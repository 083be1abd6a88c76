#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --edge-kernel-times SRC   # phase 5's rows and
                                                    # 5b's fused_dense ones,
                                                    # from the port in SRC

Phases, in order; any failure exits non-zero without the final ``ok`` line:

1. the card, as ``nvidia-smi`` names it with its power limit;
2. build all nine CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   one process per source, started together); 2b: ``cuobjdump -sass`` of
   the ``flash_attention``, ``tiled_gemm``, ``fused_mlp_q8`` and
   ``gemm_int8`` libraries: every bf16 flash and bf16 GEMM instance must
   issue HGMMA (bf16 wgmma), every int8 ``tiled_gemm`` instance IGMMA, the
   fused kernel and all 36 ``gemm_int8`` instances IMMA (int8 mma.sync),
   each printed beside ptxas's registers, spills and shared memory (the
   two edge kernels must not spill); ptxas's registers, spills and shared
   memory of all 14 ``fused_dense_kernel`` instances (none may spill) and
   of every instance of the chunked scans (``rwkv6_chunk_kernel``,
   ``chunk_aggregate_kernel``, ``chunk_scan_kernel``), printed only;
3. kernels: ``fused_mlp_q8`` on every edge net's fused group at M = 1, 8,
   13 and 40 and on an odd shape (also with NaN, +inf and -inf inputs:
   NaN quantizes to 0 and +-inf to +-127, as in the reference),
   ``gemm_int8`` on every layer shape of the
   five nets, on 256 x 1024 x 1024 and with all 36 tiles on two ragged
   shapes, each held against its plain PyTorch version on the same inputs
   on the card (f32 outputs exactly); 3b: ``fused_dense`` with every
   activation, with and without a residual, in f32 and bf16, at the
   planner's tile on the five nets' layer shapes (unaligned rows among
   them), one row, M = 13 and 200 and K = 0, then every strip of its tile
   set in a ring of 16- and 64-wide K chunks and with operands one element
   off a 16-byte boundary; and ``tiled_gemm`` in int8 (bit-exact), f32 and bf16 at
   ragged and large shapes, with the planner's block and three more of its
   dtype's tile set (tensor cores for int8 and bf16, CUDA cores for f32);
3c. characterize: the quick sweep of ``repro_torch.characterize`` on the
   card (each point a graph-replayed call timed as the engine pays it),
   every fitted constant and its relative residual printed; then
   ``Deployment.build(["jet_tagger", "tau_select"], machine_model=<that
   model>)`` and its ``bench()``: every row within 2x of its plan,
   re-characterizing up to 3 times under load, else the phase fails.  The
   stock constants' rows are printed beside them, and the default
   ``"auto"`` calibration is fitted (phase 4's build takes it from its
   memo); the fitted ``contention`` slope (``band2_penalty_per_layer``,
   read off the AIE model, not the card) is printed beside the stock one;
4. serve: ``Deployment.build(["jet_tagger", "tau_select"])`` on the default
   device, its stages characterize (the memoized ``"auto"`` model), plan,
   verify and engines: clean findings, one ``fused_dense`` launch per layer
   (4 + 3) from the calibration pass and nothing else, and input scales
   within 1e-5 relative of a CPU build of the same weights.  Then
   ``serve()``, ``warmup()``, ``drive(iters=50)``, each engine's forward a
   CUDA graph; then every engine degraded to the per-layer rung and driven
   again.  The launch counters are zeroed just before and read just after,
   and must equal, kernel by kernel, what the requests ran on each rung
   (a replay adds the launches its graph's own kernel nodes hold), and
   each captured graph's kernel nodes are printed.  The two rungs must
   agree, the served outputs must match
   the plain path on the CPU with the same weights, the same engines run
   eagerly (``graphs=False``) must give the graphed outputs bit for bit on
   both rungs and the same launches for the same requests, and a NaN bias
   must fail the graphed request.  The edge p50/p95 eager and graphed are
   printed side by side; 4b: ``edge_forward`` of all five nets
   on the card, one ``fused_dense`` per layer, against the plain path on
   the CPU; 4c: ``python -m repro_torch check`` in a subprocess (the tree
   mode: the lint of ``src/repro_torch``, the ``bench/`` snapshots, the
   Table-I fleet planned for h100 and aie): exit 0, no error finding, one
   launch of each kernel (``tiled_gemm`` among them) in its library
   self-check; 4d: ``python -m repro_torch plan jet_tagger tau_select vae
   qubit autoencoder --target both`` in a subprocess (exit 0, both fleet
   artifacts strict JSON), ``check --json`` of both artifacts (exit 0, no
   error) and ``check --json --root`` of a temporary tree holding a copy of
   ``src/repro_torch``, ``bench/`` and the two artifacts (exit 0, the lint,
   both plans, every snapshot and one launch of each of the nine kernels
   in ``checked``); each AIE tenant's regimes, bands, columns, estimate
   and crossing printed beside the h100 plan's estimate;
5. times with CUDA events: ``fused_mlp_q8`` on the five nets at batch 8
   and ``gemm_int8`` at every layer shape of the five and at 256 x 1024 x
   1024, each beside its plain version, a library yardstick
   (``torch._int_mm`` plus the same epilogue), the least time the card
   could take and the time of an empty launch; 5b: ``fused_dense`` at
   all 26 layer shapes of the five nets (each beside its time with every
   ``block_n`` of the set), at M = 13 and 200, and each net's whole
   ``edge_forward``, against ``torch.addmm`` (plus ReLU per layer for a
   forward), ``tiled_gemm`` at the check's case and (256, 4096, 4096)
   in bf16 against ``torch.matmul`` and in int8 at 256 x 1024 x 1024
   against ``torch._int_mm``;
6. LM kernels: ``flash_attention`` at the served shape (1,10,4096,256) /
   (1,1,4096,256) causal window 2048 in bf16 and f32, a GQA + softcap +
   ragged case in f32 and bf16, and a non-causal ragged case; a chunk of 8
   queries at ``q_offset`` 0, 1, 2047 and 2048 against the unrolled ring
   (Sk = q_offset + 8) and a 2056-key buffer, window 2048, with and
   without softcap, in bf16 and f32; the transformer family's shapes
   (``TF_FLASH_CASES``: qwen2.5-3b's D=128 group of 8, gemma2-9b's and
   -27b's local (window 4096) and global layers with softcap 50 at
   S=8192, qwen2-vl-72b's 64 heads, a 3000-token prompt over a 4096-key
   buffer and a chunk of 8 at ``q_offset`` 4088) in bf16 and f32;
   whisper-medium's (``WHISPER_FLASH_CASES``, D=64, 16 heads: the
   encoder's bidirectional (1,16,1500,64), the cross-attention of 448
   queries and of a 4-slot decode tick's one query a row over 1500 keys,
   non-causal and ragged, the decoder's causal (1,16,448,64) and a chunk
   of 8 at ``q_offset`` 440) in bf16 and f32;
   ``linear_scan`` at the forward shape (1,4096,2560), the decode shape
   (4,1,2560) and the ragged 3000-step prefill (2,3000,2560); each held
   against its plain version on the card;
7. LM forward: ``api.init`` of full-width, full-depth ``recurrentgemma-2b``
   (26 layers) on the card from a seeded CUDA generator, ``api.forward`` on
   B=1, S=4096 tokens: finite logits of the right shape, 8
   ``flash_attention`` and 18 ``linear_scan`` launches.  Then the float32
   model: a 64-token prompt decoded token by token against the forward's
   last row;
7b. the fleet, before any profiler session: ``Deployment.build([
   "jet_tagger", "tau_select", <the published recurrentgemma-2b>])``
   (clean verify, the LM serve section printed), a smoke trace through
   ``replay`` (50 edge requests a tenant, 8 LM requests of 16-256 prompt
   tokens and 16 new tokens; every record ``ok``, counters zeroed just
   before and read just after), the same LM requests through a standalone
   batcher under the same policy (tokens equal bit for bit), the edge
   ``bench()`` rows (printed), a 3000-token ``build_serve_steps`` prefill
   in chunks of the plan's 8 (flash with a ``q_offset`` against the ring
   past 2048) held to the whole-prompt prefill and 8 decode steps, and
   ``python -m repro_torch plan``, ``deploy``, ``serve`` and ``bench
   --json`` in their own processes (exit 0, the bench rows within 2x,
   measured again in a new process up to 3 times under load, as in phase
   3c).  Its edge engines are timed again after phase 8's profiler
   sessions, beside their time before them;
7c. the router's drift watcher and faults, on 7b's deployment before any
   profiler session: ``serve(drift_threshold=3, drift_min_samples=20)``,
   50 edge calls a tenant and 4 LM requests of 16 prompt and 16 new
   tokens (the natural drift printed), then 51 calls of ``jet_tagger``
   under a ``latency_spike`` of 2 x 3 x the larger of its measured p50 and
   its plan, which must trip a replan: every replan adopted by every
   tenant, engine and the cache entry, no graph captured again and the
   same outputs bit for bit (each replan printed with the tenant that
   tripped it, the plans before and after beside the measured p50s, and
   the drift of 50 fresh calls, on which the fleet is replanned again).
   The ladder: an ``engine_exception`` burst on ``jet_tagger`` of
   ``breaker_k x (retries + 1)``: failures booked on it alone,
   ``tau_select`` bit-exact, the breaker open and refusing, the per-layer
   rung graphed (its kernel nodes: one ``gemm_int8`` a layer), the probe
   reclosing and the fused rung back after a clean streak
   (``time_to_recovery_s``, the per-layer p50 and the first degraded
   call's capture printed).  Then ``non_finite_output`` on a graphed call
   and on a decode, ``batcher_stall``, ``replan_failure``,
   ``cache_corruption`` and a verify-stage build fault, each once; and on
   phase 4's deployment ``serve(shed_after=3)`` under 2 ms latency spikes:
   shed, 3 refusals, the half-open probe, re-opened;
7d. SLO scheduling, scenarios, replay and chaos, on 7b's deployment before
   any profiler session: closed-loop edge calls through a router with and
   without the SLO monitor (off, on, on, off; per-call p50, mean and calls
   a second) and ``SloMonitor.observe`` alone; each scenario (``steady``,
   ``bursty``, ``diurnal``, ``flash_crowd``) through ``Deployment.replay`` with
   ``serve(fresh=True)`` (the SLO monitor on) at the reference's knobs
   (0.25 s, edge 200 Hz, LM 16 Hz, 3 prompt and 4 new tokens, seed 0):
   the generator's offered count, every record ``ok`` or a refusal, the
   LM's tokens equal to a standalone batcher's, and per tenant the
   statuses, p50/p95/p99, scheduling lag, SLO violations, burn rates,
   ``at_risk``, deferrals and the deadline audit printed; the flash crowd
   again with ``slo=False`` (the LM's p50/p95 both ways); a 5 s flash
   crowd of 32-prompt, 32-token LM requests at a 2.5 Hz base, with and
   without the monitor (per tenant as above, both ways); the flash crowd
   under an ``engine_exception`` burst on ``jet_tagger`` (injected, the
   breaker opened and reclosed and closed, the co-residents served); and
   ``python -m repro_torch replay`` and ``chaos`` with the published LM
   in their own processes (exit 0; ``RECOVERED``);
7e. the instruments on the card: 7b's fleet built again with
   ``trace=True`` (same weights), the smoke trace (50 edge requests a
   tenant, 8 LM requests of 16 prompt and 16 new tokens) replayed; the
   edge kernels' work records equal to the planned FLOPs of the requests
   served; ``trace.json`` (strict JSON, every tenant's spans, one event a
   span) and ``metrics.prom`` (the span summary, the dropped-span counter
   and the ``repro_profile_*``, ``repro_slo_*`` and ``repro_resilience_*``
   families of every tenant, read back by ``parse_prometheus``) written
   to a temporary directory; the attribution table and the profile rows
   (bound, clamped and raw roofline fraction, achieved OP/s and bytes/s,
   measured LARE) printed; each tenant's ``graph_overhead``, an edge
   tenant's ``useful_fraction`` 1 within 1e-6; closed-loop edge p50 and
   calls a second, traced and untraced (runs of 2000 calls, four rounds
   of off, on, on, off) and ``Tracer.add`` alone; and ``python -m
   repro_torch trace`` and ``profile --json-dir``
   with the published LM in their own processes (exit 0, their files
   written);
8. LM serve: ``ContinuousBatcher(slots=4, max_len=4096)`` (the ring-cache
   path) serving 8 requests with 16-64 token prompts and ``max_new=16``,
   then a decode-heavy run of 4 requests with ``max_new=256``; each run
   reports its prefill and decode rates apart.  A ``torch.profiler`` trace
   of 5 batched decode ticks gives the device's busy and idle time per
   tick.  The tick is a CUDA graph (its kernel nodes held to 18 or 32 scan
   launches a step); the decode-heavy requests (the same prompts, 32 new
   tokens each: ``LM_EAGER_GEN``) and the trace are repeated with the tick
   run eagerly (``graphs=False``), and one replayed tick is held
   bit for bit (logits and every state leaf, an idle slot untouched) to an
   eager tick from the same state.  ``build_serve_steps`` prefill of a
   3000-token prompt (past the 2048 window: the ring roll) held against
   the forward, then 8 decode steps.  Counters are zeroed just before
   each LM path and read just after; each kernel's count must equal 18
   (scan) or 8 (flash) per step that runs it;
8q. ``--quant8``: ``quantize_params(params, min_size=1024)`` on the card
   (``quantized_bytes`` and ``memory_allocated`` before and after), one
   stacked leaf quantized on the card and on the CPU (bit-exact), phase
   8's short and decode-heavy runs over the int8 weights (graphed tick
   p50/p95, decode tok/s and peak memory beside bf16's), one quant8 tick
   graphed and eager from one state (bit-exact), the forward's logits on
   256 tokens in int8 against bf16 (printed), and ``python -m
   repro_torch.launch.serve --arch recurrentgemma-2b --quant8`` (exit 0);
9. LM kernel times: device ms per call (graph-replayed) and eager ms, the
   plain version's, ``F.scaled_dot_product_attention`` with the same band
   mask as the yardstick for flash (none exists for the scan) and, beside
   it, causal SDPA without a mask (its flash backend, 1.33x the work), and
   the bound max(bytes / 3.35 TB/s, flops / 989 TFLOP/s bf16), at the
   served shape and at the chunked prefill's (8 queries at q_offset 2048);
   each scan row keeps the step-by-step kernel's time as ``was_ms``, and a
   sweep of T times both scan kernels at B = 1 (the measurement behind
   ``rglru.CHUNKED_MIN_T``).  The Griffin model is freed here;
10. ``rwkv6_scan`` against its plain version on the card: the forward shape
   (64,4096,64) in bf16 and f32, a ragged T with per-head u, a non-zero
   initial state and the final state, the decode tick (4*64,1,64) with
   the state in and out, the model's fastest decay (w = exp(-e^4) for 300
   steps, in f32 and bf16) and w with exact zeros and ones;
11. the RWKV forward: ``api.init`` of full-width, full-depth ``rwkv6-7b``
   (32 layers) from a seeded CUDA generator, ``api.forward`` on B=1,
   S=4096: finite logits of the right shape and 32 ``rwkv6_scan``
   launches.  Then its float32 copy, at full depth, decodes 64 tokens
   against its forward's last row;
12. RWKV serving, as in phase 8: the short and decode-heavy
   ``ContinuousBatcher`` runs, a traced run of 5 ticks, and a 3000-token
   ``build_serve_steps`` prefill (one launch per layer from the carried
   state) held against the forward, then 8 decode steps.  Every step
   launches ``rwkv6_scan`` 32 times and nothing else of the LM kernels;
12q. ``--quant8`` for ``rwkv6-7b``, as phase 8q, and the forward's int8
   gap (relative RMS, largest difference, argmax agreement) through its
   first 1, 2, 4, 8, 16 and 32 layers, and at full depth with the LoRA
   and decay leaves left in bf16 (printed);
13. ``rwkv6_scan`` times at the forward and decode-tick shapes, beside the
   bound max(bytes / 3.35 TB/s, flops / 67 TFLOP/s f32): the recurrence
   is f32 arithmetic outside the tensor cores; the step-by-step kernel's
   time as ``was_ms``, and the sweep of T behind
   ``rwkv6.CHUNKED_MIN_T`` (B = 1, 64 heads of 64, bf16);
14. the dense transformer, ``gemma2-9b`` at full width and depth (42
   layers): its float32 copy (37 GB) decodes 64 tokens against its own
   forward's last row and is freed; then the bf16 model's ``api.forward``
   at B=1, S=8192 (past the 4096 window): finite logits of shape (1, 8192,
   256000) and 42 ``flash_attention`` launches.  ``build_serve_steps``
   with ``prefill_chunk`` 8: a 3000-token prompt in 375 chunks on a
   ``max_len`` 4096 cache (ring local layers, linear global ones), 42
   launches a chunk, against the whole-prompt prefill (last logits, every
   cache leaf, 8 decode steps; rtol 3e-2 / atol 3e-1);
14b. serving ``gemma2-9b`` as phase 8 serves Griffin (the same runs,
   trace, tick parity and 3000-token prefill against the forward; every
   tick launches no LM kernel, its decode attention being plain), then
   ``Deployment.build(["jet_tagger", <published gemma2-9b>])``: a clean
   verify, 20 edge and 4 LM requests replayed through the router, the LM
   tokens equal to a standalone batcher's under the plan's policy; and
   ``python -m repro_torch.launch.serve --arch gemma2-9b`` (exit 0);
14c. ``qwen2.5-3b`` at full width and depth: the float32 decode check and
   the forward at S=4096 (36 launches, flash at D=128 and a group of 8),
   then the launcher with and without ``--quant8`` (exit 0; each its
   ``main`` in this process);
14d. forwards only: ``gemma2-27b`` at full width and depth (54.4 GB of
   bf16 weights) at S=4096, and ``qwen2-vl-72b`` at full width cut to 8
   of its 80 layers, with seeded patch embeddings and M-RoPE ids (3, 1,
   S); each phase's wall time printed.  Then phase 9's flash rows at each
   transformer shape (device ms graph-replayed and eager, the plain
   version, SDPA with the band mask (without softcap where the kernel
   caps), the bound) and 256 queries over a 4096-key buffer against 256
   over 256 (the tiles past the causal edge skipped);
15. ``mixtral-8x22b`` at full width cut to 8 of its 56 layers (2.5 B
   parameters, 5.0 GB of bf16, a layer): the forward at B=1, S=8192 (past
   the 4096 window): finite logits, 8 flash launches (48 query heads over
   8, groups of 6), and the (token, expert) assignments the published
   capacity factor 1.25 drops.  A 2-layer float32 cut with capacity factor
   E/top_k (capacity T: nothing drops) decodes 64 tokens against its
   forward's rows (2e-3), and prefills 3000 tokens whole and in chunks of
   8 at ``max_len`` 4096 (== the window: ring caches), held as phase 14
   holds gemma2-9b's.  Then on the bf16 cut: a graph-replayed batcher
   tick against an eager one (4 slots, bit for bit, an idle slot
   untouched), ``Deployment.build(["jet_tagger", <the cut>])`` (as 14b:
   clean verify, router tokens equal to a standalone batcher's, the
   plan's decode step beside the measured tick) and ``launch.serve --arch
   mixtral-8x22b --smoke``;
15b. ``deepseek-v3-671b`` at full width cut to its 3 dense layers, 1
   routed layer (256 experts and a shared one) and the MTP head: the
   forward at S=4096 (4 flash launches at D=192, MLA's expanded form),
   finite logits and ``mtp_hidden``, ``mtp_logits`` on them (one more
   launch), the whole prefill against the forward's last row, a graphed
   batcher tick against an eager one.  Then a float32 cut of 1 dense and
   1 routed layer (capacity E/top_k) decodes 32 tokens through the
   absorbed cache against its expanded forward (2e-3) and prefills 512
   tokens in chunks of 8 against the whole prompt; and ``launch.serve
   --arch deepseek-v3-671b --smoke``.  Each phase's wall time and peak
   memory printed;
16. ``whisper-medium`` at full width and depth (24 encoder and 24 decoder
   layers, 791,662,592 parameters, seeded on the card) on every LM entry
   point, over frames (1, 1500, 1024) from a seeded CUDA generator: the
   bf16 forward of 448 tokens (finite logits, 72 flash launches: the
   encoder's 24 bidirectional, the decoder's 24 causal and 24 cross), a
   graph-replayed tick against an eager one (4 slots, ``max_len`` 448, the
   cross K/V zeros as in the reference's batcher, bit for bit), phase 8's
   short run (24 flash launches a tick, the cross-attention's one query
   over 1500 keys) and a profiled trace of 5 ticks (device busy time by
   kernel name, ``keep_idle``'s copies of the cross K/V among them),
   ``--quant8`` (the bytes before and after, one tick's logits against
   bf16), ``Deployment.build(["jet_tagger", <the model>])`` as 14b (the
   plan's decode step beside the tick), ``launch.serve --arch
   whisper-medium`` with and without ``--quant8``; then the float32 model:
   ``whisper_init_cache`` from the frames and 64 tokens decoded one by one
   within 1e-4 of the forward's rows, and the 64 tokens prefilled in chunks
   of 8 within 1e-3 of the whole prefill.  Then phase 9's flash rows at
   whisper's shapes, beside SDPA without a mask where one call computes
   the same function;
17. training.  17a: the flash backward kernel (``flash_attention_bwd``)
   against its plain version in f32 and bf16 (``TOL_FLASH_BWD``) at
   gemma2-2b's (2,8,4096,256)/(2,4,.) local and global with softcap 50,
   Griffin's MQA window, qwen2.5-3b's GQA 8, whisper's bidirectional and
   cross shapes at D=64 and MLA's D=192 (S cut to 1024 for the oracle),
   each timed in bf16 beside its bound, the plain version and SDPA's
   backward; the ``linear_scan`` gradient (the kernel run in reverse) at
   (2,4096,2560).  17b: one f32 step of gemma2-2b cut to 2 layers and of
   recurrentgemma-2b cut to one (rec, rec, attn) unit, both at full width
   and S=1024, through the kernels against the same step through the
   plain versions on the card (``TOL_TRAIN_STEP``: the loss and every
   gradient leaf).  17c: the published gemma2-2b trained whole through
   ``launch.train`` (bf16, AdamW with bf16 moments: ``TRAIN_STATE_DTYPE``,
   ``--remat block``, the chunked loss, 2 x 4096): 8 steps, a checkpoint
   every 4, one node
   failure injected before step 7, so the driver restores step 4 and
   replays 5-6, whose losses must equal the first pass's bit for bit;
   each step's loss and ``grad_norm`` finite, the step's p50, tokens/s and
   model FLOP/s against the bf16 dense peak, peak memory, snapshot and
   restore seconds, flash's launches a step.  17d: recurrentgemma-2b
   whole, 3 AdamW steps at 1 x 2048, ``linear_scan`` launches a step.
   17e: the ``rwkv6_scan`` backward kernel (``rwkv6_scan_bwd``), from the
   forward kernel's chunk states, against its plain version in f32 and
   bf16 (``TOL_FLASH_BWD``'s limits) and a second call bit for bit at the
   training shape (64,2048,64), the forward's (64,4096,64), D=32 and 128,
   decays down to 0.01, near 1 and with exact zeros and ones, timed in
   bf16 at the first two beside its bound, the plain version and the
   scratch one call allocates (read from the caching allocator), and the
   forward timed without and with its chunk states stored.  17f: one f32
   step of rwkv6-7b cut to 2 layers at full width and S=1024 through the
   kernels against the step with the plain backward (``TOL_TRAIN_STEP``) and against the plain step
   (the loss at ``TOL_TRAIN_STEP``, the leaves at ``TOL_TRAIN_STEP_RWKV``).
   17g: the published rwkv6-7b trained whole
   through ``launch.train`` (bf16, AdamW with int8 moments, ``--remat
   block``, 1 x 2048, 3 steps): finite losses and ``grad_norm``, step p50,
   tokens/s, model FLOP/s against the bf16 dense peak, peak memory, and
   exactly 64 forward and 32 backward ``rwkv6_scan`` launches a step.
19. The dry run (``repro_torch.launch.dryrun``) and its roofline.  19a:
   the CLI over three full-width cells (gemma2-27b ``train_4k`` on the
   256- and 512-rank fake worlds, rwkv6-7b ``long_500k``), a process a
   cell, the three at once, then ``repro_torch.launch.roofline`` a mesh;
   the runs start before the kernels' build and are waited for after
   phase 2b, before any phase that times anything.  Exit 0, FLOPs on each
   rank, each train cell's FSDP all-gather and gradient reduction among
   its collectives and its flash work within ``DRYRUN_FLASH_TOL`` of its
   even share; each cell's terms, bound, bytes against the card's memory
   and wall time printed.  19b: 18a's gemma2-2b
   step counted by the dry run on fake tensors and by ``analyze_step`` of
   the real step on the card: FLOPs within ``DRYRUN_FLOP_TOL``, the
   roofline bound at or below the measured p50.

Each entry point and flag runs once in its own process as a user runs it
(``check``, ``plan --target both``, ``deploy``, ``serve``, ``bench``,
``replay``, ``chaos``, ``trace``, ``profile``, the launcher bare,
``--quant8`` and ``--smoke``, the dry run and the roofline); a repeat by
another family runs its ``main`` in this process (``in_process``).  Each
phase's wall time is printed (``wall <phase>``).

It prints a ``summary`` line (the fitted constants and each net's
planned-vs-measured ratio, the edge p50/p95, the LM ticks eager and
graphed, the fleet's, the transformer phases', whisper's and training's
readings), one ``{"kernels": [...]}`` line (all nine kernels; flash with
its rows at the transformer's and whisper's shapes, the two backwards with
their rows at the training shapes), the card line again, and last ``{"ok":
true, "device": {...}}``.  It needs no network and one card.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
NETS = ("jet_tagger", "tau_select", "vae", "qubit", "autoencoder")
SERVED = ("jet_tagger", "tau_select")
DRIVE_ITERS = 50
DEGRADED_ITERS = 5
# The ported kernels the served graphs run.
GRAPH_KERNELS = ("fused_mlp_q8", "gemm_int8", "linear_scan", "rwkv6_scan")
# Phase 3c: characterize passes before a bench row outside 2x fails (the
# reference's tests/test_deploy.py re-characterizes up to 3 times under
# load), and the bench's timed calls per engine.
CHARACTERIZE_PASSES = 3
BENCH_ITERS = 51
# H100 SXM datasheet (not measured): device memory rate and dense int8 and
# bf16 rates.
HBM_BW = 3.35e12
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
# The int8 side is exact and the f32 epilogue repeats the plain version's
# arithmetic in the same order, so kernel and plain agree bit for bit:
# f32 outputs of fused_mlp_q8 and gemm_int8 are held to exactly 0.  Across
# paths (the two rungs, card and CPU) the tolerance is the reference's own
# fused-vs-per-layer 1e-5.
TOL_EXACT = 0.0
TOL = 1e-5
# Batch rows of the fused kernel's checks: one row, the served 8, a ragged
# two-CTA 13 and five CTAs.
FUSED_ROWS = (1, 8, 13, 40)
# bf16 outputs: both sides round the same f32 value; allow one bf16 ulp.
TOL_BF16 = 2 ** -8

# The LM path (recurrentgemma-2b): forward and prefill length, serving.
LM_ARCH = "recurrentgemma-2b"
LM_SEQ = 4096
LM_CONSISTENCY_TOKENS = 64
LM_SLOTS = 4
LM_REQUESTS = 8
LM_MAX_NEW = 16
LM_LONG_GEN = 256              # tokens per request in the decode-heavy run
# The eager decode-heavy rerun: the graphed run's prompts and 32 new tokens
# each.  31 eager ticks read a tick's p50 and p95 (an eager Griffin tick
# takes ~53 ms on an H100, an RWKV one ~91 ms); 255 would cost their phases
# ~32 s more.
LM_EAGER_GEN = 32
LM_TRACED_TICKS = 5
# A traced tick's device activities by name, the largest first: whisper's
# tick spreads its time over a dozen (the keep_idle copies of the cross
# K/V among them).
TRACE_TOP = 12
LM_LONG_PROMPT = 3000
LM_LONG_DECODE = 8
# Flash against its plain version, as (rtol, atol).  Both sides do f32
# arithmetic on the same inputs and differ only in summation order (~1e-7),
# so bf16 outputs differ by at most one rounding: one bf16 ulp, at most
# 2^-7 of the value.  The bf16 limit is that ulp plus 4e-3 (two ulps at the
# 0.25-0.5 outputs), far inside the reference's 3e-2, which is as large as
# a served output (RMS ~0.04 over a 2048-key band).  f32 outputs meet the
# reference's 2e-3 and also stay within 1e-3 of the output's RMS: leaving
# one key out of a 2048-key band moves outputs by ~5e-4, ten times that.
TOL_FLASH = {"float32": (2e-3, 2e-3), "bfloat16": (2 ** -7, 4e-3)}
TOL_FLASH_RMS = 1e-3
# SDPA, the yardstick, rounds its probabilities to bf16: the reference's
# bf16 tolerance (tests/test_kernels.py).
TOL_FLASH_LIBRARY = 3e-2
# The scan: the reference's 1e-4.  The float32 decode-vs-forward check uses
# the CPU parity tests' float32 tolerance (tests/test_torch_griffin.py); the
# bf16 prefill-vs-forward check the reference's bf16 rtol 3e-2 / atol 3e-1.
TOL_SCAN = 1e-4
TOL_LM_F32 = 2e-3
# The RWKV path (rwkv6-7b), through the same entry points and lengths.
RWKV_ARCH = "rwkv6-7b"
# H100 SXM datasheet (not measured): f32 outside the tensor cores.
PEAK_F32 = 67e12
# rwkv6_scan against its plain version, as (rtol, atol).  Both do f32
# arithmetic on the same inputs and differ in summation order and FMA use:
# a few f32 ulps per step on outputs of magnitude 1-10, and the decay (w < 1)
# keeps old errors from growing, so ~1e-6.  f32 outputs and the final state
# are held to 1e-4, twenty times tighter than the reference's 2e-3; bf16
# outputs round values that close to at most one bf16 ulp apart (2^-7 of the
# value), plus 1e-4 near zero.
TOL_RWKV = {"float32": (1e-4, 1e-4), "bfloat16": (2 ** -7, 1e-4)}
# fused_dense and tiled_gemm against their plain versions, as (rtol, atol).
# f32: both sum exact f32 products in f32 in another order (~1e-7 of
# outputs of O(1) at K <= 1024), held to the reference's fused_dense
# 1e-5 / 1e-4.  bf16: the same f32 values rounded once to bf16 differ by at
# most one bf16 ulp (2^-7 of the value), plus 1e-3 near zero; far inside the
# reference's 2e-2.
TOL_DENSE = {"float32": (1e-5, 1e-4), "bfloat16": (2 ** -7, 1e-3)}
# The calibrated input scales of a build on the card against a CPU build of
# the same weights: max|h| over the same f32 layers summed in another order.
TOL_XSCALE = 1e-5
# Library yardsticks: torch.matmul in bf16 rounds and accumulates its own
# way; the reference's bf16 tolerance (tests/test_kernels.py).
TOL_GEMM_LIBRARY = (2e-2, 0.16)
LM_KERNELS = ("flash_attention", "linear_scan", "rwkv6_scan")

KERNEL_META = {
    "fused_mlp_q8": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_mlp_q8.cu",
        "replaces": "src/repro/kernels/fused_mlp.py:93"},
    "gemm_int8": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm_int8.cu",
        "replaces": "src/repro/kernels/gemm_int8.py:48"},
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:98"},
    "linear_scan": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/rglru.py:49"},
    "rwkv6_scan": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6.py:53"},
    "tiled_gemm": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tiled_gemm.cu",
        "replaces": "src/repro/kernels/tiled_gemm.py:61"},
    "fused_dense": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_dense.cu",
        "replaces": "src/repro/kernels/fused_dense.py:59"},
    # The gradient of the flash TPU kernel's function: the JAX package
    # has no backward kernel and differentiates chunked_attention
    # (src/repro/models/layers.py:139) with jax.grad.
    "flash_attention_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:98"},
    # The gradient of the rwkv6_scan TPU kernel's function: the JAX
    # package differentiates rwkv6_chunked (src/repro/models/rwkv.py:79)
    # with jax.grad.
    "rwkv6_scan_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
        "replaces": "src/repro/kernels/rwkv6.py:53"},
}


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def on_card(t, what: str) -> None:
    """The default device must be the card."""
    if t.device.type != "cuda":
        raise SmokeFailure(f"{what} is on {t.device}, not cuda")


def check_close(what: str, got, want, *, tol: float = TOL,
                atol: float | None = None) -> float:
    """Max abs error of ``got`` against ``want``; fails outside
    ``rtol = tol`` and ``atol`` (default ``tol``)."""
    import torch
    atol = tol if atol is None else atol
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise SmokeFailure(f"{what}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise SmokeFailure(f"{what}: non-finite output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=tol, atol=atol):
        raise SmokeFailure(f"{what}: max abs err {err} beyond rtol {tol} "
                           f"atol {atol}")
    return err


# ---------------------------------------------------------------------------
# Phase 2b: the tensor-core instances issue tensor-core instructions
# ---------------------------------------------------------------------------

# (library, mark in the instance's mangled name, the instruction it must
# issue, instances): bf16 flash, its backward (the dq and dkdv kernels at
# D = 64, 128, 256) and GEMM issue HGMMA (bf16 wgmma), int8 GEMM IGMMA
# (int8 wgmma), the edge kernels IMMA (int8 mma.sync): the fused group and
# every one of gemm_int8's 36 tiles.
TC_INSTANCES = (
    ("flash_attention", "flash_tc_kernel", "HGMMA", 3),
    ("flash_attention_bwd", "flash_bwd_wg_", "HGMMA", 6),
    ("tiled_gemm", "tc_gemm_kernelI13__nv_bfloat16", "HGMMA", 6),
    ("tiled_gemm", "tc_gemm_kernelIa", "IGMMA", 6),
    ("fused_mlp_q8", "fused_mlp_q8_kernel", "IMMA", 1),
    ("gemm_int8", "gemm_int8_kernel", "IMMA", 36),
)
# Libraries whose instances must not spill (ptxas -v), in phase 2b's
# tensor-core and CUDA-core listings alike.
NO_SPILL = ("fused_mlp_q8", "gemm_int8", "flash_attention_bwd",
            "fused_dense", "rwkv6_scan_bwd")
SASS_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA")


def sass_counts(lib: pathlib.Path) -> dict:
    """Tensor-core instructions per kernel function of one library, read
    with ``cuobjdump -sass`` from the toolkit that built it: the lines that
    name each op."""
    import re
    from repro_torch.kernels import build
    tool = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    ops = re.compile(rf"\b({'|'.join(SASS_OPS)})\b")
    counts, func = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            func = line.split("Function : ", 1)[1].strip()
            counts[func] = dict.fromkeys(SASS_OPS, 0)
        elif func is not None and "MMA" in line:    # every op's name has it
            for op in set(ops.findall(line)):
                counts[func][op] += 1
    return counts


def ptxas_rows(report: str) -> dict:
    """Registers, spill bytes and static shared memory per entry function,
    from nvcc's ``-Xptxas -v`` output."""
    import re
    rows, func = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            func = entry.group(1)
            rows[func] = {}
        elif func is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            rows[func].update(spill_stores=int(st), spill_loads=int(ld))
        elif func is not None and "Used" in line and "registers" in line:
            rows[func]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[func]["static_smem"] = int(smem.group(1)) if smem else 0
    return rows


def tensor_core_phase(libs: dict) -> None:
    """Counts of HGMMA/IGMMA (HMMA/IMMA) in every tensor-core instance of
    ``flash_attention``, ``flash_attention_bwd``, ``tiled_gemm``,
    ``fused_mlp_q8`` and ``gemm_int8``, beside ptxas's registers, spills
    and shared memory, and ptxas's notes on wgmma serialization or
    setmaxnreg; fails if an instance issues none of its instruction, if an
    instance is missing, or if an instance of ``NO_SPILL`` spills."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    names = sorted({t[0] for t in TC_INSTANCES})
    with ThreadPoolExecutor(len(names)) as pool:
        sass = dict(zip(names, pool.map(lambda n: sass_counts(libs[n]),
                                        names)))
    for lib, mark, op, want in TC_INSTANCES:
        counts = sass[lib]
        ptxas = ptxas_rows(build.ptxas_report.get(lib, ""))
        if not ptxas:
            log(f"tensor cores {lib}: library not rebuilt in this run, "
                f"no ptxas registers or spills to check")
        found = {f: c for f, c in counts.items() if mark in f}
        if len(found) != want:
            raise SmokeFailure(f"{lib}: {len(found)} instances marked {mark}, "
                               f"want {want}")
        for func, c in sorted(found.items()):
            row = {**c, **ptxas.get(func, {})}
            log(f"tensor cores {lib} {func}: " + json.dumps(row,
                                                          sort_keys=True))
            if c[op] == 0:
                raise SmokeFailure(f"{lib} {func} issues no {op}")
            if lib in NO_SPILL and (row.get("spill_stores", 0)
                                    or row.get("spill_loads", 0)):
                raise SmokeFailure(f"{lib} {func} spills: {row}")
    for lib in sorted({t[0] for t in TC_INSTANCES}):
        for line in build.ptxas_report.get(lib, "").splitlines():
            if "(C75" in line:
                log(f"tensor cores {lib} ptxas: {line.strip()}")


# CUDA-core instances whose registers, spills and shared memory are printed:
# (library, mark, instances or None).  fused_dense.cu's two dtypes x seven
# strips and the RWKV backward's carry and chunk kernels (two dtypes x three
# head sizes each) must not spill (``NO_SPILL``); the forward chunked scans
# (kernels/csrc/rwkv6_scan.cu, linear_scan.cu) are held to no rule.
PTXAS_INSTANCES = (("fused_dense", "fused_dense_kernel", 14),
                   ("rwkv6_scan_bwd", "rwkv6_bwd_", 12),
                   ("rwkv6_scan", "rwkv6_chunk_kernel", None),
                   ("linear_scan", "chunk_aggregate_kernel", None),
                   ("linear_scan", "chunk_scan_kernel", None))


def ptxas_phase() -> None:
    """ptxas's registers, spills and shared memory for every instance of
    ``fused_dense``, the chunked scans and the RWKV backward; fails if a
    source built in this run has none or the wrong number of them, or if
    a ``fused_dense`` or RWKV backward instance spills."""
    from repro_torch.kernels import build
    for lib, mark, want in PTXAS_INSTANCES:
        if not build.ptxas_report.get(lib):
            log(f"ptxas {lib}: library not rebuilt in this run")
            continue
        rows = {f: r for f, r in ptxas_rows(build.ptxas_report[lib]).items()
                if mark in f}
        if not rows or (want is not None and len(rows) != want):
            raise SmokeFailure(f"{lib}: ptxas reports {len(rows)} {mark} "
                               f"instances, want {want or 'some'}")
        for func, row in sorted(rows.items()):
            log(f"ptxas {lib} {func}: " + json.dumps(row, sort_keys=True))
            if lib in NO_SPILL and (row.get("spill_stores", 0)
                                    or row.get("spill_loads", 0)):
                raise SmokeFailure(f"{lib} {func} spills: {row}")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def random_qparams(cfg, gen, device):
    import torch
    from repro_torch.models import edge
    params = edge.init_edge(cfg, generator=gen, device=device)
    calib = torch.randn((cfg.batch, cfg.dims[0]), generator=gen).to(device)
    return edge.quantize_edge(params, calib_x=calib, act=cfg.act)


def pack_net(qp, act_last=False):
    from repro_torch.kernels import ops
    return ops.pack_group([p["w_q"] for p in qp], [p["w_scale"] for p in qp],
                          [p["b"] for p in qp], [p["x_scale"] for p in qp],
                          act="relu", act_last=act_last)


def kernel_phase(device) -> dict:
    import torch
    from repro_torch.core import tiling
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import gemm_int8 as g8
    from repro_torch.kernels import ops
    from repro_torch.models import edge
    from repro_torch.plan import plan_deployment
    gen = torch.Generator().manual_seed(0)
    errs = {"fused_mlp_q8": 0.0, "gemm_int8": 0.0}

    def fused_case(what, x, g):
        err = check_close(what, fm.fused_mlp_q8_cuda(x, g),
                          fm.fused_mlp_q8_plain(x, g), tol=TOL_EXACT)
        errs["fused_mlp_q8"] = max(errs["fused_mlp_q8"], err)
        log(f"kernel fused_mlp_q8 {what}: max_abs_err={err} "
            f"tol={TOL_EXACT}")

    def gemm_case(what, x, w, sw, xs, blocks, out_dtype, quiet=False):
        got = g8.gemm_int8_cuda(x, w, sw, xs, block_m=blocks[0],
                                block_k=blocks[1], block_n=blocks[2],
                                out_dtype=out_dtype)
        want = g8.gemm_int8_plain(x, w, sw, xs, out_dtype=out_dtype)
        tol = TOL_BF16 if out_dtype == torch.bfloat16 else TOL_EXACT
        err = check_close(what, got, want, tol=tol)
        if out_dtype == torch.float32:
            errs["gemm_int8"] = max(errs["gemm_int8"], err)
        if not quiet:
            log(f"kernel gemm_int8 {what} {str(out_dtype)[6:]} "
                f"blocks={blocks}: max_abs_err={err} tol={tol}")
        return err

    for name in NETS:
        cfg = edge.edge_config(name)
        qp = random_qparams(cfg, gen, device)
        g = pack_net(qp)
        for m in FUSED_ROWS:
            x = torch.randn((m, cfg.dims[0]), generator=gen).to(device)
            fused_case(f"{name} dims={list(cfg.dims)} M={m}", x, g)
        plan = plan_deployment(cfg, device=device)
        for i, (k, n) in enumerate(cfg.layer_shapes):
            xq = torch.randint(-127, 128, (cfg.batch, k), generator=gen,
                               dtype=torch.int8).to(device)
            for out_dtype in (torch.float32, torch.bfloat16):
                gemm_case(f"{name}.dense{i} ({cfg.batch},{k},{n})", xq,
                          qp[i]["w_q"], qp[i]["w_scale"],
                          qp[i]["x_scale"], plan.layer(i).api_tile,
                          out_dtype)
    # An odd group: ragged rows over two CTAs, widths off every multiple.
    dims = (19, 45, 7, 33)
    ws = [torch.randint(-127, 128, (a, b), generator=gen,
                        dtype=torch.int8).to(device)
          for a, b in zip(dims[:-1], dims[1:])]
    scs = [(torch.rand((b,), generator=gen) * 0.09 + 0.01).to(device)
           for b in dims[1:]]
    bs = [torch.randn((b,), generator=gen).to(device) for b in dims[1:]]
    x = torch.randn((13, dims[0]), generator=gen).to(device)
    for act_last in (False, True):
        g = ops.pack_group(ws, scs, bs, [0.03, 0.9, 40.0], act="relu",
                           act_last=act_last)
        fused_case(f"odd dims={list(dims)} M=13 act_last={act_last}", x, g)
        # NaN quantizes to 0 and +-inf to +-127 (the reference's clip and
        # int8 cast), in the kernel as in the plain version: the output is
        # finite and equal bit for bit.
        bad = x.clone()
        bad[0, :] = float("nan")
        bad[1, 3], bad[1, 7] = float("inf"), -float("inf")
        bad[2, ::2], bad[2, 1::2] = float("nan"), float("inf")
        bad[5, :] = -float("inf")
        fused_case(f"odd dims={list(dims)} M=13 act_last={act_last} "
                   f"NaN/+inf/-inf inputs", bad, g)
    m, k, n = 256, 1024, 1024
    xq = torch.randint(-127, 128, (m, k), generator=gen,
                       dtype=torch.int8).to(device)
    w = torch.randint(-127, 128, (k, n), generator=gen,
                      dtype=torch.int8).to(device)
    sw = (torch.rand((n,), generator=gen) * 0.01).to(device)
    blocks = tiling.plan_api(m, k, n).blocks
    for out_dtype in (torch.float32, torch.bfloat16):
        gemm_case(f"multi-CTA ({m},{k},{n})", xq, w, sw, 0.02, blocks,
                  out_dtype)
    # Every tile the kernel instantiates, on a shape ragged in M, K and N
    # (the masked byte staging) and on one with aligned rows (cp.async and
    # word staging).
    for m, k, n in ((33, 100, 130), (70, 160, 196)):
        xq = torch.randint(-127, 128, (m, k), generator=gen,
                           dtype=torch.int8).to(device)
        w = torch.randint(-127, 128, (k, n), generator=gen,
                          dtype=torch.int8).to(device)
        sw = (torch.rand((n,), generator=gen) * 0.01).to(device)
        worst = {}
        for blocks in itertools.product(tiling.BLOCK_M, tiling.BLOCK_K,
                                        tiling.BLOCK_N):
            for out_dtype in (torch.float32, torch.bfloat16):
                err = gemm_case(f"({m},{k},{n})", xq, w, sw, 0.02, blocks,
                                out_dtype, quiet=True)
                worst[out_dtype] = max(worst.get(out_dtype, 0.0), err)
        log(f"kernel gemm_int8 ({m},{k},{n}) every tile: max_abs_err "
            f"f32={worst[torch.float32]} bf16={worst[torch.bfloat16]}")
    torch.cuda.synchronize(device)
    return errs


# ---------------------------------------------------------------------------
# Phase 3b: fused_dense and tiled_gemm against their plain versions
# ---------------------------------------------------------------------------

# (M, K, N) of tiled_gemm's checks: the check's canonical case, ragged
# shapes off every block multiple, one row, and a multi-wave grid.
GEMM_CASES = ((64, 256, 512), (33, 100, 130), (1, 7, 5), (200, 300, 260),
              (256, 1024, 1024))
# Blocks held beside the planner's choice, per operand size (core/tiling.py:
# the tensor-core set for int8 and bf16, the CUDA-core set for f32): the
# smallest, the largest, one between.
GEMM_BLOCKS = {1: ((64, 128, 64), (128, 128, 256), (64, 128, 128)),
               2: ((64, 64, 64), (128, 64, 256), (128, 64, 128)),
               4: ((8, 16, 32), (64, 64, 128), (16, 32, 64))}


# fused_dense's cases: every distinct layer shape of the five nets at M = 8
# (x rows of K = 27 and 250 and w rows of N = 2 and 5 are not 16-byte
# multiples), one row, a ragged M = 13, a multi-strip M = 200 and K = 0.
def dense_cases() -> list:
    from repro_torch.models import edge
    return sorted({(8, k, n) for name in NETS
                   for k, n in edge.edge_config(name).layer_shapes}
                  | {(13, 100, 70), (1, 27, 2), (1, 250, 5),
                     (200, 300, 260), (8, 0, 16)})


DENSE_RING_CASES = ((13, 100, 70), (200, 300, 260), (17, 250, 5))


def _off_by_one(t):
    """A contiguous copy of ``t`` whose base lies one element past an
    allocation's (16-byte aligned) start."""
    import torch
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def _dense_args(gen, device, m, k, n, dtype, residual):
    """x, w (scaled so outputs are O(1)), an f32 bias and an optional
    residual, drawn on the CPU from ``gen``."""
    import torch
    dt = getattr(torch, dtype)
    x = torch.randn((m, k), generator=gen).to(device, dt)
    w = (torch.randn((k, n), generator=gen) * max(k, 1) ** -0.5).to(device,
                                                                    dt)
    b = torch.randn((n,), generator=gen).to(device)
    r = (torch.randn((m, n), generator=gen).to(device, dt) if residual
         else None)
    return x, w, b, r


def dense_kernel_phase(device) -> dict:
    import torch
    from repro_torch.core import tiling
    from repro_torch.kernels import fused_dense as fd
    from repro_torch.kernels import ops
    from repro_torch.kernels import tiled_gemm as tg
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(8)
    errs = {"fused_dense": 0.0, "tiled_gemm": 0.0}
    # fused_dense: every act, with and without a residual, f32 and bf16, at
    # the planner's tile; then every strip of the set at block_k 16 and 64
    # (rings of chunks) and operands one element off a 16-byte boundary.
    for dtype in ("float32", "bfloat16"):
        rtol, atol = TOL_DENSE[dtype]
        worst = 0.0
        for m, k, n in dense_cases():
            bm, bk, bn = tiling.plan_fused_dense(
                m, k, n, itemsize=4 if dtype == "float32" else 2).blocks
            for residual in (False, True):
                x, w, b, r = _dense_args(gen, device, m, k, n, dtype,
                                         residual)
                for act in fd.ACTS:
                    got = fd.fused_dense_cuda(x, w, b, r, act=act, block_m=bm,
                                              block_k=bk, block_n=bn)
                    want = fd.fused_dense_plain(x, w, b, r, act=act)
                    if got.dtype != want.dtype:
                        raise SmokeFailure(f"fused_dense {dtype}: out dtype "
                                           f"{got.dtype}")
                    err = check_close(f"fused_dense ({m},{k},{n}) {dtype} "
                                      f"{act} residual={residual}", got, want,
                                      tol=rtol, atol=atol)
                    worst = max(worst, err)
        n_tiles = 0
        for m, k, n in DENSE_RING_CASES:
            x, w, b, r = _dense_args(gen, device, m, k, n, dtype, True)
            want = fd.fused_dense_plain(x, w, b, r, act="gelu")
            for bm, bn in itertools.product(tiling.FD_BLOCK_M,
                                            tiling.FD_BLOCK_N):
                for bk in (16, 64):
                    if not tiling.fused_dense_tile_ok(bm, bk, bn):
                        continue
                    got = fd.fused_dense_cuda(x, w, b, r, act="gelu",
                                              block_m=bm, block_k=bk,
                                              block_n=bn)
                    worst = max(worst, check_close(
                        f"fused_dense ({m},{k},{n}) {dtype} tile "
                        f"{(bm, bk, bn)}", got, want, tol=rtol, atol=atol))
                    n_tiles += 1
            off = [_off_by_one(t) for t in (x, w, r)]
            worst = max(worst, check_close(
                f"fused_dense ({m},{k},{n}) {dtype} offset operands",
                ops.fused_dense(off[0], off[1], b, off[2], act="gelu"), want,
                tol=rtol, atol=atol))
        if dtype == "float32":
            errs["fused_dense"] = worst
        log(f"kernel fused_dense {dtype}: {len(dense_cases())} shapes x "
            f"{len(fd.ACTS)} acts x residual on/off at the planned tile, "
            f"{n_tiles} ring tiles and offset operands on "
            f"{list(DENSE_RING_CASES)}: max_abs_err={worst} rtol={rtol} "
            f"atol={atol}")
    # tiled_gemm: int8 -> int32 exactly, f32 and bf16, at the planner's
    # blocks and three more.
    for dtype in ("int8", "float32", "bfloat16"):
        worst = 0.0
        for m, k, n in GEMM_CASES:
            if dtype == "int8":
                x, w = (torch.randint(-127, 128, s, generator=gen,
                                      dtype=torch.int8).to(device)
                        for s in ((m, k), (k, n)))
            else:
                x, w, _, _ = _dense_args(gen, device, m, k, n, dtype, False)
            want = tg.tiled_gemm_plain(x, w)
            size = x.element_size()
            planned = tiling.plan_tiled(m, k, n, itemsize=size).blocks
            for bm, bk, bn in dict.fromkeys((planned,) + GEMM_BLOCKS[size]):
                got = tg.tiled_gemm_cuda(x, w, block_m=bm, block_k=bk,
                                         block_n=bn)
                what = f"tiled_gemm ({m},{k},{n}) {dtype} {(bm, bk, bn)}"
                if dtype == "int8":
                    if got.dtype != torch.int32 or not torch.equal(got, want):
                        raise SmokeFailure(f"{what}: not bit-exact")
                    continue
                rtol, atol = TOL_DENSE[dtype]
                if got.dtype != want.dtype:
                    raise SmokeFailure(f"{what}: out dtype {got.dtype}")
                worst = max(worst, check_close(what, got, want, tol=rtol,
                                               atol=atol))
        if dtype == "float32":
            errs["tiled_gemm"] = worst
        tol = ("exact" if dtype == "int8"
               else "rtol={} atol={}".format(*TOL_DENSE[dtype]))
        log(f"kernel tiled_gemm {dtype}: {len(GEMM_CASES)} shapes x "
            f"planned + {len(GEMM_BLOCKS[1])} blocks: max_abs_err={worst} "
            f"{tol}")
    torch.cuda.synchronize(device)
    return errs


# ---------------------------------------------------------------------------
# Phase 4: the main path, through the entry points a user calls
# ---------------------------------------------------------------------------

def characterize_phase(device) -> dict:
    """The quick characterization sweep on the card, each point timed as
    the engine pays it (a graph-replayed call, host clock, CUDA-event time
    beside it): every fitted constant and its relative residual.  Then
    ``Deployment.build(SERVED, machine_model=<that model>)`` and its bench:
    every row must be within 2x of its plan, re-characterizing up to
    ``CHARACTERIZE_PASSES`` times under load, else the phase fails.  Beside
    it, the stock constants' plans on the same engines' path (the fault
    this closes), and the default ``"auto"`` calibration, which phase 4's
    build then takes from its memo."""
    from repro_torch import hw
    from repro_torch.characterize import characterize
    from repro_torch.deploy import Deployment
    from repro_torch.plan import PlanCache, calibrate
    passes = []
    t_phase = time.perf_counter()
    for attempt in range(CHARACTERIZE_PASSES):
        t0 = time.perf_counter()
        mm = characterize(sweep="quick", device=device)
        sweep_s = time.perf_counter() - t0
        for term, f in mm.fits.items():
            log(f"characterize pass {attempt}: {term} constants "
                f"{json.dumps(f.constants, sort_keys=True)} residual_rel_rms "
                f"{f.residual_rel_rms} coefficients {list(f.coefficients)} "
                f"timed {f.source}")
        for smp in mm.provenance["samples"]:
            log(f"characterize pass {attempt}: sample "
                + json.dumps(smp, sort_keys=True))
        dep = Deployment.build(list(SERVED), machine_model=mm,
                               cache=PlanCache())
        rows = dep.bench(iters=BENCH_ITERS, warmup=3)
        out = [{"net_id": r.net_id, "planned_s": r.planned_s,
                "measured_s": r.measured_s, "ratio": r.ratio,
                "within_2x": r.within_2x,
                "groups": dep.plans[r.net_id].groups(),
                "tiles": [list(l.api_tile)
                          for l in dep.plans[r.net_id].layers]}
               for r in rows]
        log(f"characterize pass {attempt}: sweep {sweep_s:.2f} s, model "
            f"{mm.version[:16]}, bench " + json.dumps(out, sort_keys=True))
        passes.append({"model": mm, "h100": mm.h100(), "rows": out,
                       "sweep_s": sweep_s})
        if all(r.within_2x for r in rows):
            break
    else:
        raise SmokeFailure(f"bench rows outside 2x after "
                           f"{CHARACTERIZE_PASSES} characterizations: "
                           f"{passes[-1]['rows']}")
    stock = Deployment.build(list(SERVED), machine_model="stock",
                             cache=PlanCache())
    stock_rows = [{"net_id": r.net_id, "planned_s": r.planned_s,
                   "measured_s": r.measured_s, "ratio": r.ratio,
                   "within_2x": r.within_2x}
                  for r in stock.bench(iters=BENCH_ITERS, warmup=3)]
    log("characterize: stock constants' bench (not judged) "
        + json.dumps(stock_rows, sort_keys=True))
    t0 = time.perf_counter()
    auto = calibrate.calibrated_device_model(device)
    log(f"characterize: auto calibration in {time.perf_counter() - t0:.2f} "
        f"s: kernel_overhead_s {auto.kernel_overhead_s} (stock "
        f"{hw.H100_SXM.kernel_overhead_s}), peak_int8_ops "
        f"{auto.peak_int8_ops}")
    fitted = passes[-1]["h100"]
    band2 = {"fitted": passes[-1]["model"].aie().band2_penalty_per_layer,
             "stock": hw.AIE_ML.band2_penalty_per_layer}
    log(f"characterize: contention band2_penalty_per_layer fitted "
        f"{band2['fitted']} (stock {band2['stock']}, "
        f"src={passes[-1]['model'].fits['contention'].source})")
    wall_s = time.perf_counter() - t_phase
    log(f"characterize: phase 3c in {wall_s:.2f} s")
    return {"passes": len(passes), "rows": passes[-1]["rows"],
            "band2_penalty_per_layer": band2, "wall_s": wall_s,
            "stock_rows": stock_rows,
            "constants": {k: getattr(fitted, k) for k in (
                "kernel_overhead_s", "peak_int8_ops", "fused_epilogue_s",
                "hbm_bw")},
            "residuals": passes[-1]["model"].residuals(),
            "auto": {"kernel_overhead_s": auto.kernel_overhead_s,
                     "peak_int8_ops": auto.peak_int8_ops}}


def graph_kernel_nodes(report: dict) -> dict:
    """Each captured graph's kernel nodes: those of the ported kernels (the
    launches a replay adds to the counters, read off the graph's own
    nodes), the rest torch's own.  Returns the counts by graph."""
    out = {}
    for key, g in report.items():
        ours = {k: g["launches"][k] for k in GRAPH_KERNELS}
        total = g["nodes"]["types"].get("kernel", 0)
        out[key] = {"kernel_nodes": total, "ported_kernel_nodes": ours,
                    "torch_kernel_nodes": total - sum(g["launches"].values()),
                    "node_types": g["nodes"]["types"],
                    "replays": g["replays"]}
    return out


def _plan_launches(plan, requests: int, rung: int) -> dict:
    """The kernel launches ``requests`` requests of ``plan`` make on a rung:
    the fused rung one ``fused_mlp_q8`` per multi-layer group and one
    ``gemm_int8`` per singleton group, the per-layer rung one ``gemm_int8``
    per layer."""
    groups = plan.groups() if rung == 0 else [[i] for i in
                                              range(len(plan.layers))]
    fused = sum(1 for g in groups if len(g) > 1)
    return {"fused_mlp_q8": requests * fused,
            "gemm_int8": requests * (len(groups) - fused)}


def serve_phase():
    import torch
    from repro_torch import hw
    from repro_torch.deploy import Deployment
    from repro_torch.kernels import ops
    from repro_torch.models import edge
    from repro_torch.serve import EdgeEngine, Router

    ops.reset_launches()
    dep = Deployment.build(list(SERVED))
    build_launches = ops.launch_counts()
    if dep.device.type != "cuda":
        raise SmokeFailure(f"default device is {dep.device}, not cuda")
    if list(dep.stage_results) != ["characterize", "plan", "verify",
                                   "engines"]:
        raise SmokeFailure(f"stages {list(dep.stage_results)}")
    model = dep.machine_model
    if not (isinstance(model, hw.H100) and dep.stage_results[
            "characterize"].cached and model.kernel_overhead_s
            != hw.H100_SXM.kernel_overhead_s):
        raise SmokeFailure(f"machine_model 'auto' resolved to {model}, "
                           f"{dep.stage_results['characterize']}")
    if not all(eng.graphs for eng in dep.engines.values()):
        raise SmokeFailure("the engines on the card do not run CUDA graphs")
    log("build: stages " + "; ".join(str(r) for r in
                                      dep.stage_results.values()))
    check_build(dep, build_launches)
    ops.reset_launches()
    # Unsupervised: this phase pins each rung by hand, and a supervisor's
    # clean streak would restore the fused rung mid-drive (phase 7c drives
    # the ladder through the supervisor).
    router = dep.serve(resilience=False)
    inputs = router.warmup()
    report = router.drive(inputs, iters=DRIVE_ITERS)
    fused_after_drive = ops.launch_counts()["fused_mlp_q8"]
    for eng in dep.engines.values():
        eng.degrade()
    degraded = router.drive(inputs, iters=DEGRADED_ITERS)
    # Both rungs on one input per tenant, then back to the fused rung.
    gen = torch.Generator().manual_seed(1)
    outputs = {}
    for nid, eng in dep.engines.items():
        x = torch.randn((eng.cfg.batch, eng.cfg.dims[0]),
                        generator=gen).to(dep.device)
        y_layer = eng.infer(x)
        eng.restore()
        y_fused = eng.infer(x)
        err = check_close(f"{nid} fused vs per-layer rung", y_fused, y_layer)
        log(f"serve {nid}: fused vs per-layer rung max_abs_err={err} "
            f"tol={TOL}")
        outputs[nid] = (x, y_fused)
    torch.cuda.synchronize(dep.device)
    launches = ops.launch_counts()

    log("serve report " + json.dumps(report, sort_keys=True))
    log("serve degraded report " + json.dumps(degraded, sort_keys=True))
    for nid in SERVED:
        if report[nid]["count"] != DRIVE_ITERS:
            raise SmokeFailure(f"{nid}: {report[nid]['count']} requests "
                               f"served, want {DRIVE_ITERS}")
        if degraded[nid]["count"] != DRIVE_ITERS + DEGRADED_ITERS:
            raise SmokeFailure(f"{nid}: degraded drive not counted")
    # The counters count replays: every request's kernels, exactly.  The
    # fused rung served warmup + drive + the last request, the per-layer
    # rung the degraded drive and one request.
    want = {k: 0 for k in launches}
    for nid in SERVED:
        plan = dep.plans[nid]
        for rung, n in ((0, DRIVE_ITERS + 2), (1, DEGRADED_ITERS + 1)):
            for k, v in _plan_launches(plan, n, rung).items():
                want[k] += v
    if launches != want:
        raise SmokeFailure(f"served requests launched {launches}, want "
                           f"{want} (one count per kernel a request runs)")
    want_fused = sum(_plan_launches(dep.plans[nid], DRIVE_ITERS + 1, 0)[
        "fused_mlp_q8"] for nid in SERVED)
    if fused_after_drive != want_fused:
        raise SmokeFailure(f"fused_mlp_q8 launched {fused_after_drive} "
                           f"times for {want_fused} fused requests")
    log(f"serve launches {json.dumps(launches)} (fused after the fused "
        f"drive: {fused_after_drive})")
    nodes = {nid: graph_kernel_nodes(eng.graph_report())
             for nid, eng in dep.engines.items()}
    log("serve graphs " + json.dumps(nodes, sort_keys=True))

    # The served outputs against the plain path on the CPU, same weights.
    for nid, (x, y) in outputs.items():
        eng = dep.engines[nid]
        q_cpu = [{k: v.cpu() if torch.is_tensor(v) else v
                  for k, v in q.items()} for q in eng.qparams]
        y_cpu = edge.edge_forward_q8(q_cpu, eng.cfg, x.cpu(), plan=eng.plan)
        if y.shape != (eng.cfg.batch, eng.cfg.dims[-1]):
            raise SmokeFailure(f"{nid}: output shape {tuple(y.shape)}")
        err = check_close(f"{nid} card vs CPU plain path", y.cpu(), y_cpu)
        log(f"serve {nid}: card vs CPU plain path max_abs_err={err} "
            f"tol={TOL}")

    # The same engines run eagerly (graphs=False): both rungs equal to the
    # graphed ones bit for bit, the same launches for the same requests,
    # and the eager p50/p95 beside the graphed drive's.
    eager = {nid: EdgeEngine(eng.cfg, qparams=eng.qparams, plan=eng.plan,
                             graphs=False)
             for nid, eng in dep.engines.items()}
    for nid, eng in dep.engines.items():
        x = outputs[nid][0]
        for rung in (1, 0):
            for e in (eng, eager[nid]):
                if rung:
                    e.degrade()
                else:
                    e.restore()
            if not torch.equal(eng.infer(x), eager[nid].infer(x)):
                raise SmokeFailure(f"{nid} rung {rung}: graphed and eager "
                                   f"outputs differ")
    # A poisoned output (a NaN bias) fails the request on the graphed path
    # as on the eager one: the guard is computed inside the graph.
    from repro_torch.serve import NonFiniteOutput
    for nid, eng in dep.engines.items():
        poisoned = [dict(q) for q in eng.qparams]
        poisoned[-1]["b"] = poisoned[-1]["b"].clone()
        poisoned[-1]["b"][0] = float("nan")
        bad = EdgeEngine(eng.cfg, qparams=poisoned, plan=eng.plan)
        for _ in range(2):                       # the capture, a replay
            try:
                bad.infer(outputs[nid][0])
            except NonFiniteOutput:
                continue
            raise SmokeFailure(f"{nid}: a NaN output passed the graphed "
                               f"guard")
        if bad.faults != 2 or bad.calls != 0:
            raise SmokeFailure(f"{nid}: poisoned engine counted "
                               f"{bad.faults} faults, {bad.calls} calls")
    eager_router = Router.from_fleet(dep.fleet, engines=eager)
    eager_router.warmup(inputs)
    ops.reset_launches()
    eager_report = eager_router.drive(inputs, iters=DRIVE_ITERS)
    eager_launches = ops.launch_counts()
    ops.reset_launches()
    for nid in SERVED:
        for _ in range(DRIVE_ITERS):
            router.infer(nid, inputs[nid])
    graphed_launches = ops.launch_counts()
    if eager_launches != graphed_launches:
        raise SmokeFailure(f"{DRIVE_ITERS} requests a tenant launched "
                           f"{graphed_launches} graphed, {eager_launches} "
                           f"eager")
    p = {nid: {"graphed_p50_us": report[nid]["p50_s"] * 1e6,
               "graphed_p95_us": report[nid]["p95_s"] * 1e6,
               "eager_p50_us": eager_report[nid]["p50_s"] * 1e6,
               "eager_p95_us": eager_report[nid]["p95_s"] * 1e6,
               "planned_us": dep.plans[nid].est_latency_s * 1e6}
         for nid in SERVED}
    # The per-layer rung (one gemm_int8 and six torch kernels a layer),
    # graphed and eager, DRIVE_ITERS engine calls each.
    for nid in SERVED:
        for label, eng in (("graphed", dep.engines[nid]),
                           ("eager", eager[nid])):
            eng.degrade()
            eng.reset_measurements()
            for _ in range(DRIVE_ITERS):
                eng.infer(inputs[nid])
            agg = eng.span_stats()["infer"]
            p[nid][f"per_layer_{label}_p50_us"] = agg["p50_s"] * 1e6
            p[nid][f"per_layer_{label}_p95_us"] = agg["p95_s"] * 1e6
            eng.restore()
    log(f"serve eager vs graphed: outputs bit-exact on both rungs; "
        f"launches for {DRIVE_ITERS} requests a tenant "
        f"{json.dumps(graphed_launches)} (equal); latency "
        + json.dumps(p, sort_keys=True))
    return dep, launches, build_launches, {"latency": p, "graphs": nodes}


def check_build(dep, build_launches) -> None:
    """The build on the card: the verify stage ran and found nothing, the
    calibration pass launched ``fused_dense`` once per layer of the fleet
    and nothing else, and its input scales match a CPU build of the same
    seeded weights (the plain version) to ``TOL_XSCALE`` relative."""
    from repro_torch.deploy import Deployment
    layers = sum(len(t.plan.layers) for t in dep.fleet.tenants)
    want = {k: 0 for k in build_launches}
    want["fused_dense"] = layers
    if dep.verify != "clean" or dep.findings:
        raise SmokeFailure(f"verify stage: {dep.verify} {dep.findings}")
    if build_launches != want:
        raise SmokeFailure(f"Deployment.build launched {build_launches}, "
                           f"want {want} (calibration: one fused_dense per "
                           f"layer)")
    cpu = Deployment.build(list(SERVED), device="cpu")
    worst = 0.0
    for nid, eng in dep.engines.items():
        for i, (q, q_cpu) in enumerate(zip(eng.qparams,
                                           cpu.engines[nid].qparams)):
            if not bool((q["w_q"].cpu() == q_cpu["w_q"]).all()):
                raise SmokeFailure(f"{nid} layer {i}: w_q differs from the "
                                   f"CPU build")
            rel = abs(q["x_scale"] - q_cpu["x_scale"]) / q_cpu["x_scale"]
            if rel > TOL_XSCALE:
                raise SmokeFailure(f"{nid} layer {i}: x_scale "
                                   f"{q['x_scale']} vs CPU {q_cpu['x_scale']}"
                                   f" ({rel} relative > {TOL_XSCALE})")
            worst = max(worst, rel)
    log(f"build: verify {dep.verify}; launches {json.dumps(build_launches)}; "
        f"x_scale vs CPU build max rel err {worst} (tol {TOL_XSCALE})")


# ---------------------------------------------------------------------------
# Phase 4b: the float edge forward, one fused_dense per layer
# ---------------------------------------------------------------------------

def edge_forward_phase(device) -> dict:
    """``edge_forward`` of all five nets on the card, held against the plain
    path on the CPU with the same weights and input.  Returns the launches of
    the run and the worst error."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import edge
    gen = torch.Generator().manual_seed(7)
    runs = []
    for name in NETS:
        cfg = edge.edge_config(name)
        params = edge.init_edge(cfg, generator=gen, device=device)
        for p in params:                      # non-zero biases
            p["b"] = torch.randn(p["b"].shape, generator=gen).to(device) * 0.1
        x = torch.randn((cfg.batch, cfg.dims[0]), generator=gen)
        runs.append((cfg, params, x))
    ops.reset_launches()
    outs = [edge.edge_forward(params, cfg, x.to(device))
            for cfg, params, x in runs]
    torch.cuda.synchronize(device)
    launches = ops.launch_counts()
    layers = sum(len(cfg.layer_shapes) for cfg, _, _ in runs)
    if launches["fused_dense"] != layers or sum(launches.values()) != layers:
        raise SmokeFailure(f"edge_forward launched {launches}, want "
                           f"{layers} fused_dense")
    worst = 0.0
    rtol, atol = TOL_DENSE["float32"]
    for (cfg, params, x), y in zip(runs, outs):
        on_card(y, f"{cfg.name} edge_forward")
        cpu = [{k: v.cpu() for k, v in p.items()} for p in params]
        err = check_close(f"{cfg.name} edge_forward card vs CPU plain",
                          y.cpu(), edge.edge_forward(cpu, cfg, x), tol=rtol,
                          atol=atol)
        worst = max(worst, err)
        log(f"edge_forward {cfg.name} dims={list(cfg.dims)} M={cfg.batch}: "
            f"card vs CPU plain max_abs_err={err} rtol={rtol} atol={atol}")
    log(f"edge_forward launches {json.dumps(launches)} for {layers} layers")
    return {"launches": launches["fused_dense"], "max_abs_err": worst}


# ---------------------------------------------------------------------------
# Phase 4c: ``python -m repro_torch check`` in a subprocess
# ---------------------------------------------------------------------------

def check_cli_phase() -> dict:
    """The check entry point as a user runs it: it plans and verifies the
    Table-I fleet, then launches every kernel once in its library
    self-check.  It must exit 0 and report a ``tiled_gemm`` launch."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "check",
                           "--json"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SmokeFailure(f"python -m repro_torch check exited "
                           f"{proc.returncode}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    report = json.loads(proc.stdout)
    if report["counts"]["error"] or report["launches"]["tiled_gemm"] < 1:
        raise SmokeFailure(f"check report: {report}")
    if any(n != 1 for n in report["launches"].values()):
        raise SmokeFailure(f"check self-check launches: {report['launches']}")
    log(f"check: rc 0 in {wall_s:.1f} s; checked {report['checked']}; "
        f"counts {report['counts']}; launches "
        f"{json.dumps(report['launches'], sort_keys=True)}")
    return report


# ---------------------------------------------------------------------------
# Phase 4d: the AIE-vs-PL planner and the tree check, as a user runs them
# ---------------------------------------------------------------------------

def _strict_artifact(path: pathlib.Path):
    def refuse(name):
        raise SmokeFailure(f"{path.name}: non-strict JSON constant {name}")
    return json.loads(path.read_text(), parse_constant=refuse)


def repro_cli(args: list, own_process: bool) -> subprocess.CompletedProcess:
    """``python -m repro_torch <args>`` in its own process, as a user runs
    it, or its ``main`` in this process (:func:`in_process`)."""
    if not own_process:
        from repro_torch import cli as cli_lib
        return in_process(cli_lib.main, args)
    import os
    return subprocess.run([sys.executable, "-m", "repro_torch", *args],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC)),
                          capture_output=True, text=True, timeout=600)


def _cli(args: list, what: str, *,
         own_process: bool = True) -> subprocess.CompletedProcess:
    proc = repro_cli(args, own_process)
    if proc.returncode != 0:
        raise SmokeFailure(f"python -m repro_torch {what} exited "
                           f"{proc.returncode}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    return proc


def aie_plan_phase() -> dict:
    """``plan --target both`` of the five Table-I nets at their published
    widths (under the default ``auto`` machine model, fitted on the card),
    then ``check`` of both artifacts and ``check --root`` of a tree that
    holds them beside a copy of ``src/repro_torch`` and ``bench/``.  Each
    AIE tenant's regimes, bands, columns, estimate and crossing are printed
    beside the h100 plan's estimate."""
    import shutil
    import tempfile
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_4d_") as tmp:
        tree = pathlib.Path(tmp)
        deploy = tree / "deployments_torch"
        _cli(["plan", *NETS, "--target", "both", "--out", str(deploy)],
             "plan --target both")
        name = "+".join(NETS)
        arts = {t: deploy / f"fleet_{name}_{t}.json" for t in ("h100", "aie")}
        fleets = {t: _strict_artifact(p) for t, p in arts.items()}
        report = json.loads(_cli(["check", "--json", *map(str, arts.values())],
                                 "check <artifacts>",
                                 own_process=False).stdout)
        if report["counts"]["error"]:
            raise SmokeFailure(f"check of the plan artifacts: {report}")
        shutil.copytree(SRC / "repro_torch", tree / "src" / "repro_torch",
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      "_build"))
        shutil.copytree(ROOT / "bench", tree / "bench")
        n_py = len(list((tree / "src" / "repro_torch").rglob("*.py")))
        snaps = [p.name for p in sorted((tree / "bench").rglob(
            "BENCH_*.json"))]
        tree_report = json.loads(_cli(
            ["check", "--json", "--root", str(tree)],
            "check --root", own_process=False).stdout)
    checked = tree_report["checked"]
    want = ([f"lint:{n_py} files"]
            + [f"plan:{arts[t].name}" for t in ("aie", "h100")]
            + [f"snapshot:{n}" for n in snaps])
    if tree_report["counts"]["error"] or checked[:len(want)] != want \
            or any(n != 1 for n in tree_report["launches"].values()) \
            or set(tree_report["launches"]) != set(ops.launch_counts()):
        raise SmokeFailure(f"check --root: checked {checked}, counts "
                           f"{tree_report['counts']}, launches "
                           f"{tree_report['launches']}, want {want}")
    wall_s = time.perf_counter() - t0
    h100 = {t["net_id"]: t["plan"]["totals"]["est_latency_s"]
            for t in fleets["h100"]["tenants"]}
    tenants = {}
    for t in fleets["aie"]["tenants"]:
        layers = t["plan"]["layers"]
        regimes = collections.Counter(l["regime"] for l in layers)
        tenants[t["net_id"]] = {
            "pl": regimes["pl"], "aie": regimes["aie"],
            "bands": [l["band"] for l in layers],
            "col_offset": t["col_offset"], "cols": t["cols"],
            "est_latency_s": t["plan"]["totals"]["est_latency_s"],
            "crossing_s": t["crossing_s"],
            "h100_est_latency_s": h100[t["net_id"]]}
        log(f"aie plan {t['net_id']}: " + json.dumps(tenants[t["net_id"]],
                                                      sort_keys=True))
    log(f"aie plan: band1_cols_used "
        f"{fleets['aie']['totals']['band1_cols_used']}; check of both "
        f"artifacts counts {report['counts']}; check --root checked "
        f"{checked}, counts {tree_report['counts']}, launches "
        f"{json.dumps(tree_report['launches'], sort_keys=True)}; phase 4d "
        f"in {wall_s:.2f} s")
    return {"tenants": tenants, "wall_s": wall_s,
            "band1_cols_used": fleets["aie"]["totals"]["band1_cols_used"],
            "launches": tree_report["launches"]}


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------

def event_ms(fn, *, inner: int = 50, reps: int = 21, warm: int = 5) -> float:
    """Median per-call time of ``inner`` back-to-back eager calls, by CUDA
    events, after ``warm`` calls: what a caller that launches from Python
    sees."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        t1.synchronize()
        samples.append(t0.elapsed_time(t1) / inner)
    return statistics.median(samples)


def graph_ms(fn, *, inner: int = 50, reps: int = 21) -> float:
    """Median per-call device time: ``inner`` calls captured in one CUDA
    graph and replayed, so host launch gaps drop out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        samples.append(t0.elapsed_time(t1) / inner)
    return statistics.median(samples)


def bound(bytes_moved: float, ops: float, peak: float = PEAK_INT8) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at ``peak``
    (the int8 rate by default), whichever is larger."""
    t_bytes, t_ops = bytes_moved / HBM_BW, ops / peak
    return {"bytes": bytes_moved, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _pad_to(t, rows: int, cols: int):
    import torch
    out = torch.zeros((rows, cols), dtype=t.dtype, device=t.device)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def library_chain(qp, act_last=False):
    """The fused group as library calls: per layer ``torch._int_mm`` (which
    wants M > 16 and K, N multiples of 8, so operands are zero-padded once,
    here) plus the same epilogue and requantize in torch."""
    import torch
    layers = []
    for p in qp:
        k, n = p["w_q"].shape
        kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
        xs = torch.full((), p["x_scale"], dtype=torch.float32,
                        device=p["w_q"].device)
        s = _pad_to((p["w_scale"] * xs)[None, :], 1, np_)
        b = _pad_to(p["b"][None, :], 1, np_)
        layers.append((_pad_to(p["w_q"], kp, np_), s, b, xs))
    last = len(layers) - 1

    def run(h_pad):
        h = h_pad
        for i, (w, s, b, xs) in enumerate(layers):
            hq = torch.clamp(torch.round(h / xs), -127, 127).to(torch.int8)
            h = torch._int_mm(hq, w).float() * s + b
            if i != last or act_last:
                h = torch.clamp_min(h, 0.0)
        return h
    return run


def timing_phase(device) -> dict:
    """Device ms per call (graph-replayed), eager ms, the plain version's
    ms, a library yardstick and the bound of ``fused_mlp_q8`` on every edge
    net's fused group at batch 8 and of ``gemm_int8`` at every layer shape
    of the five nets (the planner's tile) and at 256 x 1024 x 1024; each row
    beside the time of one graph-replayed empty launch (``launch_floor_ms``).
    Weights are random from a seed; the times do not depend on them."""
    import torch
    from repro_torch.core import tiling
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.models import edge
    from repro_torch.plan import plan_deployment
    rows = {"fused_mlp_q8": [], "gemm_int8": []}
    empty_graph = graph_ms(lambda: fm.empty_launch(device))
    empty_eager = event_ms(lambda: fm.empty_launch(device))
    log(f"timing empty kernel: graph_ms={empty_graph} "
        f"eager_ms={empty_eager}")
    gen = torch.Generator().manual_seed(2)
    for nid in NETS:
        cfg = edge.edge_config(nid)
        qp = random_qparams(cfg, gen, device)
        plan = plan_deployment(cfg, device=device)
        g = pack_net(qp)
        x = torch.randn((cfg.batch, cfg.dims[0]), generator=gen).to(device)
        lib = library_chain(qp)
        x_pad = _pad_to(x, 32, -(-cfg.dims[0] // 8) * 8)
        lib_out = lib(x_pad)[:cfg.batch, :cfg.dims[-1]]
        check_close(f"{nid} library chain vs kernel", lib_out,
                    fm.fused_mlp_q8_cuda(x, g))
        macs = sum(k * n for k, n in cfg.layer_shapes)
        nbytes = (x.numel() * 4 + sum(k * n for k, n in cfg.layer_shapes)
                  + sum(2 * 4 * n for n in cfg.dims[1:]) + 4 * len(qp)
                  + cfg.batch * cfg.dims[-1] * 4)
        rows["fused_mlp_q8"].append({
            "shape": f"{nid} M={cfg.batch} dims={list(cfg.dims)}",
            "ms": graph_ms(lambda: fm.fused_mlp_q8_cuda(x, g)),
            "eager_ms": event_ms(lambda: fm.fused_mlp_q8_cuda(x, g)),
            "plain_ms": graph_ms(lambda: fm.fused_mlp_q8_plain(x, g)),
            "library_ms": graph_ms(lambda: lib(x_pad)),
            "launch_floor_ms": empty_graph,
            **bound(nbytes, 2.0 * cfg.batch * macs)})
        for i, (k, n) in enumerate(cfg.layer_shapes):
            p = qp[i]
            xq = torch.randint(-127, 128, (cfg.batch, k), generator=gen,
                               dtype=torch.int8).to(device)
            rows["gemm_int8"].append({
                **gemm_row(f"{nid}.dense{i} ({cfg.batch},{k},{n})", xq,
                           p["w_q"], p["w_scale"], p["x_scale"],
                           plan.layer(i).api_tile),
                "launch_floor_ms": empty_graph})
    m, k, n = 256, 1024, 1024
    xq = torch.randint(-127, 128, (m, k), generator=gen,
                       dtype=torch.int8).to(device)
    w = torch.randint(-127, 128, (k, n), generator=gen,
                      dtype=torch.int8).to(device)
    sw = (torch.rand((n,), generator=gen) * 0.01).to(device)
    rows["gemm_int8"].append({
        **gemm_row(f"({m},{k},{n})", xq, w, sw, 0.02,
                   tiling.plan_api(m, k, n).blocks),
        "launch_floor_ms": empty_graph})
    for name, rs in rows.items():
        for r in rs:
            log(f"timing {name} " + json.dumps(r, sort_keys=True))
    return {"rows": rows, "empty_graph_ms": empty_graph,
            "empty_eager_ms": empty_eager}


def gemm_row(what, xq, w, sw, x_scale, tile) -> dict:
    import torch
    from repro_torch.kernels import gemm_int8 as g8
    m, k = xq.shape
    n = w.shape[1]
    mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    x_pad, w_pad = _pad_to(xq, mp, kp), _pad_to(w, kp, np_)
    scale = _pad_to((torch.full((), x_scale, dtype=torch.float32,
                                device=xq.device) * sw)[None, :], 1, np_)

    def kernel():
        return g8.gemm_int8_cuda(xq, w, sw, x_scale, block_m=tile[0],
                                 block_k=tile[1], block_n=tile[2],
                                 out_dtype=torch.float32)

    def library():
        return torch._int_mm(x_pad, w_pad).float() * scale

    check_close(f"gemm {what} library vs kernel", library()[:m, :n],
                kernel())
    return {"shape": what, "blocks": list(tile),
            "ms": graph_ms(kernel), "eager_ms": event_ms(kernel),
            "plain_ms": graph_ms(lambda: g8.gemm_int8_plain(
                xq, w, sw, x_scale, out_dtype=torch.float32)),
            "library_ms": graph_ms(library),
            **bound(m * k + k * n + 4 * n + 4 * m * n, 2.0 * m * k * n)}

# ---------------------------------------------------------------------------
# Phase 5b: fused_dense and tiled_gemm times
# ---------------------------------------------------------------------------

def fused_dense_timing(device, empty_ms: float, *, sweep: bool) -> dict:
    """Device ms per call (graph-replayed) and eager ms of ``fused_dense``
    through ``ops.fused_dense`` (the tree's own planner) at all 26 layer
    shapes of the five nets and at M = 13 and 200 (act none, no residual:
    the function ``torch.addmm`` computes), and of each net's whole
    ``edge_forward`` (against ``torch.addmm`` and ReLU per layer), each
    beside its plain version, its bound and the launch floor (``empty_ms``,
    phase 5's graph-replayed empty launch, once a layer).  With ``sweep``,
    each shape's planned tile and its time
    at every ``block_n`` of the set with the same ``block_m`` and
    ``block_k``.  Weights are random from a seed."""
    import torch
    from repro_torch.kernels import fused_dense as fd
    from repro_torch.kernels import ops
    from repro_torch.models import edge
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(9)
    rtol, atol = TOL_DENSE["float32"]
    cases = [(f"{nid}.dense{i}", 8, k, n) for nid in NETS
             for i, (k, n) in enumerate(edge.edge_config(nid).layer_shapes)]
    cases += [("ragged", 13, 100, 70), ("multi-strip", 200, 300, 260)]
    layers, forwards = [], []
    for what, m, k, n in cases:
        x, w, b, _ = _dense_args(gen, device, m, k, n, "float32", False)

        def kernel():
            return ops.fused_dense(x, w, b, act="none")

        def library():
            return torch.addmm(b, x, w)
        check_close(f"fused_dense {what} library vs kernel", library(),
                    kernel(), tol=rtol, atol=atol)
        row = {"shape": f"{what} ({m},{k},{n}) f32 act none",
               "ms": graph_ms(kernel), "eager_ms": event_ms(kernel),
               "plain_ms": graph_ms(lambda: fd.fused_dense_plain(
                   x, w, b, act="none")),
               "library_ms": graph_ms(library), "launch_floor_ms": empty_ms,
               **bound(4 * (m * k + k * n + n + m * n), 2.0 * m * k * n,
                       PEAK_F32)}
        if sweep:
            from repro_torch.core import tiling
            row["blocks"] = list(tiling.plan_fused_dense(m, k, n).blocks)
            bm, bk = row["blocks"][:2]
            row["block_n_ms"] = {
                bn: graph_ms(lambda bn=bn: fd.fused_dense_cuda(
                    x, w, b, act="none", block_m=bm, block_k=bk,
                    block_n=bn))
                for bn in tiling.FD_BLOCK_N
                if tiling.fused_dense_tile_ok(bm, bk, bn)}
        layers.append(row)
    for nid in NETS:
        cfg = edge.edge_config(nid)
        params = edge.init_edge(cfg, generator=gen, device=device)
        for p in params:
            p["b"] = torch.randn(p["b"].shape, generator=gen).to(device) * 0.1
        x = torch.randn((cfg.batch, cfg.dims[0]), generator=gen).to(device)
        last = len(params) - 1
        acts = [edge._dense_act(i, last, cfg.act) for i in range(len(params))]

        def forward():
            return edge.edge_forward(params, cfg, x)

        def plain():
            h = x
            for p, act in zip(params, acts):
                h = fd.fused_dense_plain(h, p["w"], p["b"], act=act)
            return h

        def library():
            h = x
            for p, act in zip(params, acts):
                h = torch.addmm(p["b"], h, p["w"])
                if act == "relu":
                    h = torch.relu(h)
            return h
        check_close(f"{nid} edge_forward library vs kernels", library(),
                    forward(), tol=rtol, atol=atol)
        m, shapes = cfg.batch, cfg.layer_shapes
        forwards.append({
            "shape": f"{nid} edge_forward M={m} dims={list(cfg.dims)}",
            "launches": len(params),
            "ms": graph_ms(forward), "eager_ms": event_ms(forward),
            "plain_ms": graph_ms(plain), "library_ms": graph_ms(library),
            "launch_floor_ms": len(params) * empty_ms,
            **bound(sum(4 * (m * k + k * n + n + m * n) for k, n in shapes),
                    sum(2.0 * m * k * n for k, n in shapes), PEAK_F32)})
    for r in layers + forwards:
        log("timing fused_dense " + json.dumps(r, sort_keys=True))
    return {"fused_dense": layers, "edge_forward": forwards}


def dense_timing_phase(device, empty_ms: float) -> dict:
    """``fused_dense``'s rows (:func:`fused_dense_timing`, with the block_n
    sweep), and device ms per call (graph-replayed) and eager ms of
    ``tiled_gemm`` at the check's canonical case, at (256, 4096, 4096) bf16
    (both against ``torch.matmul``) and in int8 at 256 x 1024 x 1024
    (against ``torch._int_mm``), each beside its plain version and its
    bound."""
    import torch
    from repro_torch.core import tiling
    from repro_torch.kernels import tiled_gemm as tg
    rows = {**fused_dense_timing(device, empty_ms, sweep=True),
            "tiled_gemm": []}
    gen = torch.Generator().manual_seed(10)
    for m, k, n, dtype in ((64, 256, 512, "bfloat16"),
                           (256, 4096, 4096, "bfloat16"),
                           (256, 1024, 1024, "int8")):
        if dtype == "int8":
            x, w = (torch.randint(-127, 128, s, generator=gen,
                                  dtype=torch.int8).to(device)
                    for s in ((m, k), (k, n)))
            nbytes, peak = m * k + k * n + 4 * m * n, PEAK_INT8
        else:
            x, w, _, _ = _dense_args(gen, device, m, k, n, dtype, False)
            nbytes, peak = 2 * (m * k + k * n + m * n), PEAK_BF16
        blocks = tiling.plan_tiled(m, k, n, itemsize=x.element_size()).blocks

        def kernel():
            return tg.tiled_gemm_cuda(x, w, block_m=blocks[0],
                                      block_k=blocks[1], block_n=blocks[2])

        def library():
            return torch._int_mm(x, w) if dtype == "int8" \
                else torch.matmul(x, w)
        got, lib_out = kernel(), library()
        if dtype == "int8":
            if not torch.equal(got, lib_out):
                raise SmokeFailure("tiled_gemm int8 differs from _int_mm")
        else:
            check_close(f"tiled_gemm ({m},{k},{n}) library vs kernel",
                        lib_out, got, tol=TOL_GEMM_LIBRARY[0],
                        atol=TOL_GEMM_LIBRARY[1])
        reps = {"inner": 5, "reps": 11} if k >= 4096 else {}
        rows["tiled_gemm"].append({
            "shape": f"({m},{k},{n}) {dtype}", "blocks": list(blocks),
            "ms": graph_ms(kernel, **reps),
            "eager_ms": event_ms(kernel, **reps),
            "plain_ms": graph_ms(lambda: tg.tiled_gemm_plain(x, w), **reps),
            "library_ms": graph_ms(library, **reps),
            **bound(nbytes, 2.0 * m * k * n, peak)})
    for r in rows["tiled_gemm"]:
        log("timing tiled_gemm " + json.dumps(r, sort_keys=True))
    return rows


def dense_kernel_entries(errs, launches, timing) -> list:
    """``fused_dense`` at the first served net's calibration (its layers'
    times summed, one launch each), ``tiled_gemm`` at the check's canonical
    case; their other rows (and the five ``edge_forward`` rows) beside
    them."""
    first = SERVED[0]
    layers = [r for r in timing["fused_dense"]
              if r["shape"].startswith(first + ".")]
    calib = {key: sum(r[key] for r in layers)
             for key in ("ms", "eager_ms", "plain_ms", "library_ms",
                         "launch_floor_ms")}
    calib.update(bound(sum(r["bytes"] for r in layers),
                       sum(r["ops"] for r in layers), PEAK_F32))
    calib["shape"] = (f"{first} calibration, {len(layers)} launches: "
                      + ", ".join(r["shape"].split(" ", 1)[1]
                                  for r in layers))
    keys = ("shape", "ms", "eager_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "launch_floor_ms")

    def pick(r):
        return {k: r[k] for k in keys if k in r}
    entries = []
    for name, row, others in (
            ("fused_dense", calib, timing["fused_dense"]
             + timing["edge_forward"]),
            ("tiled_gemm", timing["tiled_gemm"][0],
             timing["tiled_gemm"][1:])):
        entries.append({
            "name": name, **KERNEL_META[name],
            "launches": launches[name]["main"],
            "launches_by_path": launches[name],
            "max_abs_err": errs[name],
            **pick(row), "rows": [pick(r) for r in others]})
    return entries


# ---------------------------------------------------------------------------
# Phase 7b: the mixed fleet behind one router, and chunked prefill
# ---------------------------------------------------------------------------

# The fleet's smoke trace: 50 requests a edge tenant, 8 LM requests of
# 16-256 prompt tokens and 16 new tokens; the batcher's cache is the ring
# of phase 8 (max_len 4096 past the 2048 window).
FLEET_EDGE_REQUESTS = 50
FLEET_PROMPTS = (16, 50, 84, 118, 153, 187, 221, 256)
FLEET_MAX_NEW = 16
# The CLI subcommands as a user runs them, each in its own process (the
# built kernels are reused), with the published LM where it takes one.
# (label, argv, own process): ``plan`` runs in its own process in 4d, so
# here its ``main`` runs in this one.
FLEET_CLI = (
    ("plan", ["plan", "jet_tagger", "tau_select", "--lm", "recurrentgemma_2b",
              "--lm-config", "published"], False),
    ("deploy", ["deploy", "jet_tagger", "tau_select", "--lm",
                "recurrentgemma_2b", "--lm-config", "published"], True),
    ("serve", ["serve", "jet_tagger", "tau_select", "--lm",
               "recurrentgemma_2b", "--lm-config", "published"], True),
    ("bench", ["bench", "jet_tagger", "tau_select", "--lm",
               "recurrentgemma_2b", "--lm-config", "published", "--iters",
               str(BENCH_ITERS), "--json",
               "chiprun_out/BENCH_deploy_torch.json"], True))


def fleet_phase(cfg, params, tokens, per_step, per_tick) -> dict:
    """``Deployment.build(["jet_tagger", "tau_select", <the published
    Griffin>])`` on the card ("auto" machine model): a clean verify, the
    plan's LM serve section printed, one ``fused_dense`` launch per edge
    layer from the build.  Then a smoke trace through ``replay`` (every
    record ``ok``; counters zeroed just before and read just after: one
    ``fused_mlp_q8`` a edge request and 18 ``linear_scan`` a decode step),
    the same LM requests through a standalone batcher under the same policy
    and weights (tokens equal bit for bit), the edge ``bench()`` rows
    within 2x of their plans, a 3000-token chunked prefill (375 chunks of
    8, flash with a q_offset, on the ring path past 2048) held to the
    whole-prompt prefill (last logits and every state leaf) and 8 decode
    steps, the chunk-alone fault outside that limit, and the CLI
    subcommands (``bench`` with the published LM, its rows within 2x)."""
    import dataclasses
    import torch
    from repro_torch.characterize import characterize
    from repro_torch.deploy import Deployment
    from repro_torch.kernels import ops
    from repro_torch.models import edge
    from repro_torch.obs import workload
    from repro_torch.plan import PlanCache
    from repro_torch.serve import engine
    ops.reset_launches()
    t0 = time.perf_counter()
    dep = Deployment.build([*SERVED, cfg], lm_params={cfg.name: (cfg, params)},
                           max_len=LM_SEQ)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = ops.launch_counts()
    if dep.verify != "clean":
        raise SmokeFailure(f"fleet verify: {dep.verify} {dep.findings}")
    layers = sum(len(edge.edge_config(n).layer_shapes) for n in SERVED)
    if build_launches["fused_dense"] != layers:
        raise SmokeFailure(f"fleet build launched {build_launches}, want "
                           f"{layers} fused_dense")
    lm_plan = dep.plans[cfg.name]
    batcher = dep.engines[cfg.name]
    if batcher.policy != engine.BatchPolicy.from_plan(lm_plan):
        raise SmokeFailure(f"fleet batcher policy {batcher.policy}")
    log(f"fleet build {build_s:.2f} s: " + dep.summary().replace("\n",
                                                                 " | "))
    log(f"fleet {cfg.name} serve section "
        + json.dumps(lm_plan.serve, sort_keys=True))

    router = dep.serve()
    inputs = router.warmup()
    tenants = {t.net_id: t.plan.kind for t in dep.fleet.tenants}
    trace = workload.smoke_trace(tenants, edge_iters=FLEET_EDGE_REQUESTS,
                                 lm_requests=len(FLEET_PROMPTS),
                                 new_tokens=FLEET_MAX_NEW)
    lm_rids = [r.rid for r in trace if r.kind == "lm"]
    lengths = dict(zip(lm_rids, FLEET_PROMPTS))
    trace = [dataclasses.replace(r, prompt_tokens=lengths[r.rid])
             if r.kind == "lm" else r for r in trace]
    ops.reset_launches()
    report = workload.replay(router, trace, inputs=inputs)
    torch.cuda.synchronize()
    replay_launches = ops.launch_counts()
    bad = [r for r in report.records if r.status != "ok"]
    if bad:
        raise SmokeFailure(f"fleet replay: {len(bad)} records not ok: "
                           f"{bad[:3]}")
    steps = sum(FLEET_PROMPTS) + batcher.decode_steps_observed
    want = {"fused_mlp_q8": FLEET_EDGE_REQUESTS * len(SERVED),
            "linear_scan": per_tick["linear_scan"] * steps}
    got = {k: replay_launches[k] for k in want}
    others = {k: n for k, n in replay_launches.items()
              if k not in want and n}
    if got != want or others:
        raise SmokeFailure(f"fleet replay launched {replay_launches}, want "
                           f"{want} and nothing else")
    summary = report.summary()
    stats = batcher.span_stats()
    pre, dec = stats["prefill_chunk"], stats["decode_step"]
    lm_records = [r for r in report.records if r.kind == "lm"]
    out_tokens = sum(len(r.tokens) for r in lm_records)
    fleet = {
        "edge_p50_us": {n: summary[n]["p50_s"] * 1e6 for n in SERVED},
        "edge_p95_us": {n: summary[n]["p95_s"] * 1e6 for n in SERVED},
        "lm_request_p50_s": summary[cfg.name]["p50_s"],
        "lm_tok_per_s": out_tokens / report.wall_s,
        "lm_prefill_tok_per_s": sum(FLEET_PROMPTS) / pre["total_s"],
        "lm_decode_tok_per_s": (out_tokens - len(lm_records))
        / dec["total_s"],
        "lm_tick_p50_ms": dec["p50_s"] * 1e3,
        "replay_wall_s": report.wall_s, "build_s": build_s,
        "launches": replay_launches}
    log("fleet replay " + json.dumps({**fleet, "summary": summary},
                                     sort_keys=True))

    # The same LM requests through a standalone batcher: bit for bit.
    alone = engine.ContinuousBatcher(cfg, params, plan=lm_plan,
                                     max_len=LM_SEQ)
    reqs = {}
    for tr in trace:
        if tr.kind == "lm":
            reqs[tr.rid] = engine.Request(
                rid=tr.rid, prompt=workload._lm_prompt(tr, cfg.vocab_size),
                max_new=tr.new_tokens)
            alone.submit(reqs[tr.rid])
    alone.run_until_drained()
    for r in lm_records:
        if reqs[r.rid].out != r.tokens:
            raise SmokeFailure(f"fleet request {r.rid}: router tokens "
                               f"{r.tokens} != standalone {reqs[r.rid].out}")
    log(f"fleet cross-check: {len(lm_records)} LM requests, router tokens "
        f"equal the standalone batcher's bit for bit")
    del alone

    # The fleet's edge tenants within 2x of their plans, gated as phase 3c
    # gates them.  The plan's "auto" fit is the process's memo, timed
    # phases earlier on a host whose call cost drifts; so a row outside 2x
    # is measured again against the fleet planned under a quick
    # characterization made now, up to CHARACTERIZE_PASSES passes.
    rows = dep.bench(iters=BENCH_ITERS)
    for attempt in range(1, CHARACTERIZE_PASSES + 1):
        log(f"fleet bench pass {attempt} "
            + json.dumps([r.as_record() for r in rows]))
        if all(r.within_2x for r in rows):
            break
        if attempt == CHARACTERIZE_PASSES:
            raise SmokeFailure(f"fleet bench rows outside 2x after "
                               f"{attempt} passes: {rows}")
        refit = Deployment.build(
            [*SERVED, cfg], machine_model=characterize(sweep="quick",
                                                       device=dep.device),
            stop_after="plan", cache=PlanCache())
        planned = {t.net_id: t.plan.est_latency_s
                   for t in refit.fleet.tenants}
        rows = [dataclasses.replace(r, planned_s=planned[r.net_id])
                for r in dep.bench(iters=BENCH_ITERS)]
    fleet["bench"] = {r.net_id: r.ratio for r in rows}
    fleet["bench_p50_us"] = {r.net_id: r.measured_s * 1e6 for r in rows}
    fleet["bench_passes"] = attempt
    del router, batcher
    gc.collect()
    torch.cuda.empty_cache()

    # Chunked prefill on the ring path against the whole-prompt prefill.
    chunked = chunked_prefill_check(cfg, params, tokens, lm_plan, per_step,
                                    fault=True)
    chunk_launches = chunked.pop("launches")
    fleet.update(chunked_prefill_s=chunked["chunked_prefill_s"],
                 whole_prefill_s=chunked["whole_prefill_s"],
                 chunks=chunked["chunks"], chunk_launches=chunk_launches,
                 chunked_max_abs_err=chunked["max_abs_err"],
                 chunked_state_max_abs_err=chunked["cache_max_abs_err"],
                 chunk_alone_fault=chunked["chunk_alone_fault"])

    # The CLI, as a user runs it.
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    cli = {}

    def run_cli(label, argv, own_process):
        t0 = time.perf_counter()
        proc = repro_cli(argv, own_process)
        cli[label] = time.perf_counter() - t0
        tail = "\n".join(proc.stdout.splitlines()[-14:])
        log(f"fleet cli {label}: rc {proc.returncode} in {cli[label]:.1f} s"
            f"\n{tail}")
        if proc.returncode != 0:
            raise SmokeFailure(f"python -m repro_torch {' '.join(argv)} "
                               f"exited {proc.returncode}:\n{proc.stderr}")

    for label, argv, own_process in FLEET_CLI:
        run_cli(label, argv, own_process)
    # Each bench process fits its own "auto" model; like phase 3c, a row
    # outside 2x under load is measured again, up to CHARACTERIZE_PASSES
    # processes in all.
    for attempt in range(1, CHARACTERIZE_PASSES + 1):
        bench = json.loads((ROOT / "chiprun_out"
                            / "BENCH_deploy_torch.json").read_text())
        ratios = {r["name"]: r["derived"].split("ratio=")[1].split(";")[0]
                  for r in bench["rows"]}
        within = len(bench["rows"]) == len(SERVED) and all(
            "within_2x=True" in r["derived"] for r in bench["rows"])
        if within:
            break
        if attempt == CHARACTERIZE_PASSES:
            raise SmokeFailure(f"bench --json rows after {attempt} "
                               f"processes: {bench['rows']}")
        run_cli(f"bench (pass {attempt + 1})", FLEET_CLI[-1][1], True)
    fleet["cli_bench_passes"] = attempt
    fleet.update(cli_s=cli, cli_bench_ratios=ratios)
    log("fleet " + json.dumps(fleet, sort_keys=True))
    return {"fleet": fleet, "deployment": dep, "launches": {
        "fleet build": build_launches, "fleet replay": replay_launches,
        "fleet chunked prefill": chunk_launches}}


def chunk_alone_fault(cfg, params, prompt, chunked, last_w, state_w) -> dict:
    """The ring-path fault the check above must see: each chunk attends to
    its own keys alone (the reference's chunked prefill past the window,
    which loses the earlier context), the ring published as the port does.
    Its last logits must lie outside the limit the sound path is held to;
    its distance, and the state leaves', are returned."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api, layers, tree
    ring_chunk = layers._ring_chunk

    def alone(q, k, v, cache, start, window, softcap):
        _, new_cache = ring_chunk(q, k, v, cache, start, window, softcap)
        return ops.flash_attention(q, k, v, causal=True, window=window,
                                   softcap=softcap), new_cache
    layers._ring_chunk = alone
    try:
        last_f, state_f = chunked(params, prompt,
                                  api.init_decode_state(cfg, 1, LM_SEQ))
    finally:
        layers._ring_chunk = ring_chunk
    torch.cuda.synchronize()
    if torch.allclose(last_f.float(), last_w.float(), rtol=3e-2, atol=3e-1):
        raise SmokeFailure("the chunk-alone fault's logits lie within the "
                           "chunked prefill's limit: the check cannot see it")
    return {"logits_max_abs_err": float((last_f.float() - last_w.float())
                                        .abs().max()),
            "state_max_abs_err": max(float((a.float() - b.float()).abs()
                                           .max())
                                     for a, b in zip(tree.leaves(state_f),
                                                     tree.leaves(state_w)))}


# ---------------------------------------------------------------------------
# Phase 7c: the router's drift watcher, faults, breakers and shedding
# ---------------------------------------------------------------------------

# The drift watcher's band and sample floor for this phase.  An edge call's
# measured/planned ratio has read 1.27-2.04 on this card (host drift within
# one process; PERF.md section 5), the LM tick 2.77-8x its plan: a band of 3
# leaves the edge tenants' host drift alone, and 20 samples hold a p50
# steady.  The router, like the reference, has no hysteresis.  Whether the
# natural drive trips a replan rests on the LM plan's calibration, so the
# phase logs that drift and then trips one for certain: a latency_spike on
# DRIFT_SPIKE_TENANT's calls, each sleeping DRIFT_SPIKE_FACTOR x the band
# times the larger of its p50 measured in the drive and its plan, for more
# calls than its window holds from the drive: from then on its p50 is a
# spiked call, over twice the band.
DRIFT_THRESHOLD = 3.0
DRIFT_MIN_SAMPLES = 20
DRIFT_EDGE_CALLS = 50
DRIFT_LM_PROMPTS = (16, 16, 16, 16)
DRIFT_NEW_TOKENS = 16
DRIFT_SPIKE_TENANT = "jet_tagger"
DRIFT_SPIKE_FACTOR = 2.0
DRIFT_SPIKE_CALLS = DRIFT_EDGE_CALLS + 1
# The ladder: calls before the burst, and calls after the restore.
LADDER_AFTER = 8
LADDER_TAIL = 5
# Shedding on phase 4's deployment: spikes far above a budget of tens of
# microseconds, and the half-open probes allowed to find one within it.
SHED_AFTER = 3
SPIKE_S = 0.002
SHED_PROBES = 3


def edge_graphs(eng) -> dict:
    """An edge engine's captured graphs: ``{(rung, shape): (graph object
    id, replays)}`` (empty where it runs eagerly)."""
    return {key: (id(f.graph.graph), f.graph.replays)
            for key, f in eng._graphs.items()}


def tick_graph(batcher):
    """A batcher's captured tick: (graph object id, replays), or None."""
    g = batcher._graph
    return None if g is None or g.graph is None else (id(g.graph), g.replays)


def per_layer_graph_launches(eng, shape) -> dict:
    """The launches one replay of an engine's per-layer graph makes, read
    off the graph's own kernel nodes."""
    return eng.graph_report()[f"per_layer {list(shape)}"]["launches"]


def same_graphs(label, before: dict, after: dict) -> None:
    """No graph captured again: the same graph objects, each replayed on
    (a graph captured since is allowed only under a key it lacked)."""
    for key, (gid, replays) in before.items():
        if key not in after or after[key][0] != gid:
            raise SmokeFailure(f"{label}: graph {key} was captured again")
        if after[key][1] < replays:
            raise SmokeFailure(f"{label}: graph {key} replays went back")


def _lm_request(rid, n, new, vocab):
    import numpy as np
    from repro_torch.serve import engine
    prompt = np.random.default_rng(100 + rid).integers(
        1, vocab, n).astype(np.int32)
    return engine.Request(rid=rid, prompt=prompt, max_new=new)


def fleet_resilience_phase(dep, cfg, params, per_tick, edge_dep) -> dict:
    """Phase 7c, on phase 7b's mixed deployment (before any profiler
    session), through ``Deployment.serve`` and the router's entry points:
    the drift replan, the degradation ladder, each other fault kind once,
    and shedding on phase 4's edge deployment.  Every check fails the
    run."""
    import tempfile
    import warnings
    import torch
    from repro_torch.deploy import Deployment
    from repro_torch.faults import (FaultPlan, FaultSpec, InjectedFault,
                                    NonFiniteOutput)
    from repro_torch.kernels import ops
    from repro_torch.models import tree
    from repro_torch.plan import PlanCache
    from repro_torch.serve import (TenantBreakerOpen, TenantFaulted,
                                   TenantOverBudget, engine)

    readings, launches = {}, {}
    nid_lm = cfg.name
    batcher = dep.engines[nid_lm]
    lm_plan = batcher.plan

    # -- 1. drift --------------------------------------------------------
    router = dep.serve(drift_threshold=DRIFT_THRESHOLD,
                       drift_min_samples=DRIFT_MIN_SAMPLES, fresh=True)
    inputs = router.warmup()
    planned_before = {n: router.tenant(n).plan.est_latency_s
                      for n in router.net_ids}
    warm_drift = {n: router.drift(n) for n in router.net_ids}
    log(f"drift: threshold {DRIFT_THRESHOLD}, min samples "
        f"{DRIFT_MIN_SAMPLES}; after warmup {json.dumps(warm_drift)}; "
        f"planned us " + json.dumps({n: v * 1e6 for n, v
                                     in planned_before.items()}))
    y0 = {n: dep.engines[n].infer(x).clone() for n, x in inputs.items()}
    graphs0 = {n: edge_graphs(dep.engines[n]) for n in inputs}
    tick0 = tick_graph(batcher)
    steps0 = batcher.decode_steps_observed
    trips = []

    def watch(nid, what):
        if router.replans > len(trips):
            trips.append({"replan": router.replans, "tripped_by": nid,
                          "at": what})
            log(f"drift: replan {router.replans} tripped by {nid} ({what})")

    ops.reset_launches()
    for i in range(DRIFT_EDGE_CALLS):
        for n, x in inputs.items():
            router.infer(n, x)
            watch(n, f"edge call {i}")
    reqs = [_lm_request(i, n, DRIFT_NEW_TOKENS, cfg.vocab_size)
            for i, n in enumerate(DRIFT_LM_PROMPTS)]
    for r in reqs:
        router.submit(nid_lm, r)
    ticks = 0
    while router.lm_pending():
        router.step()
        ticks += 1
        watch(nid_lm, f"tick {ticks}")
        if ticks > 10_000:
            raise SmokeFailure("drift: the LM requests never drained")
    torch.cuda.synchronize()
    drift_launches = ops.launch_counts()
    if not all(r.done and not r.error and len(r.out) == DRIFT_NEW_TOKENS
               for r in reqs):
        raise SmokeFailure("drift: LM requests " + str(
            [(r.done, r.error, len(r.out)) for r in reqs]))
    steps = sum(DRIFT_LM_PROMPTS) + batcher.decode_steps_observed - steps0
    want = {"fused_mlp_q8": DRIFT_EDGE_CALLS * len(inputs),
            "linear_scan": per_tick["linear_scan"] * steps}
    got = {k: drift_launches[k] for k in want}
    others = {k: n for k, n in drift_launches.items() if k not in want and n}
    if got != want or others:
        raise SmokeFailure(f"drift: launched {drift_launches}, want {want} "
                           f"and nothing else")
    launches["fleet drift"] = drift_launches
    rep = router.report()
    measured = {n: (batcher.measured_decode_p50_s if n == nid_lm
                    else rep[n]["p50_s"]) for n in router.net_ids}
    natural = {"drift": {n: router.drift(n) for n in router.net_ids},
               "replans": router.replans,
               "planned_us": {n: router.tenant(n).plan.est_latency_s * 1e6
                              for n in router.net_ids}}
    log(f"drift: the natural drive: {json.dumps(natural, sort_keys=True)}")

    # The certain trip: DRIFT_SPIKE_CALLS spiked calls of one edge tenant.
    spiked = DRIFT_SPIKE_TENANT
    magnitude = DRIFT_SPIKE_FACTOR * DRIFT_THRESHOLD * max(
        measured[spiked], router.tenant(spiked).plan.est_latency_s)
    router.arm_faults(FaultPlan(faults=(FaultSpec(
        kind="latency_spike", tenant=spiked, after=0,
        count=DRIFT_SPIKE_CALLS, magnitude_s=magnitude),)).injector())
    ops.reset_launches()
    for i in range(DRIFT_SPIKE_CALLS):
        router.infer(spiked, inputs[spiked])
        watch(spiked, f"spiked call {i}")
    torch.cuda.synchronize()
    router.arm_faults(None)
    spike_launches = ops.launch_counts()
    if {k: n for k, n in spike_launches.items() if n} != {
            "fused_mlp_q8": DRIFT_SPIKE_CALLS}:
        raise SmokeFailure(f"drift: the spiked calls launched "
                           f"{spike_launches}")
    launches["fleet drift spike"] = spike_launches
    planned_after = {n: router.tenant(n).plan.est_latency_s
                     for n in router.net_ids}
    drift_after = {n: router.drift(n) for n in router.net_ids}
    if router.replans < 1 or router.replans <= natural["replans"]:
        raise SmokeFailure(f"drift: the spike tripped no replan (drift "
                           f"{drift_after}, threshold {DRIFT_THRESHOLD}, "
                           f"spike {magnitude * 1e6} us)")
    for n in router.net_ids:
        t = router.tenant(n)
        cached = dep.ctx.cache.get(t.plan.key)
        if not (t.plan is dep.engines[n].plan is router.fleet.tenant(n).plan
                and cached == t.plan):
            raise SmokeFailure(f"drift: tenant {n}'s plan, engine plan, "
                               f"fleet plan and cache entry disagree")
    for n, x in inputs.items():
        same_graphs(f"drift {n}", graphs0[n], edge_graphs(dep.engines[n]))
        if not torch.equal(dep.engines[n].infer(x), y0[n]):
            raise SmokeFailure(f"drift: {n}'s output changed across the "
                               f"replan")
    tick1 = tick_graph(batcher)
    if tick0 is not None and (tick1[0] != tick0[0] or tick1[1] <= tick0[1]):
        raise SmokeFailure(f"drift: the LM tick graph {tick0} -> {tick1}")
    router.reset_metrics()
    for _ in range(DRIFT_EDGE_CALLS):
        for n, x in inputs.items():
            router.infer(n, x)
            watch(n, "fresh call")
    fresh = {n: router.drift(n) for n in router.net_ids}
    # The spike's cost leaves the plans: a replan on the fresh calls.
    router.replan_fleet()
    readings["drift"] = {
        "threshold": DRIFT_THRESHOLD, "min_samples": DRIFT_MIN_SAMPLES,
        "after_warmup": warm_drift, "natural": natural,
        "spike": {"tenant": spiked, "us": magnitude * 1e6,
                  "calls": DRIFT_SPIKE_CALLS},
        "planned_us_after_fresh": {
            n: router.tenant(n).plan.est_latency_s * 1e6
            for n in router.net_ids},
        "replans": router.replans, "trips": trips, "ticks": ticks,
        "planned_us_before": {n: v * 1e6 for n, v in planned_before.items()},
        "planned_us_after": {n: v * 1e6 for n, v in planned_after.items()},
        "measured_p50_us": {n: v * 1e6 for n, v in measured.items()},
        "drift_after_replan": drift_after, "drift_fresh": fresh,
        "budget_us_after": {n: router.tenant(n).metrics.latency_budget_s
                            * 1e6 for n in router.net_ids}}
    log("drift " + json.dumps(readings["drift"], sort_keys=True))

    # -- 2. the ladder ---------------------------------------------------
    router = dep.serve(fresh=True)
    sup = router.supervisor
    knobs = sup.cfg("jet_tagger")
    k = knobs["breaker_k"] * (knobs["retries"] + 1)
    jet, tau = dep.engines["jet_tagger"], dep.engines["tau_select"]
    x_jet, x_tau = inputs["jet_tagger"], inputs["tau_select"]
    fused_jet, want_tau = jet.infer(x_jet).clone(), tau.infer(x_tau).clone()
    shape = tuple(x_jet.shape)
    if (1, shape) in jet._graphs:
        raise SmokeFailure("ladder: the per-layer rung was captured before "
                           "the breaker opened")
    tau_graphs = edge_graphs(tau)
    router.arm_faults(FaultPlan.burst("jet_tagger", after=LADDER_AFTER,
                                      count=k).injector())
    calls = (LADDER_AFTER + knobs["breaker_k"] + 2 * knobs["breaker_cooldown"]
             + LADDER_TAIL)
    trace = []
    ops.reset_launches()
    for i in range(calls):
        level = jet.degrade_level
        t0 = time.perf_counter()
        try:
            y = router.infer("jet_tagger", x_jet)
            outcome = "ok"
        except TenantBreakerOpen:
            outcome, y = "refused", None
        except TenantFaulted:
            outcome, y = "failed", None
        dt = time.perf_counter() - t0
        state = sup.breaker("jet_tagger").state
        trace.append((outcome, level, jet.degrade_level, state, dt))
        if y is not None:
            err = check_close(f"ladder call {i} (rung {level})", y, fused_jet)
            if level == 0 and err != 0.0:
                raise SmokeFailure(f"ladder call {i}: fused rung output "
                                   f"moved by {err}")
        if not torch.equal(router.infer("tau_select", x_tau), want_tau):
            raise SmokeFailure(f"ladder call {i}: tau_select's output is "
                               f"not bit-exact with the unarmed run")
    torch.cuda.synchronize()
    ladder_launches = ops.launch_counts()
    router.arm_faults(None)
    outcomes = [t[0] for t in trace]
    per_layer = [t for t in trace if t[0] == "ok" and t[1] == 1]
    fused_ok = sum(1 for t in trace if t[0] == "ok" and t[1] == 0)
    health = router.health()["tenants"]
    hj, ht = health["jet_tagger"], health["tau_select"]
    want_seq = (["ok"] * LADDER_AFTER + ["failed"] * knobs["breaker_k"]
                + ["refused"] * knobs["breaker_cooldown"]
                + ["ok"] * (knobs["breaker_cooldown"] + LADDER_TAIL))
    if outcomes != want_seq:
        raise SmokeFailure(f"ladder outcomes {outcomes}, want {want_seq}")
    if (hj["failures"], ht["failures"], ht["state"]) != (
            knobs["breaker_k"], 0, "closed"):
        raise SmokeFailure(f"ladder: failures not booked on jet_tagger "
                           f"alone: {health}")
    if (hj["breaker_opens"], hj["breaker_recloses"], hj["degrades"],
            hj["restores"], hj["state"]) != (1, 1, 1, 1, "closed"):
        raise SmokeFailure(f"ladder: breaker/ladder counters {hj}")
    opened = trace[LADDER_AFTER + knobs["breaker_k"] - 1]
    probe = trace[LADDER_AFTER + knobs["breaker_k"]
                  + knobs["breaker_cooldown"]]
    if opened[2:4] != (1, "open") or probe[1:4] != (1, 1, "closed"):
        raise SmokeFailure(f"ladder: open {opened}, probe {probe}")
    if len(per_layer) != knobs["breaker_cooldown"] or trace[-1][1:3] != (0, 0):
        raise SmokeFailure(f"ladder: {len(per_layer)} per-layer calls, last "
                           f"{trace[-1]}")
    layer_nodes = per_layer_graph_launches(jet, shape)
    n_layers = len(jet.cfg.dims) - 1
    if (layer_nodes["gemm_int8"], layer_nodes["fused_mlp_q8"]) != (
            n_layers, 0):
        raise SmokeFailure(f"ladder: the per-layer graph's kernel nodes "
                           f"{layer_nodes}")
    want = {"gemm_int8": n_layers * len(per_layer),
            "fused_mlp_q8": fused_ok + calls}
    got = {kk: ladder_launches[kk] for kk in want}
    others = {kk: n for kk, n in ladder_launches.items()
              if kk not in want and n}
    if got != want or others:
        raise SmokeFailure(f"ladder launched {ladder_launches}, want {want} "
                           f"and nothing else")
    same_graphs("ladder tau_select", tau_graphs, edge_graphs(tau))
    launches["ladder"] = ladder_launches
    fused_dt = [t[4] for t in trace[:LADDER_AFTER]]
    readings["ladder"] = {
        "burst": k, "knobs": knobs, "outcomes": outcomes,
        "time_to_recovery_s": hj["time_to_recovery_s"],
        "first_degraded_call_us": per_layer[0][4] * 1e6,
        "per_layer_p50_us": statistics.median(t[4] for t in per_layer[1:])
        * 1e6,
        "fused_p50_us": statistics.median(fused_dt) * 1e6,
        "per_layer_graph_launches": layer_nodes, "health": hj}
    log("ladder " + json.dumps(readings["ladder"], sort_keys=True))

    # -- 3. each other fault kind once -----------------------------------
    kinds = {}
    router.arm_faults(FaultPlan(faults=(FaultSpec(
        kind="non_finite_output", tenant="tau_select", after=0),)).injector())
    before = edge_graphs(tau)
    try:
        router.infer("tau_select", x_tau)
        raise SmokeFailure("non_finite_output: the poisoned call passed")
    except TenantFaulted as exc:
        if not isinstance(exc.__cause__, NonFiniteOutput):
            raise SmokeFailure(f"non_finite_output raised {exc!r}") from exc
    if not torch.equal(router.infer("tau_select", x_tau), want_tau):
        raise SmokeFailure("non_finite_output: the next call is not "
                           "bit-exact")
    same_graphs("non_finite_output", before, edge_graphs(tau))
    kinds["non_finite_output"] = "failed, next call bit-exact"

    # A poisoned decode with two requests decoding: both fail, and the
    # graph's own logits stay finite.
    router.arm_faults(None)
    pair = [_lm_request(10 + i, 16, DRIFT_NEW_TOKENS, cfg.vocab_size)
            for i in range(2)]
    for r in pair:
        router.submit(nid_lm, r)
    while not all(r.out for r in pair):
        router.step()
    failures = router.tenant(nid_lm).metrics.failures
    router.arm_faults(FaultPlan(faults=(FaultSpec(
        kind="non_finite_output", site="batcher.decode", tenant=nid_lm),
    )).injector())
    router.step()
    if batcher._graph is not None and not bool(
            torch.isfinite(batcher._graph._out).all()):
        raise SmokeFailure("batcher.decode: the graph's own logits were "
                           "poisoned")
    if [r.error for r in pair] != ["non_finite_output"] * 2 \
            or router.tenant(nid_lm).metrics.failures != failures + 2 \
            or batcher.n_active:
        raise SmokeFailure(f"batcher.decode: errors "
                           f"{[r.error for r in pair]}, {batcher.n_active} "
                           f"slots still active")
    kinds["batcher.decode non_finite_output"] = "both live requests failed"

    # A stalled tick: no admission, no decode, the state untouched; the
    # request's tokens equal a standalone batcher's.
    inj = FaultPlan(faults=(FaultSpec(kind="batcher_stall", tenant=nid_lm,
                                      after=1),)).injector()
    router.arm_faults(inj)
    follow = _lm_request(20, 16, DRIFT_NEW_TOKENS, cfg.vocab_size)
    router.submit(nid_lm, follow)
    router.step()
    state = tree.tree_map(torch.clone, batcher.state)
    steps, active = batcher.decode_steps_observed, batcher.n_active
    router.step()
    torch.cuda.synchronize()
    if inj.fired() != 1 or batcher.decode_steps_observed != steps \
            or batcher.n_active != active or not all(tree.leaves(
                tree.tree_map(torch.equal, state, batcher.state))):
        raise SmokeFailure("batcher_stall: the stalled tick moved the "
                           "batcher")
    del state
    router.run_until_drained()
    twin = _lm_request(20, 16, DRIFT_NEW_TOKENS, cfg.vocab_size)
    alone = engine.ContinuousBatcher(cfg, params, plan=lm_plan,
                                     max_len=LM_SEQ)
    alone.submit(twin)
    alone.run_until_drained()
    if follow.error or follow.out != twin.out:
        raise SmokeFailure(f"after the faults: router tokens {follow.out} "
                           f"!= standalone {twin.out}")
    del alone
    kinds["batcher_stall"] = "tick skipped, state bit-exact"
    kinds["following request"] = "tokens equal a standalone batcher's"
    router.arm_faults(None)

    # A replan that fails keeps serving under the current fleet.
    router = dep.serve(drift_threshold=DRIFT_THRESHOLD, drift_min_samples=1,
                       fresh=True)
    fleet0 = router.fleet
    router.arm_faults(FaultPlan(faults=(
        FaultSpec(kind="latency_spike", tenant="jet_tagger", after=0,
                  magnitude_s=SPIKE_S),
        FaultSpec(kind="replan_failure", tenant="jet_tagger", after=0,
                  count=99))).injector())
    router.infer("jet_tagger", x_jet)
    if (router.replan_failures, router.replans) != (1, 0) \
            or router.fleet is not fleet0:
        raise SmokeFailure(f"replan_failure: {router.health()}")
    if not torch.equal(router.infer("jet_tagger", x_jet), fused_jet) \
            or router.fleet is not fleet0:
        raise SmokeFailure("replan_failure: the router stopped serving the "
                           "current fleet")
    router.arm_faults(None)
    kinds["replan_failure"] = (f"{router.replan_failures} replan failures, "
                               f"the fleet kept")

    # A corrupt cache read is a miss with a warning; a build fault at the
    # verify stage raises before any engine exists.
    with tempfile.TemporaryDirectory() as tmp:
        first = Deployment.build(list(SERVED), cache=PlanCache(tmp),
                                 stop_after="plan")
        cache = PlanCache(tmp)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            again = Deployment.build(
                list(SERVED), cache=cache, stop_after="plan",
                faults=[FaultSpec(kind="cache_corruption")])
    caught = [w for w in caught if issubclass(w.category, RuntimeWarning)]
    if cache.corrupt_reads != 1 or len(caught) != 1 \
            or again.stage_results["plan"].cached \
            or again.fleet != first.fleet:
        raise SmokeFailure(f"cache_corruption: {cache.corrupt_reads} "
                           f"corrupt reads, warnings {caught}")
    kinds["cache_corruption"] = f"a miss: {caught[0].message}"
    ops.reset_launches()
    try:
        Deployment.build(list(SERVED), cache=PlanCache(), faults=[FaultSpec(
            kind="engine_exception", site="build", tenant="verify")])
        raise SmokeFailure("build fault: Deployment.build returned")
    except InjectedFault as exc:
        kinds["build"] = str(exc)
    if any(ops.launch_counts().values()):
        raise SmokeFailure(f"build fault: launched {ops.launch_counts()} "
                           f"(an engine was built)")
    readings["faults"] = kinds
    log("faults " + json.dumps(kinds, sort_keys=True))

    # -- 4. shedding, on phase 4's edge deployment -----------------------
    # The spiked tenant alone is driven: tau_select, called right after each
    # spike, read over its budget three times running on the card and was
    # shed too.  A call that follows a 2 ms sleep runs slow on the host,
    # whichever tenant makes it (``after_sleep_us`` beside
    # ``back_to_back_us``, engine calls).  tau_select is served once after,
    # and must not be shed.
    edge_dep.recalibrate()
    router = edge_dep.serve(shed_after=SHED_AFTER, fresh=True)
    x4 = router.default_inputs()
    tau4 = edge_dep.engines["tau_select"]
    after_sleep, back_to_back = [], []
    for _ in range(SHED_AFTER * 3):
        time.sleep(SPIKE_S)
        for out in (after_sleep, back_to_back):
            t0 = time.perf_counter()
            tau4.infer(x4["tau_select"])
            out.append((time.perf_counter() - t0) * 1e6)
    budget = router.tenant("jet_tagger").metrics.latency_budget_s
    router.arm_faults(FaultPlan(faults=(FaultSpec(
        kind="latency_spike", tenant="jet_tagger", after=0, count=SHED_AFTER,
        magnitude_s=SPIKE_S),)).injector())
    seq, latencies = [], []
    for _ in range(2 * SHED_AFTER + (SHED_AFTER + 1) * SHED_PROBES):
        t0 = time.perf_counter()
        try:
            router.infer("jet_tagger", x4["jet_tagger"])
            seq.append("ok")
            latencies.append(time.perf_counter() - t0)
        except TenantOverBudget as exc:
            if type(exc) is not TenantOverBudget:
                raise
            seq.append("shed")
        if len(seq) > SHED_AFTER and seq[-1] == "ok" \
                and not router.over_budget("jet_tagger"):
            break
    router.arm_faults(None)
    router.infer("tau_select", x4["tau_select"])
    want_seq = ["ok"] * SHED_AFTER + ["shed"] * SHED_AFTER + ["ok"]
    if seq[:len(want_seq)] != want_seq or router.over_budget("jet_tagger") \
            or router.over_budget("tau_select"):
        raise SmokeFailure(f"shedding: {seq}, latencies {latencies}, budget "
                           f"{budget}")
    readings["shed"] = {"sequence": seq, "budget_us": budget * 1e6,
                        "spiked_us": [v * 1e6 for v in
                                      latencies[:SHED_AFTER]],
                        "probe_us": [v * 1e6 for v in
                                     latencies[SHED_AFTER:]],
                        "spike_us": SPIKE_S * 1e6,
                        "after_sleep_us": statistics.median(after_sleep),
                        "back_to_back_us": statistics.median(back_to_back)}
    log("shed " + json.dumps(readings["shed"], sort_keys=True))
    return {"readings": readings, "launches": launches}


# ---------------------------------------------------------------------------
# Phase 7d: SLO scheduling, the scenarios, replay and chaos
# ---------------------------------------------------------------------------

# The reference's replay defaults: 0.25 s, edge 200 Hz, LM 16 Hz, 3 prompt
# and 4 new tokens, seed 0 (``obs/workload.py``'s generators).
SCENARIO_KW = {"duration_s": 0.25, "rate_hz": 200.0, "lm_rate_hz": 16.0,
               "prompt_tokens": 3, "new_tokens": 4, "seed": 0}
REFUSALS = ("shed", "queue_full", "breaker")
CHAOS_AFTER, CHAOS_COUNT = 8, 6
# The flash crowd at a length that gives the SLO comparison samples: 5 s,
# about 30 LM requests of 32 prompt and 32 new tokens at a 2.5 Hz base and
# 2400 edge requests a tenant, replayed with and without the monitor.  The
# batcher prefills one token a tick of all its slots (16 ms), so the card
# time grows with the prompt tokens offered: 128-token prompts at 4 Hz took
# 42 s a replay on the H100.
LONG_FLASH_KW = {"duration_s": 5.0, "rate_hz": 200.0, "lm_rate_hz": 2.5,
                 "prompt_tokens": 32, "new_tokens": 32, "seed": 0}
# Closed-loop edge calls through the router, with and without the monitor.
SLO_COST_CALLS = 2000
SCENARIO_CLI = (
    ("replay", ["replay", "jet_tagger", "tau_select", "--lm",
                "recurrentgemma_2b", "--lm-config", "published",
                "--json-dir", "chiprun_out/replay_7d"]),
    ("chaos", ["chaos", "jet_tagger", "tau_select", "--lm",
               "recurrentgemma_2b", "--lm-config", "published",
               "--json-dir", "chiprun_out/chaos_7d"]))


def _audited(router):
    """The router with a tracer of its own: its audit spans (``request``,
    ``sched/defer``, ``fault/*``) are kept, the engines' are not."""
    from repro_torch.obs.trace import Tracer
    router.tracer = Tracer()
    return router


def _scenario_rows(report, router) -> dict:
    """Per tenant: offered, statuses, tails, lag, the SLO monitor's state,
    the deferrals (the router's ``sched/defer`` spans) and the deadline
    audit."""
    deferred = collections.Counter(
        s.attrs["tenant"] for s in router.tracer.by_name("sched/defer"))
    health = router.health()["tenants"]
    snap = router.slo.snapshot() if router.slo is not None else {}
    rows = {}
    for nid, s in report.summary().items():
        st = snap.get(nid, {})
        rows[nid] = {
            "offered": s["count"],
            "status": {k: s[k] for k in ("ok", *REFUSALS, "fault", "stuck")
                       if s[k]},
            "p50_us": s["p50_s"] * 1e6, "p95_us": s["p95_s"] * 1e6,
            "p99_us": s["p99_s"] * 1e6,
            "lag_p50_us": s["lag_p50_s"] * 1e6,
            "lag_p95_us": s["lag_p95_s"] * 1e6,
            "slo_p95_budget_us": (st["p95_budget_s"] * 1e6
                                  if st.get("p95_budget_s") else None),
            "slo_violations": st.get("violations"),
            "burn_fast": st.get("burn_fast"), "burn_slow": st.get("burn_slow"),
            "at_risk": st.get("at_risk"),
            "deferrals": deferred.get(nid, 0),
            "deadline_exceeded": health[nid].get("deadline_exceeded")}
    return rows


def slo_cost(dep) -> dict:
    """What the SLO monitor costs an edge request: closed-loop
    ``router.infer`` calls on each edge tenant through a router with and
    without the monitor, in the order off, on, on, off (each a fresh router,
    warmed and reset), as per-call p50 and mean µs and calls a second; and
    ``SloMonitor.observe`` alone on a full 256-sample window (printed, not
    judged)."""
    from repro_torch.obs.slo import SloMonitor
    out = {}
    for tp in dep.fleet.tenants:
        if tp.plan.kind != "edge":
            continue
        nid = tp.net_id
        runs = {"off": [], "on": []}
        for label in ("off", "on", "on", "off"):
            router = dep.serve(slo=label == "on", fresh=True)
            x = router.warmup()[nid]
            router.reset_metrics()
            calls = []
            t_start = time.perf_counter()
            for _ in range(SLO_COST_CALLS):
                t0 = time.perf_counter()
                router.infer(nid, x)
                calls.append(time.perf_counter() - t0)
            wall = time.perf_counter() - t_start
            runs[label].append({"p50_us": statistics.median(calls) * 1e6,
                                "mean_us": statistics.fmean(calls) * 1e6,
                                "calls_per_s": SLO_COST_CALLS / wall})
        out[nid] = {k: {m: statistics.fmean(r[m] for r in v)
                        for m in v[0]} for k, v in runs.items()}
        out[nid]["runs"] = runs
    mon = SloMonitor.from_fleet(dep.fleet)
    nid = next(iter(out))
    lat = [40e-6 + 1e-6 * (i % 97) for i in range(4 * mon.window)]
    for v in lat[:mon.window]:
        mon.observe(nid, v)
    t0 = time.perf_counter()
    for v in lat[mon.window:]:
        mon.observe(nid, v)
    out["observe_us"] = (time.perf_counter() - t0) / (3 * mon.window) * 1e6
    log("slo cost, closed-loop edge calls " + json.dumps(out, sort_keys=True))
    return out


def scenario_phase(dep, cfg, params) -> dict:
    """Phase 7d, on 7b's mixed deployment after 7c and before any profiler
    session: the monitor's cost on closed-loop edge calls; each scenario
    replayed with ``serve(fresh=True)`` (the SLO monitor on, the
    reference's default) at the reference's default knobs; the flash crowd
    again with ``slo=False``; a 5 s flash crowd of 32-prompt, 32-token LM
    requests with and without the monitor; the flash crowd under an
    ``engine_exception`` burst on ``jet_tagger`` (in process); and ``python
    -m repro_torch replay`` and ``chaos`` with the published LM in their own
    processes.  Counters are zeroed just before each replay and read just
    after.  Every check fails the run."""
    import os
    import torch
    from repro_torch.faults import FaultPlan
    from repro_torch.kernels import ops
    from repro_torch.obs import workload
    from repro_torch.serve import engine

    tenants = {t.net_id: t.plan.kind for t in dep.fleet.tenants}
    nid_lm = cfg.name
    lm_plan = dep.plans[nid_lm]
    alone = engine.ContinuousBatcher(cfg, params, plan=lm_plan,
                                     max_len=LM_SEQ)
    readings, launches = {"knobs": SCENARIO_KW,
                          "slo_cost": slo_cost(dep)}, {}

    def replay(label, drive):
        ops.reset_launches()
        report = drive()
        torch.cuda.synchronize()
        launches[f"scenario {label}"] = ops.launch_counts()
        return report

    def same_tokens(label, report):
        """The LM's served tokens equal a standalone batcher's on the same
        prompts, bit for bit."""
        reqs = {}
        for r in report.records:
            if r.kind == "lm" and r.status == "ok":
                tr = workload.TraceRequest(0.0, r.tenant, "lm",
                                           SCENARIO_KW["prompt_tokens"],
                                           SCENARIO_KW["new_tokens"], r.rid)
                reqs[r.rid] = engine.Request(
                    rid=r.rid, prompt=workload._lm_prompt(tr, cfg.vocab_size),
                    max_new=SCENARIO_KW["new_tokens"])
                alone.submit(reqs[r.rid])
        alone.run_until_drained()
        for r in report.records:
            if r.rid in reqs and reqs[r.rid].out != r.tokens:
                raise SmokeFailure(f"{label}: LM request {r.rid} served "
                                   f"{r.tokens}, a standalone batcher "
                                   f"{reqs[r.rid].out}")
        return len(reqs)

    for name in sorted(workload.SCENARIOS):
        router = _audited(dep.serve(fresh=True))
        if router.slo is None:
            raise SmokeFailure("serve() attached no SLO monitor")
        want = workload.make_scenario(name, tenants, **SCENARIO_KW)
        report = replay(name, lambda: dep.replay(
            name, json_dir=ROOT / "chiprun_out" / "scenarios_7d",
            **SCENARIO_KW))
        if dep.serve() is not router:
            raise SmokeFailure(f"{name}: replay served another router")
        offered = {n: sum(1 for r in want if r.tenant == n) for n in tenants}
        got = {n: s["count"] for n, s in report.summary().items()}
        if got != {n: c for n, c in offered.items() if c}:
            raise SmokeFailure(f"{name}: offered {got}, the generator "
                               f"{offered}")
        bad = [r for r in report.records
               if r.status not in ("ok",) + REFUSALS]
        if bad:
            raise SmokeFailure(f"{name}: records neither ok nor refused: "
                               f"{bad[:3]}")
        checked = same_tokens(name, report)
        rows = _scenario_rows(report, router)
        readings[name] = {"tenants": rows, "wall_s": report.wall_s,
                          "lm_tokens_checked": checked}
        for nid, row in rows.items():
            log(f"scenario {name} {nid} " + json.dumps(row, sort_keys=True))
        log(f"scenario {name}: {len(report.records)} requests in "
            f"{report.wall_s * 1e3:.1f} ms wall; {checked} LM requests' "
            f"tokens equal a standalone batcher's; launches "
            + json.dumps(launches[f"scenario {name}"]))
    log(workload.format_replay(report, slo=router.slo))

    # The flash crowd without the monitor: what deferral costs the LM.
    # ``Deployment.replay`` serves with the default arguments, so this
    # replay goes through ``workload.replay`` on this router.
    router = _audited(dep.serve(slo=False, fresh=True))
    inputs = router.warmup()
    report = replay("flash_crowd slo=False", lambda: workload.replay(
        router, workload.make_scenario("flash_crowd", tenants,
                                       **SCENARIO_KW), inputs=inputs))
    if any(r.status not in ("ok",) + REFUSALS for r in report.records):
        raise SmokeFailure("flash_crowd slo=False: a record neither ok nor "
                           "refused")
    same_tokens("flash_crowd slo=False", report)
    off = _scenario_rows(report, router)
    on = readings["flash_crowd"]["tenants"]
    readings["flash_crowd_slo_off"] = {"tenants": off,
                                       "wall_s": report.wall_s}
    log(f"scenario flash_crowd LM request p50 / p95 us: slo on "
        f"{on[nid_lm]['p50_us']:.1f} / {on[nid_lm]['p95_us']:.1f} "
        f"({on[nid_lm]['deferrals']} deferrals), slo off "
        f"{off[nid_lm]['p50_us']:.1f} / {off[nid_lm]['p95_us']:.1f}")

    # The same comparison at a length that gives the monitor samples: the
    # 5 s flash crowd, with the monitor (``Deployment.replay``) and without.
    long = {}
    for label, slo in (("on", True), ("off", False)):
        router = _audited(dep.serve(slo=slo, fresh=True))
        if slo:
            report = replay("flash_crowd long", lambda: dep.replay(
                "flash_crowd", **LONG_FLASH_KW))
        else:
            inputs = router.warmup()
            report = replay("flash_crowd long slo=False",
                            lambda: workload.replay(router, (
                                workload.make_scenario(
                                    "flash_crowd", tenants,
                                    **LONG_FLASH_KW)), inputs=inputs))
        if any(r.status not in ("ok",) + REFUSALS for r in report.records):
            raise SmokeFailure(f"long flash_crowd slo {label}: a record "
                               f"neither ok nor refused")
        long[label] = {"tenants": _scenario_rows(report, router),
                       "wall_s": report.wall_s}
        for nid, row in long[label]["tenants"].items():
            log(f"scenario flash_crowd long slo {label} {nid} "
                + json.dumps(row, sort_keys=True))
    readings["flash_crowd_long"] = {"knobs": LONG_FLASH_KW, **long}
    on, off = long["on"]["tenants"][nid_lm], long["off"]["tenants"][nid_lm]
    log(f"scenario flash_crowd long LM request p50 / p95 / p99 ms: slo on "
        f"{on['p50_us'] / 1e3:.1f} / {on['p95_us'] / 1e3:.1f} / "
        f"{on['p99_us'] / 1e3:.1f} ({on['deferrals']} deferrals, "
        f"{on['status']}), slo off {off['p50_us'] / 1e3:.1f} / "
        f"{off['p95_us'] / 1e3:.1f} / {off['p99_us'] / 1e3:.1f} "
        f"({off['status']})")

    # Chaos in process: the default burst of the chaos subcommand.
    router = dep.serve(fresh=True)
    injector = FaultPlan.burst("jet_tagger", kind="engine_exception",
                               after=CHAOS_AFTER,
                               count=CHAOS_COUNT).injector()
    t0 = time.perf_counter()
    report = replay("chaos", lambda: dep.replay(
        "flash_crowd", faults=injector, **SCENARIO_KW))
    chaos_s = time.perf_counter() - t0
    health = router.health()
    if dep.serve() is not router:
        raise SmokeFailure("chaos: replay served another router")
    vh = health["tenants"]["jet_tagger"]
    summary = report.summary()
    fired = injector.fired(tenant="jet_tagger")
    served = {n: summary[n]["ok"] for n in tenants if n != "jet_tagger"}
    chaos = {"injected": fired, "failures": vh["failures"],
             "opens": vh["breaker_opens"],
             "recloses": vh["breaker_recloses"], "state": vh["state"],
             "time_to_recovery_s": vh["time_to_recovery_s"],
             "degrades": vh["degrades"], "restores": vh["restores"],
             "co_residents_ok": served, "wall_s": chaos_s,
             "jet_tagger": {k: summary["jet_tagger"][k]
                            for k in ("count", "ok", "fault", "breaker",
                                      "p95_s", "lag_p95_s")}}
    log("scenario chaos " + json.dumps(chaos, sort_keys=True))
    if not (fired > 0 and vh["breaker_opens"] >= 1
            and vh["breaker_recloses"] >= vh["breaker_opens"]
            and vh["state"] == "closed" and all(served.values())):
        raise SmokeFailure(f"chaos: not recovered {chaos}")
    if any(r.status == "stuck" for r in report.records):
        raise SmokeFailure("chaos: a request never finished")
    readings["chaos"] = chaos
    router.arm_faults(None)
    dep.engines["jet_tagger"].restore()

    # The subcommands, as a user runs them.
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli = {}
    for label, argv in SCENARIO_CLI:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch", *argv],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        cli[label] = {"rc": proc.returncode,
                      "s": time.perf_counter() - t0}
        tail = "\n".join(proc.stdout.splitlines()[-24:])
        log(f"scenario cli {label}: rc {proc.returncode} in "
            f"{cli[label]['s']:.1f} s\n{tail}")
        if proc.returncode != 0:
            raise SmokeFailure(f"python -m repro_torch {' '.join(argv)} "
                               f"exited {proc.returncode}:\n{proc.stderr}")
        if label == "chaos":
            verdict = [l for l in proc.stdout.splitlines()
                       if l.startswith("chaos: ")]
            cli[label]["verdict"] = verdict[-1] if verdict else None
            if not verdict or not verdict[-1].startswith("chaos: RECOVERED"):
                raise SmokeFailure(f"chaos subcommand verdict {verdict}")
    readings["cli"] = cli
    del alone
    gc.collect()
    torch.cuda.empty_cache()
    return {"readings": readings, "launches": launches}


# ---------------------------------------------------------------------------
# Phase 7e: the instruments on the card
# ---------------------------------------------------------------------------

INSTRUMENT_EDGE_REQUESTS = 50
INSTRUMENT_LM_REQUESTS = 8
INSTRUMENT_TOKENS = 16
TRACE_COST_CALLS = 2000
TRACE_COST_ROUNDS = 4
USEFUL_TOL = 1e-6
INSTRUMENT_CLI = (
    ("trace", ["trace", "jet_tagger", "tau_select", "--lm",
               "recurrentgemma_2b", "--lm-config", "published",
               "--trace-out", "chiprun_out/trace_7e"]),
    ("profile", ["profile", "jet_tagger", "tau_select", "--lm",
                 "recurrentgemma_2b", "--lm-config", "published",
                 "--json-dir", "chiprun_out/profile_7e"]))


def _strict_json(text: str):
    def refuse(const):
        raise SmokeFailure(f"trace.json holds {const}")
    return json.loads(text, parse_constant=refuse)


def trace_cost(dep) -> dict:
    """What tracing costs an edge request: closed-loop ``router.infer``
    calls on each edge tenant with the deployment's tracer off and on,
    ``TRACE_COST_ROUNDS`` rounds in the order off, on, on, off (the same
    router and engines), as the p50 of all of a side's calls, its calls a
    second and each run's p50; ``Tracer.add`` alone, the work a traced
    call adds per span, and adding an edge graph's work record, the work a
    replay adds (both printed, not judged)."""
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import Tracer
    router = dep.serve()
    inputs = router.warmup()
    out = {}
    for nid, x in inputs.items():
        calls = {"untraced": [], "traced": []}
        walls = {"untraced": 0.0, "traced": 0.0}
        runs = {"untraced": [], "traced": []}
        for label in ("untraced", "traced", "traced", "untraced") \
                * TRACE_COST_ROUNDS:
            dep.tracer.enabled = label == "traced"
            run = []
            t_start = time.perf_counter()
            for _ in range(TRACE_COST_CALLS):
                t0 = time.perf_counter()
                router.infer(nid, x)
                run.append(time.perf_counter() - t0)
            walls[label] += time.perf_counter() - t_start
            calls[label] += run
            runs[label].append(statistics.median(run) * 1e6)
        out[nid] = {label: {"p50_us": statistics.median(calls[label]) * 1e6,
                            "calls_per_s": len(calls[label]) / walls[label],
                            "run_p50_us": runs[label]}
                    for label in calls}
    dep.tracer.enabled = True
    scratch = Tracer()
    t0 = time.perf_counter()
    for i in range(TRACE_COST_CALLS):
        scratch.add("infer", 0.0, 4e-5, trace=i, tenant="jet_tagger")
    out["add_us"] = (time.perf_counter() - t0) / TRACE_COST_CALLS * 1e6
    # What the work records cost a replayed edge call: adding its graph's
    # record (put back after).
    graphs = dep.engines[SERVED[0]].graph_report()
    work = next(iter(graphs.values()))["work"] if graphs else {}
    before = ops.work_counts()
    t0 = time.perf_counter()
    for _ in range(TRACE_COST_CALLS):
        ops.add_work(work)
    out["record_us"] = (time.perf_counter() - t0) / TRACE_COST_CALLS * 1e6
    ops.set_work(before)
    log("instruments trace cost, closed-loop edge calls "
        + json.dumps(out, sort_keys=True))
    return out


def instruments_phase(cfg, params) -> dict:
    """Phase 7e: 7b's fleet built again with ``trace=True`` and its
    instruments read on the card (see the module doc).  Counters are zeroed
    just before the traced replay and read just after.  Every check fails
    the run."""
    import dataclasses
    import os
    import tempfile
    import torch
    from repro_torch.deploy import Deployment
    from repro_torch.kernels import ops
    from repro_torch.obs import parse_prometheus, workload

    t_phase = time.perf_counter()
    dep = Deployment.build([*SERVED, cfg], lm_params={cfg.name: (cfg, params)},
                           max_len=LM_SEQ, trace=True)
    tenants = {t.net_id: t.plan.kind for t in dep.fleet.tenants}
    router = dep.serve()
    inputs = router.warmup()
    trace = workload.smoke_trace(
        tenants, edge_iters=INSTRUMENT_EDGE_REQUESTS,
        lm_requests=INSTRUMENT_LM_REQUESTS, prompt_tokens=INSTRUMENT_TOKENS,
        new_tokens=INSTRUMENT_TOKENS)
    ops.reset_launches()
    report = workload.replay(router, trace, inputs=inputs)
    torch.cuda.synchronize()
    launches, work = ops.launch_counts(), ops.work_counts()
    bad = [r for r in report.records if r.status != "ok"]
    if bad:
        raise SmokeFailure(f"instruments replay: {len(bad)} records not ok: "
                           f"{bad[:3]}")
    # Each edge request is one fused_mlp_q8 launch of its plan's GEMMs.
    edge_flops = sum(INSTRUMENT_EDGE_REQUESTS * dep.plans[n].work()["flops"]
                     for n in SERVED)
    if launches["fused_mlp_q8"] != INSTRUMENT_EDGE_REQUESTS * len(SERVED) \
            or work["fused_mlp_q8"]["flops"] != edge_flops:
        raise SmokeFailure(f"instruments: fused_mlp_q8 launches "
                           f"{launches['fused_mlp_q8']} recorded "
                           f"{work['fused_mlp_q8']}, want {edge_flops} flops")
    missing = [k for k, n in launches.items()
               if n and not (work[k]["flops"] > 0 and work[k]["bytes"] > 0)]
    if missing:
        raise SmokeFailure(f"instruments: launches without a work record "
                           f"{missing}: {work}")
    log("instruments replay launches " + json.dumps(launches, sort_keys=True)
        + " work " + json.dumps(work, sort_keys=True))

    # trace.json and metrics.prom, read back strictly.
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = dep.export_trace(pathlib.Path(tmp) / "trace.json")
        prom_path = dep.export_prometheus(pathlib.Path(tmp) / "metrics.prom")
        payload = _strict_json(trace_path.read_text())
        prom_text = prom_path.read_text()
    events = [e for e in payload["traceEvents"] if e["ph"] == "X"]
    n_spans = len(dep.tracer)
    if len(events) != n_spans or payload["otherData"]["spans"] != n_spans:
        raise SmokeFailure(f"trace.json: {len(events)} events for "
                           f"{n_spans} spans")
    seen = {(e["cat"], e["name"]) for e in events}
    want = {(n, "infer") for n in SERVED} | {(cfg.name, "decode_step"),
                                             (cfg.name, "request")}
    if not want <= seen:
        raise SmokeFailure(f"trace.json lacks {sorted(want - seen)}")
    samples = parse_prometheus(prom_text)
    families = {(s["name"], s["labels"].get("tenant")) for s in samples}
    per_tenant = ["repro_span_seconds", "repro_span_seconds_count",
                  "repro_span_seconds_sum", "repro_profile_achieved_flops",
                  "repro_profile_achieved_bytes_per_second",
                  "repro_profile_roofline_fraction",
                  "repro_profile_bound_info", "repro_slo_budget_seconds",
                  "repro_slo_latency_seconds", "repro_slo_burn_rate",
                  "repro_slo_violations_total",
                  "repro_resilience_failures_total",
                  "repro_resilience_breaker_state",
                  "repro_resilience_degrade_level"]
    lost = [(name, t) for t in tenants for name in per_tenant
            if (name, t) not in families]
    lost += [("repro_profile_measured_lare", t) for t in SERVED
             if ("repro_profile_measured_lare", t) not in families]
    if ("repro_tracer_dropped_total", None) not in families:
        lost.append(("repro_tracer_dropped_total", None))
    if lost:
        raise SmokeFailure(f"metrics.prom lacks {lost}")
    log(f"instruments export: trace.json {len(events)} events = "
        f"{n_spans} spans ({dep.tracer.dropped} dropped), metrics.prom "
        f"{len(samples)} samples in {len({n for n, _ in families})} "
        f"series names, every tenant's families read back")
    log("instruments attribution\n" + dep.format_attribution())

    rows = dep.profile()
    log("instruments profile\n" + dep.format_profile())
    profile_rows = {}
    for r in rows:
        if r.group is not None:
            continue
        profile_rows[f"{r.tenant} {r.kind}"] = {
            "count": r.count, "p50_us": r.measured_p50_s * 1e6,
            "ceiling_us": r.ceiling_s * 1e6, "bound": r.bound,
            "fraction": r.roofline_fraction, "raw_fraction": r.raw_fraction,
            "achieved_ops_per_s": r.achieved_flops,
            "achieved_bytes_per_s": r.achieved_bytes_per_s,
            "t_compute_us": r.t_compute_s * 1e6,
            "t_memory_us": r.t_memory_s * 1e6,
            "t_launch_us": r.t_launch_s * 1e6,
            "measured_lare": r.measured_lare}
    log("instruments profile rows " + json.dumps(profile_rows,
                                                 sort_keys=True))
    ceilings = dataclasses.asdict(dep.profile_hw())
    log("instruments ceilings " + json.dumps(ceilings, sort_keys=True))

    overhead = dep.graph_overhead()
    log("instruments graph_overhead " + json.dumps(overhead, sort_keys=True))
    for n in SERVED:
        uf = overhead[n]["useful_fraction"]
        if uf is None or abs(uf - 1.0) > USEFUL_TOL:
            raise SmokeFailure(f"{n}: useful_fraction {uf}, want 1 within "
                               f"{USEFUL_TOL}")

    cost = trace_cost(dep)

    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli = {}
    for label, argv in INSTRUMENT_CLI:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch", *argv],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        cli[label] = {"rc": proc.returncode, "s": time.perf_counter() - t0}
        tail = "\n".join(proc.stdout.splitlines()[-30:])
        log(f"instruments cli {label}: rc {proc.returncode} in "
            f"{cli[label]['s']:.1f} s\n{tail}")
        if proc.returncode != 0:
            raise SmokeFailure(f"python -m repro_torch {' '.join(argv)} "
                               f"exited {proc.returncode}:\n{proc.stderr}")
        out_dir = ROOT / argv[-1]
        files = sorted(p.name for p in out_dir.iterdir())
        want_files = ({"trace.json", "metrics.prom"} if label == "trace"
                      else set()) | {
            f"BENCH_{'serve' if label == 'trace' else 'profile'}_{n}.json"
            for n in (*SERVED, cfg.name)}
        if not want_files <= set(files):
            raise SmokeFailure(f"{label} wrote {files}, want {want_files}")
        cli[label]["files"] = files
    readings = {"launches": launches, "work": work, "spans": n_spans,
                "profile": profile_rows, "graph_overhead": overhead,
                "trace_cost": cost, "cli": cli,
                "wall_s": time.perf_counter() - t_phase}
    log("instruments readings " + json.dumps(
        {k: v for k, v in readings.items() if k != "profile"},
        sort_keys=True))
    del router, dep
    gc.collect()
    torch.cuda.empty_cache()
    return {"readings": readings, "launches": {"instruments": launches}}


def edge_call_split(deps: dict, iters: int = BENCH_ITERS) -> dict:
    """The host parts of one graphed edge call (input copy, replay, output
    clone, stream synchronize; p50 us over ``iters`` calls), for each edge
    engine of each deployment, timed back to back: engines of two
    deployments timed at one moment tell the process's state from the
    engines' own cost (printed, not judged).  Each engine's fused rung is
    captured anew, whatever rung it serves now."""
    import torch
    from repro_torch.kernels.graph import GraphedForward
    out = {}
    for label, dep in deps.items():
        for tp in dep.fleet.tenants:
            if tp.plan.kind != "edge":
                continue
            eng = dep.engines[tp.net_id]
            x = torch.ones((tp.plan.batch, eng.cfg.dims[0]),
                           device=dep.device)
            fwd = GraphedForward(eng._fwd, x.shape, dep.device)
            fwd(x)
            parts = {"copy": [], "replay": [], "clone": [], "sync": []}
            for _ in range(iters):
                t0 = time.perf_counter()
                fwd.static.copy_(x)
                t1 = time.perf_counter()
                y = fwd.graph()
                t2 = time.perf_counter()
                y.clone()
                t3 = time.perf_counter()
                torch.cuda.current_stream().synchronize()
                t4 = time.perf_counter()
                for k, a, b in (("copy", t0, t1), ("replay", t1, t2),
                                ("clone", t2, t3), ("sync", t3, t4)):
                    parts[k].append((b - a) * 1e6)
            out[f"{label} {tp.net_id}"] = {k: statistics.median(v)
                                           for k, v in parts.items()}
    log("edge call split, p50 us " + json.dumps(out, sort_keys=True))
    return out


def bench_after_profiler(fleet: dict) -> None:
    """The fleet's edge engines timed again after phase 8's profiler
    sessions, beside their time before them: the host cost a traced run
    leaves on later calls in the same process (printed, not judged)."""
    dep = fleet.pop("deployment")
    rows = dep.bench(iters=BENCH_ITERS)
    after = {r.net_id: r.measured_s * 1e6 for r in rows}
    fleet["fleet"]["bench_p50_us_after_profiler"] = after
    log("fleet bench after the profiler sessions: p50 us "
        + json.dumps({"before": fleet["fleet"]["bench_p50_us"],
                      "after": after}, sort_keys=True))


# ---------------------------------------------------------------------------
# Phase 6: the LM kernels against their plain versions on the card
# ---------------------------------------------------------------------------

# (label, B, Hq, Hkv, S, D, dtype, options)
FLASH_CASES = (
    ("served", 1, 10, 1, LM_SEQ, 256, "bfloat16",
     {"causal": True, "window": 2048}),
    ("served", 1, 10, 1, LM_SEQ, 256, "float32",
     {"causal": True, "window": 2048}),
    ("gqa+softcap+ragged", 1, 8, 4, 1000, 256, "float32",
     {"causal": True, "window": 512, "softcap": 50.0}),
    ("gqa+softcap+ragged", 1, 8, 4, 1000, 256, "bfloat16",
     {"causal": True, "window": 512, "softcap": 50.0}),
    ("non-causal ragged", 1, 2, 1, 1000, 256, "float32", {"causal": False}),
)
# A chunk of 8 queries at key position q_offset, (1, 10, 8, 256) against
# one KV head, window 2048 (recurrentgemma-2b's attention): against the
# unrolled ring (Sk = q_offset + 8, the chunked prefill's) and against a
# cache buffer of 2056 keys (keys past a query masked by causal); with and
# without softcap.
FLASH_CHUNK = 8
FLASH_OFFSETS = (0, 1, 2047, 2048)
FLASH_BUFFER = 2056
SCAN_CASES = (("forward", (1, LM_SEQ, 2560)),
              ("decode tick", (LM_SLOTS, 1, 2560)),
              ("ragged prefill", (2, LM_LONG_PROMPT, 2560)))
# T of the sweep that sets each scan's CHUNKED_MIN_T: the sequential and the
# chunked kernel at each, at B = 1 (a multi-token step is one prompt).
THRESHOLD_TS = (2, 8, 16, 32, 64, 128, 256, 512)


def _qkv(gen, device, b, hq, hkv, s, d, dtype):
    import torch
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _scan_inputs(gen, device, shape):
    import torch
    a = torch.rand(shape, generator=gen, device=device) * 0.6 + 0.399
    return a, torch.randn(shape, generator=gen, device=device)


def lm_kernel_phase(device) -> dict:
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    gen = torch.Generator(device=device).manual_seed(3)
    errs = {"flash_attention": 0.0, "linear_scan": 0.0}
    for label, b, hq, hkv, s, d, dt, kw in FLASH_CASES:
        q, k, v = _qkv(gen, device, b, hq, hkv, s, d, getattr(torch, dt))
        rtol, atol = TOL_FLASH[dt]
        want = fa.flash_attention_plain(q, k, v, **kw)
        err = check_close(f"flash_attention {label} {dt}",
                          fa.flash_attention_cuda(q, k, v, **kw), want,
                          tol=rtol, atol=atol)
        rms = float(want.float().square().mean().sqrt())
        if dt == "float32" and err > TOL_FLASH_RMS * rms:
            raise SmokeFailure(f"flash_attention {label}: max abs err {err} "
                               f"beyond {TOL_FLASH_RMS} of the output RMS "
                               f"{rms}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        log(f"kernel flash_attention {label} q={list(q.shape)} "
            f"k={list(k.shape)} {dt} {kw}: max_abs_err={err} rtol={rtol} "
            f"atol={atol} out_rms={rms} err/rms={err / rms}")
    for dt in ("bfloat16", "float32"):
        rtol, atol = TOL_FLASH[dt]
        for off in FLASH_OFFSETS:
            for sk in (off + FLASH_CHUNK, FLASH_BUFFER):
                for softcap in (None, 30.0):
                    q = torch.randn((1, 10, FLASH_CHUNK, 256), generator=gen,
                                    device=device).to(getattr(torch, dt))
                    k, v = (torch.randn((1, 1, sk, 256), generator=gen,
                                        device=device).to(getattr(torch, dt))
                            for _ in range(2))
                    kw = {"causal": True, "window": 2048,
                          "softcap": softcap, "q_offset": off}
                    err = check_close(
                        f"flash_attention chunk q_offset={off} Sk={sk} "
                        f"softcap={softcap} {dt}",
                        fa.flash_attention_cuda(q, k, v, **kw),
                        fa.flash_attention_plain(q, k, v, **kw), tol=rtol,
                        atol=atol)
                    errs["flash_attention"] = max(errs["flash_attention"],
                                                  err)
                    log(f"kernel flash_attention chunk q={list(q.shape)} "
                        f"k={list(k.shape)} {dt} {kw}: max_abs_err={err} "
                        f"rtol={rtol} atol={atol}")
    errs["flash_attention"] = max(errs["flash_attention"],
                                  tf_flash_checks(gen, device))
    for label, shape in SCAN_CASES:
        a, b = _scan_inputs(gen, device, shape)
        err = check_close(f"linear_scan {label}", rg.linear_scan_cuda(a, b),
                          rg.linear_scan_plain(a, b), tol=TOL_SCAN)
        errs["linear_scan"] = max(errs["linear_scan"], err)
        log(f"kernel linear_scan {label} {list(shape)} float32: "
            f"max_abs_err={err} tol={TOL_SCAN}")
    torch.cuda.synchronize(device)
    return errs


# ---------------------------------------------------------------------------
# Phases 7 and 8: the LM forward and serving, through the user's entry points
# ---------------------------------------------------------------------------

def layer_counts(cfg) -> tuple[dict, dict]:
    """LM kernel launches of one full-sequence step and of one decode tick.
    Griffin: flash per attention layer on the full sequence only, the scan
    per recurrent layer on both; RWKV: ``rwkv6_scan`` per layer on both;
    the transformer: flash per layer on the full sequence only (its decode
    attention is plain, as in the reference)."""
    zero = dict.fromkeys(LM_KERNELS, 0)
    if cfg.family == "transformer":
        return {**zero, "flash_attention": cfg.num_layers}, dict(zero)
    if cfg.family == "rwkv":
        step = {**zero, "rwkv6_scan": cfg.num_layers}
        return step, dict(step)
    pattern = cfg.griffin.pattern
    kinds = [pattern[i % len(pattern)] for i in range(cfg.num_layers)]
    step = {**zero, "flash_attention": kinds.count("attn"),
            "linear_scan": kinds.count("rec")}
    return step, {**step, "flash_attention": 0}


def lm_counts(launches) -> dict:
    return {k: launches[k] for k in LM_KERNELS}


def lm_forward_phase(arch: str, seq: int = LM_SEQ,
                     layers: int | None = None):
    """``api.init`` of ``arch`` at full width and depth (or its first
    ``layers``) from a seeded CUDA generator and ``api.forward`` at B=1 and
    ``seq``: finite logits of the right shape and the family's launches.
    Before it, the model's float32 copy decodes 64 tokens against its own
    forward's last row, and is freed before the model in its own dtype is
    drawn (gemma2-9b's f32 copy is 37 GB whole)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import api, tree
    # Float32 products stay float32 (the consistency check below).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get(arch).config
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    per_step, per_tick = layer_counts(cfg)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, seq)).astype(np.int32)

    # Decode against the forward, in float32 on a 64-token prompt.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = api.init(cfg32, torch.Generator(device="cuda").manual_seed(0))
    toks = tokens[:, :LM_CONSISTENCY_TOKENS]
    full = api.forward(params32, cfg32, {"tokens": toks})["logits"][:, -1]
    state = api.init_decode_state(cfg32, 1, seq)
    step_logits = None
    for t in range(LM_CONSISTENCY_TOKENS):
        step_logits, state = api.decode_step(params32, cfg32,
                                             toks[:, t:t + 1], state, t)
    err = check_close(f"{cfg.name} float32 decode vs forward",
                      step_logits[:, 0], full, tol=TOL_LM_F32)
    log(f"lm {cfg.name} float32 ({cfg32.num_layers} layers) decode vs "
        f"forward over {LM_CONSISTENCY_TOKENS} tokens: max_abs_err={err} "
        f"tol={TOL_LM_F32}")
    del params32, state, full, step_logits
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    on_card(params["emb"], "api.init's model")
    log(f"lm init {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_params} params {cfg.dtype} in "
        f"{time.perf_counter() - t0:.2f} s")
    ops.reset_launches()
    t0 = time.perf_counter()
    logits = api.forward(params, cfg, {"tokens": tokens})["logits"]
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    want_shape = (1, seq, cfg.padded_vocab)
    if tuple(logits.shape) != want_shape:
        raise SmokeFailure(f"forward logits {tuple(logits.shape)}, want "
                           f"{want_shape}")
    if not bool(torch.isfinite(logits).all()):
        raise SmokeFailure("forward logits are not finite")
    if lm_counts(launches) != per_step:
        raise SmokeFailure(f"{cfg.name} forward launched {launches}, want "
                           f"{per_step}")
    log(f"lm {cfg.name} forward B=1 S={seq}: {forward_s:.3f} s (first "
        f"call, host clock), launches {json.dumps(launches)}, logits "
        f"|max| {float(logits.abs().max())}")
    del logits
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, params, tokens, launches, per_step, per_tick


def serve_run(cfg, params, prompts, max_new, per_tick, label,
              graphs=None, max_len: int | None = None):
    """Serve ``prompts`` through a fresh ``ContinuousBatcher`` (its tick a
    CUDA graph unless ``graphs=False``) until drained, counters zeroed just
    before and read just after.  Returns the batcher and a row of rates:
    overall, and prefill and decode apart from the batcher's own spans
    (``prefill_chunk``: a prompt fed token by token; ``decode_step``: one
    batched tick over the live slots).  A graphed tick's kernel nodes are
    held to the LM kernels' launches a step makes.  ``max_len`` is the
    state's (``LM_SEQ`` by default)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import engine
    batcher = engine.ContinuousBatcher(
        cfg, params, slots=LM_SLOTS, graphs=graphs,
        max_len=LM_SEQ if max_len is None else max_len)
    reqs = [engine.Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    ops.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        batcher.submit(r)
    batcher.run_until_drained()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    bad = [r.rid for r in reqs
           if not r.done or r.error or len(r.out) != max_new]
    if bad or batcher.faults:
        raise SmokeFailure(f"serve {label}: requests {bad} unfinished or "
                           f"failed, {batcher.faults} faults")
    prompt_tokens = sum(len(p) for p in prompts)
    steps = prompt_tokens + batcher.decode_steps_observed
    want = {k: n * steps for k, n in per_tick.items()}
    if lm_counts(launches) != want:
        raise SmokeFailure(f"serve {label} launched {launches}, want {want} "
                           f"for {steps} decode steps")
    stats = batcher.span_stats()
    pre, dec = stats["prefill_chunk"], stats["decode_step"]
    for kind, agg in (("prefill_chunk", pre), ("decode_step", dec)):
        if agg["count"] != agg["total_count"]:
            raise SmokeFailure(f"serve {label}: the {kind} window dropped "
                               f"spans; its totals are not the run's")
    n_out = sum(len(r.out) for r in reqs)
    # Each request's first token comes from its prefill, the rest from
    # decode ticks.
    decode_tokens = n_out - len(reqs)
    row = {"requests": len(reqs), "slots": LM_SLOTS,
           "prompt_lens": [len(p) for p in prompts], "max_new": max_new,
           "out_tokens": n_out, "wall_s": wall_s, "tok_per_s": n_out / wall_s,
           "prefill_steps": prompt_tokens, "prefill_s": pre["total_s"],
           "prefill_tok_per_s": prompt_tokens / pre["total_s"],
           "decode_ticks": dec["count"], "decode_tokens": decode_tokens,
           "decode_s": dec["total_s"],
           "decode_tok_per_s": decode_tokens / dec["total_s"],
           "decode_p50_ms": dec["p50_s"] * 1e3,
           "decode_p95_ms": dec["p95_s"] * 1e3, "launches": launches,
           "graphed": graphs is not False}
    report = batcher.graph_report()
    if (graphs is not False) != (report is not None):
        raise SmokeFailure(f"serve {label}: graph report {report}")
    if report is not None:
        row["graph"] = graph_kernel_nodes({"tick": report})["tick"]
        if {k: report["launches"][k] for k in per_tick} != per_tick:
            raise SmokeFailure(f"serve {label}: the captured tick launches "
                               f"{report['launches']}, want {per_tick}")
    log(f"lm {cfg.name} serve {label} " + json.dumps(row, sort_keys=True))
    log(f"lm {cfg.name} serve {label} span_stats "
        + json.dumps(stats, sort_keys=True))
    return batcher, row


def _union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def decode_tick_trace(batcher, cfg, n_ticks: int) -> dict:
    """The device's busy and idle time over ``n_ticks`` batched decode
    ticks with every slot live, from a ``torch.profiler`` trace: busy is
    the union of the device activities (kernels, copies) inside the host
    span of the ticks, which ends in a synchronize; the ``TRACE_TOP``
    device activities by name with their ms a tick."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.serve import engine
    rng = np.random.default_rng(1)
    reqs = [engine.Request(rid=10_000 + i,
                           prompt=rng.integers(1, cfg.vocab_size, 1)
                           .astype(np.int32), max_new=n_ticks + 2)
            for i in range(batcher.slots)]
    for r in reqs:
        batcher.submit(r)
    # Admit and prefill every slot, and one decode tick: from here on each
    # tick decodes all slots, and n_ticks more finish every request.
    batcher.step()
    torch.cuda.synchronize()
    label = "decode_ticks"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_host = time.perf_counter()
        with record_function(label):
            for _ in range(n_ticks):
                batcher.step()
            torch.cuda.synchronize()
        t_host = time.perf_counter() - t_host
    if not all(r.done and not r.error for r in reqs) or batcher.n_active:
        raise SmokeFailure("traced decode ticks left requests unfinished")
    events = prof.events()
    span = next(e for e in events
                if e.name == label and e.device_type == DeviceType.CPU)
    t0, t1 = span.time_range.start, span.time_range.end
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation and e.name != label]
    window_us = t1 - t0
    out = {"ticks": n_ticks, "host_ms_per_tick": window_us / n_ticks / 1e3,
           "host_clock_ms_per_tick": t_host / n_ticks * 1e3,
           "device_ops_per_tick": len(dev) / n_ticks}
    if not dev:
        out.update(device_busy_ms_per_tick=None, idle_share=None)
        log(f"lm {cfg.name} decode trace: the profiler recorded no device "
            f"activity; idle share not measured " + json.dumps(out))
        return out
    busy_us = _union_us((max(e.time_range.start, t0),
                         min(e.time_range.end, t1)) for e in dev
                        if e.time_range.end > t0 and e.time_range.start < t1)
    by_name: dict = {}
    for e in dev:
        by_name[e.name[:80]] = (by_name.get(e.name[:80], 0.0)
                                + e.time_range.end - e.time_range.start)
    names = sorted(by_name.items(), key=lambda kv: -kv[1])[:TRACE_TOP]
    out.update(device_busy_ms_per_tick=busy_us / n_ticks / 1e3,
               idle_share=1.0 - busy_us / window_us,
               top_device_ms_per_tick={k: v / n_ticks / 1e3
                                       for k, v in names})
    log(f"lm {cfg.name} decode trace " + json.dumps(out, sort_keys=True))
    return out


def lm_serve_phase(cfg, params, tokens, per_step, per_tick, *,
                   eager_gen: int = LM_EAGER_GEN) -> dict:
    """Phase 8's runs (12's for RWKV, 14b's for the transformer): the short
    and decode-heavy runs graphed, the decode-heavy prompts again with the
    tick run eagerly (``eager_gen`` new tokens each), a profiler trace of
    each, the tick parity, and a 3000-token prefill against the forward
    with 8 decode steps."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serve import engine
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size,
                            int(rng.integers(16, 65))).astype(np.int32)
               for _ in range(LM_REQUESTS + LM_SLOTS)]
    _, short = serve_run(cfg, params, prompts[:LM_REQUESTS], LM_MAX_NEW,
                         per_tick, "short")
    batcher, heavy = serve_run(cfg, params, prompts[LM_REQUESTS:],
                               LM_LONG_GEN, per_tick, "decode-heavy")
    trace = decode_tick_trace(batcher, cfg, LM_TRACED_TICKS)
    del batcher
    # The decode-heavy prompts and a trace with the tick run eagerly, fewer
    # new tokens each.
    batcher, eager_heavy = serve_run(cfg, params, prompts[LM_REQUESTS:],
                                     eager_gen, per_tick,
                                     "decode-heavy eager", graphs=False)
    eager_trace = decode_tick_trace(batcher, cfg, LM_TRACED_TICKS)
    del batcher
    parity = tick_parity(cfg, params, prompts[:LM_SLOTS])
    gc.collect()
    torch.cuda.empty_cache()

    # Whole-prompt prefill (for Griffin past the window: the ring roll; for
    # RWKV one launch per layer from the carried state), then decode.
    prefill, decode = engine.build_serve_steps(cfg)
    prompt = tokens[:, :LM_LONG_PROMPT]
    state = api.init_decode_state(cfg, 1, LM_SEQ)
    ops.reset_launches()
    t0 = time.perf_counter()
    last, state = prefill(params, prompt, state)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = last[:, -1].argmax(dim=-1, keepdim=True)
    t0 = time.perf_counter()
    for i in range(LM_LONG_DECODE):
        logits, state = decode(params, tok, state, LM_LONG_PROMPT + i)
        if not bool(torch.isfinite(logits).all()):
            raise SmokeFailure(f"decode step {i} after the long prefill: "
                               f"non-finite logits")
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0) / LM_LONG_DECODE
    long_launches = ops.launch_counts()
    want = {k: per_step[k] + per_tick[k] * LM_LONG_DECODE
            for k in LM_KERNELS}
    if lm_counts(long_launches) != want:
        raise SmokeFailure(f"prefill + decode launched {long_launches}, "
                           f"want {want}")
    ref_last = api.forward(params, cfg, {"tokens": prompt})["logits"][:, -1:]
    err = check_close("prefill vs forward", last, ref_last, tol=3e-2,
                      atol=3e-1)
    log(f"lm {cfg.name} prefill {LM_LONG_PROMPT} tokens: {prefill_s:.3f} s; "
        f"{LM_LONG_DECODE} decode steps {decode_s * 1e3:.3f} ms each (host "
        f"clock); prefill vs forward max_abs_err={err}; launches "
        f"{json.dumps(long_launches)}")
    return {"launches": {"serve": short["launches"],
                         "serve decode-heavy": heavy["launches"],
                         "serve decode-heavy eager": eager_heavy["launches"],
                         "prefill+decode": long_launches},
            "short": short, "decode_heavy": heavy, "trace": trace,
            "decode_heavy_eager": eager_heavy, "trace_eager": eager_trace,
            "tick_parity": parity}


def tick_parity(cfg, params, prompts, max_len: int | None = None) -> dict:
    """One decode tick replayed from the graph and the same tick run
    eagerly from the same state must agree bit for bit: logits and every
    state leaf.  The batcher first admits and prefills ``prompts`` and
    decodes a few ticks (the graph is captured at the first), so the state
    is a served one.  ``max_len`` is the state's (``LM_SEQ`` by
    default)."""
    import numpy as np
    import torch
    from repro_torch.models import tree
    from repro_torch.serve import engine
    b = engine.ContinuousBatcher(
        cfg, params, slots=LM_SLOTS,
        max_len=LM_SEQ if max_len is None else max_len)
    for i, p in enumerate(prompts):
        b.submit(engine.Request(rid=20_000 + i, prompt=p, max_new=64))
    for _ in range(3):
        b.step()
    tok = np.array([[r.out[-1]] for r in b.active], np.int32)
    live = np.ones((b.slots,), bool)
    live[0] = False                              # one idle slot as well
    before = tree.tree_map(torch.clone, b.state)
    graphed = b._decode_masked(tok, live).clone()
    after_graph = tree.tree_map(torch.clone, b.state)
    tree.tree_map(lambda s, v: s.copy_(v), b.state, before)
    eager = b._step().clone()                    # the same static inputs
    worst = float((graphed.float() - eager.float()).abs().max())
    same = torch.equal(graphed, eager) and all(tree.leaves(tree.tree_map(
        torch.equal, after_graph, b.state)))
    kept = all(tree.leaves(tree.tree_map(
        lambda a, c, ax: torch.equal(a.select(ax, 0), c.select(ax, 0)),
        before, after_graph, b._axes)))
    if not (same and kept):
        raise SmokeFailure(f"{cfg.name}: a replayed tick and an eager tick "
                           f"from the same state differ (logits max abs "
                           f"{worst}; idle slot kept: {kept})")
    out = {"bit_exact": True, "leaves": len(tree.leaves(b.state)),
           "replays_before": b.graph_report()["replays"]}
    log(f"lm {cfg.name} tick parity: replayed vs eager tick from the same "
        f"state bit-exact (logits and {out['leaves']} state leaves; idle "
        f"slot unchanged)")
    return out


# ---------------------------------------------------------------------------
# Phases 8q and 12q: int8 LM weights (--quant8) at full width
# ---------------------------------------------------------------------------

QUANT_MIN_SIZE = 1024          # the launcher's --quant8
QUANT_PROMPT = 256             # the forward compared int8 against bf16
# One stacked leaf per family, quantized on the card and on the CPU.
QUANT_LEAF = {"recurrentgemma-2b": ("blocks", "slot0", "rec", "w_x"),
              "rwkv6-7b": ("blocks", "tmix", "wr")}


# Where the RWKV forward's int8 error comes from: the forward through its
# first n layers in int8 against bf16, and the whole depth with the LoRA and
# decay leaves left in bf16.
QUANT_DEPTHS = (1, 2, 4, 8, 16, 32)
QUANT_BF16_LEAVES = ("w1_mix", "w2_mix", "w1_decay", "w2_decay")


def _logit_gap(cfg, qparams, params, prompt) -> dict:
    """The forward's logits in int8 against bf16: the relative RMS and the
    largest difference, the argmax agreement and the largest bf16 logit;
    fails the run on a non-finite int8 logit."""
    import torch
    from repro_torch.models import api
    real = slice(0, cfg.vocab_size)
    with torch.no_grad():
        q = api.forward(qparams, cfg, {"tokens": prompt})["logits"]
        b = api.forward(params, cfg, {"tokens": prompt})["logits"]
    if not bool(torch.isfinite(q).all()):
        raise SmokeFailure(f"quant8 {cfg.name}: non-finite forward logits")
    q, b = q[..., real].float(), b[..., real].float()
    return {"rel_rms": float((q - b).norm() / b.norm()),
            "max_abs_diff": float((q - b).abs().max()),
            "argmax_agreement": float((q.argmax(-1) == b.argmax(-1))
                                      .float().mean()),
            "bf16_max_abs": float(b.abs().max())}


def quant8_depth(cfg, params, qparams, prompt) -> dict:
    """The int8-against-bf16 gap of the forward through the first n layers
    (the embedding and head as they are), and of the whole depth with
    :data:`QUANT_BF16_LEAVES` left in bf16 (printed, not judged)."""
    from repro_torch.models import tree

    def first(p, n):
        return {**p, "blocks": tree.tree_map(lambda t: t[:n], p["blocks"])}

    out = {str(n): _logit_gap(cfg, first(qparams, n), first(params, n),
                              prompt)
           for n in QUANT_DEPTHS if n <= cfg.num_layers}
    tmix = {**qparams["blocks"]["tmix"],
            **{k: params["blocks"]["tmix"][k] for k in QUANT_BF16_LEAVES}}
    mixed = {**qparams, "blocks": {**qparams["blocks"], "tmix": tmix}}
    out["lora_decay_bf16"] = _logit_gap(cfg, mixed, params, prompt)
    log(f"quant8 {cfg.name} forward on {prompt.shape[-1]} tokens by depth, "
        f"int8 against bf16 (reported, not judged): "
        + json.dumps(out, sort_keys=True))
    return out


def _leaf(tree_, path):
    for k in path:
        tree_ = tree_[k]
    return tree_


def _bytes(tree_) -> int:
    from repro_torch.models import tree
    return sum(t.numel() * t.element_size() for t in tree.leaves(tree_))


def quant8_phase(cfg, params, tokens, per_tick, served) -> dict:
    """``quantize_params(params, min_size=1024)`` on the card's bf16
    parameters (bytes and device memory before and after); one stacked leaf
    quantized on the card and on the CPU, bit for bit; phase 8's short and
    decode-heavy runs on a 4-slot batcher over the int8 weights (the tick a
    CUDA graph, every logit finite, the peak memory of each run), beside
    phase 8's bf16 ticks; one quant8 tick graphed and eager from one state,
    bit for bit; the forward's logits on a 256-token prompt in int8 against
    bf16 (printed, not judged); and ``python -m repro_torch.launch.serve
    --arch <arch> --quant8`` in its own process.  Counters are zeroed just
    before each run and read just after."""
    import numpy as np
    import torch
    from repro_torch import runtime
    from repro_torch.serve import engine
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    qparams = engine.quantize_params(params, min_size=QUANT_MIN_SIZE)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    mem_after = torch.cuda.memory_allocated()
    before, after = engine.quantized_bytes(qparams)
    out = {"quantize_s": quant_s,
           "quantized_bytes": {"before": before, "after": after},
           "resident_bytes": {"bf16": _bytes(params),
                              "int8": _bytes(qparams)},
           "memory_allocated": {"before": mem_before,
                                "after_quantize": mem_after}}
    log(f"quant8 {cfg.name}: int8 weights {before / 1e6:.1f} -> "
        f"{after / 1e6:.1f} MB (quantized_bytes), resident "
        f"{out['resident_bytes']['bf16'] / 1e9:.3f} GB bf16 -> "
        f"{out['resident_bytes']['int8'] / 1e9:.3f} GB int8; "
        f"memory_allocated {mem_before / 1e9:.3f} -> {mem_after / 1e9:.3f} "
        f"GB; quantized in {quant_s:.2f} s")

    path = QUANT_LEAF[cfg.name]
    leaf = _leaf(params, path)
    card = _leaf(qparams, path)
    t0 = time.perf_counter()
    cpu = engine.quantize_params({"w": leaf.cpu()}, min_size=1)["w"]
    cpu_s = time.perf_counter() - t0
    for k in ("q8", "scale"):
        if not torch.equal(card[k].cpu(), cpu[k]):
            raise SmokeFailure(f"quant8 {cfg.name}: {'/'.join(path)} {k} on "
                               f"the card differs from the CPU's")
    if not torch.equal(runtime.dequant(card).cpu(), runtime.dequant(cpu)):
        raise SmokeFailure(f"quant8 {cfg.name}: dequant on the card differs "
                           f"from the CPU's")
    out["leaf"] = {"path": "/".join(path), "shape": list(leaf.shape),
                   "bit_exact": True, "cpu_s": cpu_s}
    log(f"quant8 {cfg.name}: {'/'.join(path)} {list(leaf.shape)} quantized "
        f"on the card and on the CPU: q8, scale and dequant bit-exact")
    del cpu
    # One layer's dequant as the model runs it (one pass: int8 read, bf16
    # written), beside the two-step form through an f32 copy, which is
    # bit-identical and moves 19 bytes a weight instead of 3.
    layer = {"q8": card["q8"][0], "scale": card["scale"][0]}
    n = layer["q8"].numel()
    one = event_ms(lambda: runtime.dequant(layer))
    two = event_ms(lambda: (layer["q8"].float() * layer["scale"])
                   .to(torch.bfloat16))
    out["dequant_layer"] = {
        "shape": list(layer["q8"].shape), "ms": one, "two_step_ms": two,
        "bytes": 3 * n, "gb_per_s": 3 * n / one / 1e6,
        "bound_ms": 3 * n / HBM_BW * 1e3}
    log(f"quant8 {cfg.name} dequant of one layer "
        + json.dumps(out["dequant_layer"], sort_keys=True))

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size,
                            int(rng.integers(16, 65))).astype(np.int32)
               for _ in range(LM_REQUESTS + LM_SLOTS)]
    runs = {}
    for label, ps, new in (("short", prompts[:LM_REQUESTS], LM_MAX_NEW),
                           ("decode-heavy", prompts[LM_REQUESTS:],
                            LM_LONG_GEN)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        batcher, row = serve_run(cfg, qparams, ps, new, per_tick,
                                 f"quant8 {label}")
        row["peak_above_resident_gb"] = (
            torch.cuda.max_memory_allocated() - base) / 1e9
        runs[label] = row
        if label == "decode-heavy":
            out["trace"] = decode_tick_trace(batcher, cfg, LM_TRACED_TICKS)
        del batcher
    heavy, bf16 = runs["decode-heavy"], served["decode_heavy"]
    out["ticks"] = {
        "quant8": {k: heavy[k] for k in ("decode_p50_ms", "decode_p95_ms",
                                          "decode_tok_per_s")},
        "bf16": {k: bf16[k] for k in ("decode_p50_ms", "decode_p95_ms",
                                       "decode_tok_per_s")},
        "short_quant8": {k: runs["short"][k] for k in (
            "decode_p50_ms", "decode_p95_ms", "decode_tok_per_s",
            "prefill_tok_per_s")},
        "peak_above_resident_gb": {k: r["peak_above_resident_gb"]
                                   for k, r in runs.items()}}
    log(f"quant8 {cfg.name} ticks " + json.dumps(out["ticks"],
                                                 sort_keys=True))
    out["tick_parity"] = tick_parity(cfg, qparams, prompts[:LM_SLOTS])
    gc.collect()
    torch.cuda.empty_cache()

    prompt = tokens[:, :QUANT_PROMPT]
    out["forward"] = {"tokens": QUANT_PROMPT,
                      **_logit_gap(cfg, qparams, params, prompt)}
    log(f"quant8 {cfg.name} forward on {QUANT_PROMPT} tokens, int8 against "
        f"bf16 logits (reported, not judged): " + json.dumps(out["forward"]))
    if cfg.family == "rwkv":
        out["forward_by_depth"] = quant8_depth(cfg, params, qparams, prompt)
    del qparams
    gc.collect()
    torch.cuda.empty_cache()

    # --quant8 in its own process once (Griffin's); RWKV's in this one.
    out["launcher"] = launcher_run(cfg.name, "--quant8",
                                   own_process=cfg.family != "rwkv")
    return {"readings": out,
            "launches": {f"quant8 {k}": r["launches"]
                         for k, r in runs.items()}}


# ---------------------------------------------------------------------------
# Phase 9: LM kernel times
# ---------------------------------------------------------------------------

def lm_timing_phase(device) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as rg
    gen = torch.Generator(device=device).manual_seed(4)
    label, b, hq, hkv, s, d, dt, kw = FLASH_CASES[0]
    q, k, v = _qkv(gen, device, b, hq, hkv, s, d, getattr(torch, dt))
    pos = torch.arange(s, device=device)
    band = (pos[None, :] <= pos[:, None]) \
        & (pos[None, :] > pos[:, None] - kw["window"])
    kx = k.repeat_interleave(hq // hkv, dim=1)
    vx = v.repeat_interleave(hq // hkv, dim=1)

    def kernel():
        return fa.flash_attention_cuda(q, k, v, **kw)

    def library():
        return F.scaled_dot_product_attention(q, kx, vx, attn_mask=band)

    def library_causal():
        # Causal over the whole sequence, no mask tensor: SDPA's flash
        # backend takes it, at 1.33x the band's work (no window).
        return F.scaled_dot_product_attention(q, kx, vx, is_causal=True)

    check_close("flash library vs kernel", library(), kernel(),
                tol=TOL_FLASH_LIBRARY)
    if not bool(torch.isfinite(library_causal()).all()):
        raise SmokeFailure("causal SDPA output is not finite")
    pairs = int(band.sum()) * b * hq
    flash = {"shape": f"q {list(q.shape)} k/v {list(k.shape)} {dt} {kw}",
             "ms": graph_ms(kernel, inner=5, reps=11),
             "eager_ms": event_ms(kernel, inner=5, reps=11),
             "plain_ms": graph_ms(lambda: fa.flash_attention_plain(
                 q, k, v, **kw), inner=2, reps=5),
             "library_ms": graph_ms(library, inner=5, reps=11),
             "library_causal_ms": graph_ms(library_causal, inner=5, reps=11),
             **bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                     4.0 * d * pairs, PEAK_BF16)}
    log("timing flash_attention " + json.dumps(flash, sort_keys=True))
    flash["chunk"] = flash_chunk_timing(gen, device)
    scan = {}
    for label, shape in SCAN_CASES:
        a, bb = _scan_inputs(gen, device, shape)
        n = a.numel()
        row = {"shape": f"{label} a/b {list(shape)} float32",
               "ms": graph_ms(lambda: rg.linear_scan_cuda(a, bb), inner=20,
                              reps=11),
               "was_ms": sequential_ms(rg, lambda: rg.linear_scan_cuda(
                   a, bb), inner=20),
               "eager_ms": event_ms(lambda: rg.linear_scan_cuda(a, bb),
                                    inner=20, reps=11),
               "plain_ms": graph_ms(lambda: rg.linear_scan_plain(a, bb),
                                    inner=1, reps=3),
               "library_ms": None,
               **bound(3 * 4 * n, 2.0 * n, PEAK_BF16)}
        log("timing linear_scan " + json.dumps(row, sort_keys=True))
        scan[label] = row

    def make(t):
        a, bb = _scan_inputs(gen, device, (1, t, 2560))
        return lambda: rg.linear_scan_cuda(a, bb)
    threshold_sweep("linear_scan", rg, make)
    return {"flash_attention": flash, "linear_scan": scan}


def flash_chunk_timing(gen, device) -> dict:
    """Flash at the chunked prefill's shape past the window: 8 queries at
    q_offset 2048 against the unrolled ring of 2048 cached keys and the
    chunk (Sk = 2056), one KV head, bf16, beside SDPA with the same band
    mask and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    off, sk = FLASH_OFFSETS[-1], FLASH_OFFSETS[-1] + FLASH_CHUNK
    q = torch.randn((1, 10, FLASH_CHUNK, 256), generator=gen,
                    device=device).to(torch.bfloat16)
    k, v = (torch.randn((1, 1, sk, 256), generator=gen,
                        device=device).to(torch.bfloat16) for _ in range(2))
    kw = {"causal": True, "window": 2048, "q_offset": off}
    q_pos = off + torch.arange(FLASH_CHUNK, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    band = (k_pos <= q_pos) & (k_pos > q_pos - kw["window"])
    kx, vx = k.repeat_interleave(10, dim=1), v.repeat_interleave(10, dim=1)

    def kernel():
        return fa.flash_attention_cuda(q, k, v, **kw)

    def library():
        return F.scaled_dot_product_attention(q, kx, vx, attn_mask=band)

    check_close("flash chunk library vs kernel", library(), kernel(),
                tol=TOL_FLASH_LIBRARY)
    pairs = int(band.sum()) * 10
    row = {"shape": f"chunk q {list(q.shape)} k/v {list(k.shape)} bfloat16 "
                    f"{kw}",
           "ms": graph_ms(kernel, inner=20, reps=11),
           "eager_ms": event_ms(kernel, inner=20, reps=11),
           "plain_ms": graph_ms(lambda: fa.flash_attention_plain(
               q, k, v, **kw), inner=5, reps=11),
           "library_ms": graph_ms(library, inner=20, reps=11),
           **bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                   4.0 * 256 * pairs, PEAK_BF16)}
    log("timing flash_attention chunk " + json.dumps(row, sort_keys=True))
    return row


@contextlib.contextmanager
def chunked_from(module, t: int):
    """Send ``module``'s launches of T >= ``t`` to its chunked kernel (and
    shorter ones to the sequential kernel) inside the block."""
    keep = module.CHUNKED_MIN_T
    module.CHUNKED_MIN_T = t
    try:
        yield
    finally:
        module.CHUNKED_MIN_T = keep


def sequential_ms(module, fn, *, inner: int) -> float:
    """Graph-replayed ms of ``fn`` on ``module``'s sequential kernel (the
    kernel the chunked one replaced)."""
    with chunked_from(module, 2 ** 31):
        return graph_ms(fn, inner=inner, reps=11)


def threshold_sweep(name, module, make) -> dict:
    """The sequential and the chunked kernel at each T of ``THRESHOLD_TS``
    (``make(t)`` returns the call), graph-replayed: the measurement behind
    ``module.CHUNKED_MIN_T``."""
    rows = {}
    for t in THRESHOLD_TS:
        fn = make(t)
        with chunked_from(module, 2):
            chunked = graph_ms(fn, inner=20, reps=11)
        rows[t] = {"chunked_ms": chunked,
                   "sequential_ms": sequential_ms(module, fn, inner=20)}
    log(f"threshold {name} (CHUNKED_MIN_T={module.CHUNKED_MIN_T}): "
        + json.dumps(rows, sort_keys=True))
    return rows


# ---------------------------------------------------------------------------
# Phases 10 and 13: rwkv6_scan against its plain version, and its times
# ---------------------------------------------------------------------------

# (label, BH, T, D, heads, dtype, with_state): the forward (B=1, 64 heads of
# 64), a ragged T with per-head u and a carried state, the decode tick.
RWKV_CASES = (
    ("forward", 64, LM_SEQ, 64, 64, "bfloat16", False),
    ("forward", 64, LM_SEQ, 64, 64, "float32", False),
    ("ragged per-head u + state", 48, 1001, 64, 16, "float32", True),
    ("decode tick", LM_SLOTS * 64, 1, 64, 64, "float32", True),
    ("fast decay", 64, 1001, 64, 64, "float32", True),
    ("fast decay", 64, 1001, 64, 64, "bfloat16", True),
    ("w with exact zeros", 64, 1001, 64, 64, "float32", True),
)


def _rwkv_inputs(gen, device, bh, t, d, heads, dtype, with_state):
    """r, k, v (scale 0.5, in ``dtype``), w in (0.5, 0.99), u (heads, D)
    (scale 0.3) and an optional state0, as the reference's kernel test
    draws them."""
    import torch
    dt = getattr(torch, dtype)
    r, k, v = [(torch.randn((bh, t, d), generator=gen, device=device)
                * 0.5).to(dt) for _ in range(3)]
    w = torch.rand((bh, t, d), generator=gen, device=device) * 0.49 + 0.5
    u = torch.randn((heads, d), generator=gen, device=device) * 0.3
    s0 = (torch.randn((bh, d, d), generator=gen, device=device)
          if with_state else None)
    return (r, k, v, w, u), s0


def _rwkv_case_inputs(gen, device, label, bh, t, d, heads, dtype,
                      with_state):
    """As ``_rwkv_inputs``, with w of the cases that do not draw it from
    (0.5, 0.99): the model's fastest decay, exp(-e^4) (a log-decay of -54.6
    a step), for the first 300 steps and 0.99 after; or every 7th step
    w = 0 and every 11th (from 3) w = 1 exactly."""
    import math
    (r, k, v, w, u), s0 = _rwkv_inputs(gen, device, bh, t, d, heads, dtype,
                                       with_state)
    if label == "fast decay":
        w.fill_(0.99)
        w[:, :300] = math.exp(-math.exp(4.0))
    elif label == "w with exact zeros":
        w[:, ::7] = 0.0
        w[:, 3::11] = 1.0
    return (r, k, v, w, u), s0


def rwkv_kernel_phase(device) -> float:
    import torch
    from repro_torch.kernels import rwkv6 as rw
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(5)
    worst = 0.0
    for label, bh, t, d, heads, dt, with_state in RWKV_CASES:
        args, s0 = _rwkv_case_inputs(gen, device, label, bh, t, d, heads, dt,
                                     with_state)
        got, got_s = rw.rwkv6_scan_cuda(*args, state0=s0, return_state=True)
        want, want_s = rw.rwkv6_scan_plain(*args, state0=s0,
                                           return_state=True)
        rtol, atol = TOL_RWKV[dt]
        err = check_close(f"rwkv6_scan {label} {dt}", got, want, tol=rtol,
                          atol=atol)
        err_s = check_close(f"rwkv6_scan {label} {dt} final state", got_s,
                            want_s, tol=TOL_RWKV["float32"][0],
                            atol=TOL_RWKV["float32"][1])
        worst = max(worst, err, err_s)
        rms = float(want.float().square().mean().sqrt())
        log(f"kernel rwkv6_scan {label} r/k/v={[bh, t, d]} {dt} heads={heads} "
            f"state0={with_state}: max_abs_err={err} rtol={rtol} atol={atol} "
            f"out_rms={rms}; final state max_abs_err={err_s} "
            f"tol={TOL_RWKV['float32']}")
    torch.cuda.synchronize(device)
    return worst


def rwkv_scan_bound(bh, t, d, heads, io_bytes, with_state) -> dict:
    """Each input read once and each output written once (r, k, v and the
    output at ``io_bytes`` each, w f32, u, and the f32 state in and out when
    carried); 5 D^2 + 5 D f32 flops per row and step (r.S, r.(u*k), the
    bonus, the decay and the k v^T update) at the f32 rate."""
    n = bh * t * d
    nbytes = 4 * n * io_bytes + 4 * n + 4 * heads * d
    if with_state:
        nbytes += 2 * 4 * bh * d * d
    return bound(nbytes, bh * t * (5.0 * d * d + 5.0 * d), PEAK_F32)


def rwkv_timing_phase(device) -> dict:
    import torch
    from repro_torch.kernels import rwkv6 as rw
    gen = torch.Generator(device=device).manual_seed(6)
    rows = {}
    for label, bh, t, d, heads, dt, with_state in (RWKV_CASES[0],
                                                   RWKV_CASES[3]):
        args, s0 = _rwkv_inputs(gen, device, bh, t, d, heads, dt,
                                with_state)

        def kernel():
            return rw.rwkv6_scan_cuda(*args, state0=s0,
                                      return_state=with_state)

        def plain():
            return rw.rwkv6_scan_plain(*args, state0=s0,
                                       return_state=with_state)
        inner = 5 if t > 1 else 20
        row = {"shape": f"{label} r/k/v {[bh, t, d]} {dt}, w f32, heads "
                        f"{heads}, state in/out {with_state}",
               "ms": graph_ms(kernel, inner=inner, reps=11),
               "was_ms": sequential_ms(rw, kernel, inner=inner),
               "eager_ms": event_ms(kernel, inner=inner, reps=11),
               "plain_ms": graph_ms(plain, inner=1, reps=3),
               "library_ms": None,
               **rwkv_scan_bound(bh, t, d, heads, 2 if dt == "bfloat16"
                                 else 4, with_state)}
        if bh == 64 and dt == "bfloat16":
            # The f32 bound of the recurrent form binds the row; the bytes
            # alone, beside it.
            row["bytes_bound_ms"] = row["bytes"] / HBM_BW * 1e3
        log("timing rwkv6_scan " + json.dumps(row, sort_keys=True))
        rows[label] = row

    def make(t):
        args, s0 = _rwkv_inputs(gen, device, 64, t, 64, 64, "bfloat16", True)
        return lambda: rw.rwkv6_scan_cuda(*args, state0=s0,
                                          return_state=True)
    threshold_sweep("rwkv6_scan", rw, make)
    return rows


# ---------------------------------------------------------------------------
# Phases 14-14d: the dense transformer family
# ---------------------------------------------------------------------------

TF_ARCH = "gemma2-9b"
TF_SEQ = 8192                  # gemma2's published context, past its window
# Phases 14-14b run gemma2-9b at full width, cut in depth since phase 17
# came in: at full depth the whole script read 1,161 s before its last
# phase on a slow host, and with 21 layers and phases 17e-17g 1,109 s;
# with 11 layers and phase 18, 1,247 s on a slow host (PERF.md section
# 4).  5 of its 42 layers: 2 (local, global) blocks and a local tail
# layer.  The launcher's run stays whole.
TF_LAYERS = 5
# The batcher's and the chunked prefill's cache: max_len == gemma2's window
# (LM_SEQ, 4096), so the local layers keep rings and the global layers
# linear buffers, as the reference's rule picks them.
TF_CHUNK = 8
# Phase 14's model-level check past the window: the first two layers (one
# local, one global) over 512 tokens past the 4096 window.
TF_WINDOW_LAYERS = 2
TF_WINDOW_SEQ = 4608
# The mixed fleet's LM requests: the plan's 8-slot tick costs ~0.1-0.2 s
# with gemma2-9b's caches, and the batcher feeds prompts a token a tick.
TF_FLEET_EDGE_REQUESTS = 20
TF_FLEET_PROMPTS = (8, 12, 16, 24)
TF_FLEET_NEW = 16
QWEN_ARCH = "qwen2.5-3b"
QWEN_SEQ = 4096
BIG_ARCH = "gemma2-27b"
BIG_SEQ = 4096                 # 54.4 GB of bf16 weights leave room for it
VL_ARCH = "qwen2-vl-72b"
VL_LAYERS = 8                  # of 80: the 145 GB of bf16 weights need two
VL_SEQ = 4096                  # cards; 8 layers are ~19 GB
# Flash at the family's shapes, phase 6 (against the plain version, bf16 and
# f32, TOL_FLASH) and phase 9 (bf16 times): (label, B, Hq, Hkv, S, Sk, D,
# options).  The gemma2 cases run at S = 8192, where the 4096 window bites.
TF_FLASH_CASES = (
    ("qwen2.5-3b global", 1, 16, 2, 4096, 4096, 128, {"causal": True}),
    ("gemma2-9b local", 1, 16, 8, 8192, 8192, 256,
     {"causal": True, "window": 4096, "softcap": 50.0}),
    ("gemma2-9b global", 1, 16, 8, 8192, 8192, 256,
     {"causal": True, "softcap": 50.0}),
    ("gemma2-27b local", 1, 32, 16, 8192, 8192, 128,
     {"causal": True, "window": 4096, "softcap": 50.0}),
    ("gemma2-27b global", 1, 32, 16, 8192, 8192, 128,
     {"causal": True, "softcap": 50.0}),
    ("qwen2-vl-72b global", 1, 64, 8, 4096, 4096, 128, {"causal": True}),
    # A whole prompt over the max_len buffer (keys past the prompt masked by
    # causal), and the last chunk of 8 of a full buffer.
    ("qwen2.5-3b prefill over cache", 1, 16, 2, 3000, 4096, 128,
     {"causal": True}),
    ("qwen2.5-3b chunk at 4088", 1, 16, 2, 8, 4096, 128,
     {"causal": True, "q_offset": 4088}),
    ("gemma2-9b global prefill over cache", 1, 16, 8, 3000, 4096, 256,
     {"causal": True, "softcap": 50.0}),
    ("gemma2-9b global chunk at 4088", 1, 16, 8, 8, 4096, 256,
     {"causal": True, "softcap": 50.0, "q_offset": 4088}),
    # The MoE transformers: mixtral's 48 query heads over 8 (groups of 6),
    # local past the window; deepseek's expanded MLA at D = 192 (128 + 64,
    # v zero-padded to 192 in the model), which runs launch_tc<256> with
    # the fourth 64-column block past d, and a chunk of it at 4088.
    ("mixtral-8x22b local", 1, 48, 8, 8192, 8192, 128,
     {"causal": True, "window": 4096}),
    ("deepseek-v3 MLA expanded", 1, 128, 128, 4096, 4096, 192,
     {"causal": True}),
    ("deepseek-v3 MLA chunk at 4088", 1, 128, 128, 8, 4096, 192,
     {"causal": True, "q_offset": 4088}),
)
# whisper-medium's flash calls (phase 16): 16 heads of 64, its encoder over
# 1500 frames (not a multiple of a 64-key tile: the last holds 28 keys).
# The encoder's bidirectional self-attention; the decoder's cross-attention
# over the frames on a forward of 448 tokens (the published decoder length)
# and on a decode tick of 4 slots (one query a row); its causal
# self-attention on the forward; a chunk of 8 at q_offset 440.
WHISPER_FLASH_CASES = (
    ("whisper-medium encoder", 1, 16, 16, 1500, 1500, 64,
     {"causal": False}),
    ("whisper-medium cross forward", 1, 16, 16, 448, 1500, 64,
     {"causal": False}),
    ("whisper-medium decode cross", 4, 16, 16, 1, 1500, 64,
     {"causal": False}),
    ("whisper-medium decoder self", 1, 16, 16, 448, 448, 64,
     {"causal": True}),
    ("whisper-medium chunk at 440", 1, 16, 16, 8, 448, 64,
     {"causal": True, "q_offset": 440}),
)
# Phase 9's tile-skip check: 3000 queries over a 4096-key buffer do the work
# of 3000 over 3000 (every tile past the causal edge skipped), at a size
# well above the launch floor.  Without the skip the first would cost about
# 4096 * 3000 / (3000^2 / 2) = 2.7 times the second; the check fails past
# TF_SKIP_MAX_RATIO.
TF_SKIP_CASES = (("prefill S=3000 over Sk=4096", 3000, 4096),
                 ("prefill S=3000 over Sk=3000", 3000, 3000))
TF_SKIP_MAX_RATIO = 1.25


def _tf_qkv(gen, device, b, hq, hkv, s, sk, d, dtype):
    import torch
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, hq, s, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def tf_flash_checks(gen, device) -> float:
    """Phase 6's transformer and whisper cases: each of ``TF_FLASH_CASES``
    and ``WHISPER_FLASH_CASES`` in bf16 and f32 against the plain version
    at ``TOL_FLASH`` (f32 also within ``TOL_FLASH_RMS`` of the output's
    RMS).  Returns the largest error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    worst = 0.0
    for label, b, hq, hkv, s, sk, d, kw in (TF_FLASH_CASES
                                            + WHISPER_FLASH_CASES):
        for dt in ("bfloat16", "float32"):
            q, k, v = _tf_qkv(gen, device, b, hq, hkv, s, sk, d,
                              getattr(torch, dt))
            rtol, atol = TOL_FLASH[dt]
            want = fa.flash_attention_plain(q, k, v, **kw)
            err = check_close(f"flash_attention {label} {dt}",
                              fa.flash_attention_cuda(q, k, v, **kw), want,
                              tol=rtol, atol=atol)
            rms = float(want.float().square().mean().sqrt())
            if dt == "float32" and err > TOL_FLASH_RMS * rms:
                raise SmokeFailure(f"flash_attention {label}: max abs err "
                                   f"{err} beyond {TOL_FLASH_RMS} of the "
                                   f"output RMS {rms}")
            worst = max(worst, err)
            log(f"kernel flash_attention {label} q={list(q.shape)} "
                f"k={list(k.shape)} {dt} {kw}: max_abs_err={err} rtol={rtol} "
                f"atol={atol} out_rms={rms} err/rms={err / rms}")
            del q, k, v, want
    torch.cuda.synchronize(device)
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def _band(s, sk, kw, device):
    """The (S, Sk) mask of the kernel's options, for SDPA."""
    import torch
    q_pos = kw.get("q_offset", 0) + torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    band = k_pos <= q_pos
    if kw.get("window"):
        band &= k_pos > q_pos - kw["window"]
    return band


def tf_flash_row(gen, device, label, b, hq, hkv, s, sk, d, kw, *,
                 mask_free: bool = False) -> dict:
    """One bf16 timing row: the kernel graph-replayed and eager, the plain
    version, SDPA with the band mask (the yardstick: it has no softcap, so
    where the kernel caps its logits SDPA computes less, and its time is
    ``sdpa_no_softcap_ms`` with ``library_ms`` null) and the bound
    max(bytes / 3.35 TB/s, flops / 989 TFLOP/s).  ``mask_free``: SDPA
    without a mask where one call computes the kernel's function so (no
    mask when non-causal, ``is_causal`` for a causal square at offset 0),
    its form in the row's ``library_form``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _tf_qkv(gen, device, b, hq, hkv, s, sk, d, torch.bfloat16)
    band = _band(s, sk, kw, device)
    kx = k.repeat_interleave(hq // hkv, dim=1)
    vx = v.repeat_interleave(hq // hkv, dim=1)
    sdpa_kw, form = {"attn_mask": band}, "band mask"
    if mask_free and not kw.get("window") and not kw.get("softcap"):
        if not kw.get("causal", True):
            sdpa_kw, form = {}, "no mask"
        elif not kw.get("q_offset") and s == sk:
            sdpa_kw, form = {"is_causal": True}, "is_causal"

    def kernel():
        return fa.flash_attention_cuda(q, k, v, **kw)

    def library():
        return F.scaled_dot_product_attention(q, kx, vx, **sdpa_kw)

    inner = 20 if s * sk <= 2 ** 21 else 5
    flops, nbytes = fa.work(b, hq, hkv, s, sk, d, 2,
                            causal=kw.get("causal", True),
                            window=kw.get("window"),
                            q_offset=kw.get("q_offset", 0))
    row = {"shape": f"{label}: q {list(q.shape)} k/v {list(k.shape)} "
                    f"bfloat16 {kw}", "library_form": form,
           "ms": graph_ms(kernel, inner=inner, reps=11),
           "eager_ms": event_ms(kernel, inner=inner, reps=11),
           "plain_ms": graph_ms(lambda: fa.flash_attention_plain(
               q, k, v, **kw), inner=1, reps=3),
           **bound(nbytes, flops, PEAK_BF16)}
    sdpa_ms = graph_ms(library, inner=inner, reps=11)
    if kw.get("softcap"):
        row.update(library_ms=None, sdpa_no_softcap_ms=sdpa_ms)
    else:
        check_close(f"flash {label} library vs kernel", library(), kernel(),
                    tol=TOL_FLASH_LIBRARY)
        row["library_ms"] = sdpa_ms
    log("timing flash_attention " + json.dumps(row, sort_keys=True))
    del q, k, v, kx, vx, band
    gc.collect()
    torch.cuda.empty_cache()
    return row


def tf_timing_phase(device) -> dict:
    """Phase 9's transformer rows: flash at each of ``TF_FLASH_CASES`` in
    bf16, and the tile-skip pair (qwen2.5-3b's heads, causal)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(6)
    rows = [tf_flash_row(gen, device, label, b, hq, hkv, s, sk, d, kw)
            for label, b, hq, hkv, s, sk, d, kw in TF_FLASH_CASES]
    skip = {}
    for label, s, sk in TF_SKIP_CASES:
        skip[label] = tf_flash_row(gen, device, label, 1, 16, 2, s, sk, 128,
                                   {"causal": True})
    (far, near) = (skip[label]["ms"] for label, _, _ in TF_SKIP_CASES)
    log(f"timing flash tile skip: S=3000 over Sk=4096 {far} ms, over "
        f"Sk=3000 {near} ms (ratio {far / near})")
    if far > TF_SKIP_MAX_RATIO * near:
        raise SmokeFailure(f"flash tile skip: 3000 queries over 4096 keys "
                           f"took {far} ms, over 3000 keys {near} ms: more "
                           f"than {TF_SKIP_MAX_RATIO}x, so tiles past the "
                           f"causal edge are not skipped")
    return {"rows": rows, "tile_skip": skip}


def whisper_timing_phase(device) -> list:
    """Phase 9's whisper rows: flash at each of ``WHISPER_FLASH_CASES`` in
    bf16, beside SDPA without a mask where one call computes the same
    function (the non-causal shapes; the causal square)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(16)
    return [tf_flash_row(gen, device, label, b, hq, hkv, s, sk, d, kw,
                         mask_free=True)
            for label, b, hq, hkv, s, sk, d, kw in WHISPER_FLASH_CASES]


def in_process(main, argv: list) -> subprocess.CompletedProcess:
    """``main(argv)`` of an entry point in this process, its standard
    output captured: the same code and checks as its own process, without
    a new process's start and CUDA context."""
    import io
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
    return subprocess.CompletedProcess(argv, rc or 0, buf.getvalue(),
                                       err.getvalue())


def launcher_run(arch: str, *extra: str, own_process: bool = True) -> dict:
    """``python -m repro_torch.launch.serve --arch <arch> [extra]`` in its
    own process, as a user runs it (or its ``main`` in this process):
    exit 0 and a served line."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
            *extra]
    if own_process:
        proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
    else:
        from repro_torch.launch import serve as serve_launch
        proc = in_process(serve_launch.main, argv[3:])
        gc.collect()
        import torch
        torch.cuda.empty_cache()
    out = {"rc": proc.returncode, "s": time.perf_counter() - t0,
           "own_process": own_process,
           "stdout": proc.stdout.splitlines()[:2]}
    log(f"launcher {arch} {' '.join(extra)}"
        f"{'' if own_process else ' (in process)'}: rc {proc.returncode} "
        f"in {out['s']:.1f} s\n{proc.stdout.strip()}")
    if proc.returncode != 0 or " tok/s)" not in proc.stdout \
            or ("--quant8" in extra and "int8 weights" not in proc.stdout):
        raise SmokeFailure(f"python -m repro_torch.launch.serve --arch {arch} "
                           f"{' '.join(extra)} exited {proc.returncode}:\n"
                           f"{proc.stderr}")
    return out


def chunked_prefill_check(cfg, params, tokens, plan, per_step, *,
                          fault: bool = False,
                          prompt_len: int | None = None,
                          max_len: int | None = None) -> dict:
    """``build_serve_steps`` with the plan's ``prefill_chunk``: the
    3000-token prompt in chunks on a ``max_len`` 4096 cache (Griffin's ring
    past its 2048 window; for gemma2 ring local layers and linear global
    ones), each chunk launching what a forward does at its ``q_offset``,
    against the whole-prompt prefill (last logits and every cache or state
    leaf, rtol 3e-2 / atol 3e-1), then 8 decode steps from both.  With
    ``fault``, the chunk-alone fault (the reference's ring prefill) must
    lie outside that limit.  ``prompt_len`` and ``max_len`` change the
    prompt (``LM_LONG_PROMPT``) and the cache (``LM_SEQ``)."""
    prompt_len = LM_LONG_PROMPT if prompt_len is None else prompt_len
    max_len = LM_SEQ if max_len is None else max_len
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api, tree
    from repro_torch.serve import engine
    prompt = tokens[:, :prompt_len]
    chunk = plan.serve["prefill_chunk"]
    chunked, decode = engine.build_serve_steps(cfg, max_len=max_len,
                                               plan=plan)
    whole, _ = engine.build_serve_steps(cfg, max_len=max_len)
    ops.reset_launches()
    t0 = time.perf_counter()
    last_c, state_c = chunked(params, prompt,
                              api.init_decode_state(cfg, 1, max_len))
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    n_chunks = -(-prompt_len // chunk)
    want = {k: per_step[k] * n_chunks for k in LM_KERNELS}
    if lm_counts(launches) != want:
        raise SmokeFailure(f"chunked prefill launched {launches}, want "
                           f"{want}")
    t0 = time.perf_counter()
    last_w, state_w = whole(params, prompt,
                            api.init_decode_state(cfg, 1, max_len))
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    errs = [check_close("chunked prefill vs whole-prompt prefill", last_c,
                        last_w, tol=3e-2, atol=3e-1)]
    state_err = max(check_close(f"state leaf {i} after chunked prefill", a,
                                b, tol=3e-2, atol=3e-1)
                    for i, (a, b) in enumerate(zip(tree.leaves(state_c),
                                                   tree.leaves(state_w))))
    out = {}
    if fault:
        out["chunk_alone_fault"] = chunk_alone_fault(
            cfg, params, prompt, chunked, last_w, state_w)
    tok = last_w[:, -1].argmax(dim=-1, keepdim=True)
    for i in range(LM_LONG_DECODE):
        got, state_c = decode(params, tok, state_c, prompt_len + i)
        want_l, state_w = decode(params, tok, state_w, prompt_len + i)
        errs.append(check_close(f"decode step {i} after chunked prefill",
                                got, want_l, tol=3e-2, atol=3e-1))
        tok = want_l[:, -1].argmax(dim=-1, keepdim=True)
    out.update(chunked_prefill_s=chunked_s, whole_prefill_s=whole_s,
               chunks=n_chunks, launches=launches, max_abs_err=max(errs),
               cache_max_abs_err=state_err)
    log(f"lm {cfg.name} chunked prefill {prompt_len} tokens in "
        f"{n_chunks} chunks of {chunk}: {chunked_s:.3f} s against "
        f"{whole_s:.3f} s whole-prompt (host clock); last logits and "
        f"{LM_LONG_DECODE} decode steps max_abs_err={max(errs)}, state "
        f"leaves {state_err} (rtol 3e-2 atol 3e-1); "
        + (f"the chunk-alone fault {json.dumps(out['chunk_alone_fault'])}; "
           if fault else "")
        + f"launches {json.dumps(launches)}")
    del state_c, state_w, last_c, last_w
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tf_window_check(cfg) -> dict:
    """Phase 14's model-level check past the window: gemma2-9b at full width
    cut to its first two layers (one local, one global), seeded, over a
    prompt of ``TF_WINDOW_SEQ`` tokens, forward through the flash kernel
    against the same forward with flash's plain version, in bf16 (rtol 3e-2
    / atol 3e-1) and float32 (``TOL_LM_F32``).  In float32 the plain
    forward with the window dropped must lie outside ``TOL_LM_F32`` on the
    rows past the window: the local mask is what the check holds."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import api
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (1, TF_WINDOW_SEQ)).astype(
        np.int32)
    real = ops.flash_attention

    def plain(q, k, v, *, drop_window=False, **kw):
        if drop_window:
            kw["window"] = None
        return fa.flash_attention_plain(q, k, v, **kw)

    def run(params, cut, flash):
        ops.flash_attention = flash
        try:
            return api.forward(params, cut, {"tokens": tokens})["logits"]
        finally:
            ops.flash_attention = real

    out = {"seq": TF_WINDOW_SEQ, "layers": TF_WINDOW_LAYERS}
    for dt, (rtol, atol) in (("bfloat16", (3e-2, 3e-1)),
                             ("float32", (TOL_LM_F32, TOL_LM_F32))):
        cut = dataclasses.replace(cfg, num_layers=TF_WINDOW_LAYERS, dtype=dt)
        params = api.init(cut, torch.Generator(device="cuda").manual_seed(4))
        ops.reset_launches()
        got = run(params, cut, real)
        torch.cuda.synchronize()
        n = ops.launch_counts()["flash_attention"]
        if n != TF_WINDOW_LAYERS:
            raise SmokeFailure(f"window check {dt}: {n} flash launches, "
                               f"want {TF_WINDOW_LAYERS}")
        want = run(params, cut, plain)
        out[dt] = check_close(f"{cut.name} {dt} {TF_WINDOW_LAYERS}-layer "
                              f"forward over {TF_WINDOW_SEQ} tokens, kernel "
                              f"vs plain", got, want, tol=rtol, atol=atol)
        del want
        if dt == "float32":
            past = slice(cfg.window, None)
            nowin = run(params, cut, lambda *a, **kw: plain(
                *a, drop_window=True, **kw))[:, past]
            gap = float((got[:, past] - nowin).abs().max())
            if torch.allclose(got[:, past], nowin, rtol=rtol, atol=atol):
                raise SmokeFailure(f"window check: dropping the window "
                                   f"moves the logits past it by {gap} "
                                   f"only, inside rtol/atol {rtol}: the "
                                   f"check cannot see the local mask")
            out["no_window_gap"] = gap
            del nowin
        del params, got
        gc.collect()
        torch.cuda.empty_cache()
    log(f"lm {cfg.name} cut to {TF_WINDOW_LAYERS} layers, {TF_WINDOW_SEQ} "
        f"tokens past the {cfg.window} window, kernel forward vs plain: "
        + json.dumps(out, sort_keys=True))
    return out


def tf_fleet_phase(cfg, params, *, per_tick: dict | None = None,
                   max_len: int | None = None) -> dict:
    """``Deployment.build([jet_tagger, <published gemma2-9b>], lm_params=
    ...)``: a clean verify, then a smoke trace through the router (every
    record ``ok``; counters zeroed just before and read just after: one
    ``fused_mlp_q8`` a edge request, and ``per_tick``'s LM launches each
    time the batcher steps its slots (none by default: a transformer's
    decode tick is plain)), and the same LM requests through a standalone
    batcher under the plan's policy: tokens equal.  ``max_len`` is the
    LM's state (``LM_SEQ`` by default)."""
    import dataclasses
    import torch
    from repro_torch.deploy import Deployment
    from repro_torch.kernels import ops
    from repro_torch.obs import workload
    from repro_torch.serve import engine
    edge_net = SERVED[0]
    max_len = LM_SEQ if max_len is None else max_len
    t0 = time.perf_counter()
    dep = Deployment.build([edge_net, cfg],
                           lm_params={cfg.name: (cfg, params)},
                           max_len=max_len)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if dep.verify != "clean":
        raise SmokeFailure(f"transformer fleet verify: {dep.verify} "
                           f"{dep.findings}")
    lm_plan = dep.plans[cfg.name]
    batcher = dep.engines[cfg.name]
    log(f"transformer fleet build {build_s:.2f} s: "
        + dep.summary().replace("\n", " | "))
    router = dep.serve()
    inputs = router.warmup()
    tenants = {t.net_id: t.plan.kind for t in dep.fleet.tenants}
    trace = workload.smoke_trace(tenants, edge_iters=TF_FLEET_EDGE_REQUESTS,
                                 lm_requests=len(TF_FLEET_PROMPTS),
                                 new_tokens=TF_FLEET_NEW)
    lengths = dict(zip([r.rid for r in trace if r.kind == "lm"],
                       TF_FLEET_PROMPTS))
    trace = [dataclasses.replace(r, prompt_tokens=lengths[r.rid])
             if r.kind == "lm" else r for r in trace]
    steps = [0]                      # the batcher's batched decode steps
    masked = batcher._decode_masked

    def counted(tok, live):
        steps[0] += 1
        return masked(tok, live)
    batcher._decode_masked = counted
    ops.reset_launches()
    report = workload.replay(router, trace, inputs=inputs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    # The class's method again, and no name left holding the batcher: its
    # graph pool must go with it before the standalone batcher is built.
    del batcher._decode_masked, masked, counted
    bad = [r for r in report.records if r.status != "ok"]
    if bad:
        raise SmokeFailure(f"transformer fleet replay: {len(bad)} records "
                           f"not ok: {bad[:3]}")
    want = {"fused_mlp_q8": TF_FLEET_EDGE_REQUESTS,
            **{k: n * steps[0] for k, n in (per_tick or {}).items() if n}}
    others = {k: n for k, n in launches.items() if k not in want and n}
    if {k: launches[k] for k in want} != want or others:
        raise SmokeFailure(f"transformer fleet replay launched {launches}, "
                           f"want {want} and nothing else")
    summary = report.summary()
    dec = batcher.span_stats()["decode_step"]
    lm_records = [r for r in report.records if r.kind == "lm"]
    out = {"build_s": build_s, "replay_wall_s": report.wall_s,
           "edge_p50_us": summary[edge_net]["p50_s"] * 1e6,
           "lm_request_p50_s": summary[cfg.name]["p50_s"],
           "lm_tick_p50_ms": dec["p50_s"] * 1e3,
           "lm_plan_decode_step_ms": lm_plan.est_latency_s * 1e3,
           "lm_slots": batcher.slots, "lm_steps": steps[0],
           "launches": launches}
    log(f"transformer fleet {cfg.name}: the plan's decode step "
        f"{out['lm_plan_decode_step_ms']:.4f} ms against the measured "
        f"{batcher.slots}-slot tick p50 {out['lm_tick_p50_ms']:.4f} ms "
        f"(ratio {out['lm_tick_p50_ms'] / out['lm_plan_decode_step_ms']:.2f})")
    del router, batcher, dep
    gc.collect()
    torch.cuda.empty_cache()
    alone = engine.ContinuousBatcher(cfg, params, plan=lm_plan,
                                     max_len=max_len)
    reqs = {}
    for tr in trace:
        if tr.kind == "lm":
            reqs[tr.rid] = engine.Request(
                rid=tr.rid, prompt=workload._lm_prompt(tr, cfg.vocab_size),
                max_new=tr.new_tokens)
            alone.submit(reqs[tr.rid])
    alone.run_until_drained()
    for r in lm_records:
        if reqs[r.rid].out != r.tokens:
            raise SmokeFailure(f"transformer fleet request {r.rid}: router "
                               f"tokens {r.tokens} != standalone "
                               f"{reqs[r.rid].out}")
    log(f"transformer fleet: {len(lm_records)} LM requests, router tokens "
        f"equal to a standalone batcher's; " + json.dumps(out, sort_keys=True))
    del alone
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tf_forward_only(arch: str, seq: int, layers: int | None = None) -> dict:
    """Phase 14d: ``api.init`` from a seeded CUDA generator at the published
    width (``layers`` cuts the depth), then ``api.forward`` at B=1 and
    ``seq``: finite logits of the right shape and one flash launch a layer.
    qwen2-vl's forward takes seeded patch ``embeddings`` and M-RoPE ids of
    shape (3, 1, S), its vision frontend a stub in the reference too."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import api, tree
    cfg = configs.get(arch).config
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, seq))
             .astype(np.int32)}
    if cfg.mrope_sections is not None:
        dev = params["emb"].device
        gen = torch.Generator(device=dev).manual_seed(1)
        batch["embeddings"] = torch.randn(
            (1, seq, cfg.d_model), generator=gen, device=dev).to(
            params["emb"].dtype)
        # (t, h, w) ids of a 64 x 64 patch grid, time fixed.
        pos = torch.arange(seq, device=dev)
        batch["mrope_positions"] = torch.stack(
            [torch.zeros_like(pos), pos // 64, pos % 64])[:, None]
    ops.reset_launches()
    t0 = time.perf_counter()
    logits = api.forward(params, cfg, batch)["logits"]
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    want_shape = (1, seq, cfg.padded_vocab)
    if tuple(logits.shape) != want_shape \
            or not bool(torch.isfinite(logits).all()):
        raise SmokeFailure(f"{cfg.name} forward logits {tuple(logits.shape)}"
                           f" (want {want_shape}) or not finite")
    want = {**dict.fromkeys(LM_KERNELS, 0),
            "flash_attention": cfg.num_layers}
    if lm_counts(launches) != want:
        raise SmokeFailure(f"{cfg.name} forward launched {launches}, want "
                           f"{want}")
    out = {"arch": arch, "layers": cfg.num_layers, "seq": seq,
           "params": n_params, "init_s": init_s, "forward_s": forward_s,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    log(f"lm {cfg.name} ({cfg.num_layers} layers, {n_params} params) "
        f"forward B=1 S={seq}: {forward_s:.3f} s (first call, host clock), "
        f"logits |max| {float(logits.abs().max())}; "
        + json.dumps(out, sort_keys=True))
    del params, logits, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def transformer_phases(device) -> dict:
    """Phases 14-14d in order, each phase's wall time printed; every model
    freed before the next is drawn."""
    import types
    import torch
    walls, launches = {}, {}
    log(f"transformer phases: {torch.cuda.memory_allocated()} bytes "
        f"allocated at the start")
    t0 = time.perf_counter()
    cfg, params, tokens, fwd, per_step, per_tick = lm_forward_phase(
        TF_ARCH, TF_SEQ, layers=TF_LAYERS)
    launches[f"{TF_ARCH} forward"] = fwd
    # Gemma2 at max_len == window: ring local layers, linear global ones.
    chunked = chunked_prefill_check(
        cfg, params, tokens,
        types.SimpleNamespace(serve={"prefill_chunk": TF_CHUNK}), per_step)
    launches[f"{TF_ARCH} chunked prefill"] = chunked["launches"]
    window = tf_window_check(cfg)
    walls["14"] = time.perf_counter() - t0
    log(f"phase 14 ({TF_ARCH} forward, f32 decode, chunked prefill, the "
        f"window check): {walls['14']:.1f} s")

    t0 = time.perf_counter()
    served = lm_serve_phase(cfg, params, tokens, per_step, per_tick)
    for p, c in served["launches"].items():
        launches[f"{TF_ARCH} {p}"] = c
    fleet = tf_fleet_phase(cfg, params)
    launches[f"{TF_ARCH} fleet replay"] = fleet["launches"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    served["launcher"] = launcher_run(TF_ARCH)
    walls["14b"] = time.perf_counter() - t0
    log(f"phase 14b ({TF_ARCH} serving, fleet, launcher): "
        f"{walls['14b']:.1f} s")

    t0 = time.perf_counter()
    _, qparams, _, qfwd, _, _ = lm_forward_phase(QWEN_ARCH, QWEN_SEQ)
    launches[f"{QWEN_ARCH} forward"] = qfwd
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    qwen = {"launcher": launcher_run(QWEN_ARCH, own_process=False),
            "launcher_quant8": launcher_run(QWEN_ARCH, "--quant8",
                                            own_process=False)}
    walls["14c"] = time.perf_counter() - t0
    log(f"phase 14c ({QWEN_ARCH} forward, launcher, --quant8): "
        f"{walls['14c']:.1f} s")

    t0 = time.perf_counter()
    log(f"phase 14d: {torch.cuda.memory_allocated()} bytes allocated "
        f"before {BIG_ARCH}")
    torch.cuda.reset_peak_memory_stats()
    big = tf_forward_only(BIG_ARCH, BIG_SEQ)
    launches[f"{BIG_ARCH} forward"] = big["launches"]
    torch.cuda.reset_peak_memory_stats()
    vl = tf_forward_only(VL_ARCH, VL_SEQ, layers=VL_LAYERS)
    launches[f"{VL_ARCH} {VL_LAYERS}-layer forward"] = vl["launches"]
    walls["14d"] = time.perf_counter() - t0
    log(f"phase 14d ({BIG_ARCH} forward, {VL_ARCH} cut to {VL_LAYERS} "
        f"layers): {walls['14d']:.1f} s")
    return {"served": served, "chunked": chunked, "window": window,
            "fleet": fleet, "qwen": qwen,
            "forward_only": {BIG_ARCH: big, VL_ARCH: vl},
            "walls_s": walls, "launches": launches,
            "per_step": {TF_ARCH: lm_counts(fwd)["flash_attention"],
                         QWEN_ARCH: lm_counts(qfwd)["flash_attention"]}}


# ---------------------------------------------------------------------------
# Phases 15 and 15b: the MoE transformers at full width, depth cut
# ---------------------------------------------------------------------------

MIXTRAL_ARCH = "mixtral-8x22b"
MIXTRAL_LAYERS = 4             # of 56 (8 before phase 18); a layer is
                               # 2.5 B parameters (5.0 GB)
MIXTRAL_SEQ = 8192             # past the 4096 window
MIXTRAL_F32_LAYERS = 2         # the float32 decode and chunked-prefill cut
DEEPSEEK_ARCH = "deepseek-v3-671b"
DEEPSEEK_LAYERS = 4            # the 3 dense layers and 1 routed one, + MTP
DEEPSEEK_SEQ = 4096
DEEPSEEK_F32_LAYERS = 2        # 1 dense + 1 routed, no MTP head (~56 GB)
DEEPSEEK_DECODE = 32
DEEPSEEK_CHUNKED_PROMPT = 512
DEEPSEEK_CHUNKED_MAX_LEN = 1024
# The batcher ticks' prompts: 4 slots prefilled a token a tick.
MOE_TICK_PROMPTS = (8, 11, 13, 16)


def moe_cut(arch: str, layers: int, *, dtype: str | None = None,
            no_drop: bool = False, first_dense: int | None = None,
            mtp: bool | None = None):
    """The published config at full width cut to ``layers`` layers.
    ``no_drop``: capacity factor E / top_k, so an expert's capacity is
    every token and no assignment drops, whatever the token set (a chunk
    of 8 and the whole prompt then route alike)."""
    import dataclasses
    from repro_torch import configs
    cfg = configs.get(arch).config
    mo_kw = {}
    if no_drop:
        mo_kw["capacity_factor"] = cfg.moe.num_experts / cfg.moe.top_k
    if first_dense is not None:
        mo_kw["first_k_dense"] = first_dense
    kw = {"num_layers": layers,
          "moe": dataclasses.replace(cfg.moe, **mo_kw)}
    if dtype is not None:
        kw["dtype"] = dtype
    if mtp is not None:
        kw["mtp"] = mtp
    return dataclasses.replace(cfg, **kw)


def moe_init(cfg) -> tuple:
    """``api.init`` from a seeded CUDA generator; the parameter count and
    bytes printed."""
    import torch
    from repro_torch.models import api, tree
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    on_card(params["emb"], f"{cfg.name}'s api.init")
    leaves = tree.leaves(params)
    info = {"layers": cfg.num_layers, "dtype": cfg.dtype,
            "capacity_factor": cfg.moe.capacity_factor,
            "params": sum(t.numel() for t in leaves),
            "bytes": sum(t.numel() * t.element_size() for t in leaves),
            "init_s": time.perf_counter() - t0}
    log(f"lm init {cfg.name} cut to {cfg.num_layers} layers "
        f"({cfg.dtype}, mtp={cfg.mtp}): " + json.dumps(info, sort_keys=True))
    return params, info


@contextlib.contextmanager
def counted_drops():
    """The (token, expert) assignments the MoE blocks route and drop for
    capacity while the block runs (read after, one sync a layer)."""
    from repro_torch.models import moe
    real, kept = moe._slots, []

    def slots(flat_e, **kw):
        slot, valid = real(flat_e, **kw)
        kept.append((flat_e.numel(), valid.sum()))
        return slot, valid
    moe._slots = slots
    out: dict = {}
    try:
        yield out
    finally:
        moe._slots = real
        out["assigned"] = sum(n for n, _ in kept)
        out["dropped_per_layer"] = [n - int(v) for n, v in kept]
        out["dropped"] = sum(out["dropped_per_layer"])


def decode_vs_forward(cfg, params, tokens, n: int) -> float:
    """``n`` tokens decoded one by one against the forward's rows, each
    step within ``TOL_LM_F32`` (float32; capacity T, so the forward and
    each one-token step route alike)."""
    from repro_torch.models import api
    toks = tokens[:, :n]
    full = api.forward(params, cfg, {"tokens": toks})["logits"]
    state = api.init_decode_state(cfg, 1, n)
    worst = 0.0
    for t in range(n):
        logits, state = api.decode_step(params, cfg, toks[:, t:t + 1],
                                        state, t)
        worst = max(worst, check_close(
            f"{cfg.name} float32 decode step {t} vs forward row {t}",
            logits[:, 0], full[:, t], tol=TOL_LM_F32))
    log(f"lm {cfg.name} float32 ({cfg.num_layers} layers, capacity factor "
        f"{cfg.moe.capacity_factor}) decode vs forward over {n} tokens: "
        f"max_abs_err={worst} tol={TOL_LM_F32}")
    return worst


def moe_forward(cfg, params, tokens) -> dict:
    """``api.forward`` at B=1 over ``tokens``: finite logits of the right
    shape (and ``mtp_hidden`` with an MTP head), one flash launch a layer,
    and the assignments the capacity drops."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api
    seq = tokens.shape[1]
    ops.reset_launches()
    t0 = time.perf_counter()
    with counted_drops() as drops:
        out = api.forward(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    logits = out["logits"]
    want_shape = (1, seq, cfg.padded_vocab)
    if tuple(logits.shape) != want_shape \
            or not bool(torch.isfinite(logits).all()):
        raise SmokeFailure(f"{cfg.name} forward logits {tuple(logits.shape)}"
                           f" (want {want_shape}) or not finite")
    if cfg.mtp and (tuple(out["mtp_hidden"].shape) != (1, seq, cfg.d_model)
                    or not bool(torch.isfinite(out["mtp_hidden"]).all())):
        raise SmokeFailure(f"{cfg.name} mtp_hidden "
                           f"{tuple(out['mtp_hidden'].shape)} or not finite")
    want = {**dict.fromkeys(LM_KERNELS, 0), "flash_attention": cfg.num_layers}
    if lm_counts(launches) != want:
        raise SmokeFailure(f"{cfg.name} forward launched {launches}, want "
                           f"{want}")
    row = {"seq": seq, "forward_s": forward_s, "launches": launches,
           "aux_loss": float(out["aux_loss"]),
           "capacity_factor": cfg.moe.capacity_factor, **drops}
    log(f"lm {cfg.name} forward B=1 S={seq}: {forward_s:.3f} s (first call, "
        f"host clock), logits |max| {float(logits.abs().max())}; the "
        f"capacity factor {cfg.moe.capacity_factor} drops {drops['dropped']}"
        f" of {drops['assigned']} (token, expert) assignments; "
        + json.dumps(row, sort_keys=True))
    return {**row, "out": out}


def _tick_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(5)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
            for n in MOE_TICK_PROMPTS]


def _phase_end(label: str, t0: float, out: dict) -> None:
    import torch
    out["wall_s"] = time.perf_counter() - t0
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    log(f"phase {label}: {out['wall_s']:.1f} s, peak memory "
        f"{out['peak_memory_bytes']} bytes")
    gc.collect()
    torch.cuda.empty_cache()


def mixtral_phase() -> dict:
    """Phase 15: ``mixtral-8x22b`` at full width, cut in depth."""
    import types
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out, launches = {}, {}
    base = moe_cut(MIXTRAL_ARCH, MIXTRAL_LAYERS)
    tokens = np.random.default_rng(0).integers(
        0, base.vocab_size, (1, MIXTRAL_SEQ)).astype(np.int32)

    cfg32 = moe_cut(MIXTRAL_ARCH, MIXTRAL_F32_LAYERS, dtype="float32",
                    no_drop=True)
    params32, out["f32_cut"] = moe_init(cfg32)
    out["f32_decode_max_abs_err"] = decode_vs_forward(
        cfg32, params32, tokens, LM_CONSISTENCY_TOKENS)
    per_step = {**dict.fromkeys(LM_KERNELS, 0),
                "flash_attention": cfg32.num_layers}
    chunked = chunked_prefill_check(
        cfg32, params32, tokens,
        types.SimpleNamespace(serve={"prefill_chunk": TF_CHUNK}), per_step)
    out["chunked"] = chunked
    launches[f"{MIXTRAL_ARCH} f32 cut chunked prefill"] = chunked["launches"]
    del params32
    gc.collect()
    torch.cuda.empty_cache()

    params, out["cut"] = moe_init(base)
    fwd = moe_forward(base, params, tokens)
    del fwd["out"]
    out["forward"] = fwd
    launches[f"{MIXTRAL_ARCH} {MIXTRAL_LAYERS}-layer forward"] = \
        fwd["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    out["tick_parity"] = tick_parity(base, params, _tick_prompts(base))
    fleet = tf_fleet_phase(base, params)
    out["fleet"] = {k: v for k, v in fleet.items() if k != "launches"}
    launches[f"{MIXTRAL_ARCH} fleet replay"] = fleet["launches"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["launcher"] = launcher_run(MIXTRAL_ARCH, "--smoke")
    _phase_end("15 (mixtral-8x22b)", t0, out)
    return {"readings": out, "launches": launches,
            "per_step": base.num_layers}


def deepseek_phase() -> dict:
    """Phase 15b: ``deepseek-v3-671b`` at full width, cut in depth."""
    import types
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api, transformer
    from repro_torch.serve import engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out, launches = {}, {}
    cfg = moe_cut(DEEPSEEK_ARCH, DEEPSEEK_LAYERS)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, DEEPSEEK_SEQ)).astype(np.int32)
    params, out["cut"] = moe_init(cfg)
    fwd = moe_forward(cfg, params, tokens)
    launches[f"{DEEPSEEK_ARCH} {DEEPSEEK_LAYERS}-layer forward"] = \
        fwd["launches"]
    hidden = fwd["out"]["mtp_hidden"]
    last = fwd["out"]["logits"][:, -1:].clone()
    del fwd["out"]
    out["forward"] = fwd
    gc.collect()
    torch.cuda.empty_cache()

    ops.reset_launches()
    mtp = transformer.mtp_logits(params, cfg, hidden,
                                 np.roll(tokens, -1, axis=1))
    torch.cuda.synchronize()
    mtp_launches = ops.launch_counts()
    if tuple(mtp.shape) != (1, DEEPSEEK_SEQ, cfg.padded_vocab) \
            or not bool(torch.isfinite(mtp).all()) \
            or lm_counts(mtp_launches)["flash_attention"] != 1:
        raise SmokeFailure(f"mtp_logits {tuple(mtp.shape)}, finite "
                           f"{bool(torch.isfinite(mtp).all())}, launches "
                           f"{mtp_launches}")
    out["mtp_logits_abs_max"] = float(mtp.abs().max())
    launches[f"{DEEPSEEK_ARCH} mtp_logits"] = mtp_launches
    del mtp, hidden
    gc.collect()
    torch.cuda.empty_cache()

    prefill, _ = engine.build_serve_steps(cfg)
    ops.reset_launches()
    t1 = time.perf_counter()
    got, _ = prefill(params, tokens,
                     api.init_decode_state(cfg, 1, DEEPSEEK_SEQ))
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t1
    pre_launches = ops.launch_counts()
    if lm_counts(pre_launches)["flash_attention"] != cfg.num_layers:
        raise SmokeFailure(f"{cfg.name} prefill launched {pre_launches}")
    launches[f"{DEEPSEEK_ARCH} whole prefill"] = pre_launches
    out["prefill_vs_forward_max_abs_err"] = check_close(
        f"{cfg.name} whole prefill vs the forward's last row", got, last,
        tol=3e-2, atol=3e-1)
    log(f"lm {cfg.name} whole prefill of {DEEPSEEK_SEQ} tokens: "
        f"{out['prefill_s']:.3f} s (host clock), last logits vs the "
        f"forward's max_abs_err={out['prefill_vs_forward_max_abs_err']} "
        f"(rtol 3e-2 atol 3e-1)")
    del got, last
    gc.collect()
    torch.cuda.empty_cache()
    out["tick_parity"] = tick_parity(cfg, params, _tick_prompts(cfg))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = moe_cut(DEEPSEEK_ARCH, DEEPSEEK_F32_LAYERS, dtype="float32",
                    no_drop=True, first_dense=1, mtp=False)
    params32, out["f32_cut"] = moe_init(cfg32)
    out["f32_decode_max_abs_err"] = decode_vs_forward(
        cfg32, params32, tokens, DEEPSEEK_DECODE)
    per_step = {**dict.fromkeys(LM_KERNELS, 0),
                "flash_attention": cfg32.num_layers}
    chunked = chunked_prefill_check(
        cfg32, params32, tokens,
        types.SimpleNamespace(serve={"prefill_chunk": TF_CHUNK}), per_step,
        prompt_len=DEEPSEEK_CHUNKED_PROMPT,
        max_len=DEEPSEEK_CHUNKED_MAX_LEN)
    out["chunked"] = chunked
    launches[f"{DEEPSEEK_ARCH} f32 cut chunked prefill"] = \
        chunked["launches"]
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    out["launcher"] = launcher_run(DEEPSEEK_ARCH, "--smoke",
                                   own_process=False)
    _phase_end("15b (deepseek-v3-671b)", t0, out)
    return {"readings": out, "launches": launches,
            "per_step": cfg.num_layers}


def moe_phases() -> dict:
    """Phases 15 and 15b in order, every model freed before the next."""
    import torch
    log(f"moe phases: {torch.cuda.memory_allocated()} bytes allocated at "
        f"the start")
    mixtral = mixtral_phase()
    deepseek = deepseek_phase()
    return {"readings": {MIXTRAL_ARCH: mixtral["readings"],
                         DEEPSEEK_ARCH: deepseek["readings"]},
            "launches": {**mixtral["launches"], **deepseek["launches"]},
            "per_step": {MIXTRAL_ARCH: mixtral["per_step"],
                         DEEPSEEK_ARCH: deepseek["per_step"]}}


# ---------------------------------------------------------------------------
# Phase 16: the encoder-decoder whisper-medium at full width and depth
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper-medium"
WHISPER_PARAMS = 791_662_592   # init_whisper's tree, as the reference's
WHISPER_SEQ = 448              # the published decoder length: the forward's
                               # tokens and the batcher's max_len
WHISPER_DECODE = 64            # f32 tokens decoded against the forward
WHISPER_CHUNK = 8
TOL_WHISPER_DECODE = 1e-4      # absolute, f32: a step against its row
TOL_WHISPER_CHUNKED = 1e-3     # absolute, f32: chunked against whole


def whisper_counts(cfg) -> tuple[dict, dict, dict]:
    """flash launches of a forward (every encoder layer's self-attention,
    every decoder layer's self and cross), of a multi-token step (the
    decoder's self and cross) and of a one-token tick (the cross alone: the
    self-attention decode is plain)."""
    e = cfg.encdec
    zero = dict.fromkeys(LM_KERNELS, 0)
    return ({**zero, "flash_attention": e.encoder_layers
             + 2 * e.decoder_layers},
            {**zero, "flash_attention": 2 * e.decoder_layers},
            {**zero, "flash_attention": e.decoder_layers})


def whisper_init(cfg) -> tuple:
    """``api.init`` from a seeded CUDA generator (the parameter count held
    to ``WHISPER_PARAMS``) and the bytes printed."""
    import torch
    from repro_torch.models import api, tree
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    on_card(params["emb"], f"{cfg.name}'s api.init")
    leaves = tree.leaves(params)
    info = {"dtype": cfg.dtype, "params": sum(t.numel() for t in leaves),
            "bytes": sum(t.numel() * t.element_size() for t in leaves),
            "init_s": time.perf_counter() - t0}
    if info["params"] != WHISPER_PARAMS:
        raise SmokeFailure(f"{cfg.name} has {info['params']} parameters, "
                           f"want {WHISPER_PARAMS}")
    log(f"lm init {cfg.name} ({cfg.encdec.encoder_layers} + "
        f"{cfg.encdec.decoder_layers} layers, {cfg.dtype}): "
        + json.dumps(info, sort_keys=True))
    return params, info


def whisper_forward_check(cfg, params, tokens, frames, per_step) -> dict:
    """(a) ``api.forward`` at B=1 over ``tokens`` and the frames: finite
    logits of the right shape, one flash launch an encoder layer and two a
    decoder layer; the time and the peak memory."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits = api.forward(params, cfg, {"tokens": tokens,
                                       "encoder_frames": frames})["logits"]
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    want_shape = (1, tokens.shape[1], cfg.padded_vocab)
    if tuple(logits.shape) != want_shape \
            or not bool(torch.isfinite(logits).all()):
        raise SmokeFailure(f"{cfg.name} forward logits {tuple(logits.shape)}"
                           f" (want {want_shape}) or not finite")
    if lm_counts(launches) != per_step:
        raise SmokeFailure(f"{cfg.name} forward launched {launches}, want "
                           f"{per_step}")
    # Again, warm: the first call builds nothing here (the kernels are
    # built), but allocates.
    t0 = time.perf_counter()
    api.forward(params, cfg, {"tokens": tokens, "encoder_frames": frames})
    torch.cuda.synchronize()
    row = {"seq": tokens.shape[1], "encoder_len": frames.shape[1],
           "forward_s": forward_s,
           "forward_again_s": time.perf_counter() - t0,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "logits_abs_max": float(logits[..., :cfg.vocab_size].abs().max()),
           "launches": launches}
    log(f"lm {cfg.name} forward B=1 S={tokens.shape[1]} over "
        f"{frames.shape[1]} frames: " + json.dumps(row, sort_keys=True))
    return row


def whisper_f32_checks(cfg32, tokens, frames, per_multi) -> dict:
    """(b) the float32 model: ``whisper_init_cache`` from the frames, then
    ``WHISPER_DECODE`` tokens decoded one by one, each step within
    ``TOL_WHISPER_DECODE`` of the teacher-forced forward's row; and the
    same prompt prefilled through ``build_serve_steps`` in chunks of
    ``WHISPER_CHUNK`` (the plan's ``prefill_chunk``) against the whole
    prompt, the last logits within ``TOL_WHISPER_CHUNKED``."""
    import types
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api, encdec, tree
    from repro_torch.serve import engine
    params, info = whisper_init(cfg32)
    toks = tokens[:, :WHISPER_DECODE]
    full = api.forward(params, cfg32, {"tokens": toks,
                                       "encoder_frames": frames})["logits"]
    state0 = encdec.whisper_init_cache(params, cfg32, frames, WHISPER_SEQ)
    state = state0
    worst = 0.0
    for t in range(WHISPER_DECODE):
        logits, state = api.decode_step(params, cfg32, toks[:, t:t + 1],
                                        state, t)
        worst = max(worst, check_close(
            f"{cfg32.name} float32 decode step {t} vs forward row {t}",
            logits[:, 0], full[:, t], tol=0.0, atol=TOL_WHISPER_DECODE))
    log(f"lm {cfg32.name} float32 decode from whisper_init_cache vs the "
        f"forward over {WHISPER_DECODE} tokens: max_abs_err={worst} "
        f"(atol {TOL_WHISPER_DECODE})")
    del state, full
    plan = types.SimpleNamespace(serve={"prefill_chunk": WHISPER_CHUNK})
    chunked, _ = engine.build_serve_steps(cfg32, plan=plan)
    whole, _ = engine.build_serve_steps(cfg32)
    ops.reset_launches()
    t0 = time.perf_counter()
    last_c, state_c = chunked(params, toks, tree.tree_map(torch.clone,
                                                          state0))
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    n_chunks = -(-WHISPER_DECODE // WHISPER_CHUNK)
    want = {k: n * n_chunks for k, n in per_multi.items()}
    if lm_counts(launches) != want:
        raise SmokeFailure(f"{cfg32.name} chunked prefill launched "
                           f"{launches}, want {want}")
    last_w, state_w = whole(params, toks, state0)
    err = check_close(f"{cfg32.name} chunked prefill vs whole prefill",
                      last_c, last_w, tol=0.0, atol=TOL_WHISPER_CHUNKED)
    cache_err = max(check_close(f"{cfg32.name} state leaf {k} after the "
                                f"chunked prefill", state_c[k], state_w[k],
                                tol=0.0, atol=TOL_WHISPER_CHUNKED)
                    for k in ("k", "v", "xk", "xv"))
    out = {"f32": info, "decode_max_abs_err": worst,
           "chunked": {"prompt": WHISPER_DECODE, "chunks": n_chunks,
                       "chunked_s": chunked_s, "max_abs_err": err,
                       "cache_max_abs_err": cache_err,
                       "launches": launches}}
    log(f"lm {cfg32.name} float32 chunked prefill of {WHISPER_DECODE} "
        f"tokens in {n_chunks} chunks of {WHISPER_CHUNK}: last logits "
        f"max_abs_err={err}, state {cache_err} (atol "
        f"{TOL_WHISPER_CHUNKED}); launches {json.dumps(launches)}")
    del params, state0, state_c, state_w
    gc.collect()
    torch.cuda.empty_cache()
    return out


def whisper_quant8(cfg, params, prompts) -> dict:
    """(e) ``--quant8`` on the published model: the bytes before and after,
    and one graphed tick's logits over int8 weights against bf16 from
    batchers that admitted and prefilled the same prompts."""
    import numpy as np
    import torch
    from repro_torch.serve import engine
    qparams = engine.quantize_params(params, min_size=QUANT_MIN_SIZE)
    torch.cuda.synchronize()
    before, after = engine.quantized_bytes(qparams)
    ticks, tok = [], None
    for p in (params, qparams):
        # Admit and prefill every slot, then one tick of every slot on the
        # bf16 batcher's first tokens, so both ticks take the same inputs.
        b = engine.ContinuousBatcher(cfg, p, slots=LM_SLOTS,
                                     max_len=WHISPER_SEQ)
        for i, prompt in enumerate(prompts):
            b.submit(engine.Request(rid=30_000 + i, prompt=prompt,
                                    max_new=4))
        b._admit()
        for i, req in enumerate(b.active):
            b._prefill_tick(i, req)
        if tok is None:
            tok = np.array([[r.out[0]] for r in b.active], np.int32)
        ticks.append(b._decode_masked(tok, np.ones((b.slots,), bool))
                     .clone())
        del b
    bf, q8 = ticks
    real = slice(0, cfg.vocab_size)
    bf, q8 = bf[..., real].float(), q8[..., real].float()
    if not bool(torch.isfinite(q8).all()):
        raise SmokeFailure(f"quant8 {cfg.name}: non-finite tick logits")
    out = {"quantized_bytes": {"before": before, "after": after},
           "resident_bytes": {"bf16": _bytes(params),
                              "int8": _bytes(qparams)},
           "tick_gap": {"rel_rms": float((q8 - bf).norm() / bf.norm()),
                        "max_abs_diff": float((q8 - bf).abs().max()),
                        "argmax_agreement": float(
                            (q8.argmax(-1) == bf.argmax(-1)).float().mean()),
                        "bf16_max_abs": float(bf.abs().max())}}
    log(f"lm {cfg.name} quant8: " + json.dumps(out, sort_keys=True))
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


def whisper_phase() -> dict:
    """Phase 16: ``whisper-medium`` at full width and depth (24 encoder and
    24 decoder layers) through every LM entry point: (a) the bf16 forward
    over 448 tokens and 1500 frames, (c) the batcher (graphed tick against
    eager, a served run, a profiled trace), (e) ``--quant8``, (d) the
    fleet, the launcher (its ``main`` in this process), then (b) the
    float32 model's decode and chunked prefill from ``whisper_init_cache``.
    Frames are drawn from a seeded CUDA generator, tokens from numpy."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get(WHISPER_ARCH).config
    per_step, per_multi, per_tick = whisper_counts(cfg)
    out, launches = {}, {}
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, WHISPER_SEQ)).astype(np.int32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randn((1, cfg.encdec.encoder_len, cfg.d_model),
                         generator=gen, device=gen.device)

    params, out["init"] = whisper_init(cfg)
    fwd = whisper_forward_check(cfg, params, tokens, frames, per_step)
    out["forward"] = fwd
    launches[f"{WHISPER_ARCH} forward"] = fwd["launches"]

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size,
                            int(rng.integers(16, 65))).astype(np.int32)
               for _ in range(LM_REQUESTS)]
    out["tick_parity"] = tick_parity(cfg, params, prompts[:LM_SLOTS],
                                     max_len=WHISPER_SEQ)
    batcher, out["serve"] = serve_run(cfg, params, prompts, LM_MAX_NEW,
                                      {k: per_tick[k] for k in LM_KERNELS},
                                      "short", max_len=WHISPER_SEQ)
    launches[f"{WHISPER_ARCH} serve"] = out["serve"]["launches"]
    out["trace"] = decode_tick_trace(batcher, cfg, LM_TRACED_TICKS)
    del batcher
    gc.collect()
    torch.cuda.empty_cache()
    out["quant8"] = whisper_quant8(cfg, params, prompts[:LM_SLOTS])
    fleet = tf_fleet_phase(cfg, params, per_tick=per_tick,
                           max_len=WHISPER_SEQ)
    out["fleet"] = {k: v for k, v in fleet.items() if k != "launches"}
    launches[f"{WHISPER_ARCH} fleet replay"] = fleet["launches"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["launcher"] = launcher_run(WHISPER_ARCH, own_process=False)

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    f32 = whisper_f32_checks(cfg32, tokens, frames, per_multi)
    launches[f"{WHISPER_ARCH} f32 chunked prefill"] = \
        f32["chunked"]["launches"]
    out.update(f32)
    _phase_end("16 (whisper-medium)", t0, out)
    return {"readings": out, "launches": launches,
            "per_step": {"forward": per_step["flash_attention"],
                         "multi_token_step": per_multi["flash_attention"],
                         "decode_tick": per_tick["flash_attention"]}}


# ---------------------------------------------------------------------------
# Phase 17: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "gemma2-2b"
TRAIN_BATCH = 2
TRAIN_SEQ = 4096
TRAIN_STEPS = 8
TRAIN_CKPT_EVERY = 4
TRAIN_FAIL_AT = 6              # the state's step: 1-based steps 5-6 replay
# AdamW's moments in bf16: the run checkpoints twice (steps 4 and 8), and
# with f32 moments a checkpoint is 26.1 GB (24.4 GiB), in bf16 15.7 GB
# (14.6 GiB); two f32 ones overrun a 45 GiB budget of disk writes a run
# (deleted files count).
TRAIN_STATE_DTYPE = "bfloat16"
GRIFFIN_TRAIN_SEQ = 2048
GRIFFIN_TRAIN_STEPS = 3
CUT_SEQ = 1024                 # 17b's f32 cuts, one sequence
# The backward's kernel against its plain version, as max|err| / max|ref|
# of each of dq, dk and dv.  f32: both sides do f32 arithmetic on the same
# inputs (the kernel from the row's log-sum-exp, the plain version from
# the normalised softmax) and differ in summation order: dk and dv sum up
# to 8 x 4096 query rows one after another in the kernel, blocked in
# cuBLAS, ~1e-6-1e-5 of the largest value.  bf16 (D a multiple of 32: the
# tensor cores) rounds P and dS to bf16 before their products, each term
# off by up to 2^-8 of itself, and its outputs to bf16: a few 1e-3 of the
# largest value; held to 2e-2.
TOL_FLASH_BWD = {"float32": 1e-5, "bfloat16": 2e-2}
# The forward's row statistics against the plain forward's, relative to
# the largest finite value: both take f32 sums of the same products (exact
# in bf16) and of unrounded probabilities, in other orders.
TOL_FLASH_LSE = 1e-5
# The scan's gradient (f32, Griffin's state): the chunked kernel's carry
# is rounded along another path than the reversed loop's (rglru.py), the
# forward's own 1e-4 (TOL_SCAN) relative to the largest value.
TOL_SCAN_BWD = 1e-4
# 17b: one f32 step through the kernels against the same step through the
# plain versions: the loss and every gradient leaf within 1e-4 of its
# largest value, taken as at least 1e-3 of the largest gradient anywhere
# (a leaf of near-zero gradients carries the f32 rounding of the others).
# Each kernel agrees with its plain version to ~1e-6 (TOL_FLASH_BWD,
# TOL_FLASH, TOL_SCAN's readings); two to three layers compound that.
TOL_TRAIN_STEP = 1e-4
# 17f: rwkv6-7b's kernel step against the plain step.  Each scan kernel
# rounds its f32 sums in another order than its plain version (~1e-7 of
# the largest value: 17e, phase 10); the per-head group norm (eps 64e-5)
# divides each (token, head) row by its own spread, so a row of small
# spread carries the forward kernel's rounding many times larger, and two
# layers carry it back into the time-mix leaves.  On the card u_bonus's
# gradient reads 1.19e-4 of its largest value off the plain step's, and
# 1.69e-5 off the step with the same forward kernel and the plain backward
# (this phase on an H100).  Neither f32 step is the exact one: against an
# f64 witness of the same step (scripts/rwkv_grad_witness.py --layers 2
# --seq 1024 --dtypes float32, on an H100) u_bonus reads 9.75e-4 off
# through the kernels and 1.09e-3 off through the plain versions (the
# whole gradient 1.47e-5 and 1.62e-5), so the 1.19e-4 between them lies
# inside the f32 step's own error, the kernel step the nearer.  The
# backward kernel is held to TOL_TRAIN_STEP against the step with the
# plain backward; the whole kernel step to 5e-4 of each leaf against the
# plain step, its loss to TOL_TRAIN_STEP.
TOL_TRAIN_STEP_RWKV = 5e-4
TRAIN_FLASH_CASES = (
    ("gemma2-2b local", 2, 8, 4, 4096, 4096, 256,
     {"causal": True, "window": 4096, "softcap": 50.0}),
    ("gemma2-2b global", 2, 8, 4, 4096, 4096, 256,
     {"causal": True, "softcap": 50.0}),
    ("recurrentgemma-2b local", 1, 10, 1, 2048, 2048, 256,
     {"causal": True, "window": 2048}),
    ("qwen2.5-3b", 1, 16, 2, 4096, 4096, 128, {"causal": True}),
    ("whisper encoder", 1, 16, 16, 1500, 1500, 64, {"causal": False}),
    ("whisper cross", 1, 16, 16, 448, 1500, 64, {"causal": False}),
    # S cut to 1024 so that the plain oracle's (S, Sk) f32 tensors fit.
    ("deepseek MLA", 1, 128, 128, 1024, 1024, 192, {"causal": True}),
)
SCAN_BWD_SHAPE = (2, 4096, 2560)


def _rwkv_bwd_plain(r, k, v, w, u, do, states):
    """The plain RWKV backward under the kernel's signature: it rebuilds S
    itself and does not read the forward's chunk states."""
    from repro_torch.kernels import rwkv6 as rw
    return rw.rwkv6_scan_bwd_plain(r, k, v, w, u, do)


@contextlib.contextmanager
def plain_kernels(only=None):
    """Every kernel wrapper of the training path (or those named in
    ``only``) swapped for its plain version, on the card: the same step
    through plain PyTorch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import rglru
    from repro_torch.kernels import rwkv6 as rw
    swaps = [(fa, "flash_attention_cuda", fa.flash_attention_plain),
             (fb, "flash_attention_bwd_cuda", fb.flash_attention_bwd_plain),
             (rglru, "linear_scan_cuda", rglru.linear_scan_plain),
             (rglru, "linear_scan_bwd_cuda", rglru.linear_scan_bwd_plain),
             (rw, "rwkv6_scan_cuda", rw.rwkv6_scan_plain),
             (rw, "rwkv6_scan_bwd_cuda", _rwkv_bwd_plain)]
    swaps = [s for s in swaps if only is None or s[1] in only]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _rel(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def train_flash_checks(gen, device) -> dict:
    """17a's checks: the forward's row statistics against the plain
    forward's (``TOL_FLASH_LSE``, +inf on the same rows), and the backward
    kernel against its plain version (both from the kernel's statistics)
    at each of ``TRAIN_FLASH_CASES`` in f32 and bf16, at
    ``TOL_FLASH_BWD``, and a second call on the same inputs bit for bit
    the first.  Returns the largest absolute and relative errors."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    worst = {"abs": 0.0, "rel": 0.0, "lse_rel": 0.0}
    for label, b, hq, hkv, s, sk, d, kw in TRAIN_FLASH_CASES:
        for dt in ("float32", "bfloat16"):
            q, k, v = _tf_qkv(gen, device, b, hq, hkv, s, sk, d,
                              getattr(torch, dt))
            do = torch.randn((b, hq, s, d), generator=gen,
                             device=device).to(q.dtype)
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            want_lse = fa.flash_attention_plain(q, k, v, return_lse=True,
                                                **kw)[1]
            inf = torch.isinf(want_lse)
            if not torch.equal(torch.isinf(lse), inf):
                raise SmokeFailure(f"flash_attention {label} {dt}: the "
                                   f"statistics' +inf rows differ from the "
                                   f"plain forward's")
            _, lse_rel = _rel(lse[~inf], want_lse[~inf])
            del want_lse
            if lse_rel > TOL_FLASH_LSE:
                raise SmokeFailure(f"flash_attention {label} {dt}: lse off "
                                   f"by {lse_rel} of its largest value "
                                   f"(tolerance {TOL_FLASH_LSE})")
            worst["lse_rel"] = max(worst["lse_rel"], lse_rel)
            got = fb.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
            again = fb.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise SmokeFailure(f"flash_attention_bwd {label} {dt}: two "
                                   f"calls on the same inputs differ")
            del again
            want = fb.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
            errs = {}
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                if not torch.isfinite(g).all():
                    raise SmokeFailure(f"flash_attention_bwd {label} {dt}: "
                                       f"{name} is not finite")
                errs[name] = _rel(g, w)
            splits = fb.card_splits(b, hq, hkv, sk, d, device) \
                if dt == "bfloat16" else 1
            log(f"kernel flash_attention_bwd {label} q={list(q.shape)} "
                f"k={list(k.shape)} {dt} {kw}: " + ", ".join(
                    f"{n} max_abs_err={a} rel={r}"
                    for n, (a, r) in errs.items())
                + f" tol={TOL_FLASH_BWD[dt]}; lse rel={lse_rel} "
                f"tol={TOL_FLASH_LSE}; bit-equal repeat; splits={splits}")
            for n, (a, r) in errs.items():
                if r > TOL_FLASH_BWD[dt]:
                    raise SmokeFailure(f"flash_attention_bwd {label} {dt}: "
                                       f"{n} off by {r} of its largest "
                                       f"value (tolerance "
                                       f"{TOL_FLASH_BWD[dt]})")
                worst["abs"] = max(worst["abs"], a)
                worst["rel"] = max(worst["rel"], r)
            del q, k, v, do, o, lse, got, want
            gc.collect()
            torch.cuda.empty_cache()
    return worst


def train_flash_row(gen, device, label, b, hq, hkv, s, sk, d, kw) -> dict:
    """One bf16 timing row of the backward: the kernel graph-replayed and
    eager (and graph-replayed in f32, the CUDA-core path, as ``f32_ms``),
    the plain version, SDPA's backward (the yardstick: with a band
    mask, ``is_causal`` for a causal square, no mask when non-causal; it has
    no softcap, so where the kernel caps its logits SDPA computes less and
    its time is ``sdpa_no_softcap_ms`` with ``library_ms`` null) and the
    bound max(bytes / 3.35 TB/s, flops / 989 TFLOP/s)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    q, k, v = _tf_qkv(gen, device, b, hq, hkv, s, sk, d, torch.bfloat16)
    do = torch.randn((b, hq, s, d), generator=gen,
                     device=device).to(torch.bfloat16)
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)

    def kernel():
        return fb.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)

    if not kw.get("causal", True):
        sdpa_kw, form = {}, "no mask"
    elif not kw.get("window") and s == sk:
        sdpa_kw, form = {"is_causal": True}, "is_causal"
    else:
        sdpa_kw, form = {"attn_mask": _band(s, sk, kw, device)}, "band mask"
    group = hq // hkv
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (
        q, k.repeat_interleave(group, dim=1),
        v.repeat_interleave(group, dim=1)))
    lout = F.scaled_dot_product_attention(lq, lk, lv, **sdpa_kw)

    def library():
        return torch.autograd.grad(lout, (lq, lk, lv), do,
                                   retain_graph=True)

    flops, nbytes = fb.work(b, hq, hkv, s, sk, d, 2,
                            causal=kw.get("causal", True),
                            window=kw.get("window"))
    inner = 2 if flops > 5e10 else 10
    row = {"shape": f"{label}: q {list(q.shape)} k/v {list(k.shape)} "
                    f"bfloat16 {kw}", "library_form": form,
           "ms": graph_ms(kernel, inner=inner, reps=5),
           "eager_ms": event_ms(kernel, inner=inner, reps=5),
           "plain_ms": event_ms(lambda: fb.flash_attention_bwd_plain(
               q, k, v, o, do, lse, **kw), inner=1, reps=3),
           **bound(nbytes, flops, PEAK_BF16)}
    row["splits"] = fb.card_splits(b, hq, hkv, sk, d, device)
    sdpa_ms = event_ms(library, inner=inner, reps=5)
    row["tflops"] = flops / row["ms"] / 1e9
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o32, lse32 = fa.flash_attention_cuda(q32, k32, v32, return_lse=True, **kw)
    row["f32_ms"] = graph_ms(lambda: fb.flash_attention_bwd_cuda(
        q32, k32, v32, o32, do32, lse32, **kw), inner=inner, reps=3)
    del q32, k32, v32, o32, do32, lse32
    if kw.get("softcap"):
        row.update(library_ms=None, sdpa_no_softcap_ms=sdpa_ms)
    else:
        # SDPA's backward rounds P and dS to bf16: its dq against the
        # kernel's, relative to the largest, at the reference's bf16 3e-2.
        err, rel = _rel(library()[0], kernel()[0])
        if rel > TOL_FLASH_LIBRARY:
            raise SmokeFailure(f"flash backward {label}: SDPA's dq off by "
                               f"{rel} of the kernel's largest ({err})")
        row["library_ms"], row["library_dq_rel_err"] = sdpa_ms, rel
    log("timing flash_attention_bwd " + json.dumps(row, sort_keys=True))
    del q, k, v, do, o, lse, lq, lk, lv, lout
    gc.collect()
    torch.cuda.empty_cache()
    return row


def scan_bwd_row(gen, device) -> dict:
    """17a's scan gradient: the ``linear_scan`` kernel run in reverse
    (``linear_scan_bwd_cuda``) against the reversed loop at
    ``SCAN_BWD_SHAPE`` in f32, and its time beside its bound (a, h and g
    read once, da and db written once)."""
    import torch
    from repro_torch.kernels import rglru
    a = torch.rand(SCAN_BWD_SHAPE, generator=gen, device=device) * 0.5 \
        + 0.45
    b_ = torch.randn(SCAN_BWD_SHAPE, generator=gen, device=device)
    h = rglru.linear_scan_cuda(a, b_)
    g = torch.randn(SCAN_BWD_SHAPE, generator=gen, device=device)
    got = rglru.linear_scan_bwd_cuda(a, h, g)
    want = rglru.linear_scan_bwd_plain(a, h, g)
    errs = {n: _rel(x, w) for n, x, w in zip(("da", "db"), got, want)}
    log(f"kernel linear_scan backward {list(a.shape)} float32: "
        + ", ".join(f"{n} max_abs_err={e} rel={r}"
                    for n, (e, r) in errs.items()) + f" tol={TOL_SCAN_BWD}")
    for n, (_, r) in errs.items():
        if r > TOL_SCAN_BWD:
            raise SmokeFailure(f"linear_scan backward: {n} off by {r} of "
                               f"its largest value (tolerance "
                               f"{TOL_SCAN_BWD})")
    row = {"shape": f"linear_scan backward {list(a.shape)} float32",
           "ms": event_ms(lambda: rglru.linear_scan_bwd_cuda(a, h, g),
                          inner=5, reps=5),
           "plain_ms": event_ms(lambda: rglru.linear_scan_bwd_plain(a, h, g),
                                inner=1, reps=3),
           "max_abs_err": max(e for e, _ in errs.values()),
           **bound(5 * 4 * a.numel(), 2.0 * a.numel(), PEAK_F32)}
    log("timing linear_scan backward " + json.dumps(row, sort_keys=True))
    return row


def _cut(arch: str, layers: int):
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(arch).config, dtype="float32",
                               num_layers=layers)


def train_step_parity(arch: str, layers: int, device, part: str = "17b",
                      refs=(("plain step", None, TOL_TRAIN_STEP),)) -> dict:
    """17b (17f for RWKV): one f32 step's loss and gradients, through the
    kernels and through the plain versions on the card, from one seeded
    state.  Each of ``refs`` is a reference step: (label, the wrappers
    swapped for their plain versions, None for all of them, the gradient
    leaves' tolerance); its loss is held to ``TOL_TRAIN_STEP``."""
    import torch
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import ops
    from repro_torch.models import api, tree
    from repro_torch.train import step as step_lib
    cfg = _cut(arch, layers)
    params = api.init(cfg, torch.Generator(device=device).manual_seed(0),
                      device=device)
    leaves = step_lib._trainable(params)
    loss_fn = step_lib.make_loss_fn(cfg, step_lib.TrainOptions(
        remat="block", chunked_loss=cfg.family == "transformer"))
    batch = tree.tree_map(lambda a: tree.as_tensor(a, device), synth_batch(
        cfg, batch=1, seq=CUT_SEQ, step=0))

    def step():
        before = ops.launch_counts()
        loss, _ = loss_fn(params, batch)
        grads = step_lib._grad(loss, leaves)
        return loss.detach(), [g.detach() for g in grads], {
            n: c - before[n] for n, c in ops.launch_counts().items()
            if c - before[n]}
    loss, grads, launched = step()
    if cfg.family == "rwkv":
        want_kernels = {"rwkv6_scan": "rwkv6_scan_cuda",
                        "rwkv6_scan_bwd": "rwkv6_scan_bwd_cuda"}
    else:
        want_kernels = {"flash_attention": "flash_attention_cuda",
                        "flash_attention_bwd": "flash_attention_bwd_cuda"}
        if cfg.family == "griffin":
            want_kernels["linear_scan"] = "linear_scan_cuda"
    if set(launched) != set(want_kernels):
        raise SmokeFailure(f"{part} {arch}: the kernel step launched "
                           f"{launched}, want {sorted(want_kernels)}")
    out = {"arch": arch, "layers": layers, "seq": CUT_SEQ,
           "loss": float(loss), "grad_leaves": len(grads),
           "launches": launched, "refs": {}}
    for label, only, tol in refs:
        with plain_kernels(only):
            p_loss, p_grads, p_launched = step()
        want = {n for n, w in want_kernels.items()
                if only is not None and w not in only}
        if set(p_launched) != want:
            raise SmokeFailure(f"{part} {arch}: the {label} launched "
                               f"{p_launched}, want {sorted(want)}")
        gmax = max(float(g.abs().max()) for g in p_grads)
        loss_err = _rel(loss, p_loss)
        worst = 0.0
        for i, (g, w) in enumerate(zip(grads, p_grads)):
            err = float((g - w).abs().max())
            scale = max(float(w.abs().max()), 1e-3 * gmax)
            worst = max(worst, err / scale)
            if err > tol * scale or not torch.isfinite(g).all():
                raise SmokeFailure(f"{part} {arch}: gradient leaf {i} "
                                   f"{tuple(g.shape)} off by {err} of "
                                   f"{scale} against the {label} "
                                   f"(tolerance {tol})")
        if loss_err[1] > TOL_TRAIN_STEP:
            raise SmokeFailure(f"{part} {arch}: loss {float(loss)} against "
                               f"the {label}'s {float(p_loss)}")
        out["refs"][label] = {"loss": float(p_loss),
                              "loss_rel_err": loss_err[1],
                              "worst_leaf_rel_err": worst, "tolerance": tol}
        del p_grads
    log(f"{part} {arch} f32 cut ({layers} layers, S={CUT_SEQ}): "
        + json.dumps(out, sort_keys=True))
    del params, leaves, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def model_flops(cfg, batch: int, seq: int) -> float:
    """One training step's products, forward and backward, not the
    recomputed ones: 6 flops a matmul weight and token (the layers' and
    the unembedding's) and flash's 4 D a kept pair forward and 8 D
    backward (dV, dP, dQ, dK) a query head."""
    from repro_torch.kernels import flash_attention as fa
    d = cfg.d_model
    per_layer = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d \
        + 3 * d * cfg.d_ff
    dense = 6.0 * (cfg.num_layers * per_layer + d * cfg.padded_vocab) \
        * batch * seq
    attn = 0.0
    for i in range(cfg.num_layers):
        window = cfg.window if cfg.layer_kind(i) == "local" else None
        pairs = fa.band_pairs(seq, seq, causal=True, window=window,
                              q_offset=0)
        attn += 12.0 * cfg.head_dim * pairs * batch * cfg.num_heads
    return dense + attn


FLASH_TRACE_KERNELS = (("flash_forward_ms", ("flash_tc_kernel",
                                             "flash_kernel")),
                       ("flash_backward_ms", ("flash_bwd_",)))
RWKV_TRACE_KERNELS = (("scan_forward_ms", ("rwkv6_chunk_kernel",
                                           "rwkv6_kernel")),
                      ("scan_backward_ms", ("rwkv6_bwd_", "du_sum_kernel")),
                      ("scan_backward_carry_ms", ("rwkv6_bwd_carry_kernel",)),
                      ("scan_backward_chunk_ms", ("rwkv6_bwd_chunk_kernel",)),
                      ("scan_backward_du_ms", ("du_sum_kernel",)))


def train_step_trace(driver, batch_fn, *, part: str = "17c",
                     kernels=FLASH_TRACE_KERNELS) -> dict:
    """One more step of ``driver`` under ``torch.profiler``: the device's
    busy time and idle share inside the step's host span (which ends in a
    synchronize), the ``TRACE_TOP`` device activities by name, and the
    step's own kernels' ms (``kernels``: key, name parts)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    batch = batch_fn(driver.step)
    torch.cuda.synchronize()
    label = "train_step"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_host = time.perf_counter()
        with record_function(label):
            driver.state, metrics = driver.step_fn(driver.state, batch)
            torch.cuda.synchronize()
        t_host = time.perf_counter() - t_host
    events = prof.events()
    span = next(e for e in events
                if e.name == label and e.device_type == DeviceType.CPU)
    t0, t1 = span.time_range.start, span.time_range.end
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation and e.name != label]
    out = {"host_clock_ms": t_host * 1e3, "loss": float(metrics["loss"]),
           "device_ops": len(dev)}
    if not dev:
        out.update(device_busy_ms=None, idle_share=None)
        log(f"{part} step trace: the profiler recorded no device activity; "
            "idle share not measured " + json.dumps(out))
        return out
    busy_us = _union_us((max(e.time_range.start, t0),
                         min(e.time_range.end, t1)) for e in dev
                        if e.time_range.end > t0 and e.time_range.start < t1)
    by_name: dict = {}
    for e in dev:
        by_name[e.name[:80]] = (by_name.get(e.name[:80], 0.0)
                                + e.time_range.end - e.time_range.start)

    def ms_of(*parts):
        return sum(v for k, v in by_name.items()
                   if any(p in k for p in parts)) / 1e3
    out.update(
        device_busy_ms=busy_us / 1e3, idle_share=1.0 - busy_us / (t1 - t0),
        top_device_ms={k: v / 1e3 for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TRACE_TOP]},
        **{key: ms_of(*parts) for key, parts in kernels})
    log(f"{part} step trace " + json.dumps(out, sort_keys=True))
    return out


def train_run(argv: list, after=None) -> tuple[dict, dict]:
    """``launch.train.run(argv)`` with every launch counter set to 0 just
    before and read just after the steps (``after`` runs past that)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    counts = {}

    def then(driver, batch_fn):
        counts.update(ops.launch_counts())
        return after(driver, batch_fn) if after is not None else None
    report = launch_train.run(argv, after=then)
    gc.collect()
    torch.cuda.empty_cache()
    return report, counts


def gemma_train_phase() -> dict:
    """17c: the published gemma2-2b trained whole through the launcher's
    driver, with a failure injected and replayed."""
    import shutil
    import tempfile
    from repro_torch import configs
    cfg = configs.get(TRAIN_ARCH).config
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        report, counts = train_run([
            "--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--opt", "adamw",
            "--state-dtype", TRAIN_STATE_DTYPE, "--remat", "block",
            "--ckpt-every", str(TRAIN_CKPT_EVERY),
            "--fail-at", str(TRAIN_FAIL_AT), "--ckpt-dir", ckpt],
            after=train_step_trace)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    steps = report["steps"]
    runs = len(steps)
    if [s for s, *_ in steps] != [1, 2, 3, 4, 5, 6, 5, 6, 7, 8]:
        raise SmokeFailure(f"17c: steps ran {[s for s, *_ in steps]}")
    if not all(math.isfinite(l) and math.isfinite(g)
               for _, l, g, _ in steps):
        raise SmokeFailure(f"17c: a loss or grad_norm is not finite: "
                           f"{steps}")
    kinds = [e[:2] for e in report["events"]]
    if kinds != [("checkpoint", 4), ("failure", TRAIN_FAIL_AT),
                 ("restored", 4), ("checkpoint", 8)]:
        raise SmokeFailure(f"17c: driver events {report['events']}")
    first = {s: (l, g) for s, l, g, _ in steps[:6]}
    replay = {s: (l, g) for s, l, g, _ in steps[6:8]}
    gaps = {s: (replay[s][0] - first[s][0], replay[s][1] - first[s][1])
            for s in replay}
    log(f"17c replay: first pass {[first[s] for s in (5, 6)]}, replayed "
        f"{[replay[s] for s in (5, 6)]}, gaps (loss, grad_norm) {gaps}")
    if any(replay[s][0] != first[s][0] for s in replay):
        raise SmokeFailure(f"17c: the replayed losses differ from the "
                           f"first pass's by {gaps}")
    for name in ("flash_attention", "flash_attention_bwd"):
        if counts[name] == 0:
            raise SmokeFailure(f"17c: {name} launched no time in the "
                               f"training run")
    ms = [m for *_, m in steps]
    p50 = statistics.median(ms[1:])      # the first step warms up
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    ev = {e[0]: e for e in report["events"]}
    out = {"steps": steps, "step_p50_ms": p50, "tokens_per_s":
           tokens / (p50 / 1e3), "model_flops_per_step": flops,
           "model_tflops_per_s": flops / (p50 / 1e3) / 1e12,
           "mfu_bf16_dense": flops / (p50 / 1e3) / PEAK_BF16,
           "peak_memory_bytes": report["peak_bytes"],
           "snapshot_s": [e[2] for e in report["events"]
                          if e[0] == "checkpoint"],
           "restore_s": ev["restored"][2], "wall_s": report["wall_s"],
           "launches": counts,
           # Under --remat block a step launches flash's forward twice a
           # layer (the forward, the block's recompute) and its backward
           # once: 52 and 26 for gemma2-2b's 26 layers.
           "per_step": {n: counts[n] / runs for n in
                        ("flash_attention", "flash_attention_bwd")},
           "replay_gaps": gaps, "trace": report["after"]}
    log("17c gemma2-2b trained whole: " + json.dumps(
        {k: v for k, v in out.items() if k != "steps"}, sort_keys=True))
    return out


def griffin_train_phase() -> dict:
    """17d: recurrentgemma-2b at full width and depth, a few AdamW steps
    through the launcher."""
    import tempfile
    report, counts = train_run([
        "--arch", LM_ARCH, "--batch", "1", "--seq", str(GRIFFIN_TRAIN_SEQ),
        "--steps", str(GRIFFIN_TRAIN_STEPS), "--opt", "adamw", "--remat",
        "block", "--ckpt-every", "1000000", "--ckpt-dir",
        tempfile.mkdtemp(prefix="chip_smoke_griffin_")])
    steps = report["steps"]
    if len(steps) != GRIFFIN_TRAIN_STEPS or not all(
            math.isfinite(l) and math.isfinite(g) for _, l, g, _ in steps):
        raise SmokeFailure(f"17d: steps {steps}")
    for name in ("flash_attention", "flash_attention_bwd", "linear_scan"):
        if counts[name] == 0:
            raise SmokeFailure(f"17d: {name} launched no time")
    out = {"steps": steps, "step_p50_ms": statistics.median(
               [m for *_, m in steps][1:]),
           "peak_memory_bytes": report["peak_bytes"], "launches": counts,
           "per_step": {n: counts[n] / len(steps) for n in
                        ("flash_attention", "flash_attention_bwd",
                         "linear_scan")}}
    log("17d recurrentgemma-2b trained whole: " + json.dumps(
        out, sort_keys=True))
    return out


# 17e-17g: RWKV training.  The backward kernel's cases (label, BH, T, D,
# heads, w range): the 17g step's shape (1 x 2048, 64 heads of 64), the
# forward's 4096, D = 32 and 128 at small shapes, decays down to 0.01,
# decays near 1, and exact zeros and ones (``_exact_zeros``).  Held to TOL_FLASH_BWD's limits (max|err| / max|ref| of
# each of dr, dk, dv, dw and du): both sides do f32 arithmetic on the same
# inputs in other summation orders; bf16 rounds dr, dk and dv once.
RWKV_BWD_CASES = (
    ("train step", 64, 2048, 64, 64, (0.5, 0.99)),
    ("forward shape", 64, 4096, 64, 64, (0.5, 0.99)),
    ("d32", 16, 300, 32, 4, (0.5, 0.99)),
    ("d128", 16, 300, 128, 4, (0.5, 0.99)),
    ("fast decay", 64, 1024, 64, 64, (0.01, 1.0)),
    ("near one", 64, 1024, 64, 64, (0.999, 1.0)),
    ("exact zeros", 64, 300, 64, 64, (0.01, 1.0)),
)
RWKV_BWD_TIMED = ("train step", "forward shape")
RWKV_TRAIN_SEQ = 2048
RWKV_TRAIN_STEPS = 3
RWKV_TRAIN_STATE_DTYPE = "int8"


def _exact_zeros(w):
    """Exact zeros and ones in the decays of rows 0-3 (T >= 128): zeros
    over five steps inside a sub-chunk, a whole step of zeros on the first
    step of a chunk (64) and on the last (127), ones over three steps."""
    w[0, 70:75, :5] = 0.0
    w[1, 64, :] = 0.0
    w[2, 100:103, 7:20] = 1.0
    w[3, 127, :] = 0.0
    return w


def _rwkv_bwd_inputs(gen, device, label, bh, t, d, heads, w_range, dtype):
    """r, k, v, w, u, do, and the chunk states of the forward kernel on
    them (as training's forward stores them); the ``exact zeros`` case
    places ``_exact_zeros`` in w."""
    import torch
    from repro_torch.kernels import rwkv6 as rw
    dt = getattr(torch, dtype)
    r, k, v, do = [(torch.randn((bh, t, d), generator=gen, device=device)
                    * 0.5).to(dt) for _ in range(4)]
    lo, hi = w_range
    w = torch.rand((bh, t, d), generator=gen, device=device) * (hi - lo) + lo
    if label == "exact zeros":
        _exact_zeros(w)
    u = torch.randn((heads, d), generator=gen, device=device) * 0.3
    _, states = rw.rwkv6_scan_cuda(r, k, v, w, u, return_chunk_states=True)
    return (r, k, v, w, u, do), states


def rwkv_bwd_checks(gen, device) -> dict:
    """17e's checks: ``rwkv6_scan_bwd_cuda`` (from the forward kernel's
    chunk states) against ``rwkv6_scan_bwd_plain`` at each of
    ``RWKV_BWD_CASES`` in f32 and bf16, and a second call on the same
    inputs bit for bit the first.  Returns the largest absolute and
    relative errors."""
    import torch
    from repro_torch.kernels import rwkv6 as rw
    worst = {"abs": 0.0, "rel": 0.0}
    for label, bh, t, d, heads, w_range in RWKV_BWD_CASES:
        for dt in ("float32", "bfloat16"):
            args, states = _rwkv_bwd_inputs(gen, device, label, bh, t, d,
                                            heads, w_range, dt)
            got = rw.rwkv6_scan_bwd_cuda(*args, states)
            again = rw.rwkv6_scan_bwd_cuda(*args, states)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise SmokeFailure(f"rwkv6_scan_bwd {label} {dt}: two calls "
                                   f"on the same inputs differ")
            want = rw.rwkv6_scan_bwd_plain(*args)
            errs = {}
            for name, g, w in zip(("dr", "dk", "dv", "dw", "du"), got, want):
                if not torch.isfinite(g).all():
                    raise SmokeFailure(f"rwkv6_scan_bwd {label} {dt}: {name} "
                                       f"is not finite")
                errs[name] = _rel(g, w)
            log(f"kernel rwkv6_scan_bwd {label} r/k/v={[bh, t, d]} {dt} "
                f"heads={heads} w in {list(w_range)}: " + ", ".join(
                    f"{n} max_abs_err={a} rel={r}"
                    for n, (a, r) in errs.items())
                + f" tol={TOL_FLASH_BWD[dt]}; repeat bit-equal")
            for n, (a, r) in errs.items():
                if r > TOL_FLASH_BWD[dt]:
                    raise SmokeFailure(f"rwkv6_scan_bwd {label} {dt}: {n} off "
                                       f"by {r} of its largest value "
                                       f"(tolerance {TOL_FLASH_BWD[dt]})")
                worst["abs"] = max(worst["abs"], a)
                worst["rel"] = max(worst["rel"], r)
            del args, states, got, again, want
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def call_scratch(fn) -> dict:
    """Device memory one eager call of ``fn`` allocates beyond the outputs
    it returns, read from the caching allocator: the peak during the call
    less what is held after it, in bytes requested (``requested``) and in
    the allocator's rounded blocks (``blocks``)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    st = torch.cuda.memory_stats()
    del out
    return {"requested": st["requested_bytes.all.peak"]
            - st["requested_bytes.all.current"],
            "blocks": st["allocated_bytes.all.peak"]
            - st["allocated_bytes.all.current"]}


def rwkv_bwd_row(gen, device, label, bh, t, d, heads, w_range) -> dict:
    """One bf16 timing row of the backward: the kernel graph-replayed and
    eager (from the forward kernel's chunk states), the plain version, the
    bound max(bytes / 3.35 TB/s, flops / 67 TFLOP/s) of ``work_bwd`` (the
    f32 rate: the arithmetic is f32) and the scratch one call allocates
    (``call_scratch``; fails unless the bytes requested are the wrapper's
    ``bwd_scratch_bytes``); beside it the forward kernel graph-replayed on
    the same inputs without and with the chunk states stored.  No single
    PyTorch call computes this function: ``library_ms`` is null."""
    from repro_torch.kernels import rwkv6 as rw
    args, states = _rwkv_bwd_inputs(gen, device, label, bh, t, d, heads,
                                    w_range, "bfloat16")

    def kernel():
        return rw.rwkv6_scan_bwd_cuda(*args, states)

    scratch = call_scratch(kernel)
    if scratch["requested"] != rw.bwd_scratch_bytes(bh, t, d):
        raise SmokeFailure(f"rwkv6_scan_bwd {label}: one call requested "
                           f"{scratch['requested']} bytes of scratch, the "
                           f"wrapper's size is "
                           f"{rw.bwd_scratch_bytes(bh, t, d)}")

    def forward(keep):
        return lambda: rw.rwkv6_scan_cuda(*args[:5],
                                          return_chunk_states=keep)
    flops, nbytes = rw.work_bwd(bh, t, d, heads, 2)
    row = {"shape": f"{label}: r/k/v/do {[bh, t, d]} bfloat16, w f32, "
                    f"heads {heads}",
           "ms": graph_ms(kernel, inner=3, reps=5),
           "eager_ms": event_ms(kernel, inner=3, reps=5),
           "plain_ms": event_ms(lambda: rw.rwkv6_scan_bwd_plain(*args),
                                inner=1, reps=1, warm=1),
           "library_ms": None, **bound(nbytes, flops, PEAK_F32),
           "scratch_bytes": scratch["requested"],
           "scratch_block_bytes": scratch["blocks"],
           "chunk_states_bytes": states.numel() * states.element_size(),
           "forward_ms": graph_ms(forward(False), inner=3, reps=5),
           "forward_states_ms": graph_ms(forward(True), inner=3, reps=5)}
    row["f32_flops_per_s"] = flops / row["ms"] * 1e3
    log("timing rwkv6_scan_bwd " + json.dumps(row, sort_keys=True))
    return row


def rwkv_step_parity(device) -> dict:
    """17f: a 2-layer f32 cut of rwkv6-7b, its step through the kernels
    against the step with the plain backward and against the plain step
    (``TOL_TRAIN_STEP_RWKV``)."""
    return train_step_parity(
        RWKV_ARCH, 2, device, part="17f",
        refs=(("step with the plain backward", {"rwkv6_scan_bwd_cuda"},
               TOL_TRAIN_STEP),
              ("plain step", None, TOL_TRAIN_STEP_RWKV)))


def rwkv_model_flops(cfg, batch: int, seq: int) -> float:
    """One RWKV training step's work, forward and backward, not the
    recomputed forward: 6 flops a matmul weight and token (time mix: the
    five D x D projections and the two LoRAs; channel mix: its three
    matrices; the unembedding) and the recurrence's 5 D^2 + 5 D a row-step
    forward (``work``) and 10 D^2 + 12 D backward (``work_bwd``)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
    tmix = 5 * d * d + d * 5 * 32 + 5 * 32 * d + d * 64 + 64 * d
    cmix = 2 * d * f + d * d
    dense = 6.0 * (cfg.num_layers * (tmix + cmix) + d * cfg.padded_vocab) \
        * batch * seq
    rows = batch * (d // hd)
    scan = cfg.num_layers * rows * seq * (15.0 * hd * hd + 17.0 * hd)
    return dense + scan


def rwkv_train_phase() -> dict:
    """17g: the published rwkv6-7b trained whole through the launcher's
    driver: ``RWKV_TRAIN_STEPS`` AdamW steps (int8 moments, ``--remat
    block``) at 1 x ``RWKV_TRAIN_SEQ``."""
    import tempfile
    from repro_torch import configs
    cfg = configs.get(RWKV_ARCH).config
    report, counts = train_run([
        "--arch", RWKV_ARCH, "--batch", "1", "--seq", str(RWKV_TRAIN_SEQ),
        "--steps", str(RWKV_TRAIN_STEPS), "--opt", "adamw", "--state-dtype",
        RWKV_TRAIN_STATE_DTYPE, "--remat", "block", "--ckpt-every",
        "1000000", "--ckpt-dir", tempfile.mkdtemp(prefix="chip_smoke_rwkv_")],
        after=lambda driver, batch_fn: train_step_trace(
            driver, batch_fn, part="17g", kernels=RWKV_TRACE_KERNELS))
    steps = report["steps"]
    if len(steps) != RWKV_TRAIN_STEPS or not all(
            math.isfinite(l) and math.isfinite(g) for _, l, g, _ in steps):
        raise SmokeFailure(f"17g: steps {steps}")
    runs = len(steps)
    per_step = {n: counts[n] / runs for n in ("rwkv6_scan", "rwkv6_scan_bwd")}
    # Under --remat block a step runs each layer's forward twice (the
    # forward, the block's recompute) and its backward once.
    want = {"rwkv6_scan": 2 * cfg.num_layers,
            "rwkv6_scan_bwd": cfg.num_layers}
    if per_step != want:
        raise SmokeFailure(f"17g: launches a step {per_step}, want {want}")
    others = {n: c for n, c in counts.items() if c and n not in want}
    if others:
        raise SmokeFailure(f"17g: the step launched {others} besides")
    p50 = statistics.median([m for *_, m in steps][1:])
    tokens = RWKV_TRAIN_SEQ
    flops = rwkv_model_flops(cfg, 1, RWKV_TRAIN_SEQ)
    out = {"steps": steps, "step_p50_ms": p50,
           "tokens_per_s": tokens / (p50 / 1e3),
           "model_flops_per_step": flops,
           "model_tflops_per_s": flops / (p50 / 1e3) / 1e12,
           "mfu_bf16_dense": flops / (p50 / 1e3) / PEAK_BF16,
           "peak_memory_bytes": report["peak_bytes"],
           "wall_s": report["wall_s"], "launches": counts,
           "per_step": per_step, "state_dtype": RWKV_TRAIN_STATE_DTYPE,
           "trace": report["after"]}
    log("17g rwkv6-7b trained whole: " + json.dumps(
        {k: v for k, v in out.items() if k != "launches"}, sort_keys=True))
    return out


def training_phases(device) -> dict:
    """Phase 17: 17a the backward kernels against their plain versions and
    timed, 17b one f32 step through the kernels against the plain step,
    17c the published gemma2-2b trained whole with a restart, 17d
    recurrentgemma-2b, 17e the RWKV backward kernel against its plain
    version and timed, 17f one f32 rwkv6-7b step against the plain step,
    17g the published rwkv6-7b trained whole; each part's wall time
    printed."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"training phases: {torch.cuda.memory_allocated()} bytes allocated "
        f"at the start")
    walls = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(17)
    worst = train_flash_checks(gen, device)
    rows = [train_flash_row(gen, device, *case)
            for case in TRAIN_FLASH_CASES]
    scan = scan_bwd_row(gen, device)
    walls["17a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parity = [train_step_parity(TRAIN_ARCH, 2, device),
              train_step_parity(LM_ARCH, 3, device)]
    walls["17b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gemma = gemma_train_phase()
    walls["17c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    griffin = griffin_train_phase()
    walls["17d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rwkv_worst = rwkv_bwd_checks(gen, device)
    rwkv_rows = [rwkv_bwd_row(gen, device, *case) for case in RWKV_BWD_CASES
                 if case[0] in RWKV_BWD_TIMED]
    walls["17e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parity.append(rwkv_step_parity(device))
    walls["17f"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rwkv = rwkv_train_phase()
    walls["17g"] = time.perf_counter() - t0
    log(f"phase 17 (training): {json.dumps(walls, sort_keys=True)}, "
        f"{sum(walls.values()):.1f} s in all")
    return {"worst": worst, "rows": rows, "scan": scan, "parity": parity,
            "gemma": gemma, "griffin": griffin, "rwkv": rwkv,
            "rwkv_worst": rwkv_worst, "rwkv_rows": rwkv_rows,
            "walls_s": walls,
            "launches": {f"{TRAIN_ARCH} train": gemma["launches"],
                         f"{LM_ARCH} train": griffin["launches"],
                         f"{RWKV_ARCH} train": rwkv["launches"]}}


def train_kernel_entry(train: dict) -> dict:
    """The ``flash_attention_bwd`` entry of the kernels line: its main-path
    launches (the two training runs), its largest error against the plain
    version, and its row at gemma2-2b's shape beside every other row."""
    row = train["rows"][0]
    keys = ("shape", "ms", "eager_ms", "f32_ms", "plain_ms", "library_ms",
            "sdpa_no_softcap_ms", "library_form", "bound_ms", "bound_by",
            "tflops", "splits")
    return {"name": "flash_attention_bwd", **KERNEL_META[
                "flash_attention_bwd"],
            "launches": sum(c["flash_attention_bwd"]
                            for c in train["launches"].values()),
            "launches_by_path": {p: c["flash_attention_bwd"]
                                 for p, c in train["launches"].items()},
            "launches_per_step": {
                TRAIN_ARCH: train["gemma"]["per_step"]["flash_attention_bwd"],
                LM_ARCH: train["griffin"]["per_step"][
                    "flash_attention_bwd"]},
            "max_abs_err": train["worst"]["abs"],
            "max_rel_err": train["worst"]["rel"],
            "max_lse_rel_err": train["worst"]["lse_rel"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "sdpa_no_softcap_ms": row.get("sdpa_no_softcap_ms"),
            "eager_ms": row["eager_ms"], "shape": row["shape"],
            "rows": [{k: r[k] for k in keys if k in r}
                     for r in train["rows"]],
            "scan_backward": train["scan"]}


def rwkv_bwd_kernel_entry(train: dict) -> dict:
    """The ``rwkv6_scan_bwd`` entry of the kernels line: its main-path
    launches (17g's run), its largest error against the plain version
    (17e), and its row at 17g's shape beside the forward's."""
    row = train["rwkv_rows"][0]
    keys = ("shape", "ms", "eager_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "f32_flops_per_s", "scratch_bytes",
            "scratch_block_bytes", "forward_ms",
            "forward_states_ms")
    return {"name": "rwkv6_scan_bwd", **KERNEL_META["rwkv6_scan_bwd"],
            "launches": sum(c["rwkv6_scan_bwd"]
                            for c in train["launches"].values()),
            "launches_by_path": {p: c["rwkv6_scan_bwd"]
                                 for p, c in train["launches"].items()},
            "launches_per_step": {
                RWKV_ARCH: train["rwkv"]["per_step"]["rwkv6_scan_bwd"]},
            "max_abs_err": train["rwkv_worst"]["abs"],
            "max_rel_err": train["rwkv_worst"]["rel"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "eager_ms": row["eager_ms"],
            "shape": row["shape"],
            "rows": [{k: r[k] for k in keys if k in r}
                     for r in train["rwkv_rows"]]}


# ---------------------------------------------------------------------------
# Phase 18: the multi-device paths (torch.distributed)
# ---------------------------------------------------------------------------

MD_TIMED_STEPS = 3             # 18a: p50 of this many steps of each kind
MD_W2_SEQ = 1024               # 18b(i): the f32 cut's sequence, 1 a rank
MD_W2_LAYERS = 2
MD_W2_COMPRESSED_STEPS = 3
MD_MOE_ARCH = "mixtral-8x22b"
MD_MOE_TOKENS = (2, 512)       # 18b(ii): the f32 check's (B, S)
MD_MOE_TIMED = (1, 4096)       # 18b(ii): the timed bf16 run's (B, S)
MD_PIPE_LAYERS = 4             # 18b(iii): rwkv6-7b's first 4 of 32
MD_PIPE_MICRO = 4
MD_PIPE_SEQ = 1024
MD_WORLD_S = 600               # 18b's wall limit, process start included
# 18a holds the reduced gradients and the loss bit-equal (NCCL at world 1
# adds nothing and the step's kernels use no atomics).  18b(i): the mean of
# two ranks' one-row gradients against the two-row one, f32, summation
# order apart; (ii) the reference's own 2e-4 for the sharded MoE block
# (tests/test_moe_distributed.py), of the largest value; (iii) the 4 layers
# pipelined against the
# same layers in sequence, a microbatch at a time.
TOL_MD_GRAD = 1e-5
TOL_MD_LOSS = 1e-6
TOL_MD_MOE = 2e-4
TOL_MD_PIPE = 1e-5


def _md_batch(cfg, device, batch: int, seq: int, step: int) -> dict:
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import tree
    return tree.tree_map(lambda a: tree.as_tensor(a, device), synth_batch(
        cfg, batch=batch, seq=seq, step=step))


def _plain_grads(loss_fn, params, batch):
    """The loss and gradients of one batch with no process group."""
    from repro_torch.train import step as step_lib
    leaves = step_lib._trainable(params)
    loss, _ = loss_fn(params, batch)
    grads = step_lib._grad(loss, leaves)
    del leaves
    return loss.detach(), [g.detach() for g in grads]


def _quantized(c):
    """The compressed reduction's formula at one rank: (q * scale,
    c - q * scale) of the f32 ``c``."""
    import torch
    scale = c.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
    return q.float() * scale, c - q.float() * scale


def _synced_ms(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def dp_world1_phase(device) -> dict:
    """18a: the published gemma2-2b at 17c's 2 x 4096 through
    ``build_manual_dp_step`` on a (1, 1) mesh, NCCL at world 1 in this
    process: the uncompressed step's reduced gradients and loss bit-equal
    to the step with no process group, the compressed step's reduced
    gradients and residuals bit-equal to ``q * scale`` and ``c - q *
    scale`` recomputed here; then each kind timed."""
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import api, tree
    from repro_torch.train import compression, optimizer
    from repro_torch.train import step as step_lib
    t_all = time.perf_counter()
    cfg = configs.get(TRAIN_ARCH).config
    with tempfile.TemporaryDirectory() as tmp:
        mesh_lib.init_world(0, 1, device=device.type,
                            store_path=str(pathlib.Path(tmp) / "store"))
        try:
            mesh = mesh_lib.make_host_mesh()
            params = api.init(cfg, torch.Generator(device=device).manual_seed(
                0), device=device)
            n_params = sum(t.numel() for t in tree.leaves(params))
            opt = optimizer.make("adamw", state_dtype=TRAIN_STATE_DTYPE)
            state = step_lib.train_state(params, opt)
            state["residual"] = compression.ErrorFeedback.init(
                params, world=1, mesh=mesh)
            loss_fn = step_lib.make_loss_fn(cfg, step_lib.TrainOptions(
                remat="block", chunked_loss=True))
            want: dict = {}
            held: dict = {}

            def held_uncompressed(loss, reduced, new_res):
                if not torch.equal(loss, want["loss"]):
                    raise SmokeFailure(f"18a: the DP step's loss "
                                       f"{float(loss)} is not the plain "
                                       f"step's {float(want['loss'])}")
                for i, (g, w) in enumerate(zip(tree.leaves(reduced),
                                               want["grads"])):
                    if not torch.equal(g, w.float()):
                        raise SmokeFailure(
                            f"18a: reduced gradient leaf {i} "
                            f"{tuple(g.shape)} differs from the plain "
                            f"step's by {float((g - w.float()).abs().max())}")
                held["uncompressed_leaves"] = len(want["grads"])

            def held_compressed(loss, reduced, new_res):
                if not torch.equal(loss, want["loss"]):
                    raise SmokeFailure("18a: the compressed step's loss is "
                                       "not the plain step's")
                for i, (g, e, w) in enumerate(zip(
                        tree.leaves(reduced), tree.leaves(new_res),
                        want["grads"])):
                    # The residual was zero: c = g.
                    q_scale, res = _quantized(w.float())
                    if not (torch.equal(g, q_scale) and torch.equal(e, res)):
                        raise SmokeFailure(
                            f"18a: compressed leaf {i} {tuple(g.shape)}: "
                            f"reduced off q*scale by "
                            f"{float((g - q_scale).abs().max())}, residual "
                            f"off c - q*scale by "
                            f"{float((e - res).abs().max())}")
                held["compressed_leaves"] = len(want["grads"])

            def plain(step):
                want.clear()
                want["loss"], want["grads"] = _plain_grads(
                    loss_fn, params, _md_batch(cfg, device, TRAIN_BATCH,
                                               TRAIN_SEQ, step))

            build = compression.build_manual_dp_step
            counts = collections.Counter()

            def drive(step_fn, s):
                nonlocal state
                before = ops.launch_counts()
                batch = _md_batch(cfg, device, TRAIN_BATCH, TRAIN_SEQ, s)
                ms = _synced_ms(lambda: state.update(step_fn(state, batch)))
                counts.update({n: c - before[n]
                               for n, c in ops.launch_counts().items()})
                return ms
            plain(0)
            ops.reset_launches()
            drive(build(loss_fn, opt, mesh, compress=True,
                        observe=held_compressed), 0)
            plain(1)
            drive(build(loss_fn, opt, mesh, compress=False,
                        observe=held_uncompressed), 1)
            want.clear()
            gc.collect()
            times, peaks = {}, {}
            for kind, compress in (("uncompressed", False),
                                   ("compressed", True)):
                step_fn = build(loss_fn, opt, mesh, compress=compress)
                torch.cuda.reset_peak_memory_stats()
                times[kind] = [drive(step_fn, 2 + i)
                               for i in range(MD_TIMED_STEPS)]
                peaks[kind] = torch.cuda.max_memory_allocated()
            # 19b: one more uncompressed step, counted (the kernels' work
            # records and the aten ops) for the dry run to be held to.
            from repro_torch.launch import graph_analysis
            step_fn = build(loss_fn, opt, mesh, compress=False)
            batch = _md_batch(cfg, device, TRAIN_BATCH, TRAIN_SEQ, 99)
            counted = graph_analysis.analyze_step(
                lambda: state.update(step_fn(state, batch)))
            del batch
            steps = 3 + 2 * MD_TIMED_STEPS
            if int(state["step"]) != steps:
                raise SmokeFailure(f"18a: the state's step is "
                                   f"{int(state['step'])}, want {steps}")
            for name in ("flash_attention", "flash_attention_bwd"):
                if counts[name] == 0:
                    raise SmokeFailure(f"18a: {name} launched no time in "
                                       f"the DP steps")
            residual_bytes = sum(r.to_local().numel() * 4
                                 for r in tree.leaves(state["residual"]))
            del state, params, opt
        finally:
            mesh_lib.close_world()
    gc.collect()
    torch.cuda.empty_cache()
    p50 = {k: statistics.median(v) for k, v in times.items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"arch": TRAIN_ARCH, "params": n_params,
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "held": held,
           "step_ms": times, "step_p50_ms": p50,
           "tokens_per_s": {k: tokens / (v / 1e3) for k, v in p50.items()},
           "peak_memory_bytes": peaks,
           "compressed_extra_ms": p50["compressed"] - p50["uncompressed"],
           "compressed_extra_peak_bytes":
               peaks["compressed"] - peaks["uncompressed"],
           "residual_bytes": residual_bytes,
           "launches": dict(counts), "steps": steps,
           "counted": {k: v for k, v in counted.items() if k != "kernels"}
           | {"kernels": {k: dict(v) for k, v in counted["kernels"].items()}},
           "per_step": {n: counts[n] / steps for n in
                        ("flash_attention", "flash_attention_bwd")},
           "wall_s": time.perf_counter() - t_all}
    log("18a gemma2-2b manual DP step, NCCL world 1: "
        + json.dumps(out, sort_keys=True))
    return out


def _md_probe(mesh, device) -> dict:
    """Each op of the collectives module on CUDA tensors over gloo: the
    native form (where gloo carries it) bit-equal to the composed one;
    ``ppermute`` (composed on CUDA) against the values it must move."""
    import torch
    from repro_torch import collectives as coll
    rank = coll.axis_index("model", mesh)
    out = {}
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        x = (torch.arange(24, device=device).reshape(4, 6) * 7
             + 100 * rank).to(dt)
        for name, fn in (
                ("all_gather", lambda: coll.all_gather(
                    x, "model", dim=1, tiled=True, mesh=mesh)),
                ("all_to_all", lambda: coll.all_to_all(
                    x, "model", split_axis=0, concat_axis=1, mesh=mesh))):
            native = fn()
            with coll.force_composed():
                composed = fn()
            if not torch.equal(native, composed):
                raise SmokeFailure(f"18b: gloo's native {name} on CUDA "
                                   f"{dt} differs from the composed form")
            out[f"{name} {dt}"] = "native = composed"
        got = coll.ppermute(x, "model", [(0, 1), (1, 0)], mesh=mesh)
        want = (torch.arange(24, device=device).reshape(4, 6) * 7
                + 100 * (1 - rank)).to(dt)
        if not torch.equal(got, want):
            raise SmokeFailure(f"18b: ppermute on CUDA {dt} moved the "
                               f"wrong values")
        out[f"ppermute {dt}"] = "composed, held"
    return out


def _md_dp(device, mesh) -> dict:
    """18b(i): a 2-layer f32 cut of gemma2-2b at full width, a row a
    rank: the pmean'd gradients and loss against the whole batch's with no
    group; then compressed steps, after which both ranks' parameters must
    be bit-equal."""
    import torch
    from repro_torch import collectives as coll
    from repro_torch.models import api, tree
    from repro_torch.train import compression, optimizer
    from repro_torch.train import step as step_lib
    cfg = _cut(TRAIN_ARCH, MD_W2_LAYERS)
    params = api.init(cfg, torch.Generator(device=device).manual_seed(0),
                      device=device)
    opt = optimizer.make("adamw", state_dtype="bfloat16")
    state = step_lib.train_state(params, opt)
    state["residual"] = compression.ErrorFeedback.init(params, world=2,
                                                       mesh=mesh)
    loss_fn = step_lib.make_loss_fn(cfg, step_lib.TrainOptions(
        remat="block", chunked_loss=True))
    whole = _md_batch(cfg, device, 2, MD_W2_SEQ, 0)
    w_loss, w_grads = _plain_grads(loss_fn, params, whole)
    seen = {}

    def held(loss, reduced, new_res):
        mean = coll.pmean(loss, "data")
        seen["loss_rel_err"] = float((mean - w_loss).abs() / w_loss.abs())
        worst = 0.0
        for g, w in zip(tree.leaves(reduced), w_grads):
            worst = max(worst, float((g - w).abs().max())
                        / max(float(w.abs().max()), 1e-30))
        seen["grad_worst_rel_err"] = worst
    state = compression.build_manual_dp_step(
        loss_fn, opt, mesh, compress=False, observe=held)(state, whole)
    del w_grads
    step_c = compression.build_manual_dp_step(loss_fn, opt, mesh,
                                              compress=True)
    ms = [_synced_ms(lambda: state.update(step_c(
        state, _md_batch(cfg, device, 2, MD_W2_SEQ, 1 + i))))
        for i in range(MD_W2_COMPRESSED_STEPS)]
    unequal = [i for i, t in enumerate(tree.leaves(state["params"]))
               if not torch.equal(*coll.all_gather(t.detach(), "data",
                                                   mesh=mesh).unbind(0))]
    seen.update(compressed_step_ms=ms, params_unequal_leaves=unequal,
                leaves=len(tree.leaves(state["params"])))
    del state, params
    return seen


def _md_moe(device, mesh) -> dict:
    """18b(ii): one mixtral-8x22b MoE layer at full width, EP and a2a on a
    (1, 2) mesh, against the local block; then bf16, timed."""
    import dataclasses
    import torch
    from repro_torch import sharding
    from repro_torch.models import moe as moe_lib
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = moe_cut(MD_MOE_ARCH, 1, dtype=dtype, no_drop=True)
        gen = torch.Generator(device=device).manual_seed(1)
        p = moe_lib.init_moe(gen, cfg, device=device)
        b, s = MD_MOE_TOKENS if dtype == "float32" else MD_MOE_TIMED
        x = torch.randn((b, s, cfg.d_model), generator=gen, device=device
                        ).to(getattr(torch, dtype))
        local = moe_lib.moe_block(p, x, cfg)[0] if dtype == "float32" \
            else None
        for impl in ("gather_psum", "a2a"):
            c = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, impl=impl))
            with sharding.use_rules(mesh, sharding.train_rules(mesh)):
                box = {}
                ms = _synced_ms(lambda: box.update(
                    y=moe_lib.moe_block(p, x, c)[0]))
            y = box["y"]
            if local is not None:
                # Of the largest value: at full width the outputs run to
                # the hundreds, and an f32 sum over 6144 or 16384 terms in
                # another order moves a near-zero output by ~1e-2.
                err = float((y - local).abs().max())
                scale = float(local.abs().max())
                if not (torch.isfinite(y).all()
                        and err <= TOL_MD_MOE * scale):
                    raise SmokeFailure(f"18b: the {impl} MoE block is "
                                       f"{err} off the local block, whose "
                                       f"largest value is {scale} (limit "
                                       f"{TOL_MD_MOE} of it)")
                out[f"{impl} f32 max_abs_err"] = err
                out[f"{impl} f32 rel_err"] = err / scale
            else:
                if not torch.isfinite(y.float()).all():
                    raise SmokeFailure(f"18b: the bf16 {impl} MoE block "
                                       f"is not finite")
                out[f"{impl} bf16 ms"] = ms
        del p, x, local
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _md_pipeline(device) -> dict:
    """18b(iii): rwkv6-7b's first 4 layers at full width in f32 through
    ``pipeline_apply`` over two stages, against the layers in sequence."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import rwkv, tree
    from repro_torch.train import pipeline_par
    cfg = _cut(RWKV_ARCH, MD_PIPE_LAYERS)
    gen = torch.Generator(device=device).manual_seed(2)
    blocks = rwkv.init_rwkv(cfg, generator=gen, device=device)["blocks"]
    x = torch.randn((MD_PIPE_MICRO, MD_PIPE_SEQ, cfg.d_model),
                    generator=gen, device=device)

    def layer(pl, h):
        return rwkv._rwkv_block(pl, h, cfg, None)[0]
    def in_sequence(h):
        for pl in tree.unstack(blocks, MD_PIPE_LAYERS):
            h = layer(pl, h)
        return h
    with torch.no_grad():
        # A microbatch at a time, as the stages see them: the same shapes
        # to every kernel and GEMM.
        seq = torch.cat([in_sequence(m) for m in x.split(
            x.shape[0] // MD_PIPE_MICRO)])
        pmesh = mesh_lib.make_mesh((2,), ("pod",))
        before = ops.launch_counts()
        box = {}
        ms = _synced_ms(lambda: box.update(y=pipeline_par.pipeline_apply(
            layer, blocks, x, mesh=pmesh, axis="pod",
            microbatches=MD_PIPE_MICRO)))
        counts = {n: c - before[n] for n, c in ops.launch_counts().items()
                  if c - before[n]}
    err = float((box["y"] - seq).abs().max() / seq.abs().max())
    if not err <= TOL_MD_PIPE:
        raise SmokeFailure(f"18b: the pipelined layers are {err} of the "
                           f"largest value off the layers in sequence")
    if counts.get("rwkv6_scan", 0) == 0:
        raise SmokeFailure("18b: the pipeline launched no rwkv6_scan")
    return {"rel_err": err, "ms": ms, "launches": counts}


def _md_elastic_state(device):
    """18b(iv)'s state: a 2-layer cut of gemma2-2b (f32 params, AdamW's
    bf16 moments, drawn), the same from the same seeds on every rank."""
    import torch
    from repro_torch.models import api, tree
    from repro_torch.train import optimizer
    from repro_torch.train import step as step_lib
    cfg = _cut(TRAIN_ARCH, MD_W2_LAYERS)
    params = api.init(cfg, torch.Generator(device=device).manual_seed(3),
                      device=device)
    state = step_lib.train_state(params, optimizer.make(
        "adamw", state_dtype="bfloat16"), step=7)
    gen = torch.Generator(device=device).manual_seed(4)
    with torch.no_grad():
        for leaf in tree.leaves(state["opt"]):
            leaf.normal_(generator=gen)
    return cfg, state


def md_rank(rank: int, ckpt_dir: str) -> dict:
    """Phase 18b on one of two ranks sharing the card over gloo."""
    import torch
    from repro_torch import collectives as coll
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import tree
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import step as step_lib
    device = mesh_lib.world_device()
    out, walls = {}, {}
    t0 = time.perf_counter()
    mesh = mesh_lib.make_host_mesh(model=2)
    out["probe"] = _md_probe(mesh, device)
    coll.COMPOSED.clear()           # what the paths below compose
    walls["probe"] = time.perf_counter() - t0
    dmesh = mesh_lib.make_host_mesh()
    for part, fn in (("dp", lambda: _md_dp(device, dmesh)),
                     ("moe", lambda: _md_moe(device, mesh)),
                     ("pipeline", lambda: _md_pipeline(device))):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        out[part] = fn()
        out[part]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        walls[part] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg, state = _md_elastic_state(device)
    sh = step_lib.state_shardings(state, cfg, dmesh)
    laid = tree.tree_map(lambda t, s: coll.distribute(t.detach(), s.spec,
                                                      s.mesh), state, sh)
    del state
    out["elastic"] = {
        "sharded_leaves": sum(1 for t in tree.leaves(laid)
                              if t.to_local().numel() < t.numel()),
        "local_bytes": sum(t.to_local().numel() * t.element_size()
                           for t in tree.leaves(laid))}
    ckpt_lib.save(ckpt_dir, laid, 7)
    walls["elastic save"] = time.perf_counter() - t0
    out["walls_s"] = walls
    out["composed"] = sorted(coll.COMPOSED)
    return out


def elastic_restore(device, ckpt_dir: str) -> dict:
    """18b(iv) in this process: the checkpoint the two ranks saved,
    restored onto a (1, 1) mesh at world 1 by ``resume_elastic``; every
    leaf bit-equal to the state they laid out."""
    import tempfile
    import torch
    from repro_torch import collectives as coll
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import tree
    from repro_torch.train import fault
    from repro_torch.train import step as step_lib
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mesh_lib.init_world(0, 1, device=device.type,
                            store_path=str(pathlib.Path(tmp) / "store"))
        try:
            cfg, state = _md_elastic_state(device)
            mesh = mesh_lib.make_host_mesh()
            like = tree.tree_map(lambda t: torch.empty(
                t.shape, dtype=t.dtype, device="meta"), state)
            drv = fault.TrainDriver(fault.DriverConfig(ckpt_dir=ckpt_dir),
                                    step_fn=None, batch_fn=None,
                                    state=state)
            got = drv.resume_elastic(like, step_lib.state_shardings(
                state, cfg, mesh))
            unequal = [i for i, (a, b) in enumerate(zip(
                tree.leaves(got), tree.leaves(state)))
                if not torch.equal(coll.gather(a), b.detach())]
            n = len(tree.leaves(state))
            event = drv.events[-1]
            del got, state, drv
        finally:
            mesh_lib.close_world()
    if unequal or event != ("elastic_resume", 7):
        raise SmokeFailure(f"18b: the elastic restore: leaves {unequal} of "
                           f"{n} differ, event {event}")
    return {"leaves": n, "event": list(event),
            "s": time.perf_counter() - t0}


def multi_device_phases(device) -> dict:
    """Phase 18: 18a the manual DP step at world 1 (NCCL, this process);
    18b two processes on the card over gloo: the collective probe, the DP
    step, the MoE layouts, the pipeline, and the elastic save restored
    here onto world 1."""
    import shutil
    import tempfile
    import torch
    from repro_torch.launch import mesh as mesh_lib
    gc.collect()
    torch.cuda.empty_cache()
    t_all = time.perf_counter()
    walls = {}
    dp = dp_world1_phase(device)
    walls["18a"] = dp["wall_s"]
    t0 = time.perf_counter()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        ranks = mesh_lib.spawn_host_world(
            md_rank, 2, backend="gloo", device=device.type,
            timeout_s=MD_WORLD_S, args=(ckpt,))
        written = sum(f.stat().st_size
                      for f in pathlib.Path(ckpt).rglob("*") if f.is_file())
        restored = elastic_restore(device, ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    walls["18b"] = time.perf_counter() - t0
    for r, out in enumerate(ranks):
        log(f"18b rank {r}: " + json.dumps(out, sort_keys=True))
        dp_r = out["dp"]
        if not (dp_r["grad_worst_rel_err"] <= TOL_MD_GRAD
                and dp_r["loss_rel_err"] <= TOL_MD_LOSS):
            raise SmokeFailure(f"18b rank {r}: the DP step's gradients "
                               f"{dp_r['grad_worst_rel_err']} and loss "
                               f"{dp_r['loss_rel_err']} off the whole "
                               f"batch's (limits {TOL_MD_GRAD}, "
                               f"{TOL_MD_LOSS})")
        if dp_r["params_unequal_leaves"]:
            raise SmokeFailure(f"18b rank {r}: after the compressed steps "
                               f"the ranks' params differ on leaves "
                               f"{dp_r['params_unequal_leaves']}")
    composed = ranks[0]["composed"]
    log(f"18b collectives: gloo on CUDA composed {composed}, native the "
        f"rest; probe {json.dumps(ranks[0]['probe'], sort_keys=True)}")
    log(f"18b elastic: {written} bytes written, restored "
        + json.dumps(restored, sort_keys=True))
    walls["all"] = time.perf_counter() - t_all
    log(f"phase 18 (multi-device): {json.dumps(walls, sort_keys=True)}")
    pipe = [out["pipeline"]["launches"] for out in ranks]
    return {"dp": dp, "ranks": ranks, "restored": restored,
            "checkpoint_bytes": written, "composed": composed,
            "walls_s": walls,
            "launches": {f"{TRAIN_ARCH} dp step": dp["launches"],
                         f"{RWKV_ARCH} pipeline": dict(
                             collections.Counter(pipe[0])
                             + collections.Counter(pipe[1]))}}


def multi_device_readings(md: dict) -> dict:
    """Phase 18's block of the summary line."""
    dp = md["dp"]
    return {
        "18a": {k: dp[k] for k in (
            "held", "step_p50_ms", "tokens_per_s", "peak_memory_bytes",
            "compressed_extra_ms", "compressed_extra_peak_bytes",
            "residual_bytes", "per_step")},
        "18b": {"composed": md["composed"],
                "dp": [r["dp"] for r in md["ranks"]],
                "moe": [r["moe"] for r in md["ranks"]],
                "pipeline": [r["pipeline"] for r in md["ranks"]],
                "elastic": {"saved": [r["elastic"] for r in md["ranks"]],
                            "checkpoint_bytes": md["checkpoint_bytes"],
                            "restored": md["restored"]}},
        "walls_s": md["walls_s"]}


# ---------------------------------------------------------------------------
# Phase 19: the dry run and its roofline
# ---------------------------------------------------------------------------

DRYRUN_CELLS = ("gemma2-27b:train_4k:single", "gemma2-27b:train_4k:multi",
                "rwkv6-7b:long_500k:single")
DRYRUN_FLOP_TOL = 0.01       # 19b: the dry run's FLOPs against the card's
DRYRUN_FLASH_TOL = 0.01      # 19a: a train cell's flash work, its even share


DRYRUN_DIR = ROOT / "chiprun_out" / "dryrun_19"


def dryrun_start() -> dict:
    """19a's runs, started before the kernels' build so that they are done
    before the first phase that times anything (:func:`dryrun_join`):
    ``python -m repro_torch.launch.dryrun --cell <cell>`` in a process a
    cell, the three at once (a fake world of 256 or 512 ranks each, no
    device memory past a CUDA context), then ``python -m
    repro_torch.launch.roofline --mesh single`` over their cells.  A thread
    of this process waits on them; the returned dict holds the processes,
    and the thread's exit codes, times and roofline run."""
    import os
    import shutil
    import threading
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    run = {"t0": time.perf_counter(), "procs": {}}
    for cell in DRYRUN_CELLS:
        tag = cell.replace(":", ".")
        with open(DRYRUN_DIR / f"{tag}.stdout.txt", "w") as out, \
                open(DRYRUN_DIR / f"{tag}.stderr.txt", "w") as err:
            run["procs"][cell] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
                 str(DRYRUN_DIR), "--cell", cell], cwd=ROOT, env=env,
                stdout=out, stderr=err)

    def wait():
        try:
            run["rcs"] = {cell: proc.wait(timeout=900)
                          for cell, proc in run["procs"].items()}
            run["dryrun_s"] = time.perf_counter() - run["t0"]
            if any(run["rcs"].values()):
                return
            t1 = time.perf_counter()
            run["roofline"] = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.roofline",
                 "--inp", str(DRYRUN_DIR), "--out",
                 str(DRYRUN_DIR / "roofline_single.md"), "--mesh", "single"],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=300)
            run["roofline_s"] = time.perf_counter() - t1
        except Exception as exc:  # noqa: BLE001 — raised by dryrun_join
            run["error"] = exc

    run["thread"] = threading.Thread(target=wait, daemon=True)
    run["thread"].start()
    return run


def dryrun_stop(run: dict) -> None:
    """Kill what :func:`dryrun_start` started and is still running."""
    for proc in run["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dryrun_join(run: dict) -> None:
    """Wait for :func:`dryrun_start`'s runs: each dry-run process and the
    roofline must exit 0.  Their output is printed here and read by
    :func:`dryrun_phase`."""
    t_wait = time.perf_counter()
    run["thread"].join(timeout=1200)
    if run["thread"].is_alive() or "error" in run:
        dryrun_stop(run)
        raise SmokeFailure(f"19a dry run: {run.get('error', 'timed out')}")
    log(f"19a dryrun: {len(DRYRUN_CELLS)} processes at once, done in "
        f"{run['dryrun_s']:.1f} s (waited {time.perf_counter() - t_wait:.1f}"
        f" s here)")
    for cell, rc in run["rcs"].items():
        tag = cell.replace(":", ".")
        log(f"19a dryrun --cell {cell}: rc {rc}\n"
            f"{(DRYRUN_DIR / f'{tag}.stdout.txt').read_text().strip()}")
        if rc != 0:
            err = (DRYRUN_DIR / f"{tag}.stderr.txt").read_text()
            raise SmokeFailure(f"python -m repro_torch.launch.dryrun --cell "
                               f"{cell} exited {rc}:\n{err[-4000:]}")
    rp = run["roofline"]
    log(f"19a roofline --mesh single: rc {rp.returncode} in "
        f"{run['roofline_s']:.1f} s\n{rp.stdout.strip()}")
    if rp.returncode != 0:
        raise SmokeFailure(f"python -m repro_torch.launch.roofline exited "
                           f"{rp.returncode}:\n{rp.stderr}")


def flash_share(arch_name: str, shape_name: str, ranks: int) -> dict:
    """One rank's flash FLOPs in a train cell whose batch and heads split
    evenly over its ``ranks``: each layer's forward twice (the block remat
    runs it again in the backward) and its backward once, at the cell's
    global shapes, over the ranks."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    arch = configs.get(arch_name)
    cfg, sh = arch.config, arch.shapes[shape_name]
    fwd = bwd = 0.0
    for i in range(cfg.num_layers):
        kind = cfg.attn_pattern[i % len(cfg.attn_pattern)]
        window = cfg.window if kind == "local" else None
        shape = (sh.global_batch, cfg.num_heads, cfg.num_kv_heads,
                 sh.seq_len, sh.seq_len, cfg.head_dim, 2)
        fwd += 2 * fa.work(*shape, causal=True, window=window,
                           q_offset=0)[0]
        bwd += fb.work(*shape, causal=True, window=window)[0]
    return {"flash_attention": fwd / ranks, "flash_attention_bwd": bwd / ranks}


def dryrun_phase(run: dict) -> dict:
    """19a: the cells :func:`dryrun_start` counted, and ``python -m
    repro_torch.launch.roofline --mesh multi``'s ``main`` in this process
    (the single mesh ran in its own).  Each cell counts FLOPs on its rank;
    each train cell has the FSDP weight all-gather and the gradient's
    reduction among its collectives, and each flash kernel's FLOPs within
    ``DRYRUN_FLASH_TOL`` of its even share (:func:`flash_share`).  Prints
    each cell's terms and bound on the datasheet ceilings, its bytes
    against the card's memory, and its wall time."""
    from repro_torch import hw
    from repro_torch.launch import roofline
    t0 = time.perf_counter()
    argv = ["--inp", str(DRYRUN_DIR), "--out",
            str(DRYRUN_DIR / "roofline_multi.md"), "--mesh", "multi"]
    rp = in_process(roofline.main, argv)
    log(f"19a roofline --mesh multi (in process): rc {rp.returncode} in "
        f"{time.perf_counter() - t0:.1f} s\n{rp.stdout.strip()}")
    if rp.returncode != 0:
        raise SmokeFailure(f"python -m repro_torch.launch.roofline --mesh "
                           f"multi exited {rp.returncode}:\n{rp.stderr}")
    cells = {}
    for spec in DRYRUN_CELLS:
        arch, shape, mesh = spec.split(":")
        path = DRYRUN_DIR / f"{arch.replace('-', '_')}.{shape}.{mesh}.json"
        cell = json.loads(path.read_text())
        if "error" in cell or "skipped" in cell or not cell["flops"] > 0:
            raise SmokeFailure(f"19a {spec}: {cell.get('error')} "
                               f"{cell.get('skipped')} {cell.get('flops')}")
        kinds = set(cell["collectives"])
        if cell["phase"] == "train" and not (
                "all-gather" in kinds
                and kinds & {"reduce-scatter", "all-reduce"}):
            raise SmokeFailure(f"19a {spec}: collectives {sorted(kinds)}, "
                               f"want the FSDP all-gather and the "
                               f"gradient's reduction")
        flash = {}
        if cell["phase"] == "train":
            for k, want in flash_share(arch, shape, cell["ranks"]).items():
                got = cell["kernels"].get(k, {}).get("flops", 0.0)
                flash[k] = {"flops": got, "share": want,
                            "gap": abs(got - want) / want}
                if flash[k]["gap"] > DRYRUN_FLASH_TOL:
                    raise SmokeFailure(
                        f"19a {spec}: {k} counts {got:.6e} FLOPs a rank, "
                        f"its even share {want:.6e} ({flash[k]['gap']:.4f} "
                        f"apart, want {DRYRUN_FLASH_TOL})")
        row = roofline.analyze_cell(cell)
        mem = cell["temp_size_in_bytes"] + cell["argument_size_in_bytes"]
        cells[spec] = {
            "flops": cell["flops"], "hlo_bytes": cell["hlo_bytes"],
            "kernel_flops": cell["kernel_flops"], "flash": flash,
            "collective_operand_bytes": cell["collective_operand_bytes"],
            "collectives": {k: {f: v[f] for f in ("count", "operand_bytes")}
                            for k, v in cell["collectives"].items()},
            "t_compute_s": row["t_compute_s"],
            "t_memory_s": row["t_memory_s"],
            "t_collective_s": row["t_collective_s"],
            "dominant": row["dominant"],
            "bound_s": row["step_time_lower_bound_s"],
            "hbm_bytes": mem, "hbm_capacity": hw.H100_SXM.hbm_bytes,
            "fits_hbm": row["fits_hbm"], "wall_s": cell["compile_s"],
            "depth": cell["depth"], "device": cell["device"]}
        log(f"19a {spec}: " + json.dumps(cells[spec], sort_keys=True))
    return {"cells": cells, "dryrun_s": run["dryrun_s"],
            "roofline_s": run["roofline_s"],
            "wall_s": time.perf_counter() - t0}


def roofline_step_phase(md: dict) -> dict:
    """19b: 18a's gemma2-2b step (2 x 4096, block remat, the chunked loss,
    AdamW with bf16 moments) counted twice: by the dry run on fake tensors
    (one rank, no world) and by ``analyze_step`` of the real step on the
    card (18a's ``counted``: the kernels' work records and the aten ops).
    The FLOPs must agree within ``DRYRUN_FLOP_TOL``, and the dry run's
    roofline bound on the datasheet ceilings must not pass the measured
    step's p50."""
    from repro_torch import configs, hw
    from repro_torch.launch import dryrun
    from repro_torch.obs.profile import roofline_terms
    t0 = time.perf_counter()
    arch = configs.get(TRAIN_ARCH)
    shape = configs.ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    arch = configs.Arch(arch.name, arch.config, arch.smoke,
                        {"train_4k": shape})
    counts, meta = dryrun.lower_cell(
        arch, "train_4k", None, device="cuda",
        opt_overrides={"name": "adamw",
                       "kw": {"state_dtype": TRAIN_STATE_DTYPE}},
        train_overrides={"microbatches": 1, "remat": "block",
                         "chunked_loss": True})
    card = md["counted"]
    gap = abs(counts["flops"] - card["flops"]) / card["flops"]
    terms = roofline_terms(counts["flops"], counts["hlo_bytes"], 0,
                           hw=hw.H100_SXM)
    bound_ms = terms["ceiling_s"] * 1e3
    p50_ms = md["step_p50_ms"]["uncompressed"]
    out = {"dry_flops": counts["flops"], "card_flops": card["flops"],
           "flop_gap": gap, "dry_bytes": counts["hlo_bytes"],
           "card_bytes": card["bytes"],
           "dry_kernel_flops": counts["kernel_flops"],
           "card_kernel_flops": card["kernel_flops"],
           "t_compute_ms": terms["t_compute_s"] * 1e3,
           "t_memory_ms": terms["t_memory_s"] * 1e3,
           "bound": terms["bound"], "bound_ms": bound_ms,
           "step_p50_ms": p50_ms, "p50_over_bound": p50_ms / bound_ms,
           "roofline_fraction": bound_ms / p50_ms,
           "depth": meta["depth"], "wall_s": time.perf_counter() - t0}
    log("19b gemma2-2b step, dry run against the card: "
        + json.dumps(out, sort_keys=True))
    if gap > DRYRUN_FLOP_TOL:
        raise SmokeFailure(f"19b: the dry run counts {counts['flops']:.6e} "
                           f"FLOPs, the card's step {card['flops']:.6e} "
                           f"({gap:.4f} apart, want {DRYRUN_FLOP_TOL})")
    if bound_ms > p50_ms:
        raise SmokeFailure(f"19b: the roofline bound {bound_ms:.3f} ms "
                           f"passes the measured p50 {p50_ms:.3f} ms")
    return out


def kernels_line(errs, launches, timing) -> dict:
    """One entry per kernel at the first served net's shapes: the fused
    group of one request, and the per-layer rung of one degraded request
    (its layers' times summed)."""
    first = SERVED[0]
    fused = next(r for r in timing["rows"]["fused_mlp_q8"]
                 if r["shape"].startswith(first + " "))
    layers = [r for r in timing["rows"]["gemm_int8"]
              if r["shape"].startswith(first + ".")]
    per_layer = {key: sum(r[key] for r in layers)
                 for key in ("ms", "eager_ms", "plain_ms", "library_ms")}
    per_layer.update(bound(sum(r["bytes"] for r in layers),
                           sum(r["ops"] for r in layers)))
    per_layer["shape"] = (f"{first} per-layer rung, {len(layers)} launches: "
                          + ", ".join(r["shape"].split(" ", 1)[1]
                                      for r in layers))
    entries = []
    for name, row, n_launch in (("fused_mlp_q8", fused, 1),
                                ("gemm_int8", per_layer, len(layers))):
        entries.append({
            "name": name, **KERNEL_META[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "eager_ms": row["eager_ms"],
            "launch_floor_ms": n_launch * timing["empty_graph_ms"],
            "shape": row["shape"]})
    return {"kernels": entries}


def lm_kernel_entries(errs, launches_by_path, per_step, per_tick,
                      timing, tf_per_step, whisper_per_step) -> list:
    """One entry per LM kernel: flash at the served prefill shape, the scans
    at the forward shape (their decode-tick rows beside them).
    ``launches`` sums the LM paths' counts (each model's forward, serve
    runs, prefill + decode); ``per_step`` and ``per_tick`` are the launches
    of one forward and one decode tick of the model that runs the kernel
    (Griffin's for flash; ``tf_per_step`` the transformers' and
    ``whisper_per_step`` whisper-medium's beside it).  Flash also carries
    its rows at the transformer family's and at whisper's shapes."""
    keys = ("shape", "ms", "eager_ms", "plain_ms", "library_ms",
            "sdpa_no_softcap_ms", "bound_ms", "bound_by")
    entries = []
    for name in LM_KERNELS:
        row = timing[name]
        extra = {}
        if name == "flash_attention":
            extra["library_causal_ms"] = row["library_causal_ms"]
            extra["chunk"] = {k: row["chunk"][k] for k in keys
                              if k in row["chunk"]}
            extra["launches_per_transformer_forward"] = tf_per_step
            tf_rows = row["transformer"]
            extra["transformer"] = [{k: r[k] for k in keys if k in r}
                                    for r in tf_rows["rows"]]
            extra["tile_skip"] = {label: {k: r[k] for k in keys if k in r}
                                  for label, r in
                                  tf_rows["tile_skip"].items()}
            extra["launches_per_whisper_step"] = whisper_per_step
            extra["whisper"] = [{k: r[k] for k in keys + ("library_form",)
                                 if k in r} for r in row["whisper"]]
        else:
            extra["decode_tick"] = {k: row["decode tick"][k] for k in (
                "shape", "ms", "eager_ms", "plain_ms", "bound_ms",
                "bound_by")}
            row = row["forward"]
            extra["was_ms"] = row["was_ms"]
        entries.append({
            "name": name, **KERNEL_META[name],
            "launches": sum(c[name] for c in launches_by_path.values()),
            "launches_by_path": {p: c[name]
                                 for p, c in launches_by_path.items()},
            "launches_per_forward": per_step[name],
            "launches_per_decode_tick": per_tick[name],
            "max_abs_err": errs[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "eager_ms": row["eager_ms"],
            "shape": row["shape"], **extra})
    return entries


def summary_line(characterized, served_edge, served_lm) -> dict:
    """The run's end-to-end readings in one place: the fitted constants and
    each net's planned-vs-measured ratio, the edge p50/p95 eager and
    graphed, and per LM the decode tick p50/p95, decode tok/s and device
    ops a tick, eager and graphed, and the quant8 ticks beside them."""
    lm = {}
    for arch, srv in served_lm.items():
        lm[arch] = {}
        for label, run, trace in (
                ("graphed", srv["decode_heavy"], srv["trace"]),
                ("eager", srv["decode_heavy_eager"], srv["trace_eager"])):
            lm[arch][label] = {
                "tick_p50_ms": run["decode_p50_ms"],
                "tick_p95_ms": run["decode_p95_ms"],
                "decode_tok_per_s": run["decode_tok_per_s"],
                "device_ops_per_tick": trace["device_ops_per_tick"],
                "device_busy_ms_per_tick": trace.get(
                    "device_busy_ms_per_tick"),
                "idle_share": trace.get("idle_share")}
        lm[arch]["short_graphed"] = {
            k: srv["short"][k] for k in ("decode_p50_ms", "decode_p95_ms",
                                         "decode_tok_per_s",
                                         "prefill_tok_per_s")}
        if "quant8" in srv:
            q = srv["quant8"]
            lm[arch]["quant8"] = {
                "ticks": q["ticks"], "forward": q["forward"],
                "resident_bytes": q["resident_bytes"],
                "memory_allocated": q["memory_allocated"],
                "dequant_layer": q["dequant_layer"],
                "device_busy_ms_per_tick": q["trace"].get(
                    "device_busy_ms_per_tick"),
                "idle_share": q["trace"].get("idle_share"),
                "tick_parity": q["tick_parity"]["bit_exact"]}
    return {"constants": characterized["constants"],
            "residuals": characterized["residuals"],
            "characterize_passes": characterized["passes"],
            "bench": characterized["rows"],
            "bench_stock": characterized["stock_rows"],
            "auto": characterized["auto"],
            "edge": served_edge["latency"], "lm": lm}


def edge_times_main(src: pathlib.Path) -> int:
    """``--edge-kernel-times SRC``: phase 5's rows alone (``fused_mlp_q8``
    on the five nets, ``gemm_int8`` at their layer shapes and at 256 x 1024
    x 1024) and phase 5b's ``fused_dense`` and ``edge_forward`` rows
    (without the block_n sweep), built from and run through the port under
    ``SRC``, so that
    another tree's kernels (a parent commit unpacked beside this one) are
    timed by the same code in the same call.  Prints one JSON line of the
    rows; no ``ok`` line."""
    import torch
    sys.path.insert(0, str(src))
    try:
        log(card_line())
        from repro_torch.kernels import build
        build.build_all()
        device = torch.device("cuda", torch.cuda.current_device())
        timing = timing_phase(device)
        dense = fused_dense_timing(device, timing["empty_graph_ms"],
                                   sweep=False)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log(json.dumps({"edge_kernel_times": str(src), **timing,
                    "fused_dense": dense["fused_dense"],
                    "edge_forward": dense["edge_forward"]},
                   sort_keys=True))
    log(card_line())
    return 0


def timed(walls: dict, label: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall time logged and kept in ``walls``."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    walls[label] = round(time.perf_counter() - t0, 1)
    log(f"wall {label}: {walls[label]:.1f} s")
    return out


def main(argv: list) -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: PyTorch is missing ({exc})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    src = SRC
    if argv:
        if argv[0] != "--edge-kernel-times" or len(argv) != 2:
            print("usage: chip_smoke.py [--edge-kernel-times SRC]",
                  file=sys.stderr)
            return 2
        src = pathlib.Path(argv[1]).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} is missing; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    if argv:
        return edge_times_main(src)
    sys.path.insert(0, str(SRC))
    t_all = time.perf_counter()
    walls: dict = {}
    dry_run = None
    try:
        card = card_line()
        log(card)
        from repro_torch.kernels import build
        dry_run = dryrun_start()
        t0 = time.perf_counter()
        libs = build.build_all()
        log(f"build: {time.perf_counter() - t0:.1f} s for "
            f"{sorted(build.SOURCES)}")
        for name, report in sorted(build.ptxas_report.items()):
            regs = sorted({line.split("Used ")[1].split(",")[0]
                           for line in report.splitlines()
                           if "registers" in line})
            log(f"build {name}: ptxas {regs}")
        timed(walls, "2b tensor cores", tensor_core_phase, libs)
        timed(walls, "2b ptxas", ptxas_phase)
        timed(walls, "19a dry run (joined)", dryrun_join, dry_run)
        device = torch.device("cuda", torch.cuda.current_device())
        errs = timed(walls, "2 kernels", kernel_phase, device)
        errs.update(timed(walls, "2c dense kernels", dense_kernel_phase,
                          device))
        characterized = timed(walls, "3c characterize", characterize_phase,
                              device)
        dep, launches, build_launches, served_edge = timed(
            walls, "4 serve", serve_phase)
        forward = timed(walls, "4b edge_forward", edge_forward_phase, device)
        report = timed(walls, "4c check", check_cli_phase)
        aie_plan = timed(walls, "4d aie plan", aie_plan_phase)
        timing = timed(walls, "5 timing", timing_phase, device)
        dense_timing = timed(walls, "5b dense timing", dense_timing_phase,
                             device, timing["empty_graph_ms"])
        line = kernels_line(errs, launches, timing)
        line["kernels"] += dense_kernel_entries(errs, {
            "fused_dense": {"main": build_launches["fused_dense"],
                            "Deployment.build calibration":
                                build_launches["fused_dense"],
                            "edge_forward, five nets": forward["launches"]},
            "tiled_gemm": {"main": report["launches"]["tiled_gemm"],
                           "check library self-check":
                               report["launches"]["tiled_gemm"]}},
            dense_timing)
        lm_errs = timed(walls, "6 lm kernels", lm_kernel_phase, device)
        cfg, params, tokens, fwd_launches, per_step, per_tick = timed(
            walls, "7 griffin forward", lm_forward_phase, LM_ARCH)
        fleet = timed(walls, "7b fleet", fleet_phase, cfg, params, tokens,
                      per_step, per_tick)
        guarded = timed(walls, "7c resilience", fleet_resilience_phase,
                        fleet["deployment"], cfg, params, per_tick, dep)
        fleet["launches"].update(guarded["launches"])
        fleet["fleet"]["resilience"] = guarded["readings"]
        scenarios = timed(walls, "7d scenarios", scenario_phase,
                          fleet["deployment"], cfg, params)
        fleet["launches"].update(scenarios["launches"])
        fleet["fleet"]["scenarios"] = scenarios["readings"]
        instruments = timed(walls, "7e instruments", instruments_phase, cfg,
                            params)
        fleet["launches"].update(instruments["launches"])
        fleet["fleet"]["instruments"] = instruments["readings"]
        fleet["fleet"]["edge_call_split_us"] = timed(
            walls, "7f edge call split", edge_call_split,
            {"phase 4": dep, "fleet": fleet["deployment"]})
        served = timed(walls, "8 griffin serve", lm_serve_phase, cfg, params,
                       tokens, per_step, per_tick)
        q8 = timed(walls, "8q griffin quant8", quant8_phase, cfg, params,
                   tokens, per_tick, served)
        served["launches"].update(q8["launches"])
        served["quant8"] = q8["readings"]
        timed(walls, "8b bench after profiler", bench_after_profiler, fleet)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        lm_timing = timed(walls, "9 lm timing", lm_timing_phase, device)
        lm_errs["rwkv6_scan"] = timed(walls, "10 rwkv kernels",
                                      rwkv_kernel_phase, device)
        rcfg, rparams, rtokens, r_fwd_launches, r_step, r_tick = timed(
            walls, "11 rwkv forward", lm_forward_phase, RWKV_ARCH)
        r_served = timed(walls, "12 rwkv serve", lm_serve_phase, rcfg,
                         rparams, rtokens, r_step, r_tick)
        r_q8 = timed(walls, "12q rwkv quant8", quant8_phase, rcfg, rparams,
                     rtokens, r_tick, r_served)
        r_served["launches"].update(r_q8["launches"])
        r_served["quant8"] = r_q8["readings"]
        del rparams
        gc.collect()
        torch.cuda.empty_cache()
        lm_timing["rwkv6_scan"] = timed(walls, "13 rwkv timing",
                                        rwkv_timing_phase, device)
        # Phase 4's deployment (7b's went with bench_after_profiler) makes
        # room for gemma2-27b's 54.4 GB.
        del dep
        gc.collect()
        torch.cuda.empty_cache()
        tf = timed(walls, "14 transformers", transformer_phases, device)
        moe_run = timed(walls, "15 moe", moe_phases)
        tf["launches"].update(moe_run["launches"])
        tf["per_step"].update(moe_run["per_step"])
        whisper = timed(walls, "16 whisper", whisper_phase)
        tf["launches"].update(whisper["launches"])
        t0 = time.perf_counter()
        lm_timing["flash_attention"]["transformer"] = tf_timing_phase(device)
        log(f"phase 9 transformer flash rows: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        lm_timing["flash_attention"]["whisper"] = \
            whisper_timing_phase(device)
        log(f"phase 9 whisper flash rows: {time.perf_counter() - t0:.1f} s")
        train = timed(walls, "17 training", training_phases, device)
        tf["launches"].update(train["launches"])
        md = timed(walls, "18 multi-device", multi_device_phases, device)
        dry = timed(walls, "19a dry run", dryrun_phase, dry_run)
        dry["step"] = timed(walls, "19b dry run against the card",
                            roofline_step_phase, md["dp"])
        paths = {}
        for arch, fwd, srv in ((LM_ARCH, fwd_launches, served),
                               (LM_ARCH, None, fleet),
                               (RWKV_ARCH, r_fwd_launches, r_served)):
            if fwd is not None:
                paths[f"{arch} forward"] = fwd
            paths.update({f"{arch} {p}": c
                          for p, c in srv["launches"].items()})
        paths.update(tf["launches"])
        # The edge kernels of the fleet's paths (7b, and 7c's drift replan
        # and ladder) beside phase 4's.
        for entry in line["kernels"]:
            name = entry["name"]
            fleet_n = {p: c[name] for p, c in fleet["launches"].items()
                       if c[name]}
            if name in ("fused_mlp_q8", "gemm_int8", "fused_dense") \
                    and fleet_n:
                by_path = entry.get("launches_by_path",
                                    {"serve": entry["launches"]})
                entry["launches_by_path"] = {**by_path, **fleet_n}
                entry["launches"] += sum(fleet_n.values())
        line["kernels"] += lm_kernel_entries(
            lm_errs, paths,
            {**per_step, "rwkv6_scan": r_step["rwkv6_scan"]},
            {**per_tick, "rwkv6_scan": r_tick["rwkv6_scan"]}, lm_timing,
            tf["per_step"], whisper["per_step"])
        line["kernels"].append(train_kernel_entry(train))
        line["kernels"].append(rwkv_bwd_kernel_entry(train))
        for entry in line["kernels"]:
            for path, counts in md["launches"].items():
                n = counts.get(entry["name"], 0)
                if n:
                    entry.setdefault("launches_by_path", {})[path] = n
                    entry["launches"] += n
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        if dry_run is not None:
            dryrun_stop(dry_run)
    log(f"chip_smoke: all phases in {time.perf_counter() - t_all:.1f} s")
    log("summary " + json.dumps({**summary_line(
        characterized, served_edge, {LM_ARCH: served, RWKV_ARCH: r_served,
                                     TF_ARCH: tf["served"]}),
        "transformer": {k: tf[k] for k in ("chunked", "window", "fleet",
                                            "qwen", "forward_only",
                                            "walls_s")},
        "moe": moe_run["readings"],
        "whisper": whisper["readings"],
        "training": {k: train[k] for k in ("parity", "walls_s")} | {
            "gemma2-2b": {k: v for k, v in train["gemma"].items()
                          if k != "launches"},
            "recurrentgemma-2b": {k: v for k, v in train["griffin"].items()
                                  if k != "launches"},
            "rwkv6-7b": {k: v for k, v in train["rwkv"].items()
                         if k != "launches"}},
        "multi_device": multi_device_readings(md),
        "dry_run": dry, "walls_s": walls,
        "aie_plan": {k: v for k, v in aie_plan.items() if k != "launches"},
        "fleet": {k: v for k, v in fleet["fleet"].items()
                  if k not in ("launches", "chunk_launches")}},
        sort_keys=True))
    log(json.dumps(line, sort_keys=True))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
