"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a, H100).

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device  — needs a CUDA device; prints the card's name and power limit;
             sets the two TF32 switches off (float32 stays float32).
2. build   — builds every kernel under src/repro_torch/kernels/csrc with
             nvcc; prints the build seconds and ptxas' register, shared
             memory and spill lines of the serving path's instantiations.
3. kernels — each CUDA kernel at the serving path's shapes, bfloat16 and
             float32, against its plain PyTorch version on the card
             (max|Δ| < 2e-2 bf16, < 2e-5 f32; the bf16 decode reads
             within 2^-6 of their largest output; copy_pages bit-exact,
             and lru_scan bit-exact in f32), with
             its time, the plain version's and that of one PyTorch call
             computing the same function (a yardstick only) — device time
             from torch.profiler, and CUDA-event time per call beside it —
             and the least time the card could take (bytes or operations).
             The paged decode read must equal the dense kernel over the
             gathered view bit for bit, and the bf16 (tensor-core) results
             of flash_attention and of both decode reads a second launch
             on the same inputs; the decode reads also print their split
             of S, the device ms of the split kernel and the combine
             apart, and their host ms a call; at recurrentgemma's shapes
             every split's partial must count once at its weight (q = 0,
             V marking each row's split). The chunk kernels (qwen3's
             chunk_attention and deepseek-v2's mla_chunk_attention at the
             outer and middle chunks, every query at a real position as
             the serving path sends them) are held in bf16 to 2^-6 of
             their largest output too, repeat bit for bit, and end the
             phase with a table: ms beside SDPA, plain and bound, max|Δ|,
             blocks, the key tiles skipped and walked again (counted by
             the kernels on the card, in a launch that must give the
             wrapper's bits), chunk_attention's split of the keys, and
             ptxas' lines; the outer chunks with 6 pad queries at -1 are
             held too, not timed. recurrentgemma's shapes:
             the decode reads at G 16 / dh 256 on wrapped rings of 2048
             with the window, lru_scan at (1, 2040, 4096) and (1, 1020,
             4096), with h0, at an odd shape (the edge path) and at B 4
             (more chains than SMs), launched twice and held bit for bit,
             with its plan (chain-warps, warps a block, stages, T) and host
             ms a call (no library yardstick: no single PyTorch call
             computes the recurrence). stmc_conv at the
             streaming U-Net's shapes, float32 and bfloat16 (torch.addmm as
             the yardstick), launched twice and held bit for bit, with its
             plan (blocks, cluster size, columns a block); the paged MLA
             read in bf16 prints its split of S and blocks, its split
             kernel and combine apart and its host ms a call, as the decode
             reads do. A table of the kernels this slice redesigned
             (lru_scan, copy_pages) follows the chunk table; then a whole
             COW flush of qwen3's serving pools (28 layers x (k, v, pos),
             4 real and 4 padding pairs a table) and an MLA flush (latent,
             rope, pos) in one copy_pages_leaves launch, held bit for bit
             leaf by leaf, timed against one launch a leaf, the indexed
             assignment a leaf and the bytes' bound (device ms with the
             kernel and the table's upload apart, host ms a call); then
             stmc_conv in float32 at B 1 on each of the 14 convs of
             soi-unet-dns beside addmm and the bound, and their sum
             against the bound of a frame's weights. The families' shapes
             (phase 18): the decode reads, dense and paged, at
             nemotron-4-15b's G 6 and mistral-large-123b's G 12 (8 KV heads
             of 128, rings of 1024) and h2o-danube-1.8b's G 4 at dh 80 on
             wrapped 4096-row rings with its window, and chunk_attention at
             danube's chunk (dh 80, Sk 4352, window 4096), held as the
             others (paged bit for bit dense, every split counted once)
             and tabled with ptxas' lines. Every device-ms reading of this
             phase sits between MARKERS spin kernels a side, the kernel's
             held to its device kernels once a call; each kernel row also
             keeps the reading taken the parent's way (no markers) as
             ms_unmarked.
4. parity  — full-width qwen3-1.7b cut to 4 layers (SOI over layers 1..3),
             float32, pp and fp: the port's SOIEngine with 3 slots (prompts
             of 200 and 201 tokens, a third of 150 after 3 steps), 8 greedy
             steps on the card and on the CPU: logits within 1e-3, tokens
             identical. Then, in pp, a paged chunked prefix-cache engine
             (page 16, chunk 64, max_len 256): 3 prompts of ~200 tokens
             sharing their first 128, 66 greedy steps, so every ring wraps
             onto shared pages and copies them on write — tokens identical,
             logits within 1e-3, prefix-cache counters equal, COW on the
             card through copy_pages: one launch a flush, held to the
             engine's count of flushes (equal on the card and the CPU).
5. serve   — the serving driver on full-width qwen3-1.7b, SOI pp, 4
             requests of 1024..1018 tokens, 64 generated each, dense rings
             and bucketed prefill; every kernel launch is counted and held
             to the count the host clocks give. A second, profiled run
             (the serve loop alone, weights built outside it) gives the
             prefill window's device busy time, idle share and
             flash_attention time, and the decode loop's busy time and
             idle share, each with its kernel time by name.
6. paged   — the same traffic with a shared 768-token prefix through
             --paged --chunk-size 256 --prefix-cache: prefix-cache counters
             and chunk/paged-decode launch counts held to their expected
             values (copy_pages to the engine's COW flushes), tokens
             identical to the same command without the
             prefix cache, then a profiled rerun as in phase 5 (the
             prefill window and chunk_attention's device ms a request in
             it, the decode loop).
7. ds-parity — full-width deepseek-v2 cut to 2 layers (dense layer 0
             before the SOI middle, one MoE layer of 160 experts as the
             middle), float32, SOI pp: dense and paged engines with 3 slots
             (prompts of 41 and 43 tokens, a third of 37 after 3 steps), 8
             greedy steps on the card and on the CPU (the CPU's dense run
             is the reference of both card runs: its paged run is the same
             bit for bit; phases 10, 18 and 19 do the same): logits within
             1e-3, tokens identical; the card's paged run goes through
             paged_mla_decode_attention, its prefills through the d_qk 192 /
             d_v 128 flash_attention.
8. ds-serve — the serving driver on full-width deepseek-v2 cut to 4 layers
             (1 dense + 3 MoE), bfloat16, SOI pp, 4 requests of
             1024..1018 tokens, 64 generated each, --paged --page-size 16,
             exact-length prefill: flash_attention and
             paged_mla_decode_attention launches held to 16 and 192; step
             time at SOI phase 0 against off-phase steps (host clock after
             a synchronize); a profiled rerun for the prefill window (busy
             time, idle share, flash_attention time) and the decode
             loop's idle share and paged MLA read's device ms a step
             (split kernel and combine apart).
9. mla     — deepseek-v2's layer-0 block (MLA + SwiGLU 12288) at full
             width, SOI pp. Card against CPU in float32 (2 layers): a
             paged, chunked prefix-cache engine whose rings wrap onto
             shared pages and copy the MLA pools on write — tokens
             identical, logits within 1e-3, counters equal, copy_pages
             launched once a COW flush. Then the serve
             traffic of phase 6 through 4 bfloat16 layers: mla_chunk
             attention launches held to 28 (4 layers x 7 computed chunks),
             prefix-cache counters, warm against cold bit for bit, and a
             profiled rerun (the prefill window with mla_chunk_attention's
             device ms a request, the decode loop).
10. rg-parity — full-width recurrentgemma-9b cut to 9 layers (SOI pre
             0..2, middle 3..5, post 6..8: one (RG-LRU, RG-LRU, windowed
             MQA) pattern each; 6 RG-LRU and 3 MQA layers), float32, pp
             and fp, dense and paged (page 16): 3 slots (prompts of 41 and
             43 tokens, a third of 37 after 3 steps), 8 greedy steps on the
             card and on the CPU (the CPU's dense run is the reference of
             both card runs, as in phase 7): logits within 1e-3,
             tokens identical; lru_scan launched 6 times a prefill, the
             decode reads at the count the host clocks give.
11. rg-serve — the serving driver on full-depth recurrentgemma-9b (38
             layers), bfloat16, SOI pp, 4 requests of 2040..2034 tokens, 64
             generated each, so every outer ring (window 2048) wraps: dense,
             then --paged --page-size 16, exact-length prefill; lru_scan
             held to 104 launches, decode_attention / paged_decode_attention
             to 576, flash_attention to 0; tokens identical between the
             layouts; step time at SOI phase 0 against off-phase steps; a
             profiled rerun of each layout, with the prefill window's busy
             time, idle share and lru_scan's device ms a request, and the
             decode reads' device ms a step (split kernel and combine
             apart).
12. unet-parity — the paper's streaming U-Net, full-width soi-unet-dns
             (7 + 7 causal convs, K 3, 128 channels in and out, widths 616..
             1296), float32, B 2, 48 frames, for the 11 SOI configurations of
             tests/test_soi_unet.py: the stream on the card against the
             stream on the CPU and against apply_offline on the card
             (max|Δ| < 1e-4 each); stmc_conv launched exactly as often as
             the phase plans compute convs.
13. unet-stream — the same model, 512 frames (8.2 s of audio at 62.5 fps),
             at B 1 (one live stream) and B 32 (a server of many streams),
             for the STMC baseline, PP S-CC (3,), PP 2xS-CC (1,3) and FP
             SS-CC (3,): stmc_conv launches held to the phase plans (7168 /
             4608 / 2304 / 4608); median step time per phase (host clock
             after a synchronize), frames/s, the real-time factor against
             16 ms a frame, the MAC retain beside the measured step-time
             ratio to the baseline, peak device memory, and from a profiled
             rerun the idle share, kernel time by name and stmc_conv's
             device ms a frame.
14. graphs  — the captured step graphs (``engine.contracts.CheckedGraph``:
             on the card ``SOIEngine.generate`` replays one CUDA graph per
             SOI branch, ``unet_stream_session`` one per phase, as in phases
             4-13) against the eager steps, bit for bit: the graphed engine
             against an eager twin (a deep copy of the engine and its state,
             whose step runs ``generate_step`` eagerly) — tokens and logits
             every step, every leaf of the decode state at the end — for
             qwen3 at 4 layers in f32 (pp and fp dense; pp paged with
             chunked prefill and the prefix cache, 60 steps, so COW flushes
             run between replays), deepseek-v2 at 2 layers (bf16, paged) and
             recurrentgemma-9b at 12 (bf16, dense and paged); 2 captures an
             engine, none in steady state; a rebound >= 16 KiB state leaf
             raises DroppedDonationError and another params object
             ValueError before a replay. The U-Net session against the eager
             steppers at B 1 and B 32 for phase 13's configs, every frame
             and the final state bit for bit, stmc_conv launched as planned.
             Timing, graphed against eager from one state in the same
             process: full-width qwen3-1.7b at phase 5's traffic (64 steps
             each, interleaved: median step, with and without the middle;
             a profiled window of 16 steps: busy ms a step, idle share,
             device kernels a step, the decode reads on the device equal
             to the replays' count), and soi-unet-dns at B 1 and B 32, STMC
             baseline and PP S-CC (3,) (192 frames each: median step per
             phase, real-time factor, step ratio beside the MAC retain; 64
             profiled frames: busy, idle share, stmc_conv kernels on the
             device equal to the count); each graph's capture time, pool
             bytes and copy-back bytes.
15. spec    — self-speculative windows (``SOIEngine(speculate=4)``: K-1
             draft steps, the restore of the rows they wrote and K verify
             steps, one CUDA graph a window key). (a) qwen3 at 4 layers,
             f32, dense and paged with the prefix cache: a rejection forced
             at every depth n through ``verify_commit`` on the card and on
             the CPU — committed tokens equal, logits within 1e-3, the
             card's state bit for bit that of n sequential card steps (the
             null page aside). (b) full-width qwen3-1.7b bf16 through
             launch/serve.py at phase 5's traffic with --speculate 4, then at
             phase 6's (paged, prefix cache) with --mixed-spec: tokens equal
             to phases 5 and 6 (or the first differing slot and step is
             named), decode-read launches equal to the windows' plans
             ((K-1)*14 + sum_j (14 + 14*mid_j) a window), copy_pages to the
             COW flushes, captures equal to the window keys; windows, tokens
             a window, accept rate, pool bytes, the draft's gathered bytes
             a window; then windows and plain graphed steps in turn from one
             prompt set (median ms, host clock after a synchronize; tokens/s
             of each) and a profiled stretch of windows (busy, idle share,
             device kernels, the decode reads on the device == counted).
16. obs     — the observability layer (``repro_torch.obs``) on full-width
             qwen3-1.7b bf16, SOI pp. (a) phase 5's traffic (dense, 64
             steps) through an engine with telemetry and one without, in
             one process: tokens equal, every drained metrics vector equal
             to the one the host computes from its clocks (mid_fired == the
             host's branch), one drain a step either way, the same captures
             and launches a replay; device kernels a step from a profiled
             window: off == phase 14's count (PERF.md records 2229), on adds
             the vector's (at most 8); median step with and without telemetry
             from 12 interleaved pairs of 8 drained steps, the least per-pair
             on/off ratio within the reference's 1.05. (b) ``run_load`` of
             ``make_trace(24, ...)`` (4 tenants, Zipf 1.1, 768-token tenant
             prefixes, suffixes 16..256, 16..64 generated, bursts at 4 Hz of
             mean 2) through a paged prefix-cache engine (4 slots, page 16,
             chunk 256, max_len 1152, telemetry), first-come then
             phase-aligned: every request completes, the cache hits,
             chunk_attention / paged_decode_attention / copy_pages launched
             as the spans and the engine's counters give them; TTFT, TPOT and
             queue-wait p50/p99, tok/s, hit rate, deferrals, off-phase rate by
             occupancy and coherence; the Chrome trace and metrics JSON
             written and read back. (c) phase 15's dense traffic with
             --speculate 4 --trace-out --metrics-out through launch/serve.py:
             phase 5's tokens, one accepted-count sample a slot a drained
             window. (d) the U-Net session (B 1, STMC baseline, 192 frames)
             with a registry: 192 pushes counted, frames bit for bit those
             without, the push dispatch latency.
17. train   — training on the card (every number beside the card's name
             and power limit). (a) flash attention's gradient: the
             forward's lse and output, then flash_attention_bwd against the
             plain ref.flash_attention_bwd on the card at qwen3's training
             shape (8, 128, 16/8, 128), the SOI middle's (8, 64), the
             prefill bucket's (1, 1024) and Qwen3's pretraining length
             (1, 4096), f32 and bf16 (dq, dk, dv within 2e-5 / 2e-2 of
             each one's largest |value|), launched twice and held bit for
             bit; its device ms in bf16 at the training shape, the prefill
             bucket and the pretraining length (each profiled run between
             ~6 ms of spin kernels a side: so late in the run the profiler
             drops a session's first records), with its dK/dV and dQ kernels
             apart and the useful TFLOP/s, beside the plain
             version, SDPA's backward (K/V repeated, backward only) and
             the bound; at the training shape the forward without and with
             its lse, three pairs in turns, beside the plain forward, SDPA's
             forward and its bound. (b) one make_train_step of full-width qwen3
             cut to 4 layers (SOI pp), f32, through the kernels and with
             attention on the plain version: loss and every gradient within
             1e-4, every update within 1e-4 where AdamW is well conditioned
             (gradients >= 1e-3 of their leaf's largest); a bf16 step
             finite. (c) launch.train.main on qwen3-1.7b at full width and
             depth, bf16 over f32 masters, B 8, S 128, 20 steps, without
             SOI and with pp: finite losses whose last 5 average below the
             first, 56 flash_attention and 28 flash_attention_bwd launches
             a step (remat, the default: the backward recomputes each
             layer's forward), peak memory; then on a fresh state the
             median step, tokens/s, a profiled window of 3 steps (busy,
             busy share), and the model-FLOPs share of 989 TFLOP/s. (d) TrainSupervisor at
             smoke width, f32: a crash at step 7 of 12 with checkpoints
             every 3 ends within 1e-6 of an uninterrupted run. (e)
             soi-unet-dns at full width, 20 steps each (STMC baseline, PP
             S-CC (3,); speech_mixture B 8, T 64, 128 bins; the example's
             loss and optimizer): finite, falling losses; the trained
             weights streamed through stmc_conv equal apply_offline within
             1e-4; SI-SNRi and MAC retain printed.
18. families — olmoe-1b-7b, h2o-danube-1.8b, nemotron-4-15b and
             mistral-large-123b. (a) Card vs CPU: each at full width cut to
             4 layers (SOI over 1..3; nemotron and mistral to 2, SOI over
             1..2), float32, pp, 3 slots (prompts of 41
             and 43 tokens, a third of 37 after 3 steps), 8 greedy steps,
             dense and paged (page 16): tokens identical, logits within
             1e-3, launches as the host clocks give them (the f32 decode
             bodies at G 6, G 12 and dh 80); the host's peak RSS. (b)
             Serving: the serving driver at full width in bf16, SOI pp, 4
             requests of 1024..1018 tokens, 64 generated, dense rings,
             bucketed prefill, graphed steps — olmoe 16 layers, danube 24,
             nemotron 32, mistral 16 of 88 (245 GB at full depth) — every
             launch held to the host clocks' count (danube's windowed
             prefill takes the plain path: no flash launch); tok/s, the
             median step with and without the middle beside the weights a
             step reads and their floor at 3.35 TB/s, and busy, idle share
             and kernels a step from 16 graphed steps between markers. (c)
             danube paged (page 16), chunked (256), with the prefix cache:
             prompts of 4090, 4200 and 4198 tokens sharing their first
             1024, so the window-4096 rings wrap onto shared pages and copy
             them on write — tokens equal to the same chunks on dense
             rings, 2 hits, COW flushes == copy_pages launches.
19. zoo     — rwkv6-1.6b, paligemma-3b and whisper-tiny, lm_stream_session
             and GhostNet. (a) Card vs CPU in float32: rwkv6 cut to 4 layers
             (SOI pp, dense; the paged engine refused as in the reference:
             no attention cache to page), paligemma cut to 4 layers and
             whisper whole (4 + 4 layers, 1500 frames from the seed a
             request; its encoder output held within 1e-4), dense and
             paged (page 16): 3 slots (prompts of 41
             and 43 tokens, a third of 37 after 3 steps), 8 greedy steps,
             tokens identical, logits within 1e-3, launches as the host
             clocks give them; paligemma also through prefill(prefix_embeds=)
             with 256 patch embeddings, then 8 decode steps. (b) Serving
             at full width and depth in bf16, graphed steps, B 4, 64
             generated: rwkv6 (24 layers, SOI pp) and paligemma (18, no
             SOI) on phase 5's prompts through the serving driver's loop,
             whisper on prompts of 64..58 tokens after 1500 frames; every
             launch held to the host clocks' count (rwkv launches none,
             paligemma's prefix-LM prefill takes the plain path); tok/s,
             the median step (rwkv: with and without the middle) beside the
             weights a step reads and their floor at 3.35 TB/s, busy, idle
             share and kernels a step from 16 graphed steps between
             markers; paligemma then prefills one batch behind 256 patch
             embeddings (1280 rows, the plain path: its ms) and takes 64
             decode steps. (c) lm_stream_session on full-width qwen3-1.7b
             (bf16, SOI pp, B 4, a 1024-token prompt): 64 greedy pushes,
             graph replays, equal bit for bit to generate_step driven by
             hand, eagerly, from the same prefill; ms a push. (d) GhostNet
             sizes I..VII, B 32 x 1000 frames, with SOI (pair 4) and
             without: card against CPU in float32 within 1e-4, ms a batch
             beside the MAC retain. (e) is in phase 3: whisper's
             non-causal flash (encoder Sk 1500, cross prefill Sq 64 / Sk
             1500), its cross read (S 1500, query at 1 << 30) and self
             read (G 1, dh 64), and paligemma's G 8 / dh 256 reads, dense
             and paged (whisper's self read paged too).
20. analysis — (a) ``repro_torch.analysis.analyze()`` on the card over
             the six GQA smoke cells (the MLA smoke's head dims are no
             kernel instantiation) with all five passes: a finding outside
             analysis_baseline_torch.json fails; it prints how many cost
             metrics equal the CPU's cost_baseline_torch.json. (b)
             qwen3-1.7b at full width (bf16, SOI pp, B 4), phase 5's dense
             and phase 6's paged engine: each generate branch metered
             eagerly on the card (FLOPs, bytes, peak memory), equal bit
             for bit to the CPU's FakeTensorMode count; every kernel
             launch of the metered steps priced (launch counts == the
             meter's priced calls); COST001 (off-phase gap >= the middle
             trunk's floor) and COST002 (paged / dense bytes <= 1.25). (c)
             the H100 plan of each (roofline ms a branch, tok/s, cache
             bytes a slot, max slots) beside the graphed step timed as
             phase 14 times it (and phase 14's dense medians), and
             init_decode_state's allocation beside the state's leaves
             rounded to the allocator's 512-byte blocks; the card's name
             and power limit on each line.
21. dist     — the distributed layer over NCCL, a world of one rank (one
             card cannot hold two ranks of a communicator; the multi-rank
             semantics are held on gloo ranks in the CPU tests). (a) a
             process group (HashStore, rank 0 of 1, bound to the card) and
             a (1, 1) ("data", "model") mesh of launch.mesh.make_mesh. (b)
             compressed_psum on CUDA tensors bit for bit its numpy replay;
             moe_all_to_all and a one-stage pipeline_apply bit for bit
             their input and the sequential stack. (c) qwen3-1.7b at full
             width and depth, SOI pp, bf16 over float32 masters, phase
             17's batch: 3 steps of the plain step, then (its per-leaf
             digests kept, the rest freed) 3 of the sharded
             make_train_step on the mesh — loss and grad norm each step,
             every param and moment after, bit for bit; both steps'
             median ms (host clock after a synchronize) and peak memory;
             flash_attention / flash_attention_bwd launches of the sharded
             run; a profiled sharded step between markers: NCCL kernels
             and flash forward and backward kernels a step. The process
             group is destroyed after (c). (d) the dry run, --all --mesh
             both, as a table of GB a device against the H100's 80 GiB
             less the planner's reserve (no device needed).
22. train-families — training of the MoE, MLA, RG-LRU and windowed
             stacks (every number beside the card's name and power
             limit). (a) flash_attention_bwd at deepseek-v2's MLA dims
             (d_qk 192, d_v 128, 128 heads) at (8, 128) and (1, 1024),
             f32 and bf16, against the plain version (2e-5 / 2e-2 of each
             gradient's largest), launched twice and held bit for bit, the
             forward's lse and output held too; its bf16 device ms beside
             the plain version, SDPA's backward (E_v != E) and the bound,
             dK/dV and dQ apart. lru_scan_bwd at recurrentgemma's training
             shape (8, 128, 4096), its outer prefill (1, 2040, 4096, with
             h0) and the edge path (3, 37, 100): bit for bit the plain
             ref.lru_scan_bwd on the card, run to run; device ms beside
             the plain version and the bound. (b) olmoe-1b-7b, deepseek-v2's
             MLA stack and recurrentgemma-9b at full width cut to 4 layers,
             f32, SOI pp: one loss and its gradients, then one
             make_train_step step, through the kernels and with attention
             and the scan on their plain versions: loss, aux, every
             gradient and the step's metrics within 1e-4; the kernels'
             launches a loss exact. (c) make_train_step, as
             launch.train.main builds it, at full width, bf16 over f32
             masters, SOI pp, B 8 S 128, 5 steps each: olmoe-1b-7b (6 of
             16 layers), deepseek-v2's MLA stack (mla_dense_config, 4
             layers), recurrentgemma-9b (6 of 38) and h2o-danube-1.8b
             (24): every loss finite, launches exact (flash_attention_bwd
             one an attention layer a step and flash_attention two, the
             backward's recompute of the layer's remat group the second:
             olmoe 12 / 6, MLA 8 / 4, the windowed stacks 0; lru_scan two
             and lru_scan_bwd one an RG-LRU layer: 8 / 4), peak under 80
             GiB; step median and
             tokens/s, and 2 more steps profiled between markers (busy
             share, kernels a step).
23. train-zoo — training of the encoder-decoder, prefix-LM, RWKV and
             LayerNorm / plain-MLP stacks (every number beside the card's
             name and power limit). (a) flash_attention_bwd at whisper-tiny's
             encoder (8, 1500, 6/6, 64, non-causal: a ragged last key
             tile), its cross layers (8, 128 queries / 1500 keys,
             non-causal) and decoder self attention (8, 128, 6/6, 64) and
             nemotron-4-15b's G 6 (2, 128, 48/8, 128), f32 and bf16, against
             the plain version, launched twice and held bit for bit, the
             forward's lse and output held too; its bf16 device ms beside
             the plain version, SDPA's backward and the bound. (b) card
             against CPU in float32, one loss and every gradient within
             1e-4: whisper-tiny whole (B 4, random frames), paligemma-3b cut
             to 2 layers (B 4, 256 random patch embeddings), rwkv6-1.6b cut
             to 4 (SOI pp) and nemotron-4-15b cut to 2 (B 2, 3.93 B
             parameters); flash_attention_bwd launches a loss exact
             (whisper 12, nemotron 2; flash_attention twice as many, remat).
             (c) make_train_step as launch.train.main builds it, the stub
             frontends fed as it feeds them, bf16 over f32
             masters, B 8 S 128, 5 steps each: whisper-tiny (4 + 4 layers,
             1500 frames; flash_attention 24 and its backward 12 a step),
             paligemma-3b (18 layers, no SOI, 256 patch embeddings; peak
             under 72 GiB) and rwkv6-1.6b (24 layers, SOI pp): every loss
             finite, launches exact; step median, tokens/s, peak, busy
             share and kernels a step as phase 22 (c). nemotron's bf16 step
             needs more than one card: (b) is its check on the card.
24. serve-mesh — tensor-parallel serving (``launch.steps.make_prefill``
             and ``make_serve_step`` on a mesh, the KV sequence over the
             model axis; every number beside the card's name and power
             limit). (a) decode_attention's return_lse at two shards of
             qwen3-1.7b's outer ring (4, 544, 8, 128), bf16 and f32: out
             and lse against the plain version's (lse within 2e-2 bf16,
             1e-4 f32), a shard that sees no row of a slot (out 0, lse
             -inf), the shards merged in rank order (ref.merge_partials)
             against the whole read, the read without lse unchanged bit for
             bit; the bf16 shard's device ms with and without lse, three
             pairs in turns between markers, beside the plain version, SDPA
             and the bound. (b) phase 5's weights and prompts (qwen3-1.7b,
             28 layers, bf16, SOI pp, B 4 x 1024, clocks staggered by one a
             slot, max_len 1088): the plain prefill and 32 greedy steps,
             then the same model sharded on a (1, 1) NCCL mesh through the
             sharded steps — logits of every step and the final state bit
             for bit; launches (flash_attention 28, decode_attention 28 a
             step); ms a step and collectives a step of each. (c) two gloo
             processes sharing the card, a (1, 2) mesh: full-width qwen3-1.7b
             cut to 4 layers (SOI pp 1..3), float32, 8 steps — every ring
             split 544 + 544 rows, each read with its lse and merged —
             tokens equal to the one-rank steps' and logits within 1e-3;
             each rank's launches, ms a step and collectives a step.
25. moe-mesh — expert parallelism (the MoE stacks through the sharded
             steps: the router's columns and the experts over the model
             axis, the dispatch groups the global batch's, the aux loss
             over it; every number beside the card's name and power
             limit). (a) phase 18's olmoe-1b-7b weights and prompts (16
             layers, bf16, SOI pp, B 4 x 1024, clocks staggered, max_len
             1088) through the plain prefill + 32 greedy steps, then
             sharded on a (1, 1) NCCL mesh: logits and state bit for bit;
             launches (flash_attention 16, decode_attention 16 a step); ms
             a step and collectives a step of each. (b) olmoe-1b-7b cut to
             6 of 16 layers (phase 22's cut: 80 GB at 18 bytes a parameter),
             bf16 over f32 masters, B 8 S 128, 3 steps plain then 3 sharded
             on the (1, 1) mesh from the same weights: loss, aux and grad
             norm equal, params and moments equal by per-leaf digests;
             flash_attention 12 and its backward 6 a step; ms a step, peak and
             collectives a step of each. (c) two gloo processes sharing the
             card, a (1, 2) mesh, each holding 32 of the 64 experts (and
             half the heads and vocabulary): olmoe cut to 4 layers (SOI pp
             1..3), float32, 8 steps — tokens equal to the one-rank steps'
             and logits within 1e-3 — and cut to 2 (SOI pp 1..2), one train
             step against the plain step in the same process: loss and aux
             within 1e-5, grad norm and the gradients (AdamW's first moment
             after one step, 0.1 x the clipped gradient) within 1e-4 of each
             leaf's largest; each rank's parameter bytes equal to the specs'
             (the dry run's count), launches, ms a step and collectives.
             (b) also holds the first sharded step's peak and
             prints what ``shard_params`` leaves allocated beyond the
             built model; every (1, 1) comparison takes its collectives
             from one more step after the compared ones.
26. mla-rglru-mesh — the MLA and RG-LRU stacks through the sharded steps
             (heads and MLA's latent up-projections, the RG-LRU's channels
             over the model axis; MQA's one KV head replicated beside the
             split query heads; every number beside the card's name and
             power limit). (a) phase 8's deepseek-v2 (4 layers: the dense
             one and three MoE, bf16, SOI pp, dense rings) and (b)
             recurrentgemma-9b (all 38 layers, bf16, SOI pp), each through
             the plain prefill + 32 greedy steps and sharded on a (1, 1)
             NCCL mesh, as phase 24 (b): logits and state bit for bit;
             launches (a) flash_attention 4 at (192, 128); (b) lru_scan 26,
             decode_attention 12 a step). (c) deepseek-v2's MLA stack
             (mla_dense_config, 4 layers) and recurrentgemma-9b cut to 6 of
             38 layers, bf16 over f32 masters, B 8 S 128, 3 steps plain then
             3 sharded on the (1, 1) mesh, as phase 25 (b), bit for bit;
             the first sharded step's peak within 2 GiB of the plain one's.
             (d) two gloo processes sharing the card, a (1, 2) mesh,
             float32: deepseek-v2 at 2 layers (64 of 128 heads, 80 of 160
             experts a rank) and recurrentgemma-9b at 3 (8 of 16 heads, its
             one KV head on both, 2048 of 4096 LRU channels) through the
             sharded prefill + 8 steps — tokens equal to the one-rank
             steps', logits within 1e-3 — then one train step each
             (deepseek-v2's dense first layer alone, recurrentgemma at the
             same 3) against the plain step in the same process: loss
             within 1e-6, grad norm and gradients within 1e-5; bytes,
             launches, ms a step and collectives.
27. fsdp-sp-mesh — fsdp (every "embed" dimension over the data axes, the
             leaf gathered for the step) and seq_shard (Megatron sequence
             parallelism) through the sharded steps; every number beside
             the card's name and power limit. (a) phase 26's (a), (b) and
             (c) with ShardingRules(fsdp=True, seq_shard=True) on the (1,
             1) NCCL mesh, 8 serve steps: bit for bit the plain steps. (b)
             runs in phase 29 (d). (c) two gloo processes
             sharing the card on a (1, 2) mesh with
             seq_shard: recurrentgemma-9b at 3 layers, float32, prefill B 4
             x 1024 + 2 steps — tokens equal to one rank's, logits within
             1e-3 — and one train step: loss within 1e-6 and grad norm
             within 2e-5 of one rank's; reduce-scatters counted (> 0).
28. families-mesh — RWKV, the encoder-decoder and the prefix-LM through
             the sharded steps; every number beside the card's name and
             power limit. (0) the kernels at the shapes these paths give
             them, against their plain versions in f32 and bf16:
             decode_attention's return_lse on the two halves of whisper's
             cross K/V (4, 1500, 6, 64) and of paligemma's ring (4, 512, 1,
             256, G 8), merged in rank order against the whole read;
             flash_attention and its backward on 3 of whisper's 6 heads
             (encoder 1500 x 1500, cross 128 x 1500, self 128 causal) at
             B 8, the bf16 backward timed beside SDPA's. (a) whisper-tiny whole (4 + 4 layers, 51865-row vocab,
             1500 frames), paligemma-3b (18 layers, 256 random patch
             embeddings) and rwkv6-1.6b (24, SOI pp) in bf16 through the
             plain prefill + 8 steps and the same sharded on a (1, 1) NCCL
             mesh: logits and state bit for bit; then each trained (bf16
             over f32 masters, B 8 S 128; paligemma at 4 layers, rwkv6 at
             6) 3 steps plain and 3 sharded, as phase 25 (b), bit for bit;
             launches held. (b) two gloo processes sharing the card, a (1,
             2) mesh, float32: whisper-tiny whole (3 of 6 heads, its vocab
             whole, 750 of 1500 frames' cross K/V a rank), paligemma-3b at
             2 layers and rwkv6-1.6b at 4 (SOI pp; 16 of 32 heads) through
             the sharded prefill + 4 steps — tokens equal to one rank's,
             logits within 1e-3, the split state leaves half the specs'
             whole — and one train step each against the plain step in the
             same process: loss within 1e-5, grad norm and first moments
             within 1e-4 (rwkv6's gradients, behind its clamps, each leaf
             no further off a float64 run than 10x one process's); bytes
             the specs', launches held.
29. remat — the reference's per-layer rematerialisation in the train
             steps (``cfg.remat``, ``remat_policy``; every number beside
             the card's name and power limit). (a) qwen3-1.7b at full
             width and depth, bf16 over f32 masters, SOI pp, B 2 x S 4096,
             two make_train_step steps from the same weights with remat
             on ("full") and off: the second step's loss, grad norm and
             every master and moment after it bit for bit (by digest);
             each one's step ms, tokens/s, peak GiB and launches
             (flash_attention 56 with remat, 28 without; its backward 28).
             (b) the same with remat at B 8 x S 4096, the reference's
             train_4k length: step ms, tokens/s, peak GiB (remat off is
             not run: its activations alone pass the card). (c) "dots"
             and "names" at (a)'s shape, bit for bit (a), each peak. (d)
             two gloo processes sharing the card, a (2, 1) mesh with fsdp,
             qwen3-1.7b at full width cut to 8 of 28 layers, SOI pp,
             float32, one train step on each rank's half of B 8 S 128,
             with remat off and on: loss within 1e-5 and grad norm within
             1e-4 of one process's step on the whole batch; parameter
             bytes the specs'; each rank's peak beside 9.19 GiB (the step
             holding the whole gathered model, PERF.md), and its peak up
             to the update (where gathered leaves live); the all-gathers
             a step counted: each data-split leaf outside the blocks once,
             a block's inside its layer group, twice with remat (the
             backward's recompute gathers it again).
30. the kernels JSON line (the decode reads and copy_pages also give their
             phase-15 launches under "spec"; the kernels phase 16 launches
             their launches there under "obs"; flash_attention and
             flash_attention_bwd phase 17's under "train" and phase 21's
             sharded step's under "dist", with lru_scan and
             lru_scan_bwd phase 22's under "train_families" (the
             backward's MLA rows under "mla") and phase 23's under
             "train_zoo" (the backward's new shapes, with their launches
             on phase 23, under "train_zoo_shapes"); the decode
             reads and chunk_attention the families' shapes with their
             phase-18 launches under "families"; flash_attention and the
             decode reads the zoo's shapes with their phase-19 launches
             under "zoo"; decode_attention and flash_attention phase 24
             (b)'s launches under "serve_mesh", and decode_attention's
             return_lse (a)'s reading with (c)'s launches under "lse";
             decode_attention, flash_attention and flash_attention_bwd
             phase 25's sharded olmoe runs' launches under "moe_mesh";
             decode_attention, flash_attention, flash_attention_bwd,
             lru_scan and lru_scan_bwd phase 26's under "mla_rglru_mesh"
             and phase 27's under "fsdp_sp_mesh"; decode_attention,
             flash_attention and flash_attention_bwd phase 28's launches
             and (0)'s shapes under "families_mesh", and phase 29's
             under "remat"), the card line, and last {"ok": true, ...}.

Phases 4-13, 15, 16, 18 and 19 run the engine and the U-Net session as a user does, so
on the card every generate step, window and frame after a branch's first is
a graph replay; the kernel launch counters (Python-side) get each graph's launches
added at every replay (``ops.add_launch_counts``), which is what their
checks hold. Phase 13 captures every phase before its timed frames.

Any failure raises and exits nonzero; no result line is printed then.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import re
import resource
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch.plan import H100  # noqa: E402

# the H100 SXM datasheet's figures, as the planner holds them
HBM_BYTES_PER_S = H100.hbm_bw
PEAK_FLOPS = {torch.bfloat16: H100.peak_flops,
              torch.float32: H100.peak_flops_f32}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# the decode reads in bf16: at most four half-ulps of their largest output
# (an output is a mean of V rows, at recurrentgemma's read ~0.04 RMS)
READ_REL_TOL = 2.0 ** -6
L2_BYTES = 50 * 2 ** 20

SERVE_ARGV = ["--arch", "qwen3-1.7b", "--soi", "pp", "--batch", "4",
              "--prompt-len", "1024", "--stagger", "2", "--gen-len", "64",
              "--seed", "0"]
PAGED_ARGV = SERVE_ARGV + ["--paged", "--page-size", "16", "--chunk-size",
                           "256", "--shared-prefix", "768"]


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


# the script's start on the host clock: each phase line gives the seconds
# since, so a run shows what each phase costs of the time limit
T_START = time.perf_counter()


def phase(name):
    print(f"== {name} [{time.perf_counter() - T_START:.1f} s]", flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def device_phase():
    phase("1 device")
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke.py needs "
                                     "an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; device 0 = {torch.cuda.get_device_name(0)}"
          f"; TF32 off")
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

# (label, needles) of the serving path's instantiations (head dim 128;
# decode reads at G = 2 query heads per KV head, and recurrentgemma's MQA at
# G 16 / dh 256): a compiled kernel is reported when its mangled name holds
# every needle (a mangled name carries an identifier's length before it)
PATH_KERNELS = (
    ("decode_attention", ("decode_mma_kernel", "DenseRows", "Li2ELi128E")),
    ("decode_attention", ("decode_scalar_kernel", "DenseRows",
                          "Li2ELi128E")),
    ("paged_decode_attention", ("decode_mma_kernel", "PagedRows",
                                "Li2ELi128E")),
    ("paged_decode_attention", ("decode_scalar_kernel", "PagedRows",
                                "Li2ELi128E")),
    ("decode_attention (MQA)", ("decode_mma_kernel", "DenseRows",
                                "Li16ELi256E")),
    ("decode_attention (MQA)", ("decode_scalar_kernel", "DenseRows",
                                "Li16ELi256E")),
    ("paged_decode_attention (MQA)", ("decode_mma_kernel", "PagedRows",
                                      "Li16ELi256E")),
    ("paged_decode_attention (MQA)", ("decode_scalar_kernel", "PagedRows",
                                      "Li16ELi256E")),
    ("decode reads' combine", ("decode_combine_kernel",)),
    # the families' instantiations (phase 18): G 6 and G 12 at dh 128, G 4
    # at dh 80
    *((f"{name} ({tag})", (body, rows, needle))
      for tag, needle in (("G 6", "Li6ELi128E"), ("G 12", "Li12ELi128E"),
                          ("dh 80", "Li4ELi80E"),
                          # the zoo's (phase 19): paligemma's MQA, whisper's
                          # self and cross reads
                          ("G 8 / dh 256", "Li8ELi256E"),
                          ("G 1 / dh 64", "Li1ELi64E"))
      for name, rows in (("decode_attention", "DenseRows"),
                         ("paged_decode_attention", "PagedRows"))
      for body in ("decode_mma_kernel", "decode_scalar_kernel")),
    ("chunk_attention (dh 80)", ("22chunk_attention_kernel", "Li80E")),
    ("chunk_attention's merge (dh 80)", ("20chunk_combine_kernel",
                                         "Li80E")),
    ("flash_attention", ("22flash_attention_kernel", "Li128ELi128E")),
    ("flash_attention (MLA)", ("22flash_attention_kernel", "Li192ELi128E")),
    ("flash_attention (dh 64)", ("22flash_attention_kernel", "Li64ELi64E")),
    ("chunk_attention", ("22chunk_attention_kernel", "Li128E")),
    ("chunk_attention's merge", ("20chunk_combine_kernel", "Li128E")),
    ("chunk_attention, walk counted", ("17chunk_walk_kernel", "Li128E")),
    ("copy_pages", ("17copy_pages_kernel",)),
    ("mla_chunk_attention", ("26mla_chunk_attention_kernel",
                             "Li512ELi64E")),
    ("mla_chunk_attention, walk counted", ("21mla_chunk_walk_kernel",
                                           "Li512ELi64E")),
    ("paged_mla_decode_attention", ("33paged_mla_decode_attention_kernel",
                                    "Li512ELi64E")),
    ("lru_scan (ring)", ("15lru_scan_kernel", "Lb0E")),
    ("lru_scan (edge)", ("15lru_scan_kernel", "Lb1E")),
    ("stmc_conv (B 1)", ("16stmc_conv_kernel", "Li1E")),
    ("stmc_conv (B 32 tile)", ("16stmc_conv_kernel", "Li32E")),
    # the training path (phase 17)
    ("flash_attention_bwd delta", ("12delta_kernel", "Li128E")),
    # f32: the CUDA-core body (T = float); bf16: the tensor-core body
    ("flash_attention_bwd dK/dV", ("11dkdv_kernelIf", "Li128ELi128E")),
    ("flash_attention_bwd dQ", ("9dq_kernelIf", "Li128ELi128E")),
    ("flash_attention_bwd dK/dV", ("12tensor_cores11dkdv_kernel",
                                   "ILi128ELi128E")),
    ("flash_attention_bwd dQ", ("12tensor_cores9dq_kernel",
                                "ILi128ELi128E")),
    # the families' training (phase 22): the MLA dims and the scan's
    # gradient (ring and edge paths)
    ("flash_attention_bwd dK/dV (MLA)", ("11dkdv_kernelIf", "Li192ELi128E")),
    ("flash_attention_bwd dQ (MLA)", ("9dq_kernelIf", "Li192ELi128E")),
    ("flash_attention_bwd dK/dV (MLA)", ("12tensor_cores11dkdv_kernel",
                                         "ILi192ELi128E")),
    ("flash_attention_bwd dQ (MLA)", ("12tensor_cores9dq_kernel",
                                      "ILi192ELi128E")),
    ("lru_scan_bwd (ring)", ("19lru_scan_bwd_kernel", "Lb0E")),
    ("lru_scan_bwd (edge)", ("19lru_scan_bwd_kernel", "Lb1E")),
)


def _ptxas_lines(log: str) -> list:
    """One line per compiled kernel of the serving path, from nvcc
    -Xptxas -v (a kernel compiled alike in two sources, once)."""
    out, name = [], None
    spill = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spill = (f"stack {m.group(1)} B, spill st/ld "
                     f"{m.group(2)}/{m.group(3)} B")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            for kind, needles in PATH_KERNELS:
                if all(n in name for n in needles):
                    dt = ("bf16" if "bfloat16" in name
                          or "tensor_cores" in name else
                          "bytes" if kind == "copy_pages" else "f32")
                    smem = re.search(r"(\d+) bytes smem", line)
                    text = (f"  {kind}[{dt}]: {m.group(1)} registers, "
                            f"{smem.group(1) if smem else 0} B static "
                            f"smem, {spill}")
                    if text not in out:
                        out.append(text)
            name, spill = None, ""
    return out


def build_phase():
    phase("2 build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    took = time.perf_counter() - t0
    how = (f"built in {info.seconds:.2f} s" if info.seconds is not None
           else f"reused an existing build ({took:.2f} s to load)")
    print(f"kernels: {info.path.relative_to(ROOT)} {how}")
    lines = _ptxas_lines(info.log)
    check(lines or info.seconds is None, "no ptxas lines in the build log")
    for line in lines:
        print(line)


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

def _copies(make, bytes_per_set: int):
    """Enough input sets that cycling through them exceeds the L2 cache:
    each launch finds its inputs cold, as the serving path does (every
    layer owns its caches)."""
    n = max(2, math.ceil(2 * L2_BYTES / max(bytes_per_set, 1)))
    return [make() for _ in range(min(n, 64))]


def _time_ms(fn, sets, iters: int) -> float:
    """Mean device time of ``fn(*args)`` over ``iters`` launches, cycling
    the argument sets; CUDA events after a warm-up."""
    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, sets, iters: int) -> float:
    """Host time per call of ``fn(*args)``: ``iters`` calls enqueued back to
    back after a warm-up and a synchronize, on the host clock, the
    synchronize that drains them left out (a few ms of device work: the
    launch queue never fills, so no call waits on the card)."""
    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def _split_coverage(kern, plain, args, plan, label) -> float:
    """Every split of a decode read counts once, at its weight: with q = 0
    each live key scores alike, so the read is V's mean over its live keys;
    V row s holds ``n_split`` in column ``s // keys_per_split`` (its split)
    and 0 elsewhere, so column j of the output is ``n_split`` times split
    j's share of the live keys (1 where all keys are live). A split
    dropped, counted twice or weighed wrongly moves its column by its
    whole share. Dense ``(q, k, v, pos, t)`` or paged ``(q, k_pool, v_pool,
    pos_pool, page_map, t)`` arguments; returns max|kernel - plain|."""
    n_split, keys = plan[:2]
    v = torch.zeros_like(args[2])
    check(n_split <= v.shape[-1], f"{label}: {n_split} splits > dh")
    if len(args) == 5:
        rows = torch.arange(v.shape[1], device=v.device)
        v[:, rows, :, rows // keys] = n_split
    else:
        p_sz, pmap = v.shape[1], args[4]
        rows = torch.arange(pmap.shape[1] * p_sz, device=v.device)
        pages = pmap[:, rows // p_sz].long()            # (B, S) pool pages
        v[pages, (rows % p_sz).expand_as(pages), :,
          (rows // keys).expand_as(pages)] = n_split
    case = (torch.zeros_like(args[0]), args[1], v) + tuple(args[3:])
    got = kern(*case).float()
    want = plain(*case).float()
    # the columns of the splits hold all the mass, n_split a head (float32:
    # no rounding)
    totals = plain(*(x.float() if x.is_floating_point() else x
                     for x in case))[..., :n_split].sum(-1)
    check(bool(torch.allclose(totals, torch.full_like(totals, n_split),
                              rtol=1e-5)),
          f"{label}: the coverage input does not reach every split")
    err = float((got - want).abs().max())
    tol = min(TOL[args[0].dtype], READ_REL_TOL * float(want.abs().max()))
    check(err < tol, f"{label}: split coverage max|Δ| {err} >= {tol} (a "
                     f"split's partial lost, repeated or misweighted)")
    return err


# spin kernels on each side of a profiled run read with markers (every
# _device_ms reading, _loop_profile), of MARKER_CYCLES clocks each (~0.2 ms
# on the H100): late in a long process a profiler session drops the device
# records of its first stretch of time, longer the older the process
# (~0.3 ms of backward calls by phase 17; _device_events), so each side
# spans ~6 ms, more where a session lost a side
MARKERS = 32
MARKER_CYCLES = 400_000


def _records(prof) -> list:
    """(start µs, end µs, name, device type) of every record a finished
    profiler session kept, as ``prof.events()`` gives them, read from the
    session's raw results: ``events()`` builds each record's call tree
    first, seconds a session on the host late in the script (most of the
    script's profiling time, sampled on the H100)."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    return [((e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3, e.name(),
             e.device_type()) for e in res.events()
            if not e.is_hidden_event()]


def _device_events(fn, markers: int = 0, warm=None) -> list:
    """Run ``fn`` under torch.profiler with CUDA activity only; returns the
    device intervals (start µs, end µs, name) of its kernels and copies,
    sorted by start. With ``markers``, that many spin kernels
    (``torch.cuda._sleep(MARKER_CYCLES)``) run on each side of ``fn``, each
    side synchronized (``fn`` starts on an idle card), after ``warm``
    where given (run first, synchronized and not read), and only the
    events between the last one kept before ``fn`` and the first one kept
    after it are returned: a profiler session late in a long process drops
    the device records of its first stretch of time (1 record after phase
    3, 5 after phase 6, ~23 by phase 17 on the H100;
    tools/profiler_drop_reading.py). A session that kept no marker on one
    side of ``fn``'s events is taken again with 4 and then 16 times the
    markers (the stretch lost grows with the process's profiled history:
    past ~45 ms by phase 14 after phase 3's marked readings), and a third
    such session raises."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for n in (markers, 4 * markers, 16 * markers):
        def spin():
            for _ in range(n):
                torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if warm is not None:
                warm()
                torch.cuda.synchronize()
            spin()
            fn()
            spin()
        ev = sorted((s_, e, name) for s_, e, name, where in _records(prof)
                    if where == cuda)
        if not markers or not ev:
            # a session that kept no device record at all hands back none,
            # as without markers (_device_ms profiles again, then times by
            # events)
            return ev
        # the markers' runs of consecutive events: the first after
        # ``warm``'s events is the leading one, the last the trailing one
        mark = [i for i, x in enumerate(ev) if "spin_kernel" in x[2]]
        runs = [i for i in mark if i - 1 not in mark]
        if len(runs) >= 2 and mark[-1] == len(ev) - 1:
            lead_end = next(i for i in mark
                            if i >= runs[-2] and i + 1 not in mark)
            return ev[lead_end + 1:runs[-1]]
        print(f"  (the profiler kept no marker on one side of a run: "
              f"{len(mark)} of {2 * n} kept, {len(ev)} events, the first a "
              f"marker: {bool(mark) and mark[0] == 0}; profiled again)",
              flush=True)
    check(False, f"the profiler kept no marker kernel on one side of the "
                 f"run with up to {16 * markers} a side")


def _device_ms(fn, sets, iters: int, by_name=None, bound_ms=None,
               markers: int = 0, each=()):
    """Mean device time per call (the summed durations of the call's
    kernels, host launch gaps excluded); None if the profiler saw no
    device activity. ``by_name`` (a dict) receives each kernel's mean ms
    per call. ``markers``: as ``_device_events``'s. Each name in ``each``
    must be on the device ``iters`` times, once a call. A reading under
    ``bound_ms`` (the least time the card could take) or short of
    ``each`` lost events: the run is profiled again, and a second such
    reading raises."""
    def run():
        for i in range(iters):
            fn(*sets[i % len(sets)])

    def reading(ev):
        return sum(e - s for s, e, _ in ev) / iters / 1e3 if ev else None

    def lost(ev):
        seen = {k: sum(k in name for _s, _e, name in ev) for k in each}
        short = {k: n for k, n in seen.items() if n != iters}
        if bound_ms is not None and ev and reading(ev) < bound_ms:
            short["device ms"] = reading(ev)
        return short
    # the profiler can hand back no device events for a run, or lose some
    # of them: look again
    ev = _device_events(run, markers)
    if not ev or lost(ev):
        ev = _device_events(run, markers)
        check(not ev or not lost(ev),
              f"two profiled runs lost events: {lost(ev)} (want {iters} of "
              f"each of {each}, device ms over the bound {bound_ms})")
    if not ev:
        return None
    if by_name is not None:
        for s, e, name in ev:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / iters / 1e3
    return reading(ev)


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals sorted by start."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _bound(nbytes: int, flops: float, dt) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dt]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _decode_case(b, s, hkv, g, dh, dt, t_base, dev, gen):
    """Serving-like decode inputs: slot i holds positions 0..t_i of a cache
    of s rows (the rest empty)."""
    h = hkv * g

    def make():
        q = torch.randn((b, h, dh), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(dt)
        t = torch.tensor([t_base - 2 * i for i in range(b)],
                         dtype=torch.int32, device=dev)
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].repeat(
            b, 1)
        pos = torch.where(pos <= t[:, None], pos, torch.full_like(pos, -1))
        return q, k, v, pos, t

    esz = torch.finfo(dt).bits // 8
    sets = _copies(make, 2 * b * s * hkv * dh * esz)
    q, k, v, pos, t = sets[0]
    live = int((pos >= 0).sum())
    # bytes: q and out once, positions and clocks once, the K/V rows the
    # mask keeps live once; operations: q.k and p.v over the live rows
    nbytes = (2 * b * h * dh * esz + pos.numel() * 4 + b * 4
              + 2 * live * hkv * dh * esz)
    flops = 4.0 * live * h * dh
    # the position mask as SDPA takes it, built outside the timed call
    masks = {st[3].data_ptr(): ((st[3] >= 0) & (st[3] <= st[4][:, None]))
             [:, None, None] for st in sets}

    def library(q, k, v, pos, t):
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=masks[pos.data_ptr()], enable_gqa=True)[:, :, 0]

    return sets, nbytes, flops, library, {}


def _flash_case(b, s, hkv, g, dh, dt, dev, gen, dv=None):
    h = hkv * g
    dv = dv or dh

    def make():
        return (torch.randn((b, s, h, dh), generator=gen, device=dev).to(dt),
                torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(dt),
                torch.randn((b, s, hkv, dv), generator=gen, device=dev).to(dt))

    esz = torch.finfo(dt).bits // 8
    # q read and out written once, K and V read once
    nbytes = b * s * esz * (h * dh + h * dv + hkv * (dh + dv))
    sets = _copies(make, nbytes)
    pairs = s * (s + 1) // 2                      # causal (q, k) pairs
    flops = 2.0 * b * h * (dh + dv) * pairs

    def library(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    return sets, nbytes, flops, library, {}


def _flash_nc_case(b, sq, sk, hkv, g, dh, dt, dev, gen):
    """Non-causal flash inputs (whisper's encoder, Sq == Sk, and its cross
    prefill, Sq < Sk): every (q, k) pair is live."""
    h = hkv * g

    def make():
        return (torch.randn((b, sq, h, dh), generator=gen, device=dev).to(dt),
                torch.randn((b, sk, hkv, dh), generator=gen,
                            device=dev).to(dt),
                torch.randn((b, sk, hkv, dh), generator=gen,
                            device=dev).to(dt))

    esz = torch.finfo(dt).bits // 8
    nbytes = esz * b * (2 * sq * h * dh + 2 * sk * hkv * dh)
    sets = _copies(make, nbytes)
    flops = 4.0 * b * h * dh * sq * sk

    def library(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True).transpose(1, 2)

    return sets, nbytes, flops, library, {"kw": {"causal": False}}


def _cross_case(b, s, h, dh, dt, dev, gen):
    """whisper's cross read: ``s`` encoder rows at positions 0..s-1 a slot
    (G 1), the query at 1 << 30, so every row is live."""
    def make():
        q = torch.randn((b, h, dh), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, h, dh), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, h, dh), generator=gen, device=dev).to(dt)
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].repeat(
            b, 1)
        t = torch.full((b,), 1 << 30, dtype=torch.int32, device=dev)
        return q, k, v, pos, t

    esz = torch.finfo(dt).bits // 8
    sets = _copies(make, 2 * b * s * h * dh * esz)
    nbytes = 2 * b * h * dh * esz + b * s * 4 + b * 4 + 2 * b * s * h * dh * esz
    flops = 4.0 * b * s * h * dh

    def library(q, k, v, pos, t):
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2))[:, :, 0]

    return sets, nbytes, flops, library, {}


def _chunk_case(b, c, s_cache, hkv, g, dh, dt, q0, filled, pad_rows, dev,
                gen, window=None):
    """A serving prefill chunk: ``c`` queries at q0.. (the last
    ``pad_rows`` of them pad, at position -1) against a cache whose first
    ``filled`` rows hold positions 0.. (the rest empty) plus the chunk;
    with a ``window``, a key is live for a query only within it."""

    def visible(qp, kp):
        allow = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None])
        if window is not None:
            allow &= kp[:, None, :] > qp[:, :, None] - window
        return allow

    h = hkv * g
    sk = s_cache + c

    def make():
        q = torch.randn((b, c, h, dh), generator=gen, device=dev).to(dt)
        k = torch.randn((b, sk, hkv, dh), generator=gen, device=dev).to(dt)
        v = torch.randn((b, sk, hkv, dh), generator=gen, device=dev).to(dt)
        qp = q0 + torch.arange(c, dtype=torch.int32, device=dev)
        qp[c - pad_rows:] = -1
        cache = torch.arange(s_cache, dtype=torch.int32, device=dev)
        cache = torch.where(cache < filled, cache, torch.full_like(cache, -1))
        kp = torch.cat([cache, qp])[None].repeat(b, 1)
        return q, k, v, qp[None].repeat(b, 1).contiguous(), kp

    esz = torch.finfo(dt).bits // 8
    sets = _copies(make, 2 * b * sk * hkv * dh * esz)
    q, k, v, qp, kp = sets[0]
    pairs = int(visible(qp, kp).sum())
    live_keys = int((kp >= 0).sum())
    # bytes: q and out once, the live K/V rows once, both position lanes;
    # operations: q.k and p.v over the live (query, key) pairs
    nbytes = (2 * q.numel() * esz + 2 * live_keys * hkv * dh * esz
              + (qp.numel() + kp.numel()) * 4)
    flops = 4.0 * pairs * h * dh
    masks = {st[4].data_ptr(): visible(st[3], st[4])[:, None]
             for st in sets}

    def library(q, k, v, qp, kp):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=masks[kp.data_ptr()], enable_gqa=True).transpose(1, 2)

    # SDPA leaves a query row with no live key undefined: compare live rows
    live_rows = qp[0] >= 0
    extra = {"rows": live_rows}
    if window is not None:
        extra["kw"] = {"window": window}
    return sets, nbytes, flops, library, extra


def _paged_case(b, n_pp, p_sz, hkv, g, dh, dt, t_base, dev, gen):
    """Serving-like paged decode inputs: ``b * n_pp + 1`` pool pages (page
    0 the null page, its position lane live-looking garbage), slot i
    mapping shuffled pages for its positions 0..t_i, the rest of its map
    unbacked."""
    from repro_torch.models.attention import paged_view
    h = hkv * g
    n_pages = b * n_pp + 1
    ts = [t_base - 3 * i for i in range(b)]

    def make():
        q = torch.randn((b, h, dh), generator=gen, device=dev).to(dt)
        shape = (n_pages, p_sz, hkv, dh)
        k = torch.randn(shape, generator=gen, device=dev).to(dt)
        v = torch.randn(shape, generator=gen, device=dev).to(dt)
        pos = torch.full((n_pages, p_sz), -1, dtype=torch.int32, device=dev)
        pos[0] = torch.arange(p_sz, dtype=torch.int32, device=dev)
        perm = 1 + torch.randperm(n_pages - 1, generator=gen, device=dev)
        pm = torch.zeros((b, n_pp), dtype=torch.int32, device=dev)
        used = 0
        for s_, t in enumerate(ts):
            n_live = t // p_sz + 1
            ids = perm[used:used + n_live]
            used += n_live
            pm[s_, :n_live] = ids.to(torch.int32)
            pos[ids] = torch.arange(n_live * p_sz, dtype=torch.int32,
                                    device=dev).view(n_live, p_sz)
        t = torch.tensor(ts, dtype=torch.int32, device=dev)
        return q, k, v, pos, pm, t

    esz = torch.finfo(dt).bits // 8
    sets = _copies(make, 2 * n_pages * p_sz * hkv * dh * esz)
    live = sum(t + 1 for t in ts)
    mapped = sum((t // p_sz + 1) * p_sz for t in ts)
    # bytes: q and out once, the live K/V rows once, the mapped pages'
    # position lanes, the map and the clocks; operations over the live rows
    nbytes = (2 * b * h * dh * esz + 2 * live * hkv * dh * esz + mapped * 4
              + b * n_pp * 4 + b * 4)
    flops = 4.0 * live * h * dh
    # the library yardstick runs on the dense view gathered from the pages
    # (gathered here, outside the timed call)
    views = {}
    for q, k, v, pos, pm, t in sets:
        dv = paged_view({"k": k, "v": v, "pos": pos}, pm)
        mask = (dv["pos"] >= 0) & (dv["pos"] <= t[:, None])
        views[k.data_ptr()] = (dv["k"].contiguous(), dv["v"].contiguous(),
                               dv["pos"].contiguous(), mask[:, None, None])

    def library(q, k, v, pos, pm, t):
        kd, vd, _, mask = views[k.data_ptr()]
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]

    return sets, nbytes, flops, library, {"dense_view": views}


MLA_SCALE = (128 + 64) ** -0.5           # deepseek-v2: (qk_nope + qk_rope)^-.5


def _mla_chunk_case(b, c, s_cache, h, lat_d, r, dt, q0, filled, pad_rows,
                    dev, gen):
    """An absorbed-MLA prefill chunk: ``c`` queries at q0.. (the last
    ``pad_rows`` of them pad) against a latent ring whose first ``filled``
    rows hold positions 0.. plus the chunk."""
    sk = s_cache + c

    def make():
        ql = torch.randn((b, c, h, lat_d), generator=gen, device=dev).to(dt)
        qr = torch.randn((b, c, h, r), generator=gen, device=dev).to(dt)
        lat = torch.randn((b, sk, lat_d), generator=gen, device=dev).to(dt)
        rope = torch.randn((b, sk, r), generator=gen, device=dev).to(dt)
        qp = q0 + torch.arange(c, dtype=torch.int32, device=dev)
        qp[c - pad_rows:] = -1
        cache = torch.arange(s_cache, dtype=torch.int32, device=dev)
        cache = torch.where(cache < filled, cache, torch.full_like(cache, -1))
        kp = torch.cat([cache, qp])[None].repeat(b, 1)
        return ql, qr, lat, rope, qp[None].repeat(b, 1).contiguous(), kp

    esz = torch.finfo(dt).bits // 8
    sets = _copies(make, b * (c * h * 2 * (lat_d + r) + sk * (lat_d + r))
                   * esz)
    ql, qr, lat, rope, qp, kp = sets[0]
    allow = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None])
    pairs = int(allow.sum())
    live_keys = int((kp >= 0).sum())
    # bytes: q_lat/q_rope read and out written once, the live latent and
    # rope rows once, both position lanes; operations: the two score terms
    # and the latent value product over the live (query, key) pairs
    nbytes = (esz * (ql.numel() + qr.numel() + ql.numel())
              + live_keys * (lat_d + r) * esz + (qp.numel() + kp.numel()) * 4)
    flops = 2.0 * pairs * h * (lat_d + r + lat_d)
    kv = {}
    for st in sets:
        mask = ((st[5][:, None, :] >= 0)
                & (st[5][:, None, :] <= st[4][:, :, None]))[:, None]
        kv[st[2].data_ptr()] = (torch.cat([st[2], st[3]], -1)[:, None],
                                st[2][:, None], mask)

    def library(ql, qr, lat, rope, qp, kp):
        # q = [q_lat | q_rope], k = [latent | rope] on one KV head, v =
        # latent: SDPA computes the same absorbed function (d_v != d_qk)
        k1, v1, mask = kv[lat.data_ptr()]
        q = torch.cat([ql, qr], -1).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q, k1, v1, attn_mask=mask, scale=MLA_SCALE,
            enable_gqa=True).transpose(1, 2)

    live_rows = qp[0] >= 0
    return (sets, nbytes, flops, library,
            {"rows": live_rows, "kw": {"scale": MLA_SCALE}})


def _paged_mla_case(b, n_pp, p_sz, h, lat_d, r, dt, t_base, dev, gen):
    """Serving-like paged MLA decode inputs: ``b * n_pp + 1`` pool pages
    (page 0 the null page), slot i mapping shuffled pages for its positions
    0..t_i, the rest of its map unbacked."""
    from repro_torch.models.attention import paged_view
    n_pages = b * n_pp + 1
    ts = [t_base - 3 * i for i in range(b)]

    def make():
        ql = torch.randn((b, h, lat_d), generator=gen, device=dev).to(dt)
        qr = torch.randn((b, h, r), generator=gen, device=dev).to(dt)
        lat = torch.randn((n_pages, p_sz, lat_d), generator=gen,
                          device=dev).to(dt)
        rope = torch.randn((n_pages, p_sz, r), generator=gen,
                           device=dev).to(dt)
        pos = torch.full((n_pages, p_sz), -1, dtype=torch.int32, device=dev)
        pos[0] = torch.arange(p_sz, dtype=torch.int32, device=dev)
        perm = 1 + torch.randperm(n_pages - 1, generator=gen, device=dev)
        pm = torch.zeros((b, n_pp), dtype=torch.int32, device=dev)
        used = 0
        for s_, t in enumerate(ts):
            n_live = t // p_sz + 1
            ids = perm[used:used + n_live]
            used += n_live
            pm[s_, :n_live] = ids.to(torch.int32)
            pos[ids] = torch.arange(n_live * p_sz, dtype=torch.int32,
                                    device=dev).view(n_live, p_sz)
        t = torch.tensor(ts, dtype=torch.int32, device=dev)
        return ql, qr, lat, rope, pos, pm, t

    esz = torch.finfo(dt).bits // 8
    sets = _copies(make, n_pages * p_sz * (lat_d + r) * esz)
    live = sum(t + 1 for t in ts)
    mapped = sum((t // p_sz + 1) * p_sz for t in ts)
    # bytes: q_lat/q_rope and out once, the live latent + rope rows once,
    # the mapped pages' position lanes, the map and the clocks; operations:
    # the two score terms and the latent value product over the live rows
    nbytes = (esz * b * h * (2 * lat_d + r) + live * (lat_d + r) * esz
              + mapped * 4 + b * n_pp * 4 + b * 4)
    flops = 2.0 * live * h * (lat_d + r + lat_d)
    views = {}
    for ql, qr, lat, rope, pos, pm, t in sets:
        v = paged_view({"latent": lat, "rope": rope, "pos": pos}, pm)
        mask = (v["pos"] >= 0) & (v["pos"] <= t[:, None])
        views[lat.data_ptr()] = (
            torch.cat([v["latent"], v["rope"]], -1)[:, None].contiguous(),
            v["latent"][:, None].contiguous(), mask[:, None, None])

    def library(ql, qr, lat, rope, pos, pm, t):
        k1, v1, mask = views[lat.data_ptr()]
        q = torch.cat([ql, qr], -1)[:, :, None]
        return torch.nn.functional.scaled_dot_product_attention(
            q, k1, v1, attn_mask=mask, scale=MLA_SCALE,
            enable_gqa=True)[:, :, 0]

    return sets, nbytes, flops, library, {"kw": {"scale": MLA_SCALE}}


def _copy_case(n_pages, p_sz, hkv, dh, dt, dev, gen):
    """A COW flush on one outer bf16 pool leaf: 4 pairs and 4 (0, 0)
    padding pairs."""
    srcs = torch.tensor([5, 17, 100, 201, 0, 0, 0, 0], dtype=torch.int32,
                        device=dev)
    dsts = torch.tensor([250, 260, 270, 272, 0, 0, 0, 0], dtype=torch.int32,
                        device=dev)

    def make():
        pool = torch.randn((n_pages, p_sz, hkv, dh), generator=gen,
                           device=dev).to(dt)
        return pool, srcs, dsts

    esz = torch.finfo(dt).bits // 8
    row = p_sz * hkv * dh * esz
    sets = _copies(make, n_pages * row)
    # bytes: each real pair's page read once and written once, the pair
    # table once; no arithmetic
    nbytes = 2 * 4 * row + 2 * srcs.numel() * 4

    def library(pool, srcs, dsts):
        pool[dsts.long()] = pool[srcs.long()]
        return pool

    return sets, nbytes, 0.0, library, {"inplace": True}


def _ring_positions(ts, s, dev):
    """(B, s) positions of rings whose clocks ``ts`` passed ``s``: row l
    holds the newest position p <= t with p % s == l."""
    t = torch.tensor(ts, dtype=torch.int32, device=dev)[:, None]
    l = torch.arange(s, dtype=torch.int32, device=dev)[None]
    return (t - torch.remainder(t - l, s)).to(torch.int32)


def _rg_ring_case(b, s, g, dh, dt, t_base, window, dev, gen, paged=None,
                  hkv=1):
    """A windowed decode read over wrapped rings: recurrentgemma's outer
    read is MQA (one KV head, G query heads of dh), h2o-danube's ``hkv`` 8
    KV heads of G 4; rings of ``s`` rows whose clocks t_base.. have passed
    ``s``, so every ring has wrapped, with the attention window. ``paged``
    (a page size) puts the same logical rows into shuffled pages of ``b *
    s/P + 1`` pool rows (page 0 the null page) and returns the paged read's
    case."""
    ts = [t_base - 2 * i for i in range(b)]
    h = hkv * g
    n_pp = s // paged if paged else 0
    n_pages = b * n_pp + 1

    def make():
        q = torch.randn((b, h, dh), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, hkv, dh), generator=gen, device=dev).to(dt)
        pos = _ring_positions(ts, s, dev)
        t = torch.tensor(ts, dtype=torch.int32, device=dev)
        if not paged:
            return q, k, v, pos, t
        perm = 1 + torch.randperm(n_pages - 1, generator=gen, device=dev)
        pm = perm.view(b, n_pp).to(torch.int32)
        shape = (n_pages, paged, hkv, dh)
        kp = torch.randn(shape, generator=gen, device=dev).to(dt)
        vp = torch.randn(shape, generator=gen, device=dev).to(dt)
        pp = torch.full((n_pages, paged), -1, dtype=torch.int32, device=dev)
        pp[0] = torch.arange(paged, dtype=torch.int32, device=dev)
        idx = pm.long().view(-1)
        kp[idx] = k.reshape(b * n_pp, paged, hkv, dh)
        vp[idx] = v.reshape(b * n_pp, paged, hkv, dh)
        pp[idx] = pos.reshape(b * n_pp, paged)
        return q, kp, vp, pp, pm, t

    esz = torch.finfo(dt).bits // 8
    sets = _copies(make, 2 * b * s * hkv * dh * esz)
    # every ring row is live (the window covers the whole ring) and read
    # once as K and once as V; q and out once; positions, map and clocks
    live = b * s
    nbytes = (2 * b * h * dh * esz + 2 * live * hkv * dh * esz + live * 4
              + b * 4 + (b * n_pp * 4 if paged else 0))
    flops = 4.0 * live * h * dh
    views = {}
    for st in sets:
        if paged:
            from repro_torch.models.attention import paged_view
            q, kp, vp, pp, pm, t = st
            dv = paged_view({"k": kp, "v": vp, "pos": pp}, pm)
            kd, vd, pd = (dv["k"].contiguous(), dv["v"].contiguous(),
                          dv["pos"].contiguous())
        else:
            q, kd, vd, pd, t = st
        mask = (pd >= 0) & (pd <= t[:, None]) & (pd > t[:, None] - window)
        views[st[1].data_ptr()] = (kd, vd, pd, mask[:, None, None])

    def library(q, k, *rest):
        kd, vd, _, mask = views[k.data_ptr()]
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]

    extra = {"kw": {"window": window}}
    if paged:
        extra["dense_view"] = views
    return sets, nbytes, flops, library, extra


def _lru_case(b, s, d, dt, dev, gen, h0=False):
    """The RG-LRU recurrence as prefill hands it over: decays in (0.5,
    0.999), inputs scaled by sqrt(1 - a^2); ``h0`` adds a start state."""

    def make():
        a = 0.5 + 0.499 * torch.rand((b, s, d), generator=gen, device=dev)
        x = torch.randn((b, s, d), generator=gen, device=dev) * torch.sqrt(
            1 - a * a)
        h = (torch.randn((b, d), generator=gen, device=dev) if h0
             else None)
        return a.to(dt), x.to(dt), h

    esz = torch.finfo(dt).bits // 8
    # a and x read once, h written once (and h0 read once); a product and
    # a sum per element
    nbytes = 3 * b * s * d * esz + (b * d * 4 if h0 else 0)
    sets = _copies(make, nbytes)
    # no single PyTorch call computes this recurrence: no library yardstick
    return sets, nbytes, 2.0 * b * s * d, None, {"exact_f32": True}


def _stmc_case(b, k, cin, cout, dt, dev, gen, bias=True):
    """One STMC conv contraction as the U-Net stream hands it over: a
    (B, K, Cin) window of activations against He-uniform (K, Cin, Cout)
    weights and a bias."""
    bound = (6.0 / (k * cin)) ** 0.5

    def make():
        win = torch.randn((b, k, cin), generator=gen, device=dev)
        w = (torch.rand((k, cin, cout), generator=gen, device=dev) * 2
             - 1) * bound
        bb = (0.1 * torch.randn((cout,), generator=gen, device=dev)
              if bias else None)
        return (win.to(dt), w.to(dt), None if bb is None else bb.to(dt))

    def library(win, w, bb):
        flat_w = w.view(k * cin, cout)
        if bb is None:
            return torch.mm(win.view(b, k * cin), flat_w)
        return torch.addmm(bb, win.view(b, k * cin), flat_w)

    esz = torch.finfo(dt).bits // 8
    # window, weights and bias read once, the output written once; a
    # multiply-add per window element and output column
    nbytes = (b * k * cin + k * cin * cout + (cout if bias else 0)
              + b * cout) * esz
    sets = _copies(make, nbytes)
    return sets, nbytes, 2.0 * b * k * cin * cout, library, {}


def _first(fn):
    """The ``h_all`` of an (h_all, h_last) scan."""
    return lambda *args: fn(*args)[0]


KERNEL_META = {
    "decode_attention": dict(
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:73"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:74"),
    "chunk_attention": dict(
        source="src/repro_torch/kernels/csrc/chunk_attention.cu",
        replaces="src/repro/kernels/chunk_attention.py:79"),
    "paged_decode_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:155"),
    "copy_pages": dict(
        source="src/repro_torch/kernels/csrc/page_copy.cu",
        replaces="src/repro/kernels/page_copy.py:33"),
    "mla_chunk_attention": dict(
        source="src/repro_torch/kernels/csrc/mla_chunk_attention.cu",
        replaces="src/repro/kernels/chunk_attention.py:168"),
    "paged_mla_decode_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_mla_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:245"),
    "lru_scan": dict(
        source="src/repro_torch/kernels/csrc/lru_scan.cu",
        replaces="src/repro/kernels/lru_scan.py:41"),
    "stmc_conv": dict(
        source="src/repro_torch/kernels/csrc/stmc_conv.cu",
        replaces="src/repro/kernels/stmc_conv.py:27"),
    # no TPU kernel: the reference's gradient is XLA's autodiff of this
    # plain function, which its Pallas flash kernel stands for on a TPU
    "flash_attention_bwd": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/ref.py:61",
        replaces_note="no Pallas kernel: the reference differentiates "
                      "ref.chunked_flash_attention with XLA"),
    # the same for the RG-LRU scan's gradient: XLA's autodiff of the
    # associative scan
    "lru_scan_bwd": dict(
        source="src/repro_torch/kernels/csrc/lru_scan.cu",
        replaces="src/repro/kernels/ref.py:388",
        replaces_note="no Pallas kernel: the reference differentiates "
                      "ref.lru_scan (an associative scan) with XLA"),
}
# the device kernel each wrapper launches once a call, by name (phase 3's
# readings hold a profile to them: one that lost a record is taken again);
# the decode reads also launch their combine once a call, a split chunk
# read its merge (_call_kernels)
CALL_KERNELS = {
    "decode_attention": ("decode_mma_kernel", "decode_scalar_kernel"),
    "paged_decode_attention": ("decode_mma_kernel", "decode_scalar_kernel"),
    "flash_attention": ("flash_attention_kernel",),
    "chunk_attention": ("chunk_attention_kernel",),
    "mla_chunk_attention": ("mla_chunk_attention_kernel",),
    "paged_mla_decode_attention": ("paged_mla_decode_attention_kernel",),
    "copy_pages": ("copy_pages_kernel",),
    "lru_scan": ("lru_scan_kernel",),
    "stmc_conv": ("stmc_conv_kernel",),
}


def _call_kernels(name: str, dt, n_split: int) -> tuple:
    """The device kernels a call of wrapper ``name`` in ``dt`` launches
    once each: the decode reads' split body of the dtype and their combine,
    chunk_attention's range kernel and, split, its merge; the others'
    one kernel."""
    if name in DECODE_READS:
        body = CALL_KERNELS[name][0 if dt == torch.bfloat16 else 1]
        return body, "decode_combine_kernel"
    if name == "chunk_attention" and n_split > 1:
        return CALL_KERNELS[name] + ("chunk_combine_kernel",)
    return CALL_KERNELS[name]


# kernels whose path runs float32 (the rest: bfloat16)
F32_PATHS = ("lru_scan", "stmc_conv")
DECODE_READS = ("decode_attention", "paged_decode_attention")
CHUNK_KERNELS = ("chunk_attention", "mla_chunk_attention")
# the reads that split S and merge the ranges in a combine kernel
SPLIT_READS = DECODE_READS + ("paged_mla_decode_attention",)
# the kernels this slice redesigned, tabled at the end of phase 3
REDESIGNED = ("lru_scan", "copy_pages")



def _chunk_walk(name, args, kw, got) -> dict:
    """What the bf16 chunk body did on these inputs, counted by the kernel
    on the card (kernels/chunk_attention.py: chunk_walk, mla_chunk_walk):
    blocks of the main kernel, key tiles in reach of a block (summed over
    the blocks), the tiles it skipped and the tiles it walked again. The
    counted launch must give the wrapper's bits."""
    from repro_torch.kernels import chunk_attention as CA
    counted = (CA.chunk_walk if name == "chunk_attention"
               else CA.mla_chunk_walk)
    out, walk = counted(*args, **kw)
    check(torch.equal(out, got),
          f"{name}: the counted launch is not the wrapper's bit for bit")
    tiles, skipped, again = (int(x) for x in walk.sum(0).tolist())
    return {"blocks": walk.shape[0], "tiles": tiles,
            "tiles_skipped": skipped, "tiles_walked_again": again,
            "skipped_share": skipped / tiles}


def _check_only(case):
    """A phase-3 case held against its plain version, not timed."""
    case[4]["check_only"] = True
    return case


def _walk_text(r) -> str:
    return (f"{r['tiles_skipped']} / {r['tiles_walked_again']} of "
            f"{r['tiles']} ({r['skipped_share']:.3f})" if "tiles" in r
            else "-")


def _chunk_table(recs, log: str):
    """Phase 3's table of the chunk kernels: device ms [CUDA-event ms], x
    SDPA, plain, bound and its share, max|Δ| against its bound, blocks, key
    tiles skipped and walked again (counted on the card), the split; then
    their ptxas lines."""
    print("  chunk kernels (device ms [event ms]; x SDPA; plain; bound "
          "(share); max|Δ| / tol; blocks; tiles skipped / walked again of "
          "all, counted on the card; split):")
    for r in recs:
        split = (f"{r['n_split']} x {r['keys_per_split']}"
                 if "n_split" in r else "-")
        print(f"    {r['name']} {r['shape']} {r['dtype']}: {r['ms']:.4f} "
              f"[{r['event_ms']:.4f}]; x{r['ms'] / r['library_ms']:.2f}; "
              f"{r['plain_ms']:.4f}; {r['bound_ms']:.5f} "
              f"({r['bound_ms'] / r['ms']:.3f}); {r['max_abs_err']:.2e} / "
              f"{r['tol']:.2e}; {r.get('blocks', '-')}; {_walk_text(r)}; "
              f"{split}")
    for line in _ptxas_lines(log):
        if "chunk" in line:
            print("  " + line)


def _plan_text(r) -> str:
    """A redesigned kernel's plan as phase 3 prints it."""
    p = r.get("plan")
    if p is None:
        return "-"
    if r["name"] == "lru_scan":
        ring = ("edge path" if p["edge"] else
                f"ring of {p['stages']} stages of T {p['steps']} steps, "
                f"{p['smem'] // 1024} KB a block")
        return (f"{p['chains']} chain-warps, {p['warps']} a block, "
                f"{p['blocks']} blocks, {ring}; host {r['host_ms']:.4f} ms "
                f"a call")
    if r["name"] == "stmc_conv":
        return (f"{p['blocks']} blocks, cluster {p['splits']} x "
                f"{p['keys_per_split']} rows of K*Cin, {p['cols']} columns "
                f"a block, {p['rows']} rows of B, "
                f"{'16-byte' if p['vec16'] else 'edge-path'} loads; host "
                f"{r['host_ms']:.4f} ms a call")
    return (f"{p['blocks']} blocks = {p['groups']} head groups x "
            f"{p['n_split']} ranges of {p['keys_per_split']} keys x B; "
            f"split {r.get('split_ms', math.nan):.4f} + combine "
            f"{r.get('combine_ms', math.nan):.4f} ms, host "
            f"{r['host_ms']:.4f} ms a call")


def _redesign_table(recs, log: str):
    """Phase 3's table of the kernels this slice redesigned: device ms
    [CUDA-event ms], x the library call, plain, bound and its share,
    max|Δ| against its tolerance, and the plan; then their ptxas lines."""
    print("  redesigned kernels (device ms [event ms]; x library; plain; "
          "bound (share); max|Δ| / tol; plan):")
    for r in recs:
        lib = (f"x{r['ms'] / r['library_ms']:.2f}" if r["library_ms"]
               else "-")
        print(f"    {r['name']} {r['shape']} {r['dtype']}: {r['ms']:.4f} "
              f"[{r['event_ms']:.4f}]; {lib}; {r['plain_ms']:.4f}; "
              f"{r['bound_ms']:.5f} ({r['bound_ms'] / r['ms']:.3f}); "
              f"{r['max_abs_err']:.2e} / {r['tol']:.2e}; {_plan_text(r)}")
    for line in _ptxas_lines(log):
        if "lru_scan" in line or "copy_pages" in line:
            print("  " + line)


# phase 3's label of each family of phase 18 whose decode or chunk shape
# is new (a shape's label starts with it)
FAMILY_OF = {"nemotron": "nemotron-4-15b", "mistral": "mistral-large-123b",
             "danube": "h2o-danube-1.8b"}
# the same for phase 19's families: one label a new shape (no label is a
# prefix of another)
ZOO_OF = {"whisper-enc": "whisper-tiny",
          "whisper-cross-prefill": "whisper-tiny",
          "whisper-cross-read": "whisper-tiny",
          "whisper-self": "whisper-tiny", "paligemma": "paligemma-3b"}


def _family(shape: str):
    """The family label under which phase 3 reads this shape, or None."""
    return next((f for f in (*FAMILY_OF, *ZOO_OF) if shape.startswith(f)),
                None)


def _family_table(recs, log: str):
    """Phase 3's table of the families' new shapes in bf16: device ms
    between markers [the parent's reading without them], CUDA-event ms, x
    SDPA, plain, bound (share), max|Δ| against its tolerance, the split of
    S and the paged read equal to the dense kernel's; then ptxas' lines of
    their instantiations, both dtypes."""
    print("  the families' and the zoo's shapes, bf16 (device ms [without "
          "markers] "
          "{event ms}; x SDPA; plain; bound (share); max|Δ| / tol; split):")
    for r in recs:
        split = (f"{r['n_split']} x {r['keys_per_split']}"
                 if "n_split" in r else "-")
        unmarked = r["ms_unmarked"] or math.nan
        print(f"    {r['name']} {r['shape']}: {r['ms']:.4f} "
              f"[{unmarked:.4f}] {{{r['event_ms']:.4f}}}; "
              f"x{r['ms'] / r['library_ms']:.2f}; {r['plain_ms']:.4f}; "
              f"{r['bound_ms']:.5f} ({r['bound_ms'] / r['ms']:.3f}); "
              f"{r['max_abs_err']:.2e} / {r['tol']:.2e}; {split}"
              + ("; == dense kernel" if r.get("equals_dense_kernel")
                 else ""))
    for line in _ptxas_lines(log):
        if any(k in line for k in ("G 6", "G 12", "dh 80", "G 8 / dh 256",
                                   "dh 64")):
            print("  " + line)


def _unet_conv_sweep(dev, gen) -> dict:
    """stmc_conv in float32 at B 1 (one live stream) on each of the 14
    convs of soi-unet-dns, beside torch.addmm and the bound (device ms from
    the profiler), each held to the plain version; their sums against the
    bound of a frame's weights. Returns the sums."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import stmc_conv as SC
    from repro_torch.models import unet as U
    f32 = torch.float32
    cfg = _unet_cfg(None)
    enc_io, dec_io = U._layer_io(cfg)
    convs = ([(f"enc{i + 1}", cfg.kernel, ci, co)
              for i, (ci, co) in enumerate(enc_io)]
             + [(f"dec{i + 1}", cfg.kernel, ci, co)
                for i, (ci, co) in enumerate(dec_io)])
    print(f"  stmc_conv f32 B 1 on the {len(convs)} convs of soi-unet-dns "
          f"(device ms; addmm; bound (share); plan; max|Δ|):")
    tot = {"ms": 0.0, "addmm_ms": 0.0, "bound_ms": 0.0}
    for label, k, cin, cout in convs:
        sets, nbytes, flops, library, _ = _stmc_case(1, k, cin, cout, f32,
                                                     dev, gen)
        got = SC.stmc_conv(*sets[0])
        err = float((got - ref.stmc_conv(*sets[0])).abs().max())
        check(err < TOL[f32], f"stmc_conv {label}: max|Δ| {err}")
        bound, _ = _bound(nbytes, flops, f32)
        ms = (_device_ms(SC.stmc_conv, sets, 20, bound_ms=bound,
                         markers=MARKERS, each=CALL_KERNELS["stmc_conv"])
              or _time_ms(SC.stmc_conv, sets, 50))
        lib = (_device_ms(library, sets, 20, markers=MARKERS)
               or _time_ms(library, sets, 50))
        plan = SC.stmc_plan(1, k * cin, cout, f32)
        print(f"    {label} ({k * cin}x{cout}): {ms:.4f}; {lib:.4f}; "
              f"{bound:.5f} ({bound / ms:.3f}); {plan.blocks} blocks = "
              f"{-(-cout // plan.cols)} x {plan.splits}, {plan.cols} "
              f"columns; {err:.1e}", flush=True)
        tot["ms"] += ms
        tot["addmm_ms"] += lib
        tot["bound_ms"] += bound
    print(f"    sum of the {len(convs)}: {tot['ms']:.4f} ms against addmm "
          f"{tot['addmm_ms']:.4f}; the frame's bound "
          f"{tot['bound_ms'] * 1e3:.1f} µs (share "
          f"{tot['bound_ms'] / tot['ms']:.3f})")
    return tot


# a COW flush's pairs in each page table: 4 real pairs (fresh pages near
# the pool's end as destinations) and 4 (0, 0) padding pairs
FLUSH_PAIRS = {273: ([5, 17, 100, 201, 0, 0, 0, 0],
                     [250, 260, 270, 272, 0, 0, 0, 0]),
               193: ([3, 40, 99, 150, 0, 0, 0, 0],
                     [180, 185, 190, 192, 0, 0, 0, 0])}


def _flush_case(tables, dev, gen):
    """A COW flush as the engine hands it to ``copy_pages_leaves``: for each
    page table ``(n_pages, layers, leaf shapes)``, every leaf of its
    attention layers with the table's pairs (``FLUSH_PAIRS``). A set is
    (pools, host srcs, host dsts, device srcs, device dsts); returns the
    sets, the bytes the flush must move and the leaves' count."""
    spec = [(n, shape, dt) for n, layers, leaves in tables
            for _ in range(layers) for shape, dt in leaves]
    ids = {n: tuple(torch.tensor(v, dtype=torch.int32, device=dev)
                    for v in FLUSH_PAIRS[n]) for n in FLUSH_PAIRS}

    def make():
        pools = [torch.randn((n,) + shape, generator=gen, device=dev).to(dt)
                 if dt.is_floating_point else
                 torch.randint(-1, 2048, (n,) + shape, generator=gen,
                               device=dev, dtype=dt) for n, shape, dt in spec]
        return (pools, [FLUSH_PAIRS[n][0] for n, _, _ in spec],
                [FLUSH_PAIRS[n][1] for n, _, _ in spec],
                [ids[n][0] for n, _, _ in spec],
                [ids[n][1] for n, _, _ in spec])

    rows = [math.prod(shape) * (torch.finfo(dt).bits if dt.is_floating_point
                                else torch.iinfo(dt).bits) // 8
            for _, shape, dt in spec]
    pool_bytes = sum(n * r for (n, _, _), r in zip(spec, rows))
    sets = _copies(make, pool_bytes)
    real = [sum(a != b for a, b in zip(*FLUSH_PAIRS[n])) for n, _, _ in spec]
    # bytes: each real pair's page read once and written once, the packed
    # table (5 fields a leaf, 2 ids a pair of each table, int64) once
    n_pairs = sum(len(FLUSH_PAIRS[n][0]) for n in {n for n, _, _ in spec})
    nbytes = (sum(2 * k * r for k, r in zip(real, rows))
              + 8 * (5 * len(spec) + 2 * n_pairs))
    return sets, nbytes, len(spec)


def _cow_flush_reading(label, tables, dev, gen) -> dict:
    """One ``copy_pages_leaves`` launch for a whole COW flush, held bit for
    bit against the plain version leaf by leaf, timed against the same
    flush as one ``copy_pages`` launch a leaf, against the indexed
    assignment a leaf summed (the library yardstick) and the bytes' bound;
    device ms (kernel and table upload apart), CUDA-event ms and host ms a
    call. Returns the record."""
    from repro_torch.kernels import page_copy as PC
    from repro_torch.kernels import ref
    sets, nbytes, n_leaves = _flush_case(tables, dev, gen)
    pools, srcs, dsts, dsrcs, ddsts = sets[0]
    got = [p.clone() for p in pools]
    n0 = PC.copy_pages.launches
    PC.copy_pages_leaves(got, srcs, dsts)
    torch.cuda.synchronize()
    check(PC.copy_pages.launches == n0 + 1,
          f"copy_pages_leaves {label}: {PC.copy_pages.launches - n0} "
          f"launches for one flush")
    for i, (g, p, s_, d_) in enumerate(zip(got, pools, dsrcs, ddsts)):
        check(torch.equal(g, ref.copy_pages(p.clone(), s_, d_)),
              f"copy_pages_leaves {label}: leaf {i} not bit-exact")

    def one(pools, srcs, dsts, *_):
        PC.copy_pages_leaves(pools, srcs, dsts)

    def per_leaf(pools, srcs, dsts, *_):
        for p, s_, d_ in zip(pools, srcs, dsts):
            PC.copy_pages(p, s_, d_)

    def plain(pools, _s, _d, dsrcs, ddsts):
        for p, s_, d_ in zip(pools, dsrcs, ddsts):
            ref.copy_pages(p, s_, d_)

    longs = {id(t): t.long() for st in sets for t in st[3] + st[4]}

    def library(pools, _s, _d, dsrcs, ddsts):
        for p, s_, d_ in zip(pools, dsrcs, ddsts):
            p[longs[id(d_)]] = p[longs[id(s_)]]

    def kernel_and_copy(parts):
        kern = sum(v for k, v in parts.items() if "copy_pages_kernel" in k)
        return kern, sum(parts.values()) - kern

    rec = {"name": "copy_pages", "shape": label, "dtype": "bfloat16",
           "max_abs_err": 0.0, "leaves": n_leaves}
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, 0.0, torch.bfloat16)
    # one launch a call names its kernel; a launch a leaf launches it once
    # a leaf, which the profile is held to through the bound alone
    for key, fn, iters, each in (
            ("", one, 20, CALL_KERNELS["copy_pages"]),
            ("per_leaf_", per_leaf, 5, ())):
        parts: dict = {}
        rec[key + "ms"] = (_device_ms(fn, sets, iters, parts,
                                      bound_ms=rec["bound_ms"],
                                      markers=MARKERS, each=each)
                           or _time_ms(fn, sets, iters))
        rec[key + "kernel_ms"], rec[key + "upload_ms"] = kernel_and_copy(
            parts)
        rec[key + "event_ms"] = _time_ms(fn, sets, iters)
        rec[key + "host_ms"] = _host_ms(fn, sets, 4 * iters)
    # the host's share of a call: packing the table, and its upload
    table = PC.pack_leaves(pools, srcs, dsts)
    rec["host_pack_ms"] = _host_ms(
        lambda pools, srcs, dsts, *_: PC.pack_leaves(pools, srcs, dsts), sets,
        80)
    rec["host_upload_ms"] = _host_ms(lambda *_: PC._upload(table, dev), sets,
                                     80)
    rec["plain_ms"] = (_device_ms(plain, sets, 5, bound_ms=rec["bound_ms"],
                                  markers=MARKERS)
                       or _time_ms(plain, sets, 5))
    rec["library_ms"] = (_device_ms(library, sets, 5, markers=MARKERS)
                         or _time_ms(library, sets, 5))
    rec["bytes"] = nbytes
    print(json.dumps({"kernels": [rec]}), flush=True)
    print(f"  copy_pages {label}: {n_leaves} leaves, 1 launch: "
          f"{rec['ms']:.4f} ms on the device (kernel {rec['kernel_ms']:.4f}"
          f", upload {rec['upload_ms']:.4f}) [{rec['event_ms']:.4f}], host "
          f"{rec['host_ms']:.4f} ms a call (packing {rec['host_pack_ms']:.4f}"
          f", upload {rec['host_upload_ms']:.4f}); a launch a leaf: "
          f"{rec['per_leaf_ms']:.4f} (kernels {rec['per_leaf_kernel_ms']:.4f}"
          f", uploads {rec['per_leaf_upload_ms']:.4f}) "
          f"[{rec['per_leaf_event_ms']:.4f}], host "
          f"{rec['per_leaf_host_ms']:.4f}; indexed assignment "
          f"{rec['library_ms']:.4f}; plain {rec['plain_ms']:.4f}; bound "
          f"{rec['bound_ms']:.5f} ({rec['bound_ms'] / rec['ms']:.3f}); "
          f"bit for bit", flush=True)
    return rec


def kernels_phase(dev) -> dict:
    """Returns {kernel name: record of its serving-path bf16 case}; the
    flash kernel's deepseek-v2 shape is keyed "flash_attention (MLA)", the
    decode kernels' recurrentgemma outer shapes "<name> (RG)" and the
    middle ring "decode_attention (RG middle)"; lru_scan's and
    stmc_conv's records are their first float32 case, the dtype their
    paths run (stmc_conv: decoder 2 of the U-Net at B 1, one live stream)."""
    phase("3 kernels")
    from repro_torch.kernels import _build
    from repro_torch.kernels import chunk_attention as CA
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import lru_scan as LS
    from repro_torch.kernels import page_copy as PC
    from repro_torch.kernels import ref
    from repro_torch.kernels import stmc_conv as SC
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        # outer ring (4, 1088, 8, 128) and compressed middle (4, 768, 8, 128)
        # at serving step ~32: clocks 1056.. and frames 528..
        cases.append(("decode_attention", "outer (4,1088,8,128)", dt,
                      _decode_case(4, 1088, 8, 2, 128, dt, 1056, dev, gen),
                      DA.decode_attention, ref.decode_attention))
        cases.append(("decode_attention", "middle (4,768,8,128)", dt,
                      _decode_case(4, 768, 8, 2, 128, dt, 528, dev, gen),
                      DA.decode_attention, ref.decode_attention))
        cases.append(("flash_attention", "prefill (1,1024,16,128)", dt,
                      _flash_case(1, 1024, 8, 2, 128, dt, dev, gen),
                      FA.flash_attention, ref.flash_attention))
        cases.append(("flash_attention", "middle (1,512,16,128)", dt,
                      _flash_case(1, 512, 8, 2, 128, dt, dev, gen),
                      FA.flash_attention, ref.flash_attention))
        # the last chunk of a 1024-token prompt: 256 queries at 768.. against
        # the 1088-row ring (768 live) plus the chunk; the middle's 128
        # frames at 384.. against 768 + 128. Every query at a real position,
        # as the serving path sends them (models/attention.py); then the
        # outer chunk with 6 pad queries at -1, held but not timed
        cases.append(("chunk_attention", "outer q(1,256,16,128) Sk 1344", dt,
                      _chunk_case(1, 256, 1088, 8, 2, 128, dt, 768, 768, 0,
                                  dev, gen),
                      CA.chunk_attention, ref.chunk_attention))
        cases.append(("chunk_attention", "middle q(1,128,16,128) Sk 896", dt,
                      _chunk_case(1, 128, 768, 8, 2, 128, dt, 384, 384, 0,
                                  dev, gen),
                      CA.chunk_attention, ref.chunk_attention))
        cases.append(("chunk_attention",
                      "outer q(1,256,16,128) Sk 1344, 6 pad queries", dt,
                      _check_only(_chunk_case(1, 256, 1088, 8, 2, 128, dt,
                                              768, 768, 6, dev, gen)),
                      CA.chunk_attention, ref.chunk_attention))
        # the serving pools (slots * pages_per_slot + 1 pages) at clocks
        # 1056.. (outer) and frames 528.. (middle)
        cases.append(("paged_decode_attention",
                      "outer pools (273,16,8,128) map (4,68)", dt,
                      _paged_case(4, 68, 16, 8, 2, 128, dt, 1056, dev, gen),
                      DA.paged_decode_attention, ref.paged_decode_attention))
        cases.append(("paged_decode_attention",
                      "middle pools (193,16,8,128) map (4,48)", dt,
                      _paged_case(4, 48, 16, 8, 2, 128, dt, 528, dev, gen),
                      DA.paged_decode_attention, ref.paged_decode_attention))
        # deepseek-v2's exact-length prefill: 128 heads, q/k 192, v 128
        cases.append(("flash_attention", "MLA prefill (1,1024,128,192/128)",
                      dt, _flash_case(1, 1024, 128, 1, 192, dt, dev, gen,
                                      dv=128),
                      FA.flash_attention, ref.flash_attention))
        # the MLA stack's serving chunk (as chunk_attention's above, the
        # pad queries' case held but not timed) and the paged decode read
        # at clocks 1056.. / frames 528..
        cases.append(("mla_chunk_attention",
                      "outer q(1,256,128,512+64) Sk 1344", dt,
                      _mla_chunk_case(1, 256, 1088, 128, 512, 64, dt, 768,
                                      768, 0, dev, gen),
                      CA.mla_chunk_attention, ref.mla_chunk_attention))
        cases.append(("mla_chunk_attention",
                      "middle q(1,128,128,512+64) Sk 896", dt,
                      _mla_chunk_case(1, 128, 768, 128, 512, 64, dt, 384,
                                      384, 0, dev, gen),
                      CA.mla_chunk_attention, ref.mla_chunk_attention))
        cases.append(("mla_chunk_attention",
                      "outer q(1,256,128,512+64) Sk 1344, 6 pad queries", dt,
                      _check_only(_mla_chunk_case(1, 256, 1088, 128, 512, 64,
                                                  dt, 768, 768, 6, dev,
                                                  gen)),
                      CA.mla_chunk_attention, ref.mla_chunk_attention))
        cases.append(("paged_mla_decode_attention",
                      "outer pools (273,16,512+64) map (4,68) H 128", dt,
                      _paged_mla_case(4, 68, 16, 128, 512, 64, dt, 1056,
                                      dev, gen),
                      DA.paged_mla_decode_attention,
                      ref.paged_mla_decode_attention))
        cases.append(("paged_mla_decode_attention",
                      "middle pools (193,16,512+64) map (4,48) H 128", dt,
                      _paged_mla_case(4, 48, 16, 128, 512, 64, dt, 528, dev,
                                      gen),
                      DA.paged_mla_decode_attention,
                      ref.paged_mla_decode_attention))
        # recurrentgemma: MQA (G 16, dh 256) on the outer rings of 2048 at
        # serving step ~32 (clocks 2072.., wrapped), window 2048, dense and
        # paged (page 16); the middle's 1280-frame rings at frames 1036..
        cases.append(("decode_attention",
                      "RG outer ring (4,2048,1,256) G 16 t 2072 w 2048", dt,
                      _rg_ring_case(4, 2048, 16, 256, dt, 2072, 2048, dev,
                                    gen),
                      DA.decode_attention, ref.decode_attention))
        cases.append(("decode_attention", "RG middle (4,1280,1,256) G 16",
                      dt, _decode_case(4, 1280, 1, 16, 256, dt, 1036, dev,
                                       gen),
                      DA.decode_attention, ref.decode_attention))
        cases.append(("paged_decode_attention",
                      "RG outer pools (513,16,1,256) map (4,128) G 16 t 2072 "
                      "w 2048", dt,
                      _rg_ring_case(4, 2048, 16, 256, dt, 2072, 2048, dev,
                                    gen, paged=16),
                      DA.paged_decode_attention, ref.paged_decode_attention))
        # the families' new decode shapes (phase 18's serving reads):
        # nemotron-4-15b G 6 and mistral-large-123b G 12 (8 KV heads of
        # 128) at clocks 1000.. of 1024-row rings; h2o-danube-1.8b G 4 at
        # dh 80 on wrapped 4096-row rings with its window (clocks 4200..),
        # dense and paged (page 16); danube's chunk of 256 queries at 4096..
        # against its full ring of 4096 plus the chunk, with the window
        for fam, g in (("nemotron", 6), ("mistral", 12)):
            cases.append(("decode_attention",
                          f"{fam} (4,1024,8,128) G {g} t 1000", dt,
                          _decode_case(4, 1024, 8, g, 128, dt, 1000, dev,
                                       gen),
                          DA.decode_attention, ref.decode_attention))
            cases.append(("paged_decode_attention",
                          f"{fam} pools (257,16,8,128) map (4,64) G {g} "
                          f"t 1000", dt,
                          _paged_case(4, 64, 16, 8, g, 128, dt, 1000, dev,
                                      gen),
                          DA.paged_decode_attention,
                          ref.paged_decode_attention))
        cases.append(("decode_attention",
                      "danube ring (4,4096,8,80) G 4 t 4200 w 4096", dt,
                      _rg_ring_case(4, 4096, 4, 80, dt, 4200, 4096, dev, gen,
                                    hkv=8),
                      DA.decode_attention, ref.decode_attention))
        cases.append(("paged_decode_attention",
                      "danube pools (1025,16,8,80) map (4,256) G 4 t 4200 "
                      "w 4096", dt,
                      _rg_ring_case(4, 4096, 4, 80, dt, 4200, 4096, dev, gen,
                                    paged=16, hkv=8),
                      DA.paged_decode_attention, ref.paged_decode_attention))
        cases.append(("chunk_attention",
                      "danube q(1,256,32,80) Sk 4352 w 4096", dt,
                      _chunk_case(1, 256, 4096, 8, 4, 80, dt, 4096, 4096, 0,
                                  dev, gen, window=4096),
                      CA.chunk_attention, ref.chunk_attention))
        # the zoo's new shapes (phase 19): whisper-tiny's non-causal
        # encoder over 1500 frames (the last key tile ragged: 1500 = 23 *
        # 64 + 28) and its cross prefill of a 64-token prompt, its cross
        # read of the 1500 encoder rows from a query at 1 << 30 and its
        # self read (G 1, dh 64) at the served ring of 128, dense and paged
        # (page 16);
        # paligemma-3b's MQA read (G 8, dh 256) at the served ring of
        # 1088, dense and paged (page 16)
        cases.append(("flash_attention",
                      "whisper-enc (1,1500,6,64) non-causal", dt,
                      _flash_nc_case(1, 1500, 1500, 6, 1, 64, dt, dev, gen),
                      FA.flash_attention, ref.flash_attention))
        cases.append(("flash_attention",
                      "whisper-cross-prefill q(1,64,6,64) Sk 1500 "
                      "non-causal", dt,
                      _flash_nc_case(1, 64, 1500, 6, 1, 64, dt, dev, gen),
                      FA.flash_attention, ref.flash_attention))
        cases.append(("decode_attention",
                      "whisper-cross-read (4,1500,6,64) G 1 t 1<<30", dt,
                      _cross_case(4, 1500, 6, 64, dt, dev, gen),
                      DA.decode_attention, ref.decode_attention))
        cases.append(("decode_attention",
                      "whisper-self (4,128,6,64) G 1 t 100", dt,
                      _decode_case(4, 128, 6, 1, 64, dt, 100, dev, gen),
                      DA.decode_attention, ref.decode_attention))
        cases.append(("paged_decode_attention",
                      "whisper-self pools (33,16,6,64) map (4,8) G 1 t 100",
                      dt, _paged_case(4, 8, 16, 6, 1, 64, dt, 100, dev, gen),
                      DA.paged_decode_attention, ref.paged_decode_attention))
        cases.append(("decode_attention",
                      "paligemma (4,1088,1,256) G 8 t 1056", dt,
                      _decode_case(4, 1088, 1, 8, 256, dt, 1056, dev, gen),
                      DA.decode_attention, ref.decode_attention))
        cases.append(("paged_decode_attention",
                      "paligemma pools (273,16,1,256) map (4,68) G 8 t 1056",
                      dt, _paged_case(4, 68, 16, 1, 8, 256, dt, 1056, dev,
                                      gen),
                      DA.paged_decode_attention, ref.paged_decode_attention))
    # recurrentgemma's prefill recurrence: float32 a and x (the path's
    # dtype) at the outer (2040 tokens) and middle (1020 frames) shapes,
    # then a start state and an odd shape; bfloat16 inputs too
    for dt in (torch.float32, torch.bfloat16):
        for shape, args in (("outer (1,2040,4096)", (1, 2040, 4096)),
                            ("middle (1,1020,4096)", (1, 1020, 4096))):
            cases.append(("lru_scan", shape, dt,
                          _lru_case(*args, dt, dev, gen), _first(LS.lru_scan),
                          _first(ref.lru_scan)))
    cases.append(("lru_scan", "h0 (2,300,4096)", torch.float32,
                  _lru_case(2, 300, 4096, torch.float32, dev, gen, h0=True),
                  _first(LS.lru_scan), _first(ref.lru_scan)))
    cases.append(("lru_scan", "odd (3,37,100)", torch.float32,
                  _lru_case(3, 37, 100, torch.float32, dev, gen),
                  _first(LS.lru_scan), _first(ref.lru_scan)))
    # more chains than SMs: 512 chain-warps, four a block
    cases.append(("lru_scan", "B 4 (4,2040,4096)", torch.float32,
                  _lru_case(4, 2040, 4096, torch.float32, dev, gen),
                  _first(LS.lru_scan), _first(ref.lru_scan)))
    # the streaming U-Net (soi-unet-dns): decoder 2, the layer with the
    # most weights (K*Cin 7248, Cout 664: 19.25 MB in float32), at B 1 (one
    # live stream) and B 32; encoder 7 (Cout 1296) at B 32; a ragged case
    # without bias. float32 is the path's dtype
    for dt in (torch.float32, torch.bfloat16):
        for shape, args, bias in (
                ("dec2 (1,3,2416)x(3,2416,664)", (1, 3, 2416, 664), True),
                ("dec2 (32,3,2416)x(3,2416,664)", (32, 3, 2416, 664), True),
                ("enc7 (32,3,1208)x(3,1208,1296)", (32, 3, 1208, 1296),
                 True),
                ("ragged (3,3,64)x(3,64,129) no bias", (3, 3, 64, 129),
                 False)):
            cases.append(("stmc_conv", shape, dt,
                          _stmc_case(*args, dt, dev, gen, bias=bias),
                          SC.stmc_conv, ref.stmc_conv))
    # one leaf as the parent launched a leaf; the kernel takes host ids
    copy_case = _copy_case(273, 16, 8, 128, torch.bfloat16, dev, gen)
    host_ids = [t.cpu() for t in copy_case[0][0][1:]]
    cases.append(("copy_pages", "one leaf (273,16,8,128), 4+4 pairs",
                  torch.bfloat16, copy_case,
                  lambda pool, _s, _d: PC.copy_pages(pool, *host_ids),
                  ref.copy_pages))
    main, chunk_recs, redesigned, family_recs = {}, [], [], []
    for (name, shape, dt, (sets, nbytes, flops, library, extra), kern,
         plain) in cases:
        kw = extra.get("kw", {})
        if kw:                         # the MLA kernels' scale, a window
            kern = functools.partial(kern, **kw)
            plain = functools.partial(plain, **kw)
        args = sets[0]
        if extra.get("inplace"):
            # in-place kernels: each version gets its own copy of the pool
            def fresh():
                return (args[0].clone(),) + tuple(args[1:])
        else:
            def fresh():
                return args
        got = kern(*fresh())
        torch.cuda.synchronize()
        want = plain(*fresh())
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got.float()).all()),
              f"{name} {shape}: non-finite")
        if extra.get("inplace"):
            check(torch.equal(got, want), f"{name} {shape}: not bit-exact")
        is_read = name in SPLIT_READS
        is_chunk = name in CHUNK_KERNELS
        tol = TOL[dt]
        if (is_read or is_chunk) and dt == torch.bfloat16:
            tol = min(tol, READ_REL_TOL * float(want.float().abs().max()))
        check(err < tol, f"{name} {shape} {dt}: max|Δ| {err} >= {tol}")
        check_only = extra.get("check_only", False)
        lib_err = None
        if library is not None and not check_only:
            lib = library(*fresh()).float()
            rows = extra.get("rows")
            if rows is not None:
                lib, ref_rows = lib[:, rows], want.float()[:, rows]
            else:
                ref_rows = want.float()
            lib_err = float((lib - ref_rows).abs().max())
        rec_extra = {"tol": tol}
        if is_read:
            if name == "paged_mla_decode_attention":
                plan = DA.paged_mla_launch_plan(args[0], args[1], args[4],
                                                args[5])
                groups = -(-args[0].shape[1] // DA.MLA_HEADS_PER_BLOCK)
                rec_extra["plan"] = {
                    "n_split": plan[0], "keys_per_split": plan[1],
                    "groups": groups,
                    "blocks": groups * plan[0] * args[0].shape[0]}
            elif len(args) == 5:
                plan = DA.launch_plan(args[0], args[1])
            else:
                plan = DA.paged_launch_plan(args[0], args[1], args[4])
            rec_extra["n_split"], rec_extra["keys_per_split"] = plan[:2]
            if shape.startswith("RG") or _family(shape):
                rec_extra["split_coverage_err"] = _split_coverage(
                    kern, plain, args, plan, f"{name} {shape} {dt}")
            rec_extra["host_ms"] = _host_ms(kern, sets, 100)
        if is_chunk and dt == torch.bfloat16:
            rec_extra.update(_chunk_walk(name, args, kw, got))
            if name == "chunk_attention":
                plan = CA.launch_plan(args[0], args[1])
                rec_extra["n_split"], rec_extra["keys_per_split"] = plan[:2]
        if name == "stmc_conv":
            win, w = args[0], args[1]
            rec_extra["plan"] = SC.stmc_plan(
                win.shape[0], win.shape[1] * win.shape[2], w.shape[2],
                dt)._asdict()
            rec_extra["host_ms"] = _host_ms(kern, sets, 100)
        if name == "lru_scan":
            rec_extra["plan"] = LS.launch_plan(args[0], args[1])._asdict()
            rec_extra["host_ms"] = _host_ms(kern, sets, 20)
        if (dt == torch.bfloat16 and (name == "flash_attention" or is_read
                                      or is_chunk)) or name in (
                                          "stmc_conv", "lru_scan"):
            # the tensor-core bodies, the cluster's split-K and the scan's
            # chains add in a fixed order (no atomics): a second launch on
            # the same inputs gives the same bits
            again = kern(*fresh())
            rec_extra["repeats_bit_for_bit"] = bool(torch.equal(got, again))
            check(rec_extra["repeats_bit_for_bit"],
                  f"{name} {shape}: bf16 results differ run to run")
        if "dense_view" in extra:
            # the paged read against the dense kernel over the same logical
            # rows (gathered), bit for bit: the same split, key order and
            # combine
            kd, vd, posd, _ = extra["dense_view"][args[1].data_ptr()]
            dense = DA.decode_attention(args[0], kd, vd, posd, args[5], **kw)
            rec_extra["equals_dense_kernel"] = bool(torch.equal(got, dense))
            check(rec_extra["equals_dense_kernel"],
                  f"{name} {shape} {dt}: not the dense kernel's read bit "
                  f"for bit")
        if extra.get("exact_f32") and dt == torch.float32:
            # the scan's product and sum round as the plain version's do
            rec_extra["equals_plain"] = bool(torch.equal(got, want))
            check(rec_extra["equals_plain"],
                  f"{name} {shape}: float32 not bit for bit the plain's")
        if check_only:
            print(f"  held, not timed: {name} {shape} {str(dt)[6:]}: "
                  f"max|Δ| {err:.2e} / {tol:.2e}; tiles skipped / walked "
                  f"again of all: {_walk_text(rec_extra)}", flush=True)
            continue
        # ms: device time per call from the profiler (the call's kernels,
        # host launch gaps excluded) — the plain version and the library
        # call spend more time in host dispatch than on the card, which
        # CUDA events over back-to-back calls would charge to them;
        # *_event_ms keep that view
        has_lib = library is not None
        event = {"event_ms": _time_ms(kern, sets, 50),
                 "plain_event_ms": _time_ms(plain, sets, 5),
                 "library_event_ms": (_time_ms(library, sets, 50)
                                      if has_lib else None)}
        parts = {}
        bound_ms, bound_by = _bound(nbytes, flops, dt)
        # the kernel and its plain version compute the row's function: a
        # reading under its bound is a profile that lost events. Every
        # reading sits between MARKERS spin kernels a side, and the
        # kernel's holds each of its device kernels once a call; the
        # parent's reading (no markers, no names) is kept beside it
        each = _call_kernels(name, dt, rec_extra.get("n_split", 1))
        dev_ms = {"ms": _device_ms(kern, sets, 20, parts, bound_ms=bound_ms,
                                   markers=MARKERS, each=each),
                  "plain_ms": _device_ms(plain, sets, 5, bound_ms=bound_ms,
                                         markers=MARKERS),
                  "library_ms": (_device_ms(library, sets, 20,
                                            markers=MARKERS)
                                 if has_lib else None)}
        rec_extra["ms_unmarked"] = _device_ms(kern, sets, 20)
        for key, val in dev_ms.items():
            if val is None:            # the profiler saw no device activity
                dev_ms[key] = event[key.replace("ms", "event_ms")]
        if (is_read or is_chunk) and parts:
            # the split kernel and the combine apart
            rec_extra["combine_ms"] = sum(
                v for k_, v in parts.items()
                if "decode_combine" in k_ or "chunk_combine" in k_)
            rec_extra["split_ms"] = sum(parts.values()) - rec_extra[
                "combine_ms"]
        rec = {"name": name, "shape": shape, "dtype": str(dt)[6:],
               "max_abs_err": err, **dev_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, **event,
               "library_max_abs_err": lib_err, "bytes": nbytes,
               "flops": flops, **rec_extra}
        print(json.dumps({"kernels": [rec]}), flush=True)
        if is_chunk:
            chunk_recs.append(rec)
        if _family(shape):
            family_recs.append(rec)
        if name in REDESIGNED:
            redesigned.append(rec)
        key = name + (f" ({_family(shape)})" if _family(shape) else
                      " (MLA)" if shape.startswith("MLA") else
                      " (RG middle)" if shape.startswith("RG middle") else
                      " (RG)" if shape.startswith("RG") else
                      " (middle)" if is_chunk and shape.startswith("middle")
                      else "")
        serving_dt = (torch.float32 if name in F32_PATHS
                      else torch.bfloat16)
        if dt == serving_dt and key not in main:
            main[key] = rec
    _chunk_table([r for r in chunk_recs if not _family(r["shape"])],
                 _build.build_info().log)
    _redesign_table(redesigned, _build.build_info().log)
    _family_table([r for r in family_recs if r["dtype"] == "bfloat16"],
                  _build.build_info().log)
    # a whole COW flush: qwen3's serving pools (28 layers, SOI 7..21: 14 on
    # the outer table's 273 pages, 14 on the middle's 193), k, v and pos;
    # then an MLA flush (latent, rope, pos) of 2 + 2 layers
    kv = ((16, 8, 128), torch.bfloat16)
    pos = ((16,), torch.int32)
    main["copy_pages"] = _cow_flush_reading(
        "qwen3 flush 28 layers x (k, v, pos)",
        [(273, 14, (kv, kv, pos)), (193, 14, (kv, kv, pos))], dev, gen)
    mla = (((16, 512), torch.bfloat16), ((16, 64), torch.bfloat16), pos)
    _cow_flush_reading("MLA flush 4 layers x (latent, rope, pos)",
                       [(273, 2, mla), (193, 2, mla)], dev, gen)
    _unet_conv_sweep(dev, gen)
    return main


# ---------------------------------------------------------------------------
# 4. end-to-end parity, card vs CPU
# ---------------------------------------------------------------------------

def _parity_cfg(mode):
    from repro_torch.configs import qwen3_1_7b
    from repro_torch.configs.base import SOILMCfg
    full = qwen3_1_7b.config(soi=mode)
    seg = dataclasses.replace(full.segments[0], n_layers=4)
    return dataclasses.replace(
        full, segments=(seg,), dtype="float32",
        soi=SOILMCfg(first_layer=1, last_layer=3, mode=mode))


def _greedy(engine, params, prompts, n_steps=8, late_at=3, frames=None):
    """Slots 0 and 1 from the start, slot 2 after ``late_at`` steps,
    greedy; ``frames`` gives each request its encoder frames. Returns per
    step (logits of the active slots, their tokens, the active slots)."""
    ds = engine.init_decode_state(params)
    steps = []
    active = []
    frames = frames or [None] * 3

    def prefill(slot):
        return engine.prefill(params, prompts[slot],
                              encoder_frames=frames[slot])
    for slot in (0, 1):
        ds = engine.insert(prefill(slot), ds, slot)
        active.append(slot)
    for k in range(n_steps):
        if k == late_at:
            ds = engine.insert(prefill(2), ds, 2)
            active.append(2)
        ds, res = engine.generate(params, ds)
        toks = res.convert_to_numpy().data[:, 0]
        steps.append((res.logits[active].float().cpu(),
                      [int(toks[s]) for s in active], list(active)))
    return steps


# HOST_RUN: the card-vs-CPU phases (7, 10, 18, 19) run the host once, dense,
# and hold the card's dense and paged runs to it: on the plain reads the
# host's paged engine is its dense one bit for bit (the reads gather the
# pages, then compute as the dense read does;
# tests/test_torch_paged.py::test_paged_engine_bit_exact_vs_dense_engine),
# and the host's runs are most of these phases' time


def _compare_runs(runs, label):
    """Tokens identical and logits within 1e-3 at every step of a
    (CPU run, card run) pair; returns the largest logit difference."""
    worst = 0.0
    for k, ((lc, tc, act), (lg, tg, _)) in enumerate(zip(*runs)):
        err = float((lc - lg).abs().max())
        worst = max(worst, err)
        if tc != tg:
            top = torch.topk(lc, 2, dim=-1).values
            gaps = (top[:, 0] - top[:, 1]).tolist()
            raise RuntimeError(
                f"parity {label} step {k}: tokens differ (cpu {tc}, cuda "
                f"{tg}, slots {act}); top-2 logit gaps on the CPU {gaps}")
        check(err < 1e-3, f"parity {label} step {k}: logits differ by "
                          f"{err} >= 1e-3")
    return worst


def parity_phase(dev) -> dict:
    """Returns the launch counts of the paged prefix-cache engine's card
    run (the path that copies pages on write)."""
    phase("4 parity (full-width qwen3, 4 layers, f32, card vs CPU)")
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    paged_counts = None
    for mode in ("pp", "fp"):
        cfg = _parity_cfg(mode)
        dev_model = T.init(cfg, generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
        cpu_model = _cpu_copy(dev_model, cfg)
        gen = torch.Generator().manual_seed(2)
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                                 dtype=torch.int32) for n in (200, 201, 150)]
        runs = []
        for where, model in ((torch.device("cpu"), cpu_model),
                             (dev, dev_model)):
            eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=256,
                            device=where)
            t0 = time.perf_counter()
            runs.append(_greedy(eng, model, [p.to(where) for p in prompts]))
            print(f"  {mode} {where}: 3 prefills + 8 steps in "
                  f"{time.perf_counter() - t0:.2f} s (host clock)")
        worst = _compare_runs(runs, mode)
        print(f"  {mode}: 8 steps, tokens identical, max|Δlogit| {worst:.3e}")
        if mode == "pp":
            # paged + chunked + prefix cache: 3 prompts sharing 128 tokens,
            # 66 steps, so each ring wraps (position 256, frame 128) onto
            # pages the index still shares and copies them on write
            shared = prompts[0][:128]
            pp = [torch.cat([shared, torch.randint(
                0, cfg.vocab, (n - 128,), generator=gen, dtype=torch.int32)])
                for n in (200, 201, 199)]
            runs, stats, flushes = [], [], []
            for where, model in ((torch.device("cpu"), cpu_model),
                                 (dev, dev_model)):
                eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=256,
                                device=where, paged=True, page_size=16,
                                prefill_chunk=64, prefix_cache=True)
                if where.type == "cuda":
                    ops.reset_launch_counts()
                t0 = time.perf_counter()
                runs.append(_greedy(eng, model, [p.to(where) for p in pp],
                                    n_steps=66))
                if where.type == "cuda":
                    torch.cuda.synchronize(dev)
                    paged_counts = ops.launch_counts()
                stats.append(eng.prefix_cache_stats)
                flushes.append(eng.cow_flushes)
                print(f"  paged {where}: 3 chunked prefills + 66 steps in "
                      f"{time.perf_counter() - t0:.2f} s (host clock); "
                      f"prefix cache {stats[-1]}; {flushes[-1]} COW flushes")
            worst = _compare_runs(runs, "paged pp")
            check(stats[0] == stats[1], f"prefix-cache counters differ: cpu "
                                        f"{stats[0]}, cuda {stats[1]}")
            check(stats[1]["hits"] == 2 and stats[1]["cow_copies"] > 0,
                  f"expected 2 hits and copies on write: {stats[1]}")
            # one copy_pages launch a COW flush, every pool leaf in it
            check(paged_counts["copy_pages"] == flushes[1] == flushes[0] > 0,
                  f"copy_pages launches {paged_counts['copy_pages']} != COW "
                  f"flushes (cpu {flushes[0]}, cuda {flushes[1]})")
            check(paged_counts["chunk_attention"] > 0
                  and paged_counts["paged_decode_attention"] > 0,
                  f"paged run launches {paged_counts}")
            check(paged_counts["decode_attention"] == 0
                  and paged_counts["flash_attention"] == 0,
                  f"the paged chunked run used a dense kernel: "
                  f"{paged_counts}")
            print(f"  paged pp: 66 steps, tokens identical, max|Δlogit| "
                  f"{worst:.3e}; card launches {paged_counts}")
        del cpu_model, dev_model
    return paged_counts


# ---------------------------------------------------------------------------
# 5. serve
# ---------------------------------------------------------------------------

# the plain serve runs' tokens (phases 5 and 6), which the speculative
# serves of phase 15 must equal
PLAIN_SEQS: dict = {}
# the kernels phase 15's speculative serves launch, and which run's count
# the kernels line gives
SPEC_PATHS = {"decode_attention": "dense",
              "paged_decode_attention": "paged",
              "copy_pages": "paged"}


def serve_phase(dev):
    phase("5 serve (qwen3-1.7b full width, SOI pp, 4 requests)")
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = configs.get("qwen3-1.7b", soi="pp")
    torch.cuda.reset_peak_memory_stats(dev)
    args = serve.parse_args(SERVE_ARGV)
    ops.reset_launch_counts()
    res = serve.run(args)
    counts = ops.launch_counts()
    n_req = len(res.seqs)
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    want_flash = cfg.n_layers * n_req
    want_decode = n_outer * res.steps + n_mid * res.mid_steps
    print(f"  prefill {res.prefill_s:.3f} s for {n_req} requests, decode "
          f"{res.decoded} tokens in {res.decode_s:.3f} s = "
          f"{res.decoded / res.decode_s:.1f} tok/s (host clock); "
          f"{res.steps} steps, {res.mid_steps} with the middle; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"  launches {counts}; expected flash_attention {want_flash}, "
          f"decode_attention {want_decode}")
    check(res.seqs.shape == (4, 64), f"tokens shape {res.seqs.shape}")
    check(((res.seqs >= 0) & (res.seqs < cfg.vocab)).all(),
          "token ids outside [0, vocab)")
    check(counts["flash_attention"] == want_flash,
          f"flash_attention launches {counts['flash_attention']} != "
          f"{want_flash}")
    check(counts["decode_attention"] == want_decode,
          f"decode_attention launches {counts['decode_attention']} != "
          f"{want_decode}")
    PLAIN_SEQS["dense"] = res.seqs
    # the same traffic again under the profiler (CUDA activity only; the
    # weights are built before it starts): device busy and idle share of
    # the prefill window and of the decode loop, which starts after the
    # last prefill kernel; kernel time by name over each window
    print("  profiled rerun:")
    _cfg, params, prompt, plens, engine = serve.setup(args)
    ev = _device_events(lambda: serve.serve(engine, params, prompt, plens,
                                            args.gen_len))
    check(ev, "the profiler saw no device activity")
    _prefill_profile(ev, n_req, "flash_attention_kernel")
    _decode_profile(ev, res.steps, "flash_attention_kernel")
    del params, engine
    return counts


def _named(name: str, kernels) -> bool:
    """Is the device event ``name`` one of ``kernels`` (a name or a tuple
    of names)?"""
    kernels = (kernels,) if isinstance(kernels, str) else kernels
    return any(k in name for k in kernels)


def _prefill_profile(ev, n_req: int, kernel):
    """Device busy time and idle share of a serve run's prefill window,
    from its first device event to the end of the last ``kernel`` (the
    prefill attention: a name or a tuple of names, e.g. a kernel and its
    merge), kernel time by name over it, and ``kernel``'s own device time
    in it; returns that time a request, in ms."""
    prefill_end = max(e for _s, e, n in ev if _named(n, kernel))
    window = [(s_, min(e, prefill_end), n) for s_, e, n in ev
              if s_ < prefill_end]
    busy = _window_profile(window, n_req, "prefill", "request")
    mine = sum(e - s_ for s_, e, n in window if _named(n, kernel))
    label = kernel if isinstance(kernel, str) else " + ".join(kernel)
    print(f"  {label} in the prefill window: {mine / 1e3:.3f} ms on the "
          f"device, {mine / busy:.3f} of its busy time, "
          f"{mine / 1e3 / n_req:.4f} ms a request")
    return mine / 1e3 / n_req


def _decode_profile(ev, steps: int, prefill_kernel):
    """Device busy time and idle share of a serve run's decode loop, which
    starts after the last ``prefill_kernel`` (a name or a tuple of names);
    kernel time by name over that window. Returns the loop's device
    events."""
    prefill_end = max(e for _s, e, n in ev if _named(n, prefill_kernel))
    loop = [(s_, e, n) for s_, e, n in ev if s_ >= prefill_end]
    _window_profile(loop, steps, "decode", "step")
    return loop


# the decode reads' device kernels: the split body (bf16 or float32) and
# the combine
READ_KERNELS = {"split": ("decode_mma_kernel", "decode_scalar_kernel"),
                "combine": ("decode_combine_kernel",)}
# the paged MLA read's: its split body (both dtypes share the name) and
# the same combine
MLA_READ_KERNELS = {"split": ("paged_mla_decode_attention_kernel",),
                    "combine": ("decode_combine_kernel",)}


def _reads_per_step(loop, steps: int, label: str,
                    kernels=READ_KERNELS) -> float:
    """Print and return the decode reads' device ms per step in a decode
    loop's events, split kernel and combine apart."""
    ms = {part: sum(e - s_ for s_, e, n in loop
                    if any(k in n for k in needles)) / 1e3
          for part, needles in kernels.items()}
    total = sum(ms.values())
    check(total > 0, f"{label}: no decode read in the decode loop")
    print(f"  {label} decode reads: {total:.3f} ms on the device in "
          f"{steps} steps = {total / steps:.4f} ms a step (split "
          f"{ms['split'] / steps:.4f}, combine {ms['combine'] / steps:.4f})")
    return total / steps


def _window_profile(ev, n: int, label: str, unit: str):
    """Print the device busy time and idle share of the window the device
    events ``ev`` span, busy time per ``unit`` (``n`` of them), and kernel
    time by name; returns the busy µs."""
    window = max(e for _s, e, _n in ev) - min(s_ for s_, _e, _n in ev)
    busy = _busy_us([(s_, e) for s_, e, _n in ev])
    by_name: dict = {}
    for s_, e, name in ev:
        key = name.removeprefix("void ")[:70]
        by_name[key] = by_name.get(key, 0.0) + (e - s_)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  {label} window {window / 1e3:.2f} ms on the device clock, "
          f"busy {busy / 1e3:.2f} ms, idle share {1 - busy / window:.3f}; "
          f"per {unit} busy {busy / 1e3 / n:.3f} ms")
    for key, us in top:
        print(f"    {us / 1e3:9.3f} ms  {key}")
    return busy


@torch.no_grad()
def _warm_equals_cold(args, cold_args, cfg=None):
    """The random model's greedy tokens barely vary, so hold the bits
    instead: request 1 of the serve traffic (a hit at 768 tokens) prefills
    to the same logits and prefill caches with the prefix cache as without,
    and one generate step over requests 0 and 1 (one reading shared pages)
    gives the same logits. ``cfg`` replaces the config ``--arch`` names."""
    from repro_torch.launch import serve
    out = []
    for a in (args, cold_args):
        _cfg, params, prompt, plens, engine = serve.setup(a, cfg)
        ds = engine.init_decode_state(params)
        prefixes = []
        for slot in (0, 1):
            prefixes.append(engine.prefill(params, prompt[slot, :plens[slot]]))
            ds = engine.insert(prefixes[-1], ds, slot)
        _ds, res = engine.generate(params, ds)
        out.append((prefixes[1], res.logits[:2].clone(),
                    engine.prefix_cache_stats["hits"]))
        del params, ds, _ds
    (pw, lw, hits), (pc, lc, _) = out
    check(hits == 1, f"request 1 did not hit the prefix cache ({hits})")
    check(torch.equal(pw.logits, pc.logits),
          "a hit's prefill logits differ from the cold prefill's")
    for group in ("pre", "mid", "post"):
        for i, (cw, cc) in enumerate(zip(pw.state[group], pc.state[group])):
            for name in cc:              # k, v, pos / latent, rope, pos
                check(torch.equal(cw[name], cc[name]),
                      f"prefill cache {group}[{i}].{name}: warm != cold")
    for name in ("conv_buf", "queue"):
        check(torch.equal(pw.state[name], pc.state[name]),
              f"prefill {name}: warm != cold")
    check(torch.equal(lw, lc), "decode logits over shared pages differ "
                               "from the cold run's")
    print("  bit for bit with the cold run: a hit's prefill logits, caches, "
          "conv window and queue, and a decode step's logits")


def paged_serve_phase(dev):
    phase("6 paged serve (qwen3-1.7b full width, SOI pp, --paged "
          "--chunk-size 256 --prefix-cache, shared prefix 768)")
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = configs.get("qwen3-1.7b", soi="pp")
    args = serve.parse_args(PAGED_ARGV + ["--prefix-cache"])
    cold_args = serve.parse_args(PAGED_ARGV)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = serve.run(args)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    chunk = 256
    # the miss computes every chunk of its prompt; a hit at 768 computes
    # the chunks past it (one, for prompts of 1018..1022 tokens)
    plens = res.plens
    hit_at = 768
    want_chunks = (-(-plens[0] // chunk)
                   + sum(-(-p // chunk) - hit_at // chunk for p in plens[1:]))
    want_chunk = (n_outer + n_mid) * want_chunks
    want_paged = n_outer * res.steps + n_mid * res.mid_steps
    pc = res.prefix_cache
    print(f"  prefill {res.prefill_s:.3f} s for {len(res.seqs)} requests, "
          f"decode {res.decoded} tokens in {res.decode_s:.3f} s = "
          f"{res.decoded / res.decode_s:.1f} tok/s (host clock); "
          f"{res.steps} steps, {res.mid_steps} with the middle; peak device "
          f"memory {peak:.2f} GiB")
    print(f"  prefix cache {pc}; pools {res.pools}")
    print(f"  launches {counts}; expected chunk_attention {want_chunk} "
          f"({want_chunks} chunks x {n_outer + n_mid} layers), "
          f"paged_decode_attention {want_paged}, copy_pages "
          f"{res.cow_flushes} (COW flushes)")
    check(res.seqs.shape == (4, 64), f"tokens shape {res.seqs.shape}")
    check(((res.seqs >= 0) & (res.seqs < cfg.vocab)).all(),
          "token ids outside [0, vocab)")
    check(pc["hits"] == 3 and pc["misses"] == 1
          and pc["tokens_skipped"] == 3 * hit_at,
          f"prefix-cache counters {pc}")
    check(want_chunk == 196 and counts["chunk_attention"] == want_chunk,
          f"chunk_attention launches {counts['chunk_attention']} != "
          f"{want_chunk}")
    check(counts["paged_decode_attention"] == want_paged,
          f"paged_decode_attention launches "
          f"{counts['paged_decode_attention']} != {want_paged}")
    check(counts["decode_attention"] == 0 and counts["flash_attention"] == 0,
          f"the paged chunked path launched a dense kernel: {counts}")
    check(counts["copy_pages"] == res.cow_flushes,
          f"copy_pages launches {counts['copy_pages']} != COW flushes "
          f"{res.cow_flushes}")
    PLAIN_SEQS["paged"] = res.seqs
    cold = serve.run(cold_args)
    check(cold.prefix_cache == {} and (cold.seqs == res.seqs).all(),
          "tokens with the prefix cache differ from the cold run")
    print(f"  tokens identical to the cold run (no prefix cache: prefill "
          f"{cold.prefill_s:.3f} s, decode "
          f"{cold.decoded / cold.decode_s:.1f} tok/s, host clock)")
    _warm_equals_cold(args, cold_args)
    print("  profiled rerun:")
    ev = _device_events(lambda: serve.run(args))
    check(ev, "the profiler saw no device activity")
    # the chunks' range kernel and, split, their merge
    chunk = ("chunk_attention_kernel", "chunk_combine_kernel")
    _prefill_profile(ev, len(res.seqs), chunk)
    _decode_profile(ev, res.steps, chunk)
    return counts


# ---------------------------------------------------------------------------
# 7-9. deepseek-v2: MLA and MoE on the SOI engine
# ---------------------------------------------------------------------------

STAGE_BYTES = 256 * 2 ** 20
_STAGE = []


def _to_host(x):
    """``x.to("cpu")``, through one pinned staging buffer a chunk at a time:
    the card writes pinned memory at its link's rate, and the host's copy
    out of it is spread over its threads (a copy straight into fresh
    pageable memory was most of the card-vs-CPU phases' set-up)."""
    if x.device.type != "cuda" or not x.is_contiguous() or not x.numel():
        return x.to("cpu")
    if not _STAGE:
        _STAGE.append(torch.empty(STAGE_BYTES, dtype=torch.uint8,
                                  pin_memory=True))
    stage = _STAGE[0]
    out = torch.empty(x.shape, dtype=x.dtype)
    src, dst = x.view(-1).view(torch.uint8), out.view(-1).view(torch.uint8)
    for i in range(0, src.numel(), STAGE_BYTES):
        n = min(STAGE_BYTES, src.numel() - i)
        stage[:n].copy_(src[i:i + n])
        dst[i:i + n].copy_(stage[:n])
    return out


def _cpu_copy(model, cfg):
    """The same weights on the host (built on the card, where random init
    is fast, and copied)."""
    from repro_torch.models import transformer as T
    cpu = T.Transformer(cfg, generator=torch.Generator(), device="meta")
    cpu.load_state_dict({k: _to_host(v) for k, v in
                         model.state_dict().items()}, assign=True)
    return cpu


def _free(dev):
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()


def deepseek_parity_phase(dev) -> dict:
    """Returns the launch counts of the paged engine's card run."""
    phase("7 ds-parity (full-width deepseek-v2, 2 layers: dense layer 0 + "
          "one MoE middle, f32, SOI pp, card vs CPU)")
    from repro_torch.configs import deepseek_v2_236b as DS
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(DS.config(soi="pp", n_layers=2),
                              dtype="float32")
    t0 = time.perf_counter()
    dev_model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(1), device=dev)
    cpu_model = _cpu_copy(dev_model, cfg)
    n_par = sum(p.numel() for p in dev_model.parameters())
    print(f"  {n_par / 1e9:.2f} B float32 parameters, 160 routed experts "
          f"(no cut), on the card and on the host "
          f"({time.perf_counter() - t0:.1f} s to build and copy)")
    gen = torch.Generator().manual_seed(2)
    # odd prompt lengths: one MoE dispatch group, so the host's expert
    # products stay small (the card's are the same computation)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                             dtype=torch.int32) for n in (41, 43, 37)]
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    out = {}
    host = None
    for layout, kw in (("dense", {}),
                       ("paged", dict(paged=True, page_size=16))):
        runs = []
        for where, model in ((torch.device("cpu"), cpu_model),
                             (dev, dev_model)):
            if where.type == "cpu" and host is not None:
                runs.append(host)     # the host's dense run: see HOST_RUN
                continue
            eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=64,
                            device=where, **kw)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            runs.append(_greedy(eng, model, [p.to(where) for p in prompts]))
            torch.cuda.synchronize(dev)
            counts = ops.launch_counts()          # the card run's, last
            print(f"  {layout} {where}: 3 prefills + 8 steps in "
                  f"{time.perf_counter() - t0:.2f} s (host clock)")
        host = runs[0]
        worst = _compare_runs(runs, f"deepseek {layout}")
        want_paged = (n_outer * eng.steps + n_mid * eng.mid_steps
                      if layout == "paged" else 0)
        print(f"  {layout}: 8 steps, tokens identical, max|Δlogit| "
              f"{worst:.3e}; card launches {counts}")
        check(counts["flash_attention"] == 3 * cfg.n_layers,
              f"flash_attention launches {counts['flash_attention']} != "
              f"{3 * cfg.n_layers} (3 prefills x {cfg.n_layers} layers)")
        check(counts["paged_mla_decode_attention"] == want_paged,
              f"paged_mla_decode_attention launches "
              f"{counts['paged_mla_decode_attention']} != {want_paged}")
        out[layout] = counts
    del cpu_model, dev_model
    _free(dev)
    return out["paged"]


DS_SERVE_ARGV = ["--arch", "deepseek-v2-236b", "--layers", "4", "--soi",
                 "pp", "--batch", "4", "--prompt-len", "1024", "--stagger",
                 "2", "--gen-len", "64", "--seed", "0", "--paged",
                 "--page-size", "16"]


@torch.no_grad()
def _insert_all(engine, params, prompt, plens, frames=None):
    """A fresh decode state with request i (``prompt[i, :plens[i]]``, its
    encoder frames ``frames[i]`` where given) in slot i."""
    ds = engine.init_decode_state(params)
    frames = frames or [None] * len(plens)
    for slot, n in enumerate(plens):
        ds = engine.insert(engine.prefill(params, prompt[slot, :n],
                                          encoder_frames=frames[slot]),
                           ds, slot)
    return ds


def _phase_step_ms(engine, params, prompt, plens, n_steps=16, frames=None):
    """Prefill every request, then time ``n_steps`` generate steps one by
    one (host clock, each ended by a synchronize); returns the median ms
    of the steps that ran the SOI middle and of those that skipped it (a
    config without SOI: the median of all, and None)."""
    ds = _insert_all(engine, params, prompt, plens, frames)
    torch.cuda.synchronize(engine.device)
    on, off = [], []
    for _ in range(n_steps):
        mid0 = engine.mid_steps
        t0 = time.perf_counter()
        ds, _res = engine.generate(params, ds)
        torch.cuda.synchronize(engine.device)
        (on if engine.mid_steps > mid0 else off).append(
            (time.perf_counter() - t0) * 1e3)
    if engine.cfg.soi is None:
        return sorted(on)[len(on) // 2], None
    check(on and off, f"steps with the middle {len(on)}, without {len(off)}")
    return sorted(on)[len(on) // 2], sorted(off)[len(off) // 2]


def deepseek_serve_phase(dev) -> dict:
    phase("8 ds-serve (deepseek-v2 full width, 4 layers = 1 dense + 3 MoE, "
          "bf16, SOI pp, --paged --page-size 16, exact-length prefill)")
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parse_args(DS_SERVE_ARGV)
    t0 = time.perf_counter()
    cfg, params, prompt, plens, engine = serve.setup(args)
    torch.cuda.synchronize(dev)
    print(f"  {sum(p.numel() for p in params.parameters()) / 1e9:.2f} B "
          f"bf16 parameters built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = serve.serve(engine, params, prompt, plens, args.gen_len)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    want_flash = cfg.n_layers * len(res.seqs)
    want_paged = n_outer * res.steps + n_mid * res.mid_steps
    print(f"  prefill {res.prefill_s:.3f} s for {len(res.seqs)} requests "
          f"(lens {plens}), decode {res.decoded} tokens in "
          f"{res.decode_s:.3f} s = {res.decoded / res.decode_s:.1f} tok/s "
          f"(host clock); {res.steps} steps, {res.mid_steps} with the "
          f"middle; peak device memory {peak:.2f} GiB; pools {res.pools}")
    print(f"  launches {counts}; expected flash_attention {want_flash} "
          f"({cfg.n_layers} layers x {len(res.seqs)} requests), "
          f"paged_mla_decode_attention {want_paged} ({n_outer} outer "
          f"layers x {res.steps} steps + {n_mid} middle x {res.mid_steps})")
    check(res.seqs.shape == (4, 64), f"tokens shape {res.seqs.shape}")
    check(((res.seqs >= 0) & (res.seqs < cfg.vocab)).all(),
          "token ids outside [0, vocab)")
    check(want_flash == 16 and counts["flash_attention"] == want_flash,
          f"flash_attention launches {counts['flash_attention']} != 16")
    check(want_paged == 192
          and counts["paged_mla_decode_attention"] == want_paged,
          f"paged_mla_decode_attention launches "
          f"{counts['paged_mla_decode_attention']} != 192")
    others = {k: v for k, v in counts.items()
              if k not in ("flash_attention", "paged_mla_decode_attention")}
    check(not any(others.values()), f"unexpected launches {others}")
    on, off = _phase_step_ms(engine, params, prompt, plens)
    print(f"  step time (host clock after a synchronize, median): "
          f"{on:.3f} ms with the SOI middle (phase 0), {off:.3f} ms "
          f"without; ratio {on / off:.3f}")
    print("  profiled rerun:")
    ev = _device_events(lambda: serve.serve(engine, params, prompt, plens,
                                            args.gen_len))
    check(ev, "the profiler saw no device activity")
    _prefill_profile(ev, len(res.seqs), "flash_attention_kernel")
    loop = _decode_profile(ev, res.steps, "flash_attention_kernel")
    _reads_per_step(loop, res.steps, "paged MLA", MLA_READ_KERNELS)
    del params, engine
    _free(dev)
    return counts


MLA_ARGV = ["--arch", "deepseek-v2-236b", "--soi", "pp", "--batch", "4",
            "--prompt-len", "1024", "--stagger", "2", "--gen-len", "64",
            "--seed", "0", "--paged", "--page-size", "16", "--chunk-size",
            "256", "--shared-prefix", "768"]


def mla_phase(dev) -> tuple:
    """Returns the launch counts of the card's parity run (the path whose
    rings wrap and copy MLA pages on write) and of the serve run."""
    phase("9 mla (deepseek-v2 layer-0 block: MLA + SwiGLU 12288, full "
          "width, SOI pp, chunked prefill + prefix cache)")
    from repro_torch.configs import deepseek_v2_236b as DS
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    # card against CPU, f32, 2 layers: 3 prompts of ~100 tokens sharing
    # their first 64, 34 steps, so every ring wraps (position 128, frame 64)
    # onto pages the index still shares and copies latent/rope/pos pages
    cfg = dataclasses.replace(DS.mla_dense_config(soi="pp", n_layers=2),
                              dtype="float32")
    dev_model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(3), device=dev)
    cpu_model = _cpu_copy(dev_model, cfg)
    gen = torch.Generator().manual_seed(4)
    shared = torch.randint(0, cfg.vocab, (64,), generator=gen,
                           dtype=torch.int32)
    prompts = [torch.cat([shared, torch.randint(
        0, cfg.vocab, (n - 64,), generator=gen, dtype=torch.int32)])
        for n in (100, 101, 99)]
    runs, stats, flushes = [], [], []
    for where, model in ((torch.device("cpu"), cpu_model), (dev, dev_model)):
        eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=128,
                        device=where, paged=True, page_size=16,
                        prefill_chunk=32, prefix_cache=True)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        runs.append(_greedy(eng, model, [p.to(where) for p in prompts],
                            n_steps=34))
        torch.cuda.synchronize(dev)
        cow_counts = ops.launch_counts()          # the card run's, last
        stats.append(eng.prefix_cache_stats)
        flushes.append(eng.cow_flushes)
        print(f"  parity {where}: 3 chunked prefills + 34 steps in "
              f"{time.perf_counter() - t0:.2f} s (host clock); prefix cache "
              f"{stats[-1]}; {flushes[-1]} COW flushes")
    worst = _compare_runs(runs, "mla paged")
    check(stats[0] == stats[1], f"prefix-cache counters differ: cpu "
                                f"{stats[0]}, cuda {stats[1]}")
    check(stats[1]["hits"] == 2 and stats[1]["cow_copies"] > 0,
          f"expected 2 hits and copies on write: {stats[1]}")
    check(cow_counts["copy_pages"] == flushes[1] == flushes[0] > 0,
          f"copy_pages launches {cow_counts['copy_pages']} != COW flushes "
          f"(cpu {flushes[0]}, cuda {flushes[1]})")
    check(cow_counts["mla_chunk_attention"] > 0
          and cow_counts["paged_mla_decode_attention"] > 0,
          f"parity run launches {cow_counts}")
    gqa = ("decode_attention", "flash_attention", "chunk_attention",
           "paged_decode_attention")
    check(not any(cow_counts[k] for k in gqa),
          f"the MLA run launched a GQA kernel: {cow_counts}")
    print(f"  parity: 34 steps, tokens identical, max|Δlogit| {worst:.3e}; "
          f"card launches {cow_counts} (copy_pages on the latent, rope and "
          f"pos pools)")
    del cpu_model, dev_model
    _free(dev)

    cfg = DS.mla_dense_config(soi="pp", n_layers=4)
    args = serve.parse_args(MLA_ARGV + ["--prefix-cache"])
    cold_args = serve.parse_args(MLA_ARGV)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = serve.run(args, cfg)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    chunk, hit_at = 256, 768
    plens = res.plens
    want_chunks = (-(-plens[0] // chunk)
                   + sum(-(-p // chunk) - hit_at // chunk for p in plens[1:]))
    want_chunk = cfg.n_layers * want_chunks
    want_paged = n_outer * res.steps + n_mid * res.mid_steps
    pc = res.prefix_cache
    print(f"  serve, 4 bf16 layers: prefill {res.prefill_s:.3f} s for "
          f"{len(res.seqs)} requests, decode {res.decoded} tokens in "
          f"{res.decode_s:.3f} s = {res.decoded / res.decode_s:.1f} tok/s "
          f"(host clock); {res.steps} steps, {res.mid_steps} with the "
          f"middle; peak device memory {peak:.2f} GiB")
    print(f"  prefix cache {pc}; pools {res.pools}")
    print(f"  launches {counts}; expected mla_chunk_attention {want_chunk} "
          f"({want_chunks} chunks x {cfg.n_layers} layers), "
          f"paged_mla_decode_attention {want_paged}")
    check(res.seqs.shape == (4, 64), f"tokens shape {res.seqs.shape}")
    check(pc["hits"] == 3 and pc["misses"] == 1
          and pc["tokens_skipped"] == 3 * hit_at,
          f"prefix-cache counters {pc}")
    check(want_chunk == 28 and counts["mla_chunk_attention"] == want_chunk,
          f"mla_chunk_attention launches {counts['mla_chunk_attention']} "
          f"!= 28")
    check(counts["paged_mla_decode_attention"] == want_paged,
          f"paged_mla_decode_attention launches "
          f"{counts['paged_mla_decode_attention']} != {want_paged}")
    check(not any(counts[k] for k in gqa),
          f"the MLA serve launched a GQA kernel: {counts}")
    check(counts["copy_pages"] == res.cow_flushes,
          f"copy_pages launches {counts['copy_pages']} != COW flushes "
          f"{res.cow_flushes}")
    cold = serve.run(cold_args, cfg)
    check(cold.prefix_cache == {} and (cold.seqs == res.seqs).all(),
          "tokens with the prefix cache differ from the cold run")
    print(f"  tokens identical to the cold run (no prefix cache: prefill "
          f"{cold.prefill_s:.3f} s, decode "
          f"{cold.decoded / cold.decode_s:.1f} tok/s, host clock)")
    _warm_equals_cold(args, cold_args, cfg)
    print("  profiled rerun:")
    ev = _device_events(lambda: serve.run(args, cfg))
    check(ev, "the profiler saw no device activity")
    _prefill_profile(ev, len(res.seqs), "mla_chunk_attention_kernel")
    _decode_profile(ev, res.steps, "mla_chunk_attention_kernel")
    _free(dev)
    return cow_counts, counts


# ---------------------------------------------------------------------------
# 10-11. recurrentgemma: RG-LRU and windowed MQA on the SOI engine
# ---------------------------------------------------------------------------

def _rg_counts(cfg):
    """(outer attention layers, middle attention layers, RG-LRU layers) of
    an SOI config."""
    from repro_torch.models import transformer as T
    parts = T.soi_partition(cfg)
    blocks = [T.layer_blocks(dataclasses.replace(cfg, segments=tuple(p)))
              for p in parts]
    n_att = [sum(b.attn is not None for b in bl) for bl in blocks]
    n_rec = sum(b.rglru is not None for b in T.layer_blocks(cfg))
    return n_att[0] + n_att[2], n_att[1], n_rec


RG_PARITY_LAYERS = 9


def rg_parity_phase(dev) -> dict:
    """Returns the launch counts of the paged pp engine's card run."""
    phase(f"10 rg-parity (full-width recurrentgemma-9b, {RG_PARITY_LAYERS} "
          f"layers, f32, SOI pp/fp, dense and paged, card vs CPU)")
    from repro_torch.configs import recurrentgemma_9b as RG
    from repro_torch.configs.base import SOILMCfg
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    # the config's own SOI span at 9 layers leaves no pre segment: one
    # pattern a segment instead
    cfgs = {mode: dataclasses.replace(
        RG.config(soi=mode, n_layers=RG_PARITY_LAYERS), dtype="float32",
        soi=SOILMCfg(first_layer=3, last_layer=6, mode=mode))
            for mode in ("pp", "fp")}
    t0 = time.perf_counter()
    dev_model = T.init(cfgs["pp"], generator=torch.Generator(device=dev)
                       .manual_seed(5), device=dev)
    cpu_model = _cpu_copy(dev_model, cfgs["pp"])
    n_par = sum(p.numel() for p in dev_model.parameters())
    soi = cfgs["pp"].soi
    print(f"  {n_par / 1e9:.2f} B float32 parameters (SOI pre "
          f"0..{soi.first_layer - 1}, middle {soi.first_layer}.."
          f"{soi.last_layer - 1}, post {soi.last_layer}.."
          f"{RG_PARITY_LAYERS - 1}), on the card "
          f"and on the host "
          f"({time.perf_counter() - t0:.1f} s to build and copy)")
    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, cfgs["pp"].vocab, (n,), generator=gen,
                             dtype=torch.int32) for n in (41, 43, 37)]
    n_outer, n_mid, n_rec = _rg_counts(cfgs["pp"])
    out = {}
    for mode, cfg in cfgs.items():
        host = None
        for layout, kw in (("dense", {}),
                           ("paged", dict(paged=True, page_size=16))):
            runs = []
            for where, model in ((torch.device("cpu"), cpu_model),
                                 (dev, dev_model)):
                if where.type == "cpu" and host is not None:
                    runs.append(host)     # the host's dense run: see HOST_RUN
                    continue
                eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=64,
                                device=where, **kw)
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                runs.append(_greedy(eng, model,
                                    [p.to(where) for p in prompts]))
                torch.cuda.synchronize(dev)
                counts = ops.launch_counts()      # the card run's, last
                print(f"  {mode} {layout} {where}: 3 prefills + 8 steps in "
                      f"{time.perf_counter() - t0:.2f} s (host clock)")
            host = runs[0]
            worst = _compare_runs(runs, f"recurrentgemma {mode} {layout}")
            read = ("paged_decode_attention" if layout == "paged"
                    else "decode_attention")
            want = {"lru_scan": 3 * n_rec,
                    read: n_outer * eng.steps + n_mid * eng.mid_steps}
            print(f"  {mode} {layout}: 8 steps, tokens identical, "
                  f"max|Δlogit| {worst:.3e}; card launches {counts}")
            for name, n in counts.items():
                check(n == want.get(name, 0),
                      f"{mode} {layout}: {name} launches {n} != "
                      f"{want.get(name, 0)} (expected {want})")
            out[(mode, layout)] = counts
    del cpu_model, dev_model
    _free(dev)
    return out[("pp", "paged")]


RG_ARGV = ["--arch", "recurrentgemma-9b", "--soi", "pp", "--batch", "4",
           "--prompt-len", "2040", "--stagger", "2", "--gen-len", "64",
           "--seed", "0"]


def rg_serve_phase(dev) -> dict:
    """Returns {"dense": counts, "paged": counts} of the two serve runs."""
    phase("11 rg-serve (recurrentgemma-9b full depth, 38 layers, bf16, SOI "
          "pp, 4 requests of 2040..2034 tokens, 64 generated: dense, then "
          "--paged --page-size 16)")
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parse_args(RG_ARGV)
    t0 = time.perf_counter()
    cfg, params, prompt, plens, engine = serve.setup(args)
    torch.cuda.synchronize(dev)
    print(f"  {sum(p.numel() for p in params.parameters()) / 1e9:.2f} B "
          f"bf16 parameters built in {time.perf_counter() - t0:.1f} s")
    n_outer, n_mid, n_rec = _rg_counts(cfg)
    engines = {"dense": engine,
               "paged": SOIEngine(cfg, max_concurrent_decodes=args.batch,
                                  max_len=args.prompt_len + args.gen_len,
                                  device=dev, paged=True, page_size=16)}
    out, seqs = {}, {}
    for layout, eng in engines.items():
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        res = serve.serve(eng, params, prompt, plens, args.gen_len)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        read = ("paged_decode_attention" if layout == "paged"
                else "decode_attention")
        want = {"lru_scan": n_rec * len(res.seqs),
                read: n_outer * res.steps + n_mid * res.mid_steps}
        print(f"  {layout}: prefill {res.prefill_s:.3f} s for "
              f"{len(res.seqs)} requests (lens {plens}), decode "
              f"{res.decoded} tokens in {res.decode_s:.3f} s = "
              f"{res.decoded / res.decode_s:.1f} tok/s (host clock); "
              f"{res.steps} steps, {res.mid_steps} with the middle; peak "
              f"device memory {peak:.2f} GiB; pools {res.pools}")
        print(f"  {layout} launches {counts}; expected {want} ({n_rec} "
              f"RG-LRU layers x {len(res.seqs)} prefills; {n_outer} outer "
              f"attention layers x {res.steps} steps + {n_mid} middle x "
              f"{res.mid_steps})")
        check(res.seqs.shape == (4, 64), f"tokens shape {res.seqs.shape}")
        check(((res.seqs >= 0) & (res.seqs < cfg.vocab)).all(),
              "token ids outside [0, vocab)")
        check(want["lru_scan"] == 104 and want[read] == 576,
              f"expected counts moved: {want}")
        for name, n in counts.items():
            check(n == want.get(name, 0),
                  f"{layout}: {name} launches {n} != {want.get(name, 0)}")
        out[layout], seqs[layout] = counts, res.seqs
        on, off = _phase_step_ms(eng, params, prompt, plens)
        print(f"  {layout} step time (host clock after a synchronize, "
              f"median): {on:.3f} ms with the SOI middle (phase 0), "
              f"{off:.3f} ms without; ratio {on / off:.3f}")
    check((seqs["dense"] == seqs["paged"]).all(),
          "paged tokens differ from the dense run's")
    print("  tokens identical between the dense and the paged run")
    for layout in ("dense", "paged"):
        print(f"  profiled rerun ({layout}):")
        ev = _device_events(lambda: serve.serve(engines[layout], params,
                                                prompt, plens, args.gen_len))
        check(ev, "the profiler saw no device activity")
        _prefill_profile(ev, len(res.seqs), "lru_scan_kernel")
        loop = _decode_profile(ev, res.steps, "lru_scan_kernel")
        _reads_per_step(loop, res.steps, layout)
    del params, engines, engine
    _free(dev)
    return out


# ---------------------------------------------------------------------------
# 12-13. the paper's streaming U-Net: the STMC/SOI stream on stmc_conv
# ---------------------------------------------------------------------------

# the 11 SOI configurations of tests/test_soi_unet.py
UNET_SOIS = (None, dict(pairs=(1,)), dict(pairs=(2,)), dict(pairs=(4,)),
             dict(pairs=(1, 3)), dict(pairs=(2, 4)),
             dict(pairs=(2,), mode="fp"), dict(pairs=(1,), mode="fp"),
             dict(pairs=(1,), mode="fp", shift_pos=3),
             dict(pairs=(2,), extrapolation="tconv"),
             dict(pairs=(2,), mode="fp", extrapolation="tconv"))
UNET_TOL = 1e-4
# (label, SOI, stmc_conv launches for 512 frames, reckoned by hand from the
# freshness predicates of models/unet.py; the check uses the plans' count)
STREAM_SOIS = (("STMC baseline", None, 7168),
               ("PP S-CC (3,)", dict(pairs=(3,)), 4608),
               ("PP 2xS-CC (1,3)", dict(pairs=(1, 3)), 2304),
               ("FP SS-CC (3,)", dict(pairs=(3,), mode="fp"), 4608))
STREAM_FRAMES = 512
FRAME_MS = 16.0                    # 62.5 fps: 256-sample hop at 16 kHz


def _soi_label(kw) -> str:
    if kw is None:
        return "none"
    return " ".join(f"{k}={v}" for k, v in kw.items())


def _unet_cfg(kw):
    from repro_torch.configs import soi_unet_dns as UD
    from repro_torch.core.soi import SOIConvCfg
    return UD.config(None if kw is None else SOIConvCfg(**kw))


def _unet_models(dev):
    """Full-width soi-unet-dns, float32, random from seed 7, on the host
    and on the card: the dup model, and the tconv model (the same layers —
    the same generator draws them first — plus the extrapolator up[2]).
    The reference's offline graph applies an ``up`` conv wherever the model
    has one, so the dup configurations get the model without."""
    from repro_torch.models import unet as U
    out = {}
    for kind, kw in (("dup", dict(pairs=(2,))),
                     ("tconv", dict(pairs=(2,), extrapolation="tconv"))):
        cpu = U.init(_unet_cfg(kw), generator=torch.Generator()
                     .manual_seed(7), device="cpu")
        out[kind] = (cpu, copy.deepcopy(cpu).to(dev))
    return out


def _planned_convs(cfg, n_frames: int) -> int:
    from repro_torch.models import unet as U
    per_phase = U.convs_per_phase(cfg)
    return sum(per_phase[t % cfg.period] for t in range(n_frames))


def _held_launches(counts: dict, want: int, label: str):
    for name, n in counts.items():
        expect = want if name == "stmc_conv" else 0
        check(n == expect, f"{label}: {name} launches {n} != {expect}")


def unet_parity_phase(dev):
    phase("12 unet-parity (full-width soi-unet-dns, f32, B 2, 48 frames, 11 "
          "SOI configs: card stream vs CPU stream vs card offline)")
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import unet as U
    t0 = time.perf_counter()
    models = _unet_models(dev)
    n_par = sum(p.numel() for p in models["dup"][1].parameters())
    print(f"  {n_par / 1e6:.2f} M float32 parameters ({n_par * 4 / 1e6:.1f} "
          f"MB), on the card and on the host "
          f"({time.perf_counter() - t0:.1f} s to build and copy)")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 48, 128)).astype(np.float32))
    x_dev = x.to(dev)
    for kw in UNET_SOIS:
        cfg = _unet_cfg(kw)
        tconv = kw is not None and kw.get("extrapolation") == "tconv"
        cpu_model, dev_model = models["tconv" if tconv else "dup"]
        label = _soi_label(kw)
        ops.reset_launch_counts()
        y_dev = U.stream_infer(dev_model, x_dev, cfg)
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        want = _planned_convs(cfg, 48)
        _held_launches(counts, want, f"unet stream {label}")
        y_cpu = U.stream_infer(cpu_model, x, cfg)
        with torch.no_grad():
            y_off, _ = U.apply_offline(dev_model, x_dev, cfg)
        check(y_dev.shape == (2, 48, 128), f"{label}: shape {y_dev.shape}")
        check(bool(torch.isfinite(y_dev).all()), f"{label}: non-finite")
        d_cpu = float((y_dev.cpu() - y_cpu).abs().max())
        d_off = float((y_dev - y_off).abs().max())
        print(f"  {label}: max|Δ| card vs CPU {d_cpu:.3e}, stream vs offline "
              f"{d_off:.3e}; stmc_conv {counts['stmc_conv']} launches "
              f"(planned {want}); max|y| {float(y_dev.abs().max()):.3f}")
        check(d_cpu < UNET_TOL and d_off < UNET_TOL,
              f"{label}: max|Δ| {d_cpu} / {d_off} >= {UNET_TOL}")
    del models
    _free(dev)


def unet_stream_phase(dev) -> dict:
    """Returns the launch counts of the B 1 STMC-baseline stream."""
    phase(f"13 unet-stream (full-width soi-unet-dns, f32, "
          f"{STREAM_FRAMES} frames at B 1 and B 32; STMC baseline, PP "
          f"S-CC (3,), PP 2xS-CC (1,3), FP SS-CC (3,))")
    from repro_torch.engine.session import unet_stream_session
    from repro_torch.kernels import ops
    from repro_torch.models import unet as U
    cfg0 = _unet_cfg(None)
    model = U.init(cfg0, generator=torch.Generator(device=dev).manual_seed(9),
                   device=dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    main_counts = None
    for b in (1, 32):
        x = torch.randn((b, STREAM_FRAMES, 128), generator=gen, device=dev)
        base_ms = None
        for label, kw, hand_count in STREAM_SOIS:
            cfg = _unet_cfg(kw)
            planned = _planned_convs(cfg, STREAM_FRAMES)
            check(planned == hand_count,
                  f"{label}: planned {planned} != {hand_count}")
            # two periods first: every phase's graph captured (the timed
            # frames start again at phase 0)
            sess = unet_stream_session(model, cfg, batch=b, device=dev)
            for t in range(2 * cfg.period):
                sess.push(x[:, t])
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            per_phase: list = [[] for _ in range(cfg.period)]
            ops.reset_launch_counts()
            t_all = time.perf_counter()
            for t in range(STREAM_FRAMES):
                t0 = time.perf_counter()
                y = sess.push(x[:, t])
                torch.cuda.synchronize(dev)
                per_phase[t % cfg.period].append(
                    (time.perf_counter() - t0) * 1e3)
            total_s = time.perf_counter() - t_all
            counts = ops.launch_counts()
            _held_launches(counts, planned, f"{label} B {b}")
            check(y.shape == (b, 128) and bool(torch.isfinite(y).all()),
                  f"{label} B {b}: last frame {tuple(y.shape)} not finite")
            check(sess.graph.captures == cfg.period
                  and sess.graph.replays == STREAM_FRAMES + cfg.period,
                  f"{label} B {b}: {sess.graph.captures} captures, "
                  f"{sess.graph.replays} replays")
            if b == 1 and kw is None:
                main_counts = counts
            mean_ms = total_s * 1e3 / STREAM_FRAMES
            base_ms = mean_ms if base_ms is None else base_ms
            med = [sorted(v)[len(v) // 2] for v in per_phase]
            retain = U.complexity_report(cfg).retain
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
            print(f"  B {b} {label}: stmc_conv {counts['stmc_conv']} "
                  f"launches (planned {planned}); median step per phase "
                  f"{', '.join(f'{m:.3f}' for m in med)} ms; mean "
                  f"{mean_ms:.3f} ms = {STREAM_FRAMES / total_s:.1f} "
                  f"frames/s ({b * STREAM_FRAMES / total_s:.1f} stream "
                  f"frames/s), {FRAME_MS / mean_ms:.1f}x real time "
                  f"(16 ms a frame), worst step "
                  f"{max(max(v) for v in per_phase):.3f} ms; MAC retain "
                  f"{retain:.3f}, step-time ratio to the baseline "
                  f"{mean_ms / base_ms:.3f}; peak device memory "
                  f"{peak:.1f} MiB (host clock after a synchronize)")
        for label, kw, _n in (STREAM_SOIS[0], STREAM_SOIS[2]):
            cfg = _unet_cfg(kw)
            sess = unet_stream_session(model, cfg, batch=b, device=dev)
            for t in range(cfg.period):
                sess.push(x[:, t])            # the captures, unprofiled
            n_prof = 64

            def run():
                for t in range(n_prof):
                    sess.push(x[:, t])
            ev = _device_events(run)
            check(ev, "the profiler saw no device activity")
            print(f"  profiled rerun, B {b} {label}, {n_prof} frames:")
            busy = _window_profile(ev, n_prof, "stream", "frame")
            conv = sum(e - s_ for s_, e, n in ev if "stmc_conv_kernel" in n)
            print(f"  stmc_conv: {conv / 1e3:.3f} ms on the device in "
                  f"{n_prof} frames = {conv / 1e3 / n_prof:.4f} ms a frame, "
                  f"{conv / busy:.3f} of the busy time")
    del model
    _free(dev)
    return main_counts


# ---------------------------------------------------------------------------
# 14. graphs: the captured step programs against the eager steps
# ---------------------------------------------------------------------------

def _eager_twin(engine, ds):
    """A deep copy of ``engine`` (host tables, prefix index, clocks) and of
    its live decode state ``ds``, taken before the engine's first step,
    whose step runs ``gen_step`` — ``generate_step``, the argmax and the
    result rows — eagerly: the same host decisions, the same COW flushes
    and page-map copies, no graph."""
    from repro_torch.engine import soi_engine as SE
    twin, twin_ds = copy.deepcopy((engine, ds))
    cfg = twin.cfg
    twin.graph = lambda params, d, mid: SE.gen_step(params, cfg, d, mid)
    return twin, twin_ds


# the leaves of an attention cache: in a paged state, pools whose row 0 is
# the null page
POOL_LEAVES = ("['k']", "['v']", "['pos']", "['latent']", "['rope']")


def _state_equal(a, b, label, paged=False) -> tuple:
    """Every leaf of two state trees equal bit for bit; returns the count of
    leaves and of null-page elements that differ. In a paged state the null
    page (row 0 of every pool) takes the writes of slots that must not
    write (mid-window middle rows, shared prefix pages at insert), several
    to one row at once, so which lands is the scatter's choice; every read
    masks it. It is left out of the comparison and counted."""
    from repro_torch.engine.contracts import state_leaves
    la, lb = state_leaves(a), state_leaves(b)
    check([p for p, _ in la] == [p for p, _ in lb],
          f"{label}: the state trees differ")
    null_diff = 0
    for (path, x), (_, y) in zip(la, lb):
        if paged and path.startswith("['model']") and path.endswith(
                POOL_LEAVES):
            null_diff += int((x[0] != y[0]).sum())
            x, y = x[1:], y[1:]
        check(torch.equal(x, y),
              f"{label}: state leaf {path} differs from the eager step's")
    return len(la), null_diff


def _raises(exc, fn) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    raise RuntimeError(f"{exc.__name__} was not raised")


def _graph_parity(label, engine, params, prompts, n_steps, late_at, dev):
    """The graphed engine against its eager twin, bit for bit: tokens and
    logits every step, every leaf of the decode state at the end; a late
    insert after ``late_at`` steps. Returns the graphed state."""
    import numpy as np
    ds = engine.init_decode_state(params)
    for slot in (0, 1):
        ds = engine.insert(engine.prefill(params, prompts[slot].to(dev)), ds,
                           slot)
    twin, tds = _eager_twin(engine, ds)
    flushes0 = engine.cow_flushes
    t0 = time.perf_counter()
    for k in range(n_steps):
        if k == late_at:
            prefix = engine.prefill(params, prompts[2].to(dev))
            ds = engine.insert(prefix, ds, 2)
            tds = twin.insert(prefix, tds, 2)
        ds, res = engine.generate(params, ds)
        tds, tres = twin.generate(params, tds)
        check(torch.equal(res.logits, tres.logits),
              f"{label} step {k}: logits differ from the eager step's")
        check(np.array_equal(res.convert_to_numpy().data,
                             tres.convert_to_numpy().data),
              f"{label} step {k}: tokens differ from the eager step's")
    n_leaves, null_diff = _state_equal(ds, tds, label,
                                       paged=engine._paged)
    g = engine.graph
    want = 2 if engine.cfg.soi is not None else 1
    check(g.captures == want and g.replays == n_steps - want,
          f"{label}: {g.captures} captures, {g.replays} replays in "
          f"{n_steps} steps (want {want} captures)")
    stats = {str(k[0]): {"capture_s": round(v["capture_s"], 4),
                         "pool_MiB": round(v["pool_bytes"] / 2 ** 20, 2),
                         "copy_back_B": v["copy_back_bytes"]}
             for k, v in g.stats().items()}
    print(f"  {label}: {n_steps} steps graphed == eager bit for bit (tokens, "
          f"logits, {n_leaves} state leaves"
          f"{f'; null pages: {null_diff} elements differ' if engine._paged else ''}"
          f") in {time.perf_counter() - t0:.2f} s; {g.captures} captures, "
          f"{g.replays} replays, {engine.cow_flushes - flushes0} COW "
          f"flushes between replays; graphs {stats}", flush=True)
    return ds


def _refusals(label, engine, params, ds):
    """A rebound >= 16 KiB state leaf (the largest) and another params
    object are refused before a replay; the captured ones replay."""
    from repro_torch.engine import contracts as C
    g = engine.graph
    steps = C._steps(ds, [])
    path, big = max(steps, key=lambda st: st[1].nbytes)
    check(big.nbytes >= C.BIG_BYTES, f"{label}: no leaf of >= 16 KiB")
    branch = next(iter(g.stats()))[0]
    C._set_path(ds, path, big.clone())
    msg = _raises(C.DroppedDonationError,
                  lambda: g(params, ds, branch))
    C._set_path(ds, path, big)
    _raises(ValueError, lambda: g(copy.copy(params), ds, branch))
    print(f"  {label}: rebinding {''.join(f'[{s!r}]' for s in path)} "
          f"({big.nbytes} B) raised DroppedDonationError ({msg[:70]}...); "
          f"another params object ValueError", flush=True)


def _lm_graph_parity(dev):
    from repro_torch.configs import deepseek_v2_236b as DS
    from repro_torch.configs import recurrentgemma_9b as RG
    from repro_torch.engine import SOIEngine
    from repro_torch.models import transformer as T
    gen = torch.Generator().manual_seed(21)

    def draw(cfg, lens, shared=0):
        out = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                             dtype=torch.int32) for n in lens]
        for p in out[1:]:
            p[:shared] = out[0][:shared]
        return out

    # qwen3 at 4 layers, f32: dense pp and fp (prompts in one SOI phase
    # class, the late one too, so steps alternate between the branches),
    # then paged + chunked + prefix cache: prompts sharing 128 tokens, 60
    # steps, so the rings wrap onto shared pages and COW flushes run
    # between replays
    for mode in ("pp", "fp"):
        cfg = _parity_cfg(mode)
        params = T.init(cfg, generator=torch.Generator(device=dev)
                        .manual_seed(22), device=dev)
        prompts = draw(cfg, (200, 202, 203))
        st = cfg.soi.stride
        label = f"qwen3 4 layers f32 {mode} dense"
        eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=256,
                        device=dev)
        ds = _graph_parity(label, eng, params, prompts, 2 * st + 5, 3, dev)
        _refusals(label, eng, params, ds)
        if mode == "pp":
            prompts = draw(cfg, (200, 202, 203), shared=128)
            eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=256,
                            device=dev, paged=True, page_size=16,
                            prefill_chunk=64, prefix_cache=True)
            _graph_parity("qwen3 4 layers f32 pp paged, chunk 64, prefix "
                          "cache", eng, params, prompts, 60, 3, dev)
            pc = eng.prefix_cache_stats
            check(pc["hits"] == 2 and pc["cow_copies"] > 0
                  and eng.cow_flushes > 0,
                  f"expected hits and COW flushes: {pc}, "
                  f"{eng.cow_flushes} flushes")
        del params
    _free(dev)
    # deepseek-v2 at 2 layers (dense layer 0, one MoE middle), bf16, paged
    cfg = DS.config(soi="pp", n_layers=2)
    params = T.cast_params(T.init(cfg, generator=torch.Generator(device=dev)
                                  .manual_seed(23), device=dev,
                                  dtype=torch.bfloat16), cfg)
    label = "deepseek-v2 2 layers bf16 pp paged"
    eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=64, device=dev,
                    paged=True, page_size=16)
    ds = _graph_parity(label, eng, params, draw(cfg, (41, 43, 44)),
                       2 * cfg.soi.stride + 5, 3, dev)
    _refusals(label, eng, params, ds)
    del params
    _free(dev)
    # recurrentgemma-9b at 12 layers, bf16, dense and paged
    cfg = RG.config(soi="pp", n_layers=12)
    params = T.cast_params(T.init(cfg, generator=torch.Generator(device=dev)
                                  .manual_seed(24), device=dev,
                                  dtype=torch.bfloat16), cfg)
    prompts = draw(cfg, (41, 43, 44))
    for layout, kw in (("dense", {}),
                       ("paged", dict(paged=True, page_size=16))):
        label = f"recurrentgemma-9b 12 layers bf16 pp {layout}"
        eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=64,
                        device=dev, **kw)
        ds = _graph_parity(label, eng, params, prompts,
                           2 * cfg.soi.stride + 5, 3, dev)
        _refusals(label, eng, params, ds)
    del params
    _free(dev)


def _unet_graph_parity(model, dev):
    """The graphed session against the eager steppers at B 1 and B 32 for
    phase 13's configs: every frame and the final stream state bit for
    bit, ``stmc_conv`` launches from the replays equal to the plans'."""
    from repro_torch.engine.session import unet_stream_session
    from repro_torch.kernels import ops
    from repro_torch.models import unet as U
    gen = torch.Generator(device=dev).manual_seed(25)
    for b in (1, 32):
        for label, kw, _n in STREAM_SOIS:
            cfg = _unet_cfg(kw)
            n = 3 * cfg.period + 2
            x = torch.randn((b, n, 128), generator=gen, device=dev)
            sess = unet_stream_session(model, cfg, batch=b, device=dev)
            ops.reset_launch_counts()
            ys = [sess.push(x[:, t]) for t in range(n)]
            torch.cuda.synchronize(dev)
            counts = ops.launch_counts()
            _held_launches(counts, _planned_convs(cfg, n),
                           f"graphed {label} B {b}")
            steppers = U.make_phase_steppers(cfg)
            state = U.init_stream_state(b, cfg, device=dev)
            for t in range(n):
                state, y = steppers[t % cfg.period](model, state, x[:, t])
                check(torch.equal(ys[t], y),
                      f"graphed {label} B {b} frame {t}: differs from the "
                      f"eager stepper's")
            n_leaves, _ = _state_equal(sess.state["inner"], state,
                                       f"graphed {label} B {b}")
            g = sess.graph
            check(g.captures == cfg.period and g.replays == n - cfg.period,
                  f"{label} B {b}: {g.captures} captures, {g.replays} "
                  f"replays")
            st = g.stats().values()
            print(f"  U-Net B {b} {label}: {n} frames graphed == eager bit "
                  f"for bit ({n_leaves} state leaves), stmc_conv "
                  f"{counts['stmc_conv']} launches (planned); "
                  f"{g.captures} captures "
                  f"({sum(v['capture_s'] for v in st) * 1e3:.1f} ms, pool "
                  f"{sum(v['pool_bytes'] for v in st) / 2 ** 20:.1f} MiB)",
                  flush=True)


def _loop_profile(step, n: int, kernel, launches: str, label: str):
    """Device busy ms a step, idle share and device kernels a step of
    ``n`` calls of ``step`` under the profiler (device clock: first
    kernel's start to last kernel's end), and the events of ``kernel`` (a
    name or a tuple of names) on the device, held to the ``launches``
    counter's count: every counted launch ran, graph node or not. One step
    runs first (the profiler can miss the start of the first graph replay
    after it starts), then the ``n`` behind and ahead of MARKERS spin
    kernels (``_device_events``). A profile that still lost events is
    taken again; a second one that disagrees raises."""
    from repro_torch.kernels import ops

    def run():
        ops.reset_launch_counts()
        for _ in range(n):
            step()
    for _ in range(2):
        ev = _device_events(run, MARKERS, warm=step)
        check(ev, f"{label}: the profiler saw no device activity")
        seen = sum(1 for _s, _e, name in ev if _named(name, kernel))
        counted = ops.launch_counts()[launches]
        if seen == counted:
            break
    check(seen == counted, f"{label}: {seen} {kernel} kernels on the device "
                           f"in two profiles, {counted} {launches} counted")
    window = max(e for _s, e, _n in ev) - min(s_ for s_, _e, _n in ev)
    busy = _busy_us([(s_, e) for s_, e, _n in ev])
    return busy / 1e3 / n, 1 - busy / window, len(ev) / n, seen


def _enqueue_ms(step, n: int) -> float:
    """Host ms a call of ``n`` calls of ``step`` enqueued back to back
    after a synchronize, the synchronize that drains them left out: the
    host's own cost a step while the card has work queued."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / n


def _lm_graph_timing(dev):
    """Full-width qwen3-1.7b at phase 5's traffic: the graphed engine and
    its eager twin from one state, steps interleaved (host clock after a
    synchronize), then a profiled window of each."""
    from repro_torch.launch import serve
    args = serve.parse_args(SERVE_ARGV + ["--gen-len", "192"])
    cfg, params, prompt, plens, engine = serve.setup(args)
    ds = engine.init_decode_state(params)
    for slot, n in enumerate(plens):
        ds = engine.insert(engine.prefill(params, prompt[slot, :n]), ds, slot)
    twin, tds = _eager_twin(engine, ds)
    torch.cuda.synchronize(dev)
    times = {"graphed": {True: [], False: []},
             "eager": {True: [], False: []}}
    n_steps = 64
    for _ in range(n_steps):
        for mode, eng in (("graphed", engine), ("eager", twin)):
            mid0 = eng.mid_steps
            t0 = time.perf_counter()
            if mode == "graphed":
                ds, res = engine.generate(params, ds)
            else:
                tds, res = twin.generate(params, tds)
            res.convert_to_numpy()
            torch.cuda.synchronize(dev)
            times[mode][eng.mid_steps > mid0].append(
                (time.perf_counter() - t0) * 1e3)
    check(engine.graph.captures == 2, f"{engine.graph.captures} captures")
    out = {}
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    for mode, eng in (("graphed", engine), ("eager", twin)):
        allt = sorted(times[mode][True] + times[mode][False])
        on, off = sorted(times[mode][True]), sorted(times[mode][False])
        st = {"ds": ds if mode == "graphed" else tds, "prev": None}

        def step():
            st["ds"], res = eng.generate(params, st["ds"])
            if st["prev"] is not None:
                st["prev"].convert_to_numpy()
            st["prev"] = res
        n_prof = 16
        busy, idle, kern, reads = _loop_profile(
            step, n_prof, READ_KERNELS["split"], "decode_attention", mode)

        def enqueue():
            st["ds"], _res = eng.generate(params, st["ds"])
        host = _enqueue_ms(enqueue, n_prof)
        if mode == "graphed":
            ds = st["ds"]
        out[mode] = {"median_ms": allt[len(allt) // 2],
                     "mid_ms": on[len(on) // 2], "off_ms": off[len(off) // 2],
                     "busy_ms": busy, "idle": idle, "kernels": kern,
                     "host_ms": host}
        print(f"  qwen3-1.7b {mode}: median step {out[mode]['median_ms']:.3f}"
              f" ms ({out[mode]['mid_ms']:.3f} with the SOI middle, "
              f"{out[mode]['off_ms']:.3f} without; {n_steps} steps, host "
              f"clock after a synchronize); profiled {n_prof} steps: busy "
              f"{busy:.3f} ms a step, idle share {idle:.3f}, {kern:.0f} "
              f"device kernels a step, decode reads {reads} on the device "
              f"== counted; host {host:.3f} ms a step (enqueued "
              f"back to back, no drain)", flush=True)
    g = out["graphed"]
    e = out["eager"]
    stats = engine.graph.stats()
    print(f"  qwen3-1.7b graphed / eager: median step "
          f"{g['median_ms'] / e['median_ms']:.3f}, busy "
          f"{g['busy_ms'] / e['busy_ms']:.3f}; step ratio with / without "
          f"the middle {g['mid_ms'] / g['off_ms']:.3f} graphed, "
          f"{e['mid_ms'] / e['off_ms']:.3f} eager")
    for (mid,), v in stats.items():
        print(f"  qwen3-1.7b graph {'middle' if mid else 'no middle'}: "
              f"capture {v['capture_s'] * 1e3:.1f} ms, pool "
              f"{v['pool_bytes'] / 2 ** 20:.1f} MiB, copy-back "
              f"{v['copy_back_bytes']} B a replay, launches a replay "
              f"{v['launches']} (expected decode_attention "
              f"{n_outer + (n_mid if mid else 0)})")
        check(v["launches"].get("decode_attention")
              == n_outer + (n_mid if mid else 0),
              f"graph launches {v['launches']}")
    del params, engine, twin, ds, tds
    _free(dev)
    return out


def _unet_graph_timing(model, dev):
    """soi-unet-dns at B 1 and B 32, STMC baseline and PP S-CC (3,): the
    graphed session and the eager steppers from one stream, frames
    interleaved (host clock after a synchronize), then a profiled window
    of each."""
    from repro_torch.engine.session import unet_stream_session
    from repro_torch.models import unet as U
    gen = torch.Generator(device=dev).manual_seed(26)
    n = 192
    out = {}
    for b in (1, 32):
        x = torch.randn((b, n, 128), generator=gen, device=dev)
        base = {}
        for label, kw, _n in STREAM_SOIS[:2]:
            cfg = _unet_cfg(kw)
            sess = unet_stream_session(model, cfg, batch=b, device=dev)
            for t in range(2 * cfg.period):
                sess.push(x[:, t])           # every phase captured
            steppers = U.make_phase_steppers(cfg)
            state = U.init_stream_state(b, cfg, device=dev)
            times = {"graphed": [[] for _ in range(cfg.period)],
                     "eager": [[] for _ in range(cfg.period)]}
            torch.cuda.synchronize(dev)
            for t in range(n):
                ph = t % cfg.period
                t0 = time.perf_counter()
                sess.push(x[:, t])
                torch.cuda.synchronize(dev)
                times["graphed"][ph].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                state, _y = steppers[ph](model, state, x[:, t])
                torch.cuda.synchronize(dev)
                times["eager"][ph].append((time.perf_counter() - t0) * 1e3)
            retain = U.complexity_report(cfg).retain
            for mode in ("graphed", "eager"):
                med = [sorted(v)[len(v) // 2] for v in times[mode]]
                mean = sum(map(sum, times[mode])) / n
                base.setdefault(mode, mean)
                run = {"t": 0, "state": state}

                def step():
                    t = run["t"]
                    if mode == "graphed":
                        sess.push(x[:, t % n])
                    else:
                        run["state"], _ = steppers[t % cfg.period](
                            model, run["state"], x[:, t % n])
                    run["t"] = t + 1
                busy, idle, kern, _ = _loop_profile(
                    step, 64, "stmc_conv_kernel", "stmc_conv",
                    f"{mode} {label} B {b}")
                host = _enqueue_ms(step, 64)
                out[(b, label, mode)] = {"median_ms": med, "mean_ms": mean,
                                         "busy_ms": busy, "idle": idle,
                                         "host_ms": host}
                print(f"  U-Net B {b} {label} {mode}: median step per phase "
                      f"{', '.join(f'{m:.3f}' for m in med)} ms, mean "
                      f"{mean:.3f} ms, {FRAME_MS / mean:.1f}x real time, "
                      f"step ratio to the baseline {mean / base[mode]:.3f} "
                      f"(MAC retain {retain:.3f}); profiled 64 frames: busy "
                      f"{busy:.3f} ms a frame, idle share {idle:.3f}, "
                      f"{kern:.1f} device kernels a frame; host {host:.3f} ms "
                      f"a frame enqueued back to back ({n} frames, host "
                      f"clock after a synchronize)", flush=True)
    return out


def graphs_phase(dev):
    phase("14 graphs (the captured step graphs against the eager steps: "
          "qwen3, deepseek-v2, recurrentgemma, the U-Net; timing)")
    from repro_torch.models import unet as U
    _lm_graph_parity(dev)
    model = U.init(_unet_cfg(None), generator=torch.Generator(device=dev)
                   .manual_seed(9), device=dev)
    _unet_graph_parity(model, dev)
    lm = _lm_graph_timing(dev)
    _unet_graph_timing(model, dev)
    del model
    _free(dev)
    # the graphed qwen3 step's device kernels, which phase 16 holds, and
    # its timing, which phase 20 sets beside the plan
    return lm["graphed"]["kernels"], lm["graphed"]


# ---------------------------------------------------------------------------
# 15. self-speculative windows
# ---------------------------------------------------------------------------

SPEC_K = 4


def _spec_start(cfg, model, prompts, where, paged):
    """A speculative engine on ``where`` with ``prompts`` inserted and, on
    pools, the K positions of a window backed: ``(engine, state, first
    tokens)``."""
    from repro_torch.engine import SOIEngine
    kw = (dict(paged=True, page_size=16, prefill_chunk=64, prefix_cache=True)
          if paged else {})
    eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=256, device=where,
                    speculate=SPEC_K, **kw)
    ds = eng.init_decode_state(model)
    for slot, p in enumerate(prompts):
        ds = eng.insert(eng.prefill(model, p.to(where)), ds, slot)
    if paged:
        ds = eng._back_spec_window(ds)
        eng._flush_cow(ds)
        eng._refresh_page_maps(ds["model"])
    return eng, ds["model"], ds["tokens"].clone()


def _spec_parity(dev):
    """(a) qwen3 at 4 layers, f32, dense and paged with the prefix cache:
    a rejection forced at every depth n through ``verify_commit`` on the
    card and on the CPU from the same inputs (the card's greedy
    continuation, its guess at n corrupted) — committed tokens equal,
    logits within 1e-3, and the card's state bit for bit that of n
    sequential card steps (pools: outside the null page)."""
    from repro_torch.engine.speculative import verify_commit
    from repro_torch.engine.step import generate_step
    from repro_torch.models import transformer as T
    cfg = _parity_cfg("pp")
    dev_model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(31), device=dev)
    cpu_model = _cpu_copy(dev_model, cfg)
    gen = torch.Generator().manual_seed(32)
    shared = torch.randint(0, cfg.vocab, (128,), generator=gen,
                           dtype=torch.int32)
    for paged in (False, True):
        prompts = [torch.cat([shared, torch.randint(
            0, cfg.vocab, (n - 128,), generator=gen, dtype=torch.int32)])
            for n in (200, 201, 199)]
        label = "paged, prefix cache" if paged else "dense"
        t0 = time.perf_counter()
        _e, st0, cur = _spec_start(cfg, dev_model, prompts, dev, paged)
        _c, cst0, ccur = _spec_start(cfg, cpu_model, prompts,
                                     torch.device("cpu"), paged)
        check(torch.equal(cur.cpu(), ccur), f"spec parity {label}: first "
                                            f"tokens differ card vs CPU")
        ones = torch.ones(3, dtype=torch.bool, device=dev)
        seq, snaps, st, c = [cur], [], copy.deepcopy(st0), cur
        for _ in range(SPEC_K):
            lg, st = generate_step(dev_model, cfg, st, c, active=ones)
            c = torch.argmax(lg, -1).to(torch.int32)
            seq.append(c)
            snaps.append(copy.deepcopy(st))
        seq = torch.stack(seq, 1)
        worst, null_diff = 0.0, 0
        for n in range(1, SPEC_K + 1):
            inputs = seq[:, :SPEC_K].clone()
            if n < SPEC_K:
                inputs[:, n] = (inputs[:, n] + 1) % cfg.vocab
            sv, csv = copy.deepcopy(st0), copy.deepcopy(cst0)
            _, comm, n_acc, nxt, lg = verify_commit(
                dev_model, cfg, sv, inputs, active=ones, spec=ones)
            cones = ones.cpu()
            _, ccomm, cn, cnxt, clg = verify_commit(
                cpu_model, cfg, csv, inputs.cpu(), active=cones, spec=cones)
            check(n_acc.tolist() == cn.tolist() == [n] * 3,
                  f"spec parity {label} n={n}: accepted {n_acc.tolist()} "
                  f"on the card, {cn.tolist()} on the CPU")
            check(torch.equal(comm.cpu(), ccomm)
                  and torch.equal(comm[:, :n], seq[:, 1:1 + n])
                  and torch.equal(nxt.cpu(), cnxt),
                  f"spec parity {label} n={n}: committed tokens differ "
                  f"(card {comm.tolist()}, cpu {ccomm.tolist()})")
            err = float((lg.cpu() - clg).abs().max())
            check(err < 1e-3, f"spec parity {label} n={n}: logits differ "
                              f"by {err} >= 1e-3")
            worst = max(worst, err)
            _n, nd = _state_equal({"model": sv}, {"model": snaps[n - 1]},
                                  f"spec parity {label} n={n}", paged=paged)
            null_diff += nd
        print(f"  spec parity qwen3 4 layers f32 {label}: rejection forced "
              f"at n = 1..{SPEC_K} — committed tokens equal card vs CPU, "
              f"max|Δlogit| {worst:.3e}, the card's state == {SPEC_K} x n "
              f"sequential card steps bit for bit"
              f"{f' (null pages: {null_diff} elements differ)' if paged else ''}"
              f" in {time.perf_counter() - t0:.2f} s", flush=True)
        del st0, cst0, snaps, st
    del cpu_model, dev_model
    _free(dev)


def _first_diff(got, want) -> str:
    """The first (slot, step) where two token arrays differ."""
    import numpy as np
    if got.shape != want.shape:
        return f"shapes {got.shape} and {want.shape}"
    slot, step = (int(x[0]) for x in np.nonzero(got != want))
    return (f"slot {slot}, step {step}: {int(got[slot, step])} against "
            f"{int(want[slot, step])}")


def _spec_serve(label, argv, plain_seqs, dev):
    """(b) one full-width speculative serve through ``launch/serve.py``'s
    own ``setup`` and ``serve``: tokens equal to the plain run's, the decode
    reads launched as the windows' branch patterns give them, copy_pages
    once a COW flush. Returns the launch counts."""
    from repro_torch.engine.speculative import draft_rows
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parse_args(argv)
    cfg, params, prompt, plens, engine = serve.setup(args)
    ops.reset_launch_counts()
    res = serve.serve(engine, params, prompt, plens, args.gen_len,
                      mixed_spec=args.mixed_spec)
    torch.cuda.synchronize(dev)
    counts = ops.launch_counts()
    if res.seqs.shape != plain_seqs.shape or (res.seqs != plain_seqs).any():
        raise RuntimeError(f"spec {label}: tokens differ from the plain "
                           f"run's at {_first_diff(res.seqs, plain_seqs)}")
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    sp = res.spec
    read = "paged_decode_attention" if args.paged else "decode_attention"
    want = (sp["windows"] * (2 * SPEC_K - 1) * n_outer
            + n_mid * engine.spec_mid_iters)
    g = engine.spec_graph
    pool = sum(v["pool_bytes"] for v in g.stats().values())
    rows = draft_rows(cfg, engine._live["model"], SPEC_K)
    gathered = sum(v.nbytes for _l, ix, v in rows if ix is not None)
    whole = sum(v.nbytes for _l, ix, v in rows if ix is None)
    print(f"  spec {label}: tokens identical to the plain run; {sp['windows']}"
          f" windows, {sp['committed']} tokens committed "
          f"({sp['tokens_per_window']:.3f} a slot-window), accept rate "
          f"{sp['accept_rate']:.4f} ({sp['draft_accepted']}/"
          f"{sp['draft_candidates']}); decode {res.decoded} tokens in "
          f"{res.decode_s:.3f} s = {res.decoded / res.decode_s:.1f} tok/s "
          f"(host clock, the serve loop); {g.captures} captures for "
          f"{len(engine.spec_keys)} window keys {sorted(engine.spec_keys)}, "
          f"pool {pool / 2 ** 20:.1f} MiB; the draft gathers "
          f"{gathered / 2 ** 10:.1f} KiB of ring rows + {whole / 2 ** 10:.1f}"
          f" KiB of whole leaves a window", flush=True)
    print(f"  spec {label}: launches {counts}; expected {read} {want} "
          f"({sp['windows']} windows x {2 * SPEC_K - 1} x {n_outer} outer + "
          f"{engine.spec_mid_iters} verify steps with the middle x {n_mid})"
          f"{f', copy_pages {res.cow_flushes} (COW flushes)' if args.paged else ''}")
    check(g.captures == len(engine.spec_keys) > 0,
          f"spec {label}: {g.captures} captures, {len(engine.spec_keys)} "
          f"window keys")
    check(counts[read] == want, f"spec {label}: {read} launches "
                                f"{counts[read]} != {want}")
    for (key,), st in g.stats().items():
        k, pattern = key
        per = (2 * k - 1) * n_outer + n_mid * sum(pattern)
        check(st["launches"].get(read) == per,
              f"spec {label}: window {key} launches {st['launches']}, "
              f"expected {read} {per}")
    if args.paged:
        check(counts["copy_pages"] == res.cow_flushes,
              f"spec {label}: copy_pages launches {counts['copy_pages']} != "
              f"COW flushes {res.cow_flushes}")
    del params, engine
    _free(dev)
    return counts


def _spec_timing(dev):
    """Full-width qwen3-1.7b at phase 5's traffic (192 tokens of room):
    speculative windows and plain graphed steps from the same prompts and
    weights, one of each in turn (host clock after a synchronize), then a
    profiled stretch of windows."""
    from repro_torch.engine import SOIEngine
    from repro_torch.launch import serve
    args = serve.parse_args(SERVE_ARGV + ["--gen-len", "192", "--speculate",
                                          str(SPEC_K)])
    cfg, params, prompt, plens, spec = serve.setup(args)
    plain = SOIEngine(cfg, max_concurrent_decodes=args.batch,
                      max_len=spec.max_len, device=dev)
    states = {}
    for name, eng in (("spec", spec), ("plain", plain)):
        ds = eng.init_decode_state(params)
        for slot, n in enumerate(plens):
            ds = eng.insert(eng.prefill(params, prompt[slot, :n]), ds, slot)
        states[name] = ds
    torch.cuda.synchronize(dev)
    times = {"spec": [], "plain": []}
    toks = 0
    n_iter = 24
    for _ in range(n_iter):
        for name, eng in (("spec", spec), ("plain", plain)):
            t0 = time.perf_counter()
            states[name], res = eng.generate(params, states[name])
            res = res.convert_to_numpy()
            torch.cuda.synchronize(dev)
            times[name].append((time.perf_counter() - t0) * 1e3)
            if name == "spec":
                toks += int(res.data[:, SPEC_K + 2].sum())
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    rate = {"spec": toks / (sum(times["spec"]) / 1e3),
            "plain": 4 * n_iter / (sum(times["plain"]) / 1e3)}
    st = {"ds": states["spec"]}

    def window():
        st["ds"], _res = spec.generate(params, st["ds"])
    n_prof = 4
    busy, idle, kern, reads = _loop_profile(
        window, n_prof, READ_KERNELS["split"], "decode_attention",
        "spec windows")
    print(f"  spec timing qwen3-1.7b, B 4, K {SPEC_K}: median window "
          f"{med['spec']:.3f} ms against the plain graphed step "
          f"{med['plain']:.3f} ms ({n_iter} each, in turn, host clock after "
          f"a synchronize); {toks / n_iter:.2f} tokens a window; "
          f"{rate['spec']:.1f} tok/s against {rate['plain']:.1f} plain "
          f"(ratio {rate['spec'] / rate['plain']:.3f}); profiled {n_prof} "
          f"windows: busy {busy:.3f} ms a window, idle share {idle:.3f}, "
          f"{kern:.0f} device kernels a window, decode reads {reads} on the "
          f"device == counted", flush=True)
    for (key,), v in spec.spec_graph.stats().items():
        print(f"  spec graph {key}: capture {v['capture_s'] * 1e3:.1f} ms, "
              f"pool {v['pool_bytes'] / 2 ** 20:.1f} MiB, copy-back "
              f"{v['copy_back_bytes']} B a replay, launches {v['launches']}")
    del params, spec, plain, states, st
    _free(dev)
    return med, rate


def spec_phase(dev, plain_seqs) -> dict:
    phase("15 spec (self-speculative windows: forced rejection card vs "
          "CPU; qwen3-1.7b full width --speculate 4, dense, then paged "
          "with the prefix cache and --mixed-spec)")
    _spec_parity(dev)
    k = ["--speculate", str(SPEC_K)]
    counts = {
        "dense": _spec_serve("dense", SERVE_ARGV + k, plain_seqs["dense"],
                             dev),
        "paged": _spec_serve("paged --mixed-spec",
                             PAGED_ARGV + ["--prefix-cache", "--mixed-spec"]
                             + k, plain_seqs["paged"], dev)}
    _spec_timing(dev)
    return counts


# ---------------------------------------------------------------------------
# 16. obs: the telemetry vector in the captured step, run_load, spans
# ---------------------------------------------------------------------------

# the vector's kernels a step (step_metrics: six; its buffer rides the
# result rows' copy)
MAX_VECTOR_KERNELS = 8
# the reference's telemetry budget (tests/test_obs.py): the least on/off
# ratio of interleaved trial pairs
TELEMETRY_BUDGET = 1.05
LOAD_TRACE = dict(n_tenants=4, zipf_a=1.1, prefix_len=768,
                  suffix_lens=(16, 256), gen_lens=(16, 64), burst_rate_hz=4.0,
                  burst_mean=2.0, seed=0)


def _host_vector(engine) -> list:
    """The telemetry vector of the engine's host clocks and occupancy."""
    import numpy as np
    st = engine.cfg.soi.stride
    occ = engine._occupied
    hist = np.bincount(engine._clock[occ] % st, minlength=st)
    return hist.tolist() + [int(hist[0] > 0), int(occ.sum())]


def _telemetry_on_off(dev, graph_kernels):
    """(a) phase 5's traffic through a dense engine with telemetry and one
    without, one process, the same weights: 64 steps of each (tokens,
    drained vectors against the host's clocks and branch, drains a step,
    launches), device kernels a step of each from a profiled window, then
    12 interleaved trial pairs of 8 drained steps (the reference's budget
    method). Returns the telemetry engine's launch counts."""
    from repro_torch.engine import SOIEngine, contracts
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.obs import EngineTelemetry, now
    args = serve.parse_args(SERVE_ARGV + ["--gen-len", "192"])
    cfg, params, prompt, plens, _eng = serve.setup(args)
    del _eng
    st = cfg.soi.stride
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    n_steps = 64
    runs = {}
    for tele in (False, True):
        eng = SOIEngine(cfg, max_concurrent_decodes=args.batch,
                        max_len=args.prompt_len + args.gen_len, device=dev,
                        telemetry=tele)
        ops.reset_launch_counts()
        ds = eng.init_decode_state(params)
        for slot, n in enumerate(plens):
            ds = eng.insert(eng.prefill(params, prompt[slot, :n]), ds, slot)
        toks = []
        d0, s0, m0 = contracts.drain_count(), eng.steps, eng.mid_steps
        for i in range(n_steps):
            want = _host_vector(eng)
            mid0 = eng.mid_steps
            ds, res = eng.generate(params, ds)
            res = res.convert_to_numpy()
            toks.append(res.data[:, 0].copy())
            if tele:
                check(res.metrics.tolist() == want,
                      f"obs (a) step {i}: drained vector "
                      f"{res.metrics.tolist()} != the host's {want}")
                check(int(res.metrics[st]) == eng.mid_steps - mid0,
                      f"obs (a) step {i}: mid_fired {int(res.metrics[st])} "
                      f"against the host's branch {eng.mid_steps - mid0}")
            else:
                check(res.metrics is None, "obs (a): telemetry off gave a "
                                           "metrics vector")
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        drains = contracts.drain_count() - d0
        steps, mids = eng.steps - s0, eng.mid_steps - m0
        check(drains == n_steps, f"obs (a) telemetry {tele}: {drains} "
                                 f"drains in {n_steps} steps")
        want_dec = n_outer * steps + n_mid * mids
        check(counts["decode_attention"] == want_dec
              and counts["flash_attention"] == cfg.n_layers * len(plens),
              f"obs (a) telemetry {tele}: launches {counts}, expected "
              f"decode_attention {want_dec}")
        check(eng.graph.captures == 2, f"obs (a) telemetry {tele}: "
                                       f"{eng.graph.captures} captures")
        runs[tele] = {"eng": eng, "ds": ds, "toks": toks, "counts": counts,
                      "graph": {k: v["launches"]
                                for k, v in eng.graph.stats().items()}}
    off, on = runs[False], runs[True]
    check(all((a == b).all() for a, b in zip(on["toks"], off["toks"])),
          "obs (a): tokens with telemetry differ from tokens without")
    check(on["graph"] == off["graph"], f"obs (a): launches a replay "
                                       f"{on['graph']} != {off['graph']}")
    print(f"  (a) qwen3-1.7b dense B 4, {n_steps} steps each: tokens equal "
          f"with and without telemetry; every drained vector == the host "
          f"clocks' (mid_fired == the host's branch); one drain a step "
          f"either way; 2 captures each, the same launches a replay "
          f"{on['graph']}; launches on {on['counts']}", flush=True)
    kern = {}
    for tele, run in runs.items():
        r = {"ds": run["ds"], "prev": None}
        eng = run["eng"]

        def step():
            r["ds"], res = eng.generate(params, r["ds"])
            if r["prev"] is not None:
                r["prev"].convert_to_numpy()
            r["prev"] = res
        busy, idle, kern[tele], _seen = _loop_profile(
            step, 16, READ_KERNELS["split"], "decode_attention",
            f"obs telemetry {tele}")
        run["ds"] = r["ds"]
        print(f"  (a) telemetry {'on' if tele else 'off'}: profiled 16 "
              f"steps: {kern[tele]:.2f} device kernels a step, busy "
              f"{busy:.3f} ms a step, idle share {idle:.3f}", flush=True)
    extra = kern[True] - kern[False]
    print(f"  (a) device kernels a step: off {kern[False]:.2f} (phase 14: "
          f"{graph_kernels:.2f}; PERF.md records 2229), on "
          f"{kern[True]:.2f}: +{extra:.2f} for the vector (at most "
          f"{MAX_VECTOR_KERNELS})")
    check(round(kern[False]) == round(graph_kernels),
          f"obs (a): telemetry-off step {kern[False]} kernels, phase 14 "
          f"{graph_kernels}")
    check(0 < extra <= MAX_VECTOR_KERNELS,
          f"obs (a): the vector adds {extra} kernels a step")

    tel = EngineTelemetry(st)

    def trial(run, telemetry):
        eng, ds, pending = run["eng"], run["ds"], None
        t0 = now()
        for _ in range(8):
            ds, res = eng.generate(params, ds)
            if pending is not None:
                r = pending.convert_to_numpy()
                if telemetry is not None:
                    telemetry.observe_result(r)
            pending = res
        r = pending.convert_to_numpy()
        if telemetry is not None:
            telemetry.observe_result(r)
        run["ds"] = ds
        return (now() - t0) * 1e3 / 8
    import gc
    times = {True: [], False: []}
    ratios = []
    gc.collect()
    gc.disable()
    try:
        for _ in range(12):
            t_off = trial(off, None)
            t_on = trial(on, tel)
            times[False].append(t_off)
            times[True].append(t_on)
            ratios.append(t_on / t_off)
    finally:
        gc.enable()
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"  (a) median step {med[True]:.3f} ms with telemetry, "
          f"{med[False]:.3f} without (12 interleaved pairs of 8 drained "
          f"steps, host clock to the last drain); on/off per pair "
          f"{' '.join(f'{x:.3f}' for x in ratios)}; least "
          f"{min(ratios):.3f} (budget {TELEMETRY_BUDGET})", flush=True)
    check(min(ratios) <= TELEMETRY_BUDGET,
          f"obs (a): telemetry costs more than {TELEMETRY_BUDGET - 1:.0%} "
          f"in every pair: {ratios}")
    counts = on["counts"]
    del runs, off, on, params
    _free(dev)
    return counts


def _run_load(dev):
    """(b) run_load's multi-tenant trace through a paged prefix-cache
    engine with telemetry, first-come then phase-aligned: every request
    completes, the cache hits, the chunk, paged decode and copy kernels
    launch as the engine's counters and the spans give them; TTFT, TPOT,
    queue wait, occupancy and coherence; the trace and metrics files
    written and read back. Returns the launch counts of both runs."""
    import os
    import tempfile
    from repro_torch import configs
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.obs import make_trace, run_load, write_metrics, \
        write_trace
    cfg = configs.get("qwen3-1.7b", soi="pp")
    params = T.cast_params(T.init(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev, dtype=T._dtype(cfg)), cfg)
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    chunk = 256
    eng = SOIEngine(cfg, max_concurrent_decodes=4, max_len=1152, device=dev,
                    paged=True, page_size=16, prefill_chunk=chunk,
                    prefix_cache=True, telemetry=True)
    reqs = make_trace(24, cfg.vocab, **LOAD_TRACE)
    total = {}
    for align in (False, True):
        label = "phase-aligned" if align else "first-come"
        s0, m0, f0 = eng.steps, eng.mid_steps, eng.cow_flushes
        ops.reset_launch_counts()
        res = run_load(eng, params, reqs, phase_align=align)
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        s = res.summary
        steps, mids = eng.steps - s0, eng.mid_steps - m0
        chunks = sum(-(-len(r.tokens) // chunk)
                     - res.tracer.get(r.rid).tokens_skipped // chunk
                     for r in reqs)
        want = {"chunk_attention": (n_outer + n_mid) * chunks,
                "paged_decode_attention": n_outer * steps + n_mid * mids,
                "copy_pages": eng.cow_flushes - f0,
                "decode_attention": 0, "flash_attention": 0}
        print(f"  (b) run_load {label}: {s['completed']}/{len(reqs)} "
              f"completed in {s['steps']} steps ({mids} with the middle); "
              f"TTFT p50 {s['ttft_p50_s'] * 1e3:.1f} / p99 "
              f"{s['ttft_p99_s'] * 1e3:.1f} ms, TPOT p50 "
              f"{s['tpot_p50_s'] * 1e3:.3f} / p99 {s['tpot_p99_s'] * 1e3:.3f}"
              f" ms, queue wait p50 {s['queue_wait_p50_s'] * 1e3:.1f} / p99 "
              f"{s['queue_wait_p99_s'] * 1e3:.1f} ms; {s['tok_s']:.1f} tok/s"
              f" over {s['elapsed_s']:.3f} s; hit rate {s['hit_rate']:.3f}, "
              f"{s['tokens_skipped']} prompt tokens skipped, deferred "
              f"{s['deferred_admissions']}, phase-deferred "
              f"{s['phase_deferred']} (host clock, virtual across idle gaps)",
              flush=True)
        # the prefill spans' host seconds (prefill calls, eager; the device
        # tail lands in the first token's read right after the insert)
        pre = sum(tr.prefill_end - tr.prefill_start
                  for tr in res.tracer.traces)
        print(f"  (b) {label}: prefill spans {pre:.3f} s of "
              f"{s['elapsed_s']:.3f} s ({pre / s['elapsed_s']:.3f}); decode "
              f"{s['decode_tokens']} tokens, "
              f"{s['elapsed_s'] / steps * 1e3:.3f} ms of the run a step",
              flush=True)
        occ = res.telemetry.off_phase_rate_by_occupancy()
        coh = res.telemetry.phase_coherence()
        print(f"  (b) {label}: off-phase rate by occupancy "
              f"{ {k: round(v, 4) for k, v in occ.items()} }; coherence "
              f"{coh['coherent_step_rate']:.4f} of active steps fully "
              f"aligned, modal fraction {coh['modal_fraction_mean']:.4f}; "
              f"launches {counts}, expected {want} ({chunks} chunks)",
              flush=True)
        check(s["completed"] == len(reqs), f"obs (b) {label}: "
              f"{s['completed']} of {len(reqs)} requests completed")
        check(s["hit_rate"] > 0, f"obs (b) {label}: no prefix-cache hit")
        for name, n in want.items():
            check(counts[name] == n, f"obs (b) {label}: {name} launches "
                                     f"{counts[name]} != {n}")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        with tempfile.TemporaryDirectory() as tmp:
            tpath = os.path.join(tmp, "trace.json")
            mpath = os.path.join(tmp, "metrics.json")
            write_trace(res.tracer, tpath)
            write_metrics(mpath, registry=res.telemetry.registry,
                          tracer=res.tracer, extra=s)
            with open(tpath) as fh:
                ev = json.load(fh)["traceEvents"]
            with open(mpath) as fh:
                met = json.load(fh)
            check(len({e["tid"] for e in ev}) == len(reqs)
                  and met["trace.completed"] == len(reqs)
                  and met["engine.steps"] == s["steps"],
                  f"obs (b) {label}: the trace or metrics file read back "
                  f"wrong")
            print(f"  (b) {label}: Chrome trace {os.path.getsize(tpath)} B "
                  f"({len(ev)} events, {len(reqs)} tracks), metrics JSON "
                  f"{os.path.getsize(mpath)} B ({len(met)} keys), read back",
                  flush=True)
    del eng, params
    _free(dev)
    return total


def _spec_telemetry(dev, plain_seqs):
    """(c) phase 15's dense traffic with --speculate 4 --trace-out
    --metrics-out through launch/serve.py: the plain run's tokens, one
    accepted-count sample a speculating slot a drained window, one
    telemetry step a drained window."""
    import os
    import tempfile
    from repro_torch.launch import serve
    with tempfile.TemporaryDirectory() as tmp:
        tpath = os.path.join(tmp, "trace.json")
        mpath = os.path.join(tmp, "metrics.json")
        args = serve.parse_args(SERVE_ARGV + [
            "--speculate", str(SPEC_K), "--trace-out", tpath,
            "--metrics-out", mpath])
        res = serve.run(args)
        with open(mpath) as fh:
            met = json.load(fh)
        with open(tpath) as fh:
            ev = json.load(fh)["traceEvents"]
    if (res.seqs.shape != plain_seqs.shape
            or (res.seqs != plain_seqs).any()):
        raise RuntimeError(f"obs (c): tokens differ from phase 5's at "
                           f"{_first_diff(res.seqs, plain_seqs)}")
    windows = res.spec["windows"]
    # the loop leaves the window dispatched last undrained once every
    # request is done (the reference's loop does the same)
    drained = met["engine.steps"]
    n_spec = len(res.seqs)
    acc = met["engine.spec_accepted_per_window.count"]
    print(f"  (c) --speculate {SPEC_K} --trace-out --metrics-out: tokens "
          f"equal to phase 5's; {windows} windows, {drained} drained "
          f"(engine.steps); engine.spec_accepted_per_window count {acc} "
          f"(mean {met['engine.spec_accepted_per_window.mean']:.3f}) for "
          f"{n_spec} speculating slots; mid_fired "
          f"{met['engine.mid_fired_steps']}, off-phase "
          f"{met['engine.off_phase_steps']}; TTFT p50 "
          f"{met['trace.ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
          f"{met['trace.tpot_p50_s'] * 1e3:.3f} ms; {len(ev)} trace events",
          flush=True)
    check(drained == windows - 1 and met["engine.spec.windows"] == windows,
          f"obs (c): engine.steps {drained} against {windows} windows")
    check(acc == drained * n_spec, f"obs (c): {acc} accepted-count samples "
                                   f"for {drained} windows x {n_spec} slots")
    _free(dev)


def _unet_registry(dev):
    """(d) the U-Net session with a registry: its pushes counted, its
    frames bit for bit those of the same session without one, the push
    dispatch latency. Returns the registry session's launch counts."""
    from repro_torch.engine.session import unet_stream_session
    from repro_torch.kernels import ops
    from repro_torch.models import unet as U
    from repro_torch.obs import MetricsRegistry
    cfg = _unet_cfg(STREAM_SOIS[0][1])
    model = U.init(cfg, generator=torch.Generator(device=dev).manual_seed(9),
                   device=dev)
    n = 192
    x = torch.randn((1, n, cfg.in_channels), generator=torch.Generator(
        device=dev).manual_seed(27), device=dev)
    plain = unet_stream_session(model, cfg, batch=1, device=dev)
    ys = [plain.push(x[:, t]) for t in range(n)]
    reg = MetricsRegistry()
    sess = unet_stream_session(model, cfg, batch=1, device=dev,
                               registry=reg)
    ops.reset_launch_counts()
    got = [sess.push(x[:, t]) for t in range(n)]
    torch.cuda.synchronize(dev)
    counts = ops.launch_counts()
    check(all(torch.equal(a, b) for a, b in zip(got, ys)),
          "obs (d): frames with a registry differ from frames without")
    d = reg.as_dict()
    want = _planned_convs(cfg, n)
    print(f"  (d) U-Net B 1 STMC baseline, {n} frames with a registry: "
          f"session.pushes {d['session.pushes']}, frames bit for bit those "
          f"without; push dispatch p50 "
          f"{d['session.push_dispatch_s.p50'] * 1e6:.1f} / p99 "
          f"{d['session.push_dispatch_s.p99'] * 1e6:.1f} us (host clock, "
          f"the first push captures); stmc_conv {counts['stmc_conv']} "
          f"launches (plan {want})", flush=True)
    check(d["session.pushes"] == n, f"obs (d): {d['session.pushes']} pushes")
    check(counts["stmc_conv"] == want, f"obs (d): stmc_conv launches "
                                       f"{counts['stmc_conv']} != {want}")
    del model, plain, sess
    _free(dev)
    return counts


def obs_phase(dev, plain_seqs, graph_kernels) -> dict:
    phase("16 obs (the telemetry vector in the captured step, on vs off; "
          "run_load's multi-tenant trace at full width; speculative "
          "windows with --trace-out/--metrics-out; the U-Net session's "
          "registry)")
    t0 = time.perf_counter()
    a = _telemetry_on_off(dev, graph_kernels)
    b = _run_load(dev)
    _spec_telemetry(dev, plain_seqs["dense"])
    d = _unet_registry(dev)
    print(f"  phase 16 in {time.perf_counter() - t0:.1f} s")
    return {"decode_attention": (a, "obs (a) dense, telemetry on"),
            "flash_attention": (a, "obs (a) dense, telemetry on"),
            "chunk_attention": (b, "obs (b) run_load, both runs"),
            "paged_decode_attention": (b, "obs (b) run_load, both runs"),
            "copy_pages": (b, "obs (b) run_load, both runs"),
            "stmc_conv": (d, "obs (d) U-Net session with a registry")}


# ---------------------------------------------------------------------------
# 17. train
# ---------------------------------------------------------------------------

# (label, B, S) at qwen3's H 16 / Hkv 8 / dh 128: the training step's
# attention, the SOI middle's, the serving prefill bucket's, and the
# sequence length of Qwen3's general pretraining stage (arXiv 2505.09388)
BWD_SHAPES = (("train", 8, 128), ("SOI middle", 8, 64),
              ("prefill bucket", 1, 1024), ("pretraining length", 1, 4096))
# the shapes whose bf16 backward is timed; the first is the JSON's main row
BWD_TIMED = ("train", "prefill bucket", "pretraining length")
FWD_LSE_PAIRS = 3        # forward without / with lse, read in turns
# the bf16 backward's kernels, each once a call: dQ (which computes delta),
# then dK/dV
BWD_KERNELS = ("dq_kernel", "dkdv_kernel")
LSE_REL_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-3}
TRAIN_STEPS = 20
TRAIN_ARGV = ["--arch", "qwen3-1.7b", "--steps", str(TRAIN_STEPS),
              "--batch", "8", "--seq", "128", "--log-every", "10"]
GRAD_TOL = 1e-4          # (b): loss, grads and updates, kernels vs plain
RESTART_TOL = 1e-6       # (d): resumed vs uninterrupted params
# AdamW's first step is g / (|g| + eps) an element of the clipped
# gradient: where the two routes' clipped gradients differ by more than 1%
# of the smaller, or the smaller is within 100x of eps, the step amplifies
# the routes' rounding. Elsewhere it moves the step by at most
# eps / (100 |g|) <= 1e-4 of its size
WELL_CONDITIONED = 100.0


def _train_want(cfg, flash: int, lru: int = 0, times: int = 1) -> dict:
    """The kernel launches of ``times`` losses and gradients of ``cfg``
    whose backward launches ``flash`` flash_attention_bwd and ``lru``
    lru_scan_bwd: as many forwards without remat, twice as many with it
    (every layer these phases train sits in a scanned segment, whose
    groups the backward recomputes: ``models.remat``)."""
    segs = list(cfg.segments) + (
        [] if cfg.encoder is None else list(cfg.encoder.segments))
    check(all(seg.scan for seg in segs),
          f"{cfg.name}: an unscanned segment's layers are not recomputed")
    k = 2 if cfg.remat else 1
    return {"flash_attention": k * flash * times,
            "flash_attention_bwd": flash * times,
            "lru_scan": k * lru * times, "lru_scan_bwd": lru * times}


def _bwd_inputs(b, s, dt, dev, gen, heads=(16, 8), dims=(128, 128),
                sk=None, causal=True):
    """A maker of (q, k, v, o, dO, lse) at qwen3's H 16 / Hkv 8 / dh 128
    (or ``heads`` (H, Hkv) and ``dims`` (d_qk, d_v)), ``s`` queries and
    ``sk`` keys (default ``s``), the forward's o and lse from its kernel
    (``causal`` or not), and the bytes the backward must move."""
    from repro_torch.kernels import flash_attention as FA
    h, hkv = heads
    dqk, dv = dims
    sk = s if sk is None else sk

    def make():
        q = torch.randn((b, s, h, dqk), generator=gen, device=dev).to(dt)
        k = torch.randn((b, sk, hkv, dqk), generator=gen, device=dev).to(dt)
        v = torch.randn((b, sk, hkv, dv), generator=gen, device=dev).to(dt)
        do = torch.randn((b, s, h, dv), generator=gen, device=dev).to(dt)
        out, lse = FA.forward_launch(q, k, v, causal=causal, q_offset=0,
                                     scale=dqk ** -0.5, cap=0.0,
                                     with_lse=True)
        return q, k, v, out, do, lse
    esz = torch.finfo(dt).bits // 8
    # q read and dq written at H heads of d_qk, o and dO read at H of d_v;
    # k read and dk written at Hkv of d_qk, v and dv at Hkv of d_v; lse
    # read once
    nbytes = (b * s * esz * (2 * h * dqk + 2 * h * dv)
              + b * sk * esz * (2 * hkv * dqk + 2 * hkv * dv)
              + b * h * s * 4)
    return make, nbytes


def _bwd_kernel_checks(dev, gen) -> dict:
    """(a): the forward's lse and output, and the backward against the plain
    versions at the four shapes in f32 and bf16, twice for the bits; the
    bf16 times at the three timed shapes. Returns the JSON record: the
    training shape's, the others under "shapes"."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    recs = {}
    for label, b, s in BWD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            make, nbytes = _bwd_inputs(b, s, dt, dev, gen)
            q, k, v, out, do, lse = make()
            want_o = ref.flash_attention(q, k, v)
            want_lse = ref.attention_lse(q, k)
            err_o = float((out.float() - want_o.float()).abs().max())
            err_lse = float((lse - want_lse).abs().max()
                            / want_lse.abs().max())
            del want_o, want_lse
            check(err_o < TOL[dt], f"flash fwd {label} {dt}: {err_o}")
            check(err_lse < LSE_REL_TOL[dt],
                  f"flash lse {label} {dt}: rel {err_lse}")
            got = FA.flash_attention_bwd(q, k, v, out, do, lse)
            again = FA.flash_attention_bwd(q, k, v, out, do, lse)
            want = ref.flash_attention_bwd(q, k, v, out, do, lse)
            torch.cuda.synchronize(dev)
            rels, abs_err = [], 0.0
            for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
                check(torch.equal(g, a), f"flash_attention_bwd {label} "
                                         f"{dt} {name}: not bit for bit")
                d = float((g.float() - w.float()).abs().max())
                abs_err = max(abs_err, d)
                rels.append(d / float(w.float().abs().max()))
                check(rels[-1] <= TOL[dt], f"flash_attention_bwd {label} "
                      f"{dt} {name}: rel max|Δ| {rels[-1]} > {TOL[dt]}")
            print(f"  {label} ({b},{s},16/8,128) {str(dt)[6:]}: out max|Δ| "
                  f"{err_o:.2e}, lse rel {err_lse:.2e}; bwd rel max|Δ| dq "
                  f"{rels[0]:.2e} dk {rels[1]:.2e} dv {rels[2]:.2e}; run to "
                  f"run bit for bit", flush=True)
            del q, k, v, out, do, lse, got, again, want
            if label in BWD_TIMED and dt == torch.bfloat16:
                recs[label] = _bwd_timing(make, nbytes, b, s, dt, abs_err,
                                          with_fwd=label == BWD_TIMED[0])
            _free(dev)
    rec = recs[BWD_TIMED[0]]
    rec["shapes"] = [recs[label] for label in BWD_TIMED[1:]]
    return rec


def _sdpa(q, k, v, grad: bool, causal: bool = True):
    """SDPA on the kernel's inputs, K/V repeated to H heads and (B, H, S, d)
    views (a yardstick: the port never calls it); with ``grad`` the leaves
    require grad."""
    g = q.shape[2] // k.shape[2]
    qq, kk, vv = (t.transpose(1, 2).detach().requires_grad_(grad)
                  for t in (q, k.repeat_interleave(g, dim=2),
                            v.repeat_interleave(g, dim=2)))
    o = torch.nn.functional.scaled_dot_product_attention(qq, kk, vv,
                                                         is_causal=causal)
    return o, (qq, kk, vv)


def _bwd_timing(make, nbytes, b, s, dt, abs_err, with_fwd, heads=(16, 8),
                dims=(128, 128), sk=None, causal=True) -> dict:
    """The bf16 backward's device ms at (b, s) beside its plain version,
    SDPA's backward and the bound, with its two kernels apart; with
    ``with_fwd`` also the forward's: without and with its lse in turns
    (FWD_LSE_PAIRS pairs), the plain forward and SDPA's forward, and its
    bound. ``heads``, ``dims``, ``sk`` and ``causal`` as
    ``_bwd_inputs``'s."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    h, hkv = heads
    dqk, dv = dims
    sk = s if sk is None else sk
    sets = _copies(make, nbytes)
    # the (query, key) pairs the products run over: the causal triangle
    # (Sq == Sk, q_offset 0), or every pair
    pairs = s * (s + 1) // 2 if causal else s * sk
    # five products of the recompute scheme: S, dQ, dK over d_qk; dP, dV
    # over d_v
    flops = 2.0 * b * h * pairs * (3 * dqk + 2 * dv)
    bound, by = _bound(nbytes, flops, dt)
    parts = {}
    ms = _device_ms(functools.partial(FA.flash_attention_bwd,
                                      causal=causal), sets,
                    50 if s <= 1024 else 20, by_name=parts, bound_ms=bound,
                    markers=MARKERS, each=BWD_KERNELS)
    split = {key: sum(t for n, t in parts.items() if key in n)
             for key in BWD_KERNELS}
    plain_ms = _device_ms(functools.partial(ref.flash_attention_bwd,
                                            causal=causal), sets[:4],
                          5 if s <= 1024 else 2, markers=MARKERS)

    def sdpa_graph(q, k, v, out, do, lse):
        o, ins = _sdpa(q, k, v, True, causal)
        return o, ins, do.transpose(1, 2)
    graphs = [sdpa_graph(*st) for st in sets[:8]]

    def sdpa_bwd(i):
        o, ins, g = graphs[i]
        return torch.autograd.grad(o, ins, g, retain_graph=True)
    lib_ms = _device_ms(sdpa_bwd, [(i,) for i in range(len(graphs))], 20,
                        markers=MARKERS)
    del graphs
    shape = [b, s, h, hkv, dqk] + ([dv] if dv != dqk else [])
    rec = {"name": "flash_attention_bwd", "max_abs_err": abs_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": lib_ms, "shape": shape,
           "dtype": "bfloat16", "parts_ms": split,
           "useful_tflops": flops / ms / 1e9}
    if sk != s or not causal:
        rec.update(sk=sk, causal=causal)
    label = (f"({b},{s}" + (f"/Sk {sk}" if sk != s else "")
             + f",{h}/{hkv},{dqk}" + (f"/{dv})" if dv != dqk else ")")
             + ("" if causal else " non-causal"))
    print(f"  flash_attention_bwd {label} bf16: {ms:.4f} ms "
          f"(dQ {split['dq_kernel']:.4f}, dK/dV {split['dkdv_kernel']:.4f}), "
          f"{rec['useful_tflops']:.1f} TFLOP/s useful; "
          f"plain {plain_ms:.4f}; SDPA backward {lib_ms:.4f}; bound "
          f"{bound:.5f} ms ({by}; {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP)", flush=True)
    if with_fwd:
        # the forward with its lse against the serving launch without, in
        # turns; its bound: q, k, v, o and lse once, 2 products
        fwd = {False: [], True: []}
        for _ in range(FWD_LSE_PAIRS):
            for with_lse in (False, True):
                fwd[with_lse].append(_device_ms(
                    lambda q, k, v, out, do, lse, w=with_lse:
                    FA.forward_launch(q, k, v, causal=True, q_offset=0,
                                      scale=128 ** -0.5, cap=0.0,
                                      with_lse=w), sets, 50,
                    markers=MARKERS, each=("flash_attention_kernel",)))
        esz = torch.finfo(dt).bits // 8
        f_bytes = b * s * 128 * esz * (2 * 16 + 2 * 8) + b * 16 * s * 4
        f_bound, f_by = _bound(f_bytes, 4.0 * b * 16 * 128 * pairs, dt)
        f_plain = _device_ms(lambda q, k, v, *_: ref.flash_attention(q, k, v),
                             sets[:4], 5, markers=MARKERS)
        f_lib = _device_ms(lambda q, k, v, *_: _sdpa(q, k, v, False)[0],
                           sets, 50, markers=MARKERS)
        lo = {w: min(r) for w, r in fwd.items()}
        print(f"  flash_attention fwd ({b},{s},16/8,128) bf16, without / "
              f"with lse in turns: "
              + ", ".join(f"{a:.4f} / {c:.4f}"
                          for a, c in zip(fwd[False], fwd[True]))
              + f" ms (spread {max(fwd[False]) - lo[False]:.4f} / "
              f"{max(fwd[True]) - lo[True]:.4f}); plain {f_plain:.4f}; "
              f"SDPA forward {f_lib:.4f}; bound {f_bound:.5f} ms ({f_by}; "
              f"{f_bytes / 1e6:.2f} MB)", flush=True)
        rec.update(fwd_ms=fwd[False], fwd_lse_ms=fwd[True],
                   fwd_plain_ms=f_plain, fwd_library_ms=f_lib,
                   fwd_bound_ms=f_bound, fwd_bound_by=f_by)
    return rec


def _train_batch(pipe, step, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in
            pipe.batch(step).items()}


def _grads(model, cfg, batch):
    from repro_torch.models import transformer as T
    named = dict(model.named_parameters())
    loss, _ = T.loss_fn(model, cfg, batch)
    return loss.detach(), dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))


def _grad_parity(dev):
    """(b): one train step of full-width qwen3 cut to 4 layers (SOI pp
    over layers 1..2), f32, through the kernels and again with attention
    on the plain version: loss, every gradient and every update."""
    from repro_torch import configs
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(configs.get("qwen3-1.7b", soi="pp",
                                          n_layers=4), dtype="float32")
    pipe = ShardedLMPipeline(global_batch=8, seq_len=128, vocab=cfg.vocab,
                             seed=0)
    batch = _train_batch(pipe, 0, dev)
    kern = T.init(cfg, generator=torch.Generator(device=dev).manual_seed(3),
                  device=dev)
    plain = copy.deepcopy(kern)
    before = {k: p.detach().clone() for k, p in kern.named_parameters()}
    step = make_train_step(cfg, peak_lr=1e-3, warmup=20,
                           total_steps=TRAIN_STEPS)
    res = {}
    for route, model in (("kernels", kern), ("plain", plain)):
        saved = ops.flash_attention
        if route == "plain":       # attention on the plain version
            ops.flash_attention = ref.flash_attention
        try:
            ops.reset_launch_counts()
            loss, grads = _grads(model, cfg, batch)
            _, _, m = step(model, adamw_init(dict(model.named_parameters())),
                           batch)
            torch.cuda.synchronize(dev)
            counts = ops.launch_counts()
        finally:
            ops.flash_attention = saved
        res[route] = (loss, grads, m, counts)
    (lk, gk, mk, ck), (lp, gp, mp, cp) = res["kernels"], res["plain"]
    want = _train_want(cfg, cfg.n_layers, times=2)   # loss_fn, the step
    check(all(ck[k] == n for k, n in want.items()),
          f"4-layer parity: {ck} (want {want}: loss_fn, then the step)")
    check(cp["flash_attention"] == 0 and cp["flash_attention_bwd"] == 0,
          f"plain route launched kernels: {cp}")
    rel_loss = abs(float(lk) - float(lp)) / abs(float(lp))
    rel_step = abs(float(mk["loss"]) - float(mp["loss"])) / abs(
        float(mp["loss"]))
    check(rel_loss <= GRAD_TOL and rel_step <= GRAD_TOL,
          f"4-layer loss {float(lk)} vs plain {float(lp)}")
    from repro_torch.optim import clip_by_global_norm
    ck_, _ = clip_by_global_norm(gk, 1.0)     # what the step's AdamW saw
    cp_, _ = clip_by_global_norm(gp, 1.0)
    worst_g = worst_u = 0.0
    cond = total = 0
    new_k = dict(kern.named_parameters())
    new_p = dict(plain.named_parameters())
    for k, p0 in before.items():
        g_rel = float((gk[k] - gp[k]).abs().max()
                      / gp[k].abs().max().clamp_min(1e-30))
        worst_g = max(worst_g, g_rel)
        check(g_rel <= GRAD_TOL, f"4-layer grad {k}: rel {g_rel}")
        uk, up = new_k[k].detach() - p0, new_p[k].detach() - p0
        # the update where AdamW is well conditioned (WELL_CONDITIONED)
        ok = torch.minimum(ck_[k].abs(), cp_[k].abs()) >= WELL_CONDITIONED * (
            (ck_[k] - cp_[k]).abs() + 1e-8)
        cond += int(ok.sum())
        total += ok.numel()
        if ok.any():
            # the updates are read off float32 params: two steps a hair
            # apart may round to neighbouring floats, one ulp of the
            # param (<= |p| 2^-23) apart
            ulp = new_p[k].detach().abs() * 2.0 ** -23
            u_rel = float((((uk - up).abs() - ulp).clamp_min(0) * ok).max()
                          / up.abs().max())
            worst_u = max(worst_u, u_rel)
            check(u_rel <= GRAD_TOL, f"4-layer update {k}: rel {u_rel}")
    strict = max(float((new_k[k].detach() - new_p[k].detach()).abs().max()
                       / (new_p[k].detach() - before[k]).abs().max()
                       .clamp_min(1e-30)) for k in before)
    print(f"  (b) qwen3 full width, 4 layers (SOI pp), f32, B 8 S 128: loss "
          f"{float(lk):.6f} vs plain {float(lp):.6f} (rel {rel_loss:.2e}); "
          f"worst grad rel max|Δ| {worst_g:.2e}; worst update rel max|Δ| "
          f"{worst_u:.2e} over the {cond / total:.4f} of elements whose "
          f"clipped gradients are >= {WELL_CONDITIONED:g} x (their "
          f"difference + eps) (over every element: {strict:.2e})")
    del kern, plain, before, res
    # a bf16 step through the kernels: finite
    cfg16 = configs.get("qwen3-1.7b", soi="pp", n_layers=4)
    model = T.init(cfg16, generator=torch.Generator(device=dev)
                   .manual_seed(4), device=dev)
    step16 = make_train_step(cfg16, peak_lr=1e-3, warmup=20,
                             total_steps=TRAIN_STEPS)
    _, _, m = step16(model, adamw_init(dict(model.named_parameters())),
                     batch)
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    check(bool(torch.isfinite(m["loss"])) and finite,
          "4-layer bf16 step: non-finite")
    print(f"  (b) the same in bf16 over f32 masters: loss "
          f"{float(m['loss']):.4f}, params finite")


def _model_flops(cfg, b, s) -> float:
    """Matmul FLOPs of one train step (forward + backward = 3 x forward):
    each layer's weights at its own rate (the SOI middle at ceil(S/2)
    frames), the tied head, the S-CC convs, and causal attention."""
    from repro_torch.models import transformer as T
    a = cfg.segments[0].blocks[0].attn
    d = cfg.d_model
    layer_w = (d * a.n_heads * a.head_dim * 2 + 2 * d * a.n_kv * a.head_dim
               + 3 * d * cfg.segments[0].blocks[0].mlp.d_ff)
    lens = [s] * cfg.n_layers
    if cfg.soi is not None:
        sm = -(-s // cfg.soi.stride)
        pre, mid, _ = (sum(g.n_layers for g in part)
                       for part in T.soi_partition(cfg))
        lens = [s] * pre + [sm] * mid + [s] * (cfg.n_layers - pre - mid)
    fwd = sum(2 * layer_w * b * t + 4 * b * a.n_heads * a.head_dim
              * t * (t + 1) / 2 for t in lens)
    fwd += 2 * cfg.vocab * d * b * s
    if cfg.soi is not None:
        fwd += 2 * cfg.soi.stride * d * d * b * -(-s // cfg.soi.stride)
        fwd += 2 * 2 * d * d * b * s
    return 3.0 * fwd


def _full_train(dev, card):
    """(c): launch.train.main on full-width, full-depth qwen3-1.7b (bf16
    over f32 masters), without SOI and with pp; then the step timed and
    profiled on a fresh state. Returns {run: launch counts}."""
    from repro_torch import configs
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    out = {}
    for soi in (None, "pp"):
        label = "dense" if soi is None else "SOI pp"
        argv = TRAIN_ARGV + (["--soi", soi] if soi else [])
        want = _train_want(configs.get("qwen3-1.7b", soi=soi), 28,
                           times=TRAIN_STEPS)
        _free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        losses = train.main(argv)
        torch.cuda.synchronize(dev)
        took = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
              f"{label}: non-finite losses {losses}")
        last5 = sum(losses[-5:]) / 5
        check(last5 < losses[0], f"{label}: loss {losses[0]} -> mean of the "
                                 f"last 5 {last5}: not falling")
        for name in ("flash_attention", "flash_attention_bwd"):
            check(counts[name] == want[name],
                  f"{label}: {name} {counts[name]} launches, want "
                  f"{want[name]}")
        out[label] = counts
        print(f"  (c) qwen3-1.7b {label}, 28 layers, B 8 S 128, "
              f"{TRAIN_STEPS} steps: loss {losses[0]:.4f} -> last 5 "
              f"{last5:.4f}; {took:.1f} s in main; flash_attention "
              f"{counts['flash_attention']} / flash_attention_bwd "
              f"{counts['flash_attention_bwd']} launches (56 / 28 a step: "
              f"remat recomputes each layer's forward); peak "
              f"{peak / 2 ** 30:.2f} GiB allocated  [{card}]")
        # the step alone, on a fresh state: median of 4 after 2, then a
        # profiled window of 3
        _free(dev)
        cfg = configs.get("qwen3-1.7b", soi=soi)
        model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)
        opt = adamw_init(dict(model.named_parameters()))
        step = make_train_step(cfg, peak_lr=1e-3, warmup=20,
                               total_steps=TRAIN_STEPS)
        pipe = ShardedLMPipeline(global_batch=8, seq_len=128,
                                 vocab=cfg.vocab, seed=0)
        batches = [_train_batch(pipe, i, dev) for i in range(9)]
        times = []
        for i in range(6):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            step(model, opt, batches[i])
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        med = sorted(times[2:])[2] * 1e3
        ev = _device_events(lambda: [step(model, opt, batches[6 + i])
                                     for i in range(3)])
        window = max(e for _s, e, _n in ev) - min(s_ for s_, _e, _n in ev)
        flops = _model_flops(cfg, 8, 128)
        print(f"  (c) {label} step: median {med:.2f} ms (host clock after a "
              f"synchronize, 4 steps), {8 * 128 / med * 1e3:.0f} tokens/s; "
              f"model FLOPs {flops / 1e12:.2f} TFLOP a step, "
              f"{flops / (med * 1e-3) / 1e12:.1f} TFLOP/s = "
              f"{flops / (med * 1e-3) / PEAK_FLOPS[torch.bfloat16]:.3f} of "
              f"989 bf16 dense; {len(ev) / 3:.0f} device kernels a step "
              f"[{card}]")
        busy = _window_profile(ev, 3, f"(c) {label}, 3 profiled steps:",
                               "step")
        print(f"  (c) {label} busy share {busy / window:.3f}")
        del model, opt, step
    return out


def _restart_parity(dev):
    """(d): TrainSupervisor at smoke width, f32: a crash at step 7 of 12,
    checkpoints every 3, against an uninterrupted run."""
    import tempfile
    from repro_torch import configs
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.distributed.fault_tolerance import (SupervisorConfig,
                                                         TrainSupervisor)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(configs.get_smoke("qwen3-1.7b", soi="pp"),
                              dtype="float32")
    pipe = ShardedLMPipeline(global_batch=8, seq_len=64, vocab=cfg.vocab,
                             seed=0)
    step = make_train_step(cfg, peak_lr=1e-3, warmup=3, total_steps=12)

    def make_state():
        p = T.init(cfg, generator=torch.Generator(device=dev).manual_seed(5),
                   device=dev)
        return {"params": p, "opt": adamw_init(dict(p.named_parameters()))}

    def run(crash_at, directory):
        armed = {"on": crash_at is not None}

        def step_fn(state, i):
            if armed["on"] and i == crash_at:
                armed["on"] = False
                raise RuntimeError(f"simulated failure at step {i}")
            p, o, _ = step(state["params"], state["opt"],
                           _train_batch(pipe, i, dev))
            return {"params": p, "opt": o}
        sup = TrainSupervisor(SupervisorConfig(ckpt_dir=directory,
                                               ckpt_every=3),
                              make_state, step_fn, device=dev)
        return sup.run(12), sup

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        whole, _ = run(None, str(Path(tmp) / "whole"))
        resumed, sup = run(7, str(Path(tmp) / "resumed"))
    check(sup.restarts == 1 and ("restored", 5) in sup.events,
          f"restart: {sup.events}")
    check(int(resumed["opt"]["count"]) == int(whole["opt"]["count"]) == 12,
          "restart: counts")
    worst = 0.0
    a = resumed["params"].state_dict()
    for k, p in whole["params"].state_dict().items():
        d = float((a[k] - p).abs().max() / p.abs().max().clamp_min(1e-30))
        worst = max(worst, d)
        check(d <= RESTART_TOL, f"restart: {k} rel max|Δ| {d}")
    print(f"  (d) supervisor, smoke qwen3 (pp) f32: crash at step 7 of 12, "
          f"restored step 5, final params rel max|Δ| {worst:.2e} against "
          f"an uninterrupted run (<= {RESTART_TOL})")


def _unet_train(dev, card):
    """(e): soi-unet-dns at full width trained for 20 steps (the example's
    loss and optimizer), baseline and PP S-CC (3,); the trained weights
    streamed through stmc_conv against the offline graph."""
    import numpy as np
    from repro_torch.configs import soi_unet_dns
    from repro_torch.core.soi import SOIConvCfg
    from repro_torch.data.synthetic import si_snr, speech_mixture
    from repro_torch.engine.session import unet_stream_session
    from repro_torch.kernels import ops
    from repro_torch.models import unet as U
    from repro_torch.optim import adamw_init, adamw_update, \
        clip_by_global_norm
    for label, soi in (("STMC baseline", None),
                       ("PP S-CC (3,)", SOIConvCfg(pairs=(3,)))):
        cfg = soi_unet_dns.config(soi=soi)
        model = U.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(11), device=dev)
        named = dict(model.named_parameters())
        opt = adamw_init(named)
        rng = np.random.default_rng(0)
        losses, times = [], []
        for _ in range(20):
            noisy, clean = (torch.from_numpy(a).to(dev) for a in
                            speech_mixture(rng, 8, 64, cfg.in_channels))
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            y, _ = U.apply_offline(model, noisy, cfg)
            loss = torch.mean(torch.square(y - clean))
            grads = dict(zip(named, torch.autograd.grad(
                loss, list(named.values()))))
            grads, _ = clip_by_global_norm(grads, 1.0)
            adamw_update(grads, opt, named, lr=2e-3, weight_decay=0.0)
            losses.append(float(loss.detach()))
            times.append(time.perf_counter() - t0)
        check(all(map(math.isfinite, losses))
              and sum(losses[-5:]) / 5 < losses[0],
              f"U-Net {label}: losses {losses}")
        x = torch.from_numpy(speech_mixture(np.random.default_rng(1), 2, 32,
                                            cfg.in_channels)[0]).to(dev)
        ops.reset_launch_counts()
        y_on = unet_stream_session(model, cfg, batch=2, device=dev).run(x)
        torch.cuda.synchronize(dev)
        launched = ops.launch_counts()["stmc_conv"]
        with torch.no_grad():
            y_off, _ = U.apply_offline(model, x, cfg)
            noisy, clean = speech_mixture(np.random.default_rng(777), 16, 64,
                                          cfg.in_channels)
            y_ev, _ = U.apply_offline(model, torch.from_numpy(noisy).to(dev),
                                      cfg)
        err = float((y_on - y_off).abs().max())
        check(launched == _planned_convs(cfg, 32),
              f"U-Net {label}: {launched} stmc_conv launches")
        check(err < UNET_TOL, f"U-Net {label}: stream vs offline {err}")
        snri = float(np.mean(si_snr(y_ev.cpu().numpy(), clean)
                             - si_snr(noisy, clean)))
        med = sorted(times[2:])[len(times[2:]) // 2] * 1e3
        print(f"  (e) soi-unet-dns {label}, B 8 T 64, 20 steps: loss "
              f"{losses[0]:.4f} -> last 5 {sum(losses[-5:]) / 5:.4f}; step "
              f"median {med:.2f} ms; stream vs offline max|Δ| {err:.2e} "
              f"({launched} stmc_conv launches); SI-SNRi {snri:.2f} dB, MAC "
              f"retain {U.complexity_report(cfg).retain:.3f}  [{card}]")


def train_phase(dev, card) -> tuple:
    """Phase 17. Returns (the flash_attention_bwd record, {run: launch
    counts of (c)})."""
    phase("17 train")
    gen = torch.Generator(device=dev).manual_seed(17)
    rec = _bwd_kernel_checks(dev, gen)
    _grad_parity(dev)
    counts = _full_train(dev, card)
    _free(dev)
    _restart_parity(dev)
    _unet_train(dev, card)
    _free(dev)
    return rec, counts


# ---------------------------------------------------------------------------
# 18. families: olmoe-1b-7b, h2o-danube-1.8b, nemotron-4-15b and
#     mistral-large-123b through the engine
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("olmoe-1b-7b", "h2o-danube-1.8b", "nemotron-4-15b",
                "mistral-large-123b")
# the serving depth of each (None: all its layers). mistral-large-123b's 88
# layers hold 245 GB in bf16; 16 of them hold ~46 GB, alone on the card
FAMILY_LAYERS = {"mistral-large-123b": 16}
# the card-vs-CPU depth of each (4: SOI over 1..3); the two widest at 2
# (SOI over 1..2: a pre and a middle layer), their f32 weights 19.4 and
# 27.8 GB a side at 4
FAMILY_PARITY_LAYERS = {"nemotron-4-15b": 2, "mistral-large-123b": 2}
# danube paged: request 0 fits the window-4096 ring (so the prefix index
# keeps its pages), requests 1 and 2 share its first 1024 tokens and wrap
# their rings in prefill; all three wrap in decode onto shared pages
DANUBE_PLENS = (4090, 4200, 4198)
DANUBE_SHARED = 1024
DANUBE_CHUNK = 256


def _host_peak_gib() -> float:
    """The process's peak resident set on the host (Linux: KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _windowed(cfg) -> bool:
    return any(b.attn is not None and b.attn.window is not None
               for seg in cfg.segments for b in seg.blocks)


def _counts_want(counts, want, label):
    """Every kernel's launches equal ``want`` (0 where it names none)."""
    for name, n in counts.items():
        check(n == want.get(name, 0),
              f"{label}: {name} launches {n} != {want.get(name, 0)} "
              f"(expected {want})")


def _family_parity(arch, dev) -> dict:
    """Full width cut to 4 layers (SOI over 1..3; FAMILY_PARITY_LAYERS
    cuts the widest to 2, SOI over 1..2), float32, pp: 3 slots
    (prompts of 41 and 43 tokens, a third of 37 after 3 steps), 8 greedy
    steps on the card and on the CPU, dense and paged (page 16): tokens
    identical, logits within 1e-3, launches as the host clocks give them.
    Returns {layout: the card run's counts}."""
    from repro_torch import configs
    from repro_torch.configs.base import SOILMCfg
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    n = FAMILY_PARITY_LAYERS.get(arch, 4)
    cfg = dataclasses.replace(configs.get(arch, soi="pp", n_layers=n),
                              dtype="float32")
    if n == 2:
        cfg = dataclasses.replace(cfg, soi=SOILMCfg(first_layer=1,
                                                    last_layer=2, mode="pp"))
    t0 = time.perf_counter()
    dev_model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(11), device=dev)
    cpu_model = _cpu_copy(dev_model, cfg)
    n_par = sum(p.numel() for p in dev_model.parameters())
    a = cfg.segments[0].blocks[0].attn
    print(f"  {arch} parity: {n_par / 1e9:.2f} B float32 parameters "
          f"({4 * n_par / 1e9:.1f} GB a side; H {a.n_heads} / Hkv "
          f"{a.n_kv}, dh {a.head_dim}), on the card and on the host "
          f"({time.perf_counter() - t0:.1f} s to build and copy); host peak "
          f"RSS {_host_peak_gib():.1f} GiB", flush=True)
    gen = torch.Generator().manual_seed(12)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                             dtype=torch.int32) for n in (41, 43, 37)]
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    out = {}
    host = None
    for layout, kw in (("dense", {}),
                       ("paged", dict(paged=True, page_size=16))):
        runs = []
        for where, model in ((torch.device("cpu"), cpu_model),
                             (dev, dev_model)):
            if where.type == "cpu" and host is not None:
                runs.append(host)     # the host's dense run: see HOST_RUN
                continue
            eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=64,
                            device=where, **kw)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            runs.append(_greedy(eng, model, [p.to(where) for p in prompts]))
            torch.cuda.synchronize(dev)
            counts = ops.launch_counts()          # the card run's, last
            took = time.perf_counter() - t0
        host = runs[0]
        worst = _compare_runs(runs, f"{arch} {layout}")
        read = ("paged_decode_attention" if layout == "paged"
                else "decode_attention")
        want = {read: n_outer * eng.steps + n_mid * eng.mid_steps,
                "flash_attention": 0 if _windowed(cfg) else 3 * cfg.n_layers}
        _counts_want(counts, want, f"{arch} parity {layout}")
        print(f"  {arch} {layout}: 8 steps, tokens identical, max|Δlogit| "
              f"{worst:.3e}; card launches {want} (card run "
              f"{took:.2f} s)", flush=True)
        out[layout] = counts
    print(f"  {arch}: host peak RSS {_host_peak_gib():.1f} GiB")
    del cpu_model, dev_model
    _free(dev)
    return out


def _weight_floor(params, cfg) -> tuple:
    """(bytes, ms at 3.35 TB/s) of the weights a decode step reads, with
    the SOI middle and without it (the same pair twice without SOI):
    every parameter but the embedding table (a step looks up B rows of it;
    the head reads the table when tied), a learned position table (B rows
    a step), an encoder (it runs at prefill) and the cross layers' K/V
    projections (their products are in the decode state); without the
    middle's layers and the compress conv when it is skipped. A MoE
    layer's experts count whole: the port multiplies every expert's
    capacity buffer (ROADMAP.md Queue 2 C)."""
    from repro_torch.models import transformer as T

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)
    skip = [] if cfg.tie_embeddings else [params.embed]
    if cfg.learned_pos_len:
        skip.append(params.pos_embed)
    if cfg.encoder is not None:
        skip += list(params.encoder.parameters())
    skip += [w for bp in params.blocks if bp.bcfg.cross_attn is not None
             for w in (bp.cross.wk, bp.cross.wv)]
    total = nbytes(params.parameters()) - nbytes(skip)
    skipped = 0
    if cfg.soi is not None:
        _pre, mid, _post = T.split_blocks(params, cfg)
        skipped = nbytes([p for m in mid for p in m.parameters()]
                         + [params.soi_compress])
    return ((total, total / HBM_BYTES_PER_S * 1e3),
            (total - skipped, (total - skipped) / HBM_BYTES_PER_S * 1e3))


def _family_argv(arch) -> list:
    """The serving driver's arguments of a family's phase-18 serve."""
    argv = ["--arch", arch, "--soi", "pp", "--batch", "4", "--prompt-len",
            "1024", "--stagger", "2", "--gen-len", "64", "--seed", "0"]
    if arch in FAMILY_LAYERS:
        argv += ["--layers", str(FAMILY_LAYERS[arch])]
    return argv


def _family_serve(arch, dev) -> tuple:
    """The serving driver at full width (``FAMILY_LAYERS`` cuts depth),
    bf16, SOI pp, 4 requests of 1024..1018 tokens, 64 generated, dense
    rings, bucketed prefill, graphed steps: launches held to the host
    clocks' count; median step with and without the middle; tok/s; busy,
    idle share and kernels a step from 16 graphed steps between markers.
    Returns (counts, cfg, params) (the weights for danube's paged run)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parse_args(_family_argv(arch))
    t0 = time.perf_counter()
    cfg, params, prompt, plens, engine = serve.setup(args)
    torch.cuda.synchronize(dev)
    n_par = sum(p.numel() for p in params.parameters())
    print(f"  {arch} serve: {cfg.n_layers} layers (SOI "
          f"{cfg.soi.first_layer}..{cfg.soi.last_layer - 1}), "
          f"{n_par / 1e9:.2f} B bf16 parameters ({2 * n_par / 1e9:.1f} GB) "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = serve.serve(engine, params, prompt, plens, args.gen_len)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    want = {"decode_attention": n_outer * res.steps + n_mid * res.mid_steps,
            "flash_attention": (0 if _windowed(cfg)
                                else cfg.n_layers * len(res.seqs))}
    check(res.seqs.shape == (4, 64), f"{arch}: tokens {res.seqs.shape}")
    check(((res.seqs >= 0) & (res.seqs < cfg.vocab)).all(),
          f"{arch}: token ids outside [0, vocab)")
    _counts_want(counts, want, f"{arch} serve")
    print(f"  {arch}: prefill {res.prefill_s:.3f} s for {len(res.seqs)} "
          f"requests (lens {plens}), decode {res.decoded} tokens in "
          f"{res.decode_s:.3f} s = {res.decoded / res.decode_s:.1f} tok/s "
          f"(host clock); {res.steps} steps, {res.mid_steps} with the "
          f"middle; peak device memory {peak:.2f} GiB; launches {want} "
          f"== counted", flush=True)
    on, off = _phase_step_ms(engine, params, prompt, plens)
    (w_on, f_on), (w_off, f_off) = _weight_floor(params, cfg)
    print(f"  {arch} step (host clock after a synchronize, median of 16): "
          f"{on:.3f} ms with the SOI middle, {off:.3f} without; weights "
          f"read a step {w_on / 1e9:.2f} / {w_off / 1e9:.2f} GB, floor "
          f"{f_on:.3f} / {f_off:.3f} ms at 3.35 TB/s")
    ds = engine.init_decode_state(params)
    for slot, n in enumerate(plens):
        ds = engine.insert(engine.prefill(params, prompt[slot, :n]), ds,
                           slot)
    st = {"ds": ds, "prev": None}

    def step():
        st["ds"], r = engine.generate(params, st["ds"])
        if st["prev"] is not None:
            st["prev"].convert_to_numpy()
        st["prev"] = r
    n_prof = 16
    busy, idle, kern, reads = _loop_profile(
        step, n_prof, READ_KERNELS["split"], "decode_attention", arch)
    print(f"  {arch} profiled {n_prof} graphed steps: busy {busy:.3f} ms a "
          f"step, idle share {idle:.3f}, {kern:.0f} device kernels a step, "
          f"decode reads {reads} on the device == counted", flush=True)
    del st, ds, engine
    return counts, cfg, params


def _danube_paged(cfg, params, dev) -> dict:
    """h2o-danube-1.8b paged (page 16) with chunked prefill (256) and the
    prefix cache against dense rings with the same chunks, one prompt set
    (``DANUBE_PLENS``, the first ``DANUBE_SHARED`` tokens shared): the
    window-4096 rings wrap onto shared pages and copy them on write. Tokens
    equal the dense run's; counters, COW flushes and launches as the
    engine and the host clocks give them. Returns {layout: counts}."""
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    gen_len = 64
    gen = torch.Generator(device=dev).manual_seed(13)
    prompt = torch.randint(0, cfg.vocab, (3, max(DANUBE_PLENS)),
                           generator=gen, device=dev, dtype=torch.int32)
    prompt[:, :DANUBE_SHARED] = prompt[0, :DANUBE_SHARED]
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    kw = dict(max_concurrent_decodes=3, max_len=max(DANUBE_PLENS) + gen_len,
              device=dev, prefill_chunk=DANUBE_CHUNK)
    engines = {"dense": SOIEngine(cfg, **kw),
               "paged": SOIEngine(cfg, paged=True, page_size=16,
                                  prefix_cache=True, **kw)}
    chunks = {"dense": sum(-(-p // DANUBE_CHUNK) for p in DANUBE_PLENS),
              "paged": (-(-DANUBE_PLENS[0] // DANUBE_CHUNK)
                        + sum(-(-p // DANUBE_CHUNK)
                              - DANUBE_SHARED // DANUBE_CHUNK
                              for p in DANUBE_PLENS[1:]))}
    out, seqs = {}, {}
    for layout, eng in engines.items():
        ops.reset_launch_counts()
        res = serve.serve(eng, params, prompt, list(DANUBE_PLENS), gen_len)
        counts = ops.launch_counts()
        read = ("paged_decode_attention" if layout == "paged"
                else "decode_attention")
        want = {read: n_outer * res.steps + n_mid * res.mid_steps,
                "chunk_attention": cfg.n_layers * chunks[layout],
                "copy_pages": res.cow_flushes}
        check(res.seqs.shape == (3, gen_len),
              f"danube {layout}: tokens {res.seqs.shape}")
        _counts_want(counts, want, f"danube {layout}")
        print(f"  danube {layout} (chunk {DANUBE_CHUNK}): prefill "
              f"{res.prefill_s:.3f} s for 3 requests (lens "
              f"{list(DANUBE_PLENS)}, {DANUBE_SHARED} shared), decode "
              f"{res.decoded / res.decode_s:.1f} tok/s (host clock); "
              f"launches {want} == counted; prefix cache "
              f"{res.prefix_cache}; pools {res.pools}", flush=True)
        out[layout], seqs[layout] = counts, res.seqs
        if layout == "paged":
            pc = res.prefix_cache
            check(pc["hits"] == 2 and pc["misses"] == 1
                  and pc["tokens_skipped"] == 2 * DANUBE_SHARED
                  and pc["cow_copies"] > 0,
                  f"danube prefix-cache counters {pc}")
            check(res.cow_flushes > 0
                  and counts["copy_pages"] == res.cow_flushes,
                  f"danube copy_pages {counts['copy_pages']} != COW "
                  f"flushes {res.cow_flushes}")
    check((seqs["dense"] == seqs["paged"]).all(),
          "danube: paged prefix-cache tokens differ from the dense run's")
    print("  danube: paged prefix-cache tokens identical to the dense "
          "run's; the window-4096 rings wrapped onto shared pages "
          "(copy_pages once a COW flush)")
    del engines
    return out


def _family_launches(name, arch, fam) -> tuple:
    """(launches, the run) of a kernel's shape of ``arch`` in phase 18:
    the dense decode read on the bf16 serve, danube's paged read and chunk
    kernel on its paged prefix-cache run, and the paged read of the G 6 /
    G 12 families on their paged card-vs-CPU run (f32, 4 layers)."""
    if name == "decode_attention":
        return (fam["serve"][arch][name],
                f"families serve ({arch}, bf16, dense)")
    if arch == "h2o-danube-1.8b":
        return (fam["danube"]["paged"][name],
                "families danube paged prefix cache (bf16)")
    return (fam["parity"][arch]["paged"][name],
            f"families parity ({arch}, "
            f"{FAMILY_PARITY_LAYERS.get(arch, 4)} layers, f32, paged)")


def _zoo_launches(name, label, zoo) -> tuple:
    """(launches, the run) of a kernel's shape of phase 19 in phase 3: the
    whisper and paligemma serves' dense reads and whisper's flash launches
    (encoder, self and cross prefill alike: one counter), and the paged
    reads on the card-vs-CPU paged runs (f32; paligemma at 4 layers)."""
    arch = ZOO_OF[label]
    if name == "paged_decode_attention":
        return (zoo["parity"][arch]["paged"][name],
                f"zoo parity ({arch}, f32, paged)")
    return (zoo["serve"][arch]["serve"][name],
            f"zoo serve ({arch}, bf16, dense)")


def families_phase(dev) -> dict:
    """Returns {"parity": {arch: {layout: counts}}, "serve": {arch:
    counts}, "danube": {layout: counts}}."""
    layers = ", ".join(f"{a} {FAMILY_LAYERS[a]} layers" for a in
                       FAMILY_LAYERS)
    phase(f"18 families (olmoe-1b-7b, h2o-danube-1.8b, nemotron-4-15b, "
          f"mistral-large-123b: card vs CPU at 4 layers f32 (nemotron and "
          f"mistral 2), then serving "
          f"at full width in bf16, {layers}; danube paged with the prefix "
          f"cache)")
    t0 = time.perf_counter()
    out = {"parity": {}, "serve": {}}
    for arch in FAMILY_ARCHS:
        out["parity"][arch] = _family_parity(arch, dev)
    for arch in FAMILY_ARCHS:
        counts, cfg, params = _family_serve(arch, dev)
        out["serve"][arch] = counts
        if arch == "h2o-danube-1.8b":
            out["danube"] = _danube_paged(cfg, params, dev)
        del params
        _free(dev)
    print(f"  families phase: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 19. zoo: rwkv6-1.6b, paligemma-3b, whisper-tiny, lm_stream_session,
#     GhostNet
# ---------------------------------------------------------------------------

ZOO_PLENS = (41, 43, 37)           # (a): two requests, a third after 3 steps
ZOO_SERVE = {"rwkv6-1.6b": ["--soi", "pp", "--prompt-len", "1024"],
             "paligemma-3b": ["--prompt-len", "1024"],
             "whisper-tiny": ["--prompt-len", "64"]}
ZOO_GEN = 64
N_PATCHES = 256
SESSION_PROMPT = 1024
GHOST_B, GHOST_T = 32, 1000        # 16 s of frames at 62.5 fps a stream
GHOST_TOL = 1e-4
ENCODER_TOL = 1e-4                 # f32, after the encoder's LayerNorm


def _zoo_frames(cfg, n, dev, seed):
    """``n`` requests' stub encoder frames (1, n_frames, d_enc) from a
    seed, or Nones for a config without an encoder."""
    if cfg.encoder is None:
        return [None] * n
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((1, cfg.encoder.n_frames, cfg.encoder.d_model),
                        generator=gen, device=dev) for _ in range(n)]


def _zoo_reads(cfg, layout: str, steps: int) -> dict:
    """The decode reads a plain (non-SOI) config's ``steps`` generate steps
    launch: one a self-attention layer a step (paged: the paged read), and
    one a cross layer a step on the slot's dense encoder K/V."""
    from repro_torch.models import transformer as T
    blocks = T.layer_blocks(cfg)
    n_self = sum(b.attn is not None for b in blocks)
    n_cross = sum(b.cross_attn is not None for b in blocks)
    read = ("paged_decode_attention" if layout == "paged"
            else "decode_attention")
    want = {read: n_self * steps}
    want["decode_attention"] = (want.get("decode_attention", 0)
                                + n_cross * steps)
    return {k: v for k, v in want.items() if v}


def _zoo_flash(cfg, n_req: int) -> int:
    """flash_attention launches of ``n_req`` whole prefills: every
    non-windowed causal or non-causal layer (the encoder's, the decoder's
    self and cross attention) once a request; a prefix-LM prefill takes
    the plain path on every device and launches none."""
    from repro_torch.models import transformer as T
    if cfg.prefix_lm:
        return 0
    n = sum((b.attn is not None and b.attn.window is None)
            + (b.cross_attn is not None) for b in T.layer_blocks(cfg))
    if cfg.encoder is not None:
        n += cfg.encoder.segments[0].n_layers
    return n * n_req


def _zoo_parity(arch, dev) -> dict:
    """(a) Card against CPU in float32: rwkv6-1.6b cut to 4 layers (SOI pp,
    dense: the config has no attention cache to page, and the paged engine
    is refused on the card as on the CPU), paligemma-3b cut to 4 layers
    and whisper-tiny whole (each request with 1500 frames from the seed),
    no SOI, dense and paged (page 16): 3 slots (prompts of 41 and 43
    tokens, a third of 37 after 3 steps), 8 greedy steps — tokens
    identical, logits within 1e-3, launches as the host clocks give them.
    paligemma also prefills 2 requests through ``prefill(prefix_embeds=)``
    with 256 patch embeddings from the seed, then 8 greedy
    ``decode_step`` calls. Returns {layout: the card run's counts}."""
    from repro_torch import configs
    from repro_torch.engine import SOIEngine
    from repro_torch.kernels import ops
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    soi = "pp" if arch == "rwkv6-1.6b" else None
    cfg = dataclasses.replace(
        configs.get(arch, soi=soi,
                    n_layers=None if arch == "whisper-tiny" else 4),
        dtype="float32")
    dev_model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(31), device=dev)
    cpu_model = _cpu_copy(dev_model, cfg)
    n_par = sum(p.numel() for p in dev_model.parameters())
    gen = torch.Generator().manual_seed(32)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                             dtype=torch.int32) for n in ZOO_PLENS]
    frames = [None if f is None else f.cpu()
              for f in _zoo_frames(cfg, 3, dev, 33)]
    print(f"  {arch} parity: {cfg.n_layers} layers, {n_par / 1e9:.2f} B "
          f"float32 parameters a side", flush=True)
    if cfg.encoder is not None:
        # the non-causal flash kernel at 1500 frames, through the encoder
        enc = [T.encode(m, cfg, torch.cat(frames).to(w)).float().cpu()
               for m, w in ((cpu_model, "cpu"), (dev_model, dev))]
        err = float((enc[0] - enc[1]).abs().max())
        check(err < ENCODER_TOL, f"{arch} encoder: card vs CPU max|Δ| {err} "
                                 f">= {ENCODER_TOL}")
        print(f"  {arch} encoder output (3, {cfg.encoder.n_frames}, "
              f"{cfg.d_model}): card vs CPU max|Δ| {err:.3e}", flush=True)
    layouts = [("dense", {})]
    if arch == "rwkv6-1.6b":
        try:
            SOIEngine(cfg, max_concurrent_decodes=3, max_len=64, device=dev,
                      paged=True, page_size=16)
        except ValueError as e:
            print(f"  {arch} paged: refused as in the reference ({e})")
        else:
            check(False, f"{arch}: a paged engine was not refused")
    else:
        layouts.append(("paged", dict(paged=True, page_size=16)))
    out = {}
    host = None
    for layout, kw in layouts:
        runs = []
        for where, model in ((torch.device("cpu"), cpu_model),
                             (dev, dev_model)):
            if where.type == "cpu" and host is not None:
                runs.append(host)     # the host's dense run: see HOST_RUN
                continue
            eng = SOIEngine(cfg, max_concurrent_decodes=3, max_len=64,
                            device=where, **kw)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            runs.append(_greedy(
                eng, model, [p.to(where) for p in prompts],
                frames=[None if f is None else f.to(where)
                        for f in frames]))
            torch.cuda.synchronize(dev)
            counts = ops.launch_counts()          # the card run's, last
            took = time.perf_counter() - t0
        host = runs[0]
        worst = _compare_runs(runs, f"{arch} {layout}")
        if cfg.soi is None:
            want = _zoo_reads(cfg, layout, eng.steps)
        else:
            want = {}                   # rwkv: no attention, no kernel
        want["flash_attention"] = _zoo_flash(cfg, 3)
        _counts_want(counts, want, f"{arch} parity {layout}")
        print(f"  {arch} {layout}: 8 steps, tokens identical, max|Δlogit| "
              f"{worst:.3e}; card launches {want} (card run {took:.2f} s)",
              flush=True)
        out[layout] = counts
    if cfg.prefix_lm:
        pgen = torch.Generator().manual_seed(34)
        patches = torch.randn((2, N_PATCHES, cfg.d_model), generator=pgen)
        toks = torch.stack([p[:37] for p in prompts[:2]])
        runs = []
        for where, model in ((torch.device("cpu"), cpu_model),
                             (dev, dev_model)):
            ops.reset_launch_counts()
            lg, st = D.prefill(model, cfg, toks.to(where),
                               prefix_embeds=patches.to(where),
                               max_len=N_PATCHES + 37 + 8)
            steps = []
            for _ in range(8):
                nxt = torch.argmax(lg, -1).to(torch.int32)
                steps.append((lg.float().cpu(), nxt.tolist(), [0, 1]))
                lg, st = D.decode_step(model, cfg, st, nxt)
            runs.append(steps)
            counts = ops.launch_counts()
        worst = _compare_runs(runs, f"{arch} prefix_embeds")
        _counts_want(counts, {"decode_attention": cfg.n_layers * 8},
                     f"{arch} prefix_embeds")
        print(f"  {arch} prefix_embeds: 2 requests of {N_PATCHES} patches + "
              f"37 tokens, then 8 decode steps: tokens identical, "
              f"max|Δlogit| {worst:.3e}; card launches "
              f"{{'decode_attention': {cfg.n_layers * 8}}} (the prefix-LM "
              f"prefill on the plain path: no flash launch)", flush=True)
    del cpu_model, dev_model
    _free(dev)
    return out


def _zoo_loop(engine, params, prompt, plens, frames, gen_len):
    """The serving loop for requests with encoder frames (the serving
    driver has no flag for them, as the reference's has none): prefill and
    insert every request, then ``gen_len - 1`` generate steps, each step's
    tokens drained one step late. Returns (tokens (n, gen_len), prefill s,
    decode s, steps)."""
    out = {}
    t0 = time.perf_counter()
    ds = engine.init_decode_state(params)
    for slot, n in enumerate(plens):
        prefix = engine.prefill(params, prompt[slot, :n],
                                encoder_frames=frames[slot])
        ds = engine.insert(prefix, ds, slot)
        out[slot] = [int(prefix.first_token[0])]
    torch.cuda.synchronize(engine.device)
    prefill_s = time.perf_counter() - t0
    steps0 = engine.steps
    t0 = time.perf_counter()
    pending = None
    for _ in range(gen_len - 1):
        ds, res = engine.generate(params, ds)
        if pending is not None:
            data = pending.convert_to_numpy().data
            for slot in out:
                out[slot].append(int(data[slot, 0]))
        pending = res
    data = pending.convert_to_numpy().data
    for slot in out:
        out[slot].append(int(data[slot, 0]))
    torch.cuda.synchronize(engine.device)
    decode_s = time.perf_counter() - t0
    import numpy as np
    seqs = np.stack([np.asarray(out[s]) for s in sorted(out)])
    return seqs, prefill_s, decode_s, engine.steps - steps0


def _zoo_serve(arch, dev) -> dict:
    """(b) Full width and depth in bf16, graphed steps, B 4, 64 generated:
    rwkv6-1.6b (SOI pp) and paligemma-3b (no SOI) through the serving
    driver's loop on phase 5's prompts (1024..1018 tokens), whisper-tiny
    on prompts of 64..58 tokens after 1500 frames from the seed. Every
    kernel's launches held to the host clocks' count; tok/s; the median
    step (with and without the middle) beside the bf16 weights a step
    reads and their floor at 3.35 TB/s; busy, idle share and kernels a
    step from 16 graphed steps between markers. paligemma then prefills
    one batch of the 4 prompts behind 256 patch embeddings each through
    ``prefill(prefix_embeds=)`` (1280 rows on the plain prefix-LM path)
    and takes 64 greedy ``decode_step`` calls. Returns the counts of the
    serving run (and "prefix": those of the prefix batch)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import decode as D
    argv = ["--arch", arch, "--batch", "4", "--stagger", "2", "--gen-len",
            str(ZOO_GEN), "--seed", "0"] + ZOO_SERVE[arch]
    args = serve.parse_args(argv)
    t0 = time.perf_counter()
    cfg, params, prompt, plens, engine = serve.setup(args)
    torch.cuda.synchronize(dev)
    frames = [None if f is None else f.to(torch.bfloat16)
              for f in _zoo_frames(cfg, len(plens), dev, 35)]
    n_par = sum(p.numel() for p in params.parameters())
    soi = (f"SOI {cfg.soi.first_layer}..{cfg.soi.last_layer - 1}"
           if cfg.soi is not None else "no SOI")
    print(f"  {arch} serve: {cfg.n_layers} layers ({soi}), "
          f"{n_par / 1e9:.3f} B bf16 parameters ({2 * n_par / 1e9:.2f} GB) "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    if cfg.encoder is None:
        res = serve.serve(engine, params, prompt, plens, args.gen_len)
        seqs, prefill_s, decode_s = res.seqs, res.prefill_s, res.decode_s
        steps, mid_steps, decoded = res.steps, res.mid_steps, res.decoded
    else:
        steps0, mid0 = engine.steps, engine.mid_steps
        seqs, prefill_s, decode_s, steps = _zoo_loop(
            engine, params, prompt, plens, frames, args.gen_len)
        mid_steps = engine.mid_steps - mid0
        decoded = (seqs.shape[1] - 1) * seqs.shape[0]
        check(engine.steps - steps0 == steps, "step count")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if cfg.soi is None:
        want = _zoo_reads(cfg, "dense", steps)
    else:
        want = {}                           # rwkv: no attention, no kernel
    want["flash_attention"] = _zoo_flash(cfg, len(plens))
    check(seqs.shape == (4, ZOO_GEN), f"{arch}: tokens {seqs.shape}")
    check(((seqs >= 0) & (seqs < cfg.vocab)).all(),
          f"{arch}: token ids outside [0, vocab)")
    _counts_want(counts, want, f"{arch} serve")
    with_frames = "" if cfg.encoder is None else ", 1500 frames each"
    print(f"  {arch}: prefill {prefill_s:.3f} s for {len(seqs)} requests "
          f"(lens {plens}{with_frames}), decode "
          f"{decoded} tokens in {decode_s:.3f} s = "
          f"{decoded / decode_s:.1f} tok/s (host clock); {steps} steps"
          + ("" if cfg.soi is None else f", {mid_steps} with the middle")
          + f"; peak device memory {peak:.2f} GiB; "
          f"launches {want} == counted (every other kernel 0)", flush=True)
    on, off = _phase_step_ms(engine, params, prompt, plens, frames=frames)
    (w_on, f_on), (w_off, f_off) = _weight_floor(params, cfg)
    if cfg.soi is None:
        print(f"  {arch} step (host clock after a synchronize, median of "
              f"16): {on:.3f} ms; weights read a step {w_on / 1e9:.3f} GB, "
              f"floor {f_on:.4f} ms at 3.35 TB/s")
    else:
        print(f"  {arch} step (host clock after a synchronize, median of "
              f"16): {on:.3f} ms with the SOI middle, {off:.3f} without; "
              f"weights read a step {w_on / 1e9:.3f} / {w_off / 1e9:.3f} GB, "
              f"floor {f_on:.4f} / {f_off:.4f} ms at 3.35 TB/s")
    st = {"ds": _insert_all(engine, params, prompt, plens, frames),
          "prev": None}

    def step():
        st["ds"], r = engine.generate(params, st["ds"])
        if st["prev"] is not None:
            st["prev"].convert_to_numpy()
        st["prev"] = r
    n_prof = 16
    busy, idle, kern, reads = _loop_profile(
        step, n_prof, READ_KERNELS["split"], "decode_attention", arch)
    print(f"  {arch} profiled {n_prof} graphed steps: busy {busy:.3f} ms a "
          f"step, idle share {idle:.3f}, {kern:.0f} device kernels a step, "
          f"decode reads {reads} on the device == counted", flush=True)
    out = {"serve": counts}
    del st
    if cfg.prefix_lm:
        pgen = torch.Generator(device=dev).manual_seed(36)
        patches = torch.randn((len(plens), N_PATCHES, cfg.d_model),
                              generator=pgen, device=dev).to(torch.bfloat16)
        toks = prompt[:, :min(plens)]
        ops.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        lg, ps = D.prefill(params, cfg, toks, prefix_embeds=patches,
                           max_len=N_PATCHES + toks.shape[1] + ZOO_GEN)
        torch.cuda.synchronize(dev)
        pre_ms = (time.perf_counter() - t0) * 1e3
        step_ms, toks_out = [], []
        for _ in range(ZOO_GEN):
            nxt = torch.argmax(lg, -1).to(torch.int32)
            toks_out.append(nxt)
            t0 = time.perf_counter()
            lg, ps = D.decode_step(params, cfg, ps, nxt)
            torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        got = torch.stack(toks_out, 1)
        check(bool(((got >= 0) & (got < cfg.vocab)).all())
              and bool(torch.isfinite(lg).all()),
              f"{arch} prefix_embeds: tokens or logits out of range")
        pcounts = ops.launch_counts()
        _counts_want(pcounts, {"decode_attention": cfg.n_layers * ZOO_GEN},
                     f"{arch} prefix_embeds")
        print(f"  {arch} prefix_embeds: B {len(plens)} x ({N_PATCHES} "
              f"patches + {toks.shape[1]} tokens) prefilled in {pre_ms:.1f} "
              f"ms on the plain prefix-LM path, then {ZOO_GEN} eager "
              f"decode_step calls, median {sorted(step_ms)[ZOO_GEN // 2]:.3f} "
              f"ms; launches {{'decode_attention': "
              f"{cfg.n_layers * ZOO_GEN}}} == counted", flush=True)
        out["prefix"] = pcounts
    del params, engine
    _free(dev)
    return out


def _zoo_session(dev) -> dict:
    """(c) ``lm_stream_session`` on full-width qwen3-1.7b (bf16, SOI pp): B 4
    behind a 1024-token prompt, 64 greedy pushes (graph replays after each
    branch's first) against ``generate_step`` driven by hand, eagerly, from
    the same prefill: tokens and logits bit for bit; the decode reads held
    to the host clock's count; ms a push. Returns the session's counts."""
    from repro_torch import configs
    from repro_torch.engine import generate_step, lm_stream_session
    from repro_torch.kernels import ops
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    cfg = configs.get("qwen3-1.7b", soi="pp")
    gen = torch.Generator(device=dev).manual_seed(41)
    params = T.cast_params(T.init(cfg, generator=gen, device=dev,
                                  dtype=torch.bfloat16), cfg)
    prompt = torch.randint(0, cfg.vocab, (4, SESSION_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    max_len = SESSION_PROMPT + ZOO_GEN
    st = cfg.soi.stride
    # by hand, eagerly
    lg, state = D.prefill(params, cfg, prompt, max_len=max_len)
    first = torch.argmax(lg, -1).to(torch.int32)
    tok, hand = first, []
    for i in range(ZOO_GEN):
        lg, state = generate_step(params, cfg, state, tok,
                                  run_mid_any=(SESSION_PROMPT + i) % st == 0)
        hand.append(lg.clone())
        tok = torch.argmax(lg, -1).to(torch.int32)
    del state
    # the session, graphed
    ops.reset_launch_counts()
    sess = lm_stream_session(params, cfg, max_len=max_len, prompt=prompt,
                             device=dev)
    tok, got, push_ms = first, [], []
    for _ in range(ZOO_GEN):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        lg = sess.push(tok)
        torch.cuda.synchronize(dev)
        push_ms.append((time.perf_counter() - t0) * 1e3)
        got.append(lg)
        tok = torch.argmax(lg, -1).to(torch.int32)
    counts = ops.launch_counts()
    same = all(torch.equal(a, b) for a, b in zip(got, hand))
    check(same, "lm_stream_session: logits differ from the hand-driven "
                "generate_step's")
    n_outer = cfg.soi.first_layer + cfg.n_layers - cfg.soi.last_layer
    n_mid = cfg.soi.last_layer - cfg.soi.first_layer
    n_mid_steps = sum((SESSION_PROMPT + i) % st == 0 for i in range(ZOO_GEN))
    want = {"decode_attention": n_outer * ZOO_GEN + n_mid * n_mid_steps,
            "flash_attention": cfg.n_layers}
    _counts_want(counts, want, "lm_stream_session")
    steady = sorted(push_ms[2:])
    print(f"  lm_stream_session (qwen3-1.7b full width, bf16, SOI pp, B 4, "
          f"prompt {SESSION_PROMPT}): {ZOO_GEN} greedy pushes == "
          f"generate_step by hand (eager), tokens and logits bit for bit; "
          f"{sess.graph.captures} captures, {sess.graph.replays} replays; "
          f"push {steady[len(steady) // 2]:.3f} ms median (host clock after "
          f"a synchronize, first two with their captures left out: "
          f"{push_ms[0]:.1f}, {push_ms[1]:.1f} ms); launches {want} == "
          f"counted", flush=True)
    del sess, params
    _free(dev)
    return counts


def _zoo_ghostnet(dev):
    """(d) GhostNet sizes I..VII, B 32 x 1000 frames, with SOI (the config's
    pair at block 4) and without: the card's class logits against the
    CPU's in float32 (TF32 off) within 1e-4; ms a batch (CUDA events, the
    median of 10) beside the MAC retain from ``complexity_report``."""
    from repro_torch.configs import soi_ghostnet_asc as G
    from repro_torch.models import ghostnet as GH
    print("  GhostNet (B 32 x 1000 frames, f32): size, SOI, parameters, "
          "max|Δ| card vs CPU, ms a batch, MAC retain")
    for size in G.SIZES:
        for soi in (True, False):
            cfg = G.config(size)
            if not soi:
                cfg = dataclasses.replace(cfg, soi=None)
            cpu = GH.init(cfg, generator=torch.Generator().manual_seed(51),
                          device="cpu")
            card = GH.GhostNet(cfg, generator=torch.Generator(),
                               device="meta")
            card.load_state_dict({k: v.to(dev) for k, v in
                                  cpu.state_dict().items()}, assign=True)
            x = torch.randn((GHOST_B, GHOST_T, cfg.in_channels),
                            generator=torch.Generator().manual_seed(52))
            want = GH.apply_offline(cpu, x, cfg)
            xd = x.to(dev)
            got = GH.apply_offline(card, xd, cfg)
            err = float((got.cpu() - want).abs().max())
            check(err < GHOST_TOL, f"GhostNet {size} soi={soi}: max|Δ| "
                                   f"{err} >= {GHOST_TOL}")
            ms = []
            for _ in range(12):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                GH.apply_offline(card, xd, cfg)
                b.record()
                torch.cuda.synchronize(dev)
                ms.append(a.elapsed_time(b))
            ms = sorted(ms[2:])[5]
            rep = GH.complexity_report(cfg)
            print(f"    {size:>3} {'SOI (4,)' if soi else 'STMC':>8}: "
                  f"{GH.n_params(cfg)} params, {err:.2e}, {ms:.3f} ms, "
                  f"retain {rep.retain:.4f} ({rep.mmacs_per_s:.3f} MMAC/s)",
                  flush=True)


ZOO_ARCHS = ("rwkv6-1.6b", "paligemma-3b", "whisper-tiny")


def zoo_phase(dev) -> dict:
    """Returns {"parity": {arch: {layout: counts}}, "serve": {arch:
    {"serve": counts[, "prefix": counts]}}, "session": counts}."""
    phase("19 zoo (rwkv6-1.6b, paligemma-3b, whisper-tiny: card vs CPU in "
          "f32, then serving at full width and depth in bf16; "
          "lm_stream_session on qwen3-1.7b; GhostNet I..VII)")
    t0 = time.perf_counter()
    out = {"parity": {}, "serve": {}}
    for arch in ZOO_ARCHS:
        out["parity"][arch] = _zoo_parity(arch, dev)
    for arch in ZOO_ARCHS:
        out["serve"][arch] = _zoo_serve(arch, dev)
    out["session"] = _zoo_session(dev)
    _zoo_ghostnet(dev)
    print(f"  zoo phase: {time.perf_counter() - t0:.1f} s")
    return out



# ---------------------------------------------------------------------------
# 20. analysis
# ---------------------------------------------------------------------------

# the caching allocator rounds every block up to 512 bytes, and a block
# over 1 MiB may keep up to 1 MiB of its segment unsplit at its end
ALLOC_BLOCK = 512
ALLOC_TAIL = 2 ** 20


def _round_block(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def _analysis_matrix(dev):
    """(a) ``analyze()`` on the card with its default cells, the smoke
    cells its kernels take (the six GQA cells: ``targets.CARD_TARGETS``),
    all five passes; a finding outside ``analysis_baseline_torch.json``,
    or a cost metric other than the CPU's ``cost_baseline_torch.json``
    row, fails."""
    from repro_torch.analysis import analyze, compare_to_baseline
    from repro_torch.analysis.targets import CARD_TARGETS
    t0 = time.perf_counter()
    report = analyze(device=dev)
    check(report.targets == list(CARD_TARGETS),
          f"the card's default cells {report.targets} != {CARD_TARGETS}")
    diff = compare_to_baseline(report,
                               str(ROOT / "analysis_baseline_torch.json"))
    for f in diff.new:
        print(f.render())
    check(diff.clean, f"{len(diff.new)} analysis finding(s) outside "
                      f"analysis_baseline_torch.json")
    base = json.loads((ROOT / "cost_baseline_torch.json").read_text())
    rows = [(c, e) for c in report.metrics for e in report.metrics[c]]
    same = sum(report.metrics[c][e] == base["cells"][c][e] for c, e in rows)
    check(same == len(rows), f"the cost metrics of {len(rows) - same} of "
                             f"{len(rows)} entries differ from the CPU's "
                             f"cost_baseline_torch.json")
    print(f"  analysis on the card: {len(report.targets)} cells x "
          f"{len(report.passes)} passes, {len(report.findings)} findings "
          f"({len(diff.accepted)} accepted by the baseline); the cost "
          f"metrics of {same} of {len(rows)} entries equal the CPU's "
          f"cost_baseline_torch.json; {time.perf_counter() - t0:.1f} s",
          flush=True)


def _graphed_steps(engine, params, ds, prompt, plens, dev, n_steps=24):
    """Host ms of graphed steps after a synchronize, as phase 14 reads
    them: (median, median with the middle, median without), the branches'
    captures left out."""
    for slot, n in enumerate(plens):
        ds = engine.insert(engine.prefill(params, prompt[slot, :n]), ds,
                           slot)
    times = {True: [], False: []}
    for _ in range(n_steps):
        mid0, cap0 = engine.mid_steps, engine.graph.captures
        t0 = time.perf_counter()
        ds, res = engine.generate(params, ds)
        res.convert_to_numpy()
        torch.cuda.synchronize(dev)
        if engine.graph.captures == cap0:
            times[engine.mid_steps > mid0].append(
                (time.perf_counter() - t0) * 1e3)
    med = lambda v: sorted(v)[len(v) // 2]
    return (med(times[True] + times[False]), med(times[True]),
            med(times[False]))


def _full_width_cost(dev, card, graphed) -> dict:
    """(b) + (c): qwen3-1.7b at full width, SOI pp, B 4, phase 5's and 6's
    engines. Each generate branch metered eagerly on the card, equal to
    the CPU's FakeTensorMode count; every launch priced; COST001 and
    COST002; the H100 plan beside the graphed step and the state bytes
    beside init_decode_state's allocation."""
    from repro_torch.analysis import cost
    from repro_torch.engine.contracts import state_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import plan, serve
    costs = {}
    for layout, argv in (("dense", SERVE_ARGV), ("paged", PAGED_ARGV)):
        name = f"qwen3-1.7b-{layout}"
        args = serve.parse_args(argv)
        kw = serve.engine_kwargs(args)
        cfg, params, prompt, plens, engine = serve.setup(args)
        torch.cuda.synchronize(dev)
        a0 = torch.cuda.memory_allocated(dev)
        ds = engine.init_decode_state(params)
        torch.cuda.synchronize(dev)
        delta = torch.cuda.memory_allocated(dev) - a0
        leaves = [t.numel() * t.element_size() for _, t in state_leaves(ds)]
        step, step_mid, step_off = _graphed_steps(engine, params, ds, prompt,
                                                  plens, dev)
        del ds
        gen = next(e for e in engine.analysis_entries(params)
                   if e.name == "generate")
        rows = {}
        for mid in (True, False):
            ops.reset_launch_counts()
            m, peak = cost.meter_call(gen.fn, gen.with_branch(mid))
            launched = {k: n for k, n in ops.launch_counts().items() if n}
            check(not m.unpriced_kernels,
                  f"{name}: unpriced kernels {m.unpriced_kernels}")
            check(launched == dict(m.kernels),
                  f"{name}: launches {launched} != priced calls "
                  f"{dict(m.kernels)}")
            rows[mid] = (m.flops, m.bytes, peak, launched)
        t0 = time.perf_counter()
        fake = cost.measure_engine(cfg, kw, fake=True)["generate"]
        fake_s = time.perf_counter() - t0
        check((fake.flops, fake.bytes, fake.flops_min, fake.bytes_min)
              == (rows[True][0], rows[True][1], rows[False][0],
                  rows[False][1]),
              f"{name}: card {rows} != CPU fake count {fake}")
        ec = cost.EntryCost(flops=rows[True][0], flops_min=rows[False][0],
                            bytes=rows[True][1], bytes_min=rows[False][1],
                            contract=gen.cost)
        costs[name] = {"generate": ec}
        floor = cost.middle_trunk_floor(cfg, gen.cost["batch"])
        findings = cost._certify_cell(name, costs[name], cfg)
        check(not findings, "; ".join(f.message for f in findings))
        for mid, label in ((True, "phase-0"), (False, "off-phase")):
            fl, by, peak, launched = rows[mid]
            print(f"  {name} generate {label}: {fl:.6e} FLOPs, {by:.6e} "
                  f"bytes, peak {peak / 2 ** 20:.1f} MiB above the state; "
                  f"launches {launched}, every one priced; card == CPU "
                  f"FakeTensorMode count ({fake_s:.1f} s); {card}",
                  flush=True)
        print(f"  {name} COST001 holds: gap {ec.flops - ec.flops_min:.6e} "
              f">= middle-trunk floor {floor:.6e}")
        p = plan.plan_cell(name, plan.H100, {"generate": ec.to_metrics()},
                           cfg=cfg, engine_kwargs=kw)
        pred_leaves = [b for _, b in plan.decode_state_leaves(cfg, kw)]
        check(sorted(pred_leaves) == sorted(leaves),
              f"{name}: the fake decode state's leaves differ from the "
              f"card's")
        # the engine's spec mask (B bools) is allocated beside the state
        pred_alloc = (sum(_round_block(b) for b in pred_leaves)
                      + _round_block(args.batch))
        n_large = sum(b > ALLOC_TAIL for b in pred_leaves)
        check(0 <= delta - pred_alloc <= n_large * ALLOC_TAIL,
              f"{name}: init_decode_state allocated {delta} B, predicted "
              f"{pred_alloc} B (+ <= {n_large} x {ALLOC_TAIL})")
        print(f"  {name} plan @ {plan.H100.name} ({card}): phase-0 "
              f"{p.step_s_phase0 * 1e3:.4f} ms, off-phase "
              f"{p.step_s_offphase * 1e3:.4f} ms, avg "
              f"{p.step_s_avg * 1e3:.4f} ms, {p.tok_s:.1f} tok/s; "
              f"{p.state_bytes_per_slot:.0f} B of caches a slot, max slots "
              f"{p.max_slots}, params {p.param_bytes / 1e9:.3f} GB")
        p14 = ("" if graphed is None else
               f"; phase 14 dense: {graphed['median_ms']:.3f}, "
               f"{graphed['mid_ms']:.3f} / {graphed['off_ms']:.3f}")
        print(f"  {name} measured ({card}): graphed step {step:.3f} ms "
              f"({step_mid:.3f} with the middle / {step_off:.3f} without"
              f"{p14}); "
              f"measured / plan {step_mid / (p.step_s_phase0 * 1e3):.2f}x "
              f"phase-0, {step_off / (p.step_s_offphase * 1e3):.2f}x "
              f"off-phase; init_decode_state allocated {delta} B against "
              f"{pred_alloc} B predicted ({len(leaves)} leaves rounded to "
              f"{ALLOC_BLOCK} B + the spec mask; difference "
              f"{delta - pred_alloc} B), the plan's caches "
              f"{p.state_bytes_total:.0f} B ({delta / p.state_bytes_total:.4f}"
              f"x)", flush=True)
        del params, engine, gen
        _free(dev)
    cross = cost._certify_cross(costs)
    check(not cross, "; ".join(f.message for f in cross))
    d = costs["qwen3-1.7b-dense"]["generate"]
    pg = costs["qwen3-1.7b-paged"]["generate"]
    print(f"  COST002 holds: paged / dense bytes {pg.bytes / d.bytes:.4f} "
          f"(bound {cost.PAGED_BYTES_TOL})")
    return costs


def analysis_phase(dev, card, graphed):
    phase("20 analysis (the contract matrix on the card; qwen3-1.7b's "
          "generate metered at full width against the CPU fake count; the "
          "H100 plan beside the measured step)")
    check(H100.hbm_bytes >= torch.cuda.get_device_properties(0).total_memory
          >= 0.95 * H100.hbm_bytes,
          f"total_memory {torch.cuda.get_device_properties(0).total_memory}"
          f" against the plan's {H100.hbm_bytes}")
    print(f"  plan.H100: {H100.peak_flops:.4g} FLOP/s bf16, "
          f"{H100.peak_flops_f32:.3g} f32, {H100.hbm_bw:.4g} B/s, "
          f"{H100.hbm_bytes} B (total_memory "
          f"{torch.cuda.get_device_properties(0).total_memory} B); {card}")
    _analysis_matrix(dev)
    _free(dev)
    _full_width_cost(dev, card, graphed)


# ---------------------------------------------------------------------------
# 21. dist: the distributed layer over NCCL at world size 1
# ---------------------------------------------------------------------------

DIST_STEPS = 3


def _replay_psum(x):
    """compressed_psum over one rank in numpy float32."""
    import numpy as np
    flat = x.reshape(-1).astype(np.float32)
    pad = (-flat.size) % 256
    fp = np.pad(flat, (0, pad)).reshape(-1, 256)
    scale = np.maximum(np.max(np.abs(fp), axis=1, keepdims=True),
                       np.float32(1e-12)) / np.float32(127.0)
    q = np.round(fp / scale).astype(np.int8).astype(np.int32)
    return (q.astype(np.float32) * scale).reshape(-1)[:flat.size].reshape(
        x.shape)


def _dist_collectives(dev):
    """(b): the collectives over NCCL, bit for bit."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     moe_all_to_all)
    from repro_torch.distributed.pipeline import pipeline_apply
    rng = np.random.default_rng(21)
    for shape, dt in (((4, 2048), torch.float32), ((3, 101), torch.float32),
                      ((4, 96), torch.bfloat16)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dt)
        want = torch.from_numpy(_replay_psum(x.float().numpy())).to(dt)
        got = compressed_psum(x.to(dev), dist.group.WORLD)
        check(got.dtype == dt and torch.equal(got.cpu(), want),
              f"compressed_psum {shape} {dt}: not its numpy replay")
    tok = torch.from_numpy(rng.standard_normal((8, 64, 2048)).astype(
        np.float32)).to(dev, torch.bfloat16)
    check(torch.equal(moe_all_to_all(tok, dist.group.WORLD), tok),
          "moe_all_to_all over one rank is not its input")
    w = torch.from_numpy((0.03 * rng.standard_normal((8, 2048, 2048)))
                         .astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((12, 2048)).astype(
        np.float32)).to(dev)
    layers = [w[i] for i in range(8)]

    def layer_fn(lw, h):
        return torch.tanh(h @ lw)

    y = pipeline_apply(dist.group.WORLD, layer_fn, layers, x,
                       microbatches=3)
    want = []
    for h in x.chunk(3):
        for lw in layers:
            h = layer_fn(lw, h)
        want.append(h)
    check(torch.equal(y, torch.cat(want)),
          "one-stage pipeline_apply is not the sequential stack")
    print("  (b) compressed_psum (4,2048) / (3,101) f32 and (4,96) bf16 == "
          "the numpy replay bit for bit; moe_all_to_all (8,64,2048) bf16 == "
          "its input; pipeline_apply, 1 stage x 8 layers, 3 microbatches "
          "== the sequential stack bit for bit")


def _digests(tree: dict) -> dict:
    """Per-leaf digest of float32 leaves, exact: the int64 sums of the
    leaf's bits and of its bits times a position pattern (wrapping)."""
    out = {}
    for k, t in tree.items():
        x = t.detach().reshape(-1).view(torch.int32).long()
        w = torch.arange(x.numel(), device=x.device) % 65521 + 1
        out[k] = (int(x.sum()), int((x * w).sum()))
        del x, w
    return out


def _dist_train(dev, card):
    """(c): the plain step, then the sharded step on the (1, 1) mesh, 3
    steps each from the same weights and batches. Returns the sharded
    run's launch counts."""
    from repro_torch import configs
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.distributed.sharding import (ShardingRules,
                                                  gather_params, gather_tree,
                                                  shard_params)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import local_batch, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    cfg = configs.get("qwen3-1.7b", soi="pp")
    pipe = ShardedLMPipeline(global_batch=8, seq_len=128, vocab=cfg.vocab,
                             seed=0)
    batches = [_train_batch(pipe, i, dev) for i in range(DIST_STEPS + 1)]
    kw = dict(peak_lr=1e-3, warmup=20, total_steps=TRAIN_STEPS)

    def init():
        return T.init(cfg, generator=torch.Generator(device=dev)
                      .manual_seed(0), device=dev)

    def run(model, opt, step, prep):
        metrics, times = [], []
        for bt in batches[:DIST_STEPS]:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, _, m = step(model, opt, prep(bt))
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, sorted(times)[len(times) // 2]

    def profiled(label, fn):
        # one step between markers (device kernels, busy), then one more
        # with the host's records (the collectives c10d issued)
        from collections import Counter
        from torch.profiler import ProfilerActivity, profile
        ev = _device_events(fn, markers=MARKERS)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        calls = Counter(name for _s, _e, name, _w in _records(prof)
                        if name.startswith("nccl:"))
        nccl = [n for _s, _e, n in ev if "nccl" in n.lower()]
        fwd = sum(1 for _s, _e, n in ev if "flash_attention_kernel" in n)
        bwd = {k: sum(1 for _s, _e, n in ev if k in n)
               for k in ("dkdv_kernel", "dq_kernel")}
        busy = _busy_us([(s_, e) for s_, e, _n in ev])
        print(f"  (c) {label}, one step profiled between markers: {len(ev)} "
              f"device kernels, busy {busy / 1e3:.2f} ms; NCCL kernels "
              f"{len(nccl)}, NCCL calls on the host {dict(calls)}; "
              f"flash_attention forward kernels {fwd}, backward {bwd} "
              f"[{card}]")
        n = _train_want(cfg, cfg.n_layers)
        check(fwd == n["flash_attention"] and all(
            v == n["flash_attention_bwd"] for v in bwd.values()),
              f"{label}: flash forward {fwd}, backward {bwd}, want {n}")
        return calls

    _free(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    model = init()
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, **kw)
    p_metrics, p_ms = run(model, opt, step, lambda bt: bt)
    p_peak = torch.cuda.max_memory_allocated(dev)
    want = {"params": _digests(dict(model.named_parameters())),
            "mu": _digests(opt["mu"]), "nu": _digests(opt["nu"])}
    profiled("plain step", lambda: step(model, opt, batches[DIST_STEPS]))
    del model, opt, step
    _free(dev)

    mesh = make_mesh((1, 1), ("data", "model"))
    rules = ShardingRules(data_axes=("data",))
    torch.cuda.reset_peak_memory_stats(dev)
    model = shard_params(init(), rules, mesh)
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, rules, mesh, **kw)
    ops.reset_launch_counts()
    s_metrics, s_ms = run(model, opt, step,
                          lambda bt: local_batch(bt, mesh))
    counts = ops.launch_counts()
    s_peak = torch.cuda.max_memory_allocated(dev)
    check(s_metrics == p_metrics,
          f"sharded (loss, grad norm) {s_metrics} != plain {p_metrics}")
    got = {"params": _digests(gather_params(model)),
           "mu": _digests(gather_tree(opt["mu"])),
           "nu": _digests(gather_tree(opt["nu"]))}
    for t in want:
        bad = [k for k in want[t] if got[t][k] != want[t][k]]
        check(not bad and set(got[t]) == set(want[t]),
              f"sharded {t} differ from the plain step's: {bad[:5]}")
    want_n = _train_want(cfg, cfg.n_layers, times=DIST_STEPS)
    for name in ("flash_attention", "flash_attention_bwd"):
        check(counts[name] == want_n[name],
              f"sharded step: {name} {counts[name]} launches, want "
              f"{want_n[name]}")
    n_leaves = len(want["params"])
    print(f"  (c) qwen3-1.7b SOI pp, 28 layers, bf16 over f32 masters, B 8 "
          f"S 128, {DIST_STEPS} steps: sharded on the (1, 1) NCCL mesh == "
          f"plain bit for bit — (loss, grad norm) {s_metrics}; {n_leaves} "
          f"params, mu, nu leaves equal by digest")
    print(f"  (c) plain step median {p_ms:.2f} ms, peak "
          f"{p_peak / 2 ** 30:.2f} GiB; sharded step median {s_ms:.2f} ms, "
          f"peak {s_peak / 2 ** 30:.2f} GiB (host clock after a "
          f"synchronize, {DIST_STEPS} steps each) [{card}]")
    print(f"  (c) sharded run launches: flash_attention "
          f"{counts['flash_attention']}, flash_attention_bwd "
          f"{counts['flash_attention_bwd']} ({2 * cfg.n_layers} and "
          f"{cfg.n_layers} a step: remat recomputes each layer's forward)")
    calls = profiled("sharded step", lambda: step(model, opt, local_batch(
        batches[DIST_STEPS], mesh)))
    check(calls.get("nccl:all_reduce", 0) > 0,
          "the profiled sharded step issued no NCCL all-reduce")
    del model, opt, step
    _free(dev)
    return counts


def _dist_dryrun(card):
    """(d): the dry run of every cell, as a table."""
    from repro_torch.launch import dryrun
    recs = dryrun.main(["--all", "--mesh", "both", "--out",
                        str(ROOT / "experiments" / "dryrun_torch")])
    over = [f"{r['arch']} {r['shape']} {r['mesh']}" for r in recs
            if r["status"] == "ok" and not r["fits"]]
    print(f"  (d) {sum(r['status'] == 'ok' for r in recs)} cells laid out, "
          f"{len(over)} over {dryrun.CARD_BYTES / 1e9:.2f} GB a device: "
          f"{over or 'none'} (params, AdamW state, batch or decode state; "
          f"activations not counted) [{card}]")


def dist_phase(dev, card) -> dict:
    """Phase 21. Returns the sharded train run's launch counts."""
    import torch.distributed as dist
    phase("21 dist (NCCL at world size 1: collectives, the sharded qwen3-1.7b "
          "train step against the plain step, the dry run)")
    t0 = time.perf_counter()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        print(f"  (a) process group: backend {dist.get_backend()}, world "
              f"{dist.get_world_size()}; mesh (1, 1) ('data', 'model')")
        _dist_collectives(dev)
        counts = _dist_train(dev, card)
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived phase 21")
    _dist_dryrun(card)
    print(f"  phase 21: {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# 22. train-families: the MoE, MLA, RG-LRU and windowed stacks trained
# ---------------------------------------------------------------------------

# flash_attention_bwd at deepseek-v2's MLA prefill dims (d_qk 192 =
# qk_nope 128 + qk_rope 64, d_v 128) and its 128 heads, (label, B, S): the
# training step's shape and the serving prefill bucket's; the first is the
# JSON's row
MLA_BWD_SHAPES = (("train", 8, 128), ("prefill bucket", 1, 1024))
MLA_HEADS, MLA_DIMS = (128, 128), (192, 128)
# lru_scan_bwd, (label, B, S, D, h0): recurrentgemma-9b's training step
# (width 4096), its outer serving prefill, and the edge path (D % 32 != 0);
# the first two are timed, the first is the JSON's row
LRU_BWD_SHAPES = (("train", 8, 128, 4096, False),
                  ("outer prefill", 1, 2040, 4096, True),
                  ("edge", 3, 37, 100, True))
FAMILY_STEPS = 5
FAMILY_PROFILED = 2


def _train_families():
    """(label, full-width config, cut, flash_attention launches a loss,
    lru_scan launches a loss) of each family phase 22 trains: bf16 over
    float32 masters, SOI pp, depth cut only as far as 80 GB forces at 18
    bytes a parameter (f32 master, grad and AdamW's two moments, bf16
    copy)."""
    from repro_torch import configs
    from repro_torch.configs import deepseek_v2_236b as D
    return (
        ("olmoe-1b-7b", configs.get("olmoe-1b-7b", soi="pp", n_layers=6),
         "6 of 16 layers", 6, 0),
        ("deepseek-v2 MLA stack", D.mla_dense_config(soi="pp", n_layers=4),
         "mla_dense_config: 4 layers of its layer-0 block (MLA + SwiGLU "
         "12288); its MoE layers need 4 chips", 4, 0),
        ("recurrentgemma-9b", configs.get("recurrentgemma-9b", soi="pp",
                                          n_layers=6),
         "6 of 38 layers: two (RG-LRU, RG-LRU, local attention) patterns",
         0, 4),
        ("h2o-danube-1.8b", configs.get("h2o-danube-1.8b", soi="pp"),
         "none (24 layers)", 0, 0))


def _parity_families():
    """(label, 4-layer config, (flash_attention, lru_scan) launches a
    loss) of (b)'s kernels-against-plain checks: the three families whose
    training runs a kernel (danube's window takes the plain route on
    every device, so its training launches none)."""
    from repro_torch import configs
    from repro_torch.configs import deepseek_v2_236b as D
    return (
        ("olmoe-1b-7b", configs.get("olmoe-1b-7b", soi="pp", n_layers=4),
         (4, 0)),
        ("deepseek-v2 MLA stack", D.mla_dense_config(soi="pp", n_layers=4),
         (4, 0)),
        # (RG-LRU, RG-LRU, local attention) and one more RG-LRU layer
        ("recurrentgemma-9b", configs.get("recurrentgemma-9b", soi="pp",
                                          n_layers=4), (0, 3)))


def _bwd_shape_checks(cases, dev, gen) -> dict:
    """(a) of phases 22 and 23, at each (label, B, Sq, Sk, (H, Hkv), (d_qk,
    d_v), causal) of ``cases``: the forward's lse and output, then
    flash_attention_bwd against the plain version in f32 and bf16, twice
    for the bits; the bf16 times beside SDPA's backward (E_v may differ
    from E) and the bound. Returns {label: its bf16 timing record}."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    recs = {}
    for label, b, sq, sk, heads, dims, causal in cases:
        for dt in (torch.float32, torch.bfloat16):
            make, nbytes = _bwd_inputs(b, sq, dt, dev, gen, heads, dims,
                                       sk=sk, causal=causal)
            q, k, v, out, do, lse = make()
            want_o = ref.flash_attention(q, k, v, causal=causal)
            want_lse = ref.attention_lse(q, k, causal=causal)
            err_o = float((out.float() - want_o.float()).abs().max())
            err_lse = float((lse - want_lse).abs().max()
                            / want_lse.abs().max())
            del want_o, want_lse
            check(err_o < TOL[dt], f"{label} flash fwd {dt}: {err_o}")
            check(err_lse < LSE_REL_TOL[dt],
                  f"{label} flash lse {dt}: rel {err_lse}")
            got = FA.flash_attention_bwd(q, k, v, out, do, lse,
                                         causal=causal)
            again = FA.flash_attention_bwd(q, k, v, out, do, lse,
                                           causal=causal)
            want = ref.flash_attention_bwd(q, k, v, out, do, lse,
                                           causal=causal)
            torch.cuda.synchronize(dev)
            rels, abs_err = [], 0.0
            for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
                check(g.shape == w.shape, f"{label} bwd {name} "
                                          f"{tuple(g.shape)}")
                check(torch.equal(g, a), f"{label} flash_attention_bwd "
                                         f"{dt} {name}: not bit for bit")
                d = float((g.float() - w.float()).abs().max())
                abs_err = max(abs_err, d)
                rels.append(d / float(w.float().abs().max()))
                check(rels[-1] <= TOL[dt], f"{label} flash_attention_bwd "
                      f"{dt} {name}: rel max|Δ| {rels[-1]} > {TOL[dt]}")
            print(f"  (a) {label} ({b},{sq}/Sk {sk},{heads[0]}/{heads[1]},"
                  f"{dims[0]}" + (f"/{dims[1]}" if dims[1] != dims[0]
                                  else "")
                  + f", {'causal' if causal else 'non-causal'}) "
                  f"{str(dt)[6:]}: out max|Δ| {err_o:.2e}, lse rel "
                  f"{err_lse:.2e}; bwd rel max|Δ| dq {rels[0]:.2e} dk "
                  f"{rels[1]:.2e} dv {rels[2]:.2e}; run to run bit for bit",
                  flush=True)
            del q, k, v, out, do, lse, got, again, want
            if dt == torch.bfloat16:
                recs[label] = _bwd_timing(make, nbytes, b, sq, dt, abs_err,
                                          with_fwd=False, heads=heads,
                                          dims=dims, sk=sk, causal=causal)
            _free(dev)
    return recs


def _mla_bwd_checks(dev, gen) -> dict:
    """(a) flash_attention_bwd at (192, 128), 128 heads, at each
    MLA_BWD_SHAPES shape (``_bwd_shape_checks``). Returns the training
    shape's record, the other under "shapes"."""
    recs = _bwd_shape_checks([(f"MLA {label}", b, s, s, MLA_HEADS, MLA_DIMS,
                               True) for label, b, s in MLA_BWD_SHAPES],
                             dev, gen)
    rec, *rest = recs.values()
    rec["shapes"] = rest
    return rec


def _lru_bwd_inputs(b, s, d, with_h0, dev, gen):
    """A maker of (a, g, h, h0): decays in (0.1, 0.99), h the forward
    kernel's scan of them; and the bytes the backward must move (a, g, h
    (and h0) read, da, dx (and dh0) written, float32)."""
    from repro_torch.kernels import ops

    def make():
        a = torch.rand((b, s, d), generator=gen, device=dev) * 0.89 + 0.1
        x = torch.randn((b, s, d), generator=gen, device=dev)
        g = torch.randn((b, s, d), generator=gen, device=dev)
        h0 = (torch.randn((b, d), generator=gen, device=dev) if with_h0
              else None)
        h, _ = ops.lru_scan(a, x, h0)
        return a, g, h, h0
    nbytes = 4 * (5 * b * s * d + (2 * b * d if with_h0 else 0))
    return make, nbytes


def _lru_bwd_checks(dev, gen) -> dict:
    """(a) lru_scan_bwd at each LRU_BWD_SHAPES shape against the plain
    ref.lru_scan_bwd on the card, bit for bit, launched twice; its device
    ms at the first two beside the plain version's and the bound (no
    library yardstick: no single PyTorch call computes the recurrence's
    gradient). Returns the training shape's record, the other timed one
    under "shapes"."""
    from repro_torch.kernels import lru_scan as LS
    from repro_torch.kernels import ops, ref
    recs = []
    for label, b, s, d, with_h0 in LRU_BWD_SHAPES:
        make, nbytes = _lru_bwd_inputs(b, s, d, with_h0, dev, gen)
        a, g, h, h0 = make()
        got = ops.lru_scan_bwd(a, g, h, h0)
        again = ops.lru_scan_bwd(a, g, h, h0)
        want = ref.lru_scan_bwd(a, g, h, h0)
        torch.cuda.synchronize(dev)
        err = 0.0
        for name, x, y, w in zip(("da", "dx", "dh0"), got, again, want):
            if w is None:
                continue
            check(torch.equal(x, y), f"lru_scan_bwd {label} {name}: not "
                                     f"bit for bit run to run")
            err = max(err, float((x - w).abs().max()))
            check(torch.equal(x, w), f"lru_scan_bwd {label} {name}: max|Δ| "
                                     f"{err} against the plain version "
                                     f"(want bit for bit)")
        plan = LS.lru_plan(b, s, d, torch.float32, streams=3)
        line = (f"  (a) lru_scan_bwd {label} ({b},{s},{d}) f32"
                f"{' with h0' if with_h0 else ''}: bit for bit the plain "
                f"version, run to run; plan: {plan.chains} chain-warps, "
                f"{plan.warps} a block, "
                + ("edge path" if plan.edge else
                   f"{plan.stages} stages of {plan.steps} steps"))
        del a, g, h, h0, got, again, want
        if label == "edge":
            print(line, flush=True)
            continue
        sets = _copies(make, nbytes)
        bound, by = _bound(nbytes, 3.0 * b * s * d, torch.float32)
        ms = _device_ms(ops.lru_scan_bwd, sets, 50, bound_ms=bound,
                        markers=MARKERS, each=("lru_scan_bwd_kernel",))
        plain_ms = _device_ms(ref.lru_scan_bwd, sets[:2], 2 if s <= 128
                              else 1, markers=MARKERS)
        del sets
        _free(dev)
        print(f"{line}; {ms:.4f} ms (plain {plain_ms:.4f}; bound "
              f"{bound:.5f} ms, {by}: {nbytes / 1e6:.1f} MB; no library "
              f"yardstick)", flush=True)
        recs.append({"name": "lru_scan_bwd", "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": None, "shape": [b, s, d],
                     "dtype": "float32"})
    rec = recs[0]
    rec["shapes"] = recs[1:]
    return rec


def _family_grad_parity(label, cfg, dev, want) -> None:
    """(b) one loss and gradient, then one make_train_step step, of
    ``cfg`` cut to 4 layers in float32, through the kernels and again with
    attention and the RG-LRU scan on their plain versions: loss, aux,
    every gradient and the step's metrics within GRAD_TOL. ``want``: the
    kernel route's launches a loss."""
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(cfg, dtype="float32")
    pipe = ShardedLMPipeline(global_batch=8, seq_len=128, vocab=cfg.vocab,
                             seed=0)
    batch = _train_batch(pipe, 0, dev)
    kern = T.init(cfg, generator=torch.Generator(device=dev).manual_seed(22),
                  device=dev)
    plain = copy.deepcopy(kern)
    step = make_train_step(cfg, peak_lr=1e-3, warmup=20,
                           total_steps=FAMILY_STEPS)
    res = {}
    for route, model in (("kernels", kern), ("plain", plain)):
        saved = ops.flash_attention, ops.lru_scan
        if route == "plain":
            ops.flash_attention, ops.lru_scan = (ref.flash_attention,
                                                 ref.lru_scan)
        try:
            ops.reset_launch_counts()
            named = dict(model.named_parameters())
            loss, metrics = T.loss_fn(model, cfg, batch)
            grads = dict(zip(named, torch.autograd.grad(
                loss, list(named.values()))))
            torch.cuda.synchronize(dev)
            counts = ops.launch_counts()
        finally:
            ops.flash_attention, ops.lru_scan = saved
        res[route] = (float(loss.detach()), float(metrics["aux"].detach()),
                      grads, counts)
    (lk, ak, gk, ck), (lp, ap, gp, cp_) = res["kernels"], res["plain"]
    _counts_want(ck, _train_want(cfg, *want),
                 f"{label} 4-layer parity, kernels")
    _counts_want(cp_, {}, f"{label} 4-layer parity, plain")
    rel_loss = abs(lk - lp) / abs(lp)
    check(rel_loss <= GRAD_TOL, f"{label} 4-layer loss {lk} vs plain {lp}")
    check(abs(ak - ap) <= GRAD_TOL * max(abs(ap), 1e-30),
          f"{label} 4-layer aux {ak} vs plain {ap}")
    worst = 0.0
    for k in gp:
        r = float((gk[k] - gp[k]).abs().max()
                  / gp[k].abs().max().clamp_min(1e-30))
        worst = max(worst, r)
        check(r <= GRAD_TOL, f"{label} 4-layer grad {k}: rel {r}")
    del res, gk, gp, grads, named, loss, metrics
    # one model at a time through the step (its AdamW state and clipped
    # gradients beside it): 4 f32 layers of olmoe are 7.6 GB a copy
    models = {"kernels": kern, "plain": plain}
    del kern, plain
    _free(dev)
    mets = {}
    for route in ("kernels", "plain"):
        model = models.pop(route)
        saved = ops.flash_attention, ops.lru_scan
        if route == "plain":
            ops.flash_attention, ops.lru_scan = (ref.flash_attention,
                                                 ref.lru_scan)
        try:
            opt = adamw_init(dict(model.named_parameters()))
            _, _, m = step(model, opt, batch)
            mets[route] = {k: float(v) for k, v in m.items()}
        finally:
            ops.flash_attention, ops.lru_scan = saved
        del model, opt, m
        _free(dev)
    for k, v in mets["plain"].items():
        check(abs(mets["kernels"][k] - v) <= GRAD_TOL * max(abs(v), 1e-30),
              f"{label} 4-layer step {k}: {mets['kernels'][k]} vs plain {v}")
    print(f"  (b) {label}, 4 layers f32 (SOI pp), B 8 S 128: loss {lk:.6f} "
          f"vs plain {lp:.6f} (rel {rel_loss:.2e}), aux {ak:.6f} vs "
          f"{ap:.6f}; worst grad rel max|Δ| {worst:.2e}; a step's loss / "
          f"grad norm {mets['kernels']['loss']:.6f} / "
          f"{mets['kernels']['grad_norm']:.4f} vs plain "
          f"{mets['plain']['loss']:.6f} / {mets['plain']['grad_norm']:.4f}; "
          f"kernels a loss: flash {ck['flash_attention']} + "
          f"{ck['flash_attention_bwd']} bwd, lru_scan {ck['lru_scan']} + "
          f"{ck['lru_scan_bwd']} bwd", flush=True)
    del step
    _free(dev)


def _family_train(label, cfg, cut, want, dev, card, peak_gib=80.0,
                  tally=None, extras=None) -> dict:
    """(c) FAMILY_STEPS make_train_step steps of ``cfg`` at full width,
    bf16 over float32 masters, B 8 S 128, as launch.train.main builds
    them (the stub frontends' batch keys too, or ``extras`` in their
    place): every loss finite, the
    launches exact (``want``: flash and lru_scan launches a step), step ms
    and tokens/s of the S text tokens (median after 2, host clock after a
    synchronize), peak GiB under ``peak_gib``, then FAMILY_PROFILED more
    steps profiled between markers (busy share). ``tally`` (a dict)
    receives the measured steps' flash_attention_bwd launches by (B, Sq,
    Sk, H, Hkv, d). Returns the run's launch counts."""
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import stub_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    _free(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = T.init(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                   device=dev)
    opt = adamw_init(dict(model.named_parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    step = make_train_step(cfg, peak_lr=1e-3, warmup=20,
                           total_steps=FAMILY_STEPS)
    pipe = ShardedLMPipeline(global_batch=8, seq_len=128, vocab=cfg.vocab,
                             seed=0)
    if extras is None:
        extras = stub_batch(cfg, 8, dev)
    batches = [dict(_train_batch(pipe, i, dev), **extras)
               for i in range(FAMILY_STEPS + FAMILY_PROFILED)]
    torch.cuda.synchronize(dev)
    setup = time.perf_counter() - t0
    ops.reset_launch_counts()
    losses, auxes, times = [], [], []
    with _flash_shapes(tally):
        for i in range(FAMILY_STEPS):
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            _, _, m = step(model, opt, batches[i])
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux"]))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(map(math.isfinite, losses + auxes)),
          f"{label}: non-finite losses {losses} / aux {auxes}")
    _counts_want(counts, _train_want(cfg, *want, times=FAMILY_STEPS),
                 f"{label} train")
    check(peak < peak_gib * 2 ** 30, f"{label}: peak {peak / 2 ** 30:.2f} "
                                     f"GiB, over {peak_gib}")
    med = sorted(times[2:])[len(times[2:]) // 2] * 1e3
    ev = _device_events(lambda: [step(model, opt, batches[FAMILY_STEPS + i])
                                 for i in range(FAMILY_PROFILED)],
                        markers=MARKERS)
    window = max(e for _s, e, _n in ev) - min(s_ for s_, _e, _n in ev)
    busy = _window_profile(ev, FAMILY_PROFILED, f"(c) {label}, "
                           f"{FAMILY_PROFILED} profiled steps:", "step")
    print(f"  (c) {label} ({cut}; {n_params / 1e9:.3f} B params, "
          f"{18 * n_params / 1e9:.1f} GB at 18 B a param), bf16 over f32 "
          f"masters, {_soi_of(cfg)}, B 8 S 128"
          + "".join(f" + {k} {tuple(v.shape[1:])}" for k, v in extras.items())
          + f", {FAMILY_STEPS} steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (aux {auxes[0]:.5f} -> "
          f"{auxes[-1]:.5f}); step median {med:.2f} ms (host clock after a "
          f"synchronize, {FAMILY_STEPS - 2} after 2), "
          f"{8 * 128 / med * 1e3:.0f} tokens/s; busy share "
          f"{busy / window:.3f}; {len(ev) / FAMILY_PROFILED:.0f} device "
          f"kernels a step; peak {peak / 2 ** 30:.2f} GiB; launches a step: "
          f"flash {counts['flash_attention'] // FAMILY_STEPS} + "
          f"{counts['flash_attention_bwd'] // FAMILY_STEPS} bwd, lru_scan "
          f"{counts['lru_scan'] // FAMILY_STEPS} + "
          f"{counts['lru_scan_bwd'] // FAMILY_STEPS} bwd; set-up "
          f"{setup:.1f} s  [{card}]", flush=True)
    del model, opt, step, batches
    _free(dev)
    return counts


def _soi_of(cfg) -> str:
    return f"SOI {cfg.soi.mode}" if cfg.soi is not None else "no SOI"


@contextlib.contextmanager
def _flash_shapes(tally):
    """With ``tally`` (a dict), count every ``flash_attention_bwd`` launch
    of ``FlashAttentionFn``'s backward — one a training call, whose
    forward runs once more where remat recomputes its layer — by (B, Sq,
    Sk, H, Hkv, d_qk): the kernels' launch counters are the wrappers',
    unchanged."""
    if tally is None:
        yield
        return
    from repro_torch.kernels import flash_attention as FA
    launch = FA.flash_attention_bwd

    def counted(q, k, *args, **kw):
        key = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
               q.shape[3])
        tally[key] = tally.get(key, 0) + 1
        # the wrapper counts its launch on the module's name: its own
        FA.flash_attention_bwd = launch
        try:
            return launch(q, k, *args, **kw)
        finally:
            FA.flash_attention_bwd = counted
    FA.flash_attention_bwd = counted
    try:
        yield
    finally:
        FA.flash_attention_bwd = launch


def train_families_phase(dev, card) -> tuple:
    """Phase 22. Returns (the MLA flash_attention_bwd record, the
    lru_scan_bwd record, {family: launch counts of its (c) run})."""
    phase("22 train-families (flash_attention_bwd at MLA's (192, 128), "
          "lru_scan_bwd; olmoe-1b-7b, deepseek-v2's MLA stack, "
          "recurrentgemma-9b and h2o-danube-1.8b trained at full width)")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(22)
    mla_rec = _mla_bwd_checks(dev, gen)
    lru_rec = _lru_bwd_checks(dev, gen)
    for label, cfg, want in _parity_families():
        _family_grad_parity(label, cfg, dev, want)
    counts = {}
    for label, cfg, cut, flash, lru in _train_families():
        counts[label] = _family_train(label, cfg, cut, (flash, lru), dev,
                                      card)
    print(f"  phase 22 took {time.perf_counter() - t0:.1f} s [{card}]")
    return mla_rec, lru_rec, counts


# ---------------------------------------------------------------------------
# 23. train-zoo: the encoder-decoder, prefix-LM, RWKV and LayerNorm /
#     plain-MLP stacks trained
# ---------------------------------------------------------------------------

# flash_attention_bwd at the shapes this slice's training gives it, (label,
# B, Sq, Sk, (H, Hkv), (d_qk, d_v), causal): whisper-tiny's encoder over
# its 1500 frames (Sk = 23 x 64 + 28: a ragged last key tile), its cross
# layers' 128 queries against them, its decoder's self attention (B 8, S
# 128), and nemotron-4-15b's G 6 at (b)'s B 2
ZOO_BWD_SHAPES = (
    ("whisper encoder", 8, 1500, 1500, (6, 6), (64, 64), False),
    ("whisper cross", 8, 128, 1500, (6, 6), (64, 64), False),
    ("whisper self", 8, 128, 128, (6, 6), (64, 64), True),
    ("nemotron G 6", 2, 128, 128, (48, 8), (128, 128), True))
# (b)'s float64 anchor (rwkv6): a leaf's float32 gradients, the card's and
# the CPU's, each off the float64 run by (max|Δ| / its largest), within
# RATIO_64 of each other; below FLOOR_64 both are rounding alike
RATIO_64, FLOOR_64 = 10.0, 1e-6
# whisper's shapes are launched by (c)'s whisper run, nemotron's by (b)
ZOO_BWD_ON = {"whisper encoder": "whisper-tiny", "whisper cross":
              "whisper-tiny", "whisper self": "whisper-tiny",
              "nemotron G 6": "nemotron-4-15b"}


def _zoo_parity_archs():
    """(label, config at full width, cut, batch, flash_attention launches
    a loss, float64 anchor) of (b): float32, no SOI but rwkv6's (SOI pp,
    as it serves)."""
    from repro_torch import configs
    return (
        ("whisper-tiny", configs.get("whisper-tiny"),
         "none (4 + 4 layers, 1500 frames)", 4, 12, False),
        ("paligemma-3b", configs.get("paligemma-3b", n_layers=2),
         "2 of 18 layers, 256 patch embeddings", 4, 0, False),
        ("rwkv6-1.6b", configs.get("rwkv6-1.6b", soi="pp", n_layers=4),
         "4 of 24 layers, SOI pp over 1..3", 4, 0, True),
        ("nemotron-4-15b", configs.get("nemotron-4-15b", n_layers=2),
         "2 of 32 layers (3.93 B parameters)", 2, 2, False))


def _zoo_train_archs():
    """(label, full-width config, cut, flash_attention launches a step,
    peak GiB limit, seeded random patch embeddings in place of the zero
    stub) of (c). paligemma runs without SOI: its prefix-LM attention then
    takes the plain route in every layer, as the reference's does. Its
    batch carries random patch embeddings, as an image encoder would give
    them: behind the zero stub of the reference's trainer the 256 prefix
    rows stay 0 through every layer (q, k, v, the MLP and the residual are
    0 there), and each layer's RMSNorm backward multiplies their gradient
    by rsqrt(eps) = 1000, so past ~12 layers it overflows to inf and 0 x
    inf puts NaN in the weight gradients — the reference's gradient at 18
    layers behind that stub is non-finite too (ROADMAP.md Queue 3)."""
    from repro_torch import configs
    return (
        ("whisper-tiny", configs.get("whisper-tiny"),
         "none (4 + 4 layers, 1500 frames)", 12, 80.0, False),
        ("paligemma-3b", configs.get("paligemma-3b"),
         "none (18 layers, 256 random patch embeddings)", 0, 72.0, True),
        ("rwkv6-1.6b", configs.get("rwkv6-1.6b", soi="pp"),
         "none (24 layers)", 0, 80.0, False))


def _float64_grads(model, cfg, batch):
    """(loss, {name: grad}) of a float64 copy of ``model`` on the card, the
    model code's float32 upcasts (``.float()``) and compute dtype made
    float64 for the call: the reference of (b)'s RWKV check (its stack runs
    no kernel, so every op takes float64)."""
    from repro_torch.models import transformer as T
    m64 = copy.deepcopy(model).double()
    upcast, dtype = torch.Tensor.float, T._dtype
    torch.Tensor.float = lambda self, *a, **kw: self.double()
    T._dtype = lambda c: torch.float64
    try:
        return _grads(m64, cfg, {k: v.double() if v.is_floating_point()
                                 else v for k, v in batch.items()})
    finally:
        torch.Tensor.float, T._dtype = upcast, dtype


def _zoo_grad_parity(label, cfg, cut, bsz, want, dev, tally,
                     anchor64=False) -> dict:
    """(b) one loss and its gradients of ``cfg`` in float32 on the card,
    through the kernels, against the same weights and batch on the CPU
    (the plain versions): loss and every gradient within GRAD_TOL of the
    CPU's largest |value|; flash launches a loss exact (``want``). With
    ``anchor64`` a leaf past GRAD_TOL passes only if the card's and the
    CPU's float32 gradients sit equally far (within RATIO_64 of each
    other) from a float64 run on the card: rwkv6's token-shift mix is a
    clamp that holds ~70% of its entries at an edge, and an entry within
    rounding of the edge takes another side on another device, so its
    float32 gradients are far from float64 on both devices alike.
    Returns the card run's launch counts."""
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.train import stub_batch
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    model = T.init(cfg, generator=torch.Generator(device=dev).manual_seed(
        23), device=dev)
    cpu = _cpu_copy(model, cfg)
    pipe = ShardedLMPipeline(global_batch=bsz, seq_len=128, vocab=cfg.vocab,
                             seed=0)
    batch = _train_batch(pipe, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(24)
    for k, v in stub_batch(cfg, bsz, dev).items():
        batch[k] = torch.randn(v.shape, generator=gen, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    ops.reset_launch_counts()
    with _flash_shapes(tally):
        lc, gc = _grads(model, cfg, batch)
        torch.cuda.synchronize(dev)
    counts = ops.launch_counts()
    card_s = time.perf_counter() - t0
    _counts_want(counts, _train_want(cfg, want),
                 f"{label} card vs CPU, card run")
    l64 = g64 = None
    if anchor64:
        l64, g64 = _float64_grads(model, cfg, batch)
    # the card keeps its gradients; the weights go before the CPU run
    del model
    _free(dev)
    t1 = time.perf_counter()
    lp, gp = _grads(cpu, cfg, {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t1
    rel_loss = abs(float(lc) - float(lp)) / abs(float(lp))
    check(rel_loss <= GRAD_TOL, f"{label} loss {float(lc)} vs CPU "
                                f"{float(lp)}")
    worst, where, anchored = 0.0, None, []
    for k in gp:
        want_k = gp[k].to(dev)
        r = float((gc[k] - want_k).abs().max()
                  / want_k.abs().max().clamp_min(1e-30))
        if r > worst:
            worst, where = r, k
        if r > GRAD_TOL and g64 is not None:
            w = g64[k]
            scale = float(w.abs().max().clamp_min(1e-300))
            e_card, e_cpu = (max(float((g.double() - w).abs().max())
                                 / scale, FLOOR_64)
                             for g in (gc[k], want_k))
            check(e_card <= RATIO_64 * e_cpu and e_cpu <= RATIO_64 * e_card,
                  f"{label} grad {k}: card vs CPU rel {r}, and against "
                  f"float64 card {e_card} / CPU {e_cpu}")
            anchored.append((r, e_card, e_cpu, k))
            continue
        check(r <= GRAD_TOL, f"{label} grad {k}: rel {r} card vs CPU")
    line = ""
    if anchor64:
        top = max(anchored, default=None)
        line = (f"; float64 loss {float(l64):.6f}; {len(anchored)} of "
                f"{len(gp)} leaves past {GRAD_TOL} card vs CPU, each as far "
                f"from float64 on both devices"
                + (f" (worst {top[3]}: card vs CPU {top[0]:.2e}, float64 "
                   f"off by {top[1]:.2e} card / {top[2]:.2e} CPU)"
                   if top else ""))
    print(f"  (b) {label} ({cut}; {n_params / 1e9:.3f} B params), f32, B "
          f"{bsz} S 128"
          + "".join(f" + {k} {tuple(batch[k].shape[1:])}"
                    for k in ("patch_embeds", "encoder_frames")
                    if k in batch)
          + f": loss {float(lc):.6f} card vs {float(lp):.6f} CPU (rel "
          f"{rel_loss:.2e}); worst grad rel max|Δ| {worst:.2e} ({where})"
          + line + f"; flash {counts['flash_attention']} + "
          f"{counts['flash_attention_bwd']} bwd a loss; card {card_s:.1f} "
          f"s with the copy, CPU {cpu_s:.1f} s; host peak RSS "
          f"{_host_peak_gib():.1f} GiB", flush=True)
    del cpu, gc, gp, g64, batch
    _free(dev)
    return counts


def zoo_train_phase(dev, card) -> tuple:
    """Phase 23. Returns ({label: (a)'s timing record with its launches},
    {family: launch counts of its (c) run})."""
    phase("23 train-zoo (flash_attention_bwd at whisper's 1500 frames and "
          "nemotron's G 6; whisper-tiny, paligemma-3b, rwkv6-1.6b and "
          "nemotron-4-15b card vs CPU; whisper, paligemma and rwkv6 "
          "trained at full width)")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(23)
    recs = _bwd_shape_checks(ZOO_BWD_SHAPES, dev, gen)
    shapes = {}                    # (B, Sq, Sk, H, Hkv, d) -> launches
    for label, cfg, cut, bsz, want, anchor in _zoo_parity_archs():
        tally = {} if label == "nemotron-4-15b" else None
        _zoo_grad_parity(label, cfg, cut, bsz, want, dev, tally,
                         anchor64=anchor)
        shapes.update(tally or {})
    counts = {}
    for label, cfg, cut, flash, peak, random_prefix in _zoo_train_archs():
        tally = {} if flash else None
        extras = None
        if random_prefix:
            extras = {"patch_embeds": torch.randn(
                (8, cfg.frontend_len, cfg.d_model), generator=gen,
                device=dev).to(torch.bfloat16)}
        counts[label] = _family_train(label, cfg, cut, (flash, 0), dev,
                                      card, peak_gib=peak, tally=tally,
                                      extras=extras)
        shapes.update(tally or {})
    for label, b, sq, sk, (h, hkv), (dh, _), _causal in ZOO_BWD_SHAPES:
        n = shapes.get((b, sq, sk, h, hkv, dh), 0)
        arch = ZOO_BWD_ON[label]
        check(n > 0, f"flash_attention_bwd never ran at {label}'s shape on "
                     f"{arch}'s training")
        recs[label].update(
            launches=n, launches_on=(
                f"train zoo ({arch}, {FAMILY_STEPS} steps)"
                if arch in counts else f"train zoo ({arch} card vs CPU, "
                                       f"one loss)"))
    print(f"  (a) flash_attention_bwd launches by shape: "
          f"{', '.join(f'{k}: {v}' for k, v in shapes.items())}")
    print(f"  phase 23 took {time.perf_counter() - t0:.1f} s [{card}]")
    return recs, counts



# ---------------------------------------------------------------------------
# 24. serve-mesh: tensor-parallel serving, the KV sequence over the model axis
# ---------------------------------------------------------------------------

# (a) decode_attention's return_lse at qwen3-1.7b's outer ring (4, 1088, 8,
# 128) split over 2 ranks: a rank's shard of 544 rows, read with and
# without its lse in turns between markers, LSE_PAIRS pairs
LSE_PAIRS = 3
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (b) the sharded prefill + serve steps on a (1, 1) NCCL mesh, phase 5's
# weights and prompts (4 x 1024), the clocks staggered by one a slot (SOI
# phases 0 and 1 side by side), max_len phase 5's ring
MESH_STEPS = 32
MESH_MAX_LEN = 1088
MESH_STAGGER = (0, 1, 2, 3)
# (c) two gloo ranks sharing the card: full width, depth cut, float32
MESH_GLOO_LAYERS = 4
MESH_GLOO_STEPS = 8
MESH_GLOO_TOL = 1e-3
MESH_DIR = ROOT / "build" / "serve_mesh"


def _lse_checks(dev, gen, card) -> dict:
    """(a): the CUDA (out, lse) of a rank's shard against the plain
    version's in bf16 and f32, a shard that sees no row of slot 0 (out 0,
    lse -inf), the two shards merged in rank order against the whole
    read; then the bf16 shard timed with and without its lse in turns.
    Returns the bf16 record."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref
    rec = None
    for dt in (torch.bfloat16, torch.float32):
        sets, nbytes, flops, library, _ = _decode_case(
            4, MESH_MAX_LEN, 8, 2, 128, dt, 1056, dev, gen)
        q, k, v, pos, t = sets[0]
        half = MESH_MAX_LEN // 2
        shards = []
        errs, lse_errs = [], []
        for r in range(2):
            sl = slice(r * half, (r + 1) * half)
            args = (q,) + tuple(x[:, sl].contiguous() for x in (k, v, pos)) \
                + (t,)
            if r:
                # slot 0's clock before the shard's first row: it sees none
                args[3][0] = -1
            n0 = DA.decode_attention.launches
            out, lse = DA.decode_attention(*args, return_lse=True)
            torch.cuda.synchronize()
            check(DA.decode_attention.launches == n0 + 1,
                  "decode_attention with lse: not one launch a call")
            w_out, w_lse = ref.decode_attention(*args, return_lse=True)
            dead = torch.isneginf(w_lse)
            check(torch.equal(torch.isneginf(lse), dead) and bool(
                dead[0].all()) == bool(r), f"lse -inf where no row is seen "
                                           f"({dt}, shard {r})")
            check(not torch.isnan(lse).any() and not out[dead].any(),
                  f"a read that sees no row: NaN or out != 0 ({dt})")
            err = float((out.float() - w_out.float()).abs().max())
            tol = TOL[dt]
            if dt == torch.bfloat16:
                tol = min(tol, READ_REL_TOL * float(w_out.float().abs()
                                                    .max()))
            lerr = float((lse[~dead] - w_lse[~dead]).abs().max())
            check(err < tol and lerr < LSE_TOL[dt],
                  f"decode_attention lse {dt} shard {r}: max|Δ| out {err} "
                  f"(tol {tol}), lse {lerr} (tol {LSE_TOL[dt]})")
            plain_out = DA.decode_attention(*args)
            check(torch.equal(out[~dead], plain_out[~dead]),
                  f"decode_attention {dt}: the read without lse differs")
            errs.append(err)
            lse_errs.append(lerr)
            shards.append((args, out, lse))
        whole_args = (q, k, v, torch.cat([shards[0][0][3], shards[1][0][3]],
                                         dim=1), t)
        whole = DA.decode_attention(*whole_args)
        merged = ref.merge_partials(torch.stack([shards[0][1], shards[1][1]]),
                                    torch.stack([shards[0][2],
                                                 shards[1][2]]))
        merr = float((merged.float() - whole.float()).abs().max())
        tol = TOL[dt]
        if dt == torch.bfloat16:
            tol = min(tol, READ_REL_TOL * float(whole.float().abs().max()))
        check(merr < tol, f"merged shards vs the whole read {dt}: {merr}")
        print(f"  (a) decode_attention return_lse {str(dt)[6:]}, 2 shards "
              f"of (4,{half},8,128) G 2: max|Δ| out {max(errs):.2e}, lse "
              f"{max(lse_errs):.2e}; slot 0 on shard 1 sees no row: out 0, "
              f"lse -inf; merged in rank order vs the whole (4,"
              f"{MESH_MAX_LEN},8,128) read {merr:.2e}; the read without "
              f"lse equal bit for bit", flush=True)
        if dt != torch.bfloat16:
            continue
        # timing: rank 0's shard (every row live), the call's kernels held
        # once a call; with and without lse in turns
        shard_sets = [(a, b[:, :half].contiguous(), c[:, :half].contiguous(),
                       d[:, :half].contiguous(), e)
                      for a, b, c, d, e in sets]
        live = int((shard_sets[0][3] >= 0).sum())
        b_, h_, dh_ = q.shape
        esz = 2
        nb = (2 * b_ * h_ * dh_ * esz + shard_sets[0][3].numel() * 4 + b_ * 4
              + 2 * live * 8 * dh_ * esz + b_ * h_ * 4)
        bound_ms, bound_by = _bound(nb, 4.0 * live * h_ * dh_, dt)
        each = _call_kernels("decode_attention", dt, 1)

        def with_lse(*a):
            return DA.decode_attention(*a, return_lse=True)

        def plain_lse(*a):
            return ref.decode_attention(*a, return_lse=True)

        masks = {st[3].data_ptr(): ((st[3] >= 0) & (st[3] <= st[4][:, None]))
                 [:, None, None] for st in shard_sets}

        def lib(q, k, v, pos, t):
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=masks[pos.data_ptr()], enable_gqa=True)[:, :, 0]

        pairs = {False: [], True: []}
        for _ in range(LSE_PAIRS):
            for flag, fn in ((False, DA.decode_attention), (True, with_lse)):
                pairs[flag].append(_device_ms(fn, shard_sets, 20,
                                              bound_ms=bound_ms,
                                              markers=MARKERS, each=each))
        plain_ms = _device_ms(plain_lse, shard_sets, 5, bound_ms=bound_ms,
                              markers=MARKERS)
        lib_ms = _device_ms(lib, shard_sets, 20, markers=MARKERS)
        ms = sorted(pairs[True])[LSE_PAIRS // 2]
        rec = {"shape": f"shard (4,{half},8,128) of the outer ring, G 2, "
                        f"return_lse",
               "dtype": "bfloat16", "max_abs_err": max(errs),
               "lse_max_abs_err": max(lse_errs), "merge_err": merr,
               "ms": ms, "ms_pairs": {"without": pairs[False],
                                      "with": pairs[True]},
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms}
        print(f"  (a) bf16 shard, device ms a call in turns (without / with "
              f"lse): {pairs[False]} / {pairs[True]}; plain {plain_ms:.4f}, "
              f"SDPA {lib_ms:.4f}, bound {bound_ms:.5f} ({bound_by}) "
              f"[{card}]", flush=True)
    return rec


def _mesh_collectives(step) -> dict:
    """The collectives one call of ``step`` issues, by name (the host's
    records of the backend's calls; c10d's records of the same calls are
    left out)."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
        torch.cuda.synchronize()
    return dict(Counter(name for _s, _e, name, _w in _records(prof)
                        if name.startswith(("nccl:", "gloo:"))))


def _mesh_run(prefill, step, model, prompt, n_steps, dev):
    """The prefill, the clocks staggered, then ``n_steps`` greedy steps:
    (logits of each, tokens fed, the final state, ms a step)."""
    logits, state = _mesh_state(prefill, model, prompt)
    out, toks, times = [logits.clone()], [], []
    for _ in range(n_steps):
        tok = out[-1].argmax(-1).to(torch.int32)
        toks.append(tok)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, state = step(model, state, tok)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        out.append(logits.clone())
    return out, toks, state, times


def _mesh_launches(cfg, n_steps) -> dict:
    """The kernel launches of a prefill + ``n_steps`` serve steps of
    ``cfg`` at staggered clocks (every step runs the SOI middle):
    ``flash_attention`` once a prefill for each attention layer without a
    window (MLA's included; a window, and a prefix-LM's prefix, take the
    plain route), each cross layer and each encoder layer,
    ``lru_scan`` once for each RG-LRU layer, ``decode_attention`` a step
    for each GQA layer and each cross layer (MLA's dense read is the
    plain one)."""
    from repro_torch.models import transformer as T
    blocks = T.layer_blocks(cfg)
    att = [b.attn for b in blocks if b.attn is not None]
    cross = sum(b.cross_attn is not None for b in blocks)
    enc = 0 if cfg.encoder is None else sum(
        seg.n_layers for seg in cfg.encoder.segments)
    return {"flash_attention": (0 if cfg.prefix_lm else
                                sum(a.window is None for a in att))
            + cross + enc,
            "decode_attention": (sum(not a.is_mla for a in att) + cross)
            * n_steps,
            "lru_scan": sum(b.rglru is not None for b in blocks)}


def _mesh_one_by_one(dev, card, argv=SERVE_ARGV, tag="(b)", flags=None,
                     n_steps=MESH_STEPS, inputs=None,
                     max_len=MESH_MAX_LEN) -> dict:
    """Phase 24 (b) (phase 25 (a): ``argv`` phase 18's olmoe-1b-7b; phase
    26 (a) and (b): deepseek-v2 and recurrentgemma-9b; phase 27 (a): the
    same with ``flags`` fsdp and seq_shard; phase 28 (a): ``inputs`` —
    config, weights, and a batch with the stub frontends — in place of the
    driver's): the serving driver's weights and prompts of ``argv``
    through the plain steps, then the same model sharded on a (1, 1) NCCL
    mesh (``ShardingRules(**flags)``) through make_prefill + ``n_steps``
    make_serve_step, rings of ``max_len`` rows: logits every step and the
    final state bit for bit, launches ``_mesh_launches``'; ms a step, and
    the collectives of one more step after the compared ones, of each.
    Returns the sharded run's launch counts."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import ShardingRules, shard_params
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_prefill, make_serve_step
    t0 = time.perf_counter()
    if inputs is None:
        cfg, model, prompt, _plens, engine = serve.setup(
            serve.parse_args(argv))
        del engine
    else:
        cfg, model, prompt = inputs
    plain = (make_prefill(cfg, max_len=max_len), make_serve_step(cfg))
    p_out, p_toks, st, p_ms = _mesh_run(*plain, model, prompt, n_steps,
                                        dev)
    p_state = {k: v.clone() for k, v in S.flatten(st).items()}
    p_coll = _mesh_collectives(lambda: plain[1](model, st, p_toks[-1]))
    del st
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        rules = ShardingRules(data_axes=("data",), **(flags or {}))
        model = shard_params(model, rules, mesh)
        sharded = (make_prefill(cfg, rules, mesh, max_len=max_len),
                   make_serve_step(cfg, rules, mesh, max_len=max_len))
        ops.reset_launch_counts()
        s_out, s_toks, st, s_ms = _mesh_run(*sharded, model, prompt,
                                            n_steps, dev)
        counts = ops.launch_counts()
        s_flat = {k: v.clone() for k, v in S.flatten(st).items()}
        s_coll = _mesh_collectives(lambda: sharded[1](model, st,
                                                      s_toks[-1]))
        del st
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), f"the process group outlived {tag}")
    check(all(torch.equal(a, b) for a, b in zip(p_out, s_out)),
          f"{tag} sharded logits on the (1, 1) mesh differ from the plain "
          f"steps'")
    check(set(s_flat) == set(p_state) and all(
        torch.equal(s_flat[k], p_state[k]) for k in p_state),
        f"{tag} the sharded state differs from the plain steps'")
    want = _mesh_launches(cfg, n_steps)
    for name, n in want.items():
        check(counts[name] == n, f"{tag} {name} {counts[name]} launches, "
                                 f"want {n}")

    def med(x):
        return sorted(x)[len(x) // 2]
    tokens = prompt["tokens"] if isinstance(prompt, dict) else prompt
    print(f"  {tag} {cfg.name} SOI {cfg.soi.mode if cfg.soi else 'none'}, "
          f"{cfg.n_layers} layers, bf16, B 4 x {tokens.shape[1]}"
          + "".join(f" + {k} {tuple(v.shape[1:])}" for k, v in (
              prompt.items() if isinstance(prompt, dict) else ())
              if k != "tokens")
          + f", clocks staggered {MESH_STAGGER}, "
          f"{n_steps} steps: make_prefill + make_serve_step on the (1, "
          f"1) NCCL mesh, rules {rules} == the plain steps bit for bit "
          f"(logits of the "
          f"prefill and every step, {len(p_state)} state leaves); launches "
          f"{ {k: v for k, v in want.items() if v} }", flush=True)
    print(f"  {tag} ms a step (median, host clock after a synchronize, "
          f"eager): plain {med(p_ms):.3f}, sharded {med(s_ms):.3f}; "
          f"collectives a step: plain {p_coll or 'none'}, sharded {s_coll}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return counts


def _mesh_state(prefill, model, prompt):
    """(logits, state) of a prefill of ``prompt`` (tokens, or a batch dict
    with the stub frontends), the clocks staggered."""
    logits, state = prefill(model, prompt if isinstance(prompt, dict)
                            else {"tokens": prompt})
    state["t"].sub_(torch.tensor(MESH_STAGGER, dtype=torch.int32,
                                 device=state["t"].device))
    return logits, state


def _mesh_cfg():
    from repro_torch import configs
    from repro_torch.configs.base import SOILMCfg
    full = configs.get("qwen3-1.7b", soi="pp", n_layers=MESH_GLOO_LAYERS)
    return dataclasses.replace(full, dtype="float32", soi=SOILMCfg(
        first_layer=1, last_layer=MESH_GLOO_LAYERS - 1, mode="pp"))


def _mesh_inputs(cfg, dev):
    """(f32 weights, prompt) from the seed, the same in every process."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev).manual_seed(24)
    model = T.init(cfg, generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab, (4, 1024), generator=gen,
                           device=dev, dtype=torch.int32)
    return model, prompt


def _mesh_rank(rank, world):
    """(c) one of two gloo ranks sharing the card: the f32 model from the
    seed, sharded on a (1, 2) mesh, prefill + serve steps; writes its
    logits, tokens and launch counts."""
    import os
    import pickle
    import torch.distributed as dist
    from repro_torch.distributed.sharding import ShardingRules, shard_params
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_prefill, make_serve_step
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    store = dist.FileStore(str(MESH_DIR / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        cfg = _mesh_cfg()
        model, prompt = _mesh_inputs(cfg, dev)
        mesh = make_mesh((1, world), ("data", "model"))
        rules = ShardingRules(data_axes=("data",))
        model = shard_params(model, rules, mesh)
        prefill = make_prefill(cfg, rules, mesh, max_len=MESH_MAX_LEN)
        step = make_serve_step(cfg, rules, mesh, max_len=MESH_MAX_LEN)
        ops.reset_launch_counts()
        out, toks, _state, ms = _mesh_run(prefill, step, model, prompt,
                                          MESH_GLOO_STEPS, dev)
        counts = ops.launch_counts()
        _, st = _mesh_state(prefill, model, prompt)
        coll = _mesh_collectives(lambda: step(model, st, toks[0]))
        with open(MESH_DIR / f"rank{rank}.pkl", "wb") as f:
            pickle.dump({"logits": [x.cpu() for x in out],
                         "tokens": [x.cpu() for x in toks],
                         "counts": counts, "ms": ms, "coll": coll}, f)
    finally:
        dist.destroy_process_group()


def _mesh_gloo(dev, card) -> dict:
    """(c): the one-rank f32 steps here, then two gloo ranks on the card
    (the split-sequence read with its lse, the merge, the collectives on
    CUDA tensors): tokens equal, logits within MESH_GLOO_TOL. Returns the
    ranks' launch counts."""
    import pickle
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.launch.steps import make_prefill, make_serve_step
    cfg = _mesh_cfg()
    model, prompt = _mesh_inputs(cfg, dev)
    want, w_toks, _state, w_ms = _mesh_run(
        make_prefill(cfg, max_len=MESH_MAX_LEN), make_serve_step(cfg),
        model, prompt, MESH_GLOO_STEPS, dev)
    del model, _state
    _free(dev)
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    mp.spawn(_mesh_rank, args=(2,), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(MESH_DIR / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    err = 0.0
    for rk in ranks:
        check(all(torch.equal(a, b.cpu()) for a, b in zip(rk["tokens"],
                                                          w_toks)),
              "(c) the 2-rank tokens differ from the one-rank steps'")
        err = max([err] + [float((a - b.cpu()).abs().max())
                           for a, b in zip(rk["logits"], want)])
    check(err < MESH_GLOO_TOL, f"(c) logits {err} from the one-rank steps")
    n_dec = cfg.n_layers * MESH_GLOO_STEPS
    for r, rk in enumerate(ranks):
        check(rk["counts"]["decode_attention"] == n_dec,
              f"(c) rank {r}: decode_attention {rk['counts']} (want "
              f"{n_dec}, every read with its lse)")
        check(rk["counts"]["flash_attention"] == cfg.n_layers,
              f"(c) rank {r}: flash_attention {rk['counts']}")

    def med(x):
        return sorted(x)[len(x) // 2]
    print(f"  (c) two gloo ranks on the one card, (1, 2) mesh, full-width "
          f"qwen3-1.7b cut to {cfg.n_layers} layers (SOI pp 1..3), f32, B 4 "
          f"x 1024, {MESH_GLOO_STEPS} steps: tokens == the one-rank steps, "
          f"logits max|Δ| {err:.2e} (< {MESH_GLOO_TOL}); every ring split "
          f"544 + 544 (outer), 272 + 272 (middle); decode_attention with "
          f"lse {[rk['counts']['decode_attention'] for rk in ranks]}, "
          f"flash_attention on the local heads "
          f"{[rk['counts']['flash_attention'] for rk in ranks]}", flush=True)
    print(f"  (c) ms a step (median, host clock): one rank {med(w_ms):.3f}, "
          f"the two gloo ranks {[round(med(rk['ms']), 3) for rk in ranks]}; "
          f"collectives a step {ranks[0]['coll']}; spawn + run "
          f"{spawn_s:.1f} s [{card}]", flush=True)
    return {"decode_attention": sum(rk["counts"]["decode_attention"]
                                    for rk in ranks),
            "per_rank": [rk["counts"] for rk in ranks]}


def serve_mesh_phase(dev, card) -> tuple:
    """Phase 24. Returns ((a)'s record, (b)'s launch counts, (c)'s)."""
    phase("24 serve-mesh (decode_attention's lse; make_prefill + "
          "make_serve_step on a (1, 1) NCCL mesh against the plain steps; "
          "two gloo ranks on the card, the KV sequence split)")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(24)
    rec = _lse_checks(dev, gen, card)
    _free(dev)
    counts = _mesh_one_by_one(dev, card)
    _free(dev)
    gloo = _mesh_gloo(dev, card)
    _free(dev)
    print(f"  phase 24: {time.perf_counter() - t0:.1f} s", flush=True)
    return rec, counts, gloo


# ---------------------------------------------------------------------------
# 25. moe-mesh: expert parallelism, the MoE stacks on a mesh
# ---------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"
MOE_TRAIN_LAYERS = 6               # phase 22's cut: 80 GB at 18 B a param
MOE_GLOO_SERVE_LAYERS = 4
MOE_GLOO_TRAIN_LAYERS = 2
MOE_GLOO_RANKS = 2
MOE_LOSS_TOL = 1e-5                # (c) loss and aux, relative
MOE_GRAD_TOL = 1e-4                # (c) grad norm and gradients, relative
MOE_DIR = ROOT / "build" / "moe_mesh"


def _moe_cfg(n_layers, first, last, dtype=None):
    """olmoe-1b-7b at full width, ``n_layers`` deep, SOI pp over
    ``[first, last)``."""
    from repro_torch import configs
    from repro_torch.configs.base import SOILMCfg
    cfg = dataclasses.replace(
        configs.get(MOE_ARCH, soi="pp", n_layers=n_layers),
        soi=SOILMCfg(first_layer=first, last_layer=last, mode="pp"))
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def _mesh_train_one_by_one(dev, card, cfg, tag, label,
                           peak_gap=None, flags=None, stubs=None) -> dict:
    """Phase 25 (b), phase 26 (c), phase 27 (a) (``flags`` fsdp and
    seq_shard), phase 28 (a) (``stubs(i)``: batch i's stub frontends):
    ``cfg`` (bf16 over f32 masters, B 8 S 128), DIST_STEPS
    plain steps, then as many sharded on the (1, 1) mesh
    (``ShardingRules(**flags)``) from the same weights and batches (one
    model on the card at a time); metrics equal, params and moments equal
    by digest; with ``peak_gap`` (GiB) the first sharded step's peak
    within it of the plain one's. Returns the sharded run's launch
    counts."""
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.distributed.sharding import (ShardingRules,
                                                  gather_params, gather_tree,
                                                  shard_params)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import local_batch, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    t0 = time.perf_counter()
    pipe = ShardedLMPipeline(global_batch=8, seq_len=128, vocab=cfg.vocab,
                             seed=0)
    batches = [dict(_train_batch(pipe, i, dev), **(stubs(i) if stubs else
                                                   {}))
               for i in range(DIST_STEPS + 1)]
    kw = dict(peak_lr=1e-3, warmup=20, total_steps=TRAIN_STEPS)
    mesh = make_mesh((1, 1), ("data", "model"))
    rules = ShardingRules(data_axes=("data",), **(flags or {}))
    runs = {}
    for run in ("plain", "sharded"):
        _free(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        model = T.init(cfg, generator=torch.Generator(device=dev)
                       .manual_seed(0), device=dev)
        n_params = sum(p.numel() for p in model.parameters())
        built = torch.cuda.memory_allocated(dev)
        if run == "sharded":
            model = shard_params(model, rules, mesh)
            step = make_train_step(cfg, rules, mesh, **kw)

            def prep(bt):
                return local_batch(bt, mesh)
        else:
            step = make_train_step(cfg, **kw)

            def prep(bt):
                return bt
        # what stays allocated after shard_params: the weights, not a
        # copy of them beside
        held = torch.cuda.memory_allocated(dev) - built
        opt = adamw_init(dict(model.named_parameters()))
        setup_peak = torch.cuda.max_memory_allocated(dev)
        ops.reset_launch_counts()
        metrics, times, peaks, starts = [], [], [], []
        for bt in batches[:DIST_STEPS]:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            starts.append(torch.cuda.memory_allocated(dev) / 2 ** 30)
            t1 = time.perf_counter()
            # the metrics only: a name bound to the returned opt_state
            # would keep this run's moments alive into the next run
            m = step(model, opt, prep(bt))[2]
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t1) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            metrics.append(tuple(float(m[k]) for k in ("loss", "aux",
                                                       "grad_norm")))
        counts = ops.launch_counts()
        sharded = run == "sharded"
        digests = {"params": _digests(gather_params(model) if sharded
                                      else dict(model.named_parameters()))}
        for t in ("mu", "nu"):
            digests[t] = _digests(gather_tree(opt[t]) if sharded
                                  else opt[t])
        coll = _mesh_collectives(lambda: step(model, opt, prep(
            batches[DIST_STEPS])))
        runs[run] = dict(metrics=metrics, digests=digests, counts=counts,
                         ms=sorted(times)[len(times) // 2], peaks=peaks,
                         setup_peak=setup_peak / 2 ** 30, coll=coll,
                         held=held / 2 ** 30, starts=starts)
        del model, opt, step
    _free(dev)
    p, s_ = runs["plain"], runs["sharded"]
    check(s_["metrics"] == p["metrics"],
          f"{tag} sharded (loss, aux, grad norm) {s_['metrics']} != plain "
          f"{p['metrics']}")
    moe = any(b.moe is not None for b in T.layer_blocks(cfg))
    check(all((m[1] > 0) == moe for m in s_["metrics"]),
          f"{tag} the sharded aux {s_['metrics']} (MoE: {moe})")
    for t in p["digests"]:
        bad = [k for k in p["digests"][t]
               if s_["digests"][t].get(k) != p["digests"][t][k]]
        check(not bad and set(s_["digests"][t]) == set(p["digests"][t]),
              f"{tag} sharded {t} differ from the plain step's: {bad[:5]}")
    counts = s_["counts"]
    m = _mesh_launches(cfg, 0)
    want = _train_want(cfg, m["flash_attention"], m["lru_scan"],
                       times=DIST_STEPS)
    for name, n in want.items():
        check(counts[name] == n, f"{tag} sharded step: {name} "
                                 f"{counts[name]} launches, want {n}")
    if peak_gap is not None:
        check(s_["peaks"][0] - p["peaks"][0] <= peak_gap,
              f"{tag} the first sharded step peaks at {s_['peaks'][0]:.2f} "
              f"GiB, the plain at {p['peaks'][0]:.2f}")
    print(f"  {tag} {label} ({n_params / 1e9:.3f} B params), SOI "
          f"{cfg.soi.mode if cfg.soi else 'none'}, bf16 over f32 masters, "
          f"B 8 S 128, {DIST_STEPS} steps: sharded on the (1, 1) NCCL mesh "
          f"(rules {rules}) == plain bit for bit — (loss, aux, grad norm) "
          f"{s_['metrics']}; "
          f"{len(p['digests']['params'])} params, mu, nu leaves equal by "
          f"digest; launches { {k: v for k, v in want.items() if v} }",
          flush=True)
    print(f"  {tag} step median (host clock after a synchronize, "
          f"{DIST_STEPS} steps): plain {p['ms']:.2f} ms, sharded "
          f"{s_['ms']:.2f} ms; peak GiB of each step plain "
          f"{[round(x, 2) for x in p['peaks']]}, sharded "
          f"{[round(x, 2) for x in s_['peaks']]}, allocated at each "
          f"step's start {[round(x, 2) for x in p['starts']]} / "
          f"{[round(x, 2) for x in s_['starts']]} (of the set-up: init, "
          f"shard_params, adamw_init: {p['setup_peak']:.2f} / "
          f"{s_['setup_peak']:.2f}; GiB shard_params leaves allocated "
          f"beyond the built model: {s_['held']:.3f}); collectives a step: "
          f"plain {p['coll'] or 'none'}, sharded {s_['coll']}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return counts


def _moe_gloo_serve_inputs(dev):
    """(f32 olmoe cut to MOE_GLOO_SERVE_LAYERS, prompt) from the seed, the
    same in every process."""
    from repro_torch.models import transformer as T
    cfg = _moe_cfg(MOE_GLOO_SERVE_LAYERS, 1, MOE_GLOO_SERVE_LAYERS - 1,
                   "float32")
    gen = torch.Generator(device=dev).manual_seed(25)
    model = T.init(cfg, generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab, (4, 1024), generator=gen,
                           device=dev, dtype=torch.int32)
    return cfg, model, prompt


def _moe_param_bytes(model, cfg, rules, mesh) -> tuple:
    """(this rank's bytes of the local shards, the specs' per-device
    bytes: the dry run's ``params`` count)."""
    from repro_torch.distributed.sharding import per_device_bytes
    from repro_torch.launch import specs as S
    got = sum(p.to_local().numel() * p.to_local().element_size()
              for p in model.parameters())
    shapes, specs = S.param_specs(cfg, rules, mesh)
    return got, per_device_bytes(shapes, specs, mesh)


def _moe_rank(rank, world):
    """(c) one of two gloo ranks sharing the card, a (1, 2) mesh: the
    serving cut from the seed through the sharded prefill + steps; then the
    training cut's sharded step, and the plain step from the same weights
    in this process, compared here (AdamW's first moment after one step is
    0.1 x the clipped gradient; the rank's shard of each leaf against the
    plain one's slice). Writes the results."""
    import os
    import pickle
    import torch.distributed as dist
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.distributed.sharding import ShardingRules, shard_params
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (local_batch, make_prefill,
                                          make_serve_step, make_train_step)
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from torch.distributed.tensor import Shard
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    store = dist.FileStore(str(MOE_DIR / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((1, world), ("data", "model"))
        rules = ShardingRules(data_axes=("data",))
        out = {}
        cfg, model, prompt = _moe_gloo_serve_inputs(dev)
        model = shard_params(model, rules, mesh)
        out["serve_bytes"] = _moe_param_bytes(model, cfg, rules, mesh)
        out["experts"] = (model.blocks[0].moe.up.to_local().shape[0],
                          cfg.segments[0].blocks[0].moe.n_experts)
        prefill = make_prefill(cfg, rules, mesh, max_len=MESH_MAX_LEN)
        step = make_serve_step(cfg, rules, mesh, max_len=MESH_MAX_LEN)
        ops.reset_launch_counts()
        logits, toks, _state, ms = _mesh_run(prefill, step, model, prompt,
                                             MESH_GLOO_STEPS, dev)
        out["serve_counts"] = ops.launch_counts()
        _, st = _mesh_state(prefill, model, prompt)
        out["serve_coll"] = _mesh_collectives(lambda: step(model, st,
                                                           toks[0]))
        out.update(logits=[x.cpu() for x in logits],
                   tokens=[x.cpu() for x in toks], serve_ms=ms)
        del model, st, _state, prefill, step
        _free(dev)

        cfg = _moe_cfg(MOE_GLOO_TRAIN_LAYERS, 1, MOE_GLOO_TRAIN_LAYERS,
                       "float32")
        pipe = ShardedLMPipeline(global_batch=8, seq_len=128,
                                 vocab=cfg.vocab, seed=0)
        batch = _train_batch(pipe, 0, dev)
        kw = dict(peak_lr=1e-3, warmup=20, total_steps=TRAIN_STEPS)

        def init():
            return T.init(cfg, generator=torch.Generator(device=dev)
                          .manual_seed(26), device=dev)
        model = shard_params(init(), rules, mesh)
        out["train_bytes"] = _moe_param_bytes(model, cfg, rules, mesh)
        opt = adamw_init(dict(model.named_parameters()))
        step = make_train_step(cfg, rules, mesh, **kw)
        ops.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sm = step(model, opt, local_batch(batch, mesh))[2]
        torch.cuda.synchronize(dev)
        out["train_ms"] = (time.perf_counter() - t0) * 1e3
        out["train_counts"] = ops.launch_counts()
        # each leaf's shard and the dimension it splits (None: whole)
        shards = {}
        for k, p in model.named_parameters():
            dims = [pl.dim for pl in p.placements if isinstance(pl, Shard)]
            shards[k] = (dims[0] if dims else None,
                         opt["mu"][k].to_local().clone())
        out["train_coll"] = _mesh_collectives(lambda: step(
            model, opt, local_batch(batch, mesh)))
        del model, opt, step
        _free(dev)
        plain = init()
        popt = adamw_init(dict(plain.named_parameters()))
        pm = make_train_step(cfg, **kw)(plain, popt, batch)[2]
        worst, worst_at = 0.0, None
        for k, (d, mine) in shards.items():
            want = popt["mu"][k]
            if d is not None:
                want = want.chunk(world, dim=d)[rank]
            rel = float((mine - want).abs().max()
                        / want.abs().max().clamp_min(1e-30))
            if rel >= worst:
                worst, worst_at = rel, k
        out.update(train_metrics={k: float(sm[k]) for k in sm},
                   plain_metrics={k: float(pm[k]) for k in pm},
                   grad_rel=worst, grad_rel_at=worst_at,
                   n_leaves=len(shards))
        del plain, popt, shards
        with open(MOE_DIR / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _moe_gloo(dev, card) -> None:
    """(c): the one-rank f32 serving steps here, then two gloo ranks on the
    card (``_moe_rank``): tokens equal, logits within MESH_GLOO_TOL, each
    read and prefill on its kernel; the ranks' train step against their
    plain step; bytes."""
    import pickle
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.launch.steps import make_prefill, make_serve_step
    t0 = time.perf_counter()
    cfg, model, prompt = _moe_gloo_serve_inputs(dev)
    want, w_toks, _state, w_ms = _mesh_run(
        make_prefill(cfg, max_len=MESH_MAX_LEN), make_serve_step(cfg),
        model, prompt, MESH_GLOO_STEPS, dev)
    del model, _state
    _free(dev)
    shutil.rmtree(MOE_DIR, ignore_errors=True)
    MOE_DIR.mkdir(parents=True)
    t1 = time.perf_counter()
    mp.spawn(_moe_rank, args=(MOE_GLOO_RANKS,), nprocs=MOE_GLOO_RANKS,
             join=True)
    spawn_s = time.perf_counter() - t1
    ranks = []
    for r in range(MOE_GLOO_RANKS):
        with open(MOE_DIR / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    shutil.rmtree(MOE_DIR, ignore_errors=True)
    err = 0.0
    for r, rk in enumerate(ranks):
        mine, total = rk["experts"]
        check(mine * MOE_GLOO_RANKS == total,
              f"(c) rank {r} holds {mine} of {total} experts")
        check(all(torch.equal(a, b.cpu()) for a, b in zip(rk["tokens"],
                                                          w_toks)),
              f"(c) rank {r}: the 2-rank tokens differ from the one-rank "
              f"steps'")
        err = max([err] + [float((a - b.cpu()).abs().max())
                           for a, b in zip(rk["logits"], want)])
        for what in ("serve_bytes", "train_bytes"):
            got, spec = rk[what]
            check(got == spec, f"(c) rank {r} {what} {got} != the specs' "
                               f"{spec}")
        sm, pm = rk["train_metrics"], rk["plain_metrics"]
        for k, tol in (("loss", MOE_LOSS_TOL), ("aux", MOE_LOSS_TOL),
                       ("grad_norm", MOE_GRAD_TOL)):
            check(abs(sm[k] - pm[k]) <= tol * abs(pm[k]),
                  f"(c) rank {r} {k} {sm[k]} vs one rank {pm[k]}")
        check(sm["aux"] > 0, f"(c) rank {r}: aux 0")
        check(rk["grad_rel"] <= MOE_GRAD_TOL,
              f"(c) rank {r} gradient {rk['grad_rel_at']}: rel "
              f"{rk['grad_rel']}")
    check(err < MESH_GLOO_TOL, f"(c) logits {err} from the one-rank steps")
    n_dec = cfg.n_layers * MESH_GLOO_STEPS
    for r, rk in enumerate(ranks):
        c = rk["serve_counts"]
        check(c["decode_attention"] == n_dec and
              c["flash_attention"] == cfg.n_layers,
              f"(c) rank {r}: serving launches {c}")
        c = rk["train_counts"]
        want = _train_want(cfg, MOE_GLOO_TRAIN_LAYERS)
        check(all(c[k] == want[k] for k in ("flash_attention",
                                            "flash_attention_bwd")),
              f"(c) rank {r}: training launches {c}, want {want}")

    def med(x):
        return sorted(x)[len(x) // 2]
    r0 = ranks[0]
    print(f"  (c) two gloo ranks on the one card, (1, 2) mesh, "
          f"{r0['experts'][0]} of {r0['experts'][1]} experts each: "
          f"{MOE_ARCH} cut to {cfg.n_layers} layers (SOI pp "
          f"1..{cfg.n_layers - 1}), f32, B 4 x 1024, {MESH_GLOO_STEPS} "
          f"steps: tokens == the one-rank steps, logits max|Δ| {err:.2e} "
          f"(< {MESH_GLOO_TOL}); launches "
          f"{ {k: v for k, v in r0['serve_counts'].items() if v} }; ms a step "
          f"(median, host clock): one rank {med(w_ms):.3f}, the two ranks "
          f"{[round(med(rk['serve_ms']), 3) for rk in ranks]}; collectives "
          f"a step {r0['serve_coll']} [{card}]", flush=True)
    print(f"  (c) one train step, cut to {MOE_GLOO_TRAIN_LAYERS} layers (SOI "
          f"pp 1..1), f32, B 8 S 128, against the plain step in each rank: "
          + "; ".join(
              f"rank {r} loss {rk['train_metrics']['loss']:.6f} vs "
              f"{rk['plain_metrics']['loss']:.6f}, aux "
              f"{rk['train_metrics']['aux']:.6f} vs "
              f"{rk['plain_metrics']['aux']:.6f}, grad norm "
              f"{rk['train_metrics']['grad_norm']:.6f} vs "
              f"{rk['plain_metrics']['grad_norm']:.6f}, worst gradient rel "
              f"{rk['grad_rel']:.2e} ({rk['grad_rel_at']}, "
              f"{rk['n_leaves']} leaves)" for r, rk in enumerate(ranks))
          + f"; launches "
          f"{ {k: v for k, v in r0['train_counts'].items() if v} }; step ms "
          f"{[round(rk['train_ms'], 1) for rk in ranks]} (the first, host "
          f"clock); collectives a step {r0['train_coll']} [{card}]",
          flush=True)
    print(f"  (c) parameter bytes a rank (== the specs' per-device count): "
          f"serving {[rk['serve_bytes'][0] for rk in ranks]}, training "
          f"{[rk['train_bytes'][0] for rk in ranks]}; spawn + run "
          f"{spawn_s:.1f} s, (c) {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)


def moe_mesh_phase(dev, card) -> dict:
    """Phase 25. Returns the launch counts of the sharded olmoe runs on
    the (1, 1) NCCL mesh: (a)'s serve, (b)'s training."""
    import torch.distributed as dist
    phase("25 moe-mesh (expert parallelism: olmoe-1b-7b's sharded prefill + "
          "serve steps and train step on a (1, 1) NCCL mesh against the "
          "plain steps; two gloo ranks on the card, 32 experts each)")
    t0 = time.perf_counter()
    serve_counts = _mesh_one_by_one(dev, card, _family_argv(MOE_ARCH), "(a)")
    _free(dev)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        train_counts = _mesh_train_one_by_one(
            dev, card, _moe_cfg(MOE_TRAIN_LAYERS, MOE_TRAIN_LAYERS // 4,
                                MOE_TRAIN_LAYERS - MOE_TRAIN_LAYERS // 4),
            "(b)", f"{MOE_ARCH} cut to {MOE_TRAIN_LAYERS} of 16 layers "
                   f"(phase 22's cut)")
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived (b)")
    _free(dev)
    _moe_gloo(dev, card)
    _free(dev)
    print(f"  phase 25: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"decode_attention": serve_counts["decode_attention"],
            "flash_attention": serve_counts["flash_attention"],
            "flash_attention_bwd": train_counts["flash_attention_bwd"]}


# ---------------------------------------------------------------------------
# 26. mla-rglru-mesh: the MLA and RG-LRU stacks on a mesh
# ---------------------------------------------------------------------------

# the serving driver's deepseek-v2 cut of phase 8 (4 layers), dense rings
DS_MESH_ARGV = DS_SERVE_ARGV[:DS_SERVE_ARGV.index("--paged")]
MLA_PEAK_GAP = 2.0                 # (c) GiB, first sharded step vs plain
MLA_LOSS_TOL = 1e-6                # (d) loss, relative
# (d) grad norm and gradients, relative to each leaf's largest: at
# recurrentgemma's random-init logits (loss 40.8, capped at 30) a rounding
# step in the hidden state moves the softmax by ~1e-5 of itself, and the
# split model axis sums its partial products in another order (measured
# 1.13e-5 at its embedding, deepseek-v2 3.5e-6)
MLA_GRAD_TOL = 2e-5
MLA_DIR = ROOT / "build" / "mla_rglru_mesh"


def _mla_train_cfgs():
    """(c)'s training cuts, phase 22's: deepseek-v2's MLA stack at 4 layers
    with dense MLPs (its MoE layers do not fit one card), recurrentgemma-9b
    at 6 of 38 layers; SOI pp."""
    from repro_torch import configs
    from repro_torch.configs import deepseek_v2_236b as D
    return (
        (D.mla_dense_config(soi="pp", n_layers=4),
         "deepseek-v2's MLA stack, 4 layers of its layer-0 block (MLA + "
         "SwiGLU 12288; phase 22's cut)"),
        (configs.get("recurrentgemma-9b", soi="pp", n_layers=6),
         "recurrentgemma-9b cut to 6 of 38 layers (phase 22's cut)"))


def _mla_gloo_cfgs():
    """(d)'s f32 configs: (label, serving cut, training cut). deepseek-v2
    serves at 2 layers (the dense one and one MoE layer, SOI pp over the
    second) and trains its dense first layer alone; recurrentgemma-9b
    serves and trains one (RG-LRU, RG-LRU, local attention) pattern."""
    from repro_torch import configs
    from repro_torch.configs import deepseek_v2_236b as D

    def f32(cfg):
        return dataclasses.replace(cfg, dtype="float32")
    rg = f32(configs.get("recurrentgemma-9b", n_layers=3))
    return (("deepseek-v2", f32(D.config(soi="pp", n_layers=2)),
             f32(D.mla_dense_config(n_layers=1))),
            ("recurrentgemma-9b", rg, rg))


def _mla_serve_inputs(cfg, dev):
    """(f32 weights, prompt) from the seed, the same in every process."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev).manual_seed(26)
    model = T.init(cfg, generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab, (4, 1024), generator=gen,
                           device=dev, dtype=torch.int32)
    return model, prompt


def _mla_split(model, label) -> dict:
    """{what: (this rank's count, the whole count)} of a sharded model."""
    if label == "deepseek-v2":
        b = model.blocks
        return {"heads": (b[0].attn.wuq.to_local().shape[1],
                          b[0].attn.wuq.shape[1]),
                "experts": (b[1].moe.up.to_local().shape[0],
                            b[1].moe.up.shape[0])}
    rec, att = model.blocks[0].rglru, model.blocks[2].attn
    return {"heads": (att.wq.to_local().shape[1], att.wq.shape[1]),
            "kv heads": (att.wk.to_local().shape[1], att.wk.shape[1]),
            "LRU channels": (rec.lam.to_local().shape[0], rec.lam.shape[0])}


def _mla_rank(rank, world):
    """(d) one of two gloo ranks sharing the card, a (1, 2) mesh: for each
    config of ``_mla_gloo_cfgs`` the serving cut from the seed through the
    sharded prefill + steps, then the training cut's sharded step and the
    plain step from the same weights in this process, compared here (the
    rank's shard of AdamW's first moment after one step, 0.1 x the clipped
    gradient, against the plain one's slice). The ranks meet at a barrier
    between parts and take the plain step one at a time, so one full
    model's training state is on the card at a time. Writes the
    results."""
    import os
    import pickle
    import torch.distributed as dist
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.distributed.sharding import ShardingRules, shard_params
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (local_batch, make_prefill,
                                          make_serve_step, make_train_step)
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from torch.distributed.tensor import Shard
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    store = dist.FileStore(str(MLA_DIR / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((1, world), ("data", "model"))
        rules = ShardingRules(data_axes=("data",))
        kw = dict(peak_lr=1e-3, warmup=20, total_steps=TRAIN_STEPS)
        out = {}
        for label, scfg, tcfg in _mla_gloo_cfgs():
            r = out[label] = {}
            model, prompt = _mla_serve_inputs(scfg, dev)
            model = shard_params(model, rules, mesh)
            r["split"] = _mla_split(model, label)
            r["serve_bytes"] = _moe_param_bytes(model, scfg, rules, mesh)
            prefill = make_prefill(scfg, rules, mesh, max_len=MESH_MAX_LEN)
            step = make_serve_step(scfg, rules, mesh, max_len=MESH_MAX_LEN)
            ops.reset_launch_counts()
            logits, toks, st, ms = _mesh_run(prefill, step, model, prompt,
                                             MESH_GLOO_STEPS, dev)
            r["serve_counts"] = ops.launch_counts()
            r["serve_coll"] = _mesh_collectives(lambda: step(model, st,
                                                             toks[-1]))
            r.update(logits=[x.cpu() for x in logits],
                     tokens=[x.cpu() for x in toks], serve_ms=ms)
            del model, st, prefill, step, logits
            _free(dev)
            dist.barrier()

            pipe = ShardedLMPipeline(global_batch=8, seq_len=128,
                                     vocab=tcfg.vocab, seed=0)
            batch = _train_batch(pipe, 0, dev)

            def init():
                return T.init(tcfg, generator=torch.Generator(device=dev)
                              .manual_seed(27), device=dev)
            model = shard_params(init(), rules, mesh)
            r["train_bytes"] = _moe_param_bytes(model, tcfg, rules, mesh)
            opt = adamw_init(dict(model.named_parameters()))
            step = make_train_step(tcfg, rules, mesh, **kw)
            ops.reset_launch_counts()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            sm = step(model, opt, local_batch(batch, mesh))[2]
            torch.cuda.synchronize(dev)
            r["train_ms"] = (time.perf_counter() - t0) * 1e3
            r["train_counts"] = ops.launch_counts()
            shards = {}
            for k, p in model.named_parameters():
                dims = [pl.dim for pl in p.placements
                        if isinstance(pl, Shard)]
                shards[k] = (dims[0] if dims else None,
                             opt["mu"][k].to_local().clone())
            r["train_coll"] = _mesh_collectives(lambda: step(
                model, opt, local_batch(batch, mesh)))
            del model, opt, step
            _free(dev)
            # the plain step one rank at a time: two f32 states and their
            # gradients do not fit the card beside each other
            for turn in range(world):
                dist.barrier()
                if turn != rank:
                    continue
                plain = init()
                popt = adamw_init(dict(plain.named_parameters()))
                pm = make_train_step(tcfg, **kw)(plain, popt, batch)[2]
                rels = []
                for k, (d, mine) in shards.items():
                    want = popt["mu"][k]
                    if d is not None:
                        want = want.chunk(world, dim=d)[rank]
                    rels.append((float((mine - want).abs().max()
                                       / want.abs().max().clamp_min(1e-30)),
                                 k))
                rels.sort(reverse=True)
                r.update(train_metrics={k: float(sm[k]) for k in sm},
                         plain_metrics={k: float(pm[k]) for k in pm},
                         grad_rel=rels[0][0], grad_rel_at=rels[0][1],
                         grad_top=rels[:5], n_leaves=len(shards))
                del plain, popt, shards
                _free(dev)
            dist.barrier()
        with open(MLA_DIR / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _mla_gloo(dev, card) -> dict:
    """(d): each serving cut's one-rank f32 steps here, then two gloo ranks
    on the card (``_mla_rank``): tokens equal, logits within
    MESH_GLOO_TOL, each read, scan and prefill on its kernel; the ranks'
    train steps against their plain steps; bytes. Returns the ranks'
    summed launch counts of each config's serving and training."""
    import pickle
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.launch.steps import make_prefill, make_serve_step
    t0 = time.perf_counter()
    want = {}
    for label, scfg, _ in _mla_gloo_cfgs():
        model, prompt = _mla_serve_inputs(scfg, dev)
        n_params = sum(p.numel() for p in model.parameters())
        logits, toks, st, ms = _mesh_run(
            make_prefill(scfg, max_len=MESH_MAX_LEN), make_serve_step(scfg),
            model, prompt, MESH_GLOO_STEPS, dev)
        want[label] = (logits, toks, ms, n_params)
        del model, st
        _free(dev)
    shutil.rmtree(MLA_DIR, ignore_errors=True)
    MLA_DIR.mkdir(parents=True)
    t1 = time.perf_counter()
    mp.spawn(_mla_rank, args=(2,), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t1
    ranks = []
    for r in range(2):
        with open(MLA_DIR / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    shutil.rmtree(MLA_DIR, ignore_errors=True)

    def med(x):
        return sorted(x)[len(x) // 2]
    totals = {}
    for label, scfg, tcfg in _mla_gloo_cfgs():
        w_logits, w_toks, w_ms, n_params = want[label]
        err = 0.0
        for r, rk in enumerate(ranks):
            g = rk[label]
            for what, (mine, whole) in g["split"].items():
                check(mine * 2 == whole or (what == "kv heads" and
                                            mine == whole == 1),
                      f"(d) {label} rank {r} holds {mine} of {whole} {what}")
            check(all(torch.equal(a, b.cpu()) for a, b in zip(g["tokens"],
                                                              w_toks)),
                  f"(d) {label} rank {r}: the 2-rank tokens differ from the "
                  f"one-rank steps'")
            err = max([err] + [float((a - b.cpu()).abs().max())
                               for a, b in zip(g["logits"], w_logits)])
            for what in ("serve_bytes", "train_bytes"):
                got, spec = g[what]
                check(got == spec, f"(d) {label} rank {r} {what} {got} != "
                                   f"the specs' {spec}")
            sm, pm = g["train_metrics"], g["plain_metrics"]
            for k, tol in (("loss", MLA_LOSS_TOL),
                           ("grad_norm", MLA_GRAD_TOL)):
                check(abs(sm[k] - pm[k]) <= tol * abs(pm[k]),
                      f"(d) {label} rank {r} {k} {sm[k]} vs one rank "
                      f"{pm[k]}")
            check(g["grad_rel"] <= MLA_GRAD_TOL,
                  f"(d) {label} rank {r} gradient {g['grad_rel_at']}: rel "
                  f"{g['grad_rel']}")
            want_s = _mesh_launches(scfg, MESH_GLOO_STEPS)
            check(all(g["serve_counts"][k] == n for k, n in want_s.items()),
                  f"(d) {label} rank {r}: serving launches "
                  f"{g['serve_counts']}, want {want_s}")
            m = _mesh_launches(tcfg, 0)
            want_t = _train_want(tcfg, m["flash_attention"], m["lru_scan"])
            check(all(g["train_counts"][k] == n for k, n in want_t.items()),
                  f"(d) {label} rank {r}: training launches "
                  f"{g['train_counts']}, want {want_t}")
        check(err < MESH_GLOO_TOL,
              f"(d) {label} logits {err} from the one-rank steps")
        for part in ("serve_counts", "train_counts"):
            for k, v in ranks[0][label][part].items():
                totals[k] = totals.get(k, 0) + sum(rk[label][part][k]
                                                   for rk in ranks)
        g0 = ranks[0][label]
        print(f"  (d) {label}, two gloo ranks on the one card, (1, 2) mesh, "
              f"each holding {g0['split']}: serving {scfg.n_layers} layers "
              f"(SOI {scfg.soi.mode if scfg.soi else 'none'}, "
              f"{n_params / 1e9:.3f} B params) f32, B 4 x 1024, "
              f"{MESH_GLOO_STEPS} steps: tokens == the one-rank steps, "
              f"logits max|Δ| {err:.2e} (< {MESH_GLOO_TOL}); launches a rank "
              f"{ {k: v for k, v in g0['serve_counts'].items() if v} }; ms a "
              f"step (median, host clock): one rank {med(w_ms):.3f}, the two "
              f"ranks {[round(med(rk[label]['serve_ms']), 3) for rk in ranks]}"
              f"; collectives a step {g0['serve_coll']} [{card}]", flush=True)
        print(f"  (d) {label}, one train step of {tcfg.n_layers} layer(s) "
              f"f32, B 8 S 128, against the plain step in each rank: "
              + "; ".join(
                  f"rank {r} loss {rk[label]['train_metrics']['loss']:.7f} "
                  f"vs {rk[label]['plain_metrics']['loss']:.7f}, grad norm "
                  f"{rk[label]['train_metrics']['grad_norm']:.6f} vs "
                  f"{rk[label]['plain_metrics']['grad_norm']:.6f}, worst "
                  f"gradient rel {rk[label]['grad_rel']:.2e} "
                  f"({rk[label]['grad_rel_at']}, {rk[label]['n_leaves']} "
                  f"leaves; top 5 "
                  f"{[(f'{x:.2e}', k) for x, k in rk[label]['grad_top']]})"
                  for r, rk in enumerate(ranks))
              + f"; launches a rank "
              f"{ {k: v for k, v in g0['train_counts'].items() if v} }; step "
              f"ms {[round(rk[label]['train_ms'], 1) for rk in ranks]} (the "
              f"first, host clock); collectives a step {g0['train_coll']}; "
              f"parameter bytes a rank (== the specs'): serving "
              f"{[rk[label]['serve_bytes'][0] for rk in ranks]}, training "
              f"{[rk[label]['train_bytes'][0] for rk in ranks]} [{card}]",
              flush=True)
    print(f"  (d) spawn + run {spawn_s:.1f} s, (d) "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return totals


def mla_rglru_mesh_phase(dev, card) -> dict:
    """Phase 26. Returns the launch counts of the sharded runs on the (1,
    1) NCCL mesh: (a)'s and (b)'s serving, (c)'s training, and (d)'s two
    gloo ranks summed, by part."""
    import torch.distributed as dist
    phase("26 mla-rglru-mesh (deepseek-v2's MLA + MoE and recurrentgemma-9b's "
          "RG-LRU + MQA through the sharded serve and train steps on a (1, 1) "
          "NCCL mesh against the plain steps; two gloo ranks on the card, "
          "heads, latent up-projections and LRU channels split)")
    t0 = time.perf_counter()
    out = {"ds serve": _mesh_one_by_one(dev, card, DS_MESH_ARGV, "(a)")}
    _free(dev)
    out["rg serve"] = _mesh_one_by_one(
        dev, card, _family_argv("recurrentgemma-9b"), "(b)")
    _free(dev)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        for (cfg, label), key in zip(_mla_train_cfgs(),
                                     ("ds train", "rg train")):
            out[key] = _mesh_train_one_by_one(dev, card, cfg, "(c)", label,
                                              peak_gap=MLA_PEAK_GAP)
            _free(dev)
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived (c)")
    out["gloo"] = _mla_gloo(dev, card)
    _free(dev)
    print(f"  phase 26: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# 27. fsdp-sp-mesh: fsdp and sequence parallelism in the sharded steps
# ---------------------------------------------------------------------------

FSDP_SP = dict(fsdp=True, seq_shard=True)
FSDP_SP_SERVE_STEPS = 8            # (a) serve steps after the prefill
# phase 29 (d): qwen3-1.7b cut to 8 of 28 layers at full width: each
# fsdp step moves the whole f32 model through gloo's host staging twice
# (the gathers and the gradient's all-reduce)
FSDP_QWEN_LAYERS = 8
FSDP_RG_LAYERS = 3                 # (c) recurrentgemma-9b, phase 26 (d)'s
# 29 (d): the data ranks' halves of the batch against the whole batch in
# one process: the NLL, the counts and every gradient summed in another
# order
FSDP_LOSS_TOL = 1e-5               # loss, relative
FSDP_GRAD_TOL = 1e-4               # grad norm, relative
FSDP_DIR = ROOT / "build" / "fsdp_sp_mesh"


def _collective_ms(step) -> dict:
    """{collective: [calls, host ms]} of one call of ``step``, from the
    host's records of the backend's calls (a gloo call on CUDA tensors
    returns once its host-staged copies are done)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
        torch.cuda.synchronize()
    out = {}
    for s, e, name, _w in _records(prof):
        if name.startswith(("nccl:", "gloo:")):
            n, ms = out.get(name, (0, 0.0))
            out[name] = (n + 1, round(ms + (e - s) / 1e3, 3))
    return out


def _fsdp_sp_cfgs():
    """Phase 29 (d)'s qwen3-1.7b (SOI pp, FSDP_QWEN_LAYERS) and (c)'s
    recurrentgemma-9b (FSDP_RG_LAYERS: RG-LRU, RG-LRU, local attention),
    both at full width in f32."""
    from repro_torch import configs

    def f32(cfg):
        return dataclasses.replace(cfg, dtype="float32")
    return (f32(configs.get("qwen3-1.7b", soi="pp",
                            n_layers=FSDP_QWEN_LAYERS)),
            f32(configs.get("recurrentgemma-9b", n_layers=FSDP_RG_LAYERS)))


def _fsdp_sp_step(cfg, seed, dev, rules=None, mesh=None) -> dict:
    """One train step of ``cfg`` from the seed's weights (sharded by
    ``rules`` on ``mesh`` where given, on this rank's ``local_batch``):
    loss, grad norm, host ms, the step's peak GiB, and on a mesh the
    parameter bytes a rank beside the specs' and the moments' bytes, the
    step's launch counts and the collectives of a second step."""
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import local_batch, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    kw = dict(peak_lr=1e-3, warmup=20, total_steps=TRAIN_STEPS)
    batch = _train_batch(ShardedLMPipeline(global_batch=8, seq_len=128,
                                           vocab=cfg.vocab, seed=0), 0, dev)
    model = T.init(cfg, generator=torch.Generator(device=dev)
                   .manual_seed(seed), device=dev)
    out = {"n_params": sum(p.numel() for p in model.parameters())}
    if mesh is not None:
        model = shard_params(model, rules, mesh)
        out["bytes"] = _moe_param_bytes(model, cfg, rules, mesh)
        batch = local_batch(batch, mesh)
    opt = adamw_init(dict(model.named_parameters()))
    if mesh is not None:
        out["moment_bytes"] = sum(
            v.to_local().numel() * 4 for t in ("mu", "nu")
            for v in opt[t].values())
    step = make_train_step(cfg, rules, mesh, **kw)
    _free(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out["start_gib"] = torch.cuda.memory_allocated(dev) / 2 ** 30
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m = step(model, opt, batch)[2]
    torch.cuda.synchronize(dev)
    out.update(ms=(time.perf_counter() - t0) * 1e3,
               counts=ops.launch_counts(),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    if mesh is not None:
        out["coll"] = _collective_ms(lambda: step(model, opt, batch))
    del model, opt, step
    _free(dev)
    return out


def _fsdp_sp_rank(rank, world):
    """(c), one of two gloo ranks sharing the card: recurrentgemma-9b's
    prefill, two decode steps and one train step on a (1, 2) mesh with
    seq_shard, the reduce-scatters counted. Writes the results. (b), the
    (2, 1) fsdp step of qwen3-1.7b, runs in phase 29 (d), with remat on
    and off."""
    import os
    import pickle
    import torch.distributed as dist
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import ShardingRules, shard_params
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_prefill, make_serve_step
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    store = dist.FileStore(str(FSDP_DIR / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        _, rcfg = _fsdp_sp_cfgs()
        out = {}
        mesh = make_mesh((1, world), ("data", "model"))
        rules = ShardingRules(data_axes=("data",), seq_shard=True)
        model, prompt = _mla_serve_inputs(rcfg, dev)
        model = shard_params(model, rules, mesh)
        prefill = make_prefill(rcfg, rules, mesh, max_len=MESH_MAX_LEN)
        step = make_serve_step(rcfg, rules, mesh, max_len=MESH_MAX_LEN)
        calls = [0]
        reduce_scatter = coll.reduce_scatter_dim

        def counted(*args, **kw):
            calls[0] += 1
            return reduce_scatter(*args, **kw)
        coll.reduce_scatter_dim = counted
        try:
            ops.reset_launch_counts()
            logits, toks, _st, ms = _mesh_run(prefill, step, model, prompt,
                                              2, dev)
            serve_counts, serve_rs = ops.launch_counts(), calls[0]
            del model, _st, prefill, step
            _free(dev)
            dist.barrier()
            calls[0] = 0
            train = _fsdp_sp_step(rcfg, 27, dev, rules, mesh)
            train["rs"] = calls[0]
        finally:
            coll.reduce_scatter_dim = reduce_scatter
        out["c"] = dict(logits=[x.cpu() for x in logits],
                        tokens=[x.cpu() for x in toks], serve_ms=ms,
                        serve_counts=serve_counts, serve_rs=serve_rs,
                        train=train)
        with open(FSDP_DIR / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _fsdp_sp_gloo(dev, card) -> dict:
    """(c): the one-rank steps here, then two gloo ranks on the card
    (``_fsdp_sp_rank``). Returns the ranks' summed launch counts."""
    import pickle
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.launch.steps import make_prefill, make_serve_step
    t0 = time.perf_counter()
    _, rcfg = _fsdp_sp_cfgs()
    model, prompt = _mla_serve_inputs(rcfg, dev)
    w_logits, w_toks, st, w_ms = _mesh_run(
        make_prefill(rcfg, max_len=MESH_MAX_LEN), make_serve_step(rcfg),
        model, prompt, 2, dev)
    del model, st
    _free(dev)
    want_c = _fsdp_sp_step(rcfg, 27, dev)
    shutil.rmtree(FSDP_DIR, ignore_errors=True)
    FSDP_DIR.mkdir(parents=True)
    t1 = time.perf_counter()
    mp.spawn(_fsdp_sp_rank, args=(2,), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t1
    ranks = []
    for r in range(2):
        with open(FSDP_DIR / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    shutil.rmtree(FSDP_DIR, ignore_errors=True)

    def close(got, want, tol):
        return abs(got - want) <= tol * abs(want)
    totals = {}
    for r, rk in enumerate(ranks):
        c = rk["c"]
        check(all(torch.equal(a, w.cpu()) for a, w in zip(c["tokens"],
                                                           w_toks)),
              f"(c) rank {r}: the 2-rank tokens differ from one rank's")
        check(c["serve_rs"] > 0 and c["train"]["rs"] > 0,
              f"(c) rank {r}: no reduce-scatter ran (serving "
              f"{c['serve_rs']}, training {c['train']['rs']})")
        for k, tol in (("loss", MLA_LOSS_TOL), ("grad_norm", MLA_GRAD_TOL)):
            check(close(c["train"][k], want_c[k], tol),
                  f"(c) rank {r} {k} {c['train'][k]} vs one rank "
                  f"{want_c[k]}")
        want_s = _mesh_launches(rcfg, 2)
        check(all(c["serve_counts"][k] == n for k, n in want_s.items()),
              f"(c) rank {r}: serving launches {c['serve_counts']}, want "
              f"{want_s}")
        for cnt in (c["serve_counts"], c["train"]["counts"]):
            for k, v in cnt.items():
                totals[k] = totals.get(k, 0) + v
    for name, n in (("lru_scan", 4), ("lru_scan_bwd", 2)):
        check(totals.get(name, 0) >= n, f"(c): {name} launched "
                                        f"{totals.get(name, 0)} times")
    err = max(float((a - w.cpu()).abs().max()) for rk in ranks
              for a, w in zip(rk["c"]["logits"], w_logits))
    check(err < MESH_GLOO_TOL, f"(c) logits {err} from the one-rank steps")
    c0 = ranks[0]["c"]
    print(f"  (c) recurrentgemma-9b, {rcfg.n_layers} layers at full width, "
          f"f32, two gloo ranks on the card, (1, 2) mesh, seq_shard: "
          f"prefill B 4 x 1024 + 2 steps, tokens == one rank's, logits "
          f"max|Δ| {err:.2e} (< {MESH_GLOO_TOL}), reduce-scatters "
          f"{c0['serve_rs']} serving / {c0['train']['rs']} in two train "
          f"steps; "
          f"train " + "; ".join(
              f"rank {r} loss {rk['c']['train']['loss']:.7f} grad norm "
              f"{rk['c']['train']['grad_norm']:.6f}"
              for r, rk in enumerate(ranks))
          + f" vs one rank {want_c['loss']:.7f} / {want_c['grad_norm']:.6f};"
          f" step ms: serving (median) one rank "
          f"{sorted(w_ms)[len(w_ms) // 2]:.2f}, ranks "
          f"{[round(sorted(rk['c']['serve_ms'])[1], 2) for rk in ranks]}, "
          f"train {[round(rk['c']['train']['ms'], 1) for rk in ranks]} "
          f"(one rank {want_c['ms']:.1f}); collectives of a second train "
          f"step {c0['train']['coll']}; launches a rank serving "
          f"{ {k: v for k, v in c0['serve_counts'].items() if v} }, "
          f"training "
          f"{ {k: v for k, v in c0['train']['counts'].items() if v} } "
          f"[{card}]", flush=True)
    print(f"  (c) spawn + run {spawn_s:.1f} s, "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return totals


def fsdp_sp_mesh_phase(dev, card) -> dict:
    """Phase 27. Returns the launch counts of (a)'s sharded runs on the
    (1, 1) NCCL mesh with fsdp and seq_shard, by part, and of (c)'s two
    gloo ranks summed ((b) runs in phase 29 (d))."""
    import torch.distributed as dist
    phase("27 fsdp-sp-mesh (fsdp and sequence parallelism: deepseek-v2 and "
          "recurrentgemma-9b's sharded serve and train steps on a (1, 1) "
          "NCCL mesh against the plain steps; two gloo ranks on the card: "
          "recurrentgemma-9b served and trained on a (1, 2) seq_shard "
          "mesh)")
    t0 = time.perf_counter()
    out = {"ds serve": _mesh_one_by_one(dev, card, DS_MESH_ARGV, "(a)",
                                        FSDP_SP, FSDP_SP_SERVE_STEPS)}
    _free(dev)
    out["rg serve"] = _mesh_one_by_one(
        dev, card, _family_argv("recurrentgemma-9b"), "(a)", FSDP_SP,
        FSDP_SP_SERVE_STEPS)
    _free(dev)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        for (cfg, label), key in zip(_mla_train_cfgs(),
                                     ("ds train", "rg train")):
            out[key] = _mesh_train_one_by_one(dev, card, cfg, "(a)", label,
                                              peak_gap=MLA_PEAK_GAP,
                                              flags=FSDP_SP)
            _free(dev)
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived (a)")
    out["gloo"] = _fsdp_sp_gloo(dev, card)
    _free(dev)
    print(f"  phase 27: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# 28. families-mesh: RWKV, the encoder-decoder and the prefix-LM on a mesh
# ---------------------------------------------------------------------------

# (a) the sharded steps on a (1, 1) NCCL mesh against the plain steps,
# bf16: a B 4 prompt of FAM_PROMPT tokens (paligemma's 256 patch
# embeddings ahead of it, whisper's 1500 encoder frames beside it), the
# clocks staggered, FAM_SERVE_STEPS steps, rings of FAM_MAX_LEN rows;
# whisper-tiny whole, paligemma-3b and rwkv6-1.6b (SOI pp) served at full
# depth and trained (bf16 over f32 masters, B 8 S 128) at
# FAM_TRAIN_LAYERS
FAM_PROMPT = 128
FAM_MAX_LEN = 512
FAM_SERVE_STEPS = 8
FAM_TRAIN_LAYERS = {"paligemma-3b": 4, "rwkv6-1.6b": 6}
# (b) two gloo ranks sharing the card on a (1, 2) mesh, f32: whisper-tiny
# whole (its 51865-row vocab whole on each rank, its 1500 frames' cross
# K/V split 750 + 750); paligemma-3b at 2 of 18 layers and rwkv6-1.6b at 4
# of 24 (SOI pp over 1..3): two ranks' f32 training states beside the
# plain step's and the one-rank serving run's hold on the card with room
FAM_GLOO_LAYERS = {"paligemma-3b": 2, "rwkv6-1.6b": 4}
FAM_GLOO_STEPS = 4
# (b) gates, stated before the first run: logits as phase 24 (c)'s
# (MESH_GLOO_TOL); the loss relative (FAM_LOSS_TOL), the grad norm
# relative (FAM_GRAD_TOL); each leaf's rank shard of AdamW's first moment
# after one step (0.1 x the clipped gradient) relative to the plain one's
# largest (FAM_GRAD_TOL): the split model axis sums the partial products
# in another order (phase 26 (d) measured 1.13e-5 for recurrentgemma).
# RWKV's token-shift mix and decay sit behind clamps, where float32
# rounding flips whole elements of a gradient (a CPU run at d 512 put one
# process's float32 first moments 4.2e-2 from the two ranks' at a mix
# LoRA, each within 2e-3 of a float64 run): its gradients are held to a
# float64 run of the plain step instead, as phase 23 (b) holds them — the
# two ranks' no further from it, leaf by leaf, than RATIO_64 x one
# process's float32 gradients (below FLOOR_64 both are rounding alike)
FAM_LOSS_TOL = 1e-5
FAM_GRAD_TOL = 1e-4
FAM_DIR = ROOT / "build" / "families_mesh"
# (0) the kernels at the shapes these paths give them, against their plain
# versions in f32 and bf16: decode_attention's return_lse on the two
# ranks' halves of (label, B, rows, Hkv, G, dh, first clock or None for
# the cross read's 1 << 30) — whisper's cross K/V and paligemma's self
# ring (MQA, the query gathered to its 8 heads), the halves merged in
# rank order against the whole read; flash_attention and its backward on
# the rank's 3 of whisper's 6 heads at (label, Sq, Sk, causal), training's
# B 8 (``_bwd_shape_checks``: the forward's output and lse and the
# backward against their plain versions, the bf16 backward timed)
FAM_READS = (("whisper cross read", 4, 1500, 6, 1, 64, None),
             ("paligemma ring", 4, FAM_MAX_LEN, 1, 8, 256, 256 + FAM_PROMPT))
FAM_FLASH = (("whisper encoder", 1500, 1500, False),
             ("whisper cross", FAM_PROMPT, 1500, False),
             ("whisper self", FAM_PROMPT, FAM_PROMPT, True))


def _fam_read_checks(dev, gen) -> dict:
    """(0) decode_attention with its lse at each FAM_READS shape: each
    half's (out, lse) against the plain version's, the halves merged
    against the whole read. Returns {label dtype: record}."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref
    out = {}
    for label, b, s, hkv, g, dh, clock in FAM_READS:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for shape in ((b, hkv * g, dh), (b, s, hkv, dh),
                                     (b, s, hkv, dh)))
            pos = torch.arange(s, dtype=torch.int32, device=dev)[None] \
                .repeat(b, 1)
            if clock is None:
                t = torch.full((b,), 1 << 30, dtype=torch.int32, device=dev)
            else:
                t = torch.tensor([clock - i for i in range(b)],
                                 dtype=torch.int32, device=dev)
                pos = torch.where(pos <= t[:, None], pos,
                                  torch.full_like(pos, -1))
            half = s // 2
            halves, errs, lerrs = [], [], []
            for r in range(2):
                sl = slice(r * half, (r + 1) * half)
                args = (q,) + tuple(x[:, sl].contiguous()
                                    for x in (k, v, pos)) + (t,)
                o, lse = DA.decode_attention(*args, return_lse=True)
                w_o, w_lse = ref.decode_attention(*args, return_lse=True)
                live = ~torch.isneginf(w_lse)
                check(torch.equal(~torch.isneginf(lse), live),
                      f"(0) {label} {dt} half {r}: lse -inf elsewhere")
                err = float((o.float() - w_o.float()).abs().max())
                lerr = float((lse[live] - w_lse[live]).abs().max())
                tol = TOL[dt]
                if dt == torch.bfloat16:
                    tol = min(tol, READ_REL_TOL * float(
                        w_o.float().abs().max()))
                check(err < tol and lerr < LSE_TOL[dt],
                      f"(0) {label} {dt} half {r}: max|Δ| out {err} (tol "
                      f"{tol}), lse {lerr}")
                errs.append(err)
                lerrs.append(lerr)
                halves.append((o, lse))
            whole = DA.decode_attention(q, k, v, pos, t)
            merged = ref.merge_partials(torch.stack([h[0] for h in halves]),
                                        torch.stack([h[1] for h in halves]))
            merr = float((merged.float() - whole.float()).abs().max())
            tol = TOL[dt]
            if dt == torch.bfloat16:
                tol = min(tol, READ_REL_TOL * float(whole.float().abs()
                                                    .max()))
            check(merr < tol, f"(0) {label} {dt}: merged halves vs the "
                              f"whole read {merr}")
            shape = f"2 x ({b},{half},{hkv},{dh}) G {g}, return_lse"
            out[f"{label} {str(dt)[6:]}"] = {
                "shape": shape, "max_abs_err": max(errs),
                "lse_max_abs_err": max(lerrs), "merge_err": merr}
            print(f"  (0) decode_attention {label} {str(dt)[6:]}, {shape}: "
                  f"max|Δ| out {max(errs):.2e}, lse {max(lerrs):.2e}; "
                  f"merged in rank order vs the whole ({b},{s},{hkv},{dh}) "
                  f"read {merr:.2e}", flush=True)
            del q, k, v, pos, t, halves, whole, merged
    return out


def _fam_stubs(cfg, b, dev, seed) -> dict:
    """Seeded random stub frontends: paligemma's patch embeddings (b, 256,
    d) — as phase 23 (c) feeds them, an image encoder's stand-in — and
    whisper's encoder frames (b, 1500, d_enc)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    if cfg.frontend == "patch_stub":
        out["patch_embeds"] = torch.randn(
            (b, cfg.frontend_len, cfg.d_model), generator=gen, device=dev)
    if cfg.encoder is not None:
        out["encoder_frames"] = torch.randn(
            (b, cfg.encoder.n_frames, cfg.encoder.d_model), generator=gen,
            device=dev)
    return out


def _fam_cfgs():
    """(a)'s (label, serving config, training config) at full width,
    bf16."""
    from repro_torch import configs
    return tuple((label, configs.get(label, soi=soi),
                  configs.get(label, soi=soi, **(
                      {"n_layers": FAM_TRAIN_LAYERS[label]}
                      if label in FAM_TRAIN_LAYERS else {})))
                 for label, soi in (("whisper-tiny", None),
                                    ("paligemma-3b", None),
                                    ("rwkv6-1.6b", "pp")))


def _fam_serve_inputs(cfg, dev, dtype=torch.bfloat16):
    """(weights in ``dtype``, batch: B 4 tokens and the stubs) from the
    seed, the same in every process."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=dev).manual_seed(28)
    model = T.init(cfg, generator=gen, device=dev, dtype=dtype)
    prompt = torch.randint(0, cfg.vocab, (4, FAM_PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    return model, dict(tokens=prompt, **_fam_stubs(cfg, 4, dev, 29))


def _fam_gloo_cfgs():
    """(b)'s f32 configs: (label, config)."""
    from repro_torch import configs
    return tuple((label, dataclasses.replace(configs.get(label, soi=soi, **(
        {"n_layers": FAM_GLOO_LAYERS[label]} if label in FAM_GLOO_LAYERS
        else {})), dtype="float32"))
        for label, soi in (("whisper-tiny", None), ("paligemma-3b", None),
                           ("rwkv6-1.6b", "pp")))


def _fam_rank(rank, world):
    """(b) one of two gloo ranks sharing the card, a (1, 2) mesh: each
    config of ``_fam_gloo_cfgs`` served from the seed through the sharded
    prefill + steps (the state's split leaves' local shapes kept), then
    one sharded train step and the plain step from the same weights in
    this process, compared here (AdamW's first moment, as phase 26 (d)).
    The ranks take the plain step one at a time. Writes the results."""
    import os
    import pickle
    import torch.distributed as dist
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.distributed.sharding import ShardingRules, shard_params
    from repro_torch.kernels import ops
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (local_batch, make_prefill,
                                          make_serve_step, make_train_step)
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from torch.distributed.tensor import Shard
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    store = dist.FileStore(str(FAM_DIR / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((1, world), ("data", "model"))
        rules = ShardingRules(data_axes=("data",))
        kw = dict(peak_lr=1e-3, warmup=20, total_steps=TRAIN_STEPS)
        out = {}
        for label, cfg in _fam_gloo_cfgs():
            r = out[label] = {}
            model, batch = _fam_serve_inputs(cfg, dev, torch.float32)
            model = shard_params(model, rules, mesh)
            r["serve_bytes"] = _moe_param_bytes(model, cfg, rules, mesh)
            prefill = make_prefill(cfg, rules, mesh, max_len=FAM_MAX_LEN)
            step = make_serve_step(cfg, rules, mesh, max_len=FAM_MAX_LEN)
            ops.reset_launch_counts()
            logits, toks, st, ms = _mesh_run(prefill, step, model, batch,
                                             FAM_GLOO_STEPS, dev)
            r["serve_counts"] = ops.launch_counts()
            r["split"] = {k: tuple(v.shape) for k, v in S.flatten(st).items()
                          if k.rsplit(".", 1)[-1] in ("k", "S")}
            r.update(logits=[x.cpu() for x in logits],
                     tokens=[x.cpu() for x in toks], serve_ms=ms)
            del model, st, prefill, step, logits
            _free(dev)
            dist.barrier()

            pipe = ShardedLMPipeline(global_batch=8, seq_len=128,
                                     vocab=cfg.vocab, seed=0)
            batch = dict(_train_batch(pipe, 0, dev),
                         **_fam_stubs(cfg, 8, dev, 30))

            def init():
                return T.init(cfg, generator=torch.Generator(device=dev)
                              .manual_seed(27), device=dev)
            model = shard_params(init(), rules, mesh)
            r["train_bytes"] = _moe_param_bytes(model, cfg, rules, mesh)
            opt = adamw_init(dict(model.named_parameters()))
            step = make_train_step(cfg, rules, mesh, **kw)
            ops.reset_launch_counts()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            sm = step(model, opt, local_batch(batch, mesh))[2]
            torch.cuda.synchronize(dev)
            r["train_ms"] = (time.perf_counter() - t0) * 1e3
            r["train_counts"] = ops.launch_counts()
            shards = {}
            for k, p in model.named_parameters():
                dims = [pl.dim for pl in p.placements
                        if isinstance(pl, Shard)]
                shards[k] = (dims[0] if dims else None,
                             opt["mu"][k].to_local().clone())
            del model, opt, step
            _free(dev)
            for turn in range(world):
                dist.barrier()
                if turn != rank:
                    continue
                plain = init()
                popt = adamw_init(dict(plain.named_parameters()))
                pm = make_train_step(cfg, **kw)(plain, popt, batch)[2]
                rels = []
                for k, (d, mine) in shards.items():
                    want = popt["mu"][k]
                    if d is not None:
                        want = want.chunk(world, dim=d)[rank]
                    rels.append((float((mine - want).abs().max()
                                       / want.abs().max().clamp_min(1e-30)),
                                 k))
                rels.sort(reverse=True)
                r.update(train_metrics={k: float(sm[k]) for k in sm},
                         plain_metrics={k: float(pm[k]) for k in pm},
                         grad_rel=rels[0][0], grad_rel_at=rels[0][1],
                         grad_top=rels[:3], n_leaves=len(shards))
                if cfg.segments[0].blocks[0].rwkv is not None:
                    r["anchor64"] = _fam_anchor64(
                        init, cfg, batch, shards, popt["mu"], r, rank,
                        world)
                del plain, popt, shards
                _free(dev)
            dist.barrier()
        with open(FAM_DIR / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _fam_anchor64(init, cfg, batch, shards, mu, r, rank, world):
    """(b)'s float64 anchor of an RWKV stack: the gradients of a float64
    copy of the weights (``_float64_grads``; the stack runs no kernel),
    and of each leaf the rank's shard of the two ranks' float32 gradient
    and of one process's — each its first moment over 0.1 x the clip's
    scale (the metrics of ``r``) — off them, over the float64 leaf's
    largest: [(two ranks', one process's, leaf)], the worst first."""
    _, g64 = _float64_grads(init(), cfg, batch)
    scale = {k: 0.1 * min(1.0, 1.0 / r[k]["grad_norm"])
             for k in ("train_metrics", "plain_metrics")}
    out = []
    for k, (d, mine) in shards.items():
        w, p = g64[k], mu[k]
        if d is not None:
            w, p = (t.chunk(world, dim=d)[rank] for t in (w, p))
        den = w.abs().max().clamp_min(1e-300)
        out.append((float((mine.double() / scale["train_metrics"]
                           - w).abs().max() / den),
                    float((p.double() / scale["plain_metrics"]
                           - w).abs().max() / den), k))
    del g64
    return sorted(out, reverse=True)


def _fam_gloo(dev, card) -> dict:
    """(b): each config's one-rank f32 serving steps here, then two gloo
    ranks on the card (``_fam_rank``): tokens equal, logits within
    MESH_GLOO_TOL, the state split as the specs lay it out, launches; the
    ranks' train steps against their plain steps within FAM_LOSS_TOL and
    FAM_GRAD_TOL; bytes == the specs'. Returns the ranks' summed launch
    counts."""
    import pickle
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.launch.steps import make_prefill, make_serve_step
    t0 = time.perf_counter()
    want = {}
    for label, cfg in _fam_gloo_cfgs():
        model, batch = _fam_serve_inputs(cfg, dev, torch.float32)
        n_params = sum(p.numel() for p in model.parameters())
        logits, toks, st, ms = _mesh_run(
            make_prefill(cfg, max_len=FAM_MAX_LEN), make_serve_step(cfg),
            model, batch, FAM_GLOO_STEPS, dev)
        want[label] = (logits, toks, ms, n_params)
        del model, st
        _free(dev)
    shutil.rmtree(FAM_DIR, ignore_errors=True)
    FAM_DIR.mkdir(parents=True)
    t1 = time.perf_counter()
    mp.spawn(_fam_rank, args=(2,), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t1
    ranks = []
    for r in range(2):
        with open(FAM_DIR / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    shutil.rmtree(FAM_DIR, ignore_errors=True)

    def med(x):
        return sorted(x)[len(x) // 2]

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)
    totals = {}
    for label, cfg in _fam_gloo_cfgs():
        w_logits, w_toks, w_ms, n_params = want[label]
        err = 0.0
        for r, rk in enumerate(ranks):
            g = rk[label]
            check(all(torch.equal(a, b.cpu()) for a, b in zip(g["tokens"],
                                                              w_toks)),
                  f"(b) {label} rank {r}: the 2-rank tokens differ from the "
                  f"one-rank steps'")
            err = max([err] + [float((a - b.cpu()).abs().max())
                               for a, b in zip(g["logits"], w_logits)])
            for k, shape in g["split"].items():
                whole = (cfg.encoder.n_frames if k.startswith("cross_kv.")
                         else FAM_MAX_LEN)
                if k.endswith(".S"):
                    ok = shape[1] * 2 == cfg.segments[0].blocks[0].rwkv \
                        .n_heads
                else:
                    ok = shape[1] * 2 == whole
                check(ok, f"(b) {label} rank {r}: {k} {shape} is not the "
                          f"specs' half")
            for what in ("serve_bytes", "train_bytes"):
                got, spec = g[what]
                check(got == spec, f"(b) {label} rank {r} {what} {got} != "
                                   f"the specs' {spec}")
            sm, pm = g["train_metrics"], g["plain_metrics"]
            for k, tol in (("loss", FAM_LOSS_TOL),
                           ("grad_norm", FAM_GRAD_TOL)):
                check(rel(sm[k], pm[k]) <= tol,
                      f"(b) {label} rank {r} {k} {sm[k]} vs one rank "
                      f"{pm[k]}")
            if "anchor64" in g:
                for two, one, k in g["anchor64"]:
                    check(two <= RATIO_64 * max(one, FLOOR_64),
                          f"(b) {label} rank {r} {k}: the two ranks' "
                          f"gradient {two:.2e} off the float64 run, one "
                          f"process's {one:.2e}")
            else:
                check(g["grad_rel"] <= FAM_GRAD_TOL,
                      f"(b) {label} rank {r} gradient {g['grad_rel_at']}: "
                      f"rel {g['grad_rel']}")
            want_s = _mesh_launches(cfg, FAM_GLOO_STEPS)
            check(all(g["serve_counts"][k] == n for k, n in want_s.items()),
                  f"(b) {label} rank {r}: serving launches "
                  f"{g['serve_counts']}, want {want_s}")
            want_t = _train_want(cfg, _mesh_launches(cfg, 0)[
                "flash_attention"])
            check(all(g["train_counts"][k] == n for k, n in want_t.items()),
                  f"(b) {label} rank {r}: training launches "
                  f"{g['train_counts']}, want {want_t}")
        check(err < MESH_GLOO_TOL,
              f"(b) {label} logits {err} from the one-rank steps")
        for part in ("serve_counts", "train_counts"):
            for k in ranks[0][label][part]:
                totals[k] = totals.get(k, 0) + sum(rk[label][part][k]
                                                   for rk in ranks)
        g0 = ranks[0][label]
        print(f"  (b) {label} ({cfg.n_layers} layers, "
              f"{n_params / 1e9:.3f} B params) f32, two gloo ranks on the "
              f"card, (1, 2) mesh: serving B 4 x {FAM_PROMPT}, "
              f"{FAM_GLOO_STEPS} steps, tokens == one rank's, logits "
              f"max|Δ| {err:.2e} (< {MESH_GLOO_TOL}); split state "
              f"{sorted(set(g0['split'].values()))}; launches a rank "
              f"{ {k: v for k, v in g0['serve_counts'].items() if v} }; ms "
              f"a step (median, host clock) one rank {med(w_ms):.2f}, the "
              f"ranks {[round(med(rk[label]['serve_ms']), 2) for rk in ranks]}"
              f" [{card}]", flush=True)
        print(f"  (b) {label} one train step f32, B 8 S 128, against the "
              f"plain step in each rank: " + "; ".join(
                  f"rank {r} loss {rk[label]['train_metrics']['loss']:.7f} "
                  f"vs {rk[label]['plain_metrics']['loss']:.7f}, grad norm "
                  f"{rk[label]['train_metrics']['grad_norm']:.6f} vs "
                  f"{rk[label]['plain_metrics']['grad_norm']:.6f}, worst "
                  f"first-moment rel {rk[label]['grad_rel']:.2e} "
                  f"({rk[label]['grad_rel_at']}; top 3 "
                  f"{[(f'{x:.2e}', k) for x, k in rk[label]['grad_top']]}, "
                  f"{rk[label]['n_leaves']} leaves)"
                  + (f", off a float64 run worst (two ranks', one "
                     f"process's) "
                     f"{[(f'{a:.2e}', f'{b:.2e}', k) for a, b, k in rk[label]['anchor64'][:3]]}"
                     if "anchor64" in rk[label] else "")
                  for r, rk in enumerate(ranks))
              + f" (gates: loss {FAM_LOSS_TOL}, grad norm {FAM_GRAD_TOL}, "
              + ("each leaf within RATIO_64 of one process's off float64"
                 if "anchor64" in g0 else f"first moments {FAM_GRAD_TOL}")
              + "); launches "
              f"a rank { {k: v for k, v in g0['train_counts'].items() if v} }"
              f"; step ms (the first, host clock) "
              f"{[round(rk[label]['train_ms'], 1) for rk in ranks]}; "
              f"parameter bytes a rank (== the specs') serving "
              f"{[rk[label]['serve_bytes'][0] for rk in ranks]}, training "
              f"{[rk[label]['train_bytes'][0] for rk in ranks]} [{card}]",
              flush=True)
    print(f"  (b) spawn + run {spawn_s:.1f} s, (b) "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return totals


def families_mesh_phase(dev, card) -> tuple:
    """Phase 28. Returns (the launch counts of (a)'s sharded runs on the
    (1, 1) NCCL mesh and of (b)'s two gloo ranks summed, by part; (0)'s
    records by kernel)."""
    import torch.distributed as dist
    phase("28 families-mesh (rwkv6-1.6b, whisper-tiny and paligemma-3b "
          "through the sharded serve and train steps on a (1, 1) NCCL mesh "
          "against the plain steps; two gloo ranks on the card, heads, "
          "cross frames and rings split, whisper's vocab whole)")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(28)
    shapes = {"decode_attention": _fam_read_checks(dev, gen)}
    bwd = _bwd_shape_checks([
        (f"{label} on 3 of 6 heads", 8, sq, sk, (3, 3), (64, 64), causal)
        for label, sq, sk, causal in FAM_FLASH], dev, gen)
    shapes["flash_attention_bwd"] = bwd
    # the forward's output and lse are held inside the same checks
    shapes["flash_attention"] = {
        label: {"shape": rec["shape"], "causal": rec.get("causal", True),
                "held": "output and lse against the plain version, f32 "
                        "and bf16"} for label, rec in bwd.items()}
    _free(dev)
    out = {}
    for label, scfg, _ in _fam_cfgs():
        model, batch = _fam_serve_inputs(scfg, dev)
        out[f"{label} serve"] = _mesh_one_by_one(
            dev, card, tag="(a)", n_steps=FAM_SERVE_STEPS,
            inputs=(scfg, model, batch), max_len=FAM_MAX_LEN)
        del model, batch
        _free(dev)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        for label, _, tcfg in _fam_cfgs():
            out[f"{label} train"] = _mesh_train_one_by_one(
                dev, card, tcfg, "(a)", f"{label} at {tcfg.n_layers} layers",
                stubs=functools.partial(
                    lambda c, i: _fam_stubs(c, 8, dev, 100 + i), tcfg))
            _free(dev)
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived (a)")
    out["gloo"] = _fam_gloo(dev, card)
    _free(dev)
    print(f"  phase 28: {time.perf_counter() - t0:.1f} s", flush=True)
    return out, shapes


# ---------------------------------------------------------------------------
# 29. remat: the reference's per-layer rematerialisation in the train steps
# ---------------------------------------------------------------------------

REMAT_S = 4096                     # the reference's train_4k length
REMAT_B = 2                        # (a), (c)
REMAT_LONG_B = 8                   # (b)
REMAT_STEPS = 2                    # the second one measured
REMAT_DIR = ROOT / "build" / "remat_fsdp"


def _remat_step(cfg, b, dev) -> dict:
    """REMAT_STEPS make_train_step steps of ``cfg`` (bf16 over float32
    masters) from seed 29's weights, on B ``b`` x S REMAT_S batches: the
    last step's loss and grad norm, ms (host clock after a synchronize),
    peak GiB (allocated, from a reset before it) and launches, and every
    master's and moment's digest after the steps."""
    from repro_torch.data.pipeline import ShardedLMPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    _free(dev)
    model = T.init(cfg, generator=torch.Generator(device=dev)
                   .manual_seed(29), device=dev)
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, peak_lr=1e-3, warmup=20,
                           total_steps=TRAIN_STEPS)
    pipe = ShardedLMPipeline(global_batch=b, seq_len=REMAT_S,
                             vocab=cfg.vocab, seed=0)
    for i in range(REMAT_STEPS):
        batch = _train_batch(pipe, i, dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        m = step(model, opt, batch)[2]
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
    out = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               ms=ms, counts=ops.launch_counts(),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               digests={"params": _digests(dict(model.named_parameters())),
                        "mu": _digests(opt["mu"]),
                        "nu": _digests(opt["nu"])})
    del model, opt, step, batch, m
    _free(dev)
    return out


def _remat_same(got, want, label):
    """``got``'s loss, grad norm and digests bit for bit ``want``'s."""
    for k in ("loss", "grad_norm"):
        check(got[k] == want[k], f"{label}: {k} {got[k]} != {want[k]}")
    for t, d in want["digests"].items():
        bad = [k for k in d if got["digests"][t].get(k) != d[k]]
        check(not bad and set(got["digests"][t]) == set(d),
              f"{label}: {t} differ: {bad[:5]}")


def _remat_fsdp_rank(rank, world):
    """(d), one of two gloo ranks sharing the card: phase 27 (b)'s train
    step of qwen3-1.7b on a (2, 1) fsdp mesh with remat off, then on, the
    all-gathers of its two steps (``_fsdp_sp_step``'s and the profiled
    one) counted. Writes the results."""
    import os
    import pickle
    import torch.distributed as dist
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    store = dist.FileStore(str(REMAT_DIR / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        qcfg = _fsdp_sp_cfgs()[0]
        mesh = make_mesh((world, 1), ("data", "model"))
        rules = ShardingRules(data_axes=("data",), fsdp=True)
        out = {}
        gather, clip = coll.all_gather_dim, steps.clip_by_global_norm
        for remat in (False, True):
            calls, before = [0], []

            def counted(*args, **kw):
                calls[0] += 1
                return gather(*args, **kw)

            def clipped(*args, **kw):
                # the step's peak up to its update: forward, backward and
                # the gradients' sums, where the gathered leaves live
                before.append(torch.cuda.max_memory_allocated(dev) / 2 ** 30)
                return clip(*args, **kw)
            coll.all_gather_dim, steps.clip_by_global_norm = counted, clipped
            try:
                out[remat] = _fsdp_sp_step(dataclasses.replace(
                    qcfg, remat=remat), 27, dev, rules, mesh)
            finally:
                coll.all_gather_dim, steps.clip_by_global_norm = gather, clip
            out[remat].update(gathers=calls[0] / 2, grad_gib=before[0])
            dist.barrier()
        with open(REMAT_DIR / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _remat_fsdp(dev, card) -> dict:
    """(d): one process's step here, then two gloo ranks on the card
    (``_remat_fsdp_rank``): each within phase 27 (b)'s gates of it, remat
    on and off; the parameter bytes the specs'; each rank's peak, and up
    to the update; the all-gathers a step (``collectives.all_gather_dim``'s calls): every
    data-split leaf outside the blocks once, each block's inside its layer
    group, twice with remat.
    Returns the ranks' summed launch counts, by remat."""
    import pickle
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import AbstractMesh
    t0 = time.perf_counter()
    qcfg = _fsdp_sp_cfgs()[0]
    want = _fsdp_sp_step(qcfg, 27, dev)
    shutil.rmtree(REMAT_DIR, ignore_errors=True)
    REMAT_DIR.mkdir(parents=True)
    t1 = time.perf_counter()
    mp.spawn(_remat_fsdp_rank, args=(2,), nprocs=2, join=True)
    spawn_s = time.perf_counter() - t1
    ranks = []
    for r in range(2):
        with open(REMAT_DIR / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    shutil.rmtree(REMAT_DIR, ignore_errors=True)
    _, specs = S.param_specs(qcfg, ShardingRules(data_axes=("data",),
                                                 fsdp=True),
                             AbstractMesh({"data": 2, "model": 1}))
    split = [k for k, spec in specs.items() if "data" in spec]
    blocks = sum(k.startswith("blocks.") for k in split)
    full = want["n_params"] * 4
    totals = {}
    for remat in (False, True):
        n_gather = len(split) - blocks + (2 if remat else 1) * blocks
        tag = "remat" if remat else "no remat"
        for r, rk in enumerate(ranks):
            b = rk[remat]
            for k, tol in (("loss", FSDP_LOSS_TOL),
                           ("grad_norm", FSDP_GRAD_TOL)):
                check(abs(b[k] - want[k]) <= tol * abs(want[k]),
                      f"(d) {tag} rank {r} {k} {b[k]} vs one process "
                      f"{want[k]}")
            got, spec = b["bytes"]
            check(got == spec and got < 0.55 * full,
                  f"(d) {tag} rank {r} parameter bytes {got}, the specs' "
                  f"{spec}, whole f32 {full}")
            gathers = b["gathers"]
            check(gathers == n_gather,
                  f"(d) {tag} rank {r}: {gathers} all-gathers a step, want "
                  f"{n_gather} ({len(split) - blocks} leaves outside the "
                  f"blocks, {blocks} in them)")
            n = _train_want(dataclasses.replace(qcfg, remat=remat),
                            qcfg.n_layers)
            check(all(b["counts"][k] == v for k, v in n.items()),
                  f"(d) {tag} rank {r}: launches {b['counts']}, want {n}")
            tot = totals.setdefault(remat, {})
            for k, v in b["counts"].items():
                tot[k] = tot.get(k, 0) + v
        r0 = ranks[0][remat]
        print(f"  (d) qwen3-1.7b SOI pp, {qcfg.n_layers} of 28 layers at "
              f"full width ({want['n_params'] / 1e9:.3f} B params), f32, B "
              f"8 S 128, one train step, two gloo ranks on the card, (2, "
              f"1) fsdp mesh, {tag}: " + "; ".join(
                  f"rank {r} loss {rk[remat]['loss']:.7f} grad norm "
                  f"{rk[remat]['grad_norm']:.6f}"
                  for r, rk in enumerate(ranks))
              + f" vs one process's (remat) {want['loss']:.7f} / "
              f"{want['grad_norm']:.6f} (rel {FSDP_LOSS_TOL} / "
              f"{FSDP_GRAD_TOL}); peak GiB a rank "
              f"{[round(rk[remat]['peak_gib'], 3) for rk in ranks]} "
              f"(9.19 holding the whole gathered model, PERF.md; up to "
              f"the update "
              f"{[round(rk[remat]['grad_gib'], 3) for rk in ranks]}; at its "
              f"start "
              f"{[round(rk[remat]['start_gib'], 3) for rk in ranks]}), one "
              f"process {want['peak_gib']:.3f}; all-gathers a step "
              f"{n_gather} == counted ({len(split)} leaves split, {blocks} "
              f"of them in the blocks); step ms (host clock, the first) "
              f"{[round(rk[remat]['ms'], 1) for rk in ranks]}; "
              f"collectives of a second step [calls, host ms]: "
              f"{r0['coll']}; launches a rank "
              f"{ {k: v for k, v in r0['counts'].items() if v} } [{card}]",
              flush=True)
    print(f"  (d) one process: parameter bytes {full}, step "
          f"{want['ms']:.1f} ms; spawn + run {spawn_s:.1f} s, "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return totals


def remat_phase(dev, card) -> dict:
    """Phase 29. Returns {run: launch counts}."""
    from repro_torch import configs
    phase("29 remat (qwen3-1.7b at full width and depth, bf16 over f32 "
          "masters, SOI pp, B 2 x S 4096 with remat off and with each "
          "policy, bit for bit; B 8 x S 4096 with remat; the fsdp step on "
          "two gloo ranks, remat off and on)")
    t0 = time.perf_counter()
    cfg = configs.get("qwen3-1.7b", soi="pp")
    tokens = REMAT_B * REMAT_S
    runs = {}
    for label, kw in (("full", {}), ("off", dict(remat=False)),
                      ("dots", dict(remat_policy="dots")),
                      ("names", dict(remat_policy="names"))):
        c = dataclasses.replace(cfg, **kw)
        runs[label] = r = _remat_step(c, REMAT_B, dev)
        if label != "full":
            _remat_same(r, runs["full"], f"(a)/(c) {label} vs full")
        want = _train_want(c, cfg.n_layers)
        check(all(r["counts"][k] == n for k, n in want.items()),
              f"(a) {label}: launches {r['counts']}, want {want}")
        print(f"  ({'a' if label in ('full', 'off') else 'c'}) {label}: "
              f"B {REMAT_B} x S {REMAT_S}, step {REMAT_STEPS}: loss "
              f"{r['loss']:.6f}, grad norm {r['grad_norm']:.6f}"
              + ("" if label == "full" else
                 " (loss, grad norm, every master and moment bit for bit "
                 "the full policy's)")
              + f"; step {r['ms']:.1f} ms (host clock after a synchronize),"
              f" {tokens / r['ms'] * 1e3:.0f} tokens/s; peak "
              f"{r['peak_gib']:.2f} GiB; flash_attention "
              f"{r['counts']['flash_attention']} + "
              f"{r['counts']['flash_attention_bwd']} bwd [{card}]",
              flush=True)
    long_ = _remat_step(cfg, REMAT_LONG_B, dev)
    want = _train_want(cfg, cfg.n_layers)
    check(all(long_["counts"][k] == n for k, n in want.items()),
          f"(b): launches {long_['counts']}, want {want}")
    check(math.isfinite(long_["loss"]), f"(b): loss {long_['loss']}")
    print(f"  (b) full: B {REMAT_LONG_B} x S {REMAT_S} (the reference's "
          f"train_4k length), step {REMAT_STEPS}: loss "
          f"{long_['loss']:.6f}; step {long_['ms']:.1f} ms (host clock "
          f"after a synchronize), "
          f"{REMAT_LONG_B * REMAT_S / long_['ms'] * 1e3:.0f} tokens/s; peak "
          f"{long_['peak_gib']:.2f} GiB (remat off: not run, its "
          f"activations alone pass 80 GB) [{card}]", flush=True)
    out = {k: r["counts"] for k, r in runs.items()}
    out["long"] = long_["counts"]
    gloo = _remat_fsdp(dev, card)
    out["gloo off"], out["gloo"] = gloo[False], gloo[True]
    _free(dev)
    print(f"  phase 29: {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    return out


def main():
    card = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    main_recs = kernels_phase(dev)
    cow_counts = parity_phase(dev)
    counts = serve_phase(dev)
    paged_counts = paged_serve_phase(dev)
    _free(dev)
    deepseek_parity_phase(dev)
    ds_counts = deepseek_serve_phase(dev)
    mla_cow_counts, mla_counts = mla_phase(dev)
    rg_parity_phase(dev)
    rg_counts = rg_serve_phase(dev)
    unet_parity_phase(dev)
    unet_counts = unet_stream_phase(dev)
    graph_kernels, graphed = graphs_phase(dev)
    spec_counts = spec_phase(dev, PLAIN_SEQS)
    obs_counts = obs_phase(dev, PLAIN_SEQS, graph_kernels)
    main_recs["flash_attention_bwd"], train_counts = train_phase(dev, card)
    _free(dev)
    fam = families_phase(dev)
    _free(dev)
    zoo = zoo_phase(dev)
    _free(dev)
    analysis_phase(dev, card, graphed)
    _free(dev)
    dist_counts = dist_phase(dev, card)
    _free(dev)
    mla_bwd, main_recs["lru_scan_bwd"], fam_train = train_families_phase(
        dev, card)
    _free(dev)
    zoo_bwd, zoo_train = zoo_train_phase(dev, card)
    _free(dev)
    mesh_lse, mesh_counts, mesh_gloo = serve_mesh_phase(dev, card)
    _free(dev)
    moe_counts = moe_mesh_phase(dev, card)
    _free(dev)
    mesh26_counts = mla_rglru_mesh_phase(dev, card)
    # phase 26's sharded runs, each kernel's launches there
    mesh26_on = {
        "ds serve": f"sharded serve (deepseek-v2 4 layers bf16, (1, 1) NCCL "
                    f"mesh, prefill + {MESH_STEPS} steps)",
        "rg serve": f"sharded serve (recurrentgemma-9b 38 layers bf16, (1, "
                    f"1) NCCL mesh, prefill + {MESH_STEPS} steps)",
        "ds train": f"sharded train (deepseek-v2 MLA stack 4 layers, (1, 1) "
                    f"NCCL mesh, {DIST_STEPS} steps)",
        "rg train": f"sharded train (recurrentgemma-9b 6 layers, (1, 1) "
                    f"NCCL mesh, {DIST_STEPS} steps)",
        "gloo": f"two gloo ranks on the card, (1, 2) mesh, f32: deepseek-v2 "
                f"(2 layers served, 1 trained) and recurrentgemma-9b (3), "
                f"prefill + {MESH_GLOO_STEPS} steps and one train step each"}
    _free(dev)
    mesh27_counts = fsdp_sp_mesh_phase(dev, card)
    _free(dev)
    mesh28_counts, mesh28_shapes = families_mesh_phase(dev, card)
    # phase 28's sharded runs of the three families
    mesh28_on = {
        f"{label} {part}": (
            f"sharded {part} ({label} "
            + (f"{cfg.n_layers} layers bf16, (1, 1) NCCL mesh, prefill + "
               f"{FAM_SERVE_STEPS} steps)" if part == "serve" else
               f"{cfg.n_layers} layers, (1, 1) NCCL mesh, {DIST_STEPS} "
               f"steps)"))
        for label, scfg, tcfg in _fam_cfgs()
        for part, cfg in (("serve", scfg), ("train", tcfg))}
    mesh28_on["gloo"] = (
        f"two gloo ranks on the card, (1, 2) mesh, f32: whisper-tiny, "
        f"paligemma-3b ({FAM_GLOO_LAYERS['paligemma-3b']} layers) and "
        f"rwkv6-1.6b ({FAM_GLOO_LAYERS['rwkv6-1.6b']}), prefill + "
        f"{FAM_GLOO_STEPS} steps and one train step each")
    mesh29_counts = remat_phase(dev, card)
    _free(dev)
    # phase 29's runs of qwen3-1.7b
    mesh29_on = {
        label: f"remat {label} (qwen3-1.7b 28 layers bf16, SOI pp, B "
               f"{REMAT_B} x S {REMAT_S}, step {REMAT_STEPS} of "
               f"{REMAT_STEPS})"
        for label in ("full", "off", "dots", "names")}
    mesh29_on["long"] = (f"remat full (qwen3-1.7b 28 layers bf16, SOI pp, "
                         f"B {REMAT_LONG_B} x S {REMAT_S}, step "
                         f"{REMAT_STEPS} of {REMAT_STEPS})")
    for key, tag in (("gloo", "on"), ("gloo off", "off")):
        mesh29_on[key] = (f"two gloo ranks on the card, (2, 1) fsdp mesh, "
                          f"qwen3-1.7b {FSDP_QWEN_LAYERS} layers f32, one "
                          f"train step, remat {tag}")
    # phase 27's sharded runs with fsdp and seq_shard
    mesh27_on = {
        "ds serve": f"sharded serve, fsdp + seq_shard (deepseek-v2 4 layers "
                    f"bf16, (1, 1) NCCL mesh, prefill + "
                    f"{FSDP_SP_SERVE_STEPS} steps)",
        "rg serve": f"sharded serve, fsdp + seq_shard (recurrentgemma-9b 38 "
                    f"layers bf16, (1, 1) NCCL mesh, prefill + "
                    f"{FSDP_SP_SERVE_STEPS} steps)",
        "ds train": f"sharded train, fsdp + seq_shard (deepseek-v2 MLA "
                    f"stack 4 layers, (1, 1) NCCL mesh, {DIST_STEPS} steps)",
        "rg train": f"sharded train, fsdp + seq_shard (recurrentgemma-9b 6 "
                    f"layers, (1, 1) NCCL mesh, {DIST_STEPS} steps)",
        "gloo": f"two gloo ranks on the card, f32: recurrentgemma-9b "
                f"({FSDP_RG_LAYERS} layers) prefill + 2 steps and one train "
                f"step on a (1, 2) seq_shard mesh"}
    # launches: each kernel's count on its own path's run — the dense
    # serve (phase 5), the paged prefix-cache serve (phase 6), the
    # deepseek-v2 serve (phase 8), the MLA prefix-cache serve (phase 9),
    # the recurrentgemma serve (phase 11; paged run for lru_scan), and for
    # copy_pages the paged engine whose rings wrap (phase 4: the serve
    # command never wraps, max_len = prompt + generated), and the U-Net's
    # B 1 STMC-baseline stream of 512 frames (phase 13)
    launches = {"decode_attention": ("serve", counts),
                "flash_attention": ("serve", counts),
                "chunk_attention": ("paged serve", paged_counts),
                "paged_decode_attention": ("paged serve", paged_counts),
                "copy_pages": ("paged parity (ring wrap)", cow_counts),
                "mla_chunk_attention": ("mla serve", mla_counts),
                "paged_mla_decode_attention": ("deepseek serve",
                                               ds_counts),
                "lru_scan": ("rg serve (paged)", rg_counts["paged"]),
                "stmc_conv": ("unet stream", unet_counts),
                "flash_attention_bwd": (f"train (qwen3-1.7b dense, "
                                        f"{TRAIN_STEPS} steps)",
                                        train_counts["dense"]),
                "lru_scan_bwd": (f"train families (recurrentgemma-9b, "
                                 f"{FAMILY_STEPS} steps)",
                                 fam_train["recurrentgemma-9b"])}
    # the decode kernels' second path: recurrentgemma's MQA at G 16 / dh 256
    rg_second = {"decode_attention": rg_counts["dense"],
                 "paged_decode_attention": rg_counts["paged"]}
    check(mla_cow_counts["copy_pages"] > 0,
          "copy_pages never ran on the MLA pools")
    summary = []
    for name in KERNEL_META:
        rec = main_recs[name]
        path, cnt = launches[name]
        check(cnt[name] > 0, f"{name} never launched on its path ({path})")
        summary.append({
            "name": name, "route": "cuda", **KERNEL_META[name],
            "launches": cnt[name], "launches_on": path,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"],
            "dtype": rec["dtype"], "ms_unmarked": rec.get("ms_unmarked")})
        families = {}
        for label, arch in FAMILY_OF.items():
            r = main_recs.get(f"{name} ({label})")
            if r is None:
                continue
            n, on = _family_launches(name, arch, fam)
            check(n > 0, f"{name} never launched on {on}")
            families[label] = {key: r[key] for key in (
                "shape", "max_abs_err", "ms", "ms_unmarked", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}
            families[label].update(launches=n, launches_on=on)
        if families:
            summary[-1]["families"] = families
        zoo_rows = {}
        for label in ZOO_OF:
            r = main_recs.get(f"{name} ({label})")
            if r is None:
                continue
            n, on = _zoo_launches(name, label, zoo)
            check(n > 0, f"{name} never launched on {on}")
            zoo_rows[label] = {key: r[key] for key in (
                "shape", "max_abs_err", "ms", "ms_unmarked", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}
            zoo_rows[label].update(launches=n, launches_on=on)
        if zoo_rows:
            summary[-1]["zoo"] = zoo_rows
        if name == "flash_attention":
            # its second path: deepseek-v2's exact-length MLA prefill
            mla = main_recs["flash_attention (MLA)"]
            summary[-1]["mla"] = {
                key: mla[key] for key in ("shape", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")}
            summary[-1]["mla"].update(
                launches=ds_counts["flash_attention"],
                launches_on="deepseek serve")
        if name in rg_second:
            rg = main_recs[name + " (RG)"]
            summary[-1]["rg"] = {
                key: rg[key] for key in ("shape", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")}
            summary[-1]["rg"].update(
                launches=rg_second[name][name],
                launches_on="rg serve (" + ("paged" if "paged" in name
                                            else "dense") + ")")
            check(rg_second[name][name] > 0,
                  f"{name} never launched on the recurrentgemma serve")
        if name in SPEC_PATHS:
            # the speculative windows' run of the same kernel (phase 15)
            run = SPEC_PATHS[name]
            summary[-1]["spec"] = {
                "launches": spec_counts[run][name],
                "launches_on": f"spec serve ({run})"}
        if name in obs_counts:
            # phase 16's run of the same kernel
            cnt_obs, on = obs_counts[name]
            summary[-1]["obs"] = {"launches": cnt_obs[name],
                                  "launches_on": on}
        if name in ("flash_attention", "flash_attention_bwd"):
            # phase 17's training runs (the backward's main path is the
            # dense one above)
            summary[-1]["train"] = {
                run: {"launches": train_counts[run][name],
                      "launches_on": f"train (qwen3-1.7b {run}, "
                                     f"{TRAIN_STEPS} steps)"}
                for run in train_counts}
            # phase 21's sharded step on the (1, 1) NCCL mesh
            summary[-1]["dist"] = {
                "launches": dist_counts[name],
                "launches_on": f"sharded train (qwen3-1.7b pp, (1, 1) NCCL "
                               f"mesh, {DIST_STEPS} steps)"}
            check(dist_counts[name] > 0,
                  f"{name} never launched on the sharded train step")
        if name in ("flash_attention", "flash_attention_bwd", "lru_scan",
                    "lru_scan_bwd"):
            # phase 22's training runs of the families
            summary[-1]["train_families"] = {
                label: {"launches": cnt_f[name],
                        "launches_on": f"train families ({label}, "
                                       f"{FAMILY_STEPS} steps)"}
                for label, cnt_f in fam_train.items() if cnt_f[name]}
        if name in ("flash_attention", "flash_attention_bwd"):
            # phase 23's training runs of the zoo (whisper's: paligemma's
            # and rwkv6's launch none)
            summary[-1]["train_zoo"] = {
                label: {"launches": cnt_z[name],
                        "launches_on": f"train zoo ({label}, "
                                       f"{FAMILY_STEPS} steps)"}
                for label, cnt_z in zoo_train.items() if cnt_z[name]}
            check(zoo_train["whisper-tiny"][name] > 0,
                  f"{name} never launched on whisper-tiny's training")
        if name == "flash_attention_bwd":
            # the shapes phase 23's training gives it, each with its
            # launches there
            summary[-1]["train_zoo_shapes"] = {
                label: {key: r[key] for key in (
                    "shape", "sk", "causal", "max_abs_err", "ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "parts_ms", "useful_tflops", "launches", "launches_on")
                        if key in r}
                for label, r in zoo_bwd.items()}
        if name == "flash_attention_bwd":
            # its second path: deepseek-v2's MLA stack trained (phase 22)
            summary[-1]["mla"] = {key: mla_bwd[key] for key in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "parts_ms", "useful_tflops")}
            summary[-1]["mla"]["shapes"] = [
                {key: r[key] for key in ("shape", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "parts_ms",
                                         "useful_tflops")}
                for r in mla_bwd["shapes"]]
            n_mla = fam_train["deepseek-v2 MLA stack"][name]
            check(n_mla > 0, f"{name} never launched on the MLA stack's "
                             f"training")
            summary[-1]["mla"].update(
                launches=n_mla, launches_on=f"train families (deepseek-v2 "
                                            f"MLA stack, {FAMILY_STEPS} "
                                            f"steps)")
        if name == "lru_scan_bwd":
            summary[-1]["shapes"] = [
                {key: r[key] for key in ("shape", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")}
                for r in rec["shapes"]]
        if name == "flash_attention_bwd":
            # the forward at the training shape (lists: the pairs in
            # turns), the backward's parts, and its other timed shapes
            summary[-1].update({key: rec[key] for key in (
                "fwd_ms", "fwd_lse_ms", "fwd_plain_ms", "fwd_library_ms",
                "fwd_bound_ms", "fwd_bound_by", "parts_ms",
                "useful_tflops")})
            summary[-1]["shapes"] = [
                {key: r[key] for key in ("shape", "max_abs_err", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "parts_ms",
                                         "useful_tflops")}
                for r in rec["shapes"]]
        if name in CHUNK_KERNELS:
            # the same wrapper on the middle's chunk of compressed frames
            mid = main_recs[name + " (middle)"]
            summary[-1]["middle"] = {
                key: mid[key] for key in ("shape", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")}
            summary[-1]["middle"].update(
                launches=cnt[name],
                launches_on=path + ", outer and middle layers")
        if name in ("decode_attention", "flash_attention"):
            # phase 24's sharded prefill + serve steps on the (1, 1) mesh
            summary[-1]["serve_mesh"] = {
                "launches": mesh_counts[name],
                "launches_on": f"sharded serve (qwen3-1.7b pp, (1, 1) NCCL "
                               f"mesh, prefill + {MESH_STEPS} steps)"}
            check(mesh_counts[name] > 0,
                  f"{name} never launched on the sharded serve steps")
        if name in moe_counts:
            # phase 25's sharded olmoe runs on the (1, 1) mesh: (a)'s
            # prefill + serve steps, (b)'s train steps (the backward)
            summary[-1]["moe_mesh"] = {
                "launches": moe_counts[name],
                "launches_on": (
                    f"sharded train ({MOE_ARCH} {MOE_TRAIN_LAYERS} layers, "
                    f"(1, 1) NCCL mesh, {DIST_STEPS} steps)"
                    if name == "flash_attention_bwd" else
                    f"sharded serve ({MOE_ARCH} 16 layers, (1, 1) NCCL "
                    f"mesh, prefill + {MESH_STEPS} steps)")}
            check(moe_counts[name] > 0,
                  f"{name} never launched on the sharded MoE steps")
        if name == "decode_attention":
            # its return_lse: phase 24 (a)'s shard, launched on (c)'s two
            # gloo ranks, every read of a split ring
            summary[-1]["lse"] = dict(mesh_lse, launches=mesh_gloo[name],
                                      launches_on=(
                                          f"sharded serve, two gloo ranks "
                                          f"on the card ((1, 2) mesh, "
                                          f"qwen3-1.7b {MESH_GLOO_LAYERS} "
                                          f"layers f32, {MESH_GLOO_STEPS} "
                                          f"steps)"))
            check(mesh_gloo[name] > 0, "decode_attention's lse never "
                                       "launched on the split rings")
        if name in ("decode_attention", "flash_attention",
                    "flash_attention_bwd", "lru_scan", "lru_scan_bwd"):
            runs = {key: {"launches": mesh26_counts[key][name],
                          "launches_on": on}
                    for key, on in mesh26_on.items()
                    if mesh26_counts[key][name]}
            check(runs, f"{name} never launched on phase 26's sharded runs")
            summary[-1]["mla_rglru_mesh"] = runs
            runs = {key: {"launches": mesh27_counts[key][name],
                          "launches_on": on}
                    for key, on in mesh27_on.items()
                    if mesh27_counts[key].get(name)}
            check(runs, f"{name} never launched on phase 27's sharded runs")
            summary[-1]["fsdp_sp_mesh"] = runs
        if name in ("flash_attention", "flash_attention_bwd"):
            # phase 29's train steps with remat on (the forward launched
            # again by each layer group's recompute) and off
            runs = {key: {"launches": mesh29_counts[key][name],
                          "launches_on": on}
                    for key, on in mesh29_on.items()}
            check(all(r["launches"] for r in runs.values()),
                  f"{name} never launched on a phase 29 run: {runs}")
            summary[-1]["remat"] = runs
        if name in mesh28_shapes:
            # phase 28: the three families' sharded runs, and (0)'s checks
            # at the shapes they give the kernel
            runs = {key: {"launches": mesh28_counts[key][name],
                          "launches_on": on}
                    for key, on in mesh28_on.items()
                    if mesh28_counts[key].get(name)}
            check(runs, f"{name} never launched on phase 28's sharded runs")
            summary[-1]["families_mesh"] = {"runs": runs,
                                            "shapes": mesh28_shapes[name]}
        if name == "decode_attention":
            # the same wrapper on recurrentgemma's compressed middle rings
            mid = main_recs[name + " (RG middle)"]
            summary[-1]["rg_middle"] = {
                key: mid[key] for key in ("shape", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")}
            summary[-1]["rg_middle"].update(
                launches=rg_second[name][name],
                launches_on="rg serve (dense), outer and middle layers")
    print(f"== 30 done in {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
