"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions, and builds every kernel from src/repro_torch/csrc with nvcc
   (one process per source, in parallel) into build/.
2. Kernel phase: each hand-written kernel against its plain PyTorch
   version on the card, at the serving paths' shapes, with the stated
   tolerance; timed with CUDA events beside its plain version, a
   library call where one exists, and its bound on the card, and by the
   profiler (device us per launch; per call for the two-launch paged
   decode).  First the launch floor: the device time of fill_ on a
   1-element tensor.  Flash: bf16 (tensor cores) at S 1, 16, 63, 65, 100,
   300, 512 and D 128, fp32 (CUDA cores) at S 16, 100, 512 and D 128; its
   and SDPA's device time at each prefill bucket.  Paged: decode (C=1,
   split over keys) at the serving positions, on split edges, with -1
   holes, with a masked row and with a full 32-page table; chunks (C>1;
   bf16 on the tensor-core chunk kernel, fp32 on the CUDA-core one) at
   the warm suffix prefill's shape (C=32, one row at 256), at C 8, 32, 64
   with every row at positions off the pages, with holes (one a whole
   64-key tile) and with a masked row; the decode call and the C=32 chunk
   call are timed and reported apart, gather + SDPA beside each.
   Fused kept sync (quantized_psum_absmax, both hops of a quantized
   all-reduce in one launch): bit-identical to its plain version at tp 1,
   2, 4, 9, 16, L 127 and 7, bf16 and fp32, on a decode step's, the
   512-token prefill bucket's, a mamba decode step's and a ragged
   payload; timed at the decode and prefill syncs beside the six-kernel
   chain it replaced (context); and whether sum(dim=0) adds 4 and 8 rows
   left to right.  Past 8 shards (ROADMAP C17): the shard sync's send
   and receive at tp 9 and 16 on the same payloads and the quant8 dry-run
   cell's (8 x 960), bit-identical to their plain versions and the
   receive to the fused sync's row; the fused sync and the receive at tp
   16 on that payload timed (their kernels-line rows); and the tp 2
   device times PERF.md keeps (the fused sync at (2, 3840) and (2, 4096
   x 512), the receive at tp 2 on (1, 3840) and (1, 4096 x 512)) printed
   beside PERF.md's.
3. Dense main path: full-width SmolLM-360M through LLM.load(tp=2,
   spd=0.25, kept syncs and logits gather at quant8, flash prefill) ->
   generate on 4 seeded prompts, 16 greedy tokens each.  Every kernel's
   launch count is zeroed just before and read just after; the dense
   path's kernels must each be > 0; the fused kept sync must launch once
   per quantized kept sync of every forward (56 a dense forward) and qdq
   once per forward (the logits gather).  One more generate with the
   quantized collectives' plain versions swapped in (the fused kept sync,
   B3) must give the same tokens (so on every path below).  A profiled
   generate then shows the device-busy share and the top kernels by
   device time; its prefill must run on the tensor-core flash kernel,
   never on the fp32 one.
4. Paged main path: the same model and settings plus page_size=16 and a
   pool of 40 pages that the 4 requests outgrow at their peak (they need
   41): every request finishes, at least one is preempted, and every page
   comes back; the sync counts hold per forward, as on the dense path.
   Then two prompts sharing a 256-token prefix: the second
   admits warm (a prefix hit) and prefills its suffix through the paged
   kernel at C=32, once per layer.  Launch counts zeroed before and read
   after; every kernel of the path must be > 0.  The same admission (on
   another prefix) under the profiler must run the tensor-core chunk
   kernel once per layer and the fp32 one never.  A profiled paged
   generate follows; its decode must run the split and combine kernels.
4b. Serve phase (obs/, cluster/, launch/serve.py): the serve CLI's
   `main([...])` in this process on the same model and weights (bf16, tp
   2, spd 0.25, quant8 kept syncs and logits gather, 16-token pages, a
   64-page pool a replica, chunked prefill 64, 8 requests, 2 replicas
   behind prefix-affinity, --metrics-json and --trace into a temporary
   directory): every request completes, every page back, the files
   parse with the per-slot, scheduler, cluster and comm tracks; B1 0
   (the chunked prefill takes the plain attention), B2 once a layer of
   every paged forward, the fused sync and B3 per forward, the
   replicas' warm-ups counted; TTFT, TPOT and queue wait from the
   recorder, decode ms a step.  One replica's CLI line beside it (its
   agreement printed: ROADMAP C15).  Then LLM.load(dp_replicas=2,
   router="prefix-affinity") on two shared-prefix pairs, whole prefill:
   obs on and off and one replica give the same tokens bit for bit, B1
   once a layer a prefill, B2 chunks once a layer a warm admission, two
   prefix hits; decode ms with obs on and off.
5. Teacher-forced checks: prefill logits with the flash kernel against
   the plain attention, and one decode step's logits through the paged
   kernel against the dense plain decode, on the same parameters, in
   bf16 and in fp32.
6. Kernel phases of the overlap slice: quantize, dequantize and
   dequant-accumulate against their plain versions bit for bit at the
   ring's slice shapes and two ragged ones (n % 4 != 0, n < 128), and
   the fused residual RMSNorm (on no path)
   against its plain version; each timed (events and profile).
7. Ring phase: ring_quantized_psum, ring_reduce_scatter and
   ring_all_gather over the shard axis at tp 2 and 4 on payloads shaped
   like a kept sync of full-width SmolLM-360M (prefill 4x512 and a
   batch-4 decode step).  The kernel path must equal the plain path bit
   for bit and stay within the quantized ring's error bound; each call
   launches n-1 quantize, n-1 dequant-accumulate and 1 qdq.
8. Overlap path: the dense path's LLM.load arguments plus
   engine="overlap" -> generate; tokens must equal the dense path's,
   the sync counts hold per forward.
   One prefill and one decode step are priced with a LatencyModel of the
   card's NVLink (data sheet) and an assumed launch cost, and
   decode_pipelined over 3 groups must equal serial decode.
9. SSD phase: the Mamba2 chunked-scan kernels against their plain
   version at the mamba path's shapes (32 streams, P 64, N 128, chunk
   256; S 17, 300 and 512) and one off the path (G 4, P 32, N 64, chunk
   100), bf16 and fp32, y and the final state; timed (events and
   profile) beside its plain version and its bound.  A bf16 call must
   launch the three tensor-core kernels (scores, chunk states, output)
   and nothing else; their device time is summed per call and each
   one's share printed.
10. Mamba path: full-width Mamba2-370M (48 layers) through LLM.load(tp=2,
   spd=0.25 -> no drops: one sync per block, kept syncs and logits gather
   at quant8) -> generate on the same 4 prompts, 16 greedy tokens each,
   with every kernel's count zeroed before and read after: ssd_scan must
   launch once per layer per prefill (48 x 4), the fused kept sync 48
   times a forward, qdq once a forward, flash and paged 0.  A profiled
   generate follows; its prefill must run the three tensor-core SSD
   kernels, never the fp32 one.  Then, on the same
   weights with exact syncs, in bf16 and fp32: prefill logits through
   the kernel against the plain scan, and the decode logits after
   teacher-forcing the generated tokens against one exact-length
   prefill of prompt + tokens.
11. The paper's kernel shapes: B1 at head dim 128 and group 1 (16 q
   and 16 kv heads a shard, llama2-7b and opt-6.7b at tp=2) at S 1, 63,
   300, 512 and at groups 2 and 8 (qwen3-1.7b, qwen2-72b) at S 300, bf16
   and fp32, each timed beside its plain version and SDPA; B2's decode
   and chunk calls at D 128, groups 1 and 8 (serving positions, a full
   table, holes); the fused kept sync at (2, 4096) and (2, 4096 x 512);
   B3 alone on the logits gathers (2, 16000) and (2, 25136).
12. llama2-7b at full width on 10 of its 32 layers (d 4096, 6.74 B
   parameters at full depth; PAPER_LAYERS cuts the depth of 12-15, 20,
   its alg1 cut and its shard paths in 22, for the time limit), bf16,
   random weights from seed 0, through LLM.load(tp=2, spd=0.25, quant8
   kept syncs and logits gather, flash prefill): the dense path as in 3
   (counts zeroed before and read after, sync counts, plain-sync tokens,
   a profile), the paged path as in 4 (a preemption and a warm
   admission through the chunk kernel), and the teacher-forced checks of
   5 in bf16 at full width and in fp32 on layers 6-9.
13. Algorithm 1 on llama2-7b: the sensitivity sweep over
   calibration_batches(32000, 4 samples of 128 tokens, 2 batches), 12
   evaluations x 2 batches x 11 layers through B1, and again with the
   plain attention (perplexities within SWEEP_PPL_RTOL); then
   LLM.apply_comm_policy(n_spd=8, tau1, tau2 at the 25th and 75th
   percentiles of the sensitivities) must give a plan with dropped,
   quant8 and exact syncs, and a counted generate under it.
13b. Algorithm 1 with recovery on the same llama2-7b: LLM.apply_spd(
   calib, n_spd=8, tau1, tau2 halfway between the sorted sensitivities of
   the 8 cheapest blocks (2 ISB, 4 SB, 2 ESB), strategies ("ZS", "B2B",
   "HG"), lr 5e-6, 10 epochs): the sweep again, the block inputs
   captured through B1, head grouping for the ESB blocks and
   block-to-block distillation (student and teacher forwards through
   B1, the student's backward through B1's autograd Function) for SB
   and ESB.  B1's launches
   counted part by part against what the code implies; every distilled
   block's loss must fall from its first epoch to its last; each
   grouping a partition of the 32 heads; on full-width layers the
   student's gradients through B1 against the plain attention's (fp32
   and bf16) and the grouped layer's TP output against the ungrouped
   one's (fp32); a counted greedy generate under the distilled plan.
   Prints each part's wall seconds, ms per distill step, the peak
   memory and every block's losses.  B1 at the distill step's shape is
   then checked and timed for the kernels line.
14. opt-6.7b at full width on 10 of its 32 layers (PAPER_LAYERS; LayerNorm,
   learned positions, biases, ReLU)
   through the same LLM.load: the dense path as in 3, a profile, the
   teacher-forced prefill check, and decode logits after teacher-forcing
   its tokens against one exact-length prefill (learned positions read
   at decode positions).  Each 7B model is freed before the next loads;
   each path prints its peak device memory.
15. Self-speculative decoding and chunked prefill on the same llama2-7b
   weights (after 13b; its placements freed, the canonical weights
   kept): the fused kept sync and B3 under autograd (kernel forward,
   identity backward); B2's chunk kernel against its plain version at
   the verify's C 2, 5, 6, 9 (D 128, groups 1 and 8, bf16 and fp32,
   chunks on a page boundary and one before it) and its chain-verify
   call (C 5) timed; then LLM.load(tp=2, spd=0.25, quant8, bf16) serves
   the four prompts plainly and through (a) SpecConfig(k=4, "all-drop")
   dense over chunked prefill (64; its full logits and ledger kept for
   22's speculative path), (b) the same paged on the 40-page pool (a
   preemption; whole prefill), (c)
   the tiered draft from 13's sensitivities, (d) adaptive k 1..6 with
   tree width 2, paged: launch counts as the code implies (B1 per
   whole prefill of the target and the drafter; the fused sync per kept
   sync per forward of each engine, a chunk a forward; B2 chunks per
   chain verify and warm
   suffix prefill; no B2 decode), every page back, each committed
   token the argmax of a teacher-forced plain forward or within 5% of
   its row's largest logit; (e) calibrate_draft over the candidates
   with the sensitivities, on 2 held-out prompts (8 tokens); (f)
   chunked prefill (64) against whole: first-token logits within 5%,
   served tokens under the teacher-forced bound.  In fp32 on
   layers 6-9 at full width: (a), (b) and (d) give plain greedy's tokens
   bit for bit, generate_stream equals generate, an abandoned stream
   holds nothing, chunked prefill gives whole prefill's tokens and
   logits within 1e-3.  Prints acceptance, tokens per round, decode ms
   per token against plain, prefill ms chunked against whole, the
   calibrated winner and its trials, and peak memory.
16. Training: SmolLM-360M at full width and 3 of its 32 layers (bf16,
   random weights from seed 0) through the train CLI's
   make_trainer on the simulated (data 2, model 2) mesh, plan
   first_k(3, 1), sequence 4096, batch 8 in 4 microbatches of 2, remat,
   q_chunk 2048, lr 1e-3 (cosine, 2 warm-up steps), clip 1.0, weight
   decay 0.1, the batches of make_batch_iterator(49152, 8, 4096, seed=0):
   (a) ZeRO-1 for 12 steps with every kernel's count zeroed before and
   read after (B1 must launch 2 x 3 layers x 4 microbatches a step,
   forward and remat recompute under autograd; nothing else), the loss
   must fall (mean of the last 4 below the first 4); step ms, tokens/s,
   MFU (formula printed), peak memory; one more step under the profiler
   (device-busy ms, idle share, top operations); (b) checkpoints every 4
   steps and a fault at step 6 of 8: resumed from step 4, the replayed
   steps' losses equal to 1e-6 relative, each save's and the
   restore's seconds and bytes; (c) FSDP's first 4 losses equal (a)'s
   to 2e-4; (d) every kept sync at quant8 for 3 steps: the fused kept
   sync under autograd launches once per kept sync of the forward and
   once per kept block's attention sync of the remat recompute (it
   stops before the MLP sync) a microbatch, losses within 1e-3 of (a)'s,
   one step's ledger names the quantized hops, and the fused kept sync
   at the path's payload (2, 2 x 4096 x 960) bf16 equals its plain
   version bit for bit; (e) fp32 (batch 2 x 1024): 2
   steps with B1 and 2 with the plain attention, loss and grad norm
   within 1e-4, parameters within the sign-aware bound; then 2 fp32
   steps of the 2-layer cut (batch 4 x 512) that 22 (c) trains on its
   ranks.  Then B1 at the
   train shape q (36, 4096, 64) in fp32 and bf16 against its plain
   version, every output row within a relative L2 bound, and the bf16
   call timed beside SDPA.
16f. The families' training on the same simulated mesh (ROADMAP A3):
   mamba2-370m (48 layers), qwen2-moe-a2.7b (2 layers), deepseek-v2-
   lite-16b (2: the dense layer 0 and a MoE layer) and hymba-1.5b (32,
   its global layer 0 among them), each at full width through
   make_trainer, bf16, random weights from seed 0, ZeRO-1, half the
   blocks dropped (mamba2 none), every kept sync at quant8, sequence 512,
   batch 4 in 2 microbatches, remat: 3 steps with every kernel counted
   (B8 once an SSM or hybrid layer a microbatch in the forward and again
   in the remat recompute, B1 as in 16, the fused kept sync once a
   quantized kept sync of the forward and of the recompute's attention
   syncs, nothing else), each step's loss (with the MoE aux), aux, grad
   norm and ms, the peak memory; then each family's fp32 cut (2 layers,
   qwen2-moe 1; batch 2 x 256), at quant8 and at exact kept syncs: 2
   steps with the kernels and 2 with their plain versions, the MoE
   routing replayed (TrainRoutePin): step 1's loss and grad norm within
   1e-4 and its gradients leaf by leaf within FAMILY_CUT_GRAD_L2, their
   sign disagreements counted; with exact syncs step 2 within 1e-4 and
   the params after within FAMILY_CUT_PAST.  Then B8 under autograd at
   mamba2's and hymba's train shapes (x (4, 512, 16 | 15, 64)), bf16:
   the forward (the kernel) and the backward (the plain VJP) against the
   plain version differentiated directly within the relative L2 bounds
   B8_FWD_L2 and B8_GRAD_L2, the forward, the backward and the plain
   forward timed (kernels-line rows "B8 under autograd").
17. The MoE and hybrid families' kernel shapes: B8 at hymba-1.5b's
   prefill (x (2, S, 15, 64), N 16, one group, chunk 256; S 300 and
   1100) in bf16 and fp32, B1 at qwen2-moe-a2.7b's (q (16, 512, 128)),
   the fused kept sync at (2, 2048) and (2, 1600), B3 on (2, 75968) and
   (2, 16001); each against its plain version and timed.
18. qwen2-moe-a2.7b at full width on 8 of its 24 layers (d 2048, 60
   routed + 4 shared experts, top-4, 14.3 B parameters at full depth;
   FAMILY_LAYERS cuts the depth of 18, 19, 21 and their shard paths in
   22, for the time limit), bf16, random weights from seed
   0, through the same LLM.load: the dense path as in 3 (B1 8 x 4, the
   fused sync per kept sync and forward, qdq 1), a profile; the dense
   placement freed, the paged path as in 4; the teacher-forced checks of
   5 in bf16 at full width and fp32 on layers 4-7, the MoE routing of the
   kernel's forward replayed in the plain one (RoutePin).  Then
   Algorithm 1 on the same weights (family_alg1): the sweep,
   apply_comm_policy (n_spd = L // 4, at least 3; tau1 and tau2 at the
   25th and 75th percentiles: dropped, quant8 and exact syncs), its plan
   served, then apply_spd ("ZS", "B2B", "HG"; one block a tier, 4
   epochs) with B1 counted by part (sweep, capture, distillation) and
   each part's wall seconds, the groupings the identity on MoE layers,
   its plan served; each served plan's greedy tokens equal to a rerun
   on the quantized collectives' plain versions.
19. hymba-1.5b at full width on 8 of its 32 layers (d 1600, 25
   attention and 25 SSM heads, a 1024-token window but on layer 0) on
   dense caches (cache_len 2048): prompts of 17, 64, 200 and 1100
   tokens at their own length, 16 greedy tokens each; B8 8 x 4, the
   fused sync per kept sync and forward, qdq 1, B1 and B2 0; plain-sync tokens; a profile; then
   as in 10 in bf16 and fp32 on the 1100-token prompt (its decode runs
   on the windowed layers' rolling buffers); then paged through the
   gather -> dense -> scatter fallback (16-token pages, a pool of 512
   pages: the global layers' K/V paged, the windowed K/V, SSM state and
   conv tails dense per slot): the dense tokens, B8 32.  Then
   Algorithm 1 as in 18 (B8 in every evaluation; the groupings the
   identity on hybrid layers).
20. llama2-7b's int8 variants on its canonical weights (after 15, the
   llama placements freed): kv_dtype="int8", then int8 KV and
   weight_dtype="int8": the dense path as in 3 (B1 128, the syncs as
   held, no B2 or B8), plain-sync tokens, a profile (device-busy ms),
   the teacher-forced logits (prefill and 15 decode steps) against the
   bf16 path of the same weights within TF_INT8_REL, and the paged path
   through the fallback: on a 128-page pool the dense tokens, on the
   40-page pool a preemption and every page back.
21. deepseek-v2-lite-16b at full width on 9 of its 27 layers (d 2048,
   MLA with 16 heads (8 a shard) and a 512-wide latent, 64 routed + 2
   shared experts, top-6, a dense first layer; 15.71 B parameters at
   full depth), bf16,
   random weights from seed 0) through the same LLM.load: the dense
   path as in 3 (the fused sync per kept sync and forward, qdq 19, B1,
   B2 and B8 0: MLA's prefill takes the plain attention, as the
   reference's), a profile; the dense placement freed, paged through
   the fallback as in 20 (the latent and rope key paged); then the
   absorbed decode against one exact-length prefill with routing pinned
   token by token (a capacity that holds every assignment), fp32 on
   layers 5-8 and bf16 at full width.  Before it, B3 alone on
   deepseek's logits gather (2, 51200).  Then Algorithm 1 as in 18 (no
   B1: MLA's prefill takes the plain attention), and the dense MLA
   layer 0 grouped one head a unit on its captured block input: a
   partition of the 16 heads over the two shards (supported).
21f. The modality frontends (ROADMAP A4): internvl2-1b (24 layers, d
   896, GQA 14/2 heads of 64, a 256 x 1024 vision prefix, vocab 151655)
   and musicgen-medium (48 layers, d 1536, MHA 24 heads, LayerNorm,
   GELU, biases, a 64 x 768 audio prefix, vocab 2048) at full width and
   depth, bf16, random weights from seed 0.  First the kernels at their
   shapes: B1 at each frontend prefill (q (56, 556, 64) on kv (8, 556,
   64): group 7; q (96, 364, 64): group 1) in fp32 and bf16 against its
   plain version, timed beside SDPA; the fused kept sync at (2, 896)
   and (2, 1536) and B3 on (2, 75828) and (2, 1024), bit for bit.  Then
   each model through LLM.load(tp=2, spd=0.25, quant8 kept syncs and
   logits gather): the text-only dense path as in 3, then a frontend
   prefill through Engine.prefill(embeds=) of the four prompts behind
   seeded embeds (a 1024-slot buffer: internvl's prefix and the longest
   prompt take 572) and 16 greedy decode steps at Flen + lengths: B1
   once a layer, the fused sync once a quantized kept sync and forward,
   B3 once a forward, and the run with the quantized collectives' plain
   versions equal to it bit for bit, tokens and logits; its fp32 cut on
   layers 0-3 (exact syncs): the frontend prefill's logits with B1
   against the plain attention within TF_FP32_ATOL.  Sim serves 22
   (b)'s musicgen cut (FRONT_SHARD_LAYERS).  Then each model's training
   at 2 layers, full width, through make_trainer at 16f's settings with
   the trainer's embeds (B1 under autograd, counted), and its fp32 cut
   at exact kept syncs against the plain versions (cut_pair: step 1
   within 1e-4, every gradient leaf, `front`'s printed, within 1e-4
   relative L2).
22. The shard engine (one process per TP shard, launch.dist.spawn):
   (a) NCCL at the card count, one rank a card, tp = min(cards, 4): on
   one card a world of 1 on purpose (tp 1, no wire), and it says so;
   llama2-7b at full width through LLM.load(engine="shard") must give
   the tokens of sim at the same tp on the same weights, each rank's
   kept-sync kernels counted; with two or more cards one kept sync's
   bf16 all-reduce is timed on the wire (CUDA events on rank 0) at the
   decode and prefill payloads.  (b) Two ranks on card 0 over gloo
   (NCCL refuses two ranks on one card): SmolLM-360M dense, then paged
   (the 40-page pool with a preemption, the 256-token prefix admitted
   warm), then llama2-7b dense, each at full width with the main path's
   settings, against the sim runs above (3, 4, 12): the same tokens on
   both ranks; every logits tensor the run decides tokens by (each
   prefill's, each greedy step's shard logits) within 5% of its largest
   |sim logit| of sim's, event by event, up to the first whose argmax
   parts, and there sim's top-2 margin within twice that (sim multiplies
   its stacked shards in one batched cuBLAS call, a rank its one shard
   alone: cuBLAS picks its algorithm by the batch count, so the bits can
   differ; no parting, the tokens equal sim's); rank 0's ledger equals
   sim's entry for entry, and on
   every rank B1 launches as on sim, B2 on the paged path, and per
   quantized kept sync of every forward the send kernel
   (quantize_message_absmax) once and the receive kernel
   (reduce_messages_absmax) once, B4 and B6 never, B3 once a forward
   (the logits gather); every rank checks at each step that the other
   took the same tokens.  Prints decode_ms_per_token and prefill_ms of
   a host-staged wire and each rank's llama peak memory (the canonical
   weights drawn on the card and kept on the host).  In the same spawn,
   on the llama2-7b placement: the speculative path, 15 (a)'s settings
   (all-drop chain, k 4, dense, chunks of 64): the same tokens on both
   ranks, every full logits tensor (chunk, draft step, verify) against
   15 (a)'s within the same bound up to the first argmax that parts,
   then the tokens and the ledger equal to sim's unless one parted, the
   ledger of the first draft call and the first verify equal to sim's
   either way, each committed token the argmax of a teacher-forced plain
   forward on the rank or within 5% of its row's largest logit; the
   send and receive kernels once a quantized kept sync of every forward
   (the target's: the all-drop draft keeps its syncs exact), B3 a
   target forward, B1 never (the prefill is chunked, the drafter
   adopts it); prints acceptance, rounds, spec against plain
   decode_ms_per_token (the rank's own plain llama run) beside 15 (a)'s
   ratio, and rank 0's ledger entries of a draft and a target forward.
   Then Algorithm 1 on the ranks (PR 28), on sweep_phase's calibration
   batches: LLM.apply_comm_policy at 13's thresholds and LLM.apply_spd
   at 14's (every rank checks inside that all reached one plan and
   ranking): the perplexities against 13's sweep, the tiers equal to
   sim's on every block further from a threshold than twice the
   perplexities' largest difference; the tiered plan (sim's, should the
   ranks' part at a near-tie) and the distilled plan served and held to
   sim's runs of them under the dense paths' logits bound (the distilled
   plan's when the ranks reached sim's tiers), the recovery's B1
   launches as 14's, every distilled block's loss falling; the wall
   seconds beside sim's; then the fp32 cut of llama2-7b's layers 6-9 at
   full width: its tiered plan equal to sim's (alg1_cut, after 20), its
   perplexities and sensitivities within ALG1_CUT_RTOL.  Then llama2-7b
   with int8 KV and weights on the same canonical weights against 20's
   run.  A second gloo spawn serves the families at full
   width, one model at a time, each with its sim run's settings:
   mamba2-370m (10) and hymba-1.5b (19) dense, qwen2-moe-a2.7b (18)
   dense and paged (the 40-page pool with a preemption, the warm prefix
   pair), deepseek-v2-lite-16b (21) dense and paged through the fallback
   (a 128-page pool): the same tokens on both ranks, rank 0's ledger
   equal to sim's, the kernels counted as on the paths above (B1, B2
   and B8 as on sim: B8 8 x 4 on hymba, 48 x 4 on mamba2, one shard a
   rank), each rank's load time, decode ms a token, card peak and host
   memory printed as it loads.  Each bf16 path is served a second time
   with the quantized collectives' plain versions on both ranks: tokens
   and every logits event equal to the kernels' run bit for bit.  Their
   bf16 logits are not held to sim's: a near-tied MoE routing choice or
   the SSM state carries one product's rounding (a lone shard against
   sim's batched call) past the 5% bound.  Each family is held to sim
   instead in fp32, at full width on four of its layers with SHARD_KW's
   quant8 kept syncs and logits gather (SHARD_FP32_LAYERS, served by sim
   in 10, 18, 19 and 21), so that the send, receive and B3 kernels run at
   the family's width, and the MoE routing pinned to sim's run (a
   flipped code can flip a near-tied top-k choice): the same tokens on
   both ranks and the logits within the 5% bound of sim's up to the
   first argmax that parts.  In the same spawn, on hymba's weights,
   apply_comm_policy at 19's n_spd and thresholds (B8 in every
   evaluation of the sweep, on each rank's shard): the same plan and
   ranking on both ranks, the perplexities within SWEEP_PPL_RTOL of
   19's, the tiers 19's wherever the perplexities' spread cannot move
   them (the plan 19's, or parted only at such a near-tie), the wall
   seconds beside sim's; then apply_spd at 19's recovery thresholds:
   the same plan on both ranks, its distillation through B8's autograd
   Function (its forward the kernel) once a step of each distilled
   hybrid block on each rank, finite losses.  Last in that spawn,
   musicgen-medium's 8-layer cut (21f) serves 21f's frontend prefill
   and decode on both ranks (embeds whole on each model rank, `front`
   replicated): the same tokens on both ranks, B1 once a layer and the
   send and receive kernels once a kept sync and forward, every logits
   tensor within the 5% bound of sim's up to the first argmax that
   parts.  (c) Four ranks on card 0 over gloo (tp 2 x
   dp 2, PR 28) train 16's model through make_trainer(engine="shard")
   at 16's settings: ZeRO-1 for SHARD_TRAIN_STEPS steps, timed (ms a
   step, tokens/s of a host-staged wire); a fault before step 4 and the
   resume from the step-2 checkpoint (gathered to rank 0, which writes),
   its final state bit for bit the uninterrupted run's on every rank;
   FSDP and quant8 for 2 steps each; the fp32 cut of 2 layers (batch 4
   x 512) against sim's run of it in 16: the same losses and grad norms
   on every rank, step 1's loss within SHARD_TRAIN_LOSS_RTOL of 16 (a)'s,
   FSDP's within TRAJ_RTOL of ZeRO-1's, quant8's within QUANT_LOSS_RTOL,
   the cut within SHARD_TRAIN_CUT_RTOL; then qwen2-moe at 16f's depth
   and settings for 2 ZeRO-1 steps (each rank routing its own data
   slot's rows), step 1's loss within SHARD_TRAIN_LOSS_RTOL of 16f's sim
   run, B1 as on sim and the send and receive kernels where sim launches
   the fused sync, on every rank; B1 on every rank 2 x layers x
   microbatches x steps, and on the quant8 steps the send and receive
   kernels once a quantized kept sync and microbatch (the remat
   recompute re-runs the attention syncs).  Then the send and receive kernels at one rank's
   SmolLM-360M and LLaMA2-7B decode and prefill payloads and the
   families' decode payloads and hymba's 17-token prefill (a ragged last
   chunk), bf16, two ranks' messages made on the card: bit for bit
   against their plain versions and against the chain of one sync they
   replaced (cast, B4, cat, stack, copies, zeros, B6 x 2, B3, cast),
   timed beside both (their kernels-line rows; the chain as context),
   and the old B4 and B6 wrappers and torch.addcmul timed at
   the SmolLM shapes.
23. Dry-run phase (launch/dryrun.py, after the SmolLM and mamba paths;
   its CLI runs start before the kernels' build, run on the host beside
   it, and are waited for before the first timed phase, so that no
   host-timed figure is taken beside them): (a) `python -m repro_torch.launch.dryrun` on
   the meta device for DRYRUN_CELLS (the reference test's two cells, a
   train_4k cell, the grounding cell and the quant8 cell of (d)), each
   record's keys and wall
   seconds printed; (b) the grounding cell (SmolLM-360M, prefill_32k,
   the 16x16 mesh, spd 0.7) run for real on sim: one data rank's share,
   2 rows x 32768 tokens, 16 model shards on the card, bf16, B1 on every
   layer: its ledger equal to the meta record's bit for bit, the card's
   peak (max_memory_allocated) beside the count's 16 x (argument_bytes +
   temp_bytes), the counted FLOPs over the wall time as a share of the
   card's bf16 peak, with the padded heads' work and without it (the
   same rows counted at tp 1), B1 once a layer; then B1 at that shape, q (64,
   32768, 64) kv (32, 32768, 64), against its plain version run one
   1024-query chunk at a time (every row, the FLASH_ROW_RTOL bound),
   timed beside the chunked plain version and SDPA (its kernels-line
   row); (c) the decode_32k cell's data-rank share (8 rows against a
   32768-slot cache, 16 shards) the same way when the count says it
   fits in the card's memory; (d) the quant8 cell (SmolLM-360M
   decode_32k on the 16x16 mesh at spd 0.7, every kept sync quantized:
   `--comm quant8`) the same way: its ledger equal to the meta record's
   bit for bit, the fused kept sync launched at tp 16 once a quantized
   kept sync of the plan, and the next ids and the K/V the step wrote
   equal bit for bit to a rerun with the quantized collectives' plain
   versions.
24. Prints the seconds since the build at the end of each part, the
   kernels JSON line (the rows above beside the earlier ones), the card
   line, and last {"ok": true, "device": {...}}.

Any failure raises (non-zero exit, no result line).  Without a CUDA
device it exits non-zero at once.  Weights are random, from a seed.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# card peaks for the bound (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

FLASH_SHAPES = (16, 100, 512)          # S; q (2*1*9, S, 64), kv (2*1*3, S, 64)
# bf16 only (the tensor-core kernel): one query, both sides of a 64-row
# tile edge, a ragged 300; and one D = 128 case (fp32 too) at S = 200
FLASH_BF16_SHAPES = (1, 63, 65, 300)
FLASH_D128_S = 200
# the prefill buckets of PROMPT_LENS (17, 64, 200, 300): kernel and SDPA
# device time at each
FLASH_BUCKETS = (32, 64, 256, 512)
FLASH_FP32_ATOL = 2e-5                 # fp32 online vs one-shot softmax
QDQ_NS = (960, 3840, 16 * 960, 24576)  # (2, N) payloads; bit-identical
# the fused kept sync (tp, N): a batch-4 decode step's (4 x 960), the
# 512-token prefill bucket's (512 x 960), a mamba decode step's
# (4 x 1024) and a ragged N; bit-identical to its plain version
QPSUM_TPS = (1, 2, 4, 9, 16)              # 9, 16: rows streamed in groups
QPSUM_NS = (3840, 512 * 960, 4 * 1024, 1001)
QPSUM_TIMED = ((2, 3840), (2, 512 * 960))   # decode, prefill; bf16 L=127
QPSUM_SUM_TPS = (4, 8)                 # rows where sum(dim=0)'s order is read
# the send and receive past 8 ranks, and the two kernels at tp 16 on the
# quant8 dry-run cell's payload (SmolLM-360M decode_32k at 16 x 16: 8
# rows of d 960 a data rank); both are checked on QPSUM_NS and WIDE_N
WIDE_TPS = (9, 16)
WIDE_N = 8 * 960
# the tp 2 device times (us) the widened kernels keep, as PERF.md §6 has
# them (H100 80GB HBM3 at 700 W; PR 19 run A, PR 26 run B)
WIDE_KEPT_US = ((("quantized_psum_absmax", 2, 3840), 2.09),
                (("quantized_psum_absmax", 2, 4096 * 512), 8.38),
                (("reduce_messages_absmax", 2, 3840), 1.446),
                (("reduce_messages_absmax", 2, 4096 * 512), 5.466))
PROMPT_LENS = (17, 64, 200, 300)
MAX_NEW = 16
# paged serving: 16-token pages; the 4 requests need 41 pages at their
# peak, so a 40-page pool must preempt
PAGE_SIZE = 16
NUM_PAGES = 40
PREFIX_LEN = 256                       # shared prefix of the warm pair
# paged kernel shapes: q (2, 4, C, 9, 64) against one layer of a
# (2, 32, P+1, 16, 3, 64) pool leaf, table bucketed to 32 pages
PAGED_POS = (16, 80, 216, 316)
PAGED_PHYS = 96
# more decode (C=1) cases for the split-over-keys kernel (64 keys a
# split): positions on split edges, -1 holes inside two tables, and a
# full 32-page table at position 511
PAGED_EDGE_POS = (63, 64, 127, 128)
PAGED_HOLES = ((2, 5), (3, 10))        # (row, page) set to -1
PAGED_FULL_POS = (511, 16, 80, 216)
# chunk (C > 1) cases beside the warm suffix prefill's shape: every row
# live at positions off the 16-key pages, C in PAGED_CHUNK_CS (and C = 8
# at the other head dims of PAGED_CHUNK_DS); C = 32 with holes (pages 4-7
# of row 0 are a whole 64-key tile of -1) and with a masked row
PAGED_CHUNK_POS = (250, 3, 117, 250)
PAGED_CHUNK_CS = (8, 32, 64)
PAGED_CHUNK_DS = (16, 32, 128)
PAGED_CHUNK_HOLES = PAGED_HOLES + ((0, 4), (0, 5), (0, 6), (0, 7))
# chunk cases at other table widths, (C, positions, holes, pages): 128
# and 64 pages (a split walks 4 and 2 key tiles, its cp.async ring past
# its first tile; with holes, tile 5 of row 0, the second of split 1, is
# all -1), and 24, 16 and 8 pages (clusters of 6, 4 and 2 blocks)
PAGED_CHUNK_WIDTHS = (
    (32, (1001, 3, 517, 1000), (), 128),
    (32, (1001, 3, 517, 1000),
     ((0, 20), (0, 21), (0, 22), (0, 23), (3, 40), (2, 1)), 128),
    (8, (1001, 250, 3, 700), (), 64),
    (16, (300, 3, 117, 250), (), 24),
    (32, (200, 3, 117, 90), (), 16),
    (8, (100, 3, 50, 117), (), 8))
# prefill logits, flash kernel vs plain attention through 32 layers
# (exact syncs): bf16 rounds each layer's attention output differently
# (2^-8 relative per layer), fp32 only reorders sums.  The same bound
# holds the shard engine's logits to sim's (shard phase (b)): another
# cuBLAS algorithm rounds each bf16 product differently
TF_BF16_REL = 0.05                     # x max |logit|
TF_FP32_ATOL = 1e-3
# one decode step, paged kernel vs dense plain decode attention, after
# the same prefill: the same reasons and limits as the prefill check

# (rows, n) ring slices: a batch-4 decode step's kept sync (4*960 / 2),
# a 4x512 prefill's (4*512*960 / 2) at tp=2 and (/ 4) at tp=4
QUANT_SHAPES = ((2, 1920), (2, 983040), (4, 491520), (2, 1001), (3, 77))
QUANT_TIMED = (2, 983040)
# the ring's kernels by the names the profiler shows
QUANT_KERNELS = ("quant_kernel", "dequant_kernel", "dequant_accum_kernel")
# fused residual RMSNorm: a 4x512 prefill's rows and a decode step's;
# fp32 differs by summation order only, bf16 by one rounding of y
NORM_SHAPES = ((2048, 960), (4, 960))
NORM_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
RING_TPS = (2, 4)
# ring_reduce_scatter adds the n shards in ring order, psum in index
# order: fp32 reordering of sums of 4 N(0,1) values
RING_RS_ATOL = 1e-5
# the priced interconnect: NVLink 4 on the H100 SXM, 900 GB/s total,
# 450 GB/s each way (NVIDIA data sheet); the launch cost of one
# collective is ASSUMED (not measured: the port has no NCCL path yet)
NVLINK_BYTES_PER_S = 450e9
ASSUMED_LAUNCH_US = 5.0
PIPE_GROUPS = 3
# SSD scan: tp 2 x 1 request = 2 batch rows of 16 heads (32 streams) of
# Mamba2-370M, P 64, N 128, one group, chunk 256; S shorter than a chunk,
# ragged over two chunks, and two whole chunks
SSD_SHAPE = dict(bt=2, h=16, p=64, n=128, g=1, chunk=256)
SSD_SEQS = (17, 300, 512)
SSD_TIMED_S = 300
# and one shape off the path, for what the wrapper also takes: 4 groups
# of 4 heads, a chunk (100) that is no multiple of the 64-row tile, P 32
SSD_OFF_PATH = dict(bt=2, h=16, p=32, n=64, g=4, chunk=100)
# fp32 y and state (and the bf16 run's state, fp32 in both): the kernel
# and the plain chunked form differ by summation order only, measured at
# 2e-6 to 3e-6 of the largest value on the H100, so 2e-5 (a 7x
# margin).  bf16 y: both round fp32 sums to
# bf16 once, so one bf16 step of the largest |y| covers a rounding flip
SSD_FP32_REL = 2e-5
SSD_BF16_Y_REL = 2.0 ** -7
SSD_BF16_STATE_REL = 2e-5
# the paper's models (llama2-7b, opt-6.7b) at tp=2: head dim 128, 16 q
# and 16 kv heads a shard (group 1); B1 also at the group of qwen3-1.7b
# (8 q / 4 kv a shard) and qwen2-72b (32 q / 4 kv), whose full widths
# are not served here (qwen2-72b is 145 GB in bf16)
PAPER_FLASH_SEQS = (1, 63, 300, 512)
PAPER_FLASH_GROUPS = (("llama2-7b/opt-6.7b", 16, 16), ("qwen3-1.7b", 8, 4),
                      ("qwen2-72b", 32, 4))
PAPER_GROUPS_S = 300
# B2 at D 128, groups 1 and 8: (C, positions, holes) -- decode at the
# serving positions (timed), on a full table, with holes; the warm
# suffix prefill's chunk (timed), every row live, with holes
PAPER_PAGED_HEADS = ((16, 16), (32, 4))
PAPER_PAGED_CASES = ((1, None, ()), (1, PAGED_FULL_POS, ()),
                     (1, None, PAGED_HOLES), (32, None, ()),
                     (32, PAGED_CHUNK_POS, ()),
                     (32, PAGED_CHUNK_POS, PAGED_CHUNK_HOLES))
# (tp, n) of llama2-7b's kept syncs at d 4096: one decode token's and
# the 512-token prefill bucket's
PAPER_QPSUM = ((2, 4096), (2, 4096 * 512))
# the logits gathers: llama's 32000 and OPT's 50272 vocab at tp=2
PAPER_QDQ = ((2, 16000), (2, 25136))
# Algorithm 1 on llama2-7b: 4 calibration samples of 128 tokens in 2
# batches; a budget of 8 dropped syncs (spd=0.25)
SWEEP_CALIB = dict(n_samples=4, seq=128, batch=2)
N_SPD = 8
# the sweep's perplexities with the flash kernel against the plain
# attention, bf16: the two round the attention output differently (P in
# bf16 on the tensor cores against an fp32 softmax) and the difference
# grows through 32 layers.  The teacher-forced gate lets one logit move
# by 5% of the largest (~0.2 nats here, 20% of a one-token perplexity);
# a perplexity is exp of the mean CE over 256 tokens whose errors take
# either sign, so 1% relative (2.1e-3 measured on an H100 at 700 W)
SWEEP_PPL_RTOL = 1e-2
# Algorithm 1 with recovery on llama2-7b: the paper's 10 epochs over the
# sweep's 2 calibration batches, 20 distill steps a recovered block, at
# lr 5e-6.  On these random weights a block's SPD-vs-TP MSE starts at
# 3e-4 to 1e-3, and Adam's first steps at the default 5e-5 (about lr per
# element whatever the gradient's scale) throw it up 60-330x; it had not
# come back below its first epoch after 10 (scripts/
# torch_distill_probe.py on an H100: last / first epoch 1.06-7.0 at
# 5e-5, 0.36-2.1 at 2e-5, 0.13-0.64 at 1e-5, 0.13-0.18 at 5e-6)
RECOVERY_EPOCHS = 10
RECOVERY_LR = 5e-6
# the student's gradients through B1's autograd Function against those
# through the plain attention, one full-width layer, relative global
# norm: fp32 differs only in summation order.  bf16 differs in the
# forward (B1 rounds P to bf16 on the tensor cores, the plain version
# takes an fp32 softmax), and the MSE's gradient is 2 (out_s - out_t), a
# difference of two outputs that agree to a few bf16 ulps of the
# residual stream: so the bound is 5% of the gradient's norm
RECOVERY_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
# the grouping permutation's TP-mode block output (the reference's bound
# in tests/test_spd_pipeline.py: the head sum reassociates)
GROUPING_TP_RTOL = 1e-3
# the fp32 teacher-forced checks of the 7B models keep layers 6-9 (two
# dropped and two kept blocks of the spd=0.25 plan): a full-width fp32
# copy is 27 GB
TF_FP32_LAYERS = (6, 10)
# bf16 model-level checks on the mamba path: at most twice the spread of
# the same comparison made without the kernel (see mamba_checks)
MAMBA_BF16_FLOOR = 2.0
# self-speculative decoding on llama2-7b: drafts a round; chunked
# prefill's chunk; calibration's held-out prompts and their decode budget
SPEC_K = 4
SPEC_CHUNK = 64
SPEC_CALIB_LENS = (40, 24)
SPEC_CALIB_NEW = 8
# B2's chunk kernel at the verify chunk's small C (k + 1 for k 1..8),
# chunks starting on a page boundary and one position before it
VERIFY_CS = (2, 5, 6, 9)
VERIFY_POS = ((64, 16, 320, 128), (63, 15, 319, 127))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(torch, fn, iters=50, warmup=5) -> float:
    """Mean device time of fn over `iters` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(torch, q, k, v, bhkv):
    """One PyTorch call computing the flash kernel's function (causal GQA
    SDPA) on its inputs, as a yardstick; the port never calls it."""
    import torch.nn.functional as F
    bh, s, d = q.shape
    g = bh // bhkv
    q4 = q.view(2, bh // 2, s, d)
    k4, v4 = k.view(2, bhkv // 2, s, d), v.view(2, bhkv // 2, s, d)
    try:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, is_causal=True, enable_gqa=True)
        lib()
    except TypeError:                  # torch without enable_gqa
        k4r, v4r = k4.repeat_interleave(g, 1), v4.repeat_interleave(g, 1)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4r, v4r, is_causal=True)
    return lib


def flash_inputs(torch, gen, s, d, dtype, bh=2 * 1 * 9, bhkv=2 * 1 * 3):
    dev = torch.device("cuda")
    return [torch.randn(n, s, d, generator=gen, device=dev).to(dtype)
            for n in (bh, bhkv, bhkv)]


def flash_phase(torch):
    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    bh, bhkv, d = 2 * 1 * 9, 2 * 1 * 3, 64
    timed = None
    cases = ([(torch.bfloat16, s, d) for s in sorted(
        FLASH_SHAPES + FLASH_BF16_SHAPES)]
        + [(torch.float32, s, d) for s in FLASH_SHAPES]
        + [(dt, FLASH_D128_S, 128) for dt in (torch.bfloat16, torch.float32)])
    for dtype, s, dd in cases:
        q, k, v = flash_inputs(torch, gen, s, dd, dtype)
        out = FA.flash_attention_bhsd(q, k, v)
        ref = FA.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = (FLASH_FP32_ATOL if dtype == torch.float32 else
               2.0 ** -7 * max(ref.float().abs().max().item(), 1e-3))
        print(f"flash {str(dtype)[6:]} S={s} D={dd}: max_abs_err={err:.3e} "
              f"tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"flash kernel disagrees at {dtype} "
                                 f"S={s} D={dd}: {err} > {tol}")
        if dtype == torch.bfloat16 and s == max(FLASH_SHAPES):
            timed = (q, k, v, err)
    q, k, v, err = timed
    s = q.shape[1]
    ms = cuda_ms(torch, lambda: FA.flash_attention_bhsd(q, k, v))
    plain_ms = cuda_ms(torch, lambda: FA.flash_attention_plain(q, k, v))
    library_ms = cuda_ms(torch, sdpa_call(torch, q, k, v, bhkv))
    # device time per call at each prefill bucket, the kernel's and SDPA's
    buckets = {}
    for sb in FLASH_BUCKETS:
        qb, kb, vb = (q, k, v) if sb == s else flash_inputs(
            torch, gen, sb, d, torch.bfloat16)
        kern = device_us(torch, lambda: FA.flash_attention_bhsd(qb, kb, vb),
                         ("flash_fwd_tc_kernel", "flash_fwd_kernel"),
                         need=("flash_fwd_tc_kernel",))
        if kern["flash_fwd_kernel"] is not None:
            raise AssertionError("a bf16 call reached the fp32 CUDA-core "
                                 "flash kernel")
        lib_us, lib_names = device_total_us(
            torch, sdpa_call(torch, qb, kb, vb, bhkv))
        buckets[sb] = (kern["flash_fwd_tc_kernel"], lib_us)
        print(f"flash bf16 q ({bh},{sb},{d}) [device us per call]: "
              f"flash_fwd_tc_kernel={kern['flash_fwd_tc_kernel']} "
              f"SDPA={lib_us:.2f} ({', '.join(lib_names)[:120]})")
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4.0 * bh * (s * (s + 1) / 2) * d   # QK^T and PV, causal half
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    dev_us, lib_dev_us = buckets[s]
    print(f"flash_attention_bhsd (S={s}, bf16): ms={ms:.5f} plain_ms="
          f"{plain_ms:.5f} library_ms={library_ms:.5f} device_us={dev_us} "
          f"library_device_us={lib_dev_us:.2f} bound_ms={b_ms:.6f} ({b_by})")
    return {"name": "flash_attention_bhsd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:187",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "device_us": dev_us, "library_device_us": lib_dev_us,
            "shape": f"q ({bh},{s},{d}) kv ({bhkv},{s},{d}) bf16"}


def qdq_phase(torch):
    from repro_torch.kernels import quant_collectives as QC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    timed = None
    for n in QDQ_NS:
        x = torch.randn(2, n, generator=gen, device=dev)
        x[1] *= 10.0
        for levels in (127, 7):
            out = QC.qdq_absmax(x, levels=levels)
            ref = QC.qdq_absmax_plain(x, levels=levels)
            torch.cuda.synchronize()
            same = torch.equal(out, ref)
            err = (out - ref).abs().max().item()
            print(f"qdq (2,{n}) L={levels}: bit-identical={same}")
            if not same:
                raise AssertionError(f"qdq kernel not bit-identical at "
                                     f"(2,{n}) L={levels}: {err}")
            if n == 3840 and levels == 127:
                timed = (x, err)
    x, err = timed
    return qdq_row(torch, x, err, "a decode step's kept sync")


def qdq_row(torch, x, err, what):
    """B3 alone on x (rows, n) fp32 at L=127, timed (events and profile)
    beside its plain version: a kernels-line row."""
    from repro_torch.kernels import quant_collectives as QC

    ms = cuda_ms(torch, lambda: QC.qdq_absmax(x, levels=127), iters=200)
    plain_ms = cuda_ms(torch, lambda: QC.qdq_absmax_plain(x, levels=127),
                       iters=200)
    dev_us = device_us(torch, lambda: QC.qdq_absmax(x, levels=127),
                       ("qdq_kernel",))["qdq_kernel"]
    nbytes = 2 * x.numel() * 4          # read x, write y
    flops = 7.0 * x.numel()             # abs, max, div, rint, 2 clamps, mul
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    print(f"qdq_absmax ({x.shape[0]},{x.shape[1]}) fp32 L=127, {what}: "
          f"ms={ms:.5f} plain_ms={plain_ms:.5f} device_us={dev_us} "
          f"bound_ms={b_ms:.7f} ({b_by})")
    return {"name": "qdq_absmax", "route": "cuda",
            "source": "src/repro_torch/csrc/quant_collectives.cu",
            "replaces": "src/repro/kernels/quant_collectives.py:73",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_us": dev_us,
            "shape": f"({x.shape[0]},{x.shape[1]}) fp32, {what}"}


def unfused_sync(QC, x, levels):
    """A kept sync as six device kernels, the composition the fused kernel
    replaced: cast, qdq, sum over shards, the broadcast's copy, qdq, cast
    (timed as context; no single PyTorch call computes it)."""
    xq = QC.qdq_absmax(x.float(), levels=levels)
    s = xq.sum(dim=0, keepdim=True).expand_as(xq).contiguous()
    return QC.qdq_absmax(s, levels=levels).to(x.dtype)


def same_bits(torch, a, b) -> bool:
    """Equal shape, dtype and bits (a -0 against +0 counts as different)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def qpsum_phase(torch, card):
    """The fused kept-sync kernel against its plain version, bit for bit,
    at tp 1, 2, 4, 9, 16, L 127 and 7, bf16 and fp32, on the paths'
    payloads and a ragged one; timed at the decode and prefill syncs
    beside the six-kernel chain it replaced.  Also reads whether sum(dim=0) on the card
    adds the rows left to right (the plain version's order)."""
    from repro_torch.kernels import quant_collectives as QC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    for tp in QPSUM_TPS:
        for n in QPSUM_NS:
            base = torch.randn(tp, n, generator=gen, device=dev)
            base *= torch.logspace(0, 1, tp, device=dev)[:, None]
            base[0, :QC.CHUNK] = 0.0       # an all-zero chunk: the 1e-12 floor
            for dtype in (torch.bfloat16, torch.float32):
                x = base.to(dtype)
                for levels in (127, 7):
                    out = QC.quantized_psum_absmax(x, levels=levels)
                    ref = QC.quantized_psum_absmax_plain(x, levels=levels)
                    torch.cuda.synchronize()
                    if not same_bits(torch, out, ref):
                        err = (out.float() - ref.float()).abs().max().item()
                        raise AssertionError(
                            f"quantized_psum kernel not bit-identical at "
                            f"({tp},{n}) {dtype} L={levels}: {err}")
            print(f"quantized_psum ({tp},{n}): bit-identical in bf16 and "
                  f"fp32 at L 127 and 7")
    for tp in QPSUM_SUM_TPS:
        xq = QC.qdq_absmax_plain(torch.randn(tp, 491520, generator=gen,
                                             device=dev), levels=127)
        ltr = torch.zeros_like(xq[0])
        for r in range(tp):
            ltr = ltr + xq[r]
        print(f"sum(dim=0) over {tp} fp32 rows on the card equals the "
              f"left-to-right sum bit for bit: "
              f"{same_bits(torch, xq.sum(dim=0), ltr)}")

    rows = {}
    for tp, n in QPSUM_TIMED:
        x = torch.randn(tp, n, generator=gen, device=dev).to(torch.bfloat16)
        rows[n] = qpsum_row(torch, x, card, "a decode step's kept sync")
    return rows[QPSUM_TIMED[0][1]]


def qpsum_row(torch, x, card, what, chain_bits=True):
    """The fused kept sync on x (tp, n) bf16 at L=127, timed (events and
    profile) beside its plain version and the six-kernel chain it
    replaced (context), and bit-identical to the chain where
    `chain_bits` (the chain's sum(dim=0) adds the rows in an order of
    its own past 2): a kernels-line row."""
    from repro_torch.kernels import quant_collectives as QC

    tp, n = x.shape
    fused = lambda: QC.quantized_psum_absmax(x, levels=127)  # noqa: E731
    chain = lambda: unfused_sync(QC, x, 127)                 # noqa: E731
    if chain_bits and not same_bits(torch, fused(), chain()):
        raise AssertionError(f"fused sync differs from the chain at "
                             f"({tp},{n})")
    ms = cuda_ms(torch, fused, iters=200)
    plain_ms = cuda_ms(torch, lambda: QC.quantized_psum_absmax_plain(
        x, levels=127), iters=100)
    chain_ms = cuda_ms(torch, chain, iters=200)
    dev_us = device_us(torch, fused, ("quantized_psum_kernel",))[
        "quantized_psum_kernel"]
    chain_rows = device_rows(torch, chain, iters=20)
    chain_us = sum(us for _, us, _ in chain_rows) / 20
    chain_n = sum(k for _, _, k in chain_rows) / 20
    nbytes = 2 * x.numel() * x.element_size()    # read x, write y
    flops = (8.0 * tp + 7.0) * n     # hop 1 and the add a row, hop 2
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    print(f"quantized_psum_absmax [{card}] ({tp},{n}) bf16 L=127: "
          f"ms={ms:.5f} plain_ms={plain_ms:.5f} device_us={dev_us} "
          f"bound_ms={b_ms:.7f} ({b_by}); the unfused chain (context): "
          f"ms={chain_ms:.5f} device_us={chain_us:.3f} over "
          f"{chain_n:g} launches ("
          + ", ".join(k.split("(")[0][:40] for k, _, _ in chain_rows)
          + ")")
    return {"name": "quantized_psum_absmax", "route": "cuda",
            "source": "src/repro_torch/csrc/quant_collectives.cu",
            "replaces": "src/repro/kernels/quant_collectives.py:73",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_us": dev_us, "context_ms": chain_ms,
            "context_device_us": chain_us,
            "shape": f"({tp},{n}) bf16 L=127, {what}; context: the "
                     "six-kernel chain"}


def wide_sync_phase(torch, card, qpsum_us):
    """ROADMAP C17: the send and receive kernels at WIDE_TPS ranks bit for
    bit against their plain versions, bf16 and fp32, L 127 and 7, on
    QPSUM_NS and WIDE_N (qpsum_phase holds the fused sync there); the
    kernels-line rows of the fused sync and the receive at tp 16 on
    WIDE_N, each checked bit for bit on its timed inputs; the tp 2 device
    times of WIDE_KEPT_US beside PERF.md's, the fused sync's at
    QPSUM_TIMED[0] being qpsum_phase's `qpsum_us`.  Returns the two rows
    (their launches come from the quant8 dry-run cell's run)."""
    from repro_torch.kernels import quant_collectives as QC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(34)
    for tp in WIDE_TPS:
        for n in QPSUM_NS + (WIDE_N,):
            base = torch.randn(tp, n, generator=gen, device=dev)
            base *= torch.logspace(0, 1, tp, device=dev)[:, None]
            base[0, :QC.CHUNK] = 0.0       # an all-zero chunk: the 1e-12 floor
            for dtype in (torch.bfloat16, torch.float32):
                x = base.to(dtype)
                for levels in (127, 7):
                    msg = QC.quantize_message_absmax(x, levels=levels)
                    y = QC.reduce_messages_absmax(msg, n, levels=levels,
                                                  dtype=dtype)
                    torch.cuda.synchronize()
                    if not (torch.equal(msg, QC.quantize_message_absmax_plain(
                                x, levels=levels))
                            and same_bits(torch, y,
                                          QC.reduce_messages_absmax_plain(
                                              msg, n, levels=levels,
                                              dtype=dtype))):
                        raise AssertionError(
                            f"send / receive not bit-identical to their "
                            f"plain versions at tp {tp} (1,{n}) {dtype} "
                            f"L={levels}")
            print(f"send and receive at tp {tp} (1,{n}): bit-identical to "
                  f"their plain versions in bf16 and fp32 at L 127 and 7")

    tp, n = WIDE_TPS[-1], WIDE_N
    x = torch.randn(tp, n, generator=gen, device=dev).to(torch.bfloat16)
    if not same_bits(torch, QC.quantized_psum_absmax(x, levels=127),
                     QC.quantized_psum_absmax_plain(x, levels=127)):
        raise AssertionError(f"quantized_psum kernel not bit-identical at "
                             f"({tp},{n})")
    fused = qpsum_row(torch, x, card, f"tp {tp}: the quant8 dry-run cell's "
                                      "kept sync (SmolLM-360M decode_32k, "
                                      "8 rows a data rank)", chain_bits=False)
    msgs = QC.quantize_message_absmax(x, levels=127)
    recv = lambda: QC.reduce_messages_absmax(  # noqa: E731
        msgs, n, levels=127, dtype=torch.bfloat16)
    recv_plain = lambda: QC.reduce_messages_absmax_plain(  # noqa: E731
        msgs, n, levels=127, dtype=torch.bfloat16)
    got, want = recv(), recv_plain()
    err = (got.float() - want.float()).abs().max().item()
    if not same_bits(torch, got, want):
        raise AssertionError(f"reduce_messages kernel not bit-identical at "
                             f"tp {tp} (1,{n}): {err}")
    m = msgs.shape[1]
    ms = cuda_ms(torch, recv, iters=200)
    plain_ms = cuda_ms(torch, recv_plain, iters=50)
    dev_us = device_us(torch, recv, ("reduce_messages_kernel",),
                       need=("reduce_messages_kernel",))[
        "reduce_messages_kernel"]
    nbytes = tp * m + n * x.element_size()   # read the messages, write y
    b_ms, b_by = bound_ms(nbytes, (2.0 * tp + 7) * n, "float32")
    print(f"reduce_messages_absmax [{card}] ({tp},{m}) -> (1,{n}) bf16 "
          f"L=127: ms={ms:.5f} plain_ms={plain_ms:.5f} device_us={dev_us} "
          f"bound_ms={b_ms:.7f} ({b_by}, {nbytes} bytes)")
    receive = {"name": "reduce_messages_absmax", "route": "cuda",
               "source": "src/repro_torch/csrc/quant_collectives.cu",
               "replaces": "src/repro/kernels/quant_collectives.py:137",
               "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None, "device_us": dev_us,
               "shape": f"({tp},{m}) -> (1,{n}) bf16 L=127, tp {tp}: the "
                        "quant8 dry-run cell's kept sync as a rank of a "
                        "16-rank world would receive it (no path runs 16 "
                        "ranks on one card: its launches are the quant8 "
                        "cell's, 0)"}

    for (name, tp, n), was in WIDE_KEPT_US:
        if (name, tp, n) == ("quantized_psum_absmax", *QPSUM_TIMED[0]):
            print(f"kept tp 2 time [{card}]: {name} ({tp},{n}) bf16 "
                  f"device_us={qpsum_us} (qpsum_phase's) against PERF.md's "
                  f"{was} ({qpsum_us / was:.3f}x)")
            continue
        x = torch.randn(tp, n, generator=gen, device=dev).to(torch.bfloat16)
        if name == "quantized_psum_absmax":
            kname = "quantized_psum_kernel"
            fn = lambda: QC.quantized_psum_absmax(  # noqa: E731
                x, levels=127)
            shape = f"({tp},{n})"
        else:
            kname = "reduce_messages_kernel"
            msgs = QC.quantize_message_absmax(x, levels=127)
            fn = lambda: QC.reduce_messages_absmax(  # noqa: E731
                msgs, n, levels=127, dtype=torch.bfloat16)
            shape = f"tp {tp} (1,{n})"
        us = device_us(torch, fn, (kname,), iters=50, need=(kname,))[kname]
        print(f"kept tp 2 time [{card}]: {name} {shape} bf16 device_us={us}"
              f" against PERF.md's {was} ({us / was:.3f}x)")
    return [fused, receive]


class plain_syncs:
    """Inside: every quantized collective takes its kernels' plain
    versions on the card (the compression module's wrapper names are
    swapped): the fused kept sync, the send and receive kernels of a sync
    across ranks, B3 (the logits gather, the ring's hop 2), B4 and B6."""
    NAMES = ("quantized_psum_absmax", "quantize_message_absmax",
             "reduce_messages_absmax", "qdq_absmax", "quantize_absmax",
             "dequant_accum_absmax")

    def __enter__(self):
        from repro_torch.kernels import quant_collectives as QC
        from repro_torch.parallel import compression as C
        self.saved = {n: getattr(C, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(C, n, getattr(QC, f"{n}_plain"))

    def __exit__(self, *exc):
        from repro_torch.parallel import compression as C
        for n, fn in self.saved.items():
            setattr(C, n, fn)


def kept_syncs(llm) -> int:
    """Quantized kept syncs in one forward of llm: an SSM block or an SPD
    (dropped) block keeps one, any other block two (attention and MLP)."""
    from repro_torch.core.layer_kinds import layer_kinds
    plan = llm.plan
    return sum(1 if k.mixer == "ssm" or plan.drop_mask[i] else 2
               for i, k in enumerate(layer_kinds(llm.cfg))
               if plan.block_mode(i) in ("quant8", "quant4"))


def check_sync_launches(label, llm, launches, times):
    """The fused kernel once per quantized kept sync and B3 alone once per
    forward (its logits gather): forwards are the engine's timed steps."""
    fwd = sum(len(v) for v in times.values())
    want = {"quantized_psum_absmax": kept_syncs(llm) * fwd,
            "qdq_absmax": fwd if llm.plan.logits_mode != "exact" else 0}
    got = {k: launches[k] for k in want}
    print(f"{label}: {fwd} forwards x {kept_syncs(llm)} kept quantized "
          f"syncs; launches {got}, want {want}")
    if got != want:
        raise AssertionError(f"{label}: sync launches {got} != {want}")


def plain_rerun(torch, llm, prompts, fresh=False):
    """One more greedy generate of `prompts` with every quantized
    collective on its kernels' plain versions (`plain_syncs`).  `fresh`:
    on a new scheduler, warmed up as the counted run was (the paged
    pool's prefix cache would admit the prompts warm), and the old one
    restored after.  Returns (tokens, its logits tape on the host, the
    kernels' launches inside, which must be 0)."""
    from repro_torch.api import SamplingParams
    from repro_torch.kernels import quant_collectives as QC

    before = {n: getattr(QC, n).launches for n in plain_syncs.NAMES}
    saved = llm._sched
    with plain_syncs():
        if fresh:
            llm._sched = None
            llm.generate([prompts[0][:8]], SamplingParams(max_new=2))
        with LogitsTape() as tape:
            outs = llm.generate(prompts, SamplingParams(max_new=MAX_NEW))
    torch.cuda.synchronize()
    llm._sched = saved
    leaked = sum(getattr(QC, n).launches - before[n]
                 for n in plain_syncs.NAMES)
    return [o.token_ids for o in outs], tape.host(), leaked


def same_tokens_plain(torch, label, llm, prompts, tokens, fresh=False):
    """`plain_rerun`: its tokens must equal `tokens` bit for bit."""
    toks, _, leaked = plain_rerun(torch, llm, prompts, fresh)
    print(f"{label}: tokens with the quantized collectives' plain versions "
          f"equal the kernels': {toks == tokens} (kernel launches inside: "
          f"{leaked})")
    if toks != tokens or leaked:
        raise AssertionError(f"{label}: plain-sync tokens {toks} != kernel "
                             f"tokens {tokens} (leaked {leaked})")


def paged_case(torch, dtype, c, masked_row=None, pos=None, holes=(), d=64,
               width=32, hq=9, hkv=3, layers=32):
    """q (2, 4, c, hq, d) and k/v pools as one layer of (2, layers, P+1,
    16, hkv, d) leaves (a strided view, as the model passes them), a table
    bucketed to `width` pages of distinct physical pages with -1 tails
    (P = PAGED_PHYS, or more if the rows need more).  Rows at `pos`
    (PAGED_POS by default for c=1); c>1 without `pos`: only row 2 is
    live, a suffix chunk at PREFIX_LEN (the others all -1, as in a warm
    admission).  `masked_row` is set all -1 too, and each (row, page) of
    `holes` is set to -1."""
    dev = torch.device("cuda")
    tp, b, ps = 2, 4, PAGE_SIZE
    warm = c > 1 and pos is None
    if warm:
        pos = [0, 0, PREFIX_LEN, 0]
    pos = list(pos or PAGED_POS)
    live = [r for r in range(b)
            if not ((warm and r != 2) or r == masked_row)]
    own = {r: -(-(pos[r] + c) // ps) for r in live}
    if max(own.values(), default=0) > width:
        raise ValueError(f"positions {pos} + C={c} pass a {width}-page table")
    phys = max(PAGED_PHYS, sum(own.values()))
    gen = torch.Generator(device=dev).manual_seed(2 + c)
    perm = torch.randperm(phys, generator=torch.Generator().manual_seed(c))
    leaf = (tp, layers, phys + 1, ps, hkv, d)
    kleaf = torch.randn(leaf, generator=gen, device=dev).to(dtype)
    vleaf = torch.randn(leaf, generator=gen, device=dev).to(dtype)
    q = torch.randn(tp, b, c, hq, d, generator=gen, device=dev).to(dtype)
    table = torch.full((b, width), -1, dtype=torch.long)
    nxt = 0
    for r in live:
        table[r, :own[r]] = perm[nxt:nxt + own[r]]
        nxt += own[r]
    for r, j in holes:
        table[r, j] = -1
    li = min(5, layers - 1)
    return (q, kleaf[:, li], vleaf[:, li], table.to(dev),
            torch.tensor(pos, device=dev))


def paged_work(table, pos, c, q, pool):
    """Bytes the paged attention must move and its flops, from this call's
    table and positions: the visible K/V, the q rows that see a key (a
    row that sees none comes out 0 whatever its q), and every output row
    (its zeros included)."""
    tp, b, _, hq, d = q.shape
    ps, hkv = pool.shape[-3], pool.shape[-2]
    table, pos = table.cpu().numpy(), pos.cpu().numpy()
    keys, flops, q_rows = 0, 0, 0
    for r in range(b):
        live = [j for j in range(table.shape[1]) if table[r, j] >= 0]
        last = int(pos[r]) + c - 1
        keys += sum(max(0, min(ps, last + 1 - j * ps)) for j in live)
        for i in range(c):
            seen = sum(max(0, min(ps, int(pos[r]) + i + 1 - j * ps))
                       for j in live)
            flops += 4 * d * hq * seen
            q_rows += seen > 0
    es = q.element_size()
    nbytes = (tp * hkv * d * 2 * keys * es + tp * q_rows * hq * d * es
              + q.numel() * es)
    return nbytes, tp * flops


def gather_sdpa_call(torch, q, kv, vv, table, pos):
    """Context for the paged kernel (no single PyTorch call reads K/V
    through a page table): gather the table's pages, repeat the kv heads,
    and run masked SDPA; the port never calls it."""
    import torch.nn.functional as F
    tp, b, c, hq, d = q.shape
    ps, hkv, n = kv.shape[-3], kv.shape[-2], table.shape[1]
    g = hq // hkv

    def call():
        pt = torch.where(table < 0, torch.full_like(table, kv.shape[1] - 1),
                         table).reshape(-1)
        kg = kv[:, pt].reshape(tp * b, n * ps, hkv, d).transpose(1, 2)
        vg = vv[:, pt].reshape(tp * b, n * ps, hkv, d).transpose(1, 2)
        kg, vg = kg.repeat_interleave(g, 1), vg.repeat_interleave(g, 1)
        kpos = torch.arange(n * ps, device=q.device)
        qpos = pos[:, None] + torch.arange(c, device=q.device)[None]
        mask = ((kpos[None, None] <= qpos[:, :, None])
                & (table.repeat_interleave(ps, 1) >= 0)[:, None])
        mask = mask[:, None].repeat(tp, 1, 1, 1)
        return F.scaled_dot_product_attention(
            q.reshape(tp * b, c, hq, d).transpose(1, 2), kg, vg,
            attn_mask=mask)
    return call


def paged_plain(q, kv, vv, table, pos):
    """The paged kernel's plain version over the shard axis."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    return torch.stack([FA.paged_flash_attention_plain(
        q[t], kv[t], vv[t], table, pos) for t in range(q.shape[0])])


def paged_phase(torch):
    """B2 against its plain version: decode (C=1) cases and chunk (C>1)
    cases, bf16 and fp32.  Returns the kernels-line entries of the decode
    call and of the chunk call at the warm suffix prefill's shape."""
    from repro_torch.kernels import flash_attention as FA

    plain = paged_plain
    timed = chunk = None
    cases = ((1, None, None, (), 64, 32), (1, 1, None, (), 64, 32),
             (1, None, PAGED_EDGE_POS, (), 64, 32),
             (1, None, None, PAGED_HOLES, 64, 32),
             (1, None, PAGED_FULL_POS, (), 64, 32),
             (32, None, None, (), 64, 32),
             *((cc, None, PAGED_CHUNK_POS, (), 64, 32)
               for cc in PAGED_CHUNK_CS),
             *((8, None, PAGED_CHUNK_POS, (), dd, 32)
               for dd in PAGED_CHUNK_DS),
             (32, None, PAGED_CHUNK_POS, PAGED_CHUNK_HOLES, 64, 32),
             (32, 1, PAGED_CHUNK_POS, (), 64, 32),
             *((cc, None, at, holes, 64, width)
               for cc, at, holes, width in PAGED_CHUNK_WIDTHS))
    for dtype in (torch.bfloat16, torch.float32):
        for c, masked, at, holes, d, width in cases:
            q, kv, vv, table, pos = paged_case(torch, dtype, c, masked, at,
                                               holes, d, width)
            out = FA.paged_flash_attention(q, kv, vv, table, pos)
            ref = plain(q, kv, vv, table, pos)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = (FLASH_FP32_ATOL if dtype == torch.float32 else
                   2.0 ** -7 * max(ref.float().abs().max().item(), 1e-3))
            zero = (masked is None
                    or not out[:, masked].float().abs().max().item())
            print(f"paged {str(dtype)[6:]} C={c} D={d} masked_row={masked} "
                  f"pos={pos.tolist()} pages={width} holes={list(holes)}: "
                  f"max_abs_err={err:.3e} tol={tol:.3e} "
                  f"masked rows zero={zero}")
            if not (err <= tol and zero):
                raise AssertionError(f"paged kernel disagrees at {dtype} "
                                     f"C={c} D={d} pos={pos.tolist()} pages="
                                     f"{width} holes={holes}: {err} > {tol} "
                                     f"or zero={zero}")
            if dtype == torch.bfloat16 and masked is None and not holes \
                    and at is None and d == 64:
                if c == 1:
                    timed = (q, kv, vv, table, pos, err)
                else:
                    chunk = (q, kv, vv, table, pos, err)
            if c > 1 and masked is None and not holes and at is None:
                # a chunk call launches the tensor-core kernel in bf16 and
                # the CUDA-core one in fp32, and nothing else of B2
                names = ("paged_chunk_tc_kernel", "paged_fwd_kernel")
                want = names[0] if dtype == torch.bfloat16 else names[1]
                ran = device_us(torch, lambda: FA.paged_flash_attention(
                    q, kv, vv, table, pos), names, need=(want,))
                if ran[want] is None or any(
                        ran[nm] is not None for nm in names if nm != want):
                    raise AssertionError(f"a {dtype} chunk call did not run "
                                         f"{want} alone: {ran}")

    q, kv, vv, table, pos, err = timed
    ms = cuda_ms(torch, lambda: FA.paged_flash_attention(q, kv, vv, table,
                                                         pos))
    plain_ms = cuda_ms(torch, lambda: plain(q, kv, vv, table, pos))
    tp, b, c, hq, d = q.shape
    ps, hkv, n = kv.shape[-3], kv.shape[-2], table.shape[1]
    gather_ms = cuda_ms(torch, gather_sdpa_call(torch, q, kv, vv, table, pos))
    print(f"paged context: gather + SDPA (masked, GQA repeated) "
          f"{gather_ms:.4f} ms at the decode shape; not a single call "
          f"(no PyTorch call reads K/V through a page table)")
    nbytes, flops = paged_work(table, pos, c, q, kv)
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    names = ("paged_decode_split_kernel", "paged_decode_combine_kernel")
    prof = device_us(torch, lambda: FA.paged_flash_attention(
        q, kv, vv, table, pos), names, need=names)
    if None in prof.values():
        raise AssertionError(f"a decode call did not launch both kernels: "
                             f"{prof}")
    dev_us = sum(prof.values())        # each launches once per call
    print(f"paged_flash_attention decode (C=1, bf16): ms={ms:.5f} plain_ms="
          f"{plain_ms:.5f} device_us_per_call={dev_us:.2f} (split "
          f"{prof[names[0]]:.2f} + combine {prof[names[1]]:.2f}) bound_ms="
          f"{b_ms:.6f} ({b_by})")
    decode = {"name": "paged_flash_attention", "route": "cuda",
              "source": "src/repro_torch/csrc/paged_attention.cu",
              "replaces": "src/repro/kernels/flash_attention.py:136",
              "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
              "device_us": dev_us, "context_ms": gather_ms,
              "shape": f"C=1: q ({tp},{b},{c},{hq},{d}) pools layer of "
                       f"({tp},32,{kv.shape[1]},{ps},{hkv},{d}) bf16, "
                       f"table ({b},{n}), pos {list(PAGED_POS)}"}

    q, kv, vv, table, pos, err = chunk
    tp, b, c, hq, d = q.shape

    def call():
        return FA.paged_flash_attention(q, kv, vv, table, pos)

    ms = cuda_ms(torch, call)
    plain_ms = cuda_ms(torch, lambda: plain(q, kv, vv, table, pos))
    gather_ms = cuda_ms(torch, gather_sdpa_call(torch, q, kv, vv, table, pos))
    nbytes, flops = paged_work(table, pos, c, q, kv)
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    dev_us = device_us(torch, call, ("paged_chunk_tc_kernel",))[
        "paged_chunk_tc_kernel"]
    print(f"paged_flash_attention chunk (C={c}, bf16, one live row at "
          f"{PREFIX_LEN}): ms={ms:.5f} plain_ms={plain_ms:.5f} "
          f"paged_chunk_tc_kernel device_us={dev_us:.2f} bound_ms="
          f"{b_ms:.6f} ({b_by}; {nbytes} bytes, {flops} flops) "
          f"gather + SDPA {gather_ms:.4f} ms (context)")
    chunk = {"name": "paged_flash_attention_chunk", "route": "cuda",
             "source": "src/repro_torch/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:136",
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
             "device_us": dev_us, "context_ms": gather_ms,
             "shape": f"C={c}: q ({tp},{b},{c},{hq},{d}) bf16, row 2 live "
                      f"at {PREFIX_LEN}, table ({b},{table.shape[1]})"}
    return decode, chunk


def launch_floor_us(torch) -> float:
    """Device time of a minimal launch: fill_ of a 1-element CUDA tensor
    (profiler), the floor under any kernel's time per launch."""
    x = torch.zeros(1, device=torch.device("cuda"))
    us, names = device_total_us(torch, lambda: x.fill_(1.0), iters=50)
    print(f"launch floor: fill_ of a 1-element tensor takes {us:.3f} us "
          f"device per launch ({', '.join(names)[:80]})")
    return us


def timed_engine(torch, engine, names=("prefill", "decode")):
    """Wrap the engine's steps `names` with synchronized host timers."""
    times = {name: [] for name in names}
    for name in names:
        fn = getattr(engine, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            times[_name].append(time.perf_counter() - t0)
            return out
        setattr(engine, name, wrapped)
    return times


def all_kernels():
    """Every kernel wrapper, each with its `.launches` count."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_norm as FN
    from repro_torch.kernels import quant_collectives as QC
    from repro_torch.kernels import ssd_scan as SS
    return (FA.flash_attention_bhsd, FA.paged_flash_attention, QC.qdq_absmax,
            QC.quantized_psum_absmax, QC.quantize_absmax,
            QC.dequantize_absmax, QC.dequant_accum_absmax,
            QC.quantize_message_absmax, QC.reduce_messages_absmax,
            FN.fused_residual_rmsnorm, SS.ssd_scan)


MAIN_PATH_KERNELS = ("flash_attention_bhsd", "qdq_absmax",
                     "quantized_psum_absmax")


#: the MoE, MLA and hybrid families run at full width on their first
#: layers (sim and the shard engine alike), so that the run with the
#: families' training and Algorithm 1 fits its time limit: qwen2-moe 8
#: of 24, deepseek 9 of 27 (10 before the dry-run phase), hymba 8 of 32
#: (its global attention layer 0 kept)
FAMILY_LAYERS = {"qwen2-moe-a2.7b": 8, "deepseek-v2-lite-16b": 9,
                 "hymba-1.5b": 8}
#: the paper's 7B models at full width on 10 of their 32 layers (sim
#: and the shard engine alike; every check counts from the config): at
#: 32 the run took 1122.9 s after the build on a slow host, too near its
#: limit; 12 since the frontend phase (21f) joined the run (16 before),
#: 11 since the serve phase (4b), 10 since the dry-run phase (23; its
#: fp32 checks take layers 6-9)
PAPER_LAYERS = {"llama2-7b": 10, "opt-6.7b": 10}


def model_cfg(arch):
    """`arch`'s config at full width, cut to FAMILY_LAYERS or
    PAPER_LAYERS where named."""
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    layers = FAMILY_LAYERS.get(arch) or PAPER_LAYERS.get(arch)
    if layers:
        cfg = replace(cfg, n_layers=layers)
    return cfg


def main_path(torch, np, card, arch="smollm-360m", label="main path",
              cfg_kw=None, params=None, need=MAIN_PATH_KERNELS):
    """`arch` at full width through the facade (tp=2, spd=0.25, quant8
    kept syncs and logits gather, flash prefill, random weights from seed
    0, or `params`; `cfg_kw` replaced in the config): a counted dense
    generate of the four prompts, its sync counts, each kernel of `need`
    launched, and the same tokens with the fused sync's plain
    version."""
    from repro_torch.api import LLM, SamplingParams
    from repro_torch.config.base import replace
    from repro_torch.parallel.collectives import collective_ledger
    from repro_torch.tree import tree_leaves

    cfg = replace(model_cfg(arch), attn_backend="pallas", **(cfg_kw or {}))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM.load(cfg, tp=2, spd=0.25, comm="quant8", comm_logits="quant8",
                   dtype="bfloat16", cache_len=512, max_batch=4, seed=0,
                   params=params)
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in tree_leaves(llm.canonical))
    print(f"{label}: loaded {cfg.name} (L={cfg.n_layers} d={cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.d_head}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B "
          f"parameters, {n_params * 2 / 1e9:.2f} GB in bf16 -> "
          f"{llm.engine.tp}x{len(llm.params['segs'])} segments) in "
          f"{time.perf_counter() - t0:.1f} s; plan drops "
          f"{llm.plan.n_dropped}/{cfg.n_layers} syncs; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    llm.generate([prompts[0][:8]], SamplingParams(max_new=2))   # warm-up
    times = timed_engine(torch, llm.engine)

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with collective_ledger() as led, \
            LogitsTape(label in TAPED_LABELS) as tape:
        outs = llm.generate(prompts, SamplingParams(max_new=MAX_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    check_sync_launches(label, llm, launches, times)
    SIM_RUNS[label] = dict(tokens=[o.token_ids for o in outs],
                           ledger=ledger_rows(led), launches=dict(launches),
                           tape=tape.host())

    for o, p in zip(outs, prompts):
        if (o.finish_reason != "length" or len(o.token_ids) != MAX_NEW
                or not all(0 <= t < cfg.vocab_size for t in o.token_ids)):
            raise AssertionError(f"request {o.index} (prompt {len(p)}) "
                                 f"did not finish cleanly: {o}")
    if min(launches[name] for name in need) <= 0:
        raise AssertionError(f"a kernel was not launched on the {label}: "
                             f"{launches}")
    n_tok = sum(len(o.token_ids) for o in outs)
    prefill_ms = 1e3 * sum(times["prefill"])
    decode_ms = 1e3 * sum(times["decode"]) / max(len(times["decode"]), 1)
    print(f"{label} launches: {json.dumps(launches)}")
    print(f"{label} [{card}]: prefill_ms={prefill_ms:.2f} "
          f"(4 requests, prompts {list(PROMPT_LENS)}) "
          f"decode_ms_per_token={decode_ms:.2f} (one batch-4 decode step "
          f"per token of each request, {len(times['decode'])} steps) "
          f"tokens_per_s={n_tok / wall:.1f} "
          f"({n_tok} tokens in {wall:.2f} s) peak_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} (load "
          f"included)")
    print(f"{label} tokens[0]:", outs[0].token_ids)
    tokens = [o.token_ids for o in outs]
    same_tokens_plain(torch, label, llm, prompts, tokens)
    return llm, prompts, launches, tokens


def prefix_prompts(np, vocab: int, seed: int) -> list:
    """Two prompts sharing a PREFIX_LEN prefix (suffixes of 20 and 30):
    the second admits warm through the prefix cache."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, PREFIX_LEN)
    return [np.concatenate([prefix, rng.integers(0, vocab, n)])
            for n in (20, 30)]


def paged_path(torch, np, llm, prompts, dense_tokens, card,
               label="paged path"):
    """Paged serving at full width: the dense path's model and settings
    plus page_size=PAGE_SIZE on a NUM_PAGES pool, then a warm admission
    through the prefix cache."""
    from repro_torch.api import LLM, SamplingParams
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quant_collectives as QC
    from repro_torch.parallel.collectives import collective_ledger

    cfg = llm.cfg
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paged = LLM.load(cfg, tp=2, plan=llm.plan, cache_len=512, max_batch=4,
                     page_size=PAGE_SIZE, num_pages=NUM_PAGES,
                     params=llm.canonical)
    torch.cuda.synchronize()
    print(f"{label}: loaded in {time.perf_counter() - t0:.1f} s; "
          f"{NUM_PAGES} pages of {PAGE_SIZE}, pools "
          f"{tuple(paged.serve().pcaches[0]['k'].shape)} per segment leaf")
    paged.generate([prompts[0][:8]], SamplingParams(max_new=2))   # warm-up
    sched = paged.serve()
    times = timed_engine(torch, paged.engine,
                         ("prefill", "verify_paged", "decode_paged"))

    kernels = (FA.flash_attention_bhsd, FA.paged_flash_attention,
               QC.qdq_absmax, QC.quantized_psum_absmax)
    for k in kernels:
        k.launches = 0
    FA.paged_flash_attention.chunk_launches = 0
    pre0 = sched.n_preemptions
    t0 = time.perf_counter()
    # the tape runs on through the warm prefix pair below
    tape = LogitsTape(label in TAPED_LABELS).__enter__()
    with collective_ledger() as led:
        outs = paged.generate(prompts, SamplingParams(max_new=MAX_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    check_sync_launches(label, paged, launches, times)
    SIM_RUNS[label] = dict(tokens=[o.token_ids for o in outs],
                           ledger=ledger_rows(led), launches=dict(launches))
    n_pre = sched.n_preemptions - pre0
    for o, p in zip(outs, prompts):
        if (o.finish_reason != "length" or len(o.token_ids) != MAX_NEW
                or not all(0 <= t < cfg.vocab_size for t in o.token_ids)):
            raise AssertionError(f"paged request {o.index} (prompt {len(p)}) "
                                 f"did not finish cleanly: {o}")
    sched.pool.check()
    if n_pre < 1 or sched.pool.num_free != NUM_PAGES:
        raise AssertionError(f"{label}: {n_pre} preemptions, "
                             f"{sched.pool.num_free}/{NUM_PAGES} pages back")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the {label}: "
                             f"{launches}")
    n_tok = sum(len(o.token_ids) for o in outs)
    prefill_ms = 1e3 * (sum(times["prefill"]) + sum(times["verify_paged"]))
    steps = len(times["decode_paged"])
    decode_ms = 1e3 * sum(times["decode_paged"]) / max(steps, 1)
    same = sum(a == b for o, d in zip(outs, dense_tokens)
               for a, b in zip(o.token_ids, d))
    print(f"{label} launches: {json.dumps(launches)}")
    print(f"{label} [{card}]: prefill_ms={prefill_ms:.2f} "
          f"({len(times['prefill'])} cold prefills, "
          f"{len(times['verify_paged'])} warm suffix prefills, re-admissions "
          f"included) decode_ms_per_token={decode_ms:.2f} ({steps} paged "
          f"decode steps) tokens_per_s={n_tok / wall:.1f} ({n_tok} tokens in "
          f"{wall:.2f} s) preemptions={n_pre} "
          f"preempted={[o.n_preempted for o in outs]} "
          f"pages_returned={sched.pool.num_free}/{NUM_PAGES} "
          f"pool_high_water={sched.pool.high_water}")
    print(f"{label}: {same}/{n_tok} tokens equal the dense path's "
          "(bf16 + quant8: rounding may split the streams); peak_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} (the dense "
          "model's placement beside this one's, load included)")

    def prefix_pair(seed):
        """Two prompts sharing a PREFIX_LEN prefix, 8 tokens each: the
        second admits warm.  Returns (prefix hits, suffix prefills, decode
        steps, paged launches, tokens)."""
        pair = prefix_prompts(np, cfg.vocab_size, seed)
        hits0 = sched.kv.prefix_hits
        n_dec, n_suf = len(times["decode_paged"]), len(times["verify_paged"])
        before = FA.paged_flash_attention.launches
        outs2 = paged.generate(pair, SamplingParams(max_new=8))
        torch.cuda.synchronize()
        return (sched.kv.prefix_hits - hits0,
                len(times["verify_paged"]) - n_suf,
                len(times["decode_paged"]) - n_dec,
                FA.paged_flash_attention.launches - before,
                [o.token_ids for o in outs2])

    chunk0 = FA.paged_flash_attention.chunk_launches
    hits, n_suf, n_dec, warm, toks = prefix_pair(1)
    chunks = FA.paged_flash_attention.chunk_launches - chunk0
    tape.__exit__(None, None, None)
    SIM_RUNS[label].update(prefix_tokens=toks, tape=tape.host())
    print(f"paged prefix pair (prefix {PREFIX_LEN}, suffixes 20/30): "
          f"prefix_hits={hits} suffix_prefills={n_suf} decode_steps={n_dec} "
          f"paged launches={warm} (chunks {chunks}) tokens={toks}")
    if (hits < 1 or n_suf < 1 or warm != cfg.n_layers * (n_dec + n_suf)
            or chunks != cfg.n_layers * n_suf
            or sched.pool.num_free != NUM_PAGES):
        raise AssertionError("warm admission did not go through the paged "
                             f"kernel: hits={hits} suffix={n_suf} "
                             f"launches={warm} chunks={chunks}")
    launches["paged_flash_attention"] += warm
    launches["paged_flash_attention_chunk"] = (
        FA.paged_flash_attention.chunk_launches)
    print(f"{label}: {launches['paged_flash_attention_chunk']} chunk "
          f"(C > 1) launches of the paged kernel, warm suffix prefills and "
          f"re-admissions included")

    # the same admission under the profiler (another prefix): its suffix
    # prefill must run the tensor-core chunk kernel, once per layer
    from torch.profiler import ProfilerActivity, profile
    names = ("paged_chunk_tc_kernel", "paged_fwd_kernel")
    for seed in (2, 3, 4):             # a profile may see no device event
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            hits, n_suf, n_dec, warm, _ = prefix_pair(seed)
        found = by_name(profile_rows(prof), names)
        if any(n for _, n in found.values()):
            break
    (us, n_tc), (_, n_f32) = found[names[0]], found[names[1]]
    print(f"paged warm admission profile: prefix_hits={hits} "
          f"suffix_prefills={n_suf} paged_chunk_tc_kernel {n_tc}x "
          f"{us / max(n_tc, 1):.2f} us device per launch, "
          f"paged_fwd_kernel {n_f32}x")
    if hits < 1 or n_suf < 1 or n_tc != cfg.n_layers * n_suf or n_f32:
        raise AssertionError(f"the warm suffix prefill did not run on the "
                             f"tensor-core chunk kernel: {found}, "
                             f"suffix={n_suf}")
    same_tokens_plain(torch, label, paged, prompts,
                      [o.token_ids for o in outs], fresh=True)
    return paged, launches


#: the serve phase (ROADMAP A6 + A7a's serve CLI): the CLI's flags on
#: full-width SmolLM-360M, two replicas behind prefix-affinity; a pool of
#: SERVE_PAGES 16-token pages a replica holds every request (no
#: preemption: the paged path has one)
SERVE_PAGES = 64
SERVE_CLI = ["--arch", "smollm-360m", "--dtype", "bfloat16", "--tp", "2",
             "--spd", "0.25", "--comm", "quant8", "--comm-logits", "quant8",
             "--page-size", str(PAGE_SIZE), "--num-pages", str(SERVE_PAGES),
             "--prefill-chunk", "64", "--requests", "8", "--max-new",
             str(MAX_NEW), "--cache-len", "128", "--seed", "0"]
SERVE_CLUSTER = ["--replicas", "2", "--router", "prefix-affinity"]
#: the Python-API cluster run: two shared-prefix pairs (prefix_prompts),
#: whole prefill (B1), a pool that holds all four prompts in one replica
SERVE_API_PAGES = 128
SERVE_API_NEW = 8
SERVE_TRACKS = ("cluster", "slot0", "scheduler", "comm")


class captured_load:
    """Inside: every `LLM.load` also records its LLM and wraps its
    engine's steps `names` with `timed_engine` (the CLI builds its LLM
    itself)."""

    def __init__(self, torch, names):
        self.torch, self.names, self.runs = torch, names, []

    def __enter__(self):
        from repro_torch.api.llm import LLM
        self.saved = LLM.__dict__["load"]
        orig = LLM.load

        def load(*a, **kw):
            llm = orig(*a, **kw)
            self.runs.append((llm, timed_engine(self.torch, llm.engine,
                                                self.names)))
            return llm
        LLM.load = load
        return self

    def __exit__(self, *exc):
        from repro_torch.api.llm import LLM
        LLM.load = self.saved


def serve_cli_run(torch, argv, names):
    """`launch.serve.main(argv)` in this process, its kernels counted
    from 0: (its JSON line, launches, the engine's step times, the LLM)."""
    import io
    from repro_torch.launch import serve

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    buf = io.StringIO()
    with captured_load(torch, names) as cap, \
            contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"serve CLI {argv} exited {rc}")
    (llm, times), = cap.runs
    return (json.loads(buf.getvalue().strip().splitlines()[-1]),
            {k.__name__: k.launches for k in kernels}, times, llm)


def hist_mean_ms(snap, name) -> float:
    """The mean of a recorder histogram, ms."""
    return 1e3 * snap[f"{name}_sum"] / max(snap[f"{name}_count"], 1)


def serve_api_run(torch, np, llm, pairs, replicas, obs):
    """The Python API: LLM.load(dp_replicas=, router="prefix-affinity",
    obs=) on `llm`'s weights (whole prefill, the serve pool), a generate
    of the shared-prefix pairs counted from 0.  Returns (tokens,
    launches, step times, the router's or scheduler's stats, wall s)."""
    from repro_torch.api import LLM, SamplingParams
    from repro_torch.kernels import flash_attention as FA

    kernels = all_kernels()
    with captured_load(torch, ("prefill", "verify_paged",
                               "decode_paged")) as cap:
        api = LLM.load(llm.cfg, tp=2, plan=llm.plan, cache_len=512,
                       max_batch=4, page_size=PAGE_SIZE,
                       num_pages=SERVE_API_PAGES, params=llm.canonical,
                       dp_replicas=replicas, router="prefix-affinity",
                       obs=obs)
    (_, times), = cap.runs
    for k in kernels:
        k.launches = 0
    FA.paged_flash_attention.chunk_launches = 0
    t0 = time.perf_counter()
    outs = api.generate(pairs, SamplingParams(max_new=SERVE_API_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    launches["paged_flash_attention_chunk"] = (
        FA.paged_flash_attention.chunk_launches)
    sched = api.serve()
    stats = sched.stats() if replicas > 1 else sched.metrics()
    return [o.token_ids for o in outs], launches, times, stats, wall


def serve_phase(torch, np, llm, card):
    """The serve CLI and cluster serving at full width (ROADMAP A6, A7a's
    serve CLI): the CLI's JSON line, files, kernels and timings; one
    replica's CLI line beside it; the Python-API cluster over shared-
    prefix pairs with obs on and off against one replica, bit for bit.
    Returns the phase's launches, each run's apart."""
    import tempfile

    from repro_torch.obs import MetricsRegistry, Recorder, Tracer

    cfg, L = llm.cfg, llm.cfg.n_layers
    names = ("prefill_chunked", "verify_paged", "decode_paged")
    with tempfile.TemporaryDirectory(prefix="serve_phase_") as root:
        mpath, tpath = f"{root}/metrics.json", f"{root}/trace.json"
        t0 = time.perf_counter()
        line, launches, times, cli = serve_cli_run(
            torch, SERVE_CLI + SERVE_CLUSTER
            + ["--metrics-json", mpath, "--trace", tpath], names)
        wall = time.perf_counter() - t0
        with open(mpath) as f:
            metrics = json.load(f)
        with open(tpath) as f:
            trace = json.load(f)
    n_req = 8
    print(f"serve CLI (2 replicas, prefix-affinity, obs on): "
          f"{json.dumps({k: line[k] for k in ('completed', 'paged')})}; "
          f"cluster routed {line['cluster']['routed']}, replicas "
          f"{ {r: v['routed'] for r, v in line['cluster']['replicas'].items()} }"
          f"; obs.comm {json.dumps(line['obs']['comm'])}")
    # the CLI's prompts are 4..23 tokens: one 64-token chunk a prefill
    check_sync_launches("serve CLI", cli, launches, times)
    snap = metrics["metrics"]
    tracks = [e["args"]["name"] for e in trace["traceEvents"]
              if e["name"] == "thread_name"]
    n_paged = len(times["verify_paged"]) + len(times["decode_paged"])
    if (line["completed"] != n_req or len(line["outputs"]) != n_req
            or line["paged"]["free_pages"] != 2 * SERVE_PAGES
            or line["cluster"]["routed"] != n_req
            or len(line["cluster"]["replicas"]) != 2
            or snap["requests_submitted_total"] != n_req
            or snap["ttft_seconds_count"] != n_req
            or not metrics["prometheus"].startswith("# TYPE")
            or not set(SERVE_TRACKS) <= set(tracks)
            or tracks != line["obs"]["tracks"]):
        raise AssertionError(f"serve CLI: line {line}, tracks {tracks}")
    # B1 0: the chunked prefill attends through the plain chunk path; B2
    # once a layer of every paged forward; B3 alone once a forward (the
    # logits gather), the fused kept sync as check_sync_launches holds
    if (launches["flash_attention_bhsd"] != 0
            or launches["paged_flash_attention"] != L * n_paged
            or min(launches["qdq_absmax"],
                   launches["quantized_psum_absmax"]) <= 0):
        raise AssertionError(f"serve CLI launches {launches}, {n_paged} "
                             "paged forwards")
    dec = times["decode_paged"]
    print(f"serve CLI [{card}]: wall {wall:.2f} s (load and warm-up "
          f"included), ttft_ms={hist_mean_ms(snap, 'ttft_seconds'):.2f} "
          f"tpot_ms={hist_mean_ms(snap, 'tpot_seconds'):.2f} "
          f"queue_wait_ms={hist_mean_ms(snap, 'queue_wait_seconds'):.2f} "
          f"(recorder means over {n_req} requests) "
          f"decode_ms_per_step={1e3 * sum(dec) / len(dec):.2f} "
          f"({len(dec)} paged decode steps, both replicas and their "
          f"warm-ups); launches {json.dumps(launches)}")
    del cli
    one, _, _, _ = serve_cli_run(torch, SERVE_CLI, names)
    same = sum(a == b for k in line["outputs"]
               for a, b in zip(line["outputs"][k], one["outputs"][k]))
    total = sum(len(v) for v in line["outputs"].values())
    print(f"serve CLI: {same}/{total} of the printed tokens equal one "
          "replica's (quant8 chunks span neighbour slots: another "
          "co-batch can move a code, ROADMAP C15)")

    # the Python API: two shared-prefix pairs; prefix-affinity keeps each
    # pair on one replica in the slots one replica gives it
    pairs = prefix_prompts(np, cfg.vocab_size, 5) + prefix_prompts(
        np, cfg.vocab_size, 6)
    obs = Recorder(MetricsRegistry(), Tracer())
    on, api_launches, api_times, stats, wall_on = serve_api_run(
        torch, np, llm, pairs, 2, obs)
    off, off_launches, off_times, _, wall_off = serve_api_run(
        torch, np, llm, pairs, 2, None)
    lone, _, _, lone_stats, _ = serve_api_run(torch, np, llm, pairs, 1,
                                              None)
    snap = obs.snapshot()
    where = {r: v["routed"] for r, v in stats["replicas"].items()}
    print(f"serve API (2 replicas, prefix-affinity): routed {where}, "
          f"prefix_affinity_hit_rate {stats['prefix_affinity_hit_rate']}, "
          f"prefix hits {[v['prefix_hits'] for v in stats['replicas'].values()]}"
          f" (one replica: {lone_stats['prefix_hits']}); tokens equal one "
          f"replica's: {on == lone}; obs on == off: {on == off}")
    if on != lone or on != off or api_launches != off_launches:
        raise AssertionError(f"serve API: tokens on {on}, off {off}, one "
                             f"replica {lone}; launches {api_launches} vs "
                             f"{off_launches}")
    n_pre = len(api_times["prefill"])
    n_pg = len(api_times["verify_paged"]) + len(api_times["decode_paged"])
    check_sync_launches("serve API", llm, api_launches, api_times)
    if (api_launches["flash_attention_bhsd"] != L * n_pre
            or api_launches["paged_flash_attention"] != L * n_pg
            or api_launches["paged_flash_attention_chunk"]
            != L * len(api_times["verify_paged"])
            or not api_times["verify_paged"] or sorted(where.values()) != [2, 2]
            or snap["prefix_cache_hits_total"] != 2):
        raise AssertionError(f"serve API launches {api_launches}, "
                             f"{n_pre} prefills, {n_pg} paged forwards, "
                             f"routed {where}, hits "
                             f"{snap.get('prefix_cache_hits_total')}")
    for label, ts, w, rec in (("obs on", api_times, wall_on, snap),
                              ("obs off", off_times, wall_off, None)):
        dec = ts["decode_paged"]
        extra = ("" if rec is None else
                 f"ttft_ms={hist_mean_ms(rec, 'ttft_seconds'):.2f} "
                 f"tpot_ms={hist_mean_ms(rec, 'tpot_seconds'):.2f} ")
        print(f"serve API {label} [{card}]: {extra}"
              f"decode_ms_per_step={1e3 * sum(dec) / len(dec):.2f} "
              f"({len(dec)} steps, warm-ups included) generate wall "
              f"{w:.3f} s (the replicas' warm-up included)")
    print(f"serve phase launches: CLI {json.dumps(launches)}; API (obs on) "
          f"{json.dumps(api_launches)}")
    return launches, api_launches


# the port's own kernels, by the names the profiler shows (a name here is
# not a substring of another)
PORT_KERNELS = ("flash_fwd_tc_kernel", "flash_fwd_kernel",
                "paged_decode_split_kernel", "paged_decode_combine_kernel",
                "paged_chunk_tc_kernel", "paged_fwd_kernel", "qdq_kernel",
                "quantized_psum_kernel",
                "ssd_scores_kernel", "ssd_states_kernel", "ssd_output_kernel",
                "ssd_scan_kernel")


def profile_phase(torch, llm, prompts, card, label="profile"):
    """Where a main path's time goes: one more generate (4 prompts, 4
    tokens each) under torch.profiler; device-busy share of the wall time
    and the kernels that take the most device time.  Returns the launches
    of each of PORT_KERNELS in the window."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import SamplingParams

    torch.cuda.synchronize()
    tries = 3
    for t in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            llm.generate(prompts, SamplingParams(max_new=4))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = [(us, n, key) for key, us, n in profile_rows(prof)]
        # every generate launches some of the port's kernels: a window
        # that shows none of them lost its kernel events
        if any(name in key for name in PORT_KERNELS for _, _, key in rows):
            break
        print(f"{label}: profile {t + 1} of {tries} saw none of the port's "
              f"kernels among {len(rows)} device rows: taken again")
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        print(f"{label}: the profiler saw no device time")
        return {}
    rows.sort(reverse=True)
    print(f"{label} [{card}]: generate 4x4 tokens wall_ms={wall_us / 1e3:.1f} "
          f"device_busy_ms={busy_us / 1e3:.1f} "
          f"device_idle_share={1 - busy_us / wall_us:.3f} "
          f"device_ops={sum(r[1] for r in rows)}")
    for dev_us, count, key in rows[:8]:
        print(f"  {label} top: {dev_us / 1e3:8.2f} ms {count:6d}x {key[:90]}")
    seen = {}
    for name in PORT_KERNELS:
        hits = [(us, n) for us, n, key in rows if name in key]
        us, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
        seen[name] = n
        if n:
            print(f"  {label} kernel: {name} {n}x, device "
                  f"{us / n:.2f} us per launch")
    return seen


def tf_model(llm, dtype, fp32_layers=None, device=None):
    """(cfg, params, plan) of a teacher-forced check in `dtype`, with
    the plan's drop mask and exact syncs.  `fp32_layers` (start, stop)
    keeps only those layers for the fp32 check (a full-width fp32 copy of
    a 7B model is 27 GB).  `device`: where the params are cast (default:
    where the canonical tree lives)."""
    import dataclasses
    from repro_torch.config.base import SPDPlanConfig, replace
    from repro_torch.core import blocks as B
    from repro_torch.tree import tree_map

    cfg, canonical, drop = llm.cfg, llm.canonical, llm.plan.drop_mask
    if dtype == "float32" and fp32_layers:
        lo, hi = fp32_layers
        cfg = replace(cfg, n_layers=hi - lo)
        if cfg.moe is not None:       # the kept slice's dense layers
            dense = max(0, min(hi, cfg.moe.n_dense_layers) - lo)
            cfg = replace(cfg, moe=dataclasses.replace(
                cfg.moe, n_dense_layers=dense))
        canonical = dict(canonical, layers=canonical["layers"][lo:hi])
        drop = drop[lo:hi]
    params = tree_map(lambda w: w.to(device=device,
                                     dtype=B.TORCH_DTYPES[dtype]), canonical)
    return replace(cfg, dtype=dtype), params, SPDPlanConfig(drop)


class RoutePin:
    """MoE routing pinned across the two forwards of a teacher-forced
    check: `record()` keeps every `models.moe.route` result of the first
    forward, `replay()` hands them to the second in order and counts the
    top-k choices the second would have made otherwise.  A last-ulp
    difference in a router's input (bf16 rounding in the attention
    kernel) flips a near-tied top-k choice, and a token sent to another
    expert moves its logits by far more than the rounding did: pinned,
    the check measures the attention kernel, not the router's
    discontinuity (as the syncs run exact so as not to measure the
    quantizer).  A model without MoE layers never routes.  `host()` and
    `from_host` carry a sim run's routes to a shard engine's rank, which
    replays its own shard's rows of them (`replay(shard=)`)."""

    def __init__(self):
        self.kept, self.flips, self.choices = [], 0, 0

    @classmethod
    def from_host(cls, kept):
        pin = cls()
        pin.kept = kept
        return pin

    def host(self) -> list:
        return [(g.cpu().numpy(), i.cpu().numpy()) for g, i, _ in self.kept]

    @contextlib.contextmanager
    def _patched(self, fn):
        from repro_torch.models import moe as MOE
        orig = MOE.route
        MOE.route = lambda *a, **kw: fn(orig, *a, **kw)
        try:
            yield self
        finally:
            MOE.route = orig

    def record(self):
        def rec(orig, *a, **kw):
            out = orig(*a, **kw)
            self.kept.append(out)
            return out
        return self._patched(rec)

    def replay(self, shard=None):
        it = iter(self.kept)

        def rep(orig, *a, **kw):
            out, kept = orig(*a, **kw), next(it)
            if shard is not None:       # a rank: its shard's rows, on host
                kept = tuple(o.new_tensor(k[shard:shard + 1])
                             for o, k in zip(out, kept)) + (out[2],)
            own = out[1]
            same = own.sort(-1).values == kept[1].sort(-1).values
            self.flips += int((~same).sum())
            self.choices += same.numel()
            return kept
        return self._patched(rep)

    def note(self) -> str:
        return (f" routing pinned: {self.flips} of {self.choices} top-k "
                "choices would differ" if self.choices else "")


def teacher_forced(torch, llm, prompt, fp32_layers=None, label=""):
    """Prefill logits with the flash kernel vs the plain attention, same
    canonical weights and drop mask, in the serving dtype (bf16) and in
    fp32 (`fp32_layers`: see tf_model).  The syncs run exact here: a
    quantized sync turns a last-ulp difference into a whole quant step (a
    flipped code), which would measure the quantizer, not the attention
    kernel."""
    from repro_torch.api import LLM
    from repro_torch.config.base import replace
    from repro_torch.runtime.forward import bucketed_prefill

    for dtype in ("bfloat16", "float32"):
        logits = {}
        cfg0, params, plan = tf_model(llm, dtype, fp32_layers)
        pin = RoutePin()
        for backend, pinned in (("pallas", pin.record),
                                ("xla", pin.replay)):
            cfg = replace(cfg0, attn_backend=backend)
            other = LLM.load(cfg, tp=2, plan=plan, cache_len=512,
                             max_batch=1, params=params)
            with pinned():
                lg, _ = bucketed_prefill(other.engine, other.params, prompt,
                                         len(prompt), 512)
            logits[backend] = lg.float()
            del other
        del params
        err = (logits["pallas"] - logits["xla"]).abs().max().item()
        scale = logits["xla"].abs().max().item()
        tol = TF_BF16_REL * scale if dtype == "bfloat16" else TF_FP32_ATOL
        same_top = int(logits["pallas"].argmax()) == int(logits["xla"].argmax())
        print(f"{label}teacher-forced prefill ({len(prompt)} tokens, {dtype}, "
              f"{cfg0.n_layers} layers): "
              f"max_abs_err={err:.3e} tol={tol:.3e} max|logit|={scale:.3e} "
              f"same argmax={same_top}{pin.note()}")
        if not err <= tol:
            raise AssertionError(f"pallas vs xla prefill logits disagree "
                                 f"({dtype}): {err} > {tol}")


def teacher_forced_paged(torch, llm, prompt, fp32_layers=None, label=""):
    """One decode step's logits after the same prefill: paged caches
    through the paged kernel against dense caches through the plain
    decode attention, same canonical weights and drop mask, exact syncs
    (see teacher_forced), in bf16 and in fp32 (`fp32_layers`: see
    tf_model)."""
    import numpy as np
    from repro_torch.api import LLM
    from repro_torch.config.base import replace
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.runtime.forward import bucketed_prefill
    from repro_torch.runtime.paging import PagePool

    s = len(prompt)
    for dtype in ("bfloat16", "float32"):
        cfg, params, plan = tf_model(llm, dtype, fp32_layers)
        cfg = replace(cfg, attn_backend="pallas")
        m = LLM.load(cfg, tp=2, plan=plan, cache_len=512, max_batch=1,
                     params=params)
        del params
        eng = m.engine
        lg, c1 = bucketed_prefill(eng, m.params, prompt, s, 512)
        cur = np.asarray([[int(lg[0].argmax())]])
        pos = np.asarray([s])
        dense = eng.insert_slot(eng.blank_caches(1, 512), c1, 0)
        pin = RoutePin()
        with pin.record():
            _, ld, _ = eng.decode_with_logits(m.params, cur, pos, dense)
        pool = PagePool(num_pages=NUM_PAGES, page_size=PAGE_SIZE,
                        max_slots=2, pages_per_slot=512 // PAGE_SIZE)
        pool.grow(1, 3 * PAGE_SIZE)     # slot 0's pages start past page 2
        pool.grow(0, s + 1)
        pc = eng.blank_paged_caches(2, 512, page_size=PAGE_SIZE,
                                    num_pages=NUM_PAGES)
        pc = eng.insert_paged(pc, c1, 0, pool.table[0])
        table = pool.table[:1].astype(np.int64)
        before = FA.paged_flash_attention.launches
        with pin.replay():
            _, lp, _ = eng.decode_paged_with_logits(m.params, cur, pos,
                                                    table, pc)
        ran = FA.paged_flash_attention.launches - before
        err = (lp.float() - ld.float()).abs().max().item()
        scale = ld.float().abs().max().item()
        tol = TF_BF16_REL * scale if dtype == "bfloat16" else TF_FP32_ATOL
        print(f"{label}teacher-forced paged decode (prompt {s}, {dtype}, "
              f"{cfg.n_layers} layers): "
              f"max_abs_err={err:.3e} tol={tol:.3e} max|logit|={scale:.3e} "
              f"same argmax={int(lp.argmax()) == int(ld.argmax())} "
              f"paged launches={ran}{pin.note()}")
        if not (err <= tol and ran == cfg.n_layers):
            raise AssertionError(f"paged vs dense decode logits disagree "
                                 f"({dtype}): {err} > {tol} (launches {ran})")
        del m


def profile_rows(prof) -> list:
    """(key, device us, count) of every kernel and copy in a profile:
    device-side events only, since a CPU op also reports its kernels'
    time, which would count them twice."""
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((e.key, us, e.count))
    return rows


def by_name(rows, names) -> dict:
    """{name: [device us, launches]} over `rows` of the kernels `names`,
    matched as a whole symbol (never as a part of another name)."""
    import re

    pats = {n: re.compile(r"(^|[\s:])" + n + r"[<(]") for n in names}
    acc = {n: [0.0, 0] for n in names}
    for key, us, count in rows:
        for n, pat in pats.items():
            if pat.search(key):
                acc[n][0] += us
                acc[n][1] += count
    return acc


def device_rows(torch, fn, iters=20, tries=5, names=(), need=()) -> list:
    """profile_rows of `iters` calls of fn.  A profile that saw no device
    event at all, none of the kernels `names` where they are given, or
    not every one of the kernels `need`, is taken again, up to `tries`
    times: the profiler now and then loses a window's kernel events
    (between back-to-back profiles, after a large one, and at times those
    of one kernel of a call that launches several), while the kernels
    did run."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    rows = []
    for t in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = profile_rows(prof)
        want = tuple(names) + tuple(n for n in need if n not in names)
        seen = {n for n, (_, k) in by_name(rows, want).items() if k}
        if rows and (not names or seen) and set(need) <= seen:
            return rows
        print(f"profile {t + 1} of {tries} saw "
              + (f"{sorted(seen)} of {list(want)} among {len(rows)} device "
                 f"rows ({', '.join(k.split('(')[0][:40] for k, _, _ in rows[:4])})"
                 if rows else "no device event") + ": taken again")
    return rows


def device_us(torch, fn, names, iters=20, need=()) -> dict:
    """Device microseconds per launch of the kernels `names` over `iters`
    calls of fn, from torch.profiler (None where it saw no launch); the
    profile is taken again while it misses one of the kernels `need`."""
    acc = by_name(device_rows(torch, fn, iters, names=names, need=need),
                  names)
    return {n: (us / k if k else None) for n, (us, k) in acc.items()}


def device_total_us(torch, fn, iters=20) -> tuple:
    """Device microseconds per call of fn summed over every kernel and copy
    it launched (torch.profiler), and the names of those kernels."""
    rows = device_rows(torch, fn, iters)
    return (sum(us for _, us, _ in rows) / iters,
            [key.split("(")[0][:60] for key, _, _ in rows])


def quant_phase(torch):
    """quantize, dequantize and dequant-accumulate against their plain
    versions, bit for bit, at the ring's slice shapes, L 127 and 7."""
    from repro_torch.kernels import quant_collectives as QC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    timed = None
    for rows, n in QUANT_SHAPES:
        x = torch.randn(rows, n, generator=gen, device=dev)
        x *= torch.logspace(0, 2, rows, device=dev)[:, None]
        acc = torch.randn(rows, n, generator=gen, device=dev)
        for levels in (127, 7):
            q, s = QC.quantize_absmax(x, levels=levels)
            qp, sp = QC.quantize_absmax_plain(x, levels=levels)
            y = QC.dequantize_absmax(q, s)
            yp = QC.dequantize_absmax_plain(q, s)
            z = QC.dequant_accum_absmax(q, s, acc)
            zp = QC.dequant_accum_absmax_plain(q, s, acc)
            torch.cuda.synchronize()
            same = {"quantize": torch.equal(q, qp) and torch.equal(s, sp),
                    "dequantize": torch.equal(y, yp),
                    "dequant_accum": torch.equal(z, zp)}
            print(f"quant ({rows},{n}) L={levels}: bit-identical {same}")
            if not all(same.values()):
                errs = ((q.int() - qp.int()).abs().max().item(),
                        (s - sp).abs().max().item(),
                        (y - yp).abs().max().item(),
                        (z - zp).abs().max().item())
                raise AssertionError(f"quant kernels not bit-identical at "
                                     f"({rows},{n}) L={levels}: {errs}")
            if (rows, n) == QUANT_TIMED and levels == 127:
                timed = (x, q, s, acc)
    x, q, s, acc = timed
    rows, n = x.shape
    sb = s.numel() * 4
    # at the timed shape every chunk is whole, so one PyTorch call
    # computes codes*scale (int8 x fp32 promotes to fp32) and one
    # acc + codes*scale
    assert n % QC.CHUNK == 0, n
    qc, sc, ac = q.view(rows, -1, QC.CHUNK), s[..., None], acc.view(
        rows, -1, QC.CHUNK)

    def lib_deq():
        return qc * sc

    def lib_acc():
        return torch.addcmul(ac, qc, sc)

    lib_err = {"dequantize_absmax": (lib_deq().view(rows, n)
                                     - QC.dequantize_absmax(q, s)),
               "dequant_accum_absmax": (lib_acc().view(rows, n)
                                        - QC.dequant_accum_absmax(q, s,
                                                                  acc))}
    lib_err = {k: v.abs().max().item() for k, v in lib_err.items()}
    prof = device_us(torch, lambda: (QC.quantize_absmax(x, levels=127),
                                     QC.dequantize_absmax(q, s),
                                     QC.dequant_accum_absmax(q, s, acc)),
                     QUANT_KERNELS, need=QUANT_KERNELS)
    cases = (
        ("quantize_absmax", ":93", "quant_kernel",
         lambda: QC.quantize_absmax(x, levels=127),
         lambda: QC.quantize_absmax_plain(x, levels=127), None,
         4 * x.numel() + q.numel() + sb, 6.0 * x.numel()),
        ("dequantize_absmax", ":116", "dequant_kernel",
         lambda: QC.dequantize_absmax(q, s),
         lambda: QC.dequantize_absmax_plain(q, s), lib_deq,
         q.numel() + sb + 4 * q.numel(), 1.0 * q.numel()),
        ("dequant_accum_absmax", ":137", "dequant_accum_kernel",
         lambda: QC.dequant_accum_absmax(q, s, acc),
         lambda: QC.dequant_accum_absmax_plain(q, s, acc), lib_acc,
         q.numel() + sb + 8 * q.numel(), 2.0 * q.numel()),
    )
    out = []
    for name, line, kname, fn, plain, lib, nbytes, flops in cases:
        ms = cuda_ms(torch, fn, iters=100)
        plain_ms = cuda_ms(torch, plain, iters=100)
        library_ms = cuda_ms(torch, lib, iters=100) if lib else None
        # the library call's device time, every kernel it launches summed
        lib_dev, lib_names = device_total_us(torch, lib) if lib else (None,
                                                                      None)
        b_ms, b_by = bound_ms(nbytes, flops, "float32")
        print(f"{name} ({rows},{n}): ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={library_ms} library_device_us={lib_dev} "
              f"({lib_names}; max_abs_err vs kernel "
              f"{lib_err.get(name)}) device_us_per_launch={prof[kname]} "
              f"bound_ms={b_ms:.6f}")
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/csrc/quant_collectives.cu",
                    "replaces": f"src/repro/kernels/quant_collectives.py{line}",
                    "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": library_ms, "device_us": prof[kname],
                    "library_device_us": lib_dev,
                    "shape": f"({rows},{n}) fp32 L=127, a 4x512 prefill's "
                             "ring slice at tp=2"})
    out[1]["shape"] += " (on no path: only the reference's tests call it)"
    return out


def norm_phase(torch):
    """The fused residual RMSNorm against its plain version, fp32 and
    bf16, at a prefill's rows and a decode step's."""
    import torch.nn.functional as F
    from repro_torch.kernels import fused_norm as FN

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    timed = None
    for dtype in (torch.float32, torch.bfloat16):
        for t, d in NORM_SHAPES:
            x = torch.randn(t, d, generator=gen, device=dev).to(dtype)
            r = torch.randn(t, d, generator=gen, device=dev).to(dtype)
            w = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
                 ).to(dtype)
            y, s = FN.fused_residual_rmsnorm(x, r, w)
            yp, sp = FN.fused_residual_rmsnorm_plain(x, r, w)
            torch.cuda.synchronize()
            err = max((y.float() - yp.float()).abs().max().item(),
                      (s.float() - sp.float()).abs().max().item())
            tol = NORM_ATOL[str(dtype)[6:]]
            print(f"fused_norm {str(dtype)[6:]} ({t},{d}): "
                  f"max_abs_err={err:.3e} tol={tol:.0e}")
            if not err <= tol:
                raise AssertionError(f"fused norm kernel disagrees at "
                                     f"{dtype} ({t},{d}): {err} > {tol}")
            if dtype == torch.bfloat16 and t == NORM_SHAPES[0][0]:
                timed = (x, r, w, err)
    x, r, w, err = timed
    t, d = x.shape
    ms = cuda_ms(torch, lambda: FN.fused_residual_rmsnorm(x, r, w))
    plain_ms = cuda_ms(torch, lambda: FN.fused_residual_rmsnorm_plain(x, r, w))
    s = x + r
    library_ms = (cuda_ms(torch, lambda: F.rms_norm(s, (d,), w, 1e-5))
                  if hasattr(F, "rms_norm") else None)
    prof = device_us(torch, lambda: FN.fused_residual_rmsnorm(x, r, w),
                     ("fused_rmsnorm_kernel",))
    es = x.element_size()
    b_ms, b_by = bound_ms(4 * x.numel() * es + d * es, 7.0 * x.numel(),
                          "float32")
    print(f"fused_residual_rmsnorm ({t},{d}) bf16: ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} library_ms={library_ms} "
          f"(F.rms_norm on the precomputed sum, context) "
          f"device_us_per_launch={prof['fused_rmsnorm_kernel']} "
          f"bound_ms={b_ms:.6f}")
    return {"name": "fused_residual_rmsnorm", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_norm.cu",
            "replaces": "src/repro/kernels/fused_norm.py:30",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "device_us": prof["fused_rmsnorm_kernel"],
            "shape": f"x, r ({t},{d}) bf16, w ({d},) (on no path: the model "
                     "does not call it, nor does the reference's)"}


class plain_ring:
    """Inside: the ring collectives take the kernels' plain versions on
    the card (the compression module's kernel names are swapped)."""

    def __enter__(self):
        from repro_torch.kernels import quant_collectives as QC
        from repro_torch.parallel import compression as C
        self.saved = {k: getattr(C, k) for k in (
            "quantize_absmax", "dequant_accum_absmax", "qdq_absmax")}
        C.quantize_absmax = QC.quantize_absmax_plain
        C.dequant_accum_absmax = QC.dequant_accum_absmax_plain
        C.qdq_absmax = QC.qdq_absmax_plain

    def __exit__(self, *exc):
        from repro_torch.parallel import compression as C
        for k, v in self.saved.items():
            setattr(C, k, v)


def ring_phase(torch, card):
    """The runnable ring collectives over the shard axis at tp 2 and 4,
    on kept-sync payloads of full-width SmolLM-360M.  Returns the
    launches of the kernel-path calls."""
    from repro_torch.kernels import quant_collectives as QC
    from repro_torch.parallel import compression as C

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    counted = (QC.quantize_absmax, QC.dequant_accum_absmax, QC.qdq_absmax)
    launches = {k.__name__: 0 for k in counted}
    cases = []
    for tp in RING_TPS:
        for label, shp in (("prefill", (tp, 4, 512, 960)),
                           ("decode", (tp, 4, 1, 960))):
            x = torch.randn(shp, generator=gen, device=dev)
            exact = x.sum(dim=0)
            for bits in (8, 4):
                for k in counted:
                    k.launches = 0
                out = C.ring_quantized_psum(x, bits=bits)
                torch.cuda.synchronize()
                got = {k.__name__: k.launches for k in counted}
                for k in counted:
                    k.launches = 0
                with plain_ring():
                    ref = C.ring_quantized_psum(x, bits=bits)
                torch.cuda.synchronize()
                leaked = {k.__name__: k.launches for k in counted}
                if any(leaked.values()):
                    raise AssertionError(f"the plain ring launched kernels: "
                                         f"{leaked}")
                levels = 127 if bits == 8 else 7
                bound = (2 * tp + 1) / levels * x.abs().max().item()
                err = (out[0] - exact).abs().max().item()
                same = torch.equal(out, ref)
                shards = all(torch.equal(out[0], out[d]) for d in range(tp))
                want = {"quantize_absmax": tp - 1,
                        "dequant_accum_absmax": tp - 1, "qdq_absmax": 1}
                print(f"ring_quantized_psum tp={tp} {label} {tuple(shp)} "
                      f"bits={bits}: kernel==plain {same} shards equal "
                      f"{shards} err={err:.4e} bound={bound:.4e} "
                      f"launches {got}")
                if not (same and shards and err <= bound and got == want):
                    raise AssertionError(f"ring_quantized_psum tp={tp} "
                                         f"{label} bits={bits} failed")
                for k, v in got.items():
                    launches[k] += v
            rs = C.ring_reduce_scatter(x)
            flat = exact.reshape(-1)
            want_rs = torch.nn.functional.pad(
                flat, (0, (-flat.numel()) % tp)).reshape(tp, -1)
            rs_err = (rs - want_rs).abs().max().item()
            ag = C.ring_all_gather(x)
            ag_ok = torch.equal(ag, x[None].expand(tp, *x.shape))
            print(f"ring_reduce_scatter tp={tp} {label}: max_abs_err="
                  f"{rs_err:.3e} tol={RING_RS_ATOL:.0e}; ring_all_gather "
                  f"exact {ag_ok}")
            if not (rs_err <= RING_RS_ATOL and ag_ok):
                raise AssertionError(f"ring RS/AG tp={tp} {label} failed")
            cases.append((tp, label, x))
    for tp, label, x in cases:
        t_q = cuda_ms(torch, lambda: C.ring_quantized_psum(x, bits=8),
                      iters=20)
        t_rs = cuda_ms(torch, lambda: C.ring_reduce_scatter(x), iters=20)
        t_ag = cuda_ms(torch, lambda: C.ring_all_gather(x), iters=20)
        print(f"ring [{card}] tp={tp} {label} {tuple(x.shape)}: "
              f"ring_quantized_psum(q8)={t_q:.4f} ms "
              f"ring_reduce_scatter={t_rs:.4f} ms "
              f"ring_all_gather={t_ag:.4f} ms per call")
    print(f"ring phase launches: {json.dumps(launches)}")
    return launches


def overlap_path(torch, np, prompts, dense_tokens, card):
    """The dense path's LLM.load arguments plus engine="overlap": the same
    tokens, the ledger priced, and pipelined decode equal to serial."""
    from repro_torch.api import LLM, SamplingParams
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quant_collectives as QC
    from repro_torch.parallel.collectives import (LatencyModel,
                                                  collective_ledger)
    from repro_torch.runtime.forward import bucketed_prefill

    cfg = replace(get_config("smollm-360m"), attn_backend="pallas")
    t0 = time.perf_counter()
    llm = LLM.load(cfg, tp=2, spd=0.25, comm="quant8", comm_logits="quant8",
                   dtype="bfloat16", cache_len=512, max_batch=4, seed=0,
                   engine="overlap")
    torch.cuda.synchronize()
    print(f"overlap path: loaded in {time.perf_counter() - t0:.1f} s, "
          f"backend {type(llm.engine.backend).__name__} "
          f"overlaps_comm={llm.engine.backend.overlaps_comm}")
    llm.generate([prompts[0][:8]], SamplingParams(max_new=2))   # warm-up
    times = timed_engine(torch, llm.engine)
    kernels = (FA.flash_attention_bhsd, FA.paged_flash_attention,
               QC.qdq_absmax, QC.quantized_psum_absmax, QC.quantize_absmax,
               QC.dequant_accum_absmax)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with collective_ledger() as served:
        outs = llm.generate(prompts, SamplingParams(max_new=MAX_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    check_sync_launches("overlap path", llm, launches, times)
    toks = [o.token_ids for o in outs]
    if toks != dense_tokens:
        raise AssertionError(f"overlap tokens differ from the dense sim "
                             f"path's: {toks} vs {dense_tokens}")
    if min(launches["flash_attention_bhsd"], launches["qdq_absmax"]) <= 0:
        raise AssertionError(f"a kernel was not launched on the overlap "
                             f"path: {launches}")
    n_tok = sum(len(t) for t in toks)
    prefill_ms = 1e3 * sum(times["prefill"])
    decode_ms = 1e3 * sum(times["decode"]) / max(len(times["decode"]), 1)
    # shard (b)'s overlap pass holds rank 0's ledger to this one
    SIM_RUNS["overlap path"] = dict(ledger=ledger_rows(served),
                                    decode_ms=decode_ms)
    print(f"overlap path launches: {json.dumps(launches)}")
    print(f"overlap path [{card}]: prefill_ms={prefill_ms:.2f} "
          f"decode_ms_per_token={decode_ms:.2f} "
          f"({len(times['decode'])} steps) tokens_per_s={n_tok / wall:.1f} "
          f"({n_tok} tokens in {wall:.2f} s); all {n_tok} tokens equal the "
          "dense sim path's")
    same_tokens_plain(torch, "overlap path", llm, prompts, toks)

    eng, params = llm.engine, llm.params
    lat = LatencyModel(link_bytes_per_s=NVLINK_BYTES_PER_S,
                       launch_us=ASSUMED_LAUNCH_US)
    p = prompts[3]
    with collective_ledger(latency=lat, tp=2) as led_pre:
        _, c1 = bucketed_prefill(eng, params, p, len(p), 512)
    caches = eng.insert_slot(eng.blank_caches(4, 512), c1, 0)
    with collective_ledger(latency=lat, tp=2) as led_dec:
        eng.decode(params, np.full((4, 1), 7), np.asarray([len(p)] * 4),
                   caches)
    for label, led in (("prefill", led_pre), ("decode", led_dec)):
        ov = lat.summarize(led, overlap=eng.backend.overlaps_comm)
        perms = sum(e.op == "collective-permute" for e in led)
        print(f"overlap pricing [{card}; NVLink 450 GB/s each way, data "
              f"sheet; launch {ASSUMED_LAUNCH_US} us, assumed] {label} "
              f"({len(p) if label == 'prefill' else 4} tokens): "
              f"entries={len(led)} ring_steps={perms} "
              f"total_us={ov['total_us']:.3f} hidden_us={ov['hidden_us']:.3f} "
              f"exposed_us={ov['exposed_us']:.3f} "
              f"kept_sync_us={ov['kept_sync_us']:.3f} hidden_of_kept="
              f"{ov['hidden_us'] / max(ov['kept_sync_us'], 1e-12):.3f}")
        if not (abs(ov["hidden_us"] + ov["exposed_us"] - ov["total_us"])
                <= 1e-9 * max(1.0, ov["total_us"]) and perms > 0):
            raise AssertionError(f"overlap pricing of {label} does not add "
                                 f"up: {ov}, {perms} ring steps")

    rng = np.random.default_rng(2)
    toks0 = rng.integers(0, cfg.vocab_size, (4, 1))
    pos = np.zeros((4,), np.int64)

    def groups():
        return [(toks0 + i, pos, eng.blank_caches(4, 512))
                for i in range(PIPE_GROUPS)]

    def run(piped):
        gs = groups()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = (eng.decode_pipelined(params, gs, depth=2) if piped
               else [eng.decode(params, *g) for g in gs])
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # in turns (serial, pipelined, pipelined, serial) on the same card
    (serial, t_s1), (piped, t_p1) = run(False), run(True)
    (piped2, t_p2), (serial2, t_s2) = run(True), run(False)
    same = all(torch.equal(a[0], b[0]) for a, b in zip(serial, piped)) and \
        all(torch.equal(a[0], b[0]) for a, b in zip(serial2, piped2))
    print(f"decode_pipelined [{card}]: {PIPE_GROUPS} groups of 4, depth 2: "
          f"equal to serial {same}; host ms serial={1e3 * t_s1:.2f}/"
          f"{1e3 * t_s2:.2f} pipelined={1e3 * t_p1:.2f}/{1e3 * t_p2:.2f} "
          "(in turns S P P S)")
    if not same:
        raise AssertionError("decode_pipelined differs from serial decode")
    return launches


def ssd_work(bt, h, s, p, n, g, chunk, es) -> tuple:
    """Bytes the SSD scan must move (x, B, C read and y written in the
    input type; dt, a, D read and the final state written in fp32) and
    the multiply-adds x 2 it needs on this S: C.B^T once per (row, group)
    and chunk over the causal half, then per stream the decayed scores
    times x, C times the carried state and the state update."""
    nbytes = (es * (2 * bt * s * h * p + 2 * bt * s * g * n)
              + 4 * (bt * s * h + 2 * bt * h + bt * h * p * n))
    flops = 0
    for c0 in range(0, s, chunk):
        nr = min(chunk, s - c0)
        tri = nr * (nr + 1) // 2
        flops += 2 * bt * g * tri * n
        flops += 2 * bt * h * (tri * p + 2 * nr * n * p)
    return nbytes, flops


def ssd_inputs(torch, s, dtype, sh=SSD_SHAPE):
    """x, dt, a, B, C, D at shape `sh`: dt log-uniform in [1e-3, 1e-1] and
    A = -(1..16) over the heads (the model's init), B/C post-SiLU-like."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10 + s)
    bt, h, p, n, g = sh["bt"], sh["h"], sh["p"], sh["n"], sh["g"]
    x = torch.randn(bt, s, h, p, generator=gen, device=dev).to(dtype)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(bt, s, h, generator=gen,
                                               device=dev))
    a = -torch.linspace(1.0, 16.0, h, device=dev).expand(bt, h).contiguous()
    bm = torch.nn.functional.silu(torch.randn(
        bt, s, g, n, generator=gen, device=dev)).to(dtype)
    cm = torch.nn.functional.silu(torch.randn(
        bt, s, g, n, generator=gen, device=dev)).to(dtype)
    dd = torch.ones(bt, h, device=dev)
    return x, dt, a, bm, cm, dd


# B8's kernels by the names the profiler shows: bf16 runs the first three
# (one call launches each once), fp32 the last
SSD_KERNELS = ("ssd_scores_kernel", "ssd_states_kernel", "ssd_output_kernel",
               "ssd_scan_kernel")


def ssd_phase(torch, shape=SSD_SHAPE, seqs=SSD_SEQS, timed_s=SSD_TIMED_S,
              off_path=SSD_OFF_PATH,
              what="one layer of the 300-token prefill"):
    """The SSD chunked-scan kernels against their plain version at a
    path's `shape` (the mamba path's by default) over `seqs`, and one
    shape off the path, y and the final state; the device time of one
    bf16 call at S `timed_s` summed over its kernels."""
    from repro_torch.kernels import ssd_scan as SS

    chunk = shape["chunk"]
    timed = None
    dtypes = (torch.bfloat16, torch.float32)
    cases = [(dtype, s, shape) for dtype in dtypes for s in seqs]
    if off_path:
        cases += [(dtype, 300, off_path) for dtype in dtypes]
    for dtype, s, sh in cases:
        args = ssd_inputs(torch, s, dtype, sh)
        y, st = SS.ssd_scan(*args, chunk=sh["chunk"])
        yp, stp = SS.ssd_scan_plain(*args, chunk=sh["chunk"])
        torch.cuda.synchronize()
        ey = (y.float() - yp.float()).abs().max().item()
        es = (st - stp).abs().max().item()
        my = yp.float().abs().max().item()
        ms_ = stp.abs().max().item()
        if dtype == torch.float32:
            ty, ts = SSD_FP32_REL * my, SSD_FP32_REL * ms_
        else:
            ty, ts = SSD_BF16_Y_REL * my, SSD_BF16_STATE_REL * ms_
        print(f"ssd_scan {str(dtype)[6:]} S={s} G={sh['g']} P={sh['p']} "
              f"N={sh['n']} chunk={sh['chunk']}: y max_abs_err={ey:.3e} "
              f"tol={ty:.3e} (max|y|={my:.3e}); state max_abs_err="
              f"{es:.3e} tol={ts:.3e} (max|state|={ms_:.3e})")
        if not (ey <= ty and es <= ts):
            raise AssertionError(f"ssd_scan kernel disagrees at {dtype} "
                                 f"S={s}: y {ey} > {ty} or state {es} > "
                                 f"{ts}")
        if dtype == torch.bfloat16 and s == timed_s and sh is shape:
            timed = (args, ey)
    args, err = timed
    ms = cuda_ms(torch, lambda: SS.ssd_scan(*args, chunk=chunk), iters=20)
    plain_ms = cuda_ms(torch, lambda: SS.ssd_scan_plain(*args, chunk=chunk),
                       iters=20)
    prof = device_us(torch, lambda: SS.ssd_scan(*args, chunk=chunk),
                     SSD_KERNELS, iters=10, need=SSD_KERNELS[:3])
    ran = {k: us for k, us in prof.items() if us is not None}
    if set(ran) != set(SSD_KERNELS[:3]):
        raise AssertionError(f"a bf16 ssd_scan call must launch the three "
                             f"tensor-core kernels and nothing else: {prof}")
    call_us = sum(ran.values())        # each launches once a call
    sh = shape
    nbytes, flops = ssd_work(sh["bt"], sh["h"], timed_s, sh["p"],
                             sh["n"], sh["g"], chunk, 2)
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    print(f"ssd_scan (S={timed_s}, H={sh['h']}, N={sh['n']}, bf16): "
          f"ms={ms:.5f} plain_ms="
          f"{plain_ms:.5f} device_us_per_call={call_us:.2f} ("
          + ", ".join(f"{k} {us:.2f} us = {us / call_us:.0%}"
                      for k, us in ran.items())
          + f") bound_ms={b_ms:.6f} ({b_by}; {nbytes} bytes, {flops} flops) "
          f"library_ms=None (no single PyTorch call computes the SSD scan: "
          f"it is a chunked scan with a carried state, not one product)")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:66",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_us": call_us,
            "shape": f"x ({sh['bt']},{timed_s},{sh['h']},{sh['p']}) bf16, "
                     f"B/C ({sh['bt']},{timed_s},{sh['g']},{sh['n']}), "
                     f"chunk {chunk}: {what}; "
                     f"device_us per call, summed over its 3 kernels"}


class plain_ssd:
    """Inside: the model's SSD scan takes the plain version on the card
    (the kernel module's wrapper name, which kernels/ops calls, is
    swapped)."""

    def __enter__(self):
        from repro_torch.kernels import ssd_scan as SS
        self.saved = SS.ssd_scan
        SS.ssd_scan = SS.ssd_scan_plain

    def __exit__(self, *exc):
        from repro_torch.kernels import ssd_scan as SS
        SS.ssd_scan = self.saved


def fp32_run(torch, llm, prompts, label, cache_len=512, shard=False):
    """`llm`'s model cut to SHARD_FP32_LAYERS[label] at full width in
    fp32 with the plan's drop mask, quantized kept syncs and logits
    gather as SHARD_KW's (`tf_model`, then SHARD_KW's comm levels),
    served on its engine kind: sim here (its tokens, ledger, launches,
    logits and MoE routing, warm-up included, kept in
    SIM_RUNS[f"{label} fp32"] for the shard phase), or on the shard
    engine's ranks (`shard`: the LLM, for `shard_serve`), where every
    kept sync runs the send and receive kernels at the family's
    width."""
    from repro_torch.api import LLM, SamplingParams
    from repro_torch.parallel.collectives import collective_ledger

    # a rank casts the cut of its host tree on its card
    cfg, params, plan = tf_model(llm, "float32", SHARD_FP32_LAYERS[label],
                                 llm.device)
    kw = dict(tp=2, plan=plan, cache_len=cache_len, max_batch=4,
              params=params, comm=SHARD_KW["comm"],
              comm_logits=SHARD_KW["comm_logits"])
    if shard:
        return LLM.load(cfg, engine="shard", **kw)
    m = LLM.load(cfg, **kw)
    del params
    with RoutePin().record() as pin:
        m.generate([prompts[0][:8]], SamplingParams(max_new=2))  # warm-up
        kernels = all_kernels()
        for k in kernels:
            k.launches = 0
        with collective_ledger() as led, LogitsTape() as tape:
            outs = m.generate(prompts, SamplingParams(max_new=MAX_NEW))
    torch.cuda.synchronize()
    SIM_RUNS[f"{label} fp32"] = dict(
        tokens=[o.token_ids for o in outs], ledger=ledger_rows(led),
        launches={k.__name__: k.launches for k in kernels},
        tape=tape.host(), routes=pin.host())
    print(f"{label} fp32 (layers {SHARD_FP32_LAYERS[label]}, "
          f"{SHARD_KW['comm']} kept syncs and logits gather, {len(pin.kept)} "
          f"MoE routings kept for the shard phase): tokens[0] "
          f"{outs[0].token_ids}")
    del m
    release(torch)


def recurrent_path(torch, np, prompts, card, arch="mamba2-370m",
                   cache_len=512, label="mamba path"):
    """A full-width model with recurrent state (Mamba2-370M; hymba-1.5b)
    through the facade at tp=2, spd=0.25: every prefill layer through the
    SSD kernel at the prompt's own length, every kept sync through the
    fused kept-sync kernel and the logits gather through qdq; no flash
    or paged launch (a hybrid layer's attention is the plain one, as the
    reference's)."""
    from repro_torch.api import LLM, SamplingParams
    from repro_torch.core.blocks import ssm_heads
    from repro_torch.parallel.collectives import collective_ledger

    cfg = model_cfg(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM.load(cfg, tp=2, spd=0.25, comm="quant8", comm_logits="quant8",
                   dtype="bfloat16", cache_len=cache_len, max_batch=4, seed=0)
    torch.cuda.synchronize()
    print(f"{label}: loaded {cfg.name} (L={cfg.n_layers} d={cfg.d_model} "
          f"ssm heads {ssm_heads(cfg)} of {cfg.ssm.head_dim}, d_state "
          f"{cfg.ssm.d_state}, chunk {cfg.ssm.chunk_size}, attention window "
          f"{cfg.attn_window}, {cfg.param_count() / 1e6:.1f} M params) in "
          f"{time.perf_counter() - t0:.1f} s; plan drops "
          f"{llm.plan.n_dropped}/{cfg.n_layers} syncs (SPD applies: "
          f"{cfg.spd_applicable})")
    want_drop = round(cfg.n_layers * 0.25) if cfg.spd_applicable else 0
    if llm.plan.n_dropped != want_drop:
        raise AssertionError(f"{label}: the plan drops {llm.plan.n_dropped} "
                             f"syncs, want {want_drop}")
    llm.generate([prompts[0][:8]], SamplingParams(max_new=2))   # warm-up
    times = timed_engine(torch, llm.engine)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with collective_ledger() as led, \
            LogitsTape(label in TAPED_LABELS) as tape:
        outs = llm.generate(prompts, SamplingParams(max_new=MAX_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_sync_launches(label, llm, launches, times)
    SIM_RUNS[label] = dict(tokens=[o.token_ids for o in outs],
                           ledger=ledger_rows(led), launches=dict(launches),
                           tape=tape.host())
    for o, p in zip(outs, prompts):
        if (o.finish_reason != "length" or len(o.token_ids) != MAX_NEW
                or not all(0 <= t < cfg.vocab_size for t in o.token_ids)):
            raise AssertionError(f"{label} request {o.index} (prompt "
                                 f"{len(p)}) did not finish cleanly: {o}")
    want = cfg.n_layers * len(prompts)
    if (launches["ssd_scan"] != want or launches["qdq_absmax"] <= 0
            or launches["flash_attention_bhsd"]
            or launches["paged_flash_attention"]):
        raise AssertionError(f"{label} launches wrong: {launches} (want "
                             f"ssd_scan {want}, qdq > 0, flash/paged 0)")
    n_tok = sum(len(o.token_ids) for o in outs)
    prefill_ms = 1e3 * sum(times["prefill"])
    decode_ms = 1e3 * sum(times["decode"]) / max(len(times["decode"]), 1)
    print(f"{label} launches: {json.dumps(launches)}")
    print(f"{label} [{card}]: prefill_ms={prefill_ms:.2f} (4 requests, "
          f"prompts {[len(p) for p in prompts]}, each at its own length) "
          f"decode_ms_per_token={decode_ms:.2f} ({len(times['decode'])} "
          f"batch-4 steps) tokens_per_s={n_tok / wall:.1f} ({n_tok} tokens "
          f"in {wall:.2f} s) peak_memory_gib={peak:.2f} (load included)")
    print(f"{label} tokens[3]:", outs[3].token_ids)
    tokens = [o.token_ids for o in outs]
    same_tokens_plain(torch, label, llm, prompts, tokens)
    return llm, launches, tokens


def layer_outputs(fn):
    """fn() with every block's output (shard 0, fp32) captured in order."""
    from repro_torch.core import blocks as B
    outs, orig = [], B.block_seq

    def spy(*a, **kw):
        res = orig(*a, **kw)
        outs.append(res[0][0].float())
        return res

    B.block_seq = spy
    try:
        return fn(), outs
    finally:
        B.block_seq = orig


def recurrent_checks(torch, llm, prompt, toks, cache_len=512,
                     label="mamba"):
    """On a recurrent path's weights with exact syncs (a quantized sync
    turns a last-ulp difference into a quant step), fp32 then bf16:
    (a) prefill logits with the SSD kernel against the plain scan; (b)
    after prefilling `prompt` and teacher-forcing the generated `toks`
    through decode, the last decode logits against one exact-length
    prefill of prompt + toks[:-1] (ROADMAP C3 on the card; on hymba a
    prompt past the attention window checks the rolling buffer too).

    fp32 holds both to TF_FP32_ATOL.  In bf16 a rounding flip grows
    through the layers (the per-layer divergence is printed), and the
    plain version differs from itself by as much as from the kernel, at
    about 5% of the largest logit.  So each bf16 comparison is held to
    5% of the largest logit (TF_BF16_REL) or, where bf16 arithmetic alone
    spreads wider, to MAMBA_BF16_FLOOR times the same comparison made
    without the kernel: (a) the plain scan at chunk 256 against the plain
    scan at chunk 128 (the same function summed in another order), (b)
    the plain path's own decode against its own prefill.  A wrong scan
    or state is off by the size of the logits themselves."""
    import dataclasses
    import numpy as np
    from repro_torch.api import LLM
    from repro_torch.config.base import replace
    from repro_torch.core import blocks as B
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.runtime.forward import bucketed_prefill
    from repro_torch.tree import tree_map

    s = len(prompt)
    full = np.concatenate([prompt, np.asarray(toks[:-1])])

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def forced(m, c1):
        """The last decode logits after teacher-forcing toks[:-1]."""
        eng = m.engine
        caches = eng.insert_slot(eng.blank_caches(1, cache_len), c1, 0)
        for i, tok in enumerate(toks[:-1]):
            _, ld, caches = eng.decode_with_logits(
                m.params, np.asarray([[tok]]), np.asarray([s + i]), caches)
        return ld

    for dtype in ("float32", "bfloat16"):
        cfg = replace(llm.cfg, dtype=dtype)
        params = tree_map(lambda w: w.to(B.TORCH_DTYPES[dtype]),
                          llm.canonical)

        def load(c):
            return LLM.load(c, tp=2, plan=llm.plan.with_comm(None),
                            cache_len=cache_len, max_batch=1, params=params)

        m = load(cfg)
        SS.ssd_scan.launches = 0
        (lk, c1), outs_k = layer_outputs(lambda: bucketed_prefill(
            m.engine, m.params, prompt, s, cache_len))
        ran = SS.ssd_scan.launches
        SS.ssd_scan.launches = 0
        with plain_ssd():
            (lp, c1p), outs_p = layer_outputs(lambda: bucketed_prefill(
                m.engine, m.params, prompt, s, cache_len))
            ld_p = forced(m, c1p)
            lf_p, _ = bucketed_prefill(m.engine, m.params, full, len(full),
                                       cache_len)
        leaked = SS.ssd_scan.launches
        ld = forced(m, c1)
        lf, _ = bucketed_prefill(m.engine, m.params, full, len(full),
                                 cache_len)
        div = [err(a, b) / b.abs().max().item()
               for a, b in zip(outs_k, outs_p)]
        e_pre, e_tf = err(lk, lp), err(ld, lf)
        if dtype == "float32":
            tol_pre = tol_tf = TF_FP32_ATOL
            floors = ""
        else:
            m128 = load(replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, chunk_size=128)))
            with plain_ssd():
                lp128, _ = bucketed_prefill(m128.engine, m128.params, prompt,
                                            s, cache_len)
            del m128
            f_pre, f_tf = err(lp, lp128), err(ld_p, lf_p)
            # 5% of the largest logit, or the measured floor if wider
            tol_pre = max(TF_BF16_REL * lp.float().abs().max().item(),
                          MAMBA_BF16_FLOOR * f_pre)
            tol_tf = max(TF_BF16_REL * lf.float().abs().max().item(),
                         MAMBA_BF16_FLOOR * f_tf)
            floors = (f" [without the kernel: plain chunk 256 vs 128 "
                      f"{f_pre:.3e}; plain decode vs plain prefill "
                      f"{f_tf:.3e}]")
        scale = lp.float().abs().max().item()
        print(f"{label} prefill logits, kernel vs plain scan ({s} tokens, "
              f"{dtype}): max_abs_err={e_pre:.3e} tol={tol_pre:.3e} "
              f"max|logit|={scale:.3e} (err/max {e_pre / scale:.4f}) same "
              f"argmax={int(lk.argmax()) == int(lp.argmax())} kernel "
              f"launches={ran} plain-path launches={leaked}")
        print(f"{label} hidden divergence kernel vs plain ({dtype}), max|d| / "
              f"max|x| after layers 1/2/6/12/24/36/48: "
              + " ".join(f"{div[i]:.2e}" for i in (0, 1, 5, 11, 23, 35, 47)
                         if i < len(div)))
        scale = lf.float().abs().max().item()
        print(f"{label} teacher-forced decode ({s} + {len(toks) - 1} tokens, "
              f"{dtype}): last decode logits vs one {len(full)}-token prefill "
              f"max_abs_err={e_tf:.3e} tol={tol_tf:.3e} max|logit|="
              f"{scale:.3e} (err/max {e_tf / scale:.4f}) same argmax="
              f"{int(ld.argmax()) == int(lf.argmax())}{floors}")
        if not (e_pre <= tol_pre and ran == cfg.n_layers and leaked == 0):
            raise AssertionError(f"{label} kernel vs plain prefill failed "
                                 f"({dtype}): {e_pre} > {tol_pre}, launches "
                                 f"{ran}, plain-path launches {leaked}")
        if not e_tf <= tol_tf:
            raise AssertionError(f"{label} decode disagrees with an exact-"
                                 f"length prefill ({dtype}): {e_tf} > "
                                 f"{tol_tf}")
        del m


def flash_row(torch, q, k, v, err, what):
    """B1 on (q, k, v), timed (events and profile) beside its plain
    version and SDPA (the library call), with its bound: a kernels-line
    row.  A bf16 call must run the tensor-core kernel alone, an fp32 call
    the CUDA-core one."""
    from repro_torch.kernels import flash_attention as FA

    bh, s, d = q.shape
    bhkv = k.shape[0]
    dt = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    names = ("flash_fwd_tc_kernel", "flash_fwd_kernel")
    want = names[0] if dt == "bfloat16" else names[1]

    def call():
        return FA.flash_attention_bhsd(q, k, v)

    lib = sdpa_call(torch, q, k, v, bhkv)
    ms = cuda_ms(torch, call)
    plain_ms = cuda_ms(torch, lambda: FA.flash_attention_plain(q, k, v),
                       iters=10)
    library_ms = cuda_ms(torch, lib)
    ran = device_us(torch, call, names, need=(want,))
    if ran[want] is None or any(ran[n] is not None for n in names
                                if n != want):
        raise AssertionError(f"a {dt} flash call did not run {want} alone: "
                             f"{ran}")
    lib_us, _ = device_total_us(torch, lib)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4.0 * bh * (s * (s + 1) / 2) * d   # QK^T and PV, causal half
    b_ms, b_by = bound_ms(nbytes, flops, dt)
    shape = f"q ({bh},{s},{d}) kv ({bhkv},{s},{d}) {dt}, {what}"
    print(f"flash_attention_bhsd {shape}: ms={ms:.5f} plain_ms="
          f"{plain_ms:.5f} library_ms={library_ms:.5f} device_us="
          f"{ran[want]:.2f} library_device_us={lib_us:.2f} bound_ms="
          f"{b_ms:.6f} ({b_by})")
    return {"name": "flash_attention_bhsd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:187",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "device_us": ran[want], "library_device_us": lib_us,
            "shape": shape}


def paged_row(torch, case, what):
    """B2 on a paged_case (bf16), timed beside its plain version with
    its bound; gather + SDPA is context (no PyTorch call reads K/V
    through a page table).  A decode call (C = 1) must launch the split
    and combine kernels, a chunk call the tensor-core chunk kernel: a
    kernels-line row."""
    from repro_torch.kernels import flash_attention as FA

    q, kv, vv, table, pos, err = case
    tp, b, c, hq, d = q.shape
    hkv = kv.shape[-2]

    def call():
        return FA.paged_flash_attention(q, kv, vv, table, pos)

    ms = cuda_ms(torch, call)
    plain_ms = cuda_ms(torch, lambda: paged_plain(q, kv, vv, table, pos),
                       iters=10)
    gather_ms = cuda_ms(torch, gather_sdpa_call(torch, q, kv, vv, table,
                                                pos))
    nbytes, flops = paged_work(table, pos, c, q, kv)
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    names = (("paged_chunk_tc_kernel",) if c > 1 else
             ("paged_decode_split_kernel", "paged_decode_combine_kernel"))
    prof = device_us(torch, call, names, need=names)
    if None in prof.values():
        raise AssertionError(f"a C={c} paged call did not launch {names}: "
                             f"{prof}")
    dev_us = sum(prof.values())
    shape = (f"C={c}: q ({tp},{b},{c},{hq},{d}) bf16, group {hq // hkv}, "
             f"table ({b},{table.shape[1]}), pos {pos.tolist()}, {what}")
    print(f"paged_flash_attention {shape}: ms={ms:.5f} plain_ms="
          f"{plain_ms:.5f} device_us_per_call={dev_us:.2f} ("
          + " + ".join(f"{n} {u:.2f}" for n, u in prof.items())
          + f") bound_ms={b_ms:.6f} ({b_by}) gather + SDPA {gather_ms:.4f} "
          f"ms (context)")
    return {"name": ("paged_flash_attention_chunk" if c > 1
                     else "paged_flash_attention"),
            "route": "cuda", "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:136",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_us": dev_us, "context_ms": gather_ms, "shape": shape}


def paper_kernel_phase(torch, card):
    """B1, B2 and B3 at the shapes of the paper's models, each against
    its plain version with the earlier tolerances and timed: B1 at head
    dim 128 and group 1 (llama2-7b and opt-6.7b at tp=2: 16 q and 16 kv
    heads a shard) at S 1, 63, 300, 512, and at groups 2 (qwen3-1.7b) and
    8 (qwen2-72b) at S 300, bf16 and fp32; B2's decode and chunk calls at
    D 128, groups 1 and 8; the fused kept sync at llama's decode and
    512-token prefill syncs; B3 alone on the logits gathers of llama
    (16000 columns a shard) and OPT (25136: 196 chunks and a ragged 48).
    Returns kernels-line rows, each tagged with the path whose launches
    it reports (`_path`)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quant_collectives as QC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for label, hq, hkv in PAPER_FLASH_GROUPS:
        seqs = PAPER_FLASH_SEQS if hq == hkv else (PAPER_GROUPS_S,)
        for dtype in (torch.bfloat16, torch.float32):
            for s in seqs:
                q, k, v = flash_inputs(torch, gen, s, 128, dtype,
                                       bh=2 * hq, bhkv=2 * hkv)
                out = FA.flash_attention_bhsd(q, k, v)
                ref = FA.flash_attention_plain(q, k, v)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = (FLASH_FP32_ATOL if dtype == torch.float32 else
                       2.0 ** -7 * max(ref.float().abs().max().item(), 1e-3))
                print(f"flash {str(dtype)[6:]} S={s} D=128 group "
                      f"{hq // hkv} ({label}): max_abs_err={err:.3e} "
                      f"tol={tol:.3e}")
                if not err <= tol:
                    raise AssertionError(f"flash kernel disagrees at {dtype} "
                                         f"S={s} D=128 group {hq // hkv}: "
                                         f"{err} > {tol}")
                row = flash_row(torch, q, k, v, err,
                                f"group {hq // hkv} ({label})")
                row["_path"] = "llama2-7b" if hq == hkv else None
                rows.append(row)
    for hq, hkv in PAPER_PAGED_HEADS:
        for dtype in (torch.bfloat16, torch.float32):
            for c, at, holes in PAPER_PAGED_CASES:
                case = paged_case(torch, dtype, c, None, at, holes, d=128,
                                  hq=hq, hkv=hkv, layers=4)
                q, kv, vv, table, pos = case
                out = FA.paged_flash_attention(q, kv, vv, table, pos)
                ref = paged_plain(q, kv, vv, table, pos)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = (FLASH_FP32_ATOL if dtype == torch.float32 else
                       2.0 ** -7 * max(ref.float().abs().max().item(), 1e-3))
                print(f"paged {str(dtype)[6:]} C={c} D=128 group "
                      f"{hq // hkv} pos={pos.tolist()} holes={list(holes)}: "
                      f"max_abs_err={err:.3e} tol={tol:.3e}")
                if not err <= tol:
                    raise AssertionError(f"paged kernel disagrees at {dtype} "
                                         f"C={c} D=128 group {hq // hkv} "
                                         f"pos={pos.tolist()}: {err} > {tol}")
                if dtype == torch.bfloat16 and at is None and not holes:
                    row = paged_row(torch, case + (err,),
                                    "llama2-7b's heads" if hq == hkv
                                    else "qwen2-72b's heads")
                    row["_path"] = "llama2-7b paged" if hq == hkv else None
                    rows.append(row)
    for tp, n in PAPER_QPSUM:
        rows.append(checked_qpsum_row(torch, gen, card, tp, n, "llama2-7b",
                                      "a llama2-7b kept sync at d 4096"))
    for (r, n), path in zip(PAPER_QDQ, ("llama2-7b", "opt-6.7b")):
        rows.append(checked_qdq_row(torch, gen, r, n, path))
    return rows


def checked_qpsum_row(torch, gen, card, tp, n, path, what):
    """The fused kept sync on a (tp, n) payload (row 1 ten times row 0)
    bit for bit against its plain version in bf16 and fp32 at L 127 and
    7, then its kernels-line row (bf16), tagged with `path`."""
    from repro_torch.kernels import quant_collectives as QC

    base = torch.randn(tp, n, generator=gen, device=torch.device("cuda"))
    base[1] *= 10.0
    for dtype in (torch.bfloat16, torch.float32):
        x = base.to(dtype)
        for levels in (127, 7):
            out = QC.quantized_psum_absmax(x, levels=levels)
            ref = QC.quantized_psum_absmax_plain(x, levels=levels)
            torch.cuda.synchronize()
            if not same_bits(torch, out, ref):
                raise AssertionError(f"quantized_psum kernel not bit-"
                                     f"identical at ({tp},{n}) {dtype} "
                                     f"L={levels}")
    print(f"quantized_psum ({tp},{n}): bit-identical in bf16 and fp32 at L "
          f"127 and 7")
    row = qpsum_row(torch, base.to(torch.bfloat16), card, what)
    row["_path"] = path
    return row


def checked_qdq_row(torch, gen, r, n, path):
    """B3 alone on an (r, n) fp32 logits slice, bit for bit against its
    plain version at L 127 and 7, then its kernels-line row, tagged with
    `path`."""
    from repro_torch.kernels import quant_collectives as QC

    x = torch.randn(r, n, generator=gen, device=torch.device("cuda"))
    x[1] *= 10.0
    for levels in (127, 7):
        out = QC.qdq_absmax(x, levels=levels)
        ref = QC.qdq_absmax_plain(x, levels=levels)
        torch.cuda.synchronize()
        if not same_bits(torch, out, ref):
            raise AssertionError(f"qdq kernel not bit-identical at "
                                 f"({r},{n}) L={levels}")
    print(f"qdq ({r},{n}): bit-identical at L 127 and 7")
    row = qdq_row(torch, x, 0.0, f"the {path} logits gather")
    row["_path"] = path
    return row


def sweep_phase(torch, np, llm, prompts, card):
    """Algorithm 1 on the full-width model `llm` (bf16, random weights):
    the sensitivity sweep (L+1 suffix plans x the calibration batches,
    every forward through B1) with the flash kernel and with the plain
    attention; then `apply_comm_policy` with n_spd = N_SPD and (tau1,
    tau2) at the 25th and 75th percentiles of the measured
    sensitivities, so that dropped, quant8 and exact syncs run in one
    plan; then a counted generate under that plan.  Returns the
    generate's launches."""
    from repro_torch.api import SamplingParams
    from repro_torch.config.base import replace
    from repro_torch.core import sensitivity as S
    from repro_torch.core import spd as SPD
    from repro_torch.data import calibration_batches
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quant_collectives as QC
    from repro_torch.parallel.collectives import collective_ledger

    cfg, n = llm.cfg, llm.cfg.n_layers
    calib = calibration_batches(cfg.vocab_size, **SWEEP_CALIB)
    res = {}
    for backend in ("pallas", "xla"):
        FA.flash_attention_bhsd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[backend], _ = SPD.sweep_sensitivity(
            replace(cfg, attn_backend=backend), llm.canonical, calib,
            llm.tp, q_chunk=llm.q_chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = FA.flash_attention_bhsd.launches
        want = (n + 1) * len(calib) * n if backend == "pallas" else 0
        print(f"sweep [{card}] ({backend} attention): {n + 1} evaluations x "
              f"{len(calib)} batches of {tuple(calib[0]['tokens'].shape)} "
              f"x {n} layers in {wall:.2f} s; flash launches {ran} (want "
              f"{want}); peak_memory_gib="
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}")
        if ran != want:
            raise AssertionError(f"the sweep's flash launches {ran} != "
                                 f"{want}")
    r, rx = res["pallas"], res["xla"]
    print("sweep ppl_suffix (flash):", json.dumps(
        [round(float(v), 4) for v in r.ppl_suffix]))
    rel = np.abs(r.ppl_suffix / rx.ppl_suffix - 1.0)
    print(f"sweep: perplexities with the flash kernel vs the plain "
          f"attention, max relative difference {rel.max():.3e} (tol "
          f"{SWEEP_PPL_RTOL:.0e}); rankings agree at "
          f"{int((r.ranking == rx.ranking).sum())}/{n} places")
    if not (np.isfinite(r.ppl_suffix).all() and rel.max() <= SWEEP_PPL_RTOL):
        raise AssertionError("sweep perplexities are not finite or the "
                             f"kernel's differ from the plain ones: {rel}")
    tau1, tau2 = (float(np.percentile(r.sensitivity, 25)),
                  float(np.percentile(r.sensitivity, 75)))
    FA.flash_attention_bhsd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = llm.apply_comm_policy(calib, n_spd=N_SPD, tau1=tau1, tau2=tau2,
                                logits="quant8")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tiers = S.classify(got.sensitivity, tau1, tau2)
    modes = llm.plan.modes()
    print(f"apply_comm_policy [{card}]: n_spd={N_SPD} tau1={tau1:.4f} "
          f"tau2={tau2:.4f} in {wall:.2f} s (sweep and re-placement; flash "
          f"launches {FA.flash_attention_bhsd.launches}); peak_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}")
    print("apply_comm_policy sensitivity:", json.dumps(
        [round(float(v), 4) for v in got.sensitivity]))
    print("apply_comm_policy ranking:", got.ranking.tolist())
    print("apply_comm_policy tiers:", " ".join(
        f"{i}:{t}" for i, t in enumerate(tiers)))
    print("apply_comm_policy plan:", " ".join(
        f"{i}:{m}" for i, m in enumerate(modes)))
    print(f"apply_comm_policy: perplexities equal the first sweep's: "
          f"{bool(np.array_equal(got.ppl_suffix, r.ppl_suffix))}")
    if not (np.isfinite(got.ppl_suffix).all()
            and sorted(got.ranking.tolist()) == list(range(n))
            and 0 < llm.plan.n_dropped <= N_SPD
            and {"drop", "quant8", "exact"} <= set(modes)):
        raise AssertionError(f"the tiered plan is not what Algorithm 1 "
                             f"gives: {modes}")

    SIM_RUNS[ALG1_SWEEP] = dict(ppl=got.ppl_suffix, sens=got.sensitivity,
                                ranking=got.ranking.tolist(), tau1=tau1,
                                tau2=tau2, plan=llm.plan, wall=wall)

    llm.generate([prompts[0][:8]], SamplingParams(max_new=2))   # warm-up
    times = timed_engine(torch, llm.engine)
    kernels = (FA.flash_attention_bhsd, QC.qdq_absmax,
               QC.quantized_psum_absmax)
    for k in kernels:
        k.launches = 0
    with collective_ledger() as led, LogitsTape() as tape:
        outs = llm.generate(prompts, SamplingParams(max_new=MAX_NEW))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    SIM_RUNS[ALG1_TIERED] = dict(tokens=[o.token_ids for o in outs],
                                 ledger=ledger_rows(led),
                                 launches=dict(launches), tape=tape.host())
    check_sync_launches("tiered plan", llm, launches, times)
    if min(launches.values()) <= 0 or any(
            len(o.token_ids) != MAX_NEW for o in outs):
        raise AssertionError(f"the tiered plan's generate failed: {launches}")
    decode_ms = 1e3 * sum(times["decode"]) / max(len(times["decode"]), 1)
    print(f"tiered plan [{card}]: launches {json.dumps(launches)} "
          f"prefill_ms={1e3 * sum(times['prefill']):.2f} "
          f"decode_ms_per_token={decode_ms:.2f}; tokens[0] "
          f"{outs[0].token_ids}")
    return r


def recovery_taus(np, res, n_spd):
    """(tau1, tau2) halfway between sorted sensitivities of the n_spd
    cheapest blocks: the cheapest quarter are ISB, the dearest quarter
    ESB (at least one each), the rest SB, and no chosen block sits on a
    threshold."""
    s = np.sort(res.sensitivity[res.ranking[:n_spd]])
    k = max(n_spd // 4, 1)
    return float((s[k - 1] + s[k]) / 2), float((s[-k - 1] + s[-k]) / 2)


def student_grads(torch, cfg, kind, tp, split, x, out_t):
    """The distillation loss's gradients (the shard-summed fp32 MSE of
    the SPD block against `out_t`) with respect to `split`."""
    from repro_torch.core import blocks as B
    from repro_torch.core import model as M
    from repro_torch.core import simtp
    from repro_torch.tree import tree_leaves

    xs = x[None].expand((tp,) + tuple(x.shape))
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    p, leaves = simtp.grad_leaves(split)
    out, _, _ = B.block_seq(cfg, kind, M._gqa_layout(cfg, tp), p, xs, pos,
                            drop=True)
    d = (out - out_t).float()
    return tree_leaves(simtp.grads_of((d * d).flatten(1).mean(1).sum(),
                                      split, leaves))


def recovery_checks(torch, llm, report, layer_x, card):
    """On full-width layers, in fp32 and bf16: (a) the student's
    gradients with B1 under autograd against the plain attention's, on
    the first SB block; (b) on the first ESB block in fp32, the TP-mode
    block output of the grouped (permuted) layer against the unpermuted
    one, and the SPD-mode output moving."""
    from repro_torch.config.base import replace
    from repro_torch.core import blocks as B
    from repro_torch.core import grouping as G
    from repro_torch.core import simtp
    from repro_torch.core.layer_kinds import layer_kinds
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.tree import tree_map

    kinds, tp = layer_kinds(llm.cfg), llm.tp
    sb = next(b for b, c in zip(report.chosen, report.categories)
              if c == "SB")
    esb = next(b for b, c in zip(report.chosen, report.categories)
               if c == "ESB")
    for dtype in ("float32", "bfloat16"):
        dt = B.TORCH_DTYPES[dtype]
        layer = tree_map(lambda w: w.to(dt), llm.canonical["layers"][sb])
        split = simtp.split_layer(layer, replace(llm.cfg, dtype=dtype),
                                  kinds[sb], tp)
        x = layer_x[sb].to(dt)
        cfgs = {b: replace(llm.cfg, dtype=dtype, attn_backend=b)
                for b in ("pallas", "xla")}
        pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
        out_t = simtp.make_block_fn(cfgs["xla"], kinds[sb], tp,
                                    drop=False)(split, x, pos)
        before = FA.flash_attention_bhsd.launches
        g_k = student_grads(torch, cfgs["pallas"], kinds[sb], tp, split, x,
                            out_t)
        ran = FA.flash_attention_bhsd.launches - before
        g_p = student_grads(torch, cfgs["xla"], kinds[sb], tp, split, x,
                            out_t)
        num = math.sqrt(sum(float((a.float() - b.float()).square().sum())
                            for a, b in zip(g_k, g_p)))
        den = math.sqrt(sum(float(b.float().square().sum()) for b in g_p))
        worst = max(float((a.float() - b.float()).norm()
                          / max(float(b.float().norm()), 1e-30))
                    for a, b in zip(g_k, g_p))
        tol = RECOVERY_GRAD_RTOL[dtype]
        print(f"recovery grads [{card}] ({dtype}, layer {sb}, {len(g_k)} "
              f"leaves): |g_B1 - g_plain| / |g_plain| = {num / den:.3e} "
              f"(tol {tol:.0e}; worst leaf {worst:.3e}); B1 launches {ran}")
        if ran != 1 or not num / den <= tol:
            raise AssertionError(f"the student's gradients through B1 "
                                 f"({dtype}) differ from the plain "
                                 f"attention's: {num / den} > {tol}, or "
                                 f"B1 ran {ran} times (want 1)")
        del split, g_k, g_p, layer
    gres = report.grouping[esb]
    cfg32 = replace(llm.cfg, dtype="float32")
    layer = tree_map(lambda w: w.float(), llm.canonical["layers"][esb])
    permuted = G.apply_grouping(layer, cfg32, gres, tp)
    x = layer_x[esb].float()
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    outs = {}
    for drop in (False, True):
        fn = simtp.make_block_fn(cfg32, kinds[esb], tp, drop=drop)
        a, b = (fn(simtp.split_layer(lp, cfg32, kinds[esb], tp), x, pos)
                for lp in (layer, permuted))
        outs[drop] = float((a - b).norm() / a.norm())
    print(f"grouping [{card}] (fp32, layer {esb}, groups of "
          f"{[len(g) for g in gres.groups]} heads, assignment "
          f"{gres.assignment}): TP output moved by {outs[False]:.3e} "
          f"(tol {GROUPING_TP_RTOL:.0e}), SPD output by {outs[True]:.3e}")
    if not outs[False] < GROUPING_TP_RTOL:
        raise AssertionError(f"the grouping permutation changed the TP "
                             f"block output: {outs[False]}")


def recovery_phase(torch, np, llm, prompts, sweep_res, card):
    """Algorithm 1 with recovery on the full-width model `llm` (bf16,
    random weights, B1 prefill): `LLM.apply_spd(calib, n_spd=N_SPD, tau1,
    tau2, lr=RECOVERY_LR, epochs=RECOVERY_EPOCHS, strategies=("ZS",
    "B2B", "HG"))` over
    the sweep's calibration batches.  (tau1, tau2) sit halfway between the
    sorted sensitivities of the N_SPD cheapest blocks of `sweep_res` (the
    same sweep apply_spd repeats), so that two blocks are ISB, two ESB
    and the rest SB.  B1's launches are counted part by part (the sweep;
    the capture, 2 batches x L layers; 2 per distill step, teacher and
    student) and must be what the code implies.  Every distilled block's
    mean loss over its last epoch must be below its first epoch's, every
    ESB block's grouping supported and a partition of the heads; then
    `recovery_checks` and a counted greedy generate under the distilled
    plan.  Returns the B1 launches of the apply_spd call."""
    from repro_torch.api import SamplingParams
    from repro_torch.core import distill as D
    from repro_torch.core import spd as SPD
    from repro_torch.data import calibration_batches
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quant_collectives as QC
    from repro_torch.parallel.collectives import collective_ledger

    cfg, n = llm.cfg, llm.cfg.n_layers
    calib = calibration_batches(cfg.vocab_size, **SWEEP_CALIB)
    tau1, tau2 = recovery_taus(np, sweep_res, N_SPD)
    counts = {"capture": [], "distill": []}
    layer_x, step_s = {}, []
    capture, distill = SPD.capture_block_inputs, D.b2b_distill
    make_step = D.make_distill_step

    def timed_make_step(*a, **kw):
        fn = make_step(*a, **kw)
        step_s.append([])

        def step(*sa):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*sa)
            step_s[-1].append(time.perf_counter() - t)   # loss read: synced
            return out
        return step

    def counted_capture(*a, **kw):
        counts["sweep"] = FA.flash_attention_bhsd.launches
        hid = capture(*a, **kw)
        counts["capture"].append(FA.flash_attention_bhsd.launches
                                 - counts["sweep"])
        for i in range(n):
            layer_x[i] = hid[0][i]
        return hid

    def counted_distill(*a, **kw):
        before = FA.flash_attention_bhsd.launches
        out = distill(*a, **kw)
        counts["distill"].append((FA.flash_attention_bhsd.launches - before,
                                  len(out[1])))
        return out

    FA.flash_attention_bhsd.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SPD.capture_block_inputs, D.b2b_distill = counted_capture, counted_distill
    D.make_distill_step = timed_make_step
    t0 = time.perf_counter()
    try:
        report = llm.apply_spd(calib, n_spd=N_SPD, tau1=tau1, tau2=tau2,
                               lr=RECOVERY_LR, epochs=RECOVERY_EPOCHS,
                               strategies=("ZS", "B2B", "HG"))
    finally:
        SPD.capture_block_inputs, D.b2b_distill = capture, distill
        D.make_distill_step = make_step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = FA.flash_attention_bhsd.launches
    cats = dict(zip(report.chosen, report.categories))
    steps = sum(k for _, k in counts["distill"])
    sec = report.seconds
    print(f"apply_spd [{card}]: n_spd={N_SPD} tau1={tau1:.4f} "
          f"tau2={tau2:.4f} lr={RECOVERY_LR:g} epochs={RECOVERY_EPOCHS}: "
          f"tiers "
          + " ".join(f"{b}:{c}" for b, c in cats.items()))
    print(f"apply_spd [{card}]: {wall:.2f} s wall (sweep {sec['sweep']:.2f}"
          f" s, capture {sec['capture']:.3f} s, grouping "
          f"{sec['grouping']:.2f} s, distillation {sec['distill']:.2f} s = "
          f"{1e3 * sec['distill'] / max(steps, 1):.2f} ms per distill step "
          f"over {steps} steps, re-placement the rest); peak_memory_gib="
          f"{peak:.2f}")
    firsts = [1e3 * t[0] for t in step_s]
    rest = [1e3 * v for t in step_s for v in t[1:]]
    print(f"apply_spd distill steps [{card}]: each block's first step "
          f"{json.dumps([round(v, 2) for v in firsts])} ms, the other "
          f"{len(rest)} {np.mean(rest):.2f} ms on average (min "
          f"{min(rest):.2f}, max {max(rest):.2f}); outside the steps "
          f"{sec['distill'] - sum(sum(t) for t in step_s):.2f} s")
    want = {"sweep": (n + 1) * len(calib) * n,
            "capture": [len(calib) * n],
            "distill": [(2 * k, k) for _, k in counts["distill"]]}
    got = {"sweep": counts.get("sweep"), "capture": counts["capture"],
           "distill": counts["distill"]}
    print(f"apply_spd B1 launches: sweep {got['sweep']} (want "
          f"{want['sweep']}), capture {got['capture']} (want "
          f"{want['capture']}), distill {[a for a, _ in got['distill']]} "
          f"over {[k for _, k in got['distill']]} steps (2 a step); total "
          f"{total}")
    n_rec = sum(c != "ISB" for c in report.categories)
    if (got != want or total != got["sweep"] + sum(got["capture"])
            + 2 * steps or len(counts["distill"]) != n_rec
            or steps != n_rec * RECOVERY_EPOCHS * len(calib)):
        raise AssertionError(f"apply_spd's B1 launches are not what the "
                             f"code implies: {got} vs {want}, total {total}")
    if set(report.categories) != {"ISB", "SB", "ESB"}:
        raise AssertionError(f"the chosen blocks do not span the three "
                             f"tiers: {cats}")
    per_epoch, rose = len(calib), {}
    for b, losses in sorted(report.distill_losses.items()):
        first = float(np.mean(losses[:per_epoch]))
        last = float(np.mean(losses[-per_epoch:]))
        print(f"distill block {b} ({cats[b]}): loss first epoch {first:.4e} "
              f"last epoch {last:.4e} ({last / first:.3f}x); steps "
              f"{json.dumps([round(v, 7) for v in losses])}")
        if not (np.isfinite(losses).all() and last < first):
            rose[b] = (first, last)
    if rose:
        raise AssertionError(f"distillation losses did not fall from the "
                             f"first epoch to the last: {rose}")
    for b, c in cats.items():
        if c != "ESB":
            continue
        g = report.grouping[b]
        print(f"grouping block {b}: supported={g.supported} score="
              f"{g.score:.4f} assignment={g.assignment} groups={g.groups}")
        if not (g.supported and sorted(h for grp in g.groups for h in grp)
                == list(range(cfg.n_heads))
                and len(g.groups) == llm.tp
                and sorted(g.assignment) == list(range(llm.tp))):
            raise AssertionError(f"block {b}'s grouping is not a partition "
                                 f"of the heads: {g}")
    if llm.plan.n_dropped != N_SPD:
        raise AssertionError(f"the distilled plan drops "
                             f"{llm.plan.n_dropped} syncs, not {N_SPD}")

    recovery_checks(torch, llm, report, layer_x, card)
    layer_x.clear()
    SIM_RUNS[ALG1_RECOVERY] = dict(
        tau1=tau1, tau2=tau2, ppl=report.ppl_suffix,
        ranking=report.ranking.tolist(), categories=list(report.categories),
        chosen=list(report.chosen), modes=llm.plan.modes(), wall=wall,
        seconds=dict(sec), b1=total)

    llm.generate([prompts[0][:8]], SamplingParams(max_new=2))   # warm-up
    times = timed_engine(torch, llm.engine)
    kernels = (FA.flash_attention_bhsd, QC.qdq_absmax,
               QC.quantized_psum_absmax)
    for k in kernels:
        k.launches = 0
    with collective_ledger() as led, LogitsTape() as tape:
        outs = llm.generate(prompts, SamplingParams(max_new=MAX_NEW))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    SIM_RUNS[ALG1_DISTILLED] = dict(tokens=[o.token_ids for o in outs],
                                    ledger=ledger_rows(led),
                                    launches=dict(launches),
                                    tape=tape.host())
    check_sync_launches("distilled plan", llm, launches, times)
    if launches["flash_attention_bhsd"] <= 0 or any(
            o.finish_reason != "length" or len(o.token_ids) != MAX_NEW
            for o in outs):
        raise AssertionError(f"the distilled plan's generate failed: "
                             f"{launches}")
    decode_ms = 1e3 * sum(times["decode"]) / max(len(times["decode"]), 1)
    print(f"distilled plan [{card}]: launches {json.dumps(launches)} "
          f"prefill_ms={1e3 * sum(times['prefill']):.2f} "
          f"decode_ms_per_token={decode_ms:.2f}; tokens[0] "
          f"{outs[0].token_ids}")
    return total


def recovery_row(torch, launches):
    """B1 at the shape of llama2-7b's distill step and capture (bf16, tp=2
    x batch 2 x 16 heads a shard, S 128, D 128), checked against its
    plain version and timed: a kernels-line row carrying `launches`, the
    apply_spd call's count."""
    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(11)
    q, k, v = flash_inputs(torch, gen, 128, 128, torch.bfloat16, bh=64,
                           bhkv=64)
    out = FA.flash_attention_bhsd(q, k, v)
    ref = FA.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = 2.0 ** -7 * max(ref.float().abs().max().item(), 1e-3)
    print(f"flash bfloat16 S=128 D=128 group 1 (apply_spd): max_abs_err="
          f"{err:.3e} tol={tol:.3e}")
    if not err <= tol:
        raise AssertionError(f"flash kernel disagrees at the distill "
                             f"step's shape: {err} > {tol}")
    row = flash_row(torch, q, k, v, err, "llama2-7b apply_spd: capture and "
                    "distill steps")
    row["_path"] = "apply_spd"
    row["launches"] = launches
    return row


def decode_vs_prefill(torch, llm, prompt, toks, fp32_layers=None,
                      label=""):
    """After prefilling `prompt` and teacher-forcing `toks[:-1]` through
    dense decode, the last decode logits against one exact-length
    prefill of prompt + toks[:-1], exact syncs: on OPT, the learned
    positions added at decode positions.  fp32 (at `fp32_layers`) is
    held to TF_FP32_ATOL; bf16 at full width to 5% of the largest logit
    or, where bf16 alone spreads wider, MAMBA_BF16_FLOOR times the same
    comparison made with the plain attention."""
    import numpy as np
    from repro_torch.api import LLM
    from repro_torch.config.base import replace
    from repro_torch.runtime.forward import bucketed_prefill

    s = len(prompt)
    full = np.concatenate([prompt, np.asarray(toks[:-1])])

    def err_of(backend, cfg, params, plan):
        m = LLM.load(replace(cfg, attn_backend=backend), tp=2, plan=plan,
                     cache_len=512, max_batch=1, params=params)
        eng = m.engine
        _, c1 = bucketed_prefill(eng, m.params, prompt, s, 512)
        caches = eng.insert_slot(eng.blank_caches(1, 512), c1, 0)
        for i, tok in enumerate(toks[:-1]):
            _, ld, caches = eng.decode_with_logits(
                m.params, np.asarray([[tok]]), np.asarray([s + i]), caches)
        lf, _ = bucketed_prefill(eng, m.params, full, len(full), 512)
        return ((ld.float() - lf.float()).abs().max().item(),
                lf.float().abs().max().item())

    for dtype in ("float32", "bfloat16"):
        cfg, params, plan = tf_model(llm, dtype, fp32_layers)
        e, scale = err_of("pallas", cfg, params, plan)
        if dtype == "float32":
            tol, floor = TF_FP32_ATOL, ""
        else:
            e_plain, _ = err_of("xla", cfg, params, plan)
            tol = max(TF_BF16_REL * scale, MAMBA_BF16_FLOOR * e_plain)
            floor = f" [plain attention: {e_plain:.3e}]"
        del params
        print(f"{label}decode vs prefill ({s} + {len(toks) - 1} tokens, "
              f"{dtype}, {cfg.n_layers} layers): max_abs_err={e:.3e} "
              f"tol={tol:.3e} max|logit|={scale:.3e}{floor}")
        if not e <= tol:
            raise AssertionError(f"{label}decode disagrees with an exact-"
                                 f"length prefill ({dtype}): {e} > {tol}")


# ---------------------------------------------------------------------------
# Speculative decoding and chunked prefill on llama2-7b (the eleventh slice)
# ---------------------------------------------------------------------------

def qpsum_grad_check(torch):
    """The fused kept sync and B3 under autograd on the card: the forward
    is the kernel (its launch counts, no refusal), bit for bit the plain
    version, and the backward passes the cotangent through unchanged."""
    from repro_torch.kernels import quant_collectives as QC
    from repro_torch.parallel import compression as C

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(2, 4096, generator=gen, device=dev).to(torch.bfloat16)
    x.requires_grad_()
    ct = torch.randn(2, 4096, generator=gen, device=dev).to(torch.bfloat16)
    n0, q0 = QC.quantized_psum_absmax.launches, QC.qdq_absmax.launches
    y = C.quantized_psum(x, "model", bits=8)
    y.backward(ct)
    torch.cuda.synchronize()
    same = same_bits(torch, y.detach(), QC.quantized_psum_absmax_plain(
        x.detach(), levels=127))
    grad_ok = torch.equal(x.grad, ct)
    x.grad = None
    C.qdq(x, bits=8).backward(ct.float())
    torch.cuda.synchronize()
    ste_ok = torch.equal(x.grad, ct)
    runs = (QC.quantized_psum_absmax.launches - n0,
            QC.qdq_absmax.launches - q0)
    print(f"kept sync under autograd (2,4096) bf16: kernel launches "
          f"{runs[0]}, forward bit-identical to the plain version: {same}, "
          f"backward identity: {grad_ok}; qdq (straight through) launches "
          f"{runs[1]}, backward identity: {ste_ok}")
    if not (same and grad_ok and ste_ok and runs == (1, 1)):
        raise AssertionError("the kept sync under autograd did not run the "
                             "kernel forward with an identity backward")


def verify_kernel_phase(torch):
    """B2's chunk kernel at the speculative verify's small C: C in
    VERIFY_CS at D 128, groups 1 (llama2-7b) and 8, bf16 (the tensor-core
    chunk kernel) and fp32 (the CUDA-core one), every row live, with the
    chunks starting on a page boundary and one position before it; then
    the chain verify's call (C = SPEC_K + 1 at the serving positions)
    timed for the kernels line."""
    from repro_torch.kernels import flash_attention as FA

    for hq, hkv in PAPER_PAGED_HEADS:
        for dtype in (torch.bfloat16, torch.float32):
            worst = {}
            for c in VERIFY_CS:
                for at in VERIFY_POS:
                    case = paged_case(torch, dtype, c, None, at, (), d=128,
                                      hq=hq, hkv=hkv, layers=4)
                    q, kv, vv, table, pos = case
                    out = FA.paged_flash_attention(q, kv, vv, table, pos)
                    ref = paged_plain(q, kv, vv, table, pos)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    tol = (FLASH_FP32_ATOL if dtype == torch.float32 else
                           2.0 ** -7 * max(ref.float().abs().max().item(),
                                           1e-3))
                    if not err <= tol:
                        raise AssertionError(
                            f"paged kernel disagrees at {dtype} C={c} D=128 "
                            f"group {hq // hkv} pos={list(at)}: {err} > "
                            f"{tol}")
                    worst[c] = max(worst.get(c, 0.0), err / tol)
            print(f"paged {str(dtype)[6:]} verify chunks D=128 group "
                  f"{hq // hkv} at {[list(p) for p in VERIFY_POS]}: "
                  + ", ".join(f"C={c} max err/tol {w:.3f}"
                              for c, w in worst.items()))
    c = SPEC_K + 1
    case = paged_case(torch, torch.bfloat16, c, None, PAGED_POS, (), d=128,
                      hq=16, hkv=16, layers=4)
    q, kv, vv, table, pos = case
    out = FA.paged_flash_attention(q, kv, vv, table, pos)
    err = (out.float() - paged_plain(q, kv, vv, table, pos).float()
           ).abs().max().item()
    row = paged_row(torch, case + (err,), "llama2-7b's chain verify "
                    f"(k={SPEC_K})")
    row["shape"] = "chain verify, " + row["shape"]
    return row


def spec_counter(torch, engine, names):
    """Wrap `names` of `engine` with synchronized host timers; each call
    records (seconds, forwards): a draft call runs k forwards (the
    catch-up and k-1 one-token steps), a chunked prefill one a chunk,
    any other step one; a paged verify also records whether it was a
    tree chunk."""
    calls = {name: [] for name in names}
    for name in names:
        fn = getattr(engine, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            fwd = int(kw.get("k", 1))
            if _name == "prefill_chunked":
                fwd = -(-int(max(kw["lengths"])) // int(kw["chunk"]))
            calls[_name].append((time.perf_counter() - t0, fwd,
                                 kw.get("tree") is not None))
            return out
        setattr(engine, name, wrapped)
    return calls


def plan_kept_syncs(cfg, plan) -> int:
    """kept_syncs for a plan: the quantized kept syncs of one forward."""
    from types import SimpleNamespace
    return kept_syncs(SimpleNamespace(cfg=cfg, plan=plan))


SPEC_TARGET_STEPS = ("prefill", "prefill_chunked", "verify",
                     "verify_paged", "decode", "decode_paged")
SPEC_DRAFT_STEPS = ("prefill", "prefill_chunked", "draft", "draft_tree")


def spec_counts(label, llm, sched, tcalls, dcalls, launches, paged):
    """The launch counts the speculative path implies, against the
    counted ones: B1 once a layer per whole prefill of the target and of
    the drafter (a chunked prefill takes the plain attention); the fused
    kept sync kept_syncs(plan) per forward of each engine (on the shard
    engine's ranks the send and the receive kernel instead) and B3 alone
    once per forward of an engine whose plan quantizes the logits gather;
    on a paged path B2's chunk kernel once a layer per chain verify or
    warm suffix prefill (a tree chunk takes the plain attention), and no
    B2 decode."""
    cfg, n = llm.cfg, llm.cfg.n_layers
    t_fwd = sum(f for v in tcalls.values() for _, f, _ in v)
    d_fwd = sum(f for v in dcalls.values() for _, f, _ in v)
    chain_verify = sum(1 for _, _, tree in tcalls["verify_paged"]
                       if not tree)
    dplan = llm.draft_plan
    want = {
        "flash_attention_bhsd": n * (len(tcalls["prefill"])
                                     + len(dcalls["prefill"])),
        "quantized_psum_absmax": (plan_kept_syncs(cfg, llm.plan) * t_fwd
                                  + plan_kept_syncs(cfg, dplan) * d_fwd),
        "qdq_absmax": (t_fwd * (llm.plan.logits_mode != "exact")
                       + d_fwd * (dplan.logits_mode != "exact")),
    }
    # paged: every B2 call is a chunk (no plain decode step runs); dense:
    # none
    want["paged_flash_attention"] = n * chain_verify if paged else 0
    want["paged_flash_attention_chunk"] = want["paged_flash_attention"]
    if llm.engine.backend.multi_process and llm.tp > 1:
        syncs = want["quantized_psum_absmax"]
        want.update(quantized_psum_absmax=0, quantize_message_absmax=syncs,
                    reduce_messages_absmax=syncs)
    got = {k: launches[k] for k in want}
    print(f"{label}: target forwards {t_fwd} (prefill "
          f"{len(tcalls['prefill'])}, chunks "
          f"{sum(f for _, f, _ in tcalls['prefill_chunked'])}, verify "
          f"{len(tcalls['verify']) + len(tcalls['verify_paged'])}, chain "
          f"paged {chain_verify}), draft forwards {d_fwd} (prefill "
          f"{len(dcalls['prefill'])}, {sched.spec.drafter.adoptions} "
          f"adoptions); launches {got}, want {want}")
    if got != want:
        raise AssertionError(f"{label}: launches {got} != {want}")


def spec_generate(torch, llm, prompts, label, card, overrides,
                  max_new=MAX_NEW, record=None):
    """Greedy speculative serving of `prompts` on a fresh scheduler
    (`overrides` of the LLM's cache config) with every kernel's count
    zeroed before and read after, the launch counts checked
    (spec_counts), every request finished and (paged) every page back.
    Returns (tokens, preemptions, launches, decode ms per token, wall
    s); the scheduler and its drafter (the draft placement) are dropped
    with it.  `record` (a dict) gets the run's tokens, its full logits
    (LogitsTape), its ledger, the ledger entries of its first draft
    call ("draft", k forwards) and first verify ("verify"), and the
    decode ms per token."""
    from repro_torch.api import SamplingParams
    from repro_torch.api.scheduler import Request
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quant_collectives as QC
    from repro_torch.parallel.collectives import collective_ledger

    sched = llm.serve(**overrides)
    paged = sched.kv.paged
    tcalls = spec_counter(torch, llm.engine, SPEC_TARGET_STEPS)
    dcalls = spec_counter(torch, sched.spec.drafter.engine,
                          SPEC_DRAFT_STEPS)
    round_s = []                 # the draft and verify calls of each round
    led = [] if record is None else None
    spans = {}                   # the first call's ledger entries, by name
    for obj, name in ((sched.kv, "verify"), (sched.spec.drafter, "draft")):
        def timed(*a, _fn=getattr(obj, name), _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n0 = len(led)
            res = _fn(*a, **kw)
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
            spans.setdefault(_name, (n0, len(led)))
            return res
        setattr(obj, name, timed)
    kernels = (FA.flash_attention_bhsd, FA.paged_flash_attention,
               QC.qdq_absmax, QC.quantized_psum_absmax,
               QC.quantize_message_absmax, QC.reduce_messages_absmax)
    for k in kernels:
        k.launches = 0
    FA.paged_flash_attention.chunk_launches = 0
    tape = LogitsTape()
    with contextlib.ExitStack() as stack:
        if record is not None:
            stack.enter_context(tape)
            led = stack.enter_context(collective_ledger())
        t0 = time.perf_counter()
        base = -1000 * (1 + len(sched.completed))
        for i, p in enumerate(prompts):
            sched.submit(Request(uid=base - i, prompt=p, max_new=max_new,
                                 sampling=SamplingParams(max_new=max_new)))
        done = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for name in SPEC_TARGET_STEPS:
        delattr(llm.engine, name)
    for name in SPEC_DRAFT_STEPS:
        delattr(sched.spec.drafter.engine, name)
    del sched.kv.verify, sched.spec.drafter.draft
    outs = [done[base - i] for i in range(len(prompts))]
    launches = {k.__name__: k.launches for k in kernels}
    launches["paged_flash_attention_chunk"] = (
        FA.paged_flash_attention.chunk_launches)
    spec_counts(label, llm, sched, tcalls, dcalls, launches, paged)
    if any(len(r.out) != max_new or r.finish_reason != "length"
           for r in outs):
        raise AssertionError(f"{label}: a request did not finish cleanly")
    if paged:
        sched.pool.check()
        if sched.pool.num_free != sched.pool.num_pages:
            raise AssertionError(f"{label}: {sched.pool.num_free}/"
                                 f"{sched.pool.num_pages} pages back")
    rounds = sum(round_s)
    decode_ms = 1e3 * rounds * len(prompts) / max(sched.spec_committed, 1)
    if record is not None:
        rows = ledger_rows(led)
        record.update(tokens=[r.out for r in outs], tape=tape.host(),
                      ledger=rows, decode_ms=decode_ms,
                      acceptance=sched.spec_acceptance,
                      rounds=sched.spec_rounds, launches=dict(launches),
                      **{k: rows[a:b] for k, (a, b) in spans.items()})
    print(f"{label} [{card}]: acceptance={sched.spec_acceptance:.4f} "
          f"tokens_per_round={sched.spec_tokens_per_step:.4f} "
          f"rounds={sched.spec_rounds} alt_commits="
          f"{sched.spec_alt_commits} preemptions={sched.n_preemptions} "
          f"decode_ms_per_token={decode_ms:.2f} (draft + verify seconds x "
          f"{len(prompts)} rows / {sched.spec_committed} tokens committed "
          f"by rounds) tokens_per_s="
          f"{sum(len(r.out) for r in outs) / wall:.1f} wall={wall:.2f} s")
    return [r.out for r in outs], sched.n_preemptions, launches, decode_ms, \
        wall


def plain_generate(torch, llm, prompts, card, label):
    """Plain greedy serving (no speculation) on the same model: the
    tokens and the decode ms per token, reckoned as the speculative
    path's (step seconds x rows / tokens committed after admission)."""
    from repro_torch.api import SamplingParams

    times = timed_engine(torch, llm.engine)
    t0 = time.perf_counter()
    outs = llm.generate(prompts, SamplingParams(max_new=MAX_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name in ("prefill", "decode"):
        delattr(llm.engine, name)
    toks = [o.token_ids for o in outs]
    decode_ms = (1e3 * sum(times["decode"]) * len(prompts)
                 / sum(len(t) - 1 for t in toks))
    print(f"{label} [{card}]: plain decode_ms_per_token={decode_ms:.2f} "
          f"({len(times['decode'])} batch-{len(prompts)} steps) "
          f"prefill_ms={1e3 * sum(times['prefill']):.2f} tokens_per_s="
          f"{sum(len(t) for t in toks) / wall:.1f} wall={wall:.2f} s")
    return toks, decode_ms


def teacher_forced_tokens(torch, llm, prompts, toks, label):
    """Each committed token against the logits of one teacher-forced
    plain forward over prompt + output (the extension forward from
    position 0 on a blank cache, the plain attention): the argmax, or
    within TF_BF16_REL of the row's largest |logit| below its max.
    Returns how many are the argmax."""
    import numpy as np
    eng = llm.engine
    n_arg = n_all = 0
    worst = 0.0
    for p, t in zip(prompts, toks):
        full = np.concatenate([p, np.asarray(t[:-1])])[None]
        lg, _ = eng.verify(llm.params, full, np.zeros(1, np.int64),
                           eng.blank_caches(1, 512))
        rows = lg[0, len(p) - 1:].float()
        ids = torch.tensor(t, device=rows.device)
        gap = rows.max(-1).values - rows.gather(1, ids[:, None])[:, 0]
        rel = gap / rows.abs().max(-1).values
        n_arg += int((gap == 0).sum())
        n_all += len(t)
        worst = max(worst, rel.max().item())
    print(f"{label}: {n_arg}/{n_all} committed tokens are the argmax of a "
          f"teacher-forced plain forward; worst gap {worst:.4f} of the "
          f"row's largest |logit| (tol {TF_BF16_REL})")
    if worst > TF_BF16_REL:
        raise AssertionError(f"{label}: a committed token is {worst:.4f} "
                             "below its row's argmax")
    return n_arg


def spec_exact_fp32(torch, llm, prompts, card):
    """fp32 at full width on TF_FP32_LAYERS, exact syncs: the greedy
    speculative tokens of (a) the dense chain, (b) the paged chain on a
    pool the requests outgrow and (d) the adaptive tree, paged, equal
    plain greedy decoding's bit for bit; chunked prefill gives whole
    prefill's tokens, and its first-token logits agree within
    TF_FP32_ATOL; generate_stream equals generate, and a stream
    abandoned after 3 events leaves no request, slot or page held."""
    import numpy as np
    from repro_torch.api import LLM, SamplingParams
    from repro_torch.api.scheduler import Request
    from repro_torch.config.base import replace
    from repro_torch.runtime.forward import bucketed_prefill
    from repro_torch.spec import SpecConfig

    cfg, params, plan = tf_model(llm, "float32", TF_FP32_LAYERS)
    m = LLM.load(replace(cfg, attn_backend="pallas"), tp=2, plan=plan,
                 cache_len=512, max_batch=4, params=params,
                 page_size=PAGE_SIZE, num_pages=NUM_PAGES)
    del params
    sp = SamplingParams(max_new=MAX_NEW)
    dense = dict(page_size=None, num_pages=None)
    plain = [o.token_ids for o in m.generate(prompts, sp)]
    res = {}
    for key, spec, over in (
            ("a", SpecConfig(k=SPEC_K), dense),
            ("b", SpecConfig(k=SPEC_K), {}),
            ("d", SpecConfig(k=SPEC_K, adaptive=True, k_min=1, k_max=6,
                             tree_width=2), {})):
        m.enable_spec(spec)
        s = m.serve(**over)
        for i, p in enumerate(prompts):
            s.submit(Request(uid=i, prompt=p, max_new=MAX_NEW, sampling=sp))
        done = s.run()
        toks = [done[i].out for i in range(len(prompts))]
        res[key] = (toks == plain, s.spec_acceptance, s.spec_tokens_per_step,
                    s.n_preemptions)
        if s.kv.paged and s.pool.num_free != NUM_PAGES:
            raise AssertionError(f"fp32 spec ({key}): pages not returned")
    # generate_stream on the paged chain, then an abandoned stream
    m.enable_spec(SpecConfig(k=SPEC_K))
    got = [[] for _ in prompts]
    for ev in m.generate_stream(prompts, sp):
        got[ev.index].append(ev.token_id)
    stream = m.generate_stream(prompts, sp)
    for _ in range(3):
        next(stream)
    stream.close()
    sched = m.serve()
    left = (len(sched.queue), sum(x is not None for x in sched.slots),
            NUM_PAGES - sched.pool.num_free)
    # chunked prefill against whole prefill
    m.disable_spec()
    chunked = m.serve(prefill_chunk=SPEC_CHUNK, **dense)
    for i, p in enumerate(prompts):
        chunked.submit(Request(uid=i, prompt=p, max_new=MAX_NEW,
                               sampling=sp))
    done = chunked.run()
    ctoks = [done[i].out for i in range(len(prompts))]
    p = prompts[3]
    lw, _ = bucketed_prefill(m.engine, m.params, p, len(p), 512)
    lc, _ = bucketed_prefill(m.engine, m.params, p, len(p), 512,
                             chunk=SPEC_CHUNK)
    err = (lw - lc).abs().max().item()
    print(f"spec fp32 ({cfg.n_layers} layers) [{card}]: tokens equal plain "
          "greedy's: " + ", ".join(
              f"({k}) {v[0]} (acceptance {v[1]:.4f}, tokens/round "
              f"{v[2]:.4f}, preemptions {v[3]})" for k, v in res.items())
          + f"; generate_stream == generate: {got == plain}; abandoned "
          f"stream leaves (queued, slots, pages) {left}; chunked prefill "
          f"tokens == whole: {ctoks == plain}, first-token logits "
          f"max_abs_err {err:.3e} (tol {TF_FP32_ATOL})")
    if not (all(v[0] for v in res.values()) and got == plain
            and left == (0, 0, 0) and ctoks == plain
            and err <= TF_FP32_ATOL and res["b"][3] > 0):
        raise AssertionError("fp32 speculative / chunked / stream checks "
                             f"failed: {res}, left {left}, err {err}")


def spec_phase(torch, np, llama, sweep_res, card):
    """Self-speculative decoding and chunked prefill on llama2-7b at full
    width (bf16, tp=2, spd=0.25, quant8 kept syncs and logits gather, B1
    and B2, cache_len 512, max batch 4, the four prompts, 16 greedy
    tokens), the canonical weights of the llama2-7b phases: (a) chain
    k=SPEC_K all-drop, dense, over chunked prefill (SPEC_CHUNK; its
    logits and ledger recorded for the shard phase's speculative path);
    (b) chain k=SPEC_K all-drop, paged, on a pool the requests
    outgrow; (c) the tiered draft from the sweep's sensitivities; (d)
    adaptive k in [1, 6] with tree width 2, paged; (e) calibrate_draft
    over candidate_policies(sensitivity=...) on 2 held-out prompts; (f)
    chunked prefill (SPEC_CHUNK) against whole.  Returns the kernels-line
    row of B2's chain verify call."""
    from repro_torch.api import LLM, SamplingParams
    from repro_torch.api.scheduler import Request
    from repro_torch.config.base import replace
    from repro_torch.runtime.forward import bucketed_prefill
    from repro_torch.spec import (SpecConfig, calibrate_draft,
                                  candidate_policies)

    qpsum_grad_check(torch)
    row = verify_kernel_phase(torch)
    cfg = replace(llama.cfg, attn_backend="pallas")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM.load(cfg, tp=2, spd=0.25, comm="quant8", comm_logits="quant8",
                   dtype="bfloat16", cache_len=512, max_batch=4,
                   params=llama.canonical)
    torch.cuda.synchronize()
    print(f"spec phase: llama2-7b placed in {time.perf_counter() - t0:.1f} s "
          f"(plan drops {llm.plan.n_dropped}/{cfg.n_layers})")
    llm.generate([prompts[0][:8]], SamplingParams(max_new=2))  # warm-up
    plain, plain_ms = plain_generate(torch, llm, prompts, card,
                                     "spec phase plain")
    out = {}
    llm.enable_spec(SpecConfig(k=SPEC_K, draft="all-drop"))
    print(f"spec phase: all-drop draft placed; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    llm.generate([prompts[0][:8]], SamplingParams(max_new=2))  # warm-up
    paged = dict(page_size=PAGE_SIZE, num_pages=NUM_PAGES)
    dense = dict(max_batch=4)          # a fresh scheduler for each run
    rec = {}
    out["a"] = spec_generate(torch, llm, prompts,
                             "spec (a) all-drop dense, chunked prefill",
                             card, dict(dense, prefill_chunk=SPEC_CHUNK),
                             record=rec)
    SIM_RUNS[SHARD_SPEC_LABEL] = dict(rec, plain_ms=plain_ms)
    out["b"] = spec_generate(torch, llm, prompts, "spec (b) all-drop paged",
                             card, paged)
    if out["b"][1] < 1:
        raise AssertionError("spec (b): the pool did not preempt")
    llm.enable_spec(SpecConfig(k=SPEC_K, draft="tiered", n_spd=N_SPD,
                               tau1=float(np.percentile(
                                   sweep_res.sensitivity, 25)),
                               tau2=float(np.percentile(
                                   sweep_res.sensitivity, 75))),
                    sensitivity=sweep_res.sensitivity,
                    ranking=sweep_res.ranking)
    print("spec (c) tiered draft plan:", " ".join(
        f"{i}:{md}" for i, md in enumerate(llm.draft_plan.modes())))
    out["c"] = spec_generate(torch, llm, prompts, "spec (c) tiered dense",
                             card, dense)
    llm.enable_spec(SpecConfig(k=SPEC_K, adaptive=True, k_min=1, k_max=6,
                               tree_width=2))
    out["d"] = spec_generate(torch, llm, prompts,
                             "spec (d) adaptive tree paged", card, paged)
    for key, (toks, _, _, _, _) in out.items():
        same = sum(a == b for t, q in zip(toks, plain) for a, b in zip(t, q))
        print(f"spec ({key}): {same}/{sum(map(len, plain))} tokens equal "
              "plain greedy's (bf16 + quant8: verify chunks and one-token "
              "steps round differently)")
        teacher_forced_tokens(torch, llm, prompts, toks,
                              f"spec ({key}) teacher-forced")
    # (e) the calibrated draft: each candidate placed, measured, freed
    held = [np.random.default_rng(5).integers(0, cfg.vocab_size, n)
            for n in SPEC_CALIB_LENS]
    llm.disable_spec()
    release(torch)                    # the draft placements are freed
    t0 = time.perf_counter()
    cal = calibrate_draft(llm, held, k=SPEC_K, max_new=SPEC_CALIB_NEW,
                          sensitivity=sweep_res.sensitivity, force=True,
                          candidates=candidate_policies(
                              cfg, sensitivity=sweep_res.sensitivity))
    torch.cuda.synchronize()
    print(f"spec (e) calibrate_draft [{card}]: winner {cal.name} "
          f"acceptance={cal.acceptance:.4f} tokens_per_round="
          f"{cal.tokens_per_step:.4f} in {time.perf_counter() - t0:.1f} s; "
          "trials " + json.dumps([(nm, round(a, 4), round(t, 4))
                                  for nm, a, t in cal.trials])
          + f"; peak_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}")
    if not cal.trials or cal.name not in [t[0] for t in cal.trials]:
        raise AssertionError(f"calibrate_draft gave no winner: {cal}")
    # (f) chunked prefill against whole prefill, bf16 at full depth
    eng = llm.engine
    times = {}
    logits = {}
    for chunk in (None, SPEC_CHUNK, None, SPEC_CHUNK):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in prompts:
            lg, _ = bucketed_prefill(eng, llm.params, p, len(p), 512,
                                     chunk=chunk)
            logits.setdefault(chunk, []).append(lg.float())
        torch.cuda.synchronize()
        times[chunk] = 1e3 * (time.perf_counter() - t0)
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(logits[SPEC_CHUNK][:4], logits[None][:4]))
    print(f"spec (f) [{card}]: prefill_ms chunked ({SPEC_CHUNK}) "
          f"{times[SPEC_CHUNK]:.2f} vs whole {times[None]:.2f} (second of "
          f"two turns each; 4 prompts {list(PROMPT_LENS)} one at a time); "
          f"first-token logits max_abs_err / max|logit| {worst:.4f} (tol "
          f"{TF_BF16_REL})")
    if worst > TF_BF16_REL:
        raise AssertionError(f"chunked prefill's logits are {worst} off")
    sched = llm.serve(prefill_chunk=SPEC_CHUNK)
    for i, p in enumerate(prompts):
        sched.submit(Request(uid=i, prompt=p, max_new=MAX_NEW,
                             sampling=SamplingParams(max_new=MAX_NEW)))
    done = sched.run()
    ctoks = [done[i].out for i in range(len(prompts))]
    same = sum(a == b for t, q in zip(ctoks, plain) for a, b in zip(t, q))
    print(f"spec (f): served with prefill_chunk={SPEC_CHUNK}, "
          f"{same}/{sum(map(len, plain))} tokens equal whole prefill's")
    teacher_forced_tokens(torch, llm, prompts, ctoks,
                          "spec (f) chunked prefill teacher-forced")
    del sched
    print(f"spec phase [{card}]: decode_ms_per_token plain {plain_ms:.2f} "
          + " ".join(f"({k}) {v[3]:.2f}" for k, v in out.items())
          + f"; peak_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} (target, "
          "draft and candidate placements beside the canonical weights)")
    spec_exact_fp32(torch, llm, prompts, card)
    row["launches"] = out["b"][2]["paged_flash_attention_chunk"]
    return row, {k: v[2] for k, v in out.items()}


# ---------------------------------------------------------------------------
# The training phase: full-width SmolLM-360M through the train CLI's
# make_trainer on the simulated (data 2, model 2) mesh
# ---------------------------------------------------------------------------

TRAIN_ARCH = "smollm-360m"
# full width, cut from 32 layers to 16 since the MoE and hybrid paths
# came (the phase took ~240 s at 32), to 8 since the shard phase serves
# every family (it took ~125 s at 16), and to 3 since the families train
# (16f; 4 left the run ~110 s from its limit on a slow host)
TRAIN_LAYERS = 3
TRAIN_KW = dict(tp=2, dp=2, batch=8, seq=4096, microbatches=4, q_chunk=2048,
                lr=1e-3, spd=0.25, dtype="bfloat16", attn_backend="pallas",
                warmup=2, seed=0)
TRAIN_STEPS = 12                       # (a) ZeRO-1
FAULT_STEPS, FAULT_AT, FAULT_EVERY = 8, 6, 4     # (b)
FSDP_STEPS = 4                         # (c)
QUANT_STEPS = 3                        # (d)
EXACT_KW = dict(batch=2, seq=1024, microbatches=1, q_chunk=1024,
                dtype="float32")       # (e), fp32 at the phase's depth
EXACT_STEPS = 2
REPLAY_RTOL = 1e-6                     # a replayed step's loss
TRAJ_RTOL = 2e-4                       # FSDP against ZeRO-1 (the reference's)
EXACT_RTOL = 1e-4                      # fp32 B1 against the plain attention
# (d)'s losses against (a)'s first ones: int8 absmax moves a synced
# element by at most 1/254 of its 128-chunk's largest value, and the
# loss averages those errors; the bound is a quarter of the loss's fall
# over the first 3 steps of (a) (11.024 -> 10.980)
QUANT_LOSS_RTOL = 1e-3
# B1 at the train shape: each output row's relative L2 error
# ||out_r - ref_r|| / ||ref_r||.  bf16: its output and the probabilities
# of its P V product are rounded to 8 bits (2^-8 relative each), so
# 2^-5 is 8x that; a wrong 64-key block at S 4096 moves a late row by
# about sqrt(64 / 4096) = 0.125.  fp32: the summation order alone
FLASH_ROW_RTOL = {"bfloat16": 2.0 ** -5, "float32": 1e-5}
# params after fp32 steps: PARAM_REL of each leaf's largest |value|, but
# at most PARAM_FLIP_FRAC of the elements up to 2 lr a step (AdamW's first
# steps are sign functions of the gradient)
PARAM_REL, PARAM_FLIP_FRAC = 1e-5, 1e-3
H100_BF16_DENSE_FLOPS = 989e12


def flash_row_errors(torch, out, ref) -> tuple:
    """(max abs error, the worst row's relative L2 error, that row's
    sequence position, relative RMS error over all elements)."""
    d = out.float() - ref.float()
    r = ref.float()
    rel = d.norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    worst = rel.max()
    at = int(rel.amax(dim=0).argmax().item())
    return (d.abs().max().item(), worst.item(), at,
            (d.norm() / r.norm()).item())


def train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one step: 6 N T (N the unpadded parameter count, T
    = batch x seq tokens) plus the causal attention's 4 B H D S^2 / 2 a
    layer forward, three times for forward and backward.  The remat
    recompute and the padded heads are not counted (model FLOPs)."""
    return (6.0 * cfg.param_count() * batch * seq
            + 6.0 * batch * cfg.n_heads * cfg.d_head * seq ** 2
            * cfg.n_layers)


def loss_fell(np, losses) -> bool:
    """Finite, and the mean of the last 4 below the mean of the first 4."""
    return bool(np.isfinite(losses).all()
                and np.mean(losses[-4:]) < np.mean(losses[:4]))


def counted(torch, fn):
    """fn() with every kernel's launch count zeroed just before and read
    just after."""
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in kernels}


def train_cfg():
    """The training phase's model: TRAIN_ARCH at full width, TRAIN_LAYERS
    deep."""
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    return replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)


def trainer_for(root, label, params, **kw):
    """make_trainer (the train CLI's own) with the phase's settings."""
    import os
    from repro_torch.launch.train import make_trainer
    return make_trainer(train_cfg(), ckpt_dir=os.path.join(root, label),
                        params=params, device="cuda",
                        **dict(TRAIN_KW, **kw))


def train_cut_trainer(root, engine, **layout):
    """The fp32 cut of the training phase's model (SHARD_TRAIN_CUT_LAYERS
    layers at full width, seeded weights drawn on the card) for 2 steps
    of SHARD_TRAIN_CUT on `engine` ("sim" here, "shard" on a rank);
    `layout` overrides TRAIN_KW's (SHARD_POD: the pod mesh)."""
    import os
    from repro_torch.config.base import replace
    from repro_torch.launch.train import make_trainer
    cfg = replace(train_cfg(), n_layers=SHARD_TRAIN_CUT_LAYERS)
    tag = "".join(f"-{k}{v}" for k, v in sorted(layout.items()))
    return make_trainer(cfg, engine=engine, steps=2, ckpt_every=0,
                        ckpt_dir=os.path.join(root, f"cut-{engine}{tag}"),
                        device="cuda",
                        **dict(TRAIN_KW, **SHARD_TRAIN_CUT, **layout))


def losses_of(tr):
    return [m["loss"] for m in tr.metrics_log]


def step_ms(np, tr):
    """Mean synchronised wall ms of a trainer's steps after its first."""
    return 1e3 * float(np.mean([m["wall"] for m in tr.metrics_log][1:]))


def params_close(torch, a, b, lr, steps, what):
    """The sign-aware bound over two lists of tensors; raises."""
    flips = total = 0
    worst = 0.0
    for x, y in zip(a, b):
        d = (x.float() - y.float()).abs()
        top = max(x.float().abs().max().item(), 1e-30)
        flips += int((d > PARAM_REL * top).sum().item())
        total += x.numel()
        worst = max(worst, d.max().item())
    print(f"{what}: params max_abs_diff {worst:.3e} (bound "
          f"{2 * lr * steps + 1e-6:.1e}), {flips} of {total} elements past "
          f"{PARAM_REL:.0e} of their leaf's max (bound {PARAM_FLIP_FRAC:.0e})")
    if not (worst <= 2 * lr * steps + 1e-6
            and flips <= PARAM_FLIP_FRAC * total):
        raise AssertionError(f"{what}: parameters disagree")


def profile_step(torch, tr, st, card):
    """One more step under torch.profiler: device-busy ms, idle share
    (1 - busy / the step's synchronised wall time) and the top device
    operations by time."""
    from torch.profiler import ProfilerActivity, profile
    batch = next(tr.data_iter(st["step"]))
    for attempt in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, _, met = tr.step_fn(st["params"], st["opt"], batch)
            float(met["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = profile_rows(prof)
        if rows:
            break
        print(f"train profile {attempt + 1}: no device event, taken again")
    busy = sum(us for _, us, _ in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:10]
    print(f"train profile [{card}]: step wall_ms={wall * 1e3:.1f} (under "
          f"the profiler) device_busy_ms={busy:.1f} idle_share="
          + (f"{1 - busy / (wall * 1e3):.3f}" if rows else "not measured"))
    for key, us, n in top:
        print(f"  {us / 1e3:9.2f} ms {n:6d}x  {key[:90]}")


def train_phase(torch, np, card):
    """(a) ZeRO-1 for TRAIN_STEPS steps at full width (bf16, tp 2 x dp 2,
    B1 forward and remat recompute under autograd, sequence 4096, batch
    8 in 4 microbatches), timed, counted and profiled; (b) a fault at
    step FAULT_AT of FAULT_STEPS and the resume from the step-4
    checkpoint, replays equal; (c) FSDP's first steps equal ZeRO-1's;
    (d) every kept sync at quant8: the fused kept sync under autograd,
    counted; (e) fp32 at the phase's depth: B1 against the plain
    attention.
    Returns B1's kernels-line row at the train shape and the main path's
    launches."""
    import os
    import shutil
    import tempfile

    from repro_torch.config.base import replace
    from repro_torch.core import model as M
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quant_collectives as QC
    from repro_torch.parallel.collectives import collective_ledger
    from repro_torch.runtime.trainer import SimulatedFault
    from repro_torch.tree import tree_leaves, tree_map

    cfg = replace(train_cfg(), dtype="bfloat16",
                  attn_backend="pallas")
    kw = TRAIN_KW
    nmb, batch, seq = kw["microbatches"], kw["batch"], kw["seq"]
    tokens = batch * seq
    flops = train_flops(cfg, batch, seq)
    root = tempfile.mkdtemp(prefix="train_phase_")
    canon = M.init_model(cfg, seed=0, device=torch.device("cuda"))
    print(f"train phase: {cfg.name} L={cfg.n_layers} d={cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.d_head} d_ff {cfg.d_ff} "
          f"vocab {cfg.vocab_size} ({cfg.param_count() / 1e6:.1f} M "
          f"parameters), bf16, tp {kw['tp']} x dp {kw['dp']}, spd "
          f"{kw['spd']}, batch {batch} x seq {seq} in {nmb} microbatches, "
          f"remat, q_chunk {kw['q_chunk']}; checkpoints under {root}")

    # ---- (a) ZeRO-1 ----
    torch.cuda.reset_peak_memory_stats()
    tr, st = trainer_for(root, "a", canon, steps=TRAIN_STEPS, ckpt_every=0)
    st, launches = counted(torch, lambda: tr.run(st))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = 2 * cfg.n_layers * nmb * TRAIN_STEPS
    print(f"train (a) launches: {json.dumps(launches)}; B1 want 2 x "
          f"{cfg.n_layers} layers x {nmb} microbatches x {TRAIN_STEPS} "
          f"steps = {want}")
    others = {k: v for k, v in launches.items()
              if k != "flash_attention_bhsd"}
    if launches["flash_attention_bhsd"] != want or any(others.values()):
        raise AssertionError(f"train (a): launches {launches}, want B1 "
                             f"{want} and no other kernel")
    la = losses_of(tr)
    walls = [m["wall"] for m in tr.metrics_log]
    step_s = step_ms(np, tr) / 1e3
    print(f"train (a) losses: {[round(x, 4) for x in la]}; grad_norms "
          f"{[round(m['grad_norm'], 3) for m in tr.metrics_log]}")
    print(f"train (a) [{card}]: step_ms={step_s * 1e3:.1f} (mean of steps "
          f"2-{TRAIN_STEPS}, synchronised; step 1 {walls[0] * 1e3:.1f}) "
          f"tokens_per_s={tokens / step_s:.1f} mfu={flops / step_s / H100_BF16_DENSE_FLOPS:.4f} "
          f"(MFU = (6 N T + 6 B H D S^2 L) / step time / 989 TFLOPS, N "
          f"{cfg.param_count()}, T {tokens}: {flops:.4e} FLOPs a step) "
          f"peak_memory_gib={peak:.2f}")
    if not loss_fell(np, la):
        raise AssertionError(f"train (a): the loss did not fall: {la}")
    SIM_RUNS["train (a)"] = dict(losses=la, step_ms=step_s * 1e3)
    profile_step(torch, tr, st, card)
    del tr, st
    release(torch)

    # ---- (b) a fault and the resume ----
    boom = {"armed": True}

    def hook(step):
        if step == FAULT_AT and boom["armed"]:
            boom["armed"] = False
            raise SimulatedFault(f"fault injected at step {step}")

    tr, st = trainer_for(root, "b", canon, steps=FAULT_STEPS,
                         ckpt_every=FAULT_EVERY, ckpt_keep=2, fault_hook=hook)
    st = tr.run(st)
    first, worst = {}, 0.0
    replayed = []
    for m in tr.metrics_log:
        if m["step"] in first:
            rel = abs(m["loss"] - first[m["step"]]) / abs(first[m["step"]])
            worst = max(worst, rel)
            replayed.append(m["step"])
        else:
            first[m["step"]] = m["loss"]
    for step, sec, nb in tr.save_log:
        print(f"train (b) [{card}]: save at step {step}: {sec:.2f} s, "
              f"{nb / 1e9:.3f} GB")
    for step, sec, nb in tr.restore_log:
        print(f"train (b) [{card}]: restore of step {step}: {sec:.2f} s, "
              f"{nb / 1e9:.3f} GB")
    print(f"train (b): steps replayed {replayed}, worst relative loss "
          f"difference {worst:.3e} (tol {REPLAY_RTOL:.0e}); final step "
          f"{st['step']}")
    if st["step"] != FAULT_STEPS or replayed != [5, 6]:
        raise AssertionError(f"train (b): resume went wrong: {replayed}")
    if not worst <= REPLAY_RTOL:
        raise AssertionError(f"train (b): replay differs by {worst}")
    del tr, st
    shutil.rmtree(root, ignore_errors=True)
    release(torch)

    # ---- (c) FSDP ----
    tr, st = trainer_for(root, "c", canon, steps=TRAIN_STEPS, fsdp=True,
                         ckpt_every=0)
    tr.run(st, steps=FSDP_STEPS)
    lc = losses_of(tr)
    rel = np.abs(np.array(lc) - np.array(la[:FSDP_STEPS])) / np.abs(
        la[:FSDP_STEPS])
    print(f"train (c) FSDP losses {[round(x, 4) for x in lc]} vs ZeRO-1 "
          f"{[round(x, 4) for x in la[:FSDP_STEPS]]}: max rel {rel.max():.3e}"
          f" (tol {TRAJ_RTOL:.0e}); [{card}] step_ms={step_ms(np, tr):.1f}"
          f" (ZeRO-1 {step_s * 1e3:.1f})")
    if not rel.max() <= TRAJ_RTOL:
        raise AssertionError("train (c): FSDP and ZeRO-1 disagree")
    del tr, st
    release(torch)

    # ---- (d) every kept sync at quant8 ----
    tr, st = trainer_for(root, "d", canon, steps=TRAIN_STEPS, comm="quant8",
                         ckpt_every=0)
    kept = plan_kept_syncs(cfg, tr.plan)
    # the remat recompute (torch.utils.checkpoint, non-reentrant) stops
    # at a block's last op whose saved tensors the backward needs: the
    # MLP's down projection, before the MLP sync.  So it re-runs each kept
    # block's attention sync and no MLP sync
    recomputed = sum(not tr.plan.drop_mask[i] and tr.plan.block_mode(i)
                     in ("quant8", "quant4") for i in range(cfg.n_layers))

    def quant_run():
        with collective_ledger() as led:
            s = tr.run(st, steps=1)
        tr.run(s, steps=QUANT_STEPS - 1)
        return led

    led, qlaunches = counted(torch, quant_run)
    want_q = (kept + recomputed) * nmb * QUANT_STEPS
    want_b1 = 2 * cfg.n_layers * nmb * QUANT_STEPS
    ops = {}
    for e in led:
        ops[(e.op, e.axis)] = ops.get((e.op, e.axis), 0) + 1
    ld = losses_of(tr)
    qrel = float(np.max(np.abs(np.array(ld) - np.array(la[:QUANT_STEPS]))
                        / np.abs(la[:QUANT_STEPS])))
    print(f"train (d) quant8: losses {[round(x, 4) for x in ld]}, max rel "
          f"{qrel:.3e} from (a)'s (tol {QUANT_LOSS_RTOL:.0e}); launches "
          f"{json.dumps(qlaunches)}; fused kept sync want ({kept} kept "
          f"quantized syncs + {recomputed} recomputed attention syncs) x "
          f"{nmb} microbatches x {QUANT_STEPS} steps = {want_q}; one "
          f"step's ledger {ops}; [{card}] step_ms={step_ms(np, tr):.1f} "
          f"(exact {step_s * 1e3:.1f})")
    if not (np.isfinite(ld).all() and qrel <= QUANT_LOSS_RTOL
            and qlaunches["quantized_psum_absmax"] == want_q
            and qlaunches["flash_attention_bhsd"] == want_b1
            and ops.get(("reduce-scatter", "model"), 0) > 0
            and ops.get(("all-gather", "model"), 0) > 0):
        raise AssertionError("train (d): the quantized run went wrong")
    del tr, st
    # the fused kept sync at the payload this path gives it, (tp, B_mb x S
    # x d) bf16 at L 127, bit for bit against its plain version
    gen = torch.Generator(device="cuda").manual_seed(23)
    n = batch // nmb * seq * cfg.d_model
    x = torch.randn(kw["tp"], n, generator=gen, device="cuda")
    x *= torch.logspace(0, 1, kw["tp"], device="cuda")[:, None]
    x = x.to(torch.bfloat16)
    out = QC.quantized_psum_absmax(x, levels=127)
    ref = QC.quantized_psum_absmax_plain(x, levels=127)
    torch.cuda.synchronize()
    same = same_bits(torch, out, ref)
    print(f"quantized_psum at the train payload ({kw['tp']},{n}) bf16 "
          f"L=127: bit-identical to its plain version: {same}")
    if not same:
        raise AssertionError("train (d): the fused kept sync differs from "
                             "its plain version at the train payload")
    del x, out, ref
    release(torch)

    # ---- (e) fp32: B1 against the plain attention ----
    canon32 = tree_map(lambda w: w.float(), canon)
    res = {}
    for backend in ("pallas", "xla"):
        tr, st = trainer_for(root, f"e-{backend}", canon32,
                             steps=EXACT_STEPS, ckpt_every=0,
                             attn_backend=backend, **EXACT_KW)
        st, el = counted(torch, lambda: tr.run(st))
        res[backend] = (losses_of(tr),
                        [m["grad_norm"] for m in tr.metrics_log],
                        [w.detach().clone() for w in
                         tree_leaves(st["params"])], el)
        del tr, st
        release(torch)
    (lk, gk, pk, ek), (lp, gp, pp, ep) = res["pallas"], res["xla"]
    rl = max(abs(a - b) / abs(b) for a, b in zip(lk + gk, lp + gp))
    want_e = 2 * cfg.n_layers * EXACT_KW["microbatches"] * EXACT_STEPS
    print(f"train (e) fp32 {cfg.n_layers} layers, batch "
          f"{EXACT_KW['batch']} x seq {EXACT_KW['seq']}: B1 losses {lk} grad_norms {gk}; plain "
          f"{lp} {gp}; max rel {rl:.3e} (tol {EXACT_RTOL:.0e}); B1 "
          f"launches {ek['flash_attention_bhsd']} (want {want_e}), plain "
          f"{ep['flash_attention_bhsd']}")
    if not (rl <= EXACT_RTOL and ek["flash_attention_bhsd"] == want_e
            and ep["flash_attention_bhsd"] == 0):
        raise AssertionError("train (e): B1 and the plain attention "
                             "disagree in fp32")
    params_close(torch, pk, pp, kw["lr"], EXACT_STEPS, "train (e)")
    del res, pk, pp, canon32
    release(torch)

    # ---- the fp32 cut that shard (c) trains on its ranks ----
    tr, st = train_cut_trainer(root, "sim")
    tr.run(st)
    SIM_RUNS["train cut"] = [dict(loss=m["loss"], grad_norm=m["grad_norm"])
                             for m in tr.metrics_log]
    print(f"train cut (fp32, {SHARD_TRAIN_CUT_LAYERS} layers, batch "
          f"{SHARD_TRAIN_CUT['batch']} x seq {SHARD_TRAIN_CUT['seq']}) on "
          f"sim for shard (c): {SIM_RUNS['train cut']}")
    del tr, st
    tr, st = train_cut_trainer(root, "sim", **SHARD_POD)
    tr.run(st)
    SIM_RUNS["train cut pod"] = [dict(loss=m["loss"],
                                      grad_norm=m["grad_norm"])
                                 for m in tr.metrics_log]
    print(f"train cut on sim's mesh (pod 2, data 1, model 2) for shard "
          f"(c)'s pod layout: {SIM_RUNS['train cut pod']}")
    del tr, st
    shutil.rmtree(root, ignore_errors=True)
    release(torch)

    # ---- B1 at the train shape: q (tp x B_mb x 9, S, 64) ----
    lay_q = 2 * (batch // (kw["dp"] * nmb)) * kw["dp"] * 9
    lay_kv = lay_q // 3
    gen = torch.Generator(device="cuda").manual_seed(22)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = flash_inputs(torch, gen, seq, cfg.d_head, dtype,
                               bh=lay_q, bhkv=lay_kv)
        out = FA.flash_attention_bhsd(q, k, v)
        ref = FA.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err, worst, at, rms = flash_row_errors(torch, out, ref)
        tol = FLASH_ROW_RTOL[str(dtype)[6:]]
        print(f"flash {str(dtype)[6:]} at the train shape q ({lay_q},{seq},"
              f"{cfg.d_head}): max_abs_err={err:.3e} worst row relative L2 "
              f"error {worst:.3e} at position {at} (tol {tol:.3e}), "
              f"relative RMS error {rms:.3e}")
        if not worst <= tol:
            raise AssertionError(f"flash kernel disagrees at the train shape "
                                 f"in {dtype}: row error {worst} > {tol}")
        if dtype == torch.float32:
            del q, k, v, out, ref
            release(torch)
    del out, ref
    row = flash_row(torch, q, k, v, err, "train step (tp 2 x B_mb 2 x 9 "
                    "heads)")
    row["launches"] = launches["flash_attention_bhsd"]
    del q, k, v
    release(torch)
    return row, launches


# ---------------------------------------------------------------------------
# 16f: the families' training on sim (ROADMAP A3): mamba2, qwen2-moe,
# deepseek and hymba at full width, bf16, through the train CLI's
# make_trainer; their fp32 cuts against the plain versions; B8 under
# autograd at the train shape
# ---------------------------------------------------------------------------

#: each family's depth in 16f at full width.  ZeRO-1 on sim holds ~18
#: bytes a parameter (a bf16 parameter, an fp32 gradient accumulator,
#: the fp32 master and two fp32 moments): qwen2-moe's 2 layers are 1.76 B
#: parameters (~32 GB of state), deepseek's 2 (the dense layer 0 and a
#: MoE layer) 1.09 B (~20 GB), hymba's 32 1.23 B (~22 GB), mamba2's 48
#: 0.42 B (~8 GB); activations (remat) on top
FAMILY_TRAIN_LAYERS = {"mamba2-370m": 48, "qwen2-moe-a2.7b": 2,
                       "deepseek-v2-lite-16b": 2, "hymba-1.5b": 32}
#: tp 2 x dp 2 simulated, half the blocks dropped (none on mamba2: one
#: sync a block), every kept sync at quant8 (the fused kept sync under
#: autograd, identity backward), sequence 512, batch 4 in 2 microbatches
FAMILY_TRAIN_KW = dict(tp=2, dp=2, batch=4, seq=512, microbatches=2,
                       q_chunk=512, lr=1e-3, spd=0.5, comm="quant8",
                       dtype="bfloat16", attn_backend="pallas", warmup=0,
                       seed=0)
FAMILY_TRAIN_STEPS = 3
#: the fp32 cuts: 2 layers at full width (qwen2-moe 1: its fp32 state
#: is 20 bytes a parameter), batch 2 x 256, 2 steps with the kernels and
#: 2 with their plain versions (the plain attention, the plain scan, the
#: quantized collectives' plain versions), MoE routing replayed, once at
#: each of FAMILY_CUT_COMMS' kept-sync levels.  Step 1's loss and grad
#: norm (the kernels' forward and backward on the same parameters)
#: within FAMILY_CUT_RTOL, its gradients leaf by leaf within
#: FAMILY_CUT_GRAD_L2.  With exact syncs step 2 too, and at most
#: FAMILY_CUT_PAST of the params past 1e-5 of their leaf's largest after
#: the steps.  At quant8 step 2 and the params are printed, not held: a
#: last-ulp difference flips a code at a rounding boundary, which moves
#: a synced element by a quant step (1/127 of its chunk's largest) in
#: one run only.  Measured (H100, 700 W): with exact syncs step 2 within
#: 1.9e-6 and 0.001-0.244% of the params past, at quant8 up to 2.3e-4
#: and 4-38%, with step 1's sign disagreements above 8x the leaf's RMS
#: difference at most 165 elements in either: the quantizer, not
#: AdamW's sign-like first step on noise-level gradients
FAMILY_CUT_LAYERS = {"mamba2-370m": 2, "qwen2-moe-a2.7b": 1,
                     "deepseek-v2-lite-16b": 2, "hymba-1.5b": 2}
FAMILY_CUT_KW = dict(batch=2, seq=256, microbatches=1, q_chunk=256,
                     dtype="float32")
FAMILY_CUT_STEPS = 2
FAMILY_CUT_RTOL = 1e-4
#: each cut runs at FAMILY_TRAIN_KW's quant8 kept syncs and again at
#: exact ones, which leave the kernels' summation order as the only
#: difference (no quant8 code to flip)
FAMILY_CUT_COMMS = ("quant8", "exact")
#: step 1's gradients, leaf by leaf: each leaf's relative L2 distance
#: from the plain run's.  Exact: summation order (measured worst 1.5e-5,
#: a 15-element leaf); quant8: a flipped code's quant step on top
#: (measured worst 1.2e-3, hymba's head)
FAMILY_CUT_GRAD_L2 = {"quant8": 1e-2, "exact": 1e-4}
FAMILY_CUT_PAST = 0.01
#: a gradient element counts as above the noise past this many times
#: its leaf's RMS kernel-plain difference
GRAD_NOISE_X = 8
#: B8 under autograd at a train step's shape (a microbatch: tp 2 x 2
#: rows = 4 streams, S 512): mamba2's (16 heads a shard of P 64, N 128)
#: and hymba's (15 heads a shard, N 16), bf16.  The forward is the
#: kernel: y within SSD_BF16_Y_REL of the largest |y| of the plain
#: forward's (ssd_phase's bound), its relative L2 error within
#: B8_FWD_L2 (one bf16 rounding, 2^-8, doubled).  The backward is the
#: plain version's VJP recomputed from the same saved inputs, so each
#: gradient's relative L2 distance from the plain version's own
#: autograd gradient is the order of the same products: B8_GRAD_L2
B8_TRAIN_SHAPES = (("mamba2-370m", dict(bt=4, h=16, p=64, n=128, g=1,
                                        chunk=256)),
                   ("hymba-1.5b", dict(bt=4, h=15, p=64, n=16, g=1,
                                       chunk=256)))
B8_TRAIN_S = 512
B8_FWD_L2 = 2.0 ** -7
B8_GRAD_L2 = 1e-5


def family_cfg(arch, layers, **kw):
    """`arch` at full width, `layers` deep (a MoE model keeps its dense
    first layers within them)."""
    import dataclasses
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    cfg = replace(get_config(arch), n_layers=layers, **kw)
    if cfg.moe is not None:
        cfg = replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_dense_layers=min(cfg.moe.n_dense_layers, layers)))
    return cfg


class TrainRoutePin(RoutePin):
    """RoutePin between two training runs of one model: the second routes
    with the first's recorded expert choice, its gates recomputed from
    its own router (so the router keeps its gradient), and counts the
    choices it would have made otherwise.  The aux is the run's own: its
    gradient goes through the router's probabilities only, and its value
    is the pinned one where no choice differs.  A training step routes
    in the forward, for the aux term and again in the remat recompute,
    in the same order in both runs."""

    def replay(self):
        import torch
        it = iter(self.kept)

        def rep(orig, h, w, top_k, n_routed):
            _, own, aux = orig(h, w, top_k, n_routed)
            idx = next(it)[1]
            same = own.sort(-1).values == idx.sort(-1).values
            self.flips += int((~same).sum())
            self.choices += same.numel()
            probs = torch.softmax(torch.matmul(
                h.float(), w.float())[..., :n_routed], dim=-1)
            gates = probs.gather(-1, idx)
            return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), \
                idx, aux
        return self._patched(rep)


def train_launches_want(cfg, plan, nmb, steps):
    """A train step's kernel launches on sim: B1 forward and remat
    recompute on each full-causal attention layer, B8 the same on each
    SSM or hybrid layer, the fused kept sync once a quantized kept sync
    of the forward and once a kept non-SSM block's attention sync of the
    recompute (it stops before a block's last sync), a microbatch."""
    from repro_torch.core.layer_kinds import layer_kinds
    kinds = layer_kinds(cfg)
    b1 = sum(k.mixer == "gqa" and not k.window for k in kinds)
    b8 = sum(k.mixer in ("ssm", "hybrid") for k in kinds)
    kept = plan_kept_syncs(cfg, plan)
    recomputed = sum(not plan.drop_mask[i] and k.mixer != "ssm"
                     and plan.block_mode(i) in ("quant8", "quant4")
                     for i, k in enumerate(kinds))
    m = nmb * steps
    return {"flash_attention_bhsd": 2 * b1 * m, "ssd_scan": 2 * b8 * m,
            "quantized_psum_absmax": (kept + recomputed) * m}


def family_trainer(root, cfg, label, params, steps, **kw):
    import os
    from repro_torch.launch.train import make_trainer
    return make_trainer(cfg, ckpt_dir=os.path.join(root, label),
                        params=params, device="cuda", steps=steps,
                        ckpt_every=0, **dict(FAMILY_TRAIN_KW, **kw))


def family_train_phase(torch, np, card):
    """16f: each family at full width (FAMILY_TRAIN_LAYERS) through
    make_trainer on the simulated (data 2, model 2) mesh, bf16, random
    weights from seed 0: FAMILY_TRAIN_STEPS ZeRO-1 steps with every
    kernel counted (train_launches_want), each step's loss, aux, grad
    norm, ms and the peak memory; then its fp32 cut (FAMILY_CUT_LAYERS)
    with the kernels against the same steps with their plain versions,
    MoE routing replayed (TrainRoutePin): losses and grad norms within
    FAMILY_CUT_RTOL at step 1; then B8 under autograd at the train shapes
    (b8_train_rows).  Fills SIM_RUNS["family train <arch>"] (shard (c)
    trains qwen2-moe's).  Returns (B8's row, the mamba2 run's
    launches)."""
    import shutil
    import tempfile

    from repro_torch.core import model as M

    root = tempfile.mkdtemp(prefix="family_train_")
    nmb = FAMILY_TRAIN_KW["microbatches"]
    tokens = FAMILY_TRAIN_KW["batch"] * FAMILY_TRAIN_KW["seq"]
    runs = {}
    try:
        for arch, layers in FAMILY_TRAIN_LAYERS.items():
            cfg = family_cfg(arch, layers, dtype="bfloat16",
                             attn_backend="pallas")
            canon = M.init_model(cfg, seed=0, device=torch.device("cuda"))
            torch.cuda.reset_peak_memory_stats()
            tr, st = family_trainer(root, cfg, arch, canon,
                                    FAMILY_TRAIN_STEPS)
            st, launches = counted(torch, lambda: tr.run(st))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            want = train_launches_want(cfg, tr.plan, nmb, FAMILY_TRAIN_STEPS)
            got = {k: launches[k] for k in want}
            others = {k: v for k, v in launches.items()
                      if k not in want and v}
            log = tr.metrics_log
            rate = tokens / float(np.mean([m["wall"] for m in log[1:]]))
            print(f"family train {arch} [{card}]: L={cfg.n_layers} full "
                  f"width ({cfg.param_count() / 1e9:.3f} B parameters), "
                  f"bf16, tp 2 x dp 2, plan {tr.plan.n_dropped} of "
                  f"{cfg.n_layers} dropped, quant8 kept syncs, batch "
                  f"{FAMILY_TRAIN_KW['batch']} x seq "
                  f"{FAMILY_TRAIN_KW['seq']} in {nmb} microbatches, remat: "
                  f"losses {[round(m['loss'], 5) for m in log]} aux "
                  f"{[round(m['aux'], 5) for m in log]} grad_norms "
                  f"{[round(m['grad_norm'], 4) for m in log]}; step_ms "
                  f"{[round(1e3 * m['wall'], 1) for m in log]} "
                  f"(tokens_per_s={rate:.1f}"
                  f" after step 1); peak_memory_gib={peak:.2f}; launches "
                  f"{json.dumps(got)} (want {json.dumps(want)})")
            if got != want or others:
                raise AssertionError(f"family train {arch}: launches "
                                     f"{launches}, want {want} and no other")
            if not all(np.isfinite([m["loss"], m["grad_norm"], m["aux"]]).all()
                       for m in log):
                raise AssertionError(f"family train {arch}: not finite")
            if (cfg.moe is not None) != all(m["aux"] > 0 for m in log):
                raise AssertionError(f"family train {arch}: aux {log}")
            runs[arch] = dict(launches=launches,
                              losses=[m["loss"] for m in log],
                              grad_norms=[m["grad_norm"] for m in log],
                              walls=[m["wall"] for m in log])
            SIM_RUNS[f"family train {arch}"] = runs[arch]
            del tr, st
            release(torch)
            family_cut(torch, root, arch, canon)
            del canon
            release(torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rows = b8_train_rows(torch, card)
    rows[0]["launches"] = runs["mamba2-370m"]["launches"]["ssd_scan"]
    rows[1]["launches"] = runs["hymba-1.5b"]["launches"]["ssd_scan"]
    return rows, runs


class StepGrads:
    """Inside: each leaf of the gradient tree that a sim ZeRO-1 train
    step's first optimizer update receives (the step's accumulated fp32
    gradients, `parallel.zero1.zero1_update_clipped`'s first argument)
    handed to `take(i, leaf)`, once."""

    def __init__(self, take):
        self.take, self.seen = take, False

    def __enter__(self):
        from repro_torch.parallel import zero1 as Z
        from repro_torch.tree import tree_leaves
        self.orig = orig = Z.zero1_update_clipped

        def spy(grads, *a, **kw):
            if not self.seen:
                self.seen = True
                for i, g in enumerate(tree_leaves(grads)):
                    self.take(i, g)
            return orig(grads, *a, **kw)

        Z.zero1_update_clipped = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.parallel import zero1 as Z
        Z.zero1_update_clipped = self.orig


def family_cut(torch, root, arch, canon):
    """`arch`'s fp32 cut (FAMILY_CUT_LAYERS at full width), once for each
    of FAMILY_CUT_COMMS' kept-sync levels (cut_pair)."""
    from repro_torch.tree import tree_map

    cfg = family_cfg(arch, FAMILY_CUT_LAYERS[arch], dtype="float32")
    params = dict(canon, layers=canon["layers"][:cfg.n_layers])
    params = tree_map(lambda w: w.float(), params)
    for comm in FAMILY_CUT_COMMS:
        cut_pair(torch, root, arch, cfg, params, comm)
        release(torch)


def cut_pair(torch, root, arch, cfg, params, comm):
    """FAMILY_CUT_STEPS steps at kept-sync level `comm` with the kernels
    (B1, B8 and, at quant8, the fused kept sync) and the same steps with
    their plain versions (attn_backend "xla", plain_ssd, plain_syncs),
    the MoE routing of the first replayed in the second: step 1's loss
    and grad norm within FAMILY_CUT_RTOL, and its gradients leaf by leaf
    within FAMILY_CUT_GRAD_L2[comm] (relative L2) with their sign
    disagreements counted (all, and among elements above GRAD_NOISE_X x
    the leaf's RMS difference); with exact syncs the later steps within
    FAMILY_CUT_RTOL and the params after within FAMILY_CUT_PAST, at
    quant8 printed (FAMILY_CUT_LAYERS' note).  Returns step 1's
    per-leaf gradient statistics, in tree_leaves order."""
    from repro_torch.tree import tree_leaves

    pin = TrainRoutePin()
    res, kept, stats = {}, [], []

    def keep(i, g):
        kept.append(g.detach().clone())

    def compare(i, g):
        k, p = kept[i].float(), g.detach().float()
        d = k - p
        rms = d.pow(2).mean().sqrt()
        flips = torch.sign(k) != torch.sign(p)
        above = p.abs() > GRAD_NOISE_X * rms
        stats.append(dict(
            i=i, shape=tuple(p.shape), n=p.numel(),
            l2=(d.norm() / p.norm().clamp_min(1e-30)).item(),
            flips=int(flips.sum()), above=int(above.sum()),
            flips_above=int((flips & above).sum())))
        kept[i] = None

    for backend in ("pallas", "xla"):
        tr, st = family_trainer(root, cfg, f"cut-{arch}-{comm}-{backend}",
                                params, FAMILY_CUT_STEPS,
                                attn_backend=backend, comm=comm,
                                **FAMILY_CUT_KW)
        if backend == "pallas":
            with pin.record(), StepGrads(keep):
                st, launches = counted(torch, lambda: tr.run(st))
        else:
            with pin.replay(), plain_ssd(), plain_syncs(), \
                    StepGrads(compare):
                st, launches = counted(torch, lambda: tr.run(st))
        res[backend] = ([m["loss"] for m in tr.metrics_log],
                        [m["grad_norm"] for m in tr.metrics_log], launches,
                        [w.detach().clone() for w in
                         tree_leaves(st["params"])])
        del tr, st
        release(torch)
    (lk, gk, ek, pk), (lp, gp, ep, pp) = res["pallas"], res["xla"]
    rel = max(abs(a - b) / abs(b) for a, b in ((lk[0], lp[0]),
                                                (gk[0], gp[0])))
    rel2 = max(abs(a - b) / abs(b) for a, b in zip(lk[1:] + gk[1:],
                                                   lp[1:] + gp[1:]))
    ran = {k: v for k, v in ek.items() if v}
    worst = max(stats, key=lambda r: r["l2"])
    n = sum(r["n"] for r in stats)
    flips = sum(r["flips"] for r in stats)
    above = sum(r["above"] for r in stats)
    flips_above = sum(r["flips_above"] for r in stats)
    bound = FAMILY_CUT_GRAD_L2[comm]
    print(f"family cut {arch} fp32 {comm} kept syncs ({cfg.n_layers} "
          f"layers, batch {FAMILY_CUT_KW['batch']} x "
          f"{FAMILY_CUT_KW['seq']}): kernels losses {lk} grad_norms {gk}; "
          f"plain {lp} {gp}; step 1 max rel {rel:.3e} (tol "
          f"{FAMILY_CUT_RTOL:.0e}), later steps {rel2:.3e}"
          + (" (held)" if comm == "exact" else "") + "; kernel launches "
          f"{json.dumps(ran)}, plain {sum(ep.values())}"
          + (f"; routing replayed: {pin.flips} of {pin.choices} top-k "
             "choices would differ" if pin.choices else ""))
    print(f"family cut {arch} {comm}: step 1 gradients, {len(stats)} "
          f"leaves: worst leaf relative L2 {worst['l2']:.3e} (leaf "
          f"{worst['i']} {worst['shape']}; bound {bound:.0e}); median "
          f"leaf {sorted(r['l2'] for r in stats)[len(stats) // 2]:.3e}; "
          f"sign disagreements {flips} of {n} elements ({flips / n:.3%}), "
          f"{flips_above} among the {above} ({above / n:.3%}) above "
          f"{GRAD_NOISE_X} x their leaf's RMS difference")
    diff = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(pk, pp))
    past = sum(int(((a.float() - b.float()).abs() > 1e-5 * a.float().abs()
                    .max()).sum().item()) for a, b in zip(pk, pp)) / sum(
                        a.numel() for a in pk)
    print(f"family cut {arch} {comm}: params after {FAMILY_CUT_STEPS} steps "
          f"max abs diff {diff:.3e} (2 lr x steps "
          f"{2 * FAMILY_TRAIN_KW['lr'] * FAMILY_CUT_STEPS:.1e}), {past:.3%} "
          f"of the elements past 1e-5 of their leaf's largest"
          + (f" (tol {FAMILY_CUT_PAST:.0%})" if comm == "exact" else ""))
    if not (rel <= FAMILY_CUT_RTOL and worst["l2"] <= bound
            and (ran or comm == "exact") and not any(ep.values())) or (
                comm == "exact" and not (rel2 <= FAMILY_CUT_RTOL
                                         and past <= FAMILY_CUT_PAST)):
        raise AssertionError(f"family cut {arch} {comm}: the kernels and "
                             f"their plain versions disagree in fp32")
    return stats


def b8_train_rows(torch, card):
    """B8 under autograd at each B8_TRAIN_SHAPES shape, bf16: the forward
    through the autograd Function (the kernel) and its backward (the
    plain VJP) against the plain version differentiated directly, with
    the bounds above; the forward, the backward and the plain forward
    timed.  Returns their kernels-line rows."""
    from repro_torch.kernels import ssd_scan as SS

    rows = []
    for arch, sh in B8_TRAIN_SHAPES:
        chunk, s = sh["chunk"], B8_TRAIN_S
        args = [t.detach().requires_grad_() for t in
                ssd_inputs(torch, s, torch.bfloat16, sh)]
        gen = torch.Generator(device="cuda").manual_seed(31)
        w = torch.randn(args[0].shape, generator=gen, device="cuda")

        def fwd():
            return SS.ssd_scan(*args, chunk=chunk)

        def grads(y):
            return torch.autograd.grad((y.float() * w).sum(), args)

        n0 = SS.ssd_scan.launches
        y, _ = fwd()
        if SS.ssd_scan.launches != n0 + 1 or "SSDScan" not in type(
                y.grad_fn).__name__:
            raise AssertionError("B8 under autograd did not launch through "
                                 "its autograd Function")
        gk = grads(y)
        yp, _ = SS.ssd_scan_plain(*args, chunk=chunk)
        gp = grads(yp)
        torch.cuda.synchronize()

        def l2(a, b):
            return ((a.float() - b.float()).norm()
                    / b.float().norm().clamp_min(1e-30)).item()

        err = (y.float() - yp.float()).abs().max().item()
        top = yp.float().abs().max().item()
        fl2 = l2(y, yp)
        gl2 = {n: l2(a, b) for n, a, b in zip(
            ("x", "dt", "a", "bm", "cm", "dd"), gk, gp)}
        fwd_ms = cuda_ms(torch, fwd, iters=10)
        step_ms = cuda_ms(torch, lambda: grads(fwd()[0]), iters=5)
        plain_ms = cuda_ms(torch, lambda: SS.ssd_scan_plain(
            *args, chunk=chunk), iters=5)
        plain_step = cuda_ms(torch, lambda: grads(SS.ssd_scan_plain(
            *args, chunk=chunk)[0]), iters=5)
        nbytes, flops = ssd_work(sh["bt"], sh["h"], s, sh["p"], sh["n"],
                                 sh["g"], chunk, 2)
        b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
        rel = {k: float(f"{v:.3e}") for k, v in gl2.items()}
        print(f"B8 under autograd [{card}] {arch} x ({sh['bt']},{s},"
              f"{sh['h']},{sh['p']}) N {sh['n']} bf16: y max_abs_err="
              f"{err:.3e} (tol {SSD_BF16_Y_REL * top:.3e}), relative L2 "
              f"{fl2:.3e} (tol {B8_FWD_L2:.1e}); gradients' relative L2 "
              f"from the plain version's {json.dumps(rel)}"
              f" (tol {B8_GRAD_L2:.0e}); forward ms={fwd_ms:.5f} (the "
              f"kernel), backward ms={step_ms - fwd_ms:.5f} (the plain "
              f"VJP; forward + backward {step_ms:.5f}), plain forward "
              f"{plain_ms:.5f}, plain forward + backward {plain_step:.5f}; "
              f"bound_ms={b_ms:.6f} ({b_by}, the forward's work)")
        if not (err <= SSD_BF16_Y_REL * top and fl2 <= B8_FWD_L2
                and max(gl2.values()) <= B8_GRAD_L2):
            raise AssertionError(f"B8 under autograd at {arch}'s train "
                                 f"shape disagrees with the plain version")
        rows.append({"name": "ssd_scan", "route": "cuda",
                     "source": "src/repro_torch/csrc/ssd_scan.cu",
                     "replaces": "src/repro/kernels/ssd_scan.py:66",
                     "max_abs_err": err, "ms": fwd_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "context_ms": step_ms - fwd_ms,
                     "shape": f"x ({sh['bt']},{s},{sh['h']},{sh['p']}) bf16, "
                              f"N {sh['n']}: under autograd in {arch}'s "
                              f"train step (forward the kernel; "
                              f"context_ms the backward, the plain VJP)"})
        del args, y, yp, gk, gp
        release(torch)
    return rows


#: Algorithm 1 on the families (18, 19, 21): a quarter of the blocks
#: chosen, the recovery over FAMILY_ALG1_EPOCHS epochs at RECOVERY_LR
FAMILY_ALG1_EPOCHS = 4


class b1_parts:
    """Inside: B1's launches counted by part of an apply_spd call (the
    sweep, the capture and each block's distillation), the capture's
    block inputs kept (`inputs`)."""

    def __enter__(self):
        from repro_torch.core import distill as D
        from repro_torch.core import spd as SPD
        from repro_torch.kernels import flash_attention as FA
        self.saved = (SPD.capture_block_inputs, D.b2b_distill)
        self.counts = {"capture": 0, "distill": []}
        self.inputs = None
        capture, distill = self.saved
        fa = FA.flash_attention_bhsd
        fa.launches = 0

        def counted_capture(*a, **kw):
            self.counts["sweep"] = fa.launches
            hid = capture(*a, **kw)
            self.counts["capture"] = fa.launches - self.counts["sweep"]
            self.inputs = hid
            return hid

        def counted_distill(*a, **kw):
            before = fa.launches
            out = distill(*a, **kw)
            self.counts["distill"].append((fa.launches - before,
                                           len(out[1])))
            return out

        SPD.capture_block_inputs, D.b2b_distill = (counted_capture,
                                                   counted_distill)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import distill as D
        from repro_torch.core import spd as SPD
        SPD.capture_block_inputs, D.b2b_distill = self.saved


class b8_autograd:
    """Inside: `n`, the SSD scans that entered B8's autograd Function
    (`kernels.ssd_scan._SSDScan`, whose forward is the kernel launch)."""

    def __enter__(self):
        from repro_torch.kernels import ssd_scan as SS
        orig, self.n = SS._SSDScan.apply, 0

        def apply(*a):
            self.n += 1
            return orig(*a)

        SS._SSDScan.apply = apply
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ssd_scan as SS
        del SS._SSDScan.apply          # Function.apply again


def b8_distill_want(kinds, distill_losses):
    """B8's autograd launches in an apply_spd's distillation: the
    student's forward, once a step of each distilled SSM or hybrid
    block (the teacher's runs without grad)."""
    return sum(len(losses) for b, losses in distill_losses.items()
               if kinds[b].mixer in ("ssm", "hybrid"))


def family_alg1(torch, np, llm, prompts, card, label):
    """Algorithm 1 on a family's full-width model `llm` (its serving
    placement released): the sensitivity sweep; apply_comm_policy with
    n_spd = L // 4 and (tau1, tau2) at the 25th and 75th percentiles of
    the sensitivities (drop, quant8 and exact syncs in one plan; at
    least 3 blocks); then
    apply_spd (ZS, B2B, HG) at recovery_taus over FAMILY_ALG1_EPOCHS
    epochs: B1 counted by part against what the code implies (each
    evaluation and capture a launch a full-causal attention layer and
    batch, 2 a distill step of such a block), each part's wall seconds,
    every distillation loss finite, each grouping the reference's rule
    (a partition of the heads on an MLA layer with an MLP FFN, the
    identity on MoE and hybrid layers).  Each plan is served, its
    greedy tokens equal to a rerun on the quantized collectives' plain
    versions.  Returns what the shard phase holds its ranks to."""
    from repro_torch.core import spd as SPD
    from repro_torch.core.layer_kinds import layer_kinds
    from repro_torch.data import calibration_batches
    from repro_torch.kernels import flash_attention as FA

    cfg, n = llm.cfg, llm.cfg.n_layers
    kinds = layer_kinds(cfg)
    flash = sum(k.mixer == "gqa" and not k.window for k in kinds) if (
        cfg.attn_backend == "pallas") else 0
    calib = calibration_batches(cfg.vocab_size, **SWEEP_CALIB)
    n_spd = max(n // 4, 3)          # room for one ISB, SB and ESB block
    llm._release_engine()
    release(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, _ = SPD.sweep_sensitivity(cfg, llm.canonical, calib, llm.tp,
                                   q_chunk=llm.q_chunk)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    tau1, tau2 = (float(np.percentile(res.sensitivity, 25)),
                  float(np.percentile(res.sensitivity, 75)))
    FA.flash_attention_bhsd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = llm.apply_comm_policy(calib, n_spd=n_spd, tau1=tau1, tau2=tau2,
                                logits="quant8")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    modes = llm.plan.modes()
    counts = {m: modes.count(m) for m in ("drop", "quant8", "exact")}
    b1 = FA.flash_attention_bhsd.launches
    want = (n + 1) * len(calib) * flash
    print(f"{label} apply_comm_policy [{card}]: L={n} n_spd={n_spd} "
          f"tau1={tau1:.4f} tau2={tau2:.4f}: plan {counts} ("
          + " ".join(f"{i}:{m}" for i, m in enumerate(modes))
          + f"); sweep {sweep_s:.2f} s, apply_comm_policy {wall:.2f} s "
          f"(its sweep and the re-placement); B1 launches {b1} (want "
          f"{want}); peak_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}")
    if not (np.isfinite(got.ppl_suffix).all() and b1 == want
            and sorted(got.ranking.tolist()) == list(range(n))
            and 0 < llm.plan.n_dropped <= n_spd
            and counts["quant8"] and counts["exact"]):
        raise AssertionError(f"{label}: the tiered plan is not what "
                             f"Algorithm 1 gives: {modes}, B1 {b1}")
    out = {"policy": dict(ppl=got.ppl_suffix, sens=got.sensitivity,
                          ranking=got.ranking.tolist(), modes=modes,
                          tau1=tau1, tau2=tau2, n_spd=n_spd, wall=wall)}
    family_serve(torch, llm, prompts, f"{label} tiered plan")

    llm._release_engine()
    release(torch)
    r_tau1, r_tau2 = recovery_taus(np, got, n_spd)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with b1_parts() as parts, b8_autograd() as b8:
        rep = llm.apply_spd(calib, n_spd=n_spd, tau1=r_tau1, tau2=r_tau2,
                            lr=RECOVERY_LR, epochs=FAMILY_ALG1_EPOCHS,
                            strategies=("ZS", "B2B", "HG"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sec = rep.seconds
    c = parts.counts
    steps = [k for _, k in c["distill"]]
    rec = [b for b, t in zip(rep.chosen, rep.categories) if t != "ISB"]
    want = {"sweep": (n + 1) * len(calib) * flash,
            "capture": len(calib) * flash if rec else 0,
            "distill": [(2 * k * (kinds[b].mixer == "gqa"
                                  and not kinds[b].window and bool(flash)), k)
                        for b, k in zip(rec, steps)]}
    have = {"sweep": c.get("sweep", FA.flash_attention_bhsd.launches),
            "capture": c["capture"], "distill": c["distill"]}
    b8_want = b8_distill_want(kinds, rep.distill_losses)
    print(f"{label} apply_spd [{card}]: n_spd={n_spd} tau1={r_tau1:.4f} "
          f"tau2={r_tau2:.4f} lr={RECOVERY_LR:g} epochs="
          f"{FAMILY_ALG1_EPOCHS}: tiers " + " ".join(
              f"{b}:{t}" for b, t in zip(rep.chosen, rep.categories))
          + f"; {wall:.2f} s wall (sweep {sec['sweep']:.2f} s"
          + "".join(f", {k} {sec[k]:.2f} s" for k in
                    ("capture", "grouping", "distill") if k in sec)
          + f"); B1 launches by part {json.dumps(have)} (want "
          f"{json.dumps(want)}); B8 under autograd (distillation) "
          f"{b8.n} (want {b8_want}); peak_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}")
    if have != want or len(steps) != len(rec) or any(
            k != FAMILY_ALG1_EPOCHS * len(calib) for k in steps) or (
                b8.n != b8_want):
        raise AssertionError(f"{label} apply_spd: B1 launches {have} or "
                             f"B8's under autograd {b8.n} are not what "
                             f"the code implies ({want}, {b8_want})")
    for b, losses in sorted(rep.distill_losses.items()):
        first = float(np.mean(losses[:len(calib)]))
        last = float(np.mean(losses[-len(calib):]))
        print(f"{label} distill block {b} ({kinds[b].mixer}, {kinds[b].ffn}"
              f"): loss first epoch {first:.4e} last epoch {last:.4e} "
              f"({last / first:.3f}x)")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{label}: block {b}'s losses {losses}")
    for b, g in sorted(rep.grouping.items()):
        grouped = kinds[b].mixer == "mla" and kinds[b].ffn == "mlp"
        print(f"{label} grouping block {b} ({kinds[b].mixer}, "
              f"{kinds[b].ffn}): supported={g.supported} groups={g.groups} "
              f"assignment={g.assignment}")
        if g.supported != grouped or (grouped and sorted(
                h for grp in g.groups for h in grp) != list(range(
                    cfg.n_heads))):
            raise AssertionError(f"{label}: block {b}'s grouping {g}")
    if llm.plan.n_dropped != n_spd:
        raise AssertionError(f"{label}: the recovered plan drops "
                             f"{llm.plan.n_dropped}, not {n_spd}")
    out["spd"] = dict(modes=llm.plan.modes(), chosen=list(rep.chosen),
                      categories=list(rep.categories), wall=wall,
                      seconds=dict(sec), tau1=r_tau1, tau2=r_tau2,
                      b8_autograd=b8.n)
    family_serve(torch, llm, prompts, f"{label} recovered plan")
    if cfg.mla is not None:
        mla_grouping_check(torch, llm, parts.inputs, card, label)
    llm._release_engine()
    release(torch)
    return out


def family_serve(torch, llm, prompts, label):
    """A plan of Algorithm 1 served: greedy tokens of `prompts`, then the
    same with the quantized collectives' plain versions, bit for bit."""
    from repro_torch.api import SamplingParams
    outs = llm.generate(prompts, SamplingParams(max_new=MAX_NEW))
    tokens = [o.token_ids for o in outs]
    if any(len(t) != MAX_NEW for t in tokens):
        raise AssertionError(f"{label}: the plan's generate failed")
    print(f"{label}: served, tokens[0] {tokens[0]}")
    same_tokens_plain(torch, label, llm, prompts, tokens)


def mla_grouping_check(torch, llm, inputs, card, label):
    """deepseek's dense MLA layer (layer 0: MLA with an MLP FFN) grouped
    one head a unit on its captured block input (or the embedding when
    the capture did not run): a partition of the heads over the shards
    (supported, as the reference groups it)."""
    from repro_torch.core import grouping as G
    from repro_torch.core.layer_kinds import layer_kinds
    from repro_torch.data import calibration_batches
    from repro_torch.tree import tree_map

    kind = layer_kinds(llm.cfg)[0]
    if inputs is not None:
        x = inputs[0][0]
    else:
        calib = calibration_batches(llm.cfg.vocab_size, **SWEEP_CALIB)
        tok = torch.as_tensor(calib[0]["tokens"]).to(llm.device)
        x = llm.canonical["emb"].to(llm.device)[tok]
    layer = tree_map(lambda w: w.to(llm.device), llm.canonical["layers"][0])
    t0 = time.perf_counter()
    g = G.group_heads(llm.cfg, kind, layer, x, llm.tp)
    heads = sorted(h for grp in g.groups for h in grp)
    print(f"{label} grouping of layer 0 ({kind.mixer}, {kind.ffn}) [{card}]:"
          f" supported={g.supported} groups={g.groups} assignment="
          f"{g.assignment} score={g.score:.4f} in "
          f"{time.perf_counter() - t0:.2f} s")
    if not (g.supported and heads == list(range(llm.cfg.n_heads))
            and len(g.groups) == llm.tp):
        raise AssertionError(f"{label}: the dense MLA layer's grouping {g}")


# ---------------------------------------------------------------------------
# The MoE and hybrid families: qwen2-moe-a2.7b and hymba-1.5b at full
# width through the facade (tp=2, spd=0.25, quant8, attn_backend="pallas")
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
HYMBA_ARCH = "hymba-1.5b"
# the fp32 teacher-forced checks of qwen2-moe keep layers 4-7 (two
# dropped and two kept blocks of the spd=0.25 plan): a full-width fp32
# copy is ~57 GB
MOE_FP32_LAYERS = (4, 8)
# hymba's prompts: the last is longer than its 1024-token window, so its
# windowed layers decode on a rolling buffer from the first step
HYMBA_PROMPT_LENS = (17, 64, 200, 1100)
HYMBA_CACHE_LEN = 2048
# B8 at hymba's prefill: one stream a shard (tp 2, batch 1), 15 heads of
# 64 a shard (25 heads laid out as the attention's q heads: 30, five of
# them zero), N 16, one group, chunk 256
HYMBA_SSD_SHAPE = dict(bt=2, h=15, p=64, n=16, g=1, chunk=256)
HYMBA_SSD_SEQS = (300, 1100)
HYMBA_SSD_TIMED_S = 1100
# B1 at qwen2-moe's prefill: 8 q / 8 kv heads a shard at D 128 (tp 2,
# batch 1 -> 16 rows), the 512-token bucket
MOE_FLASH = dict(bh=16, bhkv=16, s=512, d=128)
# the fused kept sync at one decode token of each model (d 2048, d 1600)
# and B3 on each model's logits gather (151936 / 2 and 32002 / 2 columns)
FAMILY_QPSUM = (((2, 2048), MOE_ARCH), ((2, 1600), HYMBA_ARCH))
FAMILY_QDQ = (((2, 75968), MOE_ARCH), ((2, 16001), HYMBA_ARCH))


def family_kernel_phase(torch, card):
    """The kernels at the new paths' shapes, each against its plain
    version with the earlier tolerances, timed beside it, its library
    call where one exists, and its bound: B8 at hymba's shape (N 16, H
    15; S 300 and 1100, bf16 and fp32); B1 at qwen2-moe's prefill; the
    fused kept sync at d 2048 and 1600; B3 on 75968 and 16001 columns.
    Returns kernels-line rows tagged with the path whose launches each
    reports (`_path`)."""
    from repro_torch.kernels import flash_attention as FA

    rows = [ssd_phase(torch, HYMBA_SSD_SHAPE, HYMBA_SSD_SEQS,
                      HYMBA_SSD_TIMED_S, None,
                      "one hymba-1.5b layer of the 1100-token prefill")]
    rows[0]["_path"] = HYMBA_ARCH
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(23)
    sh = MOE_FLASH
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = flash_inputs(torch, gen, sh["s"], sh["d"], dtype,
                               bh=sh["bh"], bhkv=sh["bhkv"])
        out = FA.flash_attention_bhsd(q, k, v)
        ref = FA.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = (FLASH_FP32_ATOL if dtype == torch.float32 else
               2.0 ** -7 * max(ref.float().abs().max().item(), 1e-3))
        print(f"flash {str(dtype)[6:]} q ({sh['bh']},{sh['s']},{sh['d']}) "
              f"({MOE_ARCH}'s prefill): max_abs_err={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"flash kernel disagrees at {MOE_ARCH}'s "
                                 f"prefill in {dtype}: {err} > {tol}")
    row = flash_row(torch, q, k, v, err, f"{MOE_ARCH}'s prefill (8 q / 8 "
                    "kv heads a shard)")
    row["_path"] = MOE_ARCH
    rows.append(row)
    for (tp, n), path in FAMILY_QPSUM:
        rows.append(checked_qpsum_row(torch, gen, card, tp, n, path,
                                      f"a {path} kept sync at d {n}"))
    for (r, n), path in FAMILY_QDQ:
        rows.append(checked_qdq_row(torch, gen, r, n, path))
    return rows


def moe_phase(torch, np, card):
    """qwen2-moe-a2.7b at full width (FAMILY_LAYERS: 8 of its 24
    layers, d 2048, 60 routed + 4 shared experts, top-4; ~14.3 B
    parameters at full depth; random weights from seed 0): the dense path (B1 once per layer and prefill,
    the fused kept sync per kept sync and forward, qdq per forward, no B2
    or B8), plain-sync tokens, a profile; with the dense placement freed,
    the paged path (a preemption, every page back, a warm admission
    through B2's chunk kernel, B2's decode); then the teacher-forced
    checks in bf16 at full width and in fp32 on MOE_FP32_LAYERS; then
    Algorithm 1 (family_alg1).  One placement at a time beside the
    canonical weights (two would not fit beside them).  Returns (dense
    launches, paged launches)."""
    llm, prompts, launches, tokens = main_path(torch, np, card, MOE_ARCH,
                                               "qwen2-moe path")
    cfg = llm.cfg
    want = cfg.n_layers * len(prompts)
    if (launches["flash_attention_bhsd"] != want or launches["ssd_scan"]
            or launches["paged_flash_attention"]):
        raise AssertionError(f"qwen2-moe path launches {launches}: want B1 "
                             f"{want} (layers x prefills), no B2 or B8")
    seen = profile_phase(torch, llm, prompts, card, label="qwen2-moe profile")
    if seen and not (seen["flash_fwd_tc_kernel"]
                     and not seen["flash_fwd_kernel"]):
        raise AssertionError(f"qwen2-moe's prefill did not run on the "
                             f"tensor-core flash kernel: {seen}")
    llm._release_engine()             # the canonical weights stay
    release(torch)
    fp32_run(torch, llm, prompts, "qwen2-moe path")
    paged, paged_launches = paged_path(torch, np, llm, prompts, tokens, card,
                                       label="qwen2-moe paged path")
    decode = (paged_launches["paged_flash_attention"]
              - paged_launches["paged_flash_attention_chunk"])
    if decode <= 0 or paged_launches["paged_flash_attention_chunk"] <= 0:
        raise AssertionError(f"qwen2-moe paged path: B2 decode {decode}, "
                             f"chunks {paged_launches}")
    del paged
    release(torch)
    teacher_forced(torch, llm, prompts[2], MOE_FP32_LAYERS, "qwen2-moe ")
    teacher_forced_paged(torch, llm, prompts[2], MOE_FP32_LAYERS,
                         "qwen2-moe ")
    print(f"qwen2-moe phase: peak_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} since the "
          "paged path's load")
    SIM_RUNS["qwen2-moe alg1"] = family_alg1(torch, np, llm, prompts, card,
                                             "qwen2-moe")
    del llm
    release(torch)
    return launches, paged_launches


def hymba_phase(torch, np, card):
    """hymba-1.5b at full width (FAMILY_LAYERS: 8 of its 32 layers, d
    1600, 25 attention heads beside 25 SSM heads of 64, N 16, a
    1024-token window but on layer 0; random weights from seed
    0) on dense caches
    (cache_len 2048): prompts of 17, 64, 200 and 1100 tokens, each
    prefilled at its own length, 16 greedy tokens each; B8 once per layer
    and prefill, the fused kept sync per kept sync and forward, qdq per
    forward, no B1 or B2 (the reference's hybrid mixer takes the plain
    attention); plain-sync tokens; a profile (the idle share); then on
    the same weights with exact syncs, bf16 and fp32: prefill logits
    through B8 against the plain scan, and the 1100-token prompt's decode
    logits after teacher-forcing its tokens against one exact-length
    prefill (the rolling window); the paged fallback; then Algorithm 1
    (family_alg1).  Returns the path's launches."""
    from repro_torch.configs import get_config

    vocab = get_config(HYMBA_ARCH).vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n) for n in HYMBA_PROMPT_LENS]
    llm, launches, tokens = recurrent_path(
        torch, np, prompts, card, HYMBA_ARCH, HYMBA_CACHE_LEN, "hymba path")
    seen = profile_phase(torch, llm, prompts, card, label="hymba profile")
    if seen and not (seen["ssd_scores_kernel"] == seen["ssd_states_kernel"]
                     == seen["ssd_output_kernel"] > 0
                     and not seen["ssd_scan_kernel"]
                     and not seen["flash_fwd_tc_kernel"]):
        raise AssertionError(f"hymba's prefill did not run the three "
                             f"tensor-core SSD kernels alone: {seen}")
    recurrent_checks(torch, llm, prompts[3], tokens[3], HYMBA_CACHE_LEN,
                     "hymba")
    llm._release_engine()
    release(torch)
    fp32_run(torch, llm, prompts, "hymba path", HYMBA_CACHE_LEN)
    # paged through the fallback: the global layers' K/V paged, the
    # windowed K/V, SSM state and conv tails dense per slot
    paged, _ = fallback_path(
        torch, np, llm, prompts, tokens, card, "hymba paged path",
        cache_len=HYMBA_CACHE_LEN, preempt=False,
        want={"ssd_scan": llm.cfg.n_layers * len(prompts),
              "flash_attention_bhsd": 0, "paged_flash_attention": 0})
    del paged
    release(torch)
    SIM_RUNS["hymba alg1"] = family_alg1(torch, np, llm, prompts, card,
                                         "hymba")
    del llm
    release(torch)
    return launches


# ---------------------------------------------------------------------------
# MLA, int8 KV caches and weights, and the paged gather -> dense ->
# scatter fallback: deepseek-v2-lite-16b at full width, llama2-7b with
# int8 KV and weights, hymba-1.5b paged
# ---------------------------------------------------------------------------

DEEPSEEK_ARCH = "deepseek-v2-lite-16b"
# the fp32 teacher-forced check of deepseek keeps layers 5-8 (two of the
# spd=0.25 plan's 7 dropped blocks, two kept): a full-width fp32 copy is
# ~63 GB
DEEPSEEK_FP32_LAYERS = (5, 9)
# B3 on deepseek's logits gather: 102400 / 2 columns a shard
DEEPSEEK_QDQ = (2, 51200)
# the int8 variants of llama2-7b, on its canonical weights
INT8_VARIANTS = (("int8 KV", dict(kv_dtype="int8")),
                 ("int8 KV + weights", dict(kv_dtype="int8",
                                            weight_dtype="int8")))
# teacher-forced logits of an int8 variant against the bf16 path on the
# same weights (exact syncs), as a share of the largest bf16 logit: the
# int8 KV codes round each K/V entry to 1/254 of its row's absmax, the
# int8 weights each weight to 1/254 of its column's
TF_INT8_REL = {"int8 KV": 0.05, "int8 KV + weights": 0.10}


def check_launches(label, launches, want):
    """Exact launch counts of the kernels in `want`."""
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def fallback_path(torch, np, llm, prompts, dense_tokens, card, label, *,
                  want, cache_len=512, preempt=True):
    """Paged serving through the gather -> dense -> scatter fallback on
    `llm`'s model, plan and weights (its placement released first by the
    caller): on a pool large enough for every request at its peak
    (max_batch x cache_len / PAGE_SIZE pages; the tables' bucketed width
    is then the dense cache's, so the dense step sees the same shapes)
    the tokens must equal `dense_tokens`, the syncs count as on the dense
    path, `want` holds the other kernels' launches and the prefix cache
    is off; a profile shows where the step's time goes.  `preempt`: then
    on a NUM_PAGES pool the four requests outgrow, at least one
    preemption and every page back.  Returns (paged LLM, launches)."""
    import dataclasses
    from repro_torch.api import LLM, SamplingParams
    from repro_torch.core import model as M
    from repro_torch.parallel.collectives import collective_ledger

    cfg = llm.cfg
    if M.supports_paged_attention(cfg):
        raise AssertionError(f"{label}: {cfg.name} has the fused paged path")
    pages = 4 * cache_len // PAGE_SIZE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paged = LLM.load(cfg, tp=2, plan=llm.plan, cache_len=cache_len,
                     max_batch=4, page_size=PAGE_SIZE, num_pages=pages,
                     params=llm.canonical)
    torch.cuda.synchronize()
    flags = M.cache_pageable_tree(cfg, paged.plan)
    print(f"{label}: loaded in {time.perf_counter() - t0:.1f} s; {pages} "
          f"pages of {PAGE_SIZE}; pageable leaves "
          f"{[sorted(k for k, f in seg.items() if f is True) for seg in flags]}")
    paged.generate([prompts[0][:8]], SamplingParams(max_new=2))  # warm-up
    times = timed_engine(torch, paged.engine, ("prefill", "decode_paged"))
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with collective_ledger() as led, \
            LogitsTape(label in TAPED_LABELS) as tape:
        outs = paged.generate(prompts, SamplingParams(max_new=MAX_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    check_sync_launches(label, paged, launches, times)
    check_launches(label, launches, want)
    SIM_RUNS[label] = dict(tokens=[o.token_ids for o in outs],
                           ledger=ledger_rows(led), launches=dict(launches),
                           tape=tape.host())
    sched = paged.serve()
    tokens = [o.token_ids for o in outs]
    n_tok = sum(len(t) for t in tokens)
    steps = len(times["decode_paged"])
    print(f"{label} launches: {json.dumps(launches)}")
    print(f"{label} [{card}]: prefill_ms={1e3 * sum(times['prefill']):.2f} "
          f"decode_ms_per_token="
          f"{1e3 * sum(times['decode_paged']) / max(steps, 1):.2f} ({steps} "
          f"paged decode steps, each gathering the pageable leaves) "
          f"tokens_per_s={n_tok / wall:.1f} peak_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} (load "
          f"included) prefix_cache={sched.kv.prefix_cache} "
          f"tokens equal the dense path's: {tokens == dense_tokens}")
    if (tokens != dense_tokens or sched.kv.prefix_cache
            or sched.pool.num_free != pages):
        raise AssertionError(f"{label}: tokens {tokens} != dense "
                             f"{dense_tokens} or pages not back "
                             f"({sched.pool.num_free}/{pages})")
    profile_phase(torch, paged, prompts, card, label=f"{label} profile")
    if preempt:
        paged.cache = dataclasses.replace(paged.cache, num_pages=NUM_PAGES)
        paged._sched = None            # a fresh scheduler on the small pool
        outs = paged.generate(prompts, SamplingParams(max_new=MAX_NEW))
        sched = paged.serve()
        sched.pool.check()
        same = sum(a == b for o, d in zip(outs, dense_tokens)
                   for a, b in zip(o.token_ids, d))
        print(f"{label}, {NUM_PAGES}-page pool: preemptions="
              f"{sched.n_preemptions} preempted="
              f"{[o.n_preempted for o in outs]} pages_returned="
              f"{sched.pool.num_free}/{NUM_PAGES} pool_high_water="
              f"{sched.pool.high_water}; {same}/{n_tok} tokens equal the "
              "dense path's (a preempted request re-prefills prompt + "
              "tokens in another bucket; on MoE, routing counts every row "
              "of a step, ROADMAP C7)")
        if (sched.n_preemptions < 1 or sched.pool.num_free != NUM_PAGES
                or any(len(o.token_ids) != MAX_NEW for o in outs)):
            raise AssertionError(f"{label}: {sched.n_preemptions} "
                                 f"preemptions, {sched.pool.num_free}/"
                                 f"{NUM_PAGES} pages back")
    return paged, launches


class TokenRoutePin:
    """MoE routing pinned token by token from one prefill into other
    forwards over the same tokens: `record()` keeps every route of the
    reference forward (a prefill over all the tokens), `replay(start)`
    hands each route call of a later forward the recorded rows of its
    tokens (start .. start+T-1) and counts the top-k choices it would
    have made otherwise.  With a capacity that holds every assignment,
    routing is then per token in both forwards, so a decode-vs-prefill
    check measures the attention forms, not a near-tied top-k choice."""

    def __init__(self):
        self.kept, self.flips, self.choices = [], 0, 0

    @contextlib.contextmanager
    def _patched(self, fn):
        from repro_torch.models import moe as MOE
        orig = MOE.route
        MOE.route = lambda *a, **kw: fn(orig, *a, **kw)
        try:
            yield self
        finally:
            MOE.route = orig

    def record(self):
        def rec(orig, *a, **kw):
            out = orig(*a, **kw)
            self.kept.append(out)
            return out
        return self._patched(rec)

    def replay(self, start, valid=None):
        """`valid`: how many of the call's rows are real tokens (a
        bucketed prefill's pads route as they like); all by default."""
        it = iter(self.kept)

        def rep(orig, hf, *a, **kw):
            own = orig(hf, *a, **kw)
            gates, idx, aux = next(it)
            t = hf.shape[1]
            gates, idx = gates[:, start:start + t], idx[:, start:start + t]
            n = t if valid is None else valid
            same = (own[1][:, :n].sort(-1).values
                    == idx[:, :n].sort(-1).values)
            self.flips += int((~same).sum())
            self.choices += same.numel()
            return gates, idx, aux
        return self._patched(rep)

    def note(self) -> str:
        return (f" routing pinned: {self.flips} of {self.choices} top-k "
                "choices would differ")


def mla_decode_vs_prefill(torch, llm, prompt, toks, fp32_layers, label=""):
    """The absorbed MLA decode against the sequence form: after
    prefilling `prompt` and teacher-forcing `toks[:-1]` through dense
    decode, the last decode logits against one exact-length prefill of
    prompt + toks[:-1], exact syncs, a capacity that holds every
    assignment and the routing pinned to the full prefill's
    (TokenRoutePin); fp32 on `fp32_layers` within TF_FP32_ATOL, bf16 at
    full width within TF_BF16_REL of the largest logit."""
    import dataclasses
    import numpy as np
    from repro_torch.api import LLM
    from repro_torch.config.base import replace
    from repro_torch.runtime.forward import bucketed_prefill

    s = len(prompt)
    full = np.concatenate([prompt, np.asarray(toks[:-1])])
    for dtype in ("float32", "bfloat16"):
        cfg, params, plan = tf_model(llm, dtype, fp32_layers)
        cfg = replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_routed)))
        m = LLM.load(cfg, tp=2, plan=plan, cache_len=512, max_batch=1,
                     params=params)
        del params
        eng = m.engine
        pin = TokenRoutePin()
        with pin.record():
            lf, _ = bucketed_prefill(eng, m.params, full, len(full), 512)
        with pin.replay(0, valid=s):
            _, c1 = bucketed_prefill(eng, m.params, prompt, s, 512)
        caches = eng.insert_slot(eng.blank_caches(1, 512), c1, 0)
        for i, tok in enumerate(toks[:-1]):
            with pin.replay(s + i):
                _, ld, caches = eng.decode_with_logits(
                    m.params, np.asarray([[tok]]), np.asarray([s + i]),
                    caches)
        err = (ld.float() - lf.float()).abs().max().item()
        scale = lf.float().abs().max().item()
        tol = TF_FP32_ATOL if dtype == "float32" else TF_BF16_REL * scale
        print(f"{label}absorbed decode vs prefill ({s} + {len(toks) - 1} "
              f"tokens, {dtype}, {cfg.n_layers} layers): max_abs_err="
              f"{err:.3e} tol={tol:.3e} max|logit|={scale:.3e} same argmax="
              f"{int(ld.argmax()) == int(lf.argmax())}{pin.note()}")
        if not err <= tol:
            raise AssertionError(f"{label}absorbed decode disagrees with "
                                 f"the sequence form ({dtype}): {err} > "
                                 f"{tol}")
        del m, eng, caches, c1
        release(torch)


def deepseek_phase(torch, np, card):
    """deepseek-v2-lite-16b at full width (FAMILY_LAYERS: 9 of its 27
    layers, d 2048, MLA with 16 heads of nope 128 + rope 64, v 128, a
    512-wide latent; 64 routed + 2 shared experts, top-6, a dense first
    layer of 10944; 15.71 B parameters at full depth; random weights from
    seed 0) through the
    facade: the dense path (no B1: MLA's prefill takes the plain
    attention, as the reference's; the fused kept sync per kept sync and
    forward, qdq per forward, no B2 or B8), plain-sync tokens, a profile;
    with the dense placement freed, the paged path through the fallback
    (dense tokens on a pool large enough, a preemption and every page
    back on one the requests outgrow); then the absorbed decode against
    the sequence form; then Algorithm 1 (family_alg1, the dense MLA layer
    grouped).  Returns the dense path's launches."""
    n = model_cfg(DEEPSEEK_ARCH).param_count()
    print(f"deepseek path: {DEEPSEEK_ARCH} param_count={n} "
          f"({n / 1e9:.2f} B, {2 * n / 1e9:.1f} GB in bf16)")
    llm, prompts, launches, tokens = main_path(
        torch, np, card, DEEPSEEK_ARCH, "deepseek path",
        need=("qdq_absmax", "quantized_psum_absmax"))
    fwd = len(PROMPT_LENS) + MAX_NEW - 1
    check_launches("deepseek path", launches, {
        "qdq_absmax": fwd, "flash_attention_bhsd": 0,
        "paged_flash_attention": 0, "ssd_scan": 0})
    profile_phase(torch, llm, prompts, card, label="deepseek profile")
    llm._release_engine()             # the canonical weights stay
    release(torch)
    fp32_run(torch, llm, prompts, "deepseek path")
    paged, _ = fallback_path(
        torch, np, llm, prompts, tokens, card, "deepseek paged path",
        want={"qdq_absmax": fwd, "flash_attention_bhsd": 0,
              "paged_flash_attention": 0, "ssd_scan": 0})
    del paged
    release(torch)
    mla_decode_vs_prefill(torch, llm, prompts[2], tokens[2],
                          DEEPSEEK_FP32_LAYERS, "deepseek ")
    print(f"deepseek phase: peak_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} since the "
          "paged path's load")
    SIM_RUNS["deepseek alg1"] = family_alg1(torch, np, llm, prompts, card,
                                            "deepseek")
    del llm
    release(torch)
    return launches


def int8_vs_model(torch, llm, base_cfg, prompt, toks, label):
    """Teacher-forced logits (the prefill and each decode step along
    `toks`) of the int8 variant `llm` against the bf16 path of the same
    canonical weights, exact syncs, both through B1's prefill; held to
    TF_INT8_REL[label] of the largest bf16 logit."""
    import numpy as np
    from repro_torch.api import LLM
    from repro_torch.runtime.forward import bucketed_prefill

    def forced(cfg):
        m = LLM.load(cfg, tp=2, plan=llm.plan.with_comm(None), cache_len=512,
                     max_batch=1, params=llm.canonical)
        eng, s = m.engine, len(prompt)
        lg, c1 = bucketed_prefill(eng, m.params, prompt, s, 512)
        caches = eng.insert_slot(eng.blank_caches(1, 512), c1, 0)
        out = [lg.float()]
        for i, tok in enumerate(toks[:-1]):
            _, lg, caches = eng.decode_with_logits(
                m.params, np.asarray([[tok]]), np.asarray([s + i]), caches)
            out.append(lg.float())
        return torch.cat(out)

    got, want = forced(llm.cfg), forced(base_cfg)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    tol = TF_INT8_REL[label] * scale
    print(f"{label} vs bf16 teacher-forced ({len(prompt)} + "
          f"{len(toks) - 1} tokens): max_abs_err={err:.3e} tol={tol:.3e} "
          f"max|logit|={scale:.3e} (err/max {err / scale:.4f}) same argmax "
          f"{same}/{len(toks)}")
    if not err <= tol:
        raise AssertionError(f"{label} logits off the bf16 path: {err} > "
                             f"{tol}")


def int8_phase(torch, np, llama, card):
    """llama2-7b at full width on its canonical weights (the llama
    paths' placements freed) with kv_dtype="int8", then with int8 KV and
    weight-only int8: the dense path as in 3 (B1 once per layer and
    prefill, the syncs as held, no B2 or B8), plain-sync tokens, a
    profile (device-busy ms), the teacher-forced logits against the bf16
    path, and the paged path through the fallback (the dense tokens; a
    preemption, every page back).  Returns {variant: dense launches}."""
    from repro_torch.config.base import replace

    base = replace(llama.cfg, attn_backend="pallas")
    fwd = len(PROMPT_LENS) + MAX_NEW - 1
    want = {"flash_attention_bhsd": base.n_layers * len(PROMPT_LENS),
            "qdq_absmax": fwd, "paged_flash_attention": 0, "ssd_scan": 0}
    out = {}
    for label, kw in INT8_VARIANTS:
        m, prompts, launches, tokens = main_path(
            torch, np, card, "llama2-7b", f"llama2-7b {label} path",
            cfg_kw=kw, params=llama.canonical)
        check_launches(f"llama2-7b {label} path", launches, want)
        profile_phase(torch, m, prompts, card,
                      label=f"llama2-7b {label} profile")
        m._release_engine()
        release(torch)
        int8_vs_model(torch, m, base, prompts[2], tokens[2], label)
        release(torch)
        paged, _ = fallback_path(torch, np, m, prompts, tokens, card,
                                 f"llama2-7b {label} paged path", want=want)
        del paged, m
        release(torch)
        out[label] = launches
    return out

# ---------------------------------------------------------------------------
# The modality frontends: internvl2-1b and musicgen-medium (A4)
# ---------------------------------------------------------------------------

FRONT_ARCHS = ("internvl2-1b", "musicgen-medium")
#: the frontend prefill's decode buffer: internvl's 256-token prefix
#: before the 300-token prompt and MAX_NEW tokens takes 572 slots
FRONT_CACHE_LEN = 1024
#: the fp32 checks of the frontend prefill keep the first four layers
FRONT_FP32_LAYERS = (0, 4)
#: (c): each model's bf16 train run (FAMILY_TRAIN_KW: tp 2 x dp 2,
#: ZeRO-1, batch 4 x 512 in 2 microbatches, quant8 kept syncs, half the
#: blocks dropped) at this depth, full width, and its fp32 cut
#: (FAMILY_CUT_KW) at the same depth with exact kept syncs
FRONT_TRAIN_LAYERS = 2
FRONT_TRAIN_STEPS = 2
#: (d): musicgen-medium on the shard engine's ranks, full width, this
#: many of its 48 layers, serving a frontend prefill; sim serves the same
#: cut in the frontend phase (SIM_RUNS[FRONT_SHARD_LABEL])
FRONT_SHARD_ARCH = "musicgen-medium"
FRONT_SHARD_LAYERS = 8
FRONT_SHARD_LABEL = "musicgen frontend path"
#: B1 at each model's frontend prefill (tp 2, the four rows of PROMPT_LENS
#: behind the prefix, S = Flen + 300): internvl 7 q heads on 1 kv head a
#: shard (group 7), musicgen 12 on 12 (group 1), D 64; the fused kept
#: sync at one decode token of each (d 896, d 1536); B3 on each logits
#: gather (151656 / 2 and 2048 / 2 columns)
FRONT_FLASH = {"internvl2-1b": dict(bh=2 * 4 * 7, bhkv=2 * 4 * 1,
                                    s=256 + 300, d=64),
               "musicgen-medium": dict(bh=2 * 4 * 12, bhkv=2 * 4 * 12,
                                       s=64 + 300, d=64)}
FRONT_QPSUM = (((2, 896), "internvl2-1b"), ((2, 1536), "musicgen-medium"))
FRONT_QDQ = (((2, 75828), "internvl2-1b"), ((2, 1024), "musicgen-medium"))


def frontend_inputs(np, cfg, seed=0):
    """The frontend prefill's inputs: PROMPT_LENS prompts right-padded
    into one (4, 300) batch, their lengths, and seeded embeds (4, Flen,
    frontend_dim) fp32 (the reference's tests draw them so)."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(PROMPT_LENS, np.int64)
    toks = np.zeros((len(lens), int(lens.max())), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    emb = rng.standard_normal((len(lens), cfg.frontend_len,
                               cfg.frontend_dim)).astype(np.float32)
    return toks, lens, emb


def frontend_run(torch, np, llm, steps=MAX_NEW, cache_len=FRONT_CACHE_LEN):
    """A frontend prefill through `Engine.prefill(embeds=)` (the caches
    hold Flen + S positions; the logits are the last real token's), then
    `steps` greedy decode steps at Flen + lengths on its caches, counted
    (every kernel's launches), timed, every full-vocab logits tensor
    kept (a LogitsTape's "full" events).  Returns {"tokens" (B lists of
    steps + 1), "tape", "launches", "fwd", "prefill_ms", "decode_ms"}."""
    eng, cfg = llm.engine, llm.cfg
    toks, lens, emb = frontend_inputs(np, cfg)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    tape = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = eng.prefill(llm.params, toks, cache_len=cache_len,
                             lengths=lens, embeds=emb)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    tape.append(("full", lg.detach().clone()))
    cur = torch.argmax(lg, -1)[:, None]
    out = [cur]
    pos = cfg.frontend_len + lens
    t0 = time.perf_counter()
    for i in range(steps):
        cur, lg, caches = eng.decode_with_logits(llm.params, cur, pos + i,
                                                 caches)
        tape.append(("full", lg.detach().clone()))
        out.append(cur)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / max(steps, 1)
    return dict(tokens=torch.cat(out, 1).tolist(),
                tape=[(k, t.float().cpu().numpy()) for k, t in tape],
                launches={k.__name__: k.launches for k in kernels},
                fwd=1 + steps, prefill_ms=prefill_ms, decode_ms=decode_ms)


def frontend_serve(torch, np, llm, label, card):
    """`frontend_run` on `llm`, its launches held (B1 once a layer, the
    fused kept sync once a quantized kept sync and forward, B3 once a
    forward, nothing else), then again with the quantized collectives'
    plain versions: the same tokens and logits, bit for bit, and no
    kernel of theirs launched.  Returns the counted run."""
    res = frontend_run(torch, np, llm)
    fwd, layers = res["fwd"], llm.cfg.n_layers
    want = {"flash_attention_bhsd": layers,
            "quantized_psum_absmax": kept_syncs(llm) * fwd,
            "qdq_absmax": fwd}
    got = {k: res["launches"][k] for k in want}
    others = {k: v for k, v in res["launches"].items() if k not in want and v}
    print(f"{label} [{card}]: frontend prefill of prompts "
          f"{list(PROMPT_LENS)} behind {llm.cfg.frontend_len} x "
          f"{llm.cfg.frontend_dim} embeds (cache {FRONT_CACHE_LEN}), "
          f"{fwd - 1} greedy decode steps: prefill_ms="
          f"{res['prefill_ms']:.2f} decode_ms_per_token="
          f"{res['decode_ms']:.2f}; launches {json.dumps(got)} (want "
          f"{json.dumps(want)}); tokens[0] {res['tokens'][0]}")
    if got != want or others:
        raise AssertionError(f"{label}: launches {res['launches']}, want "
                             f"{want} and no other")
    with plain_syncs():
        plain = frontend_run(torch, np, llm)
    leaked = sum(plain["launches"][n] for n in plain_syncs.NAMES)
    same = plain["tokens"] == res["tokens"] and all(
        np.array_equal(a, b) for (_, a), (_, b) in zip(plain["tape"],
                                                        res["tape"]))
    print(f"{label}: tokens and logits with the quantized collectives' "
          f"plain versions equal the kernels': {same} (kernel launches "
          f"inside: {leaked})")
    if not same or leaked:
        raise AssertionError(f"{label}: the plain-sync frontend run differs "
                             "from the kernels'")
    return res


def frontend_fp32(torch, np, llm, label):
    """The frontend prefill's logits in fp32 on FRONT_FP32_LAYERS at full
    width (`tf_model`: the plan's drop mask, exact syncs), with B1
    against the plain attention: within TF_FP32_ATOL."""
    from repro_torch.api import LLM
    from repro_torch.config.base import replace

    cfg0, params, plan = tf_model(llm, "float32", FRONT_FP32_LAYERS)
    toks, lens, emb = frontend_inputs(np, cfg0)
    logits, launches = {}, {}
    for backend in ("pallas", "xla"):
        m = LLM.load(replace(cfg0, attn_backend=backend), tp=2, plan=plan,
                     cache_len=FRONT_CACHE_LEN, max_batch=4, params=params)
        (lg, _), launches[backend] = counted(torch, lambda: m.engine.prefill(
            m.params, toks, cache_len=FRONT_CACHE_LEN, lengths=lens,
            embeds=emb))
        logits[backend] = lg.float()
        del m
    del params
    err = (logits["pallas"] - logits["xla"]).abs().max().item()
    b1 = launches["pallas"]["flash_attention_bhsd"]
    print(f"{label} fp32 frontend prefill (layers {FRONT_FP32_LAYERS}, "
          f"exact syncs): B1 against the plain attention max_abs_err="
          f"{err:.3e} tol={TF_FP32_ATOL:.0e} max|logit|="
          f"{logits['xla'].abs().max().item():.3e}; B1 launches {b1}, "
          f"plain {launches['xla']['flash_attention_bhsd']}")
    if not (err <= TF_FP32_ATOL and b1 == cfg0.n_layers
            and not launches["xla"]["flash_attention_bhsd"]):
        raise AssertionError(f"{label}: the fp32 frontend prefill's kernel "
                             f"and plain logits disagree ({err})")


def frontend_kernel_phase(torch, card):
    """The kernels at the frontend paths' shapes, each against its plain
    version, timed beside it and its library call, with its bound: B1 at
    each model's frontend prefill (fp32 and bf16), the fused kept sync at
    d 896 and 1536, B3 on 75828 and 1024 columns.  Returns kernels-line
    rows tagged with the path whose launches each reports (`_path`)."""
    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(31)
    rows = []
    for arch, sh in FRONT_FLASH.items():
        g = sh["bh"] // sh["bhkv"]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(torch, gen, sh["s"], sh["d"], dtype,
                                   bh=sh["bh"], bhkv=sh["bhkv"])
            out = FA.flash_attention_bhsd(q, k, v)
            ref = FA.flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = (FLASH_FP32_ATOL if dtype == torch.float32 else
                   2.0 ** -7 * max(ref.float().abs().max().item(), 1e-3))
            print(f"flash {str(dtype)[6:]} q ({sh['bh']},{sh['s']},"
                  f"{sh['d']}) group {g} ({arch}'s frontend prefill): "
                  f"max_abs_err={err:.3e} tol={tol:.3e}")
            if not err <= tol:
                raise AssertionError(f"flash kernel disagrees at {arch}'s "
                                     f"frontend prefill in {dtype}: {err} > "
                                     f"{tol}")
        row = flash_row(torch, q, k, v, err, f"{arch}'s frontend prefill "
                        f"(group {g})")
        row["_path"] = arch
        rows.append(row)
    for (tp, n), path in FRONT_QPSUM:
        rows.append(checked_qpsum_row(torch, gen, card, tp, n, path,
                                      f"a {path} kept sync at d {n}"))
    for (r, n), path in FRONT_QDQ:
        rows.append(checked_qdq_row(torch, gen, r, n, path))
    return rows


def frontend_train(torch, np, card, arch):
    """(c): `arch` at full width, FRONT_TRAIN_LAYERS deep, through
    make_trainer on the simulated (data 2, model 2) mesh, bf16, with the
    trainer's embeds: FRONT_TRAIN_STEPS ZeRO-1 steps with every kernel
    counted (train_launches_want: B1 forward and remat recompute under
    autograd), finite losses; then the same depth's fp32 cut at exact
    kept syncs (`cut_pair`: step 1 within FAMILY_CUT_RTOL of the plain versions',
    each gradient leaf, `front`'s printed, within FAMILY_CUT_GRAD_L2)."""
    import shutil
    import tempfile

    from repro_torch.config.base import SPDPlanConfig
    from repro_torch.core import model as M
    from repro_torch.tree import tree_leaves, tree_map

    root = tempfile.mkdtemp(prefix="front_train_")
    try:
        cfg = family_cfg(arch, FRONT_TRAIN_LAYERS, dtype="bfloat16",
                         attn_backend="pallas")
        canon = M.init_model(cfg, seed=0, device=torch.device("cuda"))
        torch.cuda.reset_peak_memory_stats()
        tr, st = family_trainer(root, cfg, arch, canon, FRONT_TRAIN_STEPS)
        st, launches = counted(torch, lambda: tr.run(st))
        nmb = FAMILY_TRAIN_KW["microbatches"]
        want = train_launches_want(cfg, tr.plan, nmb, FRONT_TRAIN_STEPS)
        got = {k: launches[k] for k in want}
        others = {k: v for k, v in launches.items() if k not in want and v}
        log = tr.metrics_log
        print(f"frontend train {arch} [{card}]: L={cfg.n_layers} full width, "
              f"bf16, tp 2 x dp 2, plan {tr.plan.n_dropped} of "
              f"{cfg.n_layers} dropped, quant8 kept syncs, batch "
              f"{FAMILY_TRAIN_KW['batch']} x seq {FAMILY_TRAIN_KW['seq']} "
              f"behind {cfg.frontend_len} x {cfg.frontend_dim} embeds in "
              f"{nmb} microbatches, remat: losses "
              f"{[round(m['loss'], 5) for m in log]} grad_norms "
              f"{[round(m['grad_norm'], 4) for m in log]}; step_ms "
              f"{[round(1e3 * m['wall'], 1) for m in log]}; peak_memory_gib="
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}; launches "
              f"{json.dumps(got)} (want {json.dumps(want)})")
        if got != want or others or not all(
                np.isfinite([m["loss"], m["grad_norm"]]).all() for m in log):
            raise AssertionError(f"frontend train {arch}: launches "
                                 f"{launches} (want {want}), log {log}")
        del tr, st
        release(torch)
        cut = family_cfg(arch, FRONT_TRAIN_LAYERS, dtype="float32")
        params = tree_map(lambda w: w.float(), canon)
        del canon
        stats = cut_pair(torch, root, arch, cut, params, "exact")
        specs = M.stacked_specs(cut, SPDPlanConfig.none(cut.n_layers))
        i = len(tree_leaves({k: v for k, v in specs.items() if k < "front"}))
        print(f"frontend train {arch} exact: the front leaf's step 1 "
              f"gradient {stats[i]['shape']} relative L2 "
              f"{stats[i]['l2']:.3e} from the plain version's (bound "
              f"{FAMILY_CUT_GRAD_L2['exact']:.0e}), {stats[i]['flips']} "
              f"sign disagreements of {stats[i]['n']}")
        if stats[i]["shape"][-2:] != (cut.frontend_dim, cut.d_model):
            raise AssertionError(f"frontend train {arch}: leaf {i} is not "
                                 f"front: {stats[i]}")
        del params
        release(torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def front_shard_cfg():
    """(d)'s model: FRONT_SHARD_ARCH at full width, FRONT_SHARD_LAYERS
    deep, flash prefill."""
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    return replace(get_config(FRONT_SHARD_ARCH),
                   n_layers=FRONT_SHARD_LAYERS, attn_backend="pallas")


def frontend_phase(torch, np, card):
    """The modality frontends at full width (internvl2-1b: 24 layers, d
    896, GQA 14/2, a 256 x 1024 vision prefix, vocab 151655;
    musicgen-medium: 48 layers, d 1536, MHA 24 heads, LayerNorm, GELU,
    biases, a 64 x 768 audio prefix, vocab 2048; random weights from seed
    0), each at tp 2, spd 0.25, quant8 kept syncs and logits gather,
    bf16: (a) / (b) a text-only generate through `main_path` (its
    launches and plain-sync rerun), then a frontend prefill and
    MAX_NEW greedy decode steps (`frontend_serve`), the fp32 cut's
    frontend prefill against the plain attention (`frontend_fp32`);
    then (c) each model's training pair (`frontend_train`).  Sim's run
    of (d)'s cut is kept for the shard phase.  Returns ({arch: the
    frontend run's launches}, the kernel rows)."""
    from repro_torch.api import LLM
    from repro_torch.configs import get_config

    rows = frontend_kernel_phase(torch, card)
    out = {}
    for arch in FRONT_ARCHS:
        label = f"{arch} path"
        llm, _, _, _ = main_path(torch, np, card, arch, label)
        out[arch] = frontend_serve(torch, np, llm, f"{arch} frontend path",
                                   card)["launches"]
        llm._release_engine()          # the canonical weights stay
        release(torch)
        frontend_fp32(torch, np, llm, arch)
        del llm
        release(torch)
    m = LLM.load(front_shard_cfg(), **dict(SHARD_KW,
                                           cache_len=FRONT_CACHE_LEN))
    SIM_RUNS[FRONT_SHARD_LABEL] = frontend_run(torch, np, m)
    SIM_RUNS[FRONT_SHARD_LABEL]["kept"] = kept_syncs(m)
    print(f"{FRONT_SHARD_LABEL} ({FRONT_SHARD_LAYERS} of "
          f"{get_config(FRONT_SHARD_ARCH).n_layers} layers) on sim for the "
          f"shard phase: tokens[0] "
          f"{SIM_RUNS[FRONT_SHARD_LABEL]['tokens'][0]}")
    del m
    release(torch)
    for arch in FRONT_ARCHS:
        frontend_train(torch, np, card, arch)
    for r in rows:
        r["launches"] = out[r.pop("_path")][r["name"]]
    return out, rows



# ---------------------------------------------------------------------------
# The shard engine: one process per TP shard over torch.distributed
# ---------------------------------------------------------------------------

#: the sim engine's counted runs, by path label ({"tokens", "ledger",
#: "launches"}, the paged path's "prefix_tokens"): the shard phase holds
#: its ranks to them
SIM_RUNS: dict = {}
#: the sim runs the shard phase (b) holds its ranks to
SHARD_LABELS = ("main path", "paged path", "llama2-7b path")
#: the same for (b)'s speculative path and its family and int8 paths
SHARD_SPEC_LABEL = "llama2-7b spec path"
SHARD_INT8_LABEL = "llama2-7b int8 KV + weights path"
SHARD_FAMILY_LABELS = ("mamba path", "hymba path", "qwen2-moe path",
                       "qwen2-moe paged path", "deepseek path",
                       "deepseek paged path")
#: the sim runs that record their logits (LogitsTape) for the shard phase
TAPED_LABELS = SHARD_LABELS + (SHARD_INT8_LABEL,)
#: the families' fp32 runs on four layers at full width, quantized kept
#: syncs and logits gather (`fp32_run`): (first, stop) layer of each;
#: hymba's hold its global layer 0 (the cut numbers its layers from 0,
#: so its layer 0 attends globally: only a cut from 0 gives it a global
#: layer's weights), qwen2-moe's and deepseek's those of their fp32
#: checks
SHARD_FP32_LAYERS = {"mamba path": (20, 24), "hymba path": (0, 4),
                     "qwen2-moe path": (4, 8), "deepseek path": (5, 9)}


class LogitsTape:
    """Every logits tensor a generate decides its tokens by, in order:
    the shard logits each greedy decode step reduces ("shards": sim's
    (tp, B, Vl) stack, or a rank's (1, B, Vl) row) and every full-vocab
    logits tensor a step assembles ("full": a whole or chunked prefill's
    and a draft step's (B, V), a verify's or warm suffix prefill's (B, C,
    V)), through runtime.forward's greedy_token, full_logits and
    full_logits_seq (sim's reshape of its stacked shards, a rank's
    all-gather), which this wraps while it is entered (off: records
    nothing).  A full_logits call inside greedy_token (sim's reduction)
    is not an event of its own.  `host()` gives them as fp32 numpy.  The
    copies are taken on the device and moved after the run, so the timed
    steps are not held up."""

    def __init__(self, on=True):
        self.on, self.events, self._undo, self._reducing = on, [], [], False

    def __enter__(self):
        if not self.on:
            return self
        from repro_torch.runtime import forward as F
        greedy = F.greedy_token

        def taped_greedy(cfg, logits):
            self.events.append(("shards", logits.detach().clone()))
            self._reducing = True
            try:
                return greedy(cfg, logits)
            finally:
                self._reducing = False
        F.greedy_token = taped_greedy
        self._undo.append(lambda: setattr(F, "greedy_token", greedy))
        for name in ("full_logits", "full_logits_seq"):
            fn = getattr(F, name)

            def taped(cfg, logits, _fn=fn):
                out = _fn(cfg, logits)
                if not self._reducing:
                    self.events.append(("full", out.detach().clone()))
                return out
            setattr(F, name, taped)
            self._undo.append(lambda n=name, f=fn: setattr(F, n, f))
        return self

    def __exit__(self, *exc):
        while self._undo:
            self._undo.pop()()

    def host(self) -> list:
        return [(k, t.float().cpu().numpy()) for k, t in self.events]


def tape_rows(np, kind, parts, vocab):
    """One tape event as full-vocab rows: a "full" event as it is, the
    "shards" of every rank (or sim's stack) laid side by side in shard
    order, the padding columns dropped."""
    if kind == "full":
        return parts[0]
    a = np.concatenate(parts, 0)
    tp, b, vl = a.shape
    return a.transpose(1, 0, 2).reshape(b, tp * vl)[:, :vocab]


def tapes_agree(np, label, sim_tape, rank_tapes, vocab):
    """A shard run's logits against sim's, event by event, while the two
    runs have taken the same tokens (so their inputs are the same): max
    |shard - sim| within TF_BF16_REL of the event's largest |sim logit|;
    at the first event whose argmax parts, every parted row's sim top-2
    margin within twice that bound (else the shard engine decided
    otherwise than rounding can).  Every rank's "full" events are equal
    (all-gathered).  Prints err / bound event by event.  Returns (events
    compared, events, the largest err / bound, the parting: None or
    (event, rows, the largest margin / bound))."""
    n = len(sim_tape)
    worst, ratios = 0.0, []

    def seen():
        return (f"shard {label}: err / bound by event "
                f"{[round(x, 3) for x in ratios]}")
    for i, (kind, a) in enumerate(sim_tape):
        if any(len(t) <= i or t[i][0] != kind for t in rank_tapes):
            raise AssertionError(f"shard {label}: the ranks' logits events "
                                 f"part from sim's at event {i} of {n} "
                                 "before any token did")
        parts = [t[i][1] for t in rank_tapes]
        if kind == "full" and any(not np.array_equal(p, parts[0])
                                  for p in parts[1:]):
            raise AssertionError(f"shard {label}: the ranks' gathered "
                                 f"logits differ at event {i}")
        s = tape_rows(np, kind, [a], vocab)
        r = tape_rows(np, kind, parts, vocab)
        bound = TF_BF16_REL * float(np.abs(s).max())
        err = float(np.abs(r - s).max())
        worst = max(worst, err / bound)
        ratios.append(err / bound)
        if not err <= bound:
            raise AssertionError(f"shard {label}: logits event {i} ({kind}, "
                                 f"{s.shape}) max_abs_err {err:.4e} > "
                                 f"{bound:.4e}; {seen()}")
        parted = s.argmax(-1) != r.argmax(-1)
        if parted.any():
            top2 = np.sort(s[parted], -1)[:, -2:]
            margin = float((top2[:, 1] - top2[:, 0]).max())
            if not margin <= 2 * bound:
                raise AssertionError(
                    f"shard {label}: event {i} chose another token where "
                    f"sim's margin {margin:.4e} > {2 * bound:.4e}; {seen()}")
            print(seen())
            return i + 1, n, worst, (i, int(parted.sum()), margin / bound)
    if any(len(t) != n for t in rank_tapes):
        raise AssertionError(f"shard {label}: {[len(t) for t in rank_tapes]}"
                             f" logits events against sim's {n}")
    print(seen())
    return n, n, worst, None
SHARD_KW = dict(tp=2, spd=0.25, comm="quant8", comm_logits="quant8",
                dtype="bfloat16", cache_len=512, max_batch=4, seed=0)
#: (b)'s overlap pass: SmolLM-360M on engine="overlap" in the world of
#: ranks, after its dense and paged shard paths
SHARD_OVERLAP_LABEL = "overlap path"
# one kept sync's payload on the wire at llama2-7b's width, bf16: a batch-4
# decode step and one 512-token prefill
WIRE_PAYLOADS = (("decode", (4, 1, 4096)), ("prefill", (1, 512, 4096)))
SHARD_DEADLINE_S = 480
#: shard (b)'s Algorithm 1 on llama2-7b against sim's: the sweep and
#: tiered comm policy of sweep_phase, its served plan, the recovery of
#: recovery_phase, its served distilled plan, and the fp32 cut
ALG1_SWEEP, ALG1_TIERED = "llama2-7b sweep", "llama2-7b tiered plan"
ALG1_RECOVERY, ALG1_DISTILLED = ("llama2-7b recovery",
                                 "llama2-7b distilled plan")
ALG1_CUT = "llama2-7b fp32 cut"
#: the fp32 cut's perplexities and sensitivities against sim's, relative
#: to the largest of each: fp32 products of one shard against sim's
#: batched pair differ in summation order only
ALG1_CUT_RTOL = 1e-3
#: (c): the training spawn, tp 2 x dp 2 over gloo on one card
SHARD_TRAIN_DEADLINE_S = 360
SHARD_TRAIN_STEPS = 4                  # ZeRO-1, and the fault run's
SHARD_FAULT_AT, SHARD_FAULT_EVERY = 3, 2
SHARD_FSDP_STEPS = SHARD_QUANT_STEPS = 2
#: (c)'s step-1 loss against train phase (a)'s, bf16: the same batch on
#: the same weights, each rank's products on its own rows and shard
#: (cuBLAS picks its algorithm by shape); the bound is QUANT_LOSS_RTOL's,
#: a quarter of the loss's fall over (a)'s first 3 steps
SHARD_TRAIN_LOSS_RTOL = QUANT_LOSS_RTOL
#: (c)'s fp32 cut: 2 layers at full width, batch 4 x 512 tokens, against
#: the sim step on the same seeded weights: summation order only
SHARD_TRAIN_CUT = dict(batch=4, seq=512, microbatches=1, q_chunk=512,
                       dtype="float32", warmup=0)
SHARD_TRAIN_CUT_LAYERS = 2
SHARD_TRAIN_CUT_RTOL = 1e-4
#: (c)'s pod layout: the same four ranks re-bound as pod 2 x dp 1 x tp 2
#: (the reference's three-axis mesh, make_test_mesh(1, 2, pod=2)); 2
#: ZeRO-1 steps, 1 FSDP step and the fp32 cut there
SHARD_POD = dict(dp=1, pod=2)
SHARD_POD_STEPS = 2
#: (c)'s MoE training: qwen2-moe at 16f's depth and settings
#: (FAMILY_TRAIN_LAYERS, FAMILY_TRAIN_KW) on the four ranks, its step-1
#: loss against 16f's sim run within SHARD_TRAIN_LOSS_RTOL
SHARD_MOE_STEPS = 2
#: (b)'s second spawn: the families, one model at a time
SHARD_FAMILY_DEADLINE_S = 600
#: each (b) path's model, by label (its vocabulary for the logits rows)
SHARD_ARCHS = {"main path": "smollm-360m", "paged path": "smollm-360m",
               "llama2-7b path": "llama2-7b", SHARD_SPEC_LABEL: "llama2-7b",
               SHARD_INT8_LABEL: "llama2-7b", "mamba path": "mamba2-370m",
               "hymba path": HYMBA_ARCH, "qwen2-moe path": MOE_ARCH,
               "qwen2-moe paged path": MOE_ARCH,
               "deepseek path": DEEPSEEK_ARCH,
               "deepseek paged path": DEEPSEEK_ARCH}
#: the kernels a (b) path launches as its sim run does, by count
SHARD_SAME_AS_SIM = ("flash_attention_bhsd", "paged_flash_attention",
                     "ssd_scan")


def host_gib() -> tuple:
    """This process's host memory: (resident GiB now, from
    /proc/self/status; peak resident GiB, resource.getrusage)."""
    import resource
    now = 0.0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                now = int(line.split()[1]) / 2 ** 20
    return now, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def ledger_rows(led) -> list:
    return [(e.op, e.axis, e.nbytes, e.overlappable, e.block, e.phase)
            for e in led]


def shard_launches_want(size: int, kept: int, fwd: int, logits_q: bool):
    """Each rank's kept-sync kernels over `fwd` forwards of `kept`
    quantized kept syncs: the fused kernel in a group of one; across
    ranks the send and the receive kernel once a sync each; B3 once a
    forward (the logits gather); B4, B5 and B6 never."""
    syncs = kept * fwd
    across = size > 1
    return {"quantized_psum_absmax": 0 if across else syncs,
            "quantize_message_absmax": syncs if across else 0,
            "reduce_messages_absmax": syncs if across else 0,
            "qdq_absmax": fwd if logits_q else 0, "quantize_absmax": 0,
            "dequant_accum_absmax": 0, "dequantize_absmax": 0}


def shard_serve(torch, np, llm, prompts):
    """On a rank: a warm-up, then the counted, timed generate of
    `prompts` under the ledger and the logits tape; on a paged cache
    with a prefix cache (the fused paged kernels) also the warm prefix
    pair.  Every rank checks at each step that all took the same
    tokens."""
    from repro_torch.api import SamplingParams
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.parallel.collectives import collective_ledger

    llm.engine.backend.check_agreement = True
    llm.generate([prompts[0][:8]], SamplingParams(max_new=2))
    sched = llm.serve()
    paged = sched.kv.paged
    prefix = paged and bool(sched.kv.prefix_cache)
    names = (("prefill", "verify_paged", "decode_paged") if prefix
             else ("prefill", "decode_paged") if paged
             else ("prefill", "decode"))
    times = timed_engine(torch, llm.engine, names)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    FA.paged_flash_attention.chunk_launches = 0
    pre0 = sched.n_preemptions
    t0 = time.perf_counter()
    tape = LogitsTape().__enter__()   # on through the prefix pair
    with collective_ledger() as led:
        outs = llm.generate(prompts, SamplingParams(max_new=MAX_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    fwd = sum(len(v) for v in times.values())
    dec = times[names[-1]]
    res = dict(tokens=[o.token_ids for o in outs], ledger=ledger_rows(led),
               launches=launches, fwd=fwd, kept=kept_syncs(llm),
               logits_q=llm.plan.logits_mode != "exact",
               prefill_ms=1e3 * sum(sum(times[n]) for n in names[:-1]),
               decode_ms=1e3 * sum(dec) / max(len(dec), 1),
               steps=len(dec), wall=wall, events=len(tape.events),
               n_tok=sum(len(o.token_ids) for o in outs))
    if paged:
        res["preemptions"] = sched.n_preemptions - pre0
        res["pages_back"] = sched.pool.num_free
    if prefix:
        hits0, suf0 = sched.kv.prefix_hits, len(times["verify_paged"])
        chunk0 = FA.paged_flash_attention.chunk_launches
        pair = prefix_prompts(np, llm.cfg.vocab_size, 1)
        res["prefix_tokens"] = [o.token_ids for o in llm.generate(
            pair, SamplingParams(max_new=8))]
        res["prefix_hits"] = sched.kv.prefix_hits - hits0
        res["suffix_prefills"] = len(times["verify_paged"]) - suf0
        res["chunk_launches"] = (FA.paged_flash_attention.chunk_launches
                                 - chunk0)
    tape.__exit__(None, None, None)
    res["tape"] = tape.host()
    return res


def shard_plain_same(torch, np, llm, prompts, res):
    """On a rank, after `shard_serve`: `plain_rerun` on a fresh
    scheduler, every rank swapping the send, receive and B3 kernels for
    their plain versions.  Its tokens and every logits event must equal
    the kernels' run bit for bit (the kernels are bit-identical to their
    plain versions at every payload the path sends, ragged last chunks
    included).  Sets res["plain_same"] and res["plain_leaked"]."""
    toks, tape, leaked = plain_rerun(torch, llm, prompts, fresh=True)
    res["plain_leaked"] = leaked
    res["plain_same"] = (toks == res["tokens"] and len(tape) == res["events"]
                         and all(k == k2 and np.array_equal(a, b)
                                 for (k, a), (k2, b) in zip(tape, res["tape"])))
    return res


def wire_ms(torch, g) -> dict:
    """One kept sync's bf16 all-reduce over the model group at the
    WIRE_PAYLOADS, CUDA events on this rank: ms per call (20 calls after
    3), every rank calling."""
    import torch.distributed as dist

    out = {}
    for name, shape in WIRE_PAYLOADS:
        x = torch.randn(shape, device=g.device, dtype=torch.bfloat16)
        for _ in range(3):
            dist.all_reduce(x, group=g.model_group)
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(20):
            dist.all_reduce(x, group=g.model_group)
        t1.record()
        torch.cuda.synchronize()
        out[name] = dict(shape=list(shape), bytes=x.numel() * 2,
                         ms=t0.elapsed_time(t1) / 20)
    return out


def shard_rank_nccl(torch, np, g):
    """(a): llama2-7b at full width at tp = the world, one rank a card:
    sim at that tp on this rank's card, then the shard engine on the
    same canonical weights."""
    from repro_torch.api import LLM, SamplingParams
    from repro_torch.config.base import replace

    cfg = replace(model_cfg("llama2-7b"), attn_backend="pallas")
    kw = dict(SHARD_KW, tp=g.tp)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    sim = LLM.load(cfg, device=g.device, **kw)
    sim.generate([prompts[0][:8]], SamplingParams(max_new=2))
    sim_tokens = [o.token_ids for o in sim.generate(
        prompts, SamplingParams(max_new=MAX_NEW))]
    canonical = sim.canonical
    del sim
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    llm = LLM.load(cfg, engine="shard", params=canonical, **kw)
    out = shard_serve(torch, np, llm, prompts)
    out["sim_tokens"] = sim_tokens
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if g.world > 1:
        out["wire"] = wire_ms(torch, g)
    return out


def rank_load(torch, g, label, load):
    """`load()` on a rank, timed, its card peak since and host memory
    after printed at once (before anything is checked)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = load()
    torch.cuda.synchronize()
    info = dict(load_s=time.perf_counter() - t0, t0=t0)
    rss, peak = host_gib()
    print(f"shard {label} rank {g.rank}: loaded in {info['load_s']:.1f} s; "
          f"card {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held "
          f"(peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}); host "
          f"rss {rss:.2f} GiB (peak {peak:.2f})", flush=True)
    return llm, info


def rank_done(torch, res, info):
    """A rank's path result with its load time, card peak (load
    included), host memory and seconds (load + serve)."""
    rss, peak = host_gib()
    res.update(load_s=info["load_s"],
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               rss_gib=rss, maxrss_gib=peak,
               seconds=time.perf_counter() - info["t0"])
    return res


def shard_spec_serve(torch, np, llm, prompts, plain, g, card):
    """(b)'s speculative path on a rank: spec phase (a)'s settings (chain
    k=SPEC_K, the all-drop draft, dense) over chunked prefill
    (SPEC_CHUNK) on the llama2-7b placement, counted (spec_counts: the
    send and receive kernels a kept quantized sync of each forward, B3 a
    target forward, no B1: the prefill is chunked and the drafter adopts
    it), its logits and ledger recorded; every committed token held to a
    teacher-forced plain forward on the same rank; `plain` is the
    rank's own plain llama2-7b run (its decode ms a token)."""
    from repro_torch.api import SamplingParams
    from repro_torch.spec import SpecConfig

    t0 = time.perf_counter()
    llm.enable_spec(SpecConfig(k=SPEC_K, draft="all-drop"))
    llm.engine.backend.check_agreement = True
    llm.generate([prompts[0][:8]], SamplingParams(max_new=2))  # warm-up
    rec = {}
    label = f"shard {SHARD_SPEC_LABEL} rank {g.rank}"
    spec_generate(torch, llm, prompts, label, card,
                  dict(max_batch=4, prefill_chunk=SPEC_CHUNK), record=rec)
    rec["teacher_forced"] = teacher_forced_tokens(
        torch, llm, prompts, rec["tokens"], f"{label} teacher-forced")
    rec["same_as_plain"] = sum(a == b for t, u in zip(rec["tokens"],
                                                     plain["tokens"])
                               for a, b in zip(t, u))
    rec.update(plain_ms=plain["decode_ms"],
               seconds=time.perf_counter() - t0)
    llm.disable_spec()
    return rec


def shard_rank_gloo(torch, np, g, card, alg1):
    """(b): two ranks on one card over gloo: SmolLM-360M dense and paged,
    its overlap pass (shard_rank_overlap), the rings across the two
    ranks (shard_rank_rings), then llama2-7b dense, its speculative path, Algorithm 1 on it
    (shard_rank_alg1, `alg1` sim's thresholds and plan) and its int8 KV
    + weights variant, each at full width with the main path's settings
    (SHARD_KW), the canonical weights drawn on the card and kept on the
    host."""
    import gc

    from repro_torch.api import LLM
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config

    out = {}
    cfg = replace(get_config("smollm-360m"), attn_backend="pallas")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    llm = LLM.load(cfg, engine="shard", **SHARD_KW)
    out["main path"] = shard_serve(torch, np, llm, prompts)
    paged = LLM.load(cfg, tp=2, plan=llm.plan, cache_len=512, max_batch=4,
                     page_size=PAGE_SIZE, num_pages=NUM_PAGES,
                     params=llm.canonical, engine="shard")
    out["paged path"] = shard_serve(torch, np, paged, prompts)
    del paged
    out[SHARD_OVERLAP_LABEL] = shard_rank_overlap(
        torch, np, cfg, llm.canonical, prompts, out["main path"])
    out["rings"] = shard_rank_rings(torch, g)
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    cfg = replace(model_cfg("llama2-7b"), attn_backend="pallas")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    llm = LLM.load(cfg, engine="shard", **SHARD_KW)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    out["llama2-7b path"] = shard_serve(torch, np, llm, prompts)
    out["llama2-7b path"].update(
        load_s=load_s, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        held_gib=torch.cuda.memory_allocated() / 2 ** 30)
    out[SHARD_SPEC_LABEL] = shard_spec_serve(
        torch, np, llm, prompts, out["llama2-7b path"], g, card)
    llm._release_engine()
    release(torch)
    out["alg1"] = shard_rank_alg1(torch, np, g, llm, prompts, alg1)
    canonical = llm.canonical
    del llm
    release(torch)
    cfg8 = replace(cfg, kv_dtype="int8", weight_dtype="int8")
    m, info = rank_load(torch, g, SHARD_INT8_LABEL, lambda: LLM.load(
        cfg8, engine="shard", params=canonical, **SHARD_KW))
    out[SHARD_INT8_LABEL] = rank_done(
        torch, shard_serve(torch, np, m, prompts), info)
    return out


def shard_rank_overlap(torch, np, cfg, canonical, prompts, shard):
    """(b)'s overlap pass on a rank: the main path's canonical weights on
    engine="overlap" with SHARD_KW (in this world of ranks the shard
    backend plus the overlap seams), served by `shard_serve` (counted,
    timed, its ledger); its logits events against the shard main path's
    (`shard`, this rank's run) bit for bit; then `decode_pipelined` over
    PIPE_GROUPS groups of 4 against serial decode, in turns (S P P S),
    host ms each."""
    from repro_torch.api import LLM

    ov = LLM.load(cfg, engine="overlap", params=canonical, **SHARD_KW)
    res = shard_serve(torch, np, ov, prompts)
    tape = res.pop("tape")
    res.update(backend=type(ov.engine.backend).__name__,
               overlaps_comm=ov.engine.backend.overlaps_comm,
               same_logits=len(tape) == len(shard["tape"]) and all(
                   k == k2 and np.array_equal(a, b)
                   for (k, a), (k2, b) in zip(tape, shard["tape"])))
    eng, params = ov.engine, ov.params
    toks0 = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 1))
    pos = np.zeros((4,), np.int64)

    def run(piped):
        gs = [(toks0 + i, pos, eng.blank_caches(4, 512))
              for i in range(PIPE_GROUPS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = (eng.decode_pipelined(params, gs, depth=2) if piped
               else [eng.decode(params, *g) for g in gs])
        torch.cuda.synchronize()
        return [o[0] for o in out], 1e3 * (time.perf_counter() - t0)

    (s1, ts1), (p1, tp1) = run(False), run(True)
    (p2, tp2), (s2, ts2) = run(True), run(False)
    res["pipelined"] = dict(
        same=all(torch.equal(a, b) for a, b in zip(s1 + s2, p1 + p2)),
        serial_ms=(ts1, ts2), piped_ms=(tp1, tp2))
    return res


def shard_rank_rings(torch, g):
    """(b)'s rings across the two ranks of the model group, on this
    rank's row of the ring phase's tp-2 SmolLM payloads (drawn from its
    seed, in its order, on card 0: prefill 2 x 4 x 512 x 960, then
    decode 2 x 4 x 960).  Per payload and bits 8 / 4: the kernel path's
    row against the plain path's (`plain_ring`) and against this rank's
    row of the sim ring on the stacked tensor, bit for bit; the kernels'
    launches a call; ms a call across the ranks (gloo, staged through
    the host) beside the sim ring's.  Then ring_reduce_scatter and
    ring_all_gather across the ranks against the sim rows."""
    from repro_torch.kernels import quant_collectives as QC
    from repro_torch.parallel import compression as C
    from repro_torch.parallel.collectives import ModelGroup, model_group

    gen = torch.Generator(device=g.device).manual_seed(5)
    counted = (QC.quantize_absmax, QC.dequant_accum_absmax, QC.qdq_absmax)
    ctx, r = ModelGroup(g.tp, g.model_rank, g.model_group), g.model_rank
    rows = []

    def across(fn, mine):
        with model_group(ctx):
            return fn(mine)

    for label, shp in (("prefill", (2, 4, 512, 960)),
                       ("decode", (2, 4, 1, 960))):
        x = torch.randn(shp, generator=gen, device=g.device)
        mine = x[r:r + 1]
        exact = x.sum(dim=0)
        for bits in (8, 4):
            def ring(v, b=bits):
                return C.ring_quantized_psum(v, bits=b)
            sim_row = ring(x)[r]
            for k in counted:
                k.launches = 0
            y = across(ring, mine)
            torch.cuda.synchronize()
            got = {k.__name__: k.launches for k in counted}
            for k in counted:
                k.launches = 0
            with plain_ring():
                yp = across(ring, mine)
            torch.cuda.synchronize()
            levels = 127 if bits == 8 else 7
            rows.append(dict(
                label=label, shape=list(mine.shape), bits=bits,
                same_plain=torch.equal(y, yp),
                same_sim=torch.equal(y[0], sim_row), launches=got,
                leaked=sum(k.launches for k in counted),
                err=(y[0] - exact).abs().max().item(),
                bound=(2 * 2 + 1) / levels * x.abs().max().item(),
                ms=cuda_ms(torch, lambda: across(ring, mine), iters=10,
                           warmup=2),
                sim_ms=cuda_ms(torch, lambda: ring(x), iters=20)))
        rs = across(C.ring_reduce_scatter, mine)
        ag = across(C.ring_all_gather, mine)
        rows.append(dict(
            label=label, shape=list(mine.shape), bits=None,
            same_sim=(torch.equal(rs[0], C.ring_reduce_scatter(x)[r])
                      and torch.equal(ag[0], C.ring_all_gather(x)[r])),
            rs_ms=cuda_ms(torch, lambda: across(C.ring_reduce_scatter,
                                                mine), iters=10, warmup=2),
            ag_ms=cuda_ms(torch, lambda: across(C.ring_all_gather, mine),
                          iters=10, warmup=2)))
    return rows


def rank_fp32(torch, np, g, llm, prompts, label, routes, cache_len=512):
    """`fp32_run` of `llm`'s model on the shard engine's ranks, served
    by `shard_serve` with the MoE routing pinned to sim's fp32 run
    (`routes`, RoutePin.host(); this rank's shard rows): a quantized
    sync's flipped code can flip a near-tied top-k choice, which moves a
    token's logits by far more than the flip did, so pinned the check
    measures the shard math and the syncs, not the router's
    discontinuity."""
    m, info = rank_load(torch, g, f"{label} fp32", lambda: fp32_run(
        torch, llm, prompts, label, cache_len, shard=True))
    with RoutePin.from_host(routes).replay(shard=g.rank) as pin:
        res = shard_serve(torch, np, m, prompts)
    return rank_done(torch, dict(res, route_flips=pin.flips,
                                 route_choices=pin.choices), info)


def rank_family_policy(torch, np, llm, alg1):
    """hymba's Algorithm 1 on a rank, over sim's calibration batches:
    apply_comm_policy at sim's n_spd and thresholds (`alg1`:
    family_alg1's "policy"), its sweep running B8 on the rank's shard;
    then apply_spd at sim's recovery thresholds (`alg1["spd"]`), whose
    distillation runs B8 under autograd on the rank (b8_autograd).
    Each timed, B8 counted."""
    from repro_torch.core.layer_kinds import layer_kinds
    from repro_torch.data import calibration_batches
    from repro_torch.kernels import ssd_scan as SS

    calib = calibration_batches(llm.cfg.vocab_size, **SWEEP_CALIB)
    SS.ssd_scan.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = llm.apply_comm_policy(calib, n_spd=alg1["n_spd"],
                                tau1=alg1["tau1"], tau2=alg1["tau2"],
                                logits="quant8")
    torch.cuda.synchronize()
    out = dict(ppl=res.ppl_suffix, sens=res.sensitivity,
               ranking=res.ranking.tolist(), modes=llm.plan.modes(),
               wall=time.perf_counter() - t0, b8=SS.ssd_scan.launches)
    llm._release_engine()
    release(torch)
    t0 = time.perf_counter()
    with b8_autograd() as b8:
        rep = llm.apply_spd(calib, n_spd=alg1["n_spd"],
                            tau1=alg1["spd"]["tau1"],
                            tau2=alg1["spd"]["tau2"], lr=RECOVERY_LR,
                            epochs=FAMILY_ALG1_EPOCHS,
                            strategies=("ZS", "B2B", "HG"))
    torch.cuda.synchronize()
    losses = {int(b): [float(x) for x in v]
              for b, v in rep.distill_losses.items()}
    out["spd"] = dict(
        modes=llm.plan.modes(), chosen=[int(b) for b in rep.chosen],
        categories=list(rep.categories), wall=time.perf_counter() - t0,
        b8_autograd=b8.n,
        b8_want=b8_distill_want(layer_kinds(llm.cfg), rep.distill_losses),
        losses=losses,
        finite=bool(all(np.isfinite(v).all() for v in losses.values())))
    llm._release_engine()
    release(torch)
    return out


def shard_rank_families(torch, np, g, card, routes, hymba_alg1):
    """(b)'s second spawn: the MoE, MLA, SSM and hybrid families at full
    width on two ranks of one card over gloo, one model at a time (each
    released before the next), each with its sim run's settings: mamba2
    and hymba as `recurrent_path` loads them (hymba's prompts and cache
    of `hymba_phase`), qwen2-moe and deepseek as `main_path` does; then
    on the same canonical weights qwen2-moe paged as `paged_path` (the
    40-page pool, the warm prefix pair) and deepseek paged through the
    fallback as `fallback_path` (a pool for every request at its peak).
    Each bf16 path is served again with the quantized collectives' plain
    versions (`shard_plain_same`); each model's four-layer fp32 cut
    (`fp32_run`) is served after its dense path, its MoE routing pinned
    to sim's (`routes`: by path label, RoutePin.host()); after hymba's,
    its comm policy and recovery at sim's thresholds (`hymba_alg1`,
    rank_family_policy)."""
    from repro_torch.api import LLM
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    from repro_torch.core import model as M

    out = {}

    def prompts_for(arch, lens=PROMPT_LENS):
        rng = np.random.default_rng(0)
        return [rng.integers(0, get_config(arch).vocab_size, n)
                for n in lens]

    def serve(label, llm, prompts, info, **extra):
        res = shard_plain_same(torch, np, llm, prompts,
                               shard_serve(torch, np, llm, prompts))
        out[label] = rank_done(torch, dict(res, **extra), info)

    # the mamba path serves the SmolLM main path's prompts
    for label, arch, lens, kw in (
            ("mamba path", "smollm-360m", PROMPT_LENS, {}),
            ("hymba path", HYMBA_ARCH, HYMBA_PROMPT_LENS,
             dict(cache_len=HYMBA_CACHE_LEN))):
        cfg = model_cfg(SHARD_ARCHS[label])
        prompts = prompts_for(arch, lens)
        llm, info = rank_load(torch, g, label, lambda: LLM.load(
            cfg, engine="shard", **dict(SHARD_KW, **kw)))
        serve(label, llm, prompts, info)
        llm._release_engine()
        release(torch)
        out[f"{label} fp32"] = rank_fp32(torch, np, g, llm, prompts, label,
                                         routes[label],
                                         kw.get("cache_len", 512))
        if label == "hymba path":
            out["hymba alg1"] = rank_family_policy(torch, np, llm,
                                                   hymba_alg1)
        del llm
        release(torch)
    for arch, label in ((MOE_ARCH, "qwen2-moe"), (DEEPSEEK_ARCH, "deepseek")):
        cfg = replace(model_cfg(arch), attn_backend="pallas")
        prompts = prompts_for(arch)
        llm, info = rank_load(torch, g, f"{label} path", lambda: LLM.load(
            cfg, engine="shard", **SHARD_KW))
        serve(f"{label} path", llm, prompts, info)
        llm._release_engine()          # the canonical weights stay
        release(torch)
        out[f"{label} path fp32"] = rank_fp32(torch, np, g, llm, prompts,
                                              f"{label} path",
                                              routes[f"{label} path"])
        release(torch)
        # the fused paged kernels' pool, or one for every request at its
        # peak through the fallback
        pages = (NUM_PAGES if M.supports_paged_attention(cfg)
                 else 4 * 512 // PAGE_SIZE)
        m, info = rank_load(torch, g, f"{label} paged path", lambda: LLM.load(
            cfg, tp=2, plan=llm.plan, cache_len=512, max_batch=4,
            page_size=PAGE_SIZE, num_pages=pages, params=llm.canonical,
            engine="shard"))
        serve(f"{label} paged path", m, prompts, info, pages=pages)
        del m, llm
        release(torch)
    out[FRONT_SHARD_LABEL] = shard_rank_frontend(torch, np, g)
    return out


def shard_rank_frontend(torch, np, g):
    """(d) on a rank: the frontend phase's musicgen cut (front_shard_cfg)
    on the shard engine with SHARD_KW's settings, serving `frontend_run`'s
    frontend prefill and greedy decode."""
    from repro_torch.api import LLM

    m, info = rank_load(torch, g, FRONT_SHARD_LABEL, lambda: LLM.load(
        front_shard_cfg(), engine="shard",
        **dict(SHARD_KW, cache_len=FRONT_CACHE_LEN)))
    res = rank_done(torch, dict(frontend_run(torch, np, m),
                                kept=kept_syncs(m)), info)
    del m
    release(torch)
    return res


def alg1_cut(torch, np, llm, taus=None, shard=False):
    """Algorithm 1's tiered comm policy on `llm`'s model cut to its layers
    TF_FP32_LAYERS at full width in fp32 (`tf_model`, cast on `llm`'s
    device), on sim or on the shard engine's ranks, over sweep_phase's
    calibration batches: n_spd 2 and `taus` (None: halfway between the
    sorted sensitivities of a sweep made here, so that one block drops,
    two keep quant8 and one stays exact).  Returns the perplexities,
    sensitivities, ranking, plan modes, taus and wall seconds."""
    from repro_torch.api import LLM
    from repro_torch.core import spd as SPD
    from repro_torch.data import calibration_batches

    cfg, params, _ = tf_model(llm, "float32", TF_FP32_LAYERS, llm.device)
    m = LLM.load(cfg, tp=2, params=params, cache_len=512, max_batch=4,
                 **({"engine": "shard"} if shard else {}))
    del params
    calib = calibration_batches(cfg.vocab_size, **SWEEP_CALIB)
    if taus is None:
        res, _ = SPD.sweep_sensitivity(cfg, m.canonical, calib, 2,
                                       q_chunk=m.q_chunk)
        s = np.sort(res.sensitivity)
        taus = (float((s[0] + s[1]) / 2), float((s[2] + s[3]) / 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = m.apply_comm_policy(calib, n_spd=2, tau1=taus[0], tau2=taus[1],
                              logits="quant8")
    torch.cuda.synchronize()
    out = dict(ppl=res.ppl_suffix, sens=res.sensitivity,
               ranking=res.ranking.tolist(), modes=m.plan.modes(),
               taus=taus, wall=time.perf_counter() - t0)
    del m
    release(torch)
    return out


def shard_rank_alg1(torch, np, g, llm, prompts, alg1):
    """(b)'s Algorithm 1 on a rank, on the llama2-7b placement: the tiered
    comm policy with sweep_phase's thresholds and the recovery with
    recovery_phase's (`alg1`: sim's), each timed, B1 counted through
    apply_spd, each plan served by `shard_serve` (sim's plan when the
    ranks' parted from it at a near-tie, so that the logits can be held
    to sim's run of it); then the fp32 cut (`alg1_cut`) at sim's taus.
    Every rank checks inside the facade that all reached one plan and
    ranking."""
    from repro_torch.api import LLM
    from repro_torch.config.base import SPDPlanConfig
    from repro_torch.data import calibration_batches
    from repro_torch.kernels import flash_attention as FA

    out = {}
    calib = calibration_batches(llm.cfg.vocab_size, **SWEEP_CALIB)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = llm.apply_comm_policy(calib, n_spd=N_SPD, tau1=alg1["tau1"],
                                tau2=alg1["tau2"], logits="quant8")
    torch.cuda.synchronize()
    rec = dict(ppl=res.ppl_suffix, sens=res.sensitivity,
               ranking=res.ranking.tolist(), modes=llm.plan.modes(),
               wall=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    served = llm
    if rec["modes"] != alg1["modes"]:
        plan = SPDPlanConfig.from_modes(alg1["modes"], logits=alg1["logits"])
        served = LLM.load(llm.cfg, engine="shard", tp=2, plan=plan,
                          params=llm.canonical, cache_len=512, max_batch=4)
    rec["serve"] = shard_serve(torch, np, served, prompts)
    del served
    out["policy"] = rec
    llm._release_engine()
    release(torch)

    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention_bhsd.launches = 0
    t0 = time.perf_counter()
    rep = llm.apply_spd(calib, n_spd=N_SPD, tau1=alg1["r_tau1"],
                        tau2=alg1["r_tau2"], lr=RECOVERY_LR,
                        epochs=RECOVERY_EPOCHS, strategies=("ZS", "B2B", "HG"))
    torch.cuda.synchronize()
    rec = dict(ppl=rep.ppl_suffix, ranking=rep.ranking.tolist(),
               categories=list(rep.categories), chosen=list(rep.chosen),
               modes=llm.plan.modes(), wall=time.perf_counter() - t0,
               seconds=dict(rep.seconds), b1=FA.flash_attention_bhsd.launches,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               fell={b: float(np.mean(v[-len(calib):]))
                     < float(np.mean(v[:len(calib)]))
                     for b, v in rep.distill_losses.items()})
    rec["serve"] = shard_serve(torch, np, llm, prompts)
    out["spd"] = rec
    llm._release_engine()
    release(torch)
    out["cut"] = alg1_cut(torch, np, llm, taus=alg1["cut_taus"], shard=True)
    return out


def separated_tiers(sens, ref_sens, eps, tau1, tau2):
    """Blocks whose sensitivity, here and in `ref_sens`, is further than
    2 eps from both thresholds (a sensitivity is the difference of two
    perplexities, each within eps of the other run's), and whether
    their tiers agree: (blocks, the blocks that disagree)."""
    from repro_torch.core import sensitivity as S
    a = S.classify(sens, tau1, tau2)
    b = S.classify(ref_sens, tau1, tau2)
    far = [i for i, s in enumerate(ref_sens)
           if min(abs(s - tau1), abs(s - tau2)) > 2 * eps]
    return far, [i for i in far if a[i] != b[i]]


def check_shard_alg1(np, ranks, card, transport):
    """(b)'s Algorithm 1 against sim's: every rank the same plan, ranking
    and report; the tiers equal sim's wherever the perplexities' spread
    between the runs cannot move them (separated_tiers); the served
    plans' logits within the dense paths' bound of sim's run of the same
    plan (check_shard_path); the recovery's B1 launches as sim's; the
    fp32 cut's plan equal to sim's, its perplexities and sensitivities
    within ALG1_CUT_RTOL.  Prints the ranks' wall seconds beside sim's."""
    from repro_torch.configs import get_config

    vocab = get_config("llama2-7b").vocab_size
    sweep, recov = SIM_RUNS[ALG1_SWEEP], SIM_RUNS[ALG1_RECOVERY]
    res = [rk["alg1"] for rk in ranks]
    for what in ("policy", "spd", "cut"):
        for r, rr in enumerate(res[1:], 1):
            for k in ("ranking", "modes"):
                if rr[what][k] != res[0][what][k]:
                    raise AssertionError(f"shard Algorithm 1 {what}: rank "
                                         f"{r}'s {k} differs from rank 0's")
    pol, spd, cut = res[0]["policy"], res[0]["spd"], res[0]["cut"]
    eps = float(np.abs(pol["ppl"] - sweep["ppl"]).max())
    rel = eps / float(np.abs(sweep["ppl"]).max())
    far, wrong = separated_tiers(pol["sens"], sweep["sens"], eps,
                                 sweep["tau1"], sweep["tau2"])
    same_plan = pol["modes"] == sweep["plan"].modes()
    print(f"shard apply_comm_policy [{card}] llama2-7b tp 2 over "
          f"{transport}: {pol['wall']:.2f} s (sim {sweep['wall']:.2f} s), "
          f"peak_memory_gib={pol['peak_gib']:.2f} a rank; perplexities "
          f"within {eps:.3f} of sim's ({rel:.3e} relative); tiers equal "
          f"sim's on {len(far) - len(wrong)} of the {len(far)} blocks "
          f"further than 2 x that from tau1 and tau2; plan equal to sim's: "
          f"{same_plan}; ranking agrees at "
          f"{sum(a == b for a, b in zip(pol['ranking'], sweep['ranking']))}"
          f"/{len(sweep['ranking'])} places")
    print("shard apply_comm_policy plan:", " ".join(
        f"{i}:{m}" for i, m in enumerate(pol["modes"])))
    if wrong or rel > SWEEP_PPL_RTOL:
        raise AssertionError(f"shard apply_comm_policy: tiers of blocks "
                             f"{wrong} differ from sim's, or the "
                             f"perplexities by {rel:.3e}")
    check_shard_path(np, ALG1_TIERED + (" (sim's plan)" if not same_plan
                                        else ""),
                     2, [rk["alg1"]["policy"]["serve"] for rk in ranks],
                     SIM_RUNS[ALG1_TIERED], transport, card, vocab)

    same = (spd["modes"] == recov["modes"]
            and spd["categories"] == recov["categories"]
            and spd["chosen"] == recov["chosen"])
    sec = spd["seconds"]
    print(f"shard apply_spd [{card}] llama2-7b tp 2 over {transport}: "
          f"{spd['wall']:.2f} s wall (sweep {sec['sweep']:.2f} s, capture "
          f"{sec['capture']:.3f} s, grouping {sec.get('grouping', 0):.2f} s,"
          f" distillation {sec.get('distill', 0):.2f} s) against sim's "
          f"{recov['wall']:.2f} s; peak_memory_gib={spd['peak_gib']:.2f} a "
          f"rank; tiers " + " ".join(
              f"{b}:{c}" for b, c in zip(spd["chosen"], spd["categories"]))
          + f" (sim's " + " ".join(
              f"{b}:{c}" for b, c in zip(recov["chosen"],
                                         recov["categories"]))
          + f"); B1 launches {spd['b1']} (sim {recov['b1']}); losses fell "
          f"on every distilled block: {all(spd['fell'].values())}")
    if spd["b1"] != recov["b1"] or not all(spd["fell"].values()):
        raise AssertionError("shard apply_spd: B1 launches or the "
                             "distillation losses are not sim's")
    srv = [rk["alg1"]["spd"]["serve"] for rk in ranks]
    if same:
        check_shard_path(np, ALG1_DISTILLED, 2, srv, SIM_RUNS[ALG1_DISTILLED],
                         transport, card, vocab)
    else:
        far, wrong = separated_tiers(spd["ppl"][:-1] - spd["ppl"][1:],
                                     recov["ppl"][:-1] - recov["ppl"][1:],
                                     eps, recov["tau1"], recov["tau2"])
        if wrong or any(r["tokens"] != srv[0]["tokens"] for r in srv):
            raise AssertionError(f"shard apply_spd: the plan parted from "
                                 f"sim's at separated blocks {wrong}")
        print(f"shard apply_spd: the plan parted from sim's at a near-tie "
              f"(no block further than 2 x {eps:.3f} from a threshold "
              f"changed tier): its tokens held to the ranks' agreement "
              f"only")

    simcut = SIM_RUNS[ALG1_CUT]
    prel = float(np.abs(cut["ppl"] / simcut["ppl"] - 1).max())
    srel = float(np.abs(cut["sens"] - simcut["sens"]).max()
                 / np.abs(simcut["sens"]).max())
    print(f"shard fp32 cut [{card}] llama2-7b layers {TF_FP32_LAYERS}: "
          f"plan {cut['modes']} (sim {simcut['modes']}), perplexities "
          f"within {prel:.3e} and sensitivities within {srel:.3e} of the "
          f"largest (tol {ALG1_CUT_RTOL:.0e}); {cut['wall']:.2f} s (sim "
          f"{simcut['wall']:.2f} s)")
    if (cut["modes"] != simcut["modes"] or cut["ranking"]
            != simcut["ranking"] or max(prel, srel) > ALG1_CUT_RTOL):
        raise AssertionError("shard fp32 cut: Algorithm 1 parted from sim's")


def shard_rank_train(torch, np, g, job):
    """(c) on a rank of tp 2 x dp 2: the training phase's model and
    settings (TRAIN_KW) through make_trainer(engine="shard"), the
    weights drawn from seed 0 on the card and kept on the host: ZeRO-1
    for SHARD_TRAIN_STEPS steps (counted, timed); the same with a
    checkpoint every SHARD_FAULT_EVERY and a fault before step
    SHARD_FAULT_AT + 1, resumed (its final state against the first run's,
    bit for bit); FSDP and every kept sync at quant8 for 2 steps each
    (counted); the fp32 cut (train_cut_trainer); qwen2-moe at 16f's
    depth and settings for SHARD_MOE_STEPS steps (counted); then the pod
    layout."""
    import os

    from repro_torch.config.base import replace
    from repro_torch.launch.train import make_trainer
    from repro_torch.runtime.trainer import SimulatedFault
    from repro_torch.tree import tree_leaves

    root = job["root"]
    cfg = replace(train_cfg(), dtype="bfloat16", attn_backend="pallas")
    out = {}

    def trainer(label, **kw):
        return make_trainer(cfg, engine="shard", device="cuda",
                            ckpt_dir=os.path.join(root, label),
                            **dict(TRAIN_KW, steps=SHARD_TRAIN_STEPS, **kw))

    def run(label, tr, st, steps=None):
        torch.cuda.reset_peak_memory_stats()
        st, launches = counted(torch, lambda: tr.run(st, steps=steps))
        out[label] = dict(
            losses=losses_of(tr),
            grad_norms=[m["grad_norm"] for m in tr.metrics_log],
            walls=[m["wall"] for m in tr.metrics_log], launches=launches,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        return st

    tr, st = trainer("zero1", ckpt_every=0)
    st = run("zero1", tr, st)
    first = [t.clone() for t in tree_leaves(st["params"])
             + tree_leaves(st["opt"])]
    del tr, st
    armed = [True]

    def hook(step):
        if step == SHARD_FAULT_AT and armed[0]:
            armed[0] = False
            raise SimulatedFault(f"fault injected at step {step}")

    tr, st = trainer("fault", ckpt_every=SHARD_FAULT_EVERY, ckpt_keep=2,
                     fault_hook=hook)
    st = run("fault", tr, st)
    out["fault"].update(
        same_bits=all(torch.equal(a, b) for a, b in zip(
            first, tree_leaves(st["params"]) + tree_leaves(st["opt"]))),
        saves=tr.save_log, restores=tr.restore_log, step=st["step"])
    del tr, st, first
    release(torch)
    tr, st = trainer("fsdp", fsdp=True, ckpt_every=0)
    run("fsdp", tr, st, SHARD_FSDP_STEPS)
    tr, st = trainer("quant8", comm="quant8", ckpt_every=0)
    kept = plan_kept_syncs(cfg, tr.plan)
    recomputed = sum(not tr.plan.drop_mask[i] and tr.plan.block_mode(i)
                     in ("quant8", "quant4") for i in range(cfg.n_layers))
    run("quant8", tr, st, SHARD_QUANT_STEPS)
    out["quant8"].update(kept=kept, recomputed=recomputed)
    del tr, st
    release(torch)
    tr, st = train_cut_trainer(root, "shard")
    run("cut", tr, st)
    del tr, st
    release(torch)

    # qwen2-moe at 16f's depth and settings: B1, the send and receive
    # kernels under autograd, each rank routing its own data slot's rows
    mcfg = family_cfg(MOE_ARCH, FAMILY_TRAIN_LAYERS[MOE_ARCH],
                      dtype="bfloat16", attn_backend="pallas")
    tr, st = make_trainer(mcfg, engine="shard", device="cuda",
                          ckpt_dir=os.path.join(root, "moe"),
                          steps=SHARD_MOE_STEPS, ckpt_every=0,
                          **FAMILY_TRAIN_KW)
    run("moe", tr, st)
    out["moe"].update(aux=[m["aux"] for m in tr.metrics_log],
                      want=train_launches_want(
                          mcfg, tr.plan, FAMILY_TRAIN_KW["microbatches"],
                          SHARD_MOE_STEPS))
    del tr, st
    release(torch)

    # the same four ranks as pod 2 x dp 1 x tp 2: new groups over the
    # same default group
    from repro_torch.launch.dist import init_tp
    init_tp(2, 1, SHARD_POD["pod"], backend=job["backend"],
            device=job["device"])
    tr, st = trainer("pod zero1", ckpt_every=0, **SHARD_POD)
    run("pod zero1", tr, st, SHARD_POD_STEPS)
    del tr, st
    release(torch)
    tr, st = trainer("pod fsdp", fsdp=True, ckpt_every=0, **SHARD_POD)
    run("pod fsdp", tr, st, 1)
    del tr, st
    release(torch)
    tr, st = train_cut_trainer(root, "shard", **SHARD_POD)
    run("pod cut", tr, st)
    del tr, st
    release(torch)
    return out


def check_shard_train(np, ranks, card, transport):
    """(c) against the training phase: the same losses and grad norms on
    every rank; the step-1 loss within SHARD_TRAIN_LOSS_RTOL of (a)'s;
    the resumed run bit for bit the uninterrupted one; FSDP's losses
    within TRAJ_RTOL of ZeRO-1's, quant8's within QUANT_LOSS_RTOL; B1 on
    every rank 2 x layers x microbatches x steps, and on the quant8
    steps the send and receive kernels once a quantized kept sync (the
    remat recompute re-runs the attention syncs); the fp32 cut within
    SHARD_TRAIN_CUT_RTOL of sim's.  Prints ms a step and tokens/s."""
    nmb, layers = TRAIN_KW["microbatches"], train_cfg().n_layers
    for label in ("zero1", "fault", "fsdp", "quant8", "cut"):
        for r, rk in enumerate(ranks[1:], 1):
            for k in ("losses", "grad_norms"):
                if rk["train"][label][k] != ranks[0]["train"][label][k]:
                    raise AssertionError(f"shard (c) {label}: rank {r}'s "
                                         f"{k} differ from rank 0's")
    t = ranks[0]["train"]
    z, f, q = t["zero1"], t["fault"], t["quant8"]
    la = SIM_RUNS["train (a)"]["losses"]
    rel1 = abs(z["losses"][0] - la[0]) / abs(la[0])
    step_s = float(np.mean(z["walls"][1:]))
    tokens = TRAIN_KW["batch"] * TRAIN_KW["seq"]
    print(f"shard (c) [{card}] {TRAIN_ARCH} L={layers} full width, bf16, tp "
          f"2 x dp 2, four ranks on one card over {transport}: ZeRO-1 losses "
          f"{[round(x, 4) for x in z['losses']]} grad_norms "
          f"{[round(x, 3) for x in z['grad_norms']]} on every rank; step 1 "
          f"{z['losses'][0]:.4f} against train (a)'s {la[0]:.4f}: rel "
          f"{rel1:.3e} (tol {SHARD_TRAIN_LOSS_RTOL:.0e}); step_ms="
          f"{step_s * 1e3:.1f} (mean of steps 2-{SHARD_TRAIN_STEPS}; step 1 "
          f"{z['walls'][0] * 1e3:.1f}) tokens_per_s={tokens / step_s:.1f} "
          f"(sim's train (a) step_ms={SIM_RUNS['train (a)']['step_ms']:.1f});"
          f" peak_memory_gib={z['peak_gib']:.2f} a rank")
    if not rel1 <= SHARD_TRAIN_LOSS_RTOL:
        raise AssertionError("shard (c): the step-1 loss is not (a)'s")
    for label, steps in (("zero1", SHARD_TRAIN_STEPS),
                         ("fsdp", SHARD_FSDP_STEPS),
                         ("quant8", SHARD_QUANT_STEPS)):
        want = 2 * layers * nmb * steps
        for r, rk in enumerate(ranks):
            got = rk["train"][label]["launches"]["flash_attention_bhsd"]
            if got != want:
                raise AssertionError(f"shard (c) {label} rank {r}: B1 "
                                     f"launches {got}, want {want}")
    print(f"shard (c) B1 launches a rank: {z['launches']['flash_attention_bhsd']}"
          f" = 2 x {layers} layers x {nmb} microbatches x "
          f"{SHARD_TRAIN_STEPS} steps")
    for step, sec, nb in f["saves"]:
        print(f"shard (c) [{card}]: save at step {step}: {sec:.2f} s, "
              f"{nb / 1e9:.3f} GB gathered, rank 0 writing")
    for step, sec, nb in f["restores"]:
        print(f"shard (c) [{card}]: restore of step {step}: {sec:.2f} s")
    print(f"shard (c) fault before step {SHARD_FAULT_AT + 1}: losses "
          f"{[round(x, 4) for x in f['losses']]}; final state equal to the "
          f"uninterrupted run's bit for bit on every rank: "
          f"{all(rk['train']['fault']['same_bits'] for rk in ranks)}")
    if not (all(rk["train"]["fault"]["same_bits"] for rk in ranks)
            and f["step"] == SHARD_TRAIN_STEPS and len(f["restores"]) == 1
            and f["losses"][SHARD_FAULT_AT] == f["losses"][SHARD_FAULT_AT - 1]
            == z["losses"][SHARD_FAULT_AT - 1]):
        raise AssertionError("shard (c): the resumed run is not the "
                             "uninterrupted one")
    fl = t["fsdp"]["losses"]
    frel = max(abs(a - b) / abs(b) for a, b in zip(fl, z["losses"]))
    qrel = max(abs(a - b) / abs(b) for a, b in zip(q["losses"], z["losses"]))
    want_q = (q["kept"] + q["recomputed"]) * nmb * SHARD_QUANT_STEPS
    ql = q["launches"]
    print(f"shard (c) FSDP losses {[round(x, 4) for x in fl]}: max rel "
          f"{frel:.3e} from ZeRO-1's (tol {TRAJ_RTOL:.0e}) step_ms="
          f"{1e3 * float(np.mean(t['fsdp']['walls'][1:])):.1f}; quant8 "
          f"losses {[round(x, 4) for x in q['losses']]}: max rel "
          f"{qrel:.3e} (tol {QUANT_LOSS_RTOL:.0e}) step_ms="
          f"{1e3 * float(np.mean(q['walls'][1:])):.1f}; send "
          f"{ql['quantize_message_absmax']} and receive "
          f"{ql['reduce_messages_absmax']} launches a rank (want ("
          f"{q['kept']} kept + {q['recomputed']} recomputed) x {nmb} "
          f"microbatches x {SHARD_QUANT_STEPS} steps = {want_q}), fused "
          f"sim sync {ql['quantized_psum_absmax']}")
    for r, rk in enumerate(ranks):
        ql = rk["train"]["quant8"]["launches"]
        if not (ql["quantize_message_absmax"] == ql["reduce_messages_absmax"]
                == want_q and ql["quantized_psum_absmax"] == 0):
            raise AssertionError(f"shard (c) quant8 rank {r}: launches {ql}")
    if not (frel <= TRAJ_RTOL and qrel <= QUANT_LOSS_RTOL):
        raise AssertionError("shard (c): FSDP or quant8 parted from ZeRO-1")
    sim, cut = SIM_RUNS["train cut"], t["cut"]
    crel = max(abs(a - b) / abs(b) for m, c in zip(sim, zip(
        cut["losses"], cut["grad_norms"])) for a, b in zip(
            c, (m["loss"], m["grad_norm"])))
    print(f"shard (c) fp32 cut ({SHARD_TRAIN_CUT_LAYERS} layers, batch "
          f"{SHARD_TRAIN_CUT['batch']} x seq {SHARD_TRAIN_CUT['seq']}): "
          f"losses {cut['losses']} grad_norms {cut['grad_norms']} against "
          f"sim's {sim}: max rel {crel:.3e} (tol "
          f"{SHARD_TRAIN_CUT_RTOL:.0e})")
    if not crel <= SHARD_TRAIN_CUT_RTOL:
        raise AssertionError("shard (c): the fp32 cut parted from sim's")
    return z["launches"]


def shard_train_phase(np, card, transport):
    """(c): four ranks (tp 2 x dp 2) on card 0 over gloo train the
    training phase's model (shard_rank_train, check_shard_train).
    Returns rank 0's ZeRO-1 launches."""
    import shutil
    import tempfile

    from repro_torch.launch.dist import spawn

    root = tempfile.mkdtemp(prefix="shard_train_")
    t0 = time.perf_counter()
    try:
        ranks = spawn(shard_rank, 4, backend="gloo", device="cuda:0",
                      args=(dict(tp=2, dp=2, backend="gloo",
                                 device="cuda:0", train=True, root=root),),
                      deadline_s=SHARD_TRAIN_DEADLINE_S, timeout_s=300)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = check_shard_train(np, ranks, card, transport)
    check_shard_moe_train(np, ranks, card, transport)
    check_shard_pod(np, ranks, card, transport)
    print(f"shard (c) over {transport}: {time.perf_counter() - t0:.1f} s")
    return launches


def check_shard_moe_train(np, ranks, card, transport):
    """(c)'s qwen2-moe run: the same losses, aux and grad norms on every
    rank; step 1's loss within SHARD_TRAIN_LOSS_RTOL of 16f's sim run;
    on every rank B1 as on sim and the send and receive kernels once a
    quantized kept sync of the forward and of the recompute's attention
    syncs (sim's fused-sync count: train_launches_want), the fused sync
    never.  Prints ms a step beside sim's."""
    for r, rk in enumerate(ranks[1:], 1):
        for k in ("losses", "grad_norms", "aux"):
            if rk["train"]["moe"][k] != ranks[0]["train"]["moe"][k]:
                raise AssertionError(f"shard (c) moe: rank {r}'s {k} differ "
                                     f"from rank 0's")
    m = ranks[0]["train"]["moe"]
    sim = SIM_RUNS[f"family train {MOE_ARCH}"]
    rel = abs(m["losses"][0] - sim["losses"][0]) / abs(sim["losses"][0])
    want = m["want"]
    sync = want["quantized_psum_absmax"]
    for r, rk in enumerate(ranks):
        got = rk["train"]["moe"]["launches"]
        if not (got["flash_attention_bhsd"] == want["flash_attention_bhsd"]
                and got["quantize_message_absmax"]
                == got["reduce_messages_absmax"] == sync
                and got["quantized_psum_absmax"] == got["ssd_scan"] == 0):
            raise AssertionError(f"shard (c) moe rank {r}: launches {got}, "
                                 f"want B1 {want['flash_attention_bhsd']}, "
                                 f"send and receive {sync} each")
    step_s = float(np.mean(m["walls"][1:]))
    print(f"shard (c) {MOE_ARCH} [{card}] L={FAMILY_TRAIN_LAYERS[MOE_ARCH]} "
          f"full width, bf16, quant8, tp 2 x dp 2, four ranks over "
          f"{transport}: losses {[round(x, 5) for x in m['losses']]} aux "
          f"{[round(x, 5) for x in m['aux']]} grad_norms "
          f"{[round(x, 4) for x in m['grad_norms']]} on every rank; step 1 "
          f"against 16f's sim {sim['losses'][0]:.5f}: rel {rel:.3e} (tol "
          f"{SHARD_TRAIN_LOSS_RTOL:.0e}); step_ms={1e3 * step_s:.1f} (step "
          f"2; sim {1e3 * float(np.mean(sim['walls'][1:])):.1f}); B1 "
          f"{m['launches']['flash_attention_bhsd']}, send "
          f"{m['launches']['quantize_message_absmax']} and receive "
          f"{m['launches']['reduce_messages_absmax']} a rank; "
          f"peak_memory_gib={m['peak_gib']:.2f} a rank")
    if not rel <= SHARD_TRAIN_LOSS_RTOL:
        raise AssertionError("shard (c) moe: the step-1 loss is not sim's")


def check_shard_pod(np, ranks, card, transport):
    """(c)'s pod layout (pod 2 x dp 1 x tp 2 on the same four ranks): the
    same losses and grad norms on every rank; ZeRO-1's and FSDP's step-1
    loss within SHARD_TRAIN_LOSS_RTOL of the tp 2 x dp 2 run's (the same
    rows a rank, the same global batch), ZeRO-1's second within it too;
    B1 on every rank 2 x layers x microbatches x steps; the fp32 cut
    within SHARD_TRAIN_CUT_RTOL of sim's step on the same pod mesh.
    Prints ms a step beside the tp 2 x dp 2 step's."""
    nmb, layers = TRAIN_KW["microbatches"], train_cfg().n_layers
    for label in ("pod zero1", "pod fsdp", "pod cut"):
        for r, rk in enumerate(ranks[1:], 1):
            for k in ("losses", "grad_norms"):
                if rk["train"][label][k] != ranks[0]["train"][label][k]:
                    raise AssertionError(f"shard (c) {label}: rank {r}'s "
                                         f"{k} differ from rank 0's")
    t = ranks[0]["train"]
    z, pz, pf = t["zero1"], t["pod zero1"], t["pod fsdp"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        pz["losses"] + pf["losses"], z["losses"][:SHARD_POD_STEPS]
        + z["losses"][:1]))
    for label, steps in (("pod zero1", SHARD_POD_STEPS), ("pod fsdp", 1)):
        want = 2 * layers * nmb * steps
        for r, rk in enumerate(ranks):
            got = rk["train"][label]["launches"]["flash_attention_bhsd"]
            if got != want:
                raise AssertionError(f"shard (c) {label} rank {r}: B1 "
                                     f"launches {got}, want {want}")
    sim, cut = SIM_RUNS["train cut pod"], t["pod cut"]
    crel = max(abs(a - b) / abs(b) for m, c in zip(sim, zip(
        cut["losses"], cut["grad_norms"])) for a, b in zip(
            c, (m["loss"], m["grad_norm"])))
    step_ms = 1e3 * float(np.mean(pz["walls"][1:]))
    print(f"shard (c) pod layout [{card}] {TRAIN_ARCH} L={layers} full "
          f"width, bf16, pod 2 x dp 1 x tp 2 (init_tp(2, 1, pod=2) on the "
          f"same four ranks) over {transport}: ZeRO-1 losses "
          f"{[round(x, 4) for x in pz['losses']]} grad_norms "
          f"{[round(x, 3) for x in pz['grad_norms']]}, FSDP step 1 "
          f"{pf['losses'][0]:.4f}, on every rank; max rel {rel:.3e} from "
          f"the tp 2 x dp 2 run's (tol {SHARD_TRAIN_LOSS_RTOL:.0e}); "
          f"step_ms={step_ms:.1f} (step 2; step 1 {1e3 * pz['walls'][0]:.1f})"
          f" against tp 2 x dp 2's {1e3 * float(np.mean(z['walls'][1:])):.1f}"
          f"; FSDP step_ms={1e3 * pf['walls'][0]:.1f} (its first); B1 "
          f"launches a rank {pz['launches']['flash_attention_bhsd']}; "
          f"peak_memory_gib={pz['peak_gib']:.2f} a rank")
    print(f"shard (c) pod fp32 cut: losses {cut['losses']} grad_norms "
          f"{cut['grad_norms']} against sim's on mesh (pod 2, data 1, model "
          f"2) {sim}: max rel {crel:.3e} (tol {SHARD_TRAIN_CUT_RTOL:.0e})")
    if not (rel <= SHARD_TRAIN_LOSS_RTOL and crel <= SHARD_TRAIN_CUT_RTOL):
        raise AssertionError("shard (c): the pod layout parted from the tp "
                             "2 x dp 2 run or from sim's cut")


def shard_rank(rank, job):
    """One rank of the shard phase (started by launch.dist.spawn): the TP
    groups, then (a) or (b).  Kernels are loaded from build/, which the
    parent built."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.dist import init_tp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = init_tp(job["tp"], job.get("dp", 1), backend=job["backend"],
                device=job["device"])
    if job["backend"] == "nccl":
        return shard_rank_nccl(torch, np, g)
    if job.get("families"):
        return shard_rank_families(torch, np, g, job["card"], job["routes"],
                                   job["hymba_alg1"])
    if job.get("train"):
        return {"train": shard_rank_train(torch, np, g, job)}
    return shard_rank_gloo(torch, np, g, job["card"], job["alg1"])


def check_rank_runs(label, tp, ranks, sim):
    """The same tokens on every rank; each rank's kernels: the kept-sync
    kernels as shard_launches_want says, B1, B2 and B8 as on sim; rank
    0's ledger against sim's entry for entry.  Returns (how many of rank
    0's tokens equal sim's, how many sim's run has)."""
    for r, res in enumerate(ranks):
        if res["tokens"] != ranks[0]["tokens"]:
            raise AssertionError(f"shard {label} rank {r}: tokens "
                                 f"{res['tokens']} != rank 0's "
                                 f"{ranks[0]['tokens']}")
        want = shard_launches_want(tp, res["kept"], res["fwd"],
                                   res["logits_q"])
        want.update({k: sim["launches"].get(k, 0) for k in SHARD_SAME_AS_SIM})
        got = {k: res["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"shard {label} rank {r}: launches {got} "
                                 f"!= {want} (B1, B2 and B8: sim's)")
        print(f"shard {label} rank {r} launches: "
              f"{json.dumps(res['launches'])} ({res['fwd']} forwards x "
              f"{res['kept']} kept quantized syncs)")
    r0 = ranks[0]
    if r0["ledger"] != sim["ledger"]:
        raise AssertionError(f"shard {label}: rank 0's ledger "
                             f"({len(r0['ledger'])} entries) != sim's "
                             f"({len(sim['ledger'])})")
    same = sum(a == b for t, u in zip(r0["tokens"], sim["tokens"])
               for a, b in zip(t, u))
    return same, sum(len(t) for t in sim["tokens"])


def timing_note(r0) -> str:
    return (f"prefill_ms={r0['prefill_ms']:.2f} decode_ms_per_token="
            f"{r0['decode_ms']:.2f} ({r0['steps']} steps) tokens_per_s="
            f"{r0['n_tok'] / r0['wall']:.1f}")


def check_shard_path(np, label, tp, ranks, sim, transport, card, vocab):
    """`check_rank_runs`, then the ranks' logits against sim's
    (`tapes_agree`), and the tokens equal to sim's unless the logits
    parted within the bound.  Returns the parting (see tapes_agree)."""
    same, total = check_rank_runs(label, tp, ranks, sim)
    r0 = ranks[0]
    done, n, worst, parted = tapes_agree(
        np, label, sim["tape"], [rk["tape"] for rk in ranks], vocab)
    if parted is None and r0["tokens"] != sim["tokens"]:
        raise AssertionError(f"shard {label}: no logits event parted, yet "
                             f"the tokens {r0['tokens']} != sim's "
                             f"{sim['tokens']}")
    how = ("no argmax parted: the tokens equal sim's bit for bit"
           if parted is None else
           f"event {parted[0]} parted {parted[1]} row(s) at a sim top-2 "
           f"margin of {parted[2]:.3f} x the bound (<= 2 allowed)")
    print(f"shard {label} [{card}] tp {tp} over {transport}: the same "
          f"tokens on {len(ranks)} ranks; logits within "
          f"{TF_BF16_REL} x max|logit| of sim's on {done} of {n} events "
          f"(largest err {worst:.4f} x the bound); {how}; {same}/{total} "
          f"tokens equal sim's; rank 0's ledger equals sim's "
          f"({len(r0['ledger'])} entries); {timing_note(r0)}"
          + (f"; MoE routing pinned to sim's: {r0['route_flips']} of "
             f"{r0['route_choices']} top-k choices would differ"
             if r0.get("route_choices") else ""))
    return parted


def check_family_path(label, tp, ranks, sim, transport, card):
    """A family's bf16 path: `check_rank_runs`, and on every rank the
    run with the quantized collectives' plain versions equal to the
    kernels' bit for bit, tokens and logits (`shard_plain_same`).  Its
    logits are held to sim's by its fp32 cut (`fp32_run`): in bf16 a
    near-tied MoE routing choice or the SSM state carries a lone shard's
    product rounding past the 5% bound (PERF.md §6 has the readings)."""
    same, total = check_rank_runs(label, tp, ranks, sim)
    for r, res in enumerate(ranks):
        if not res["plain_same"] or res["plain_leaked"]:
            raise AssertionError(f"shard {label} rank {r}: the run with the "
                                 f"collectives' plain versions differs from "
                                 f"the kernels' (or launched "
                                 f"{res['plain_leaked']} kernels)")
    r0 = ranks[0]
    print(f"shard {label} [{card}] tp {tp} over {transport}: the same "
          f"tokens on {len(ranks)} ranks; on every rank the send, receive "
          f"and B3 kernels' run equals their plain versions' bit for bit "
          f"({r0['events']} logits events, {r0['n_tok']} tokens); "
          f"{same}/{total} tokens equal sim's bf16 run's; rank 0's ledger "
          f"equals sim's ({len(r0['ledger'])} entries); {timing_note(r0)}")


# the kept sync's payloads on the shard path, one rank's row: the
# SmolLM-360M and LLaMA2-7B syncs of a batch-4 decode step and of one
# 512-token prefill; the families' batch-4 decode syncs (mamba2 d 1024,
# hymba d 1600, qwen2-moe d 2048, as deepseek's) and hymba's 17-token
# prefill sync, 212.5 chunks (a ragged last chunk of 64); two ranks'
# messages are made on the one card
SHARD_HOP_SHAPES = (("smollm-360m", 4 * 960), ("smollm-360m", 512 * 960),
                    ("llama2-7b", 4 * 4096), ("llama2-7b", 512 * 4096),
                    ("mamba2-370m", 4 * 1024), (HYMBA_ARCH, 4 * 1600),
                    (HYMBA_ARCH, 17 * 1600), (MOE_ARCH, 4 * 2048))
SHARD_HOP_PATHS = {"smollm-360m": "main path", "llama2-7b": "llama2-7b path",
                   "mamba2-370m": "mamba path", HYMBA_ARCH: "hymba path",
                   MOE_ARCH: "qwen2-moe path"}
SHARD_HOP_TP = 2
SYNC_KERNELS = ("quant_message_kernel", "reduce_messages_kernel")


def old_shard_sync(torch, QC, x, other):
    """One rank's quantized kept sync as the chain the two kernels
    replaced ran it (context): the cast, B4, the message's cat, the
    gather's stack (`other`, the other rank's message, stands in for the
    wire), two copies, zeros, B6 once a rank, B3, the cast back."""
    n = x.shape[1]
    q, s = QC.quantize_absmax(x.float().contiguous(), levels=127)
    got = torch.stack([torch.cat([q.reshape(-1),
                                  s.reshape(-1).view(torch.int8)]), other])
    qa, sa = got[:, :n].contiguous(), got[:, n:].contiguous().view(
        torch.float32)
    acc = torch.zeros_like(x, dtype=torch.float32)
    for r in range(got.shape[0]):
        acc = QC.dequant_accum_absmax(qa[r:r + 1], sa[r:r + 1], acc)
    return QC.qdq_absmax(acc, levels=127).to(x.dtype)


def shard_hop_rows(torch, launches, card) -> list:
    """The send and receive kernels at SHARD_HOP_SHAPES, bf16 L=127, tp 2:
    bit for bit against their plain versions and against the chain they
    replaced, timed (events and profile) beside both and at their
    bounds; the old B4 and B6 wrappers and `torch.addcmul` at the SmolLM
    shapes (the host-path repair, and B6's yardstick on the device).
    `launches`:
    rank 0's on each shard path, a row's from its model's dense path."""
    from repro_torch.kernels import quant_collectives as QC

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    out = []
    for arch, n in SHARD_HOP_SHAPES:
        x = torch.randn(SHARD_HOP_TP, n, generator=gen, device=dev)
        x *= torch.logspace(0, 1, SHARD_HOP_TP, device=dev)[:, None]
        x[0, :QC.CHUNK] = 0.0          # an all-zero chunk: the 1e-12 floor
        x = x.to(torch.bfloat16)
        mine = x[:1]
        msgs = QC.quantize_message_absmax(x, levels=127)   # both ranks'
        y = QC.reduce_messages_absmax(msgs, n, levels=127,
                                      dtype=torch.bfloat16)
        q1, s1 = QC.quantize_absmax(x[1:].float(), levels=127)
        other = torch.cat([q1.reshape(-1), s1.reshape(-1).view(torch.int8)])
        old = old_shard_sync(torch, QC, mine, other)
        torch.cuda.synchronize()
        if not (torch.equal(msgs, QC.quantize_message_absmax_plain(
                    x, levels=127))
                and torch.equal(msgs[:1], QC.quantize_message_absmax(
                    mine, levels=127))
                and same_bits(torch, y, QC.reduce_messages_absmax_plain(
                    msgs, n, levels=127, dtype=torch.bfloat16))
                and same_bits(torch, y, old)):
            raise AssertionError(f"send / receive not bit-identical to their "
                                 f"plain versions and the old chain at "
                                 f"(1,{n}) tp {SHARD_HOP_TP}")
        prof = device_us(torch, lambda: (
            QC.quantize_message_absmax(mine, levels=127),
            QC.reduce_messages_absmax(msgs, n, levels=127,
                                      dtype=torch.bfloat16)),
            SYNC_KERNELS, need=SYNC_KERNELS)
        chain = lambda: old_shard_sync(torch, QC, mine, other)  # noqa: E731
        chain_ms = cuda_ms(torch, chain, iters=100)
        # the profiler at times loses some of a window's kernels: keep the
        # window that saw the most, up to the chain's 9 + tp launches
        chain_rows, chain_n = [], 0
        for _ in range(5):
            rows = device_rows(torch, chain, iters=20)
            seen = sum(k for _, _, k in rows) / 20
            if seen > chain_n:
                chain_rows, chain_n = rows, seen
            if chain_n >= 9 + SHARD_HOP_TP:
                break
        chain_us = sum(us for _, us, _ in chain_rows) / 20
        m = msgs.shape[1]
        counts = launches[SHARD_HOP_PATHS[arch]]
        cases = (
            ("quantize_message_absmax", ":93", "quant_message_kernel",
             lambda: QC.quantize_message_absmax(mine, levels=127),
             lambda: QC.quantize_message_absmax_plain(mine, levels=127),
             2 * n + m, 6.0 * n),
            ("reduce_messages_absmax", ":137", "reduce_messages_kernel",
             lambda: QC.reduce_messages_absmax(msgs, n, levels=127,
                                               dtype=torch.bfloat16),
             lambda: QC.reduce_messages_absmax_plain(
                 msgs, n, levels=127, dtype=torch.bfloat16),
             SHARD_HOP_TP * m + 2 * n, (2.0 * SHARD_HOP_TP + 7) * n))
        for name, line, kname, fn, plain, nbytes, flops in cases:
            ms = cuda_ms(torch, fn, iters=200)
            plain_ms = cuda_ms(torch, plain, iters=50)
            b_ms, b_by = bound_ms(nbytes, flops, "float32")
            share = (b_ms * 1e3 / prof[kname]) if prof[kname] else None
            # yardstick: one copy_ moving the same bytes (half read, half
            # written), how near a lone launch of this size gets its bound
            src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
            dst = torch.empty_like(src)
            copy_us, _ = device_total_us(torch, lambda: dst.copy_(src))
            print(f"{name} [{card}] {arch}'s (1,{n}) bf16 L=127 tp "
                  f"{SHARD_HOP_TP}: ms={ms:.5f} plain_ms={plain_ms:.5f} "
                  f"device_us={prof[kname]} bound_ms={b_ms:.7f} ({b_by}, "
                  f"{nbytes} bytes; {share} of it on the device; a copy_ "
                  f"of the same bytes {copy_us:.3f} us on the device) "
                  f"launches={counts[name]}")
            out.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/csrc/quant_collectives.cu",
                        "replaces": "src/repro/kernels/quant_collectives.py"
                                    + line,
                        "launches": counts[name], "max_abs_err": 0.0,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None,
                        "device_us": prof[kname], "context_ms": chain_ms,
                        "context_device_us": chain_us,
                        "shape": f"(1,{n}) bf16 L=127 tp {SHARD_HOP_TP}, "
                                 f"one rank's {arch} kept sync on the shard "
                                 "path (launches: its rank 0's); context: "
                                 "the replaced chain of one sync"})
        print(f"the shard sync [{card}] at {arch}'s (1,{n}) bf16 tp "
              f"{SHARD_HOP_TP}, device time a rank's sync (the wire apart): "
              f"send + receive "
              f"{prof['quant_message_kernel'] + prof['reduce_messages_kernel']:.3f}"
              f" us in 2 launches; the replaced chain {chain_us:.3f} us over "
              f"{chain_n:g} launches ("
              + ", ".join(k.split("(")[0][:40] for k, _, _ in chain_rows)
              + f"), ms={chain_ms:.5f}")
        if arch != "smollm-360m":
            continue
        xf = mine.float()
        q, s = QC.quantize_absmax(xf, levels=127)
        acc = torch.randn(1, n, generator=gen, device=dev)
        qc, sc, ac = q.view(1, -1, QC.CHUNK), s[..., None], acc.view(
            1, -1, QC.CHUNK)
        lib = lambda: torch.addcmul(ac, qc, sc)  # noqa: E731
        old_us = device_us(torch, lambda: (
            QC.quantize_absmax(xf, levels=127),
            QC.dequant_accum_absmax(q, s, acc), lib()),
            QUANT_KERNELS[::2], need=QUANT_KERNELS[::2])
        lib_us, _ = device_total_us(torch, lib)
        print(f"the old hop kernels [{card}] at (1,{n}) fp32: "
              f"quantize_absmax ms="
              f"{cuda_ms(torch, lambda: QC.quantize_absmax(xf, levels=127), iters=100):.5f}"
              f" device_us={old_us['quant_kernel']}; dequant_accum_absmax ms="
              f"{cuda_ms(torch, lambda: QC.dequant_accum_absmax(q, s, acc), iters=100):.5f}"
              f" device_us={old_us['dequant_accum_kernel']}; torch.addcmul "
              f"ms={cuda_ms(torch, lib, iters=100):.5f} device_us={lib_us:.3f}")
    return out


def shard_phase(torch, np, card):
    """The shard engine on the card: (a) NCCL at the card count, (b) two
    ranks on one card over gloo.  Returns each path's rank-0 launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dist import spawn

    n = torch.cuda.device_count()
    world = min(n, 4)
    t0 = time.perf_counter()
    rss, peak = host_gib()
    print(f"shard phase: this process's host rss {rss:.2f} GiB (peak "
          f"{peak:.2f}) before the ranks start")
    if world == 1:
        print("shard (a): one card, so a world of 1 on purpose (tp 1 over "
              "nccl; no wire): llama2-7b through engine='shard' against "
              "sim at tp 1")
    else:
        print(f"shard (a): {n} cards, tp {world} over nccl, one rank a "
              "card: llama2-7b against sim at that tp, and the wire")
    ranks = spawn(shard_rank, world, backend="nccl", device="cuda",
                  args=(dict(tp=world, backend="nccl", device="cuda"),),
                  deadline_s=SHARD_DEADLINE_S, timeout_s=300)
    for r, res in enumerate(ranks):
        if res["tokens"] != res["sim_tokens"] or (
                res["tokens"] != ranks[0]["tokens"]):
            raise AssertionError(f"shard (a) rank {r}: tokens "
                                 f"{res['tokens']} != sim's "
                                 f"{res['sim_tokens']}")
        want = shard_launches_want(world, res["kept"], res["fwd"], True)
        got = {k: res["launches"][k] for k in want}
        if got != want or not res["launches"]["flash_attention_bhsd"]:
            raise AssertionError(f"shard (a) rank {r}: launches "
                                 f"{res['launches']}, want {want}")
    r0 = ranks[0]
    print(f"shard (a) [{card}] llama2-7b tp {world} over nccl: tokens equal "
          f"sim's; launches {json.dumps(r0['launches'])}; prefill_ms="
          f"{r0['prefill_ms']:.2f} decode_ms_per_token={r0['decode_ms']:.2f}"
          f" peak_memory_gib={r0['peak_gib']:.2f} (sim's canonical weights "
          f"beside the shard placement); {time.perf_counter() - t0:.1f} s")
    if "wire" in r0:
        print(f"shard (a) wire [{card}]: one kept sync's bf16 all-reduce "
              f"over nccl at tp {world}, CUDA events on rank 0: "
              f"{json.dumps(r0['wire'])}")

    t0 = time.perf_counter()
    sweep, recov = SIM_RUNS[ALG1_SWEEP], SIM_RUNS[ALG1_RECOVERY]
    # plain values: a rank unpickles them before it can import the port
    alg1 = dict(tau1=sweep["tau1"], tau2=sweep["tau2"],
                modes=sweep["plan"].modes(),
                logits=sweep["plan"].logits_mode,
                r_tau1=recov["tau1"], r_tau2=recov["tau2"],
                cut_taus=SIM_RUNS[ALG1_CUT]["taus"])
    job = dict(tp=2, backend="gloo", device="cuda:0", card=card)
    ranks = spawn(shard_rank, 2, backend="gloo", device="cuda:0",
                  args=(dict(job, alg1=alg1),), deadline_s=SHARD_DEADLINE_S,
                  timeout_s=300)
    b_s = time.perf_counter() - t0
    transport = ("gloo on one card (CUDA tensors staged through the host: "
                 "these times measure a host-staged wire, not NVLink)")
    out = {"shard (a)": r0["launches"]}
    parted = {}
    for label in SHARD_LABELS + (SHARD_INT8_LABEL,):
        res = [rk[label] for rk in ranks]
        parted[label] = check_shard_path(
            np, label, 2, res, SIM_RUNS[label], transport, card,
            get_config(SHARD_ARCHS[label]).vocab_size)
        out[label] = res[0]["launches"]
    # sim's prefix tokens where the path's logits parted nowhere
    check_paged_prefix(ranks, "paged path",
                       None if parted["paged path"] else
                       SIM_RUNS["paged path"]["prefix_tokens"])
    p, ll = ranks[0]["paged path"], ranks[0]["llama2-7b path"]
    print(f"shard paged path: preemptions={p['preemptions']} pages back "
          f"{p['pages_back']}/{NUM_PAGES}, warm prefix pair: prefix_hits="
          f"{p['prefix_hits']} suffix_prefills={p['suffix_prefills']} chunk "
          f"launches {p['chunk_launches']}, prefix tokens equal sim's: "
          f"{p['prefix_tokens'] == SIM_RUNS['paged path']['prefix_tokens']}")
    for r, rk in enumerate(ranks):
        q = rk["llama2-7b path"]
        print(f"shard llama2-7b rank {r}: loaded in {q['load_s']:.1f} s, "
              f"peak_memory_gib={q['peak_gib']:.2f} (load included; the "
              f"canonical weights kept on the host), "
              f"{q['held_gib']:.2f} GiB held after")
    out[SHARD_OVERLAP_LABEL] = check_shard_overlap(ranks, card, transport)
    out["rings across ranks"] = check_shard_rings(ranks, card)
    out[SHARD_SPEC_LABEL] = check_shard_spec(np, ranks, card)
    check_shard_alg1(np, ranks, card, transport)
    print_rank_memory(ranks, (SHARD_INT8_LABEL,))
    print(f"shard (b) over {transport}: {b_s:.1f} s; llama2-7b "
          f"decode_ms_per_token={ll['decode_ms']:.2f}; the speculative path "
          f"{ranks[0][SHARD_SPEC_LABEL]['seconds']:.1f} s, the int8 path "
          f"{ranks[0][SHARD_INT8_LABEL]['seconds']:.1f} s (rank 0's)")

    out.update(shard_family_phase(np, card, job, transport))
    out["shard (c)"] = shard_train_phase(np, card, transport)
    return out


def check_shard_overlap(ranks, card, transport):
    """(b)'s overlap pass: the shard backend plus the seams on every
    rank; its tokens and logits events equal the shard main path's on the
    same rank bit for bit, and the same on both ranks; the send and
    receive kernels launched as on that path (and as shard_launches_want
    says), B1 as there; rank 0's ledger equal to the sim overlap path's,
    ring-step collective-permutes included; decode_pipelined equal to
    serial decode.  Prints ms a token beside the shard path's and sim
    overlap's.  Returns rank 0's launches."""
    for r, rk in enumerate(ranks):
        ov, mp = rk[SHARD_OVERLAP_LABEL], rk["main path"]
        want = shard_launches_want(2, ov["kept"], ov["fwd"], ov["logits_q"])
        got = {k: ov["launches"][k] for k in want}
        if not (ov["backend"] == "ShardOverlapBackend"
                and ov["overlaps_comm"]):
            raise AssertionError(f"shard overlap rank {r}: backend "
                                 f"{ov['backend']}")
        if ov["tokens"] != mp["tokens"] or not ov["same_logits"]:
            raise AssertionError(f"shard overlap rank {r}: tokens or logits "
                                 f"differ from the shard main path's")
        if got != want or ov["launches"] != mp["launches"]:
            raise AssertionError(f"shard overlap rank {r}: launches "
                                 f"{ov['launches']} != the shard path's "
                                 f"{mp['launches']} / {want}")
        if not ov["pipelined"]["same"]:
            raise AssertionError(f"shard overlap rank {r}: decode_pipelined "
                                 f"differs from serial decode")
    r0 = ranks[0][SHARD_OVERLAP_LABEL]
    if r0["tokens"] != ranks[1][SHARD_OVERLAP_LABEL]["tokens"]:
        raise AssertionError("shard overlap: the ranks' tokens differ")
    sim = SIM_RUNS["overlap path"]
    perms = sum(e[0] == "collective-permute" for e in r0["ledger"])
    if r0["ledger"] != sim["ledger"] or not perms:
        raise AssertionError(f"shard overlap: rank 0's ledger "
                             f"({len(r0['ledger'])} entries, {perms} ring "
                             f"steps) != the sim overlap path's "
                             f"({len(sim['ledger'])})")
    pl = r0["pipelined"]
    ql = r0["launches"]
    print(f"shard {SHARD_OVERLAP_LABEL} [{card}] tp 2 over {transport}: "
          f"ShardOverlapBackend on both ranks; tokens and {r0['events']} "
          f"logits events equal the shard main path's bit for bit; send "
          f"{ql['quantize_message_absmax']} and receive "
          f"{ql['reduce_messages_absmax']} launches a rank, as there; rank "
          f"0's ledger equals sim overlap's ({len(r0['ledger'])} entries, "
          f"{perms} ring-step collective-permutes); {timing_note(r0)}; "
          f"shard main path decode_ms_per_token="
          f"{ranks[0]['main path']['decode_ms']:.2f}, sim overlap "
          f"{sim['decode_ms']:.2f}")
    print(f"shard decode_pipelined [{card}] over {transport}: "
          f"{PIPE_GROUPS} groups of 4, depth 2: equal to serial on both "
          f"ranks; rank 0 host ms serial={pl['serial_ms'][0]:.2f}/"
          f"{pl['serial_ms'][1]:.2f} pipelined={pl['piped_ms'][0]:.2f}/"
          f"{pl['piped_ms'][1]:.2f} (in turns S P P S)")
    return r0["launches"]


def check_shard_rings(ranks, card):
    """(b)'s rings across the two ranks: on each rank the kernel path's
    row equals the plain path's and the sim ring's row bit for bit, within
    the ring's error bound of the exact sum, with n-1 B4, n-1 B6 and one
    B3 a call and none on the plain path; the reduce-scatter and the
    all-gather rows equal sim's.  Prints ms a call beside sim's ring.
    Returns rank 0's launches summed over the calls."""
    want = {"quantize_absmax": 1, "dequant_accum_absmax": 1,
            "qdq_absmax": 1}
    total = {k: 0 for k in want}
    for r, rk in enumerate(ranks):
        for row in rk["rings"]:
            what = f"rings across ranks rank {r} {row['label']}"
            if row["bits"] is None:
                if not row["same_sim"]:
                    raise AssertionError(f"{what}: ring_reduce_scatter or "
                                         "ring_all_gather differs from sim's")
                continue
            if not (row["same_plain"] and row["same_sim"]
                    and row["launches"] == want and not row["leaked"]
                    and row["err"] <= row["bound"]):
                raise AssertionError(f"{what} bits={row['bits']}: {row}")
            if r == 0:
                for k, v in row["launches"].items():
                    total[k] += v
    for row in ranks[0]["rings"]:
        if row["bits"] is None:
            print(f"rings across ranks [{card}] tp 2 {row['label']} "
                  f"{tuple(row['shape'])} a rank: ring_reduce_scatter="
                  f"{row['rs_ms']:.4f} ms ring_all_gather={row['ag_ms']:.4f}"
                  f" ms a call (gloo, host-staged); both equal sim's rows")
            continue
        print(f"rings across ranks [{card}] tp 2 {row['label']} "
              f"{tuple(row['shape'])} a rank bits={row['bits']}: kernel=="
              f"plain True, == sim ring's row True on both ranks; err="
              f"{row['err']:.4e} bound={row['bound']:.4e}; launches "
              f"{json.dumps(row['launches'])} a call; "
              f"ring_quantized_psum={row['ms']:.4f} ms a call (gloo, "
              f"host-staged) against the sim ring's {row['sim_ms']:.4f} ms "
              "(both ranks' rows on one card)")
    print(f"rings across ranks launches (rank 0): {json.dumps(total)}")
    return total


def shard_family_phase(np, card, job, transport):
    """(b)'s second spawn: the families, one model at a time, each bf16
    path checked by `check_family_path`, each fp32 cut held to sim's by
    `check_shard_path` (every path checked before any failure raises).
    Returns each path's rank-0 launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dist import spawn

    t0 = time.perf_counter()
    routes = {lb: SIM_RUNS[f"{lb} fp32"]["routes"] for lb in SHARD_FP32_LAYERS}
    pol, spd = (SIM_RUNS["hymba alg1"][k] for k in ("policy", "spd"))
    hymba_alg1 = dict({k: pol[k] for k in ("n_spd", "tau1", "tau2")},
                      spd={k: spd[k] for k in ("tau1", "tau2")})
    ranks = spawn(shard_rank, 2, backend="gloo", device="cuda:0",
                  args=(dict(job, families=True, routes=routes,
                             hymba_alg1=hymba_alg1),),
                  deadline_s=SHARD_FAMILY_DEADLINE_S, timeout_s=300)
    print_rank_memory(ranks, SHARD_FAMILY_LABELS)
    out, parted, failed = {}, {}, []
    for label in SHARD_FAMILY_LABELS + tuple(f"{lb} fp32"
                                             for lb in SHARD_FP32_LAYERS):
        res = [rk[label] for rk in ranks]
        out[label] = res[0]["launches"]
        try:
            if label.endswith(" fp32"):
                parted[label] = check_shard_path(
                    np, label, 2, res, SIM_RUNS[label], transport, card,
                    get_config(SHARD_ARCHS[label.removesuffix(" fp32")]
                               ).vocab_size)
            else:
                check_family_path(label, 2, res, SIM_RUNS[label], transport,
                                  card)
        except AssertionError as e:
            print(f"FAILED: {e}")
            failed.append(label)
    try:
        out[FRONT_SHARD_LABEL] = check_shard_frontend(
            np, [rk[FRONT_SHARD_LABEL] for rk in ranks],
            SIM_RUNS[FRONT_SHARD_LABEL], transport, card)
    except AssertionError as e:
        print(f"FAILED: {e}")
        failed.append(FRONT_SHARD_LABEL)
    if failed:
        raise AssertionError(f"shard (b): the paths {failed} failed")
    check_paged_prefix(ranks, "qwen2-moe paged path")
    check_shard_family_policy(np, ranks, card, transport)
    for r, rk in enumerate(ranks):
        p = rk["deepseek paged path"]
        if p["pages_back"] != p["pages"] or p["preemptions"]:
            raise AssertionError(f"shard deepseek paged path rank {r}: "
                                 f"{p['pages_back']}/{p['pages']} pages "
                                 f"back, {p['preemptions']} preemptions")
    print(f"shard (b) families over {transport}: "
          f"{time.perf_counter() - t0:.1f} s; rank 0's seconds a path "
          "(load + serve): " + ", ".join(
              f"{lb} {ranks[0][lb]['seconds']:.1f}"
              for lb in SHARD_FAMILY_LABELS))
    return out


def check_shard_frontend(np, ranks, sim, transport, card):
    """(d): the frontend prefill and its greedy decode on the ranks: the
    same tokens on every rank, each rank's kept-sync kernels as
    shard_launches_want says and B1 as sim's (once a layer), and the
    logits (the prefill's and every decode step's, all-gathered) within
    TF_BF16_REL of sim's largest until an argmax parts, a parting only
    where sim's top-2 margin allows it (`tapes_agree`).  Returns rank 0's
    launches."""
    from repro_torch.configs import get_config

    label = FRONT_SHARD_LABEL
    for r, res in enumerate(ranks):
        if res["tokens"] != ranks[0]["tokens"]:
            raise AssertionError(f"shard {label} rank {r}: tokens "
                                 f"{res['tokens']} != rank 0's")
        want = shard_launches_want(2, res["kept"], res["fwd"], True)
        want["flash_attention_bhsd"] = sim["launches"]["flash_attention_bhsd"]
        got = {k: res["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"shard {label} rank {r}: launches {got} "
                                 f"!= {want}")
    done, n, worst, parted = tapes_agree(
        np, label, sim["tape"], [rk["tape"] for rk in ranks],
        get_config(FRONT_SHARD_ARCH).vocab_size)
    r0 = ranks[0]
    if parted is None and r0["tokens"] != sim["tokens"]:
        raise AssertionError(f"shard {label}: no logits event parted, yet "
                             f"the tokens differ from sim's")
    print(f"shard {label} [{card}] tp 2 over {transport}: the same tokens "
          f"on {len(ranks)} ranks; logits within {TF_BF16_REL} x "
          f"max|logit| of sim's on {done} of {n} events (largest err "
          f"{worst:.4f} x the bound); "
          + ("no argmax parted: the tokens equal sim's" if parted is None
             else f"event {parted[0]} parted {parted[1]} row(s)")
          + f"; launches {json.dumps(r0['launches'])}; prefill_ms="
          f"{r0['prefill_ms']:.2f} decode_ms_per_token="
          f"{r0['decode_ms']:.2f}")
    return r0["launches"]


def check_shard_family_policy(np, ranks, card, transport):
    """(b)'s hymba apply_comm_policy against sim's (family_alg1), then its
    apply_spd (every rank the same plan, its distillation through B8's
    autograd Function once a step of each distilled hybrid block,
    finite losses; printed beside sim's).  The comm policy: every
    rank the same plan and ranking; the perplexities within
    SWEEP_PPL_RTOL of sim's, the tiers equal to sim's wherever the
    perplexities' spread between the runs cannot move them
    (separated_tiers), the plan sim's or parted only at such a near-tie;
    B8 once a hybrid layer a forward of the sweep.  Prints the wall
    seconds beside sim's."""
    res = [rk["hymba alg1"] for rk in ranks]
    for r, rr in enumerate(res[1:], 1):
        for k in ("ranking", "modes"):
            if rr[k] != res[0][k]:
                raise AssertionError(f"shard hymba apply_comm_policy: rank "
                                     f"{r}'s {k} differs from rank 0's")
    pol, sim = res[0], SIM_RUNS["hymba alg1"]["policy"]
    eps = float(np.abs(pol["ppl"] - sim["ppl"]).max())
    rel = eps / float(np.abs(sim["ppl"]).max())
    far, wrong = separated_tiers(pol["sens"], sim["sens"], eps, sim["tau1"],
                                 sim["tau2"])
    n = len(pol["modes"])
    b8 = (n + 1) * SWEEP_CALIB["n_samples"] // SWEEP_CALIB["batch"] * n
    print(f"shard hymba apply_comm_policy [{card}] L={n} tp 2 over "
          f"{transport}: {pol['wall']:.2f} s (sim {sim['wall']:.2f} s); "
          f"perplexities within {eps:.4f} of sim's ({rel:.3e} relative, tol "
          f"{SWEEP_PPL_RTOL:.0e}); tiers equal sim's on "
          f"{len(far) - len(wrong)} of the {len(far)} blocks further than "
          f"2 x that from tau1 and "
          f"tau2; plan equal to sim's: {pol['modes'] == sim['modes']}; B8 "
          f"launches a rank {[r['b8'] for r in res]} (want {b8})")
    if wrong or rel > SWEEP_PPL_RTOL or any(r["b8"] != b8 for r in res):
        raise AssertionError(f"shard hymba apply_comm_policy: tiers of "
                             f"blocks {wrong} differ from sim's, the "
                             f"perplexities by {rel:.3e}, or B8 launches")
    spd, sim_spd = [r["spd"] for r in res], SIM_RUNS["hymba alg1"]["spd"]
    for r, rr in enumerate(spd[1:], 1):
        for k in ("modes", "chosen", "categories"):
            if rr[k] != spd[0][k]:
                raise AssertionError(f"shard hymba apply_spd: rank {r}'s "
                                     f"{k} differs from rank 0's")
    s0 = spd[0]
    print(f"shard hymba apply_spd [{card}] L={n} tp 2 over {transport}: "
          f"{s0['wall']:.2f} s (sim {sim_spd['wall']:.2f} s); tiers "
          + " ".join(f"{b}:{t}" for b, t in zip(s0["chosen"],
                                                 s0["categories"]))
          + f"; plan equal to sim's: {s0['modes'] == sim_spd['modes']}; "
          f"distilled blocks (steps) "
          f"{ {b: len(v) for b, v in s0['losses'].items()} }, losses "
          + ", ".join(f"{b}: {v[0]:.4e} -> {v[-1]:.4e}"
                      for b, v in s0["losses"].items())
          + f"; B8 under autograd (the student's forward) a rank "
          f"{[r['b8_autograd'] for r in spd]} (want {s0['b8_want']}; sim "
          f"{sim_spd['b8_autograd']})")
    if not all(r["finite"] and r["b8_want"] > 0
               and r["b8_autograd"] == r["b8_want"] for r in spd):
        raise AssertionError("shard hymba apply_spd: B8 did not run under "
                             "autograd once a distillation step of each "
                             "hybrid block, or a loss is not finite")


def check_paged_prefix(ranks, label, want=None):
    """A (b) path on the fused paged kernels: at least one preemption,
    every page back, the warm prefix pair admitted warm (a prefix hit,
    B2's chunk kernel) with the same tokens on every rank (and `want`,
    sim's, where given)."""
    for r, rk in enumerate(ranks):
        p = rk[label]
        if (p["preemptions"] < 1 or p["pages_back"] != NUM_PAGES
                or p["prefix_hits"] < 1
                or p["prefix_tokens"] != ranks[0][label]["prefix_tokens"]
                or (want is not None and p["prefix_tokens"] != want)
                or not p["launches"]["paged_flash_attention"]
                or not p["chunk_launches"]):
            raise AssertionError(f"shard {label} rank {r}: {p}")


def print_rank_memory(ranks, labels):
    """Each rank's load time, decode ms a token, card peak and host
    memory on each path of `labels`."""
    for label in labels:
        for r, rk in enumerate(ranks):
            q = rk[label]
            print(f"shard {label} rank {r}: loaded in {q['load_s']:.1f} s, "
                  f"decode_ms_per_token={q['decode_ms']:.2f}, "
                  f"peak_memory_gib={q['peak_gib']:.2f} (load included; "
                  f"the canonical weights kept on the host), host rss "
                  f"{q['rss_gib']:.2f} GiB (peak {q['maxrss_gib']:.2f}); "
                  f"{q['seconds']:.1f} s")


def check_shard_spec(np, ranks, card):
    """(b)'s speculative path against sim's spec (a) run (SIM_RUNS): the
    same tokens on every rank; every full logits tensor (chunk, draft
    step, verify) within the bound of sim's up to the first argmax that
    parts (`tapes_agree`), and then the tokens and the whole ledger
    equal sim's unless one parted; the ledger of the first draft call
    and of the first verify equal sim's either way.  Prints acceptance,
    rounds, spec against plain decode ms a token (the rank's own plain
    llama2-7b run) beside sim's ratio, the ledger entries of a draft and
    of a target forward, and the hand launches.  Returns rank 0's
    launches."""
    label, sim = SHARD_SPEC_LABEL, SIM_RUNS[SHARD_SPEC_LABEL]
    res = [rk[label] for rk in ranks]
    for r, q in enumerate(res):
        if q["tokens"] != res[0]["tokens"]:
            raise AssertionError(f"shard {label} rank {r}: tokens differ "
                                 "from rank 0's")
        for key in ("draft", "verify"):
            if q[key] != sim[key]:
                raise AssertionError(f"shard {label} rank {r}: the first "
                                     f"{key} call's ledger {q[key]} != "
                                     f"sim's {sim[key]}")
    from repro_torch.configs import get_config
    vocab = get_config(SHARD_ARCHS[label]).vocab_size
    done, n, worst, parted = tapes_agree(np, label, sim["tape"],
                                         [q["tape"] for q in res], vocab)
    r0 = res[0]
    if parted is None and (r0["tokens"] != sim["tokens"]
                           or r0["ledger"] != sim["ledger"]):
        raise AssertionError(f"shard {label}: no logits event parted, yet "
                             "the tokens or the ledger differ from sim's")
    k = SPEC_K
    draft1 = r0["draft"][-len(r0["draft"]) // k:]
    ratio = r0["decode_ms"] / r0["plain_ms"]
    sim_ratio = sim["decode_ms"] / sim["plain_ms"]
    total = sum(len(t) for t in r0["tokens"])
    print(f"shard {label} [{card}]: the same tokens on {len(res)} ranks; "
          f"full logits within {TF_BF16_REL} x max|logit| of sim's spec (a) "
          f"on {done} of {n} events (largest err {worst:.4f} x the bound); "
          + ("no argmax parted: the tokens and the ledger equal sim's"
             if parted is None else
             f"event {parted[0]} parted {parted[1]} row(s) at a sim top-2 "
             f"margin of {parted[2]:.3f} x the bound (<= 2 allowed)")
          + f"; acceptance={r0['acceptance']:.4f} rounds={r0['rounds']} "
          f"(sim {sim['acceptance']:.4f}, {sim['rounds']}); "
          f"{r0['same_as_plain']}/{total} tokens equal the rank's plain "
          f"greedy, {r0['teacher_forced']}/{total} the argmax of a "
          f"teacher-forced plain forward on the rank")
    print(f"shard {label} [{card}]: decode_ms_per_token spec "
          f"{r0['decode_ms']:.2f} / plain {r0['plain_ms']:.2f} = "
          f"{ratio:.3f} over gloo (sim: {sim['decode_ms']:.2f} / "
          f"{sim['plain_ms']:.2f} = {sim_ratio:.3f}); {r0['seconds']:.1f} s")
    print(f"shard {label}: rank 0's ledger entries of one draft forward "
          f"(the last of the first draft call's {k}): {json.dumps(draft1)}; "
          f"of one target forward (the first verify): "
          f"{json.dumps(r0['verify'])}")
    for r, q in enumerate(res):
        print(f"shard {label} rank {r} hand launches: " + json.dumps(
            {nm: q["launches"][nm] for nm in (
                "flash_attention_bhsd", "qdq_absmax",
                "quantize_message_absmax", "reduce_messages_absmax",
                "quantized_psum_absmax")}))
    return r0["launches"]


# the dry run's cells (arch, shape, mesh, spd, kept-sync level): the
# reference test's two, a train_4k cell, the grounding cell that (b) runs
# for real, and the quant8 cell (every kept sync quantized at tp 16) that
# (d) runs for real
DRYRUN_CELLS = (("smollm-360m", "decode_32k", "single", 0.0, "exact"),
                ("hymba-1.5b", "long_500k", "multi", 0.7, "exact"),
                ("smollm-360m", "train_4k", "single", 0.7, "exact"),
                ("smollm-360m", "prefill_32k", "single", 0.7, "exact"),
                ("smollm-360m", "decode_32k", "single", 0.7, "quant8"))
DRYRUN_GROUND = DRYRUN_CELLS[3]
DRYRUN_DECODE = DRYRUN_CELLS[0]
DRYRUN_QUANT = DRYRUN_CELLS[4]
DRYRUN_DIR = ROOT / "build" / "dryrun"
# queries a chunk of B1's plain version at S 32768: (64, 1024, <=32768)
# fp32 scores, 8.6 GB at most
FLASH_LONG_CHUNK = 1024
DRYRUN_LONG_S = 32768


def dryrun_name(cell) -> str:
    arch, shape, mesh, spd, comm = cell
    return (f"{arch}_{shape}_{mesh}_spd{int(spd * 100)}"
            + ("" if comm == "exact" else f"_{comm}"))


def start_dryrun():
    """The dry run's CLI on the meta device for DRYRUN_CELLS, one process
    a cell, all at once: host work that runs beside the kernels' build
    and ends (`dryrun_records`) before the first timed phase.  Returns
    {cell: (json path, process, start time)}."""
    import os
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for cell in DRYRUN_CELLS:
        arch, shape, mesh, spd, comm = cell
        path = DRYRUN_DIR / (dryrun_name(cell) + ".json")
        if path.exists():
            path.unlink()
        procs[cell] = (path, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--spd", str(spd),
             "--comm", comm, "--json", str(path)], cwd=str(ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            time.perf_counter())
    return procs


def stop_dryrun(procs):
    for _, proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dryrun_records(procs) -> dict:
    """(a): wait for the CLI runs; print each record's keys and its wall
    seconds (the process's, start to exit, and the count's own)."""
    ends, deadline = {}, time.perf_counter() + 900
    while len(ends) < len(procs):
        for cell, (_, proc, _) in procs.items():
            if cell not in ends and proc.poll() is not None:
                ends[cell] = time.perf_counter()
        if time.perf_counter() > deadline:
            stop_dryrun(procs)
            raise AssertionError(f"dry runs still running after 900 s: "
                                 f"{sorted(set(procs) - set(ends))}")
        time.sleep(0.1)
    recs = {}
    for cell, (path, proc, t0) in procs.items():
        out, err = proc.communicate()
        wall = ends[cell] - t0
        if proc.returncode != 0:
            raise AssertionError(f"dry run {dryrun_name(cell)} failed "
                                 f"({proc.returncode}): {err[-2000:]}")
        with open(path) as f:
            rec = json.load(f)
        if not (rec["applicable"] and rec["flops_total"] > 0
                and any(v > 0 for v in
                        rec["ledger_bytes_per_device"].values())):
            raise AssertionError(f"dry run {dryrun_name(cell)}: empty "
                                 f"record {rec}")
        print(f"dryrun (a) {dryrun_name(cell)}: "
              f"{out.strip().splitlines()[-1]}")
        print(f"  keys {sorted(rec)}; mem_per_device "
              f"{rec['mem_per_device']}; ledger "
              f"{rec['ledger_bytes_per_device']}; wall {wall:.1f} s "
              f"(count {rec['count']['seconds']:.1f} s)")
        recs[cell] = rec
    return recs


def dryrun_unpadded_flops(cells) -> dict:
    """Each cell's data-rank rows counted on meta at tp 1, where no head
    is padded (a (16 data, 1 model) mesh: the same rows on one device):
    the FLOPs of those rows without the padded heads' work that the tp
    16 count holds (SmolLM's 15 q and 5 kv heads become 32 and 16)."""
    from repro_torch.config.base import SHAPES, replace
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh

    out = {}
    for cell in cells:
        arch, shape, _, spd, comm = cell
        cfg = replace(get_config(arch), attn_backend="pallas")
        out[cell] = D.count_cell(cfg, SHAPES[shape], make_test_mesh(16, 1),
                                 D.spd_plan_for(cfg, spd, comm))[
            "flops_total"]
    return out


def dryrun_ground(torch, cell, rec, card, unpadded):
    """Run `cell`'s data-rank share for real on sim on the card, with
    every kernel count zeroed just before and read just after; hold its
    ledger to the meta record's bit for bit, print the card's peak beside
    the count's and the counted FLOPs over the wall time.  Returns
    (launches, the step's inputs and outputs)."""
    from repro_torch.config.base import SHAPES, replace
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.collectives import collective_ledger

    arch, shape, mesh_kind, spd, comm = cell
    cfg = replace(get_config(arch), attn_backend="pallas")
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    plan = D.spd_plan_for(cfg, spd, comm)
    covers = rec["count"]["devices"]
    release(torch)
    base = torch.cuda.memory_allocated()
    step = D.serve_step(cfg, SHAPES[shape], mesh, plan, device="cuda",
                        seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with collective_ledger() as led, torch.no_grad():
        out = step["step"](*step["args"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() - base
    got = D.ledger_bytes(led)
    name = dryrun_name(cell)
    if got != rec["ledger_bytes_per_device"]:
        raise AssertionError(f"dryrun {name}: the card's ledger {got} is "
                             f"not the meta count's "
                             f"{rec['ledger_bytes_per_device']}")
    lead = out[0].float()
    if not bool(torch.isfinite(lead).all()):
        raise AssertionError(f"dryrun {name}: non-finite outputs")
    m = rec["mem_per_device"]
    counted = covers * (m["argument_bytes"] + m["temp_bytes"])
    flops = rec["flops_total"] * covers
    print(f"dryrun {name} on the card ({card}): {step['rows']} rows, "
          f"{covers} shards on one card, wall {wall:.3f} s; ledger equal to "
          f"the meta count bit for bit: {got}")
    print(f"  memory: card peak {peak} B ({peak / 2 ** 30:.2f} GiB; "
          f"max_memory_allocated over what was allocated before the "
          f"step's arguments) vs counted {covers} x (argument_bytes "
          f"{m['argument_bytes']} + temp_bytes {m['temp_bytes']}) = "
          f"{counted} B ({counted / 2 ** 30:.2f} GiB): gap {peak - counted} "
          f"B ({peak / counted - 1:+.2%}); the count sees each storage's "
          f"bytes, the caching allocator rounds each block up (512 B, 2 MiB "
          f"segments) and cuBLAS takes its workspace from it")
    print(f"  FLOPs: counted {flops:.4e} over {wall:.3f} s = "
          f"{flops / wall / 1e12:.2f} TFLOP/s, "
          f"{flops / wall / H100_BF16_DENSE_FLOPS:.2%} of the card's bf16 "
          f"dense peak (989 TFLOP/s at 700 W; card {card}), the padded "
          f"heads' work included; without it (the rows counted at tp 1) "
          f"{unpadded:.4e}, {unpadded / wall / H100_BF16_DENSE_FLOPS:.2%}; "
          f"launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}")
    return launches, step, out


def flash_long_row(torch, launches, card):
    """B1 at the grounding cell's shape (SmolLM at tp 16: 2 q and 1 kv
    head a shard, 16 shards x 2 rows), bf16, against its plain version
    run one FLASH_LONG_CHUNK-query chunk at a time (chunk [a, b) is the
    plain version on q[:, a:b] and the first b keys: the same causal
    rows), timed beside that and SDPA: a kernels-line row."""
    from repro_torch.kernels import flash_attention as FA

    s, d = DRYRUN_LONG_S, 64
    bh, bhkv = 64, 32
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(33)
    q, k, v = flash_inputs(torch, gen, s, d, torch.bfloat16, bh=bh,
                           bhkv=bhkv)

    def plain():
        return torch.cat([FA.flash_attention_plain(
            q[:, a:a + FLASH_LONG_CHUNK], k[:, :a + FLASH_LONG_CHUNK],
            v[:, :a + FLASH_LONG_CHUNK])
            for a in range(0, s, FLASH_LONG_CHUNK)], 1)

    def call():
        return FA.flash_attention_bhsd(q, k, v)

    out, ref = call(), plain()
    torch.cuda.synchronize()
    err, worst, at, rms = flash_row_errors(torch, out, ref)
    tol = FLASH_ROW_RTOL["bfloat16"]
    print(f"flash bf16 q ({bh},{s},{d}) kv ({bhkv},{s},{d}) against the "
          f"chunked plain version: max_abs_err={err:.3e} worst row rel "
          f"L2 {worst:.3e} at position {at} (tol {tol:.3e}), rel RMS "
          f"{rms:.3e}")
    if not worst <= tol:
        raise AssertionError(f"B1 at S {s} disagrees with its plain "
                             f"version: {worst} > {tol}")
    del out, ref
    lib = sdpa_call(torch, q, k, v, bhkv)
    ms = cuda_ms(torch, call, iters=20, warmup=2)
    plain_ms = cuda_ms(torch, plain, iters=2, warmup=1)
    library_ms = cuda_ms(torch, lib, iters=20, warmup=2)
    names = ("flash_fwd_tc_kernel", "flash_fwd_kernel")
    ran = device_us(torch, call, names, iters=5, need=(names[0],))
    # None where the profiler saw none of SDPA's kernels (PERF.md §7)
    lib_us = device_total_us(torch, lib, iters=5)[0] or None
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4.0 * bh * (s * (s + 1) / 2) * d   # QK^T and PV, causal half
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    shape = (f"q ({bh},{s},{d}) kv ({bhkv},{s},{d}) bf16, the dry run's "
             f"grounding prefill (SmolLM-360M at tp 16, 2 rows)")
    print(f"flash_attention_bhsd {shape} ({card}): ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} (chunked) library_ms={library_ms:.4f} device_us="
          f"{ran[names[0]]} library_device_us={lib_us} bound_ms="
          f"{b_ms:.4f} ({b_by})")
    return {"name": "flash_attention_bhsd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:187",
            "launches": launches["flash_attention_bhsd"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "device_us": ran[names[0]], "library_device_us": lib_us,
            "shape": shape}


def dryrun_phase(torch, recs, unpadded, card):
    """Phase 23 (module doc), on the records `dryrun_records` read and
    the unpadded counts of `dryrun_unpadded_flops`: the grounding cell
    with B1's row, and the decode cell where the count says it fits."""
    from repro_torch.configs import get_config

    ground = DRYRUN_GROUND
    launches, step, out = dryrun_ground(torch, ground, recs[ground], card,
                                        unpadded[ground])
    n_layers = get_config(ground[0]).n_layers
    if launches["flash_attention_bhsd"] != n_layers or any(
            v for k, v in launches.items() if k != "flash_attention_bhsd"):
        raise AssertionError(f"the grounding prefill did not launch B1 once "
                             f"a layer and nothing else: {launches}")
    del step, out
    release(torch)
    row = flash_long_row(torch, launches, card)
    release(torch)
    m = recs[DRYRUN_DECODE]["mem_per_device"]
    covers = recs[DRYRUN_DECODE]["count"]["devices"]
    need = covers * (m["argument_bytes"] + m["temp_bytes"])
    have = torch.cuda.get_device_properties(0).total_memory
    if need < have:
        dryrun_ground(torch, DRYRUN_DECODE, recs[DRYRUN_DECODE], card,
                      unpadded[DRYRUN_DECODE])
    else:
        print(f"dryrun {dryrun_name(DRYRUN_DECODE)} not run: the count says "
              f"its data-rank share needs {need} B, the card holds {have}")
    release(torch)
    quant = dryrun_quant(torch, recs[DRYRUN_QUANT], card,
                         unpadded[DRYRUN_QUANT])
    release(torch)
    return row, quant


def dryrun_quant(torch, rec, card, unpadded):
    """(d) The quant8 cell's data-rank share (8 rows against a 32768-slot
    cache, every kept sync quantized, 16 shards) on sim on the card, as
    dryrun_ground: its ledger equal to the meta record's bit for bit, the
    fused kept sync launched once a quantized kept sync of the plan at tp
    16, and its outputs (the next ids and the K/V the step wrote at each
    row's position) equal bit for bit to a rerun with the quantized
    collectives' plain versions.  Returns its launches."""
    from repro_torch.config.base import replace
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.tree import tree_leaves

    arch, _, _, spd, comm = DRYRUN_QUANT
    name = dryrun_name(DRYRUN_QUANT)
    m = rec["mem_per_device"]
    need = rec["count"]["devices"] * (m["argument_bytes"] + m["temp_bytes"])
    have = torch.cuda.get_device_properties(0).total_memory
    if need >= have:
        raise AssertionError(f"dryrun {name}: the count says its data-rank "
                             f"share needs {need} B, the card holds {have}")
    launches, step, out = dryrun_ground(torch, DRYRUN_QUANT, rec, card,
                                        unpadded)
    cfg = replace(get_config(arch), attn_backend="pallas")
    want = plan_kept_syncs(cfg, D.spd_plan_for(cfg, spd, comm))
    ran = {k: v for k, v in launches.items() if v}
    if ran != {"quantized_psum_absmax": want}:
        raise AssertionError(f"dryrun {name}: launches {ran}, want the fused "
                             f"kept sync {want} times and nothing else")
    pos = step["inputs"]["pos"].long()
    rows = torch.arange(pos.shape[0], device=pos.device)

    def written(caches):
        # each row's entry at its position, (tp, layers, rows, heads, d)
        return [c[:, :, rows, pos].clone() for c in tree_leaves(caches)]

    ids, kv = out[0].clone(), written(out[1])
    del out
    with plain_syncs(), torch.no_grad():
        out = step["step"](*step["args"])
    torch.cuda.synchronize()
    same = torch.equal(out[0], ids) and all(
        same_bits(torch, a, b) for a, b in zip(written(out[1]), kv))
    if not same:
        raise AssertionError(f"dryrun {name}: the rerun on the plain syncs "
                             f"differs from the kernels' run")
    print(f"dryrun {name}: the fused kept sync launched {want} times at tp "
          f"{rec['tp']} ((16, {WIDE_N}) bf16, one a quantized kept sync of "
          f"the plan); the next ids and the {len(kv)} cache leaves' written "
          f"K/V equal a rerun on the plain syncs bit for bit")
    return launches


def clock(t_start, what):
    """Where the run's time goes: seconds since the build at the end of
    each part."""
    print(f"chip_smoke: {what} done {time.perf_counter() - t_start:.1f} s "
          "after the build")


def release(torch):
    """Free the models before the next loads: the caller drops its names,
    this collects them and empties the allocator's cache."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    print(f"released: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"still allocated")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    dryrun_procs = start_dryrun()
    try:
        reports = build.build_all()
    except BaseException:
        stop_dryrun(dryrun_procs)
        raise
    print(f"kernel build: {time.perf_counter() - t0:.1f} s, beside the dry "
          f"run's CLI ({', '.join(reports) or 'cached'})")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # the dry run's records, on the host beside the build, and the
    # grounded cells' unpadded counts beside them: none of them runs
    # beside a timed phase
    t_start = time.perf_counter()
    try:
        dryrun_unpadded = dryrun_unpadded_flops((DRYRUN_GROUND,
                                                 DRYRUN_DECODE,
                                                 DRYRUN_QUANT))
    except BaseException:
        stop_dryrun(dryrun_procs)
        raise
    dryrun_recs = dryrun_records(dryrun_procs)
    clock(t_start, "the dry-run records")
    launch_floor_us(torch)
    kernels = [flash_phase(torch), *paged_phase(torch), qdq_phase(torch)]
    qpsum = qpsum_phase(torch, card)
    kernels += [qpsum, *quant_phase(torch), norm_phase(torch),
                ssd_phase(torch)]
    wide_rows = wide_sync_phase(torch, card, qpsum["device_us"])
    llm, prompts, launches, dense_tokens = main_path(torch, np, card)
    seen = profile_phase(torch, llm, prompts, card)
    if seen and not (seen["flash_fwd_tc_kernel"]
                     and not seen["flash_fwd_kernel"]):
        raise AssertionError(f"the bf16 dense path's prefill did not run "
                             f"on the tensor-core flash kernel: {seen}")
    paged, paged_launches = paged_path(torch, np, llm, prompts, dense_tokens,
                                       card)
    seen = profile_phase(torch, paged, prompts, card, label="paged profile")
    if seen and not (seen["paged_decode_split_kernel"]
                     == seen["paged_decode_combine_kernel"] > 0
                     and not seen["flash_fwd_kernel"]):
        raise AssertionError(f"the paged path's decode did not run the "
                             f"split and combine kernels: {seen}")
    del paged
    serve_phase(torch, np, llm, card)
    clock(t_start, "the serve phase")
    teacher_forced(torch, llm, prompts[2])
    teacher_forced_paged(torch, llm, prompts[2])
    del llm
    ring_launches = ring_phase(torch, card)
    overlap_path(torch, np, prompts, dense_tokens, card)
    mamba, mamba_launches, mamba_tokens = recurrent_path(torch, np, prompts,
                                                         card)
    seen = profile_phase(torch, mamba, prompts, card, label="mamba profile")
    if seen and not (seen["ssd_scores_kernel"] == seen["ssd_states_kernel"]
                     == seen["ssd_output_kernel"] > 0
                     and not seen["ssd_scan_kernel"]):
        raise AssertionError(f"the bf16 mamba path's prefill did not run the "
                             f"three tensor-core SSD kernels: {seen}")
    recurrent_checks(torch, mamba, prompts[3], mamba_tokens[3])
    fp32_run(torch, mamba, prompts, "mamba path")
    del mamba
    release(torch)
    clock(t_start, "the kernel phases and the SmolLM and mamba paths")
    dryrun_row, quant_launches = dryrun_phase(torch, dryrun_recs,
                                              dryrun_unpadded, card)
    clock(t_start, "the dry-run phase")

    # the paper's models at full width, one at a time
    paper_rows = paper_kernel_phase(torch, card)
    llama, lprompts, llama_launches, llama_tokens = main_path(
        torch, np, card, arch="llama2-7b", label="llama2-7b path")
    seen = profile_phase(torch, llama, lprompts, card,
                         label="llama2-7b profile")
    if seen and not (seen["flash_fwd_tc_kernel"]
                     and not seen["flash_fwd_kernel"]):
        raise AssertionError(f"llama2-7b's prefill did not run on the "
                             f"tensor-core flash kernel: {seen}")
    paged, llama_paged = paged_path(torch, np, llama, lprompts, llama_tokens,
                                    card, label="llama2-7b paged path")
    seen = profile_phase(torch, paged, lprompts, card,
                         label="llama2-7b paged profile")
    if seen and not (seen["paged_decode_split_kernel"]
                     == seen["paged_decode_combine_kernel"] > 0):
        raise AssertionError(f"llama2-7b's paged decode did not run the "
                             f"split and combine kernels: {seen}")
    del paged
    release(torch)
    teacher_forced(torch, llama, lprompts[2], TF_FP32_LAYERS, "llama2-7b ")
    teacher_forced_paged(torch, llama, lprompts[2], TF_FP32_LAYERS,
                         "llama2-7b ")
    sweep_res = sweep_phase(torch, np, llama, lprompts, card)
    recovery_launches = recovery_phase(torch, np, llama, lprompts, sweep_res,
                                       card)
    llama._release_engine()           # the canonical weights stay
    release(torch)
    verify_row, spec_launches = spec_phase(torch, np, llama, sweep_res, card)
    print(f"spec path launches: {json.dumps(spec_launches)}")
    release(torch)
    int8_launches = int8_phase(torch, np, llama, card)
    print(f"int8 path launches: {json.dumps(int8_launches)}")
    SIM_RUNS[ALG1_CUT] = alg1_cut(torch, np, llama)
    print(f"{ALG1_CUT} layers {TF_FP32_LAYERS} on sim for the shard phase: "
          f"plan {SIM_RUNS[ALG1_CUT]['modes']}, taus "
          f"{SIM_RUNS[ALG1_CUT]['taus']}, {SIM_RUNS[ALG1_CUT]['wall']:.2f} s")
    del llama
    release(torch)
    clock(t_start, "the llama2-7b paths")
    paper_rows.append(recovery_row(torch, recovery_launches))
    opt, oprompts, opt_launches, opt_tokens = main_path(
        torch, np, card, arch="opt-6.7b", label="opt-6.7b path")
    profile_phase(torch, opt, oprompts, card, label="opt-6.7b profile")
    teacher_forced(torch, opt, oprompts[2], TF_FP32_LAYERS, "opt-6.7b ")
    decode_vs_prefill(torch, opt, oprompts[1], opt_tokens[1],
                      TF_FP32_LAYERS, "opt-6.7b ")
    del opt
    release(torch)
    clock(t_start, "the OPT path")
    train_row, train_launches = train_phase(torch, np, card)
    print(f"train path launches: {json.dumps(train_launches)}")
    clock(t_start, "the training phase")
    b8_rows, family_train = family_train_phase(torch, np, card)
    clock(t_start, "the families' training")

    # the MoE and hybrid families at full width, one model at a time
    family_rows = family_kernel_phase(torch, card)
    moe_launches, moe_paged = moe_phase(torch, np, card)
    clock(t_start, "the qwen2-moe paths")
    hymba_launches = hymba_phase(torch, np, card)
    clock(t_start, "the hymba paths")

    # MLA at full width, and B3 on its logits gather
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(24)
    deepseek_row = checked_qdq_row(torch, gen, *DEEPSEEK_QDQ, DEEPSEEK_ARCH)
    deepseek_launches = deepseek_phase(torch, np, card)
    clock(t_start, "the deepseek paths")

    # the modality frontends at full width: served, prefilled with
    # embeds and trained
    front_launches, front_rows = frontend_phase(torch, np, card)
    print(f"frontend path launches: {json.dumps(front_launches)}")
    clock(t_start, "the frontend paths")

    # the shard engine: one process per shard, against the sim runs above
    release(torch)
    shard_launches = shard_phase(torch, np, card)
    print(f"shard path launches (rank 0): {json.dumps(shard_launches)}")
    hop_rows = shard_hop_rows(torch, shard_launches, card)
    clock(t_start, "the shard phase")

    # each kernel's launches on the main path it serves: the paged kernel
    # on the paged path, quantize and dequant-accumulate on the ring
    # phase, the SSD scan on the mamba path, the rest on the dense path
    # (every path's counts are printed above); dequantize and the fused
    # norm are on no path, and their 0 is the dense path's count; qdq
    # alone is the dense path's logits gathers, the fused kept sync its
    # quantized kept syncs
    # the paged kernel's calls split in two entries that sum to them: the
    # decode (C = 1) and the chunks (C > 1)
    launches["paged_flash_attention"] = (
        paged_launches["paged_flash_attention"]
        - paged_launches["paged_flash_attention_chunk"])
    launches["paged_flash_attention_chunk"] = paged_launches[
        "paged_flash_attention_chunk"]
    launches["quantize_absmax"] = ring_launches["quantize_absmax"]
    launches["dequant_accum_absmax"] = ring_launches["dequant_accum_absmax"]
    launches["ssd_scan"] = mamba_launches["ssd_scan"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    # the new shapes' rows: launches on the path that runs each shape
    by_path = {"llama2-7b": llama_launches, "opt-6.7b": opt_launches,
               "llama2-7b paged": dict(
                   llama_paged, paged_flash_attention=(
                       llama_paged["paged_flash_attention"]
                       - llama_paged["paged_flash_attention_chunk"]))}
    for k in paper_rows:
        path = k.pop("_path")
        if path != "apply_spd":       # that row carries its own count
            k["launches"] = by_path[path][k["name"]] if path else 0
    # B2 at the chain verify's C = k + 1: its chunk launches on the paged
    # speculative path (b)
    # B1 at the train step's shape: its launches on the train path (a)
    kernels += paper_rows + [verify_row, train_row]
    # the MoE and hybrid rows: launches on the dense path that runs each
    # shape (qwen2-moe's for B1 at its prefill, hymba's for B8 at N 16)
    fam_paths = {MOE_ARCH: moe_launches, HYMBA_ARCH: hymba_launches}
    for k in family_rows:
        k["launches"] = fam_paths[k.pop("_path")][k["name"]]
    kernels += family_rows
    # B8 under autograd at the train shapes: its launches in 16f's mamba2
    # and hymba train steps
    kernels += b8_rows
    # B3 at deepseek's logits gather: its launches on the deepseek path
    deepseek_row.pop("_path")
    deepseek_row["launches"] = deepseek_launches["qdq_absmax"]
    kernels.append(deepseek_row)
    # the frontend rows: launches of each model's frontend prefill and
    # decode (frontend_phase)
    kernels += front_rows
    # the send and receive kernels at the shard paths' payloads: rank 0's
    # launches on the dense shard path of each row's model
    kernels += hop_rows
    # B1 at the dry run's grounding prefill: its launches in that run
    kernels.append(dryrun_row)
    # the fused sync and the receive at tp 16: their launches in the quant8
    # cell's grounding (the receive's 0: no path runs 16 ranks on a card)
    for row in wide_rows:
        row["launches"] = quant_launches[row["name"]]
    kernels += wide_rows
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          f"build")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_us", "library_device_us", "context_ms",
            "context_device_us", "shape")
    print(f"card: {card}")
    print(json.dumps({"kernels": [{k: kd.get(k) for k in keys}
                                  for kd in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
