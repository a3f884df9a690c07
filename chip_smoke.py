"""Chip smoke test of the PyTorch/CUDA port (dynamo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line (any failure raises and exits non-zero):
  1. card: name and power limit (nvidia-smi);
  2. build: the serving path's CUDA kernels (the dense and int8 modes of
     flash decode; the w8a16 GEMM), compiled with nvcc from
     dynamo_tpu_torch/csrc/flash_decode.cu and w8a16_gemm.cu, one nvcc
     each, started together, with ptxas's register, shared-memory and
     spill counts;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes serving gives it (Llama-3.1-8B and Llama-3.2-1B decode
     shapes, several context/ring patterns; the plain version runs in f32
     on the same inputs, rounding P to bf16 before P.V where the kernel
     does (the bf16 kernels, as the TPU kernel), and per element
     |kernel - plain| <= atol + rtol * |plain|; controls that must fail
     the check: a dropped row, and K scales off by 5% in int8 mode, V rows
     off by 5% in dense mode), with the kernel's, the plain version's and
     one library call's times and the kernel's least time (its byte or
     operation bound); each mode's check also times the other mode's
     kernel over the same K/V in the same call (dense over the region
     before quantization, int8 over it quantized); the w8a16 GEMM in its
     four uses (bf16 layer products, untied and tied bf16 logits, f32)
     at every Llama-3.1-8B layer weight shape at M = 1, 8, 32 (the mma
     kernel) and 64, 128, 200, 512, 1024, 2048, 4096 (the wgmma kernel of
     prefill), the lm_head at M = 1, 8, 32, 40 (a speculative verify's
     rows), 1024, the Llama-3.2-1B tied
     logits and the tiny shapes, against its plain version in f32 with the
     reference's rounding emulated (controls: one channel's scale off by
     5%, one k row zeroed), timed over weights too large for L2 beside its
     byte and tensor-core bounds, cuBLAS over a bf16 weight of the same
     shape and torch._weight_int8pack_mm where it runs on CUDA (timed
     only); and the dense logits' f32 product (aten::mm.dtype);
  4. tiny: TorchEngine on ModelConfig.tiny (f32) on the card, its rounds
     replayed CUDA graphs, must be greedy token-identical to the same
     engine on the CPU, whose rounds run eagerly (the CPU tests hold it
     against the JAX TpuEngine); with int8 KV too, where a
     greedy token may differ only at a CPU near-tie (top-2 logprob gap
     <= 0.05), and a seeded request at temperature 0.8 must draw the same
     stream on both devices; and with w8a16 weights, where every step
     must run the w8a16 kernel 7 times a layer and once for the logits;
     and with a resident LoRA bank (tiny lora: 4 rows at rank 4, rows 1
     and 2 random), where a burst with adapter ids 0, 1, 2, 1 and a
     variant's repeat must be greedy token-identical on both devices;
     and ModelConfig.tiny_moe (8 experts, top-2, dropless), dense and
     w8a16 (tiny moe, tiny moe w8a16: (4 + 3 x 8) products a layer and
     the logits a step inside the replays);
  5. round_graph, in a process of its own (``chip_smoke.py
     --profiled-checks``) started after the 8B phases, as what ran
     before in a process moves torch.profiler's counts: for the tiny
     model (f32), tiny_moe, and Llama-3.1-8B's width at CUT_LAYERS
     layers (32 before the script's time was cut) with dense and with
     int8 KV, and with w8a16 weights, an engine admits the prompts, then one decode
     round replayed from its CUDA graph and the same round run eagerly
     (engine/graphs.py ``run_round``) on a clone of the same device state
     must give identical tokens, greedy and with logprobs (the largest
     logprob difference is printed); torch.profiler then counts the CUDA
     runtime calls of one steady pipelined round (one graph launch, the
     fetch copies, no kernel launched from the host) and the flash-decode
     kernels inside the replay (one a layer a step; the kernel's own
     count on the card must agree; w8a16: (7 x 8 + 1) x 4 = 228
     w8a16_gemm kernels too; tiny_moe: the dense-dispatch FFN inside the
     one graph launch), and with a LoRA bank (round_graph 8B lora:
     adapters 1..3 of rank LORA_RANK installed, the 8 prompts with ids
     LORA_IDS: one replayed round runs mixed adapters); each graph's
     capture time and the graph pool's memory are printed;
  6. serve: TorchEngine at the full width of Llama-3.1-8B (32 layers,
     random bf16 weights from a seed, made once, default EngineConfig:
     rounds pipelined, each round a replayed CUDA graph) answers 8
     concurrent greedy requests and a prefix-cache hit through
     generate(), first with dense KV, then with int8 KV; launch counts
     are zeroed just before each and read just after: every round and
     patch must have been a graph replay, the wrapper must have issued
     no launch, and the count the kernel keeps on the card (block
     (0, 0, 0) of each launch adds one, graph replays included) must show
     the kernel of that mode ran on every layer of every decode step (and
     the other mode's never), as the engine's count (the launches its
     graphs recorded at capture, once a replay) does. The burst is held
     at the engine's intake until all 8 requests wait, so its prefill
     groups do not depend on arrival timing;
  6b. checkpoint: the serve weights' first CUT_LAYERS layers (32 until
     the script's time was cut) written as an HF checkpoint into a
     temporary directory (its path and free space printed first; no
     room fails the phase): ~5 GB safetensors shards and
     model.safetensors.index.json, Llama-3.1-8B's published config.json
     (llama3 rope_scaling, three EOS ids), a tokenizer.json of Llama 3's
     shape built here on the standard library (the 256 byte symbols,
     CKPT_MERGES merges learned greedily from the repository's README.md,
     reserved tokens up to 128000, Llama 3's 256 special tokens) and a
     tokenizer_config.json whose chat template uses the Llama 3.1
     template's constructs. load_hf_params must give every leaf
     torch.equal to the in-memory weights and from_pretrained Llama-3.1-8B
     with that rope_scaling; the load's seconds and GB/s (page cache
     warm: the files were just written) and the card's peak allocation
     over it (below two copies of the weights) are printed. The serve
     burst then runs from the loaded weights, dense and int8 KV, each
     held token-identical to the same burst on the in-memory weights
     under the loaded config (their flash-decode launches inside the
     replayed rounds are the kernels line's launches_checkpoint); the
     checkpoint quantized at load (--quantize int8) must be bit-equal to
     quantize_params of the in-memory weights; the host's us to encode
     1,000 characters and to render one chat are printed. Then
     ``launch.run in=http out=torch --model-path DIR`` in a subprocess
     (its start-to-ready seconds printed): one chat and one completions
     request, each greedy, their prompt ids equal to the in-process
     PromptFormatter's and HfTokenizer's (the prompt token counts, and a
     completions request on those ids giving the same text) and their
     texts equal to generate() on those ids in build_chain's engine on
     the same weights. A Q8_0 GGUF at full width and GGUF_LAYERS layers
     (packing 32 layers on the host would take minutes) with the
     byte-level BPE tokenizer in its metadata is written first, and
     ``launch.run in=text out=torch --model-path FILE.gguf``, started
     beside the in=http launcher, must serve a prompt on cuda;
     load_gguf_params must equal the Q8_0 formula computed here. The
     files are deleted at the end;
  7. http: the port's entry point on the same weights: launch.run's
     build_chain (dense KV, default EngineConfig) behind the port's
     HttpService on 127.0.0.1, driven by the port's HTTP client: the
     serve phase's 8 prompts as streamed greedy /v1/completions requests
     (token ids, 32 tokens, nvext.ignore_eos), sent in prompt order and
     gated as in the serve phase. Every stream ends in [DONE] with
     finish_reason length, its text (the test tokenizer with one word per
     id) maps back to the serve phase's tokens, the kernel's own count on
     the card rises by layers x decode steps (the kernels line's
     launches_http), a unary chat completion returns 200 and /metrics
     carries the TTFT, ITL and E2E series; TTFT, gaps and tok/s are
     printed beside the serve phase's, with the event loop's host time
     per streamed token (LoopMeter: its busy time at perf_counter's
     resolution and its thread's CPU clock, whose step on the host is
     printed too) and DecodeStream's cost per token;
  7b. distributed: the same burst through the distributed runtime on
     the same weights: the port's store (serve_store on 127.0.0.1, port
     0), a worker (launch.run's build_chain, registered through
     launch.run.serve_worker, the function in=endpoint runs, with
     --router-mode round_robin) and a frontend (ModelWatcher +
     HttpService), each on an event loop of its own thread, the client
     on the main thread; streamed greedy /v1/completions gated at the
     worker's intake as in the http phase. Every stream ends in [DONE]
     and maps back to the serve phase's tokens, the kernel's own count
     rises by layers x decode steps (the kernels line's
     launches_distributed), the frontend's /clear_kv_blocks fan-out
     returns the pages the worker's engine held, and a chat with tools
     and a streamed chat with nvext.annotations ["llm_metrics"] answer
     200 in the JAX package's shapes; TTFT, gaps and tok/s are printed
     beside the http and serve phases', with each loop's host time per
     streamed token (LoopMeter: frontend, worker, client);
  7c. kv router: the KV router on the same weights: the port's store, two
     workers (launch.run's build_chain sharing the one weight copy, each
     registered through launch.run.serve_worker with the launcher's
     default --router-mode kv, each on its own loop thread beside its
     engine's thread) and a frontend (ModelWatcher with
     KvRouterConfig(router_temperature=0.0) + HttpService); every request
     asks top-2 logprobs. Wave A: the serve prompts gated at both
     workers' intakes; wave C, once the frontend's indexer holds every
     sealed prompt block under its worker's lease id: the 8 one at a
     time, each to the worker that served it in wave A, the router's
     overlap the prompt's full blocks and the engine's matched blocks
     that overlap (less a last block the prefill needs); wave C': the 8
     one at a time straight to the other worker's endpoint (recomputed);
     failover: one worker shut down, a prompt it held served by the
     survivor, its blocks out of the indexer. Every stream maps back to
     the engine's tokens, which must be identical to generate() on one
     engine along the same prefill paths (each worker's wave A share as
     one gated burst, then its wave C prompts one at a time; each wave C'
     prompt alone on a cold cache; the failover prompt cold, then as a
     prefix hit), and may leave the serve phase's generate() stream (where
     pairs prefilled together) only where their top-2 swap (part_ways: a
     prompt prefilled alone, or a prefix hit that prefills only its tail,
     sums in another order; the gaps are printed); the kernel's own count
     rises by layers x the decode steps of both engines over the waves
     (the kernels line's launches_kv_router). Printed: memory
     with both workers up, wave A's TTFT, gaps and tok/s beside the http
     phase's, the matched blocks, and each prompt's TTFT in wave C
     against C' (the engine's own, intake to first token, and the
     client's);
  7d. disagg: disaggregated prefill/decode on the same weights, dense KV:
     the port's store, a --role decode worker (engine D, launch.run's
     serve_worker with --max-local-prefill-length 64: every serve prompt
     goes remote), a --role prefill worker (engine P,
     serve_prefill_worker: it prefills each job and streams its pages
     over the KV transfer plane into D's pool as prefill advances, 8
     pages a chunk) and a KV-routing frontend, each on its own loop
     thread. Wave A: the 8 prompts one at a time through the frontend: 8
     remote prefills, none local, no fallback, D's admission matching
     exactly the blocks P sent, D's and P's pages byte-equal for two
     prompts, every stream identical to generate() along the same path
     (the prompt prefilled alone with max_tokens=1, then served from
     that prefix hit). Wave B: both caches cleared, the 8 as one
     ungated burst: 16 remote prefills in all (both waves at the
     launcher's 60 s remote-prefill timeout). Fallback: P stopped, one
     prompt falls back after a timeout of DISAGG_FALLBACK_S, counted once in
     remote_fallbacks and dynamo_disagg_fallback_total, with a local
     prefill's tokens. The kernel's own count rises by layers x the
     decode steps of D and P (the kernels line's launches_disagg).
     Printed: TTFT beside kv router C' (a whole-prompt recompute),
     each prompt's prefill ms, chunks and overlap ratio, wire GB/s, D's
     tail prefill, wave B's gaps beside kv router wave A's, memory;
  7e. remote kv: KVBM G4 on the same weights, int8 KV: two aggregated
     workers (serve_worker with --remote-kv --kv-quant int8
     --host-offload-pages 128), W1 and W2. Wave A: the 8 prompts one at
     a time straight to W1's engine (its probe of W2 misses; recompute);
     wave G: the same on W2, whose every prefix is fetched from W1's
     pool over the wire into its G2 and onboarded (every matchable
     block, pages and scales byte-equal to W1's, streams identical to
     W1's prefix-hit replay); miss: W1's transfer server stopped, a
     fresh prompt on W2 costs at most one probe timeout and recomputes.
     The int8 kernel's own count rises by layers x both engines' decode
     steps (launches_remote_kv). Printed: TTFT per wave and G/A per
     prompt, probe and fetch ms, wire GB/s, memory;
  7f. resilience: two 8B workers on the same weights, dense KV, each
     through serve_worker with --system-port 0 and --drain-timeout 30 (a
     system server and a drain controller each), and a KV-routing
     frontend with --health-heartbeat-ttl 2 (its shared breaker board
     running). Migration: kill_worker armed (after 3 outputs: 9 tokens,
     once) through a worker's POST /chaos; one prompt streamed for 32
     tokens must end whole, migrated once (the chaos and migration
     counters +1), its tokens before the kill generate()'s for the prompt
     alone and the rest generate()'s for the replay request. Drain: 4 prompts gated at both
     intakes; with their first tokens out, POST /drain to the worker
     holding most: its streams finish whole (identical to generate() on
     one engine along the same path), its lease is revoked, /drain reads
     draining then drained, 4 new prompts all land on the other worker,
     a request to the drained engine raises WorkerDrainingError, and the
     drain counter rises by 1; the live worker's /metrics carries uptime,
     its gauges and the resilience families. The kernel's own count
     rises by layers x both engines' decode steps (launches_resilience);
     no chaos point is left armed. Printed: the migrated stream's TTFT
     and the gap at the kill beside the median gap, and the drain's
     seconds;
  7g. prefix economy: the fleet prefix economy on the same weights, dense
     KV: the port's store, a KV-routing frontend with
     --kv-replication-target 2 --kv-prefetch-interval 0.5
     --kv-prefetch-hot-k 64 (its replication controller running; router
     temperature 0) and worker W1 (serve_worker with --remote-kv
     --host-offload-pages 128 --system-port 0). Wave H: the 8 prompts
     through the frontend to W1, twice (the second pass is routed onto
     the stored blocks and gives them heat). Wave W: W2 registers with
     W1's flags and gets no request: within 3 controller ticks it is
     warm-started (warm starts +1, hint pushes +2 or more), every block
     of the hot chains (covering every matchable block) lands in its G2,
     byte-equal to W1's pages, and its /debug/kv_fleet shows the hints
     applied. Wave O: the 8 straight to W2: no G4 fetch, every matchable
     block onboarded from G2, none recomputed, streams identical to W1's
     G1 prefix-hit replay. Wave D, the controller stopped: a fresh prompt
     on W1, routed once for heat, the view's digest published to W2,
     then the prompt on W2 is fetched by hash (recompute avoided by its
     matchable blocks), identical to W1's replay; an unknown prompt on
     W2 skips the probe round (+1, no fetch), identical to W1's cold
     compute. ``python -m dynamo_tpu_torch.tools.kv_fleet`` exits 0 and
     names W1 among the hottest block's holders. The dense kernel's own
     count rises by layers x both engines' decode steps
     (launches_prefix_economy). Printed: each prompt's TTFT on W2
     (onboarded) beside W1's recompute and G1 hit, the warm start's
     seconds from registration to the last landed page, blocks fetched
     and GB/s, the dedup arms' TTFTs, memory;
  8. offload (at the first CUT_LAYERS layers since the script's time
     was cut): the KV offload plane on Llama-3.1-8B with the same bf16
     weights, a 96-page pool (768 MiB), a 128-page G2 in pinned host
     memory and a 128-page G3 file in a temporary directory, in dense
     and in int8 KV: wave A (the serve prompts), wave B (8 prompts of
     the same lengths from seed 1, evicting most of A from HBM and A's
     oldest blocks from G2 into G3), wave C (A again), 32 greedy tokens
     a request, each wave held at the intake until all 8 wait, and G2
     and G3 must hold every block sealed so far before the next wave.
     Wave C must be token-identical to an engine whose 512-page pool
     holds everything (the G1 reference, built after the last engine is
     freed), every matchable block of C must be a G1 hit or onboarded
     with no block failing verification or recomputed, and G3 must serve
     a block of C; export_pages of 16 committed pages imported into 16
     fresh pages and exported again must be byte-equal, and
     clear_kv_blocks must return the G1 + G2 + G3 sizes before it. The
     flash-decode kernel of the mode must run on every layer of every
     decode step (the kernels line's launches_offload). A dense engine
     without tiers at 96 pages recomputes what was evicted (the
     baseline). In int8, wave F follows wave C: a fresh 4000-token
     prompt evicts a serve prompt's blocks from G1; that prompt, replayed
     with the flip_kv_bits chaos point armed once, must have exactly one
     onboarded page fail its crc, be quarantined in every tier and
     recomputed, token-identical to the G1 reference's recompute of it
     alone (its decode steps count in launches_offload). Printed: wave
     C's TTFT onboarded, as G1 hits and recomputed, wave F's beside it,
     wave B's decode gap with offload on and off, host ms a
     page offloaded (on the engine's put thread: crc + copy + spill) and
     onboarded (gather + verify + H2D issue), and the D2H and H2D copies'
     GB/s;
  8a. multimodal: image prompts on the same weights: CLIP ViT-L/14 at 224
     (VisionConfig()'s defaults, random bf16 weights from the seed)
     within TOWER_REL_L2 of its plain f32 version (a control, one
     layer's wo zeroed, must fail it), then MultimodalEngine(TorchEngine)
     with a local EncodeWorker: the image request's (4 + 256 + 3 tokens)
     first token is llama.prefill's argmax with the rows as ``embeds`` up
     to a near-tie, its stream alone equals its stream in a gated burst
     of 8 with two images up to a near-tie, another image with the same
     placeholders adds no prefix hit and the same image again hits every
     matchable block, the request over the port's runtime (rows as array
     frames) is token-identical to the in-process encoder's, and with int8
     KV its first token holds too (the kernels line's
     launches_multimodal, both modes); printed: the tower's ms, the
     image request's TTFT beside a text request's of the same length,
     the array frame's GB/s;
  8a'. embeddings: TorchEngine.embed on 8, 512 and 4096 tokens against
     the plain f32 encoder within EMBED_COS (a control, one layer's wo
     zeroed, must fail it), padding-invariant, the serve burst
     token-identical with two threads calling embed() throughout, and
     /v1/embeddings and /v1/responses over HTTP on the same engine,
     unary and streamed; printed: ms an input, the peak of an embed at
     max_context beside the free memory, the burst's tok/s with and
     without the embed calls;
  8b. speculation: linear speculative decoding on the bf16 weights
     (Llama-3.1-8B's width; arm N and the teacher-forced check at its 32
     layers, the other arms at its first CUT_LAYERS since the script's
     time was cut; default EngineConfig, K = 4, adaptive K): the serve
     phase's 8
     prompts (2 asking for top-2 logprobs, which stay in the fused round)
     and 2 built to repeat (a 64-token span four times), SPEC_NEW greedy
     tokens each, gated at the intake, in four arms: N (dense KV, ngram), Q (int8
     KV, ngram), D (dense, draft: Llama-3.2-1B with random weights from
     seed 1, batched drafting) and S (dense, self-draft: the target's own
     weights as the draft; SPEC_SELF_NEW tokens a request, its 1.4 s
     drafts being the phase's cost). Each stream equals the plain engine's
     (speculative off, same KV mode) up to a step where the plain
     stream's top-2 logprob gap is at most SPEC_TIE (the streams stopped
     there are counted); the 8 serve prompts' plain dense streams,
     teacher-forced through the verify's scorer at its shape, move no
     top-2 logprob and no top-2 gap of the plain decode's by more than
     SPEC_LP_TOL, and the same scorer on the w8a16 weights moves one by
     more; the flash-decode kernel of the mode runs on
     every layer of every fused step inside replayed graphs (the kernels
     line's launches_spec); N accepts tokens, D de-speculates, and a
     seeded temperature-0.8 request run on two N engines draws one
     stream. Printed per arm: acceptance, tokens a slot's verify step,
     effective K (mean, p50, p95), despecs (gated), draft and verify ms a
     dispatch (host wall and device, CUDA events) beside a fused round's
     ms a step, and decode tok/s beside the plain run's; then one
     verify's scorer at the burst's shape with the span bounded to the
     attention's 256-key block and over the whole region: bit-equal, each
     one's wall and device ms;
  8c. speculation tree: tree speculation on the same weights, prompts
     and plain runs (TN at 32 layers, the others at CUT_LAYERS; K = 4
     adaptive, 4 branches, the auto budget of 17
     nodes), four arms: TN (dense, n-gram trie), TQ (int8 KV, n-gram
     trie: the int8 commit), TD (dense, comb drafts from the 1B draft:
     m > 1 drafting, rejection, de-speculation) and TS (dense, the 8B as
     its own comb draft, SPEC_SELF_NEW tokens a request). Held as the
     linear arms are (near-ties, the
     mode's flash-decode launches inside replayed graphs, the kernels
     line's launches_spec_tree), with dynamo_spec_tree_nodes_total moving;
     TN accepts and draws one seeded temperature-0.8 stream twice, TD
     de-speculates. Printed per arm besides the linear arm's figures:
     effective M, branch_accept_hist, and its verify, draft and tok/s
     beside its linear counterpart's. Then the 8 plain dense streams
     teacher-forced through greedy tree verifies (a wrong sibling first,
     the true chain under node 2): the path goes through node 2, the
     emitted tokens equal the stream up to a near-tie, and every
     committed row is within SPEC_TREE_KV_TOL of a linear batch_score's;
  9. serve w8a16: the same weights quantized on the card
     (quantize_params), the serve burst and repeat again at full width
     and depth; every decode step must run both kernels on every layer
     (and the w8a16 kernel for the logits), the prefill the w8a16 kernels
     eagerly (its 7 layer products a layer on the wgmma kernel, its
     logits on the mma kernel); TTFT, gaps, tok/s and the weights' GiB
     are printed beside the dense serve's, with the share of greedy tokens equal to the
     dense run's and the first step's largest logprob difference
     (information: random weights have near-ties); then speculation
     w8a16: arm W, the speculation phase's burst with n-gram speculation
     on the w8a16 weights (their first CUT_LAYERS layers), held to its
     plain run as the other arms, the
     verifies' products and logits on the w8a16 kernels (its executions
     over the burst, counted from after the engine's graph captures, are
     the w8a16 record's launches_spec);
  9b. tenancy: resident LoRA banks on the same weights: an engine with a
     bank of 4 (rank LORA_RANK; adapters 1..3 from random_adapter, seed =
     id) serves the 8 serve prompts with adapter ids LORA_IDS in one
     gated burst, with dense KV, with int8 KV and on the w8a16 weights:
     adapter 0's streams must equal the serve phases' bank-less bursts
     exactly, every variant must part from the base, and (dense) each
     variant's streams must equal those of a burst in which all 8
     prompts take that variant, up to a top-2 swap; every round is a
     replay running the mode's flash-decode kernel on every layer of
     every step (the kernels line's launches_tenancy, both modes), w8a16
     7 products a layer and the logits. Printed: a decode step's device
     and wall ms (replayed rounds back to back) with the mixed bank
     beside an engine without one, and the MB a round's gather moves;
  9c. overload (at CUT_LAYERS layers since the script's time was cut):
     two 8B engines (2 slots, queue budget 3, tenant budget
     2; A preempts running streams) behind the port's KV router and HTTP
     frontend, and a reference engine R: a storm of 12 streamed requests
     gets 200s and 429s with Retry-After and every bounced one is served
     on retry; a HIGH-priority arrival on B's full queue evicts the
     newest waiting entry; a tenant's budget bounces only that tenant;
     with preempt_running, a HIGH-priority arrival on A migrates the
     newest running low-priority stream to B through the router, whole
     and equal to generate() on R along the same paths (the kernels
     line's launches_overload);
  9d. moe w8a16, moe bf16 (after the 8B weights are freed):
     Llama-3.1-8B's width with the repo's MoE recipe (MOE_RECIPE: 8
     experts, top-2, dropless), random weights, w8a16 at all 32 layers
     and bf16 at MOE_BF16_LAYERS (check_moe): the serve burst and its
     prefix repeat through the replayed rounds, dense then int8 KV, with
     flash decode on every layer of every step and (4 + 3 x 8) x 32 + 1
     w8a16 products a step inside the replays (the kernels line's
     launches_moe; the router stays a dense product); the repeat equal
     to its first stream up to a top-2 swap with dense KV (with int8 KV,
     whose repeat attends its prefix's int8 pages, how far they agree is
     printed as information) and one
     prompt served alone equal to its stream in the burst up to a top-2
     swap; the burst on an eager engine
     equal to the replayed one token for token; layer 0's grouped FFN
     within MOE_FFN_L2_TOL of the dense dispatch (and a capacity-drop
     control outside it); a decode step's device and wall ms beside its
     byte bound, TTFT, tok/s, the peak allocation and the prefill's
     host ms for its kept-count reads;
  10. cli: ``python -m dynamo_tpu_torch.launch.run in=text out=torch
     --model-config tiny --cache-dtype float32 --prompt "w1 w2 w3"
     --max-tokens 8`` in a subprocess, with no --device, and again with
     ``--quantize int8``: each must run its engine on cuda and exit 0;
     between the two, the distributed entry points in subprocesses:
     ``python -m dynamo_tpu_torch.cli cp --port 0``, two ``launch.run
     in=endpoint out=torch --model-config tiny --cache-dtype float32
     --router-mode round_robin`` workers with no --device (each must run
     on cuda) and a ``launch.run in=http --control-plane`` frontend; four
     greedy chat completions must each equal in=text's output, both
     workers must have served (each prints its count when SIGTERM stops
     it), each worker runs with --system-port 0 (/health must answer 200)
     and SIGTERM must drain it ("drained; shutting down"), and every
     process must exit 0.
Each phase prints its seconds, and at the end one summary line (its
name, seconds and key figures), all together before the card line. The
block from the first summary line to the last line is at most
SUMMARY_BUDGET (16,000) bytes, so the last 22,000 bytes of the output,
all a short log keeps, hold every phase's result (summary_block); two
padding lines before it make the last 22,000 and 24,000 bytes each start
at a line (tail_padding). The card line (nvidia-smi's name and power limit) comes fourth from last,
then the block's byte count, a JSON object describing every kernel (its
floats to 4 significant digits; the w8a16 per-shape figures are a log
line of their own earlier), and last {"ok": true, "device": {...}}.
Without a CUDA device, or without the rest of the repository beside it,
the script fails.
"""
from __future__ import annotations

import asyncio
import base64
import dataclasses
import faulthandler
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
from collections import defaultdict

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense tensor-core bf16
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
# kernel vs plain, per element: |got - want| <= atol + rtol * |want|; the
# plain version runs in f32 on the same inputs, so in f32 the two differ
# by the order of the sums
F32_TOL = (1e-5, 1e-4)
# bf16: kernel and plain both round P to bf16 before P.V as the TPU
# kernel does (plain_f32 with p_round), and the output to bf16 (one bf16
# step, 2**-7 of |want|). A split rounds exp(s - m_split) and its cluster
# merge rescales by exp(m_split - m) in f32, where the plain version
# rounds exp(s - m). Each probability's rounding then differs by up to
# one bf16 step, and what that does to an output is absolute (set by the
# V rows it averages, ~2**-9 of their weighted |v|), not relative to the
# output: hence the atol. A context that one block holds (ring only)
# rounds exactly as the plain version. A dropped row, K scales off by 5%
# (int8) and V rows off by 5% (dense) still fail it.
BF16_P_TOL = (5e-4, 1e-2)
SEED = 0
# the tenancy phases' bank: adapters 1..3 (random_adapter, seed = id) at
# this rank, and the serve prompts' ids in a mixed burst
LORA_RANK = 8
LORA_IDS = [0, 1, 2, 3, 0, 1, 2, 3]
# the output's last block (summaries to the ok line) in bytes, and one
# summary line's figures in characters: a short log keeps 22,000 bytes of
# the output, and the rest leaves room for later phases' summaries
SUMMARY_BUDGET = 16000
SUMMARY_LINE = 320
# a greedy token of the int8 engine may differ between devices only where
# the CPU's top-2 logprob gap is this small (tests/test_kv_quant.py)
NEAR_TIE = 0.05
# the depth of the phases cut to keep the script inside its time (32 before;
# Llama-3.1-8B's width at its first CUT_LAYERS layers, the Llama-3.2-1B
# draft at its first CUT_LAYERS of 16): speculation but its arms N and TN
# and its teacher-forced check (check_speculation says why), checkpoint
# (16.1 GB at 32), offload, overload and the profiled 8B round graphs.
# Their checks do not depend on the depth
CUT_LAYERS = 8


# the running phase's key figures and last line, and each finished
# phase's summary line (printed together before the kernels line, so the
# end of the output holds every phase's result)
_PHASE = {"figures": None, "last": ""}
SUMMARY: list[str] = []


def log(*a):
    line = " ".join(str(x) for x in a)
    print(line, flush=True)
    _PHASE["last"] = line


def figures(text):
    """The running phase's key figures, for its summary line."""
    _PHASE["figures"] = text


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call. The calls are queued behind a kernel that
    spins, so the host's cost of issuing them (the wrapper's checks, the
    ctypes call) stays out of the time; the spin is doubled until it
    outlasts the queuing (a call that synchronises never lets it: after
    6 doublings the time is returned as it is, an upper bound)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 20_000_000
    for _ in range(7):
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        h0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        queued_ms = (time.perf_counter() - h0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > queued_ms:
            break
        cycles *= 2
    return ev[1].elapsed_time(ev[2]) / iters


def serve_prompts(vocab: int):
    """The serve phase's 8 prompts (lengths 128..1024), from the seed."""
    rng = np.random.RandomState(SEED)
    lens = rng.randint(128, 1025, size=8)
    return [rng.randint(0, vocab, size=int(n)).tolist() for n in lens]


# ---------------------------------------------------------------------------
# kernels

def decode_inputs(dtype, L, nkv, nh, hd, B, S, R):
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def mk(*shape):
        return (torch.randn(shape, generator=g, device="cuda")
                * 0.5).to(dtype)

    return (mk(B, nh, hd), mk(L, nkv, B + 1, S, hd), mk(L, nkv, B + 1, S, hd),
            mk(L, nkv, B, R, hd), mk(L, nkv, B, R, hd))


def decode_patterns(S, R, serve_lens):
    """(ctx_lens, ring_base) per slot: the serve phase's contexts in mid
    round, and an edge-case mix — ring only, a single token, contexts that
    straddle split boundaries, a full region and freed lanes."""
    serve_ctx = [n + 17 for n in serve_lens]
    return {
        "serve": (serve_ctx, [c - 2 for c in serve_ctx]),
        "edges": ([3, 1, 1003, S, 1, 2050, 128, S - 1],
                  [0, 0, 1000, S - 2, 0, 2047, 127, S - 1 - R + 2]),
    }


def decode_bound_ms(ctx, base, nkv, nh, hd, R, elem, group=None):
    """Least time for one call: each live K/V row read once, q read and
    out written once; 4 flops per (head, live row, dim). With ``group``
    (int8 mode) the ctx rows are 1 byte per element, plus one f32 K and V
    scale per group they touch and one dequantizing product per element."""
    live_ctx = sum(min(b, c) for c, b in zip(ctx, base))
    live_ring = sum(max(0, min(c - b, R)) for c, b in zip(ctx, base))
    B = len(ctx)
    ctx_elem = elem if group is None else 1
    nbytes = ((live_ctx * ctx_elem + live_ring * elem) * nkv * hd * 2
              + 2 * B * nh * hd * elem + 2 * B * 4)
    flops = 4 * (live_ctx + live_ring) * nh * hd
    if group is not None:
        nbytes += sum(-(-min(b, c) // group) for c, b in zip(ctx, base)) * 8
        flops += 2 * live_ctx * nkv * hd
    peak = H100_BF16_FLOPS if elem == 2 else H100_F32_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tol_excess(got, want, tol):
    """Largest |got - want| / (atol + rtol * |want|) over the elements:
    the check passes while this is at most 1."""
    atol, rtol = tol
    want = want.float()
    return ((got.float() - want).abs() / (atol + rtol * want.abs())).max().item()


def quantize_groups(x, group):
    """Symmetric int8 with absmax scales per (layer, lane, position group),
    as the int8 region holds them: ([L, nkv, lanes, S, hd] int8,
    [L, lanes, S/group] f32)."""
    L, nkv, lanes, S, hd = x.shape
    amax = x.float().abs().reshape(L, nkv, lanes, S // group, group,
                                   hd).amax(dim=(1, 4, 5))
    sc = torch.clamp(amax / 127.0, min=1e-8)
    per_pos = sc.repeat_interleave(group, dim=2)[:, None, :, :, None]
    q = torch.clamp(torch.round(x.float() / per_pos), -127, 127)
    return q.to(torch.int8), sc


def dense_layer(c, sc, layer, dtype):
    """One layer [1, nkv, lanes, S, hd] of a region in the compute dtype:
    a dense region as it is; an int8 one (scales ``sc``) as the int8 mode
    defines it, the f32 product with the row's scale rounded to dtype."""
    if sc is None:
        return c[layer:layer + 1]
    g = c.shape[3] // sc.shape[2]
    per_pos = sc[layer].repeat_interleave(g, dim=1)[None, None, :, :, None]
    return (c[layer:layer + 1].float() * per_pos).to(dtype)


def plain_f32(fd, q, ck, cv, rk, rv, layer, ctx, base, ksc=None, vsc=None,
              p_round=None):
    """The plain version on the same inputs (an int8 region dequantized
    as above) computed in f32, in q's dtype. With ``p_round`` the
    unnormalized probabilities exp(s - max) are rounded to it before P.V,
    as the TPU kernel rounds them (dynamo_tpu/ops/flash_decode.py:159);
    without, they stay in f32. The f32 kernels keep P in f32, the bf16
    kernels of both modes round it to bf16. At a 3-row context whose
    terms cancel, that rounding alone moves an output by ~2e-3, so each
    kernel is held against the plain version with its own rounding."""
    f = [t.float() for t in (dense_layer(ck, ksc, layer, q.dtype),
                             dense_layer(cv, vsc, layer, q.dtype),
                             rk[layer:layer + 1], rv[layer:layer + 1])]
    return fd.flash_decode_attention_plain(
        q.float(), *f, 0, ctx, base, p_round=p_round).to(q.dtype)


def sdpa_call(q, ck, cv, rk, rv, layer, ctx, base):
    """The same function as one library call (timed as a yardstick only;
    the port never calls it): SDPA over the region up to the longest live
    context, plus the ring, with a mask."""
    B, nh, hd = q.shape
    R = rk.shape[3]
    S = int(torch.minimum(base, ctx).max().item())
    k = torch.cat([ck[layer][:, :B, :S], rk[layer]], dim=2).transpose(0, 1)
    v = torch.cat([cv[layer][:, :B, :S], rv[layer]], dim=2).transpose(0, 1)
    pos = torch.arange(S + R, device="cuda")[None, :]
    ring_pos = base[:, None] + pos - S
    mask = torch.where(pos < S, pos < torch.minimum(base, ctx)[:, None],
                       ring_pos < ctx[:, None])
    k, v, mask = k.contiguous(), v.contiguous(), mask[:, None, None, :]

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]

    return call


def check_flash_decode(serve_lens, quant):
    """The kernel in dense mode, or in int8 mode with ``quant`` (inputs
    quantized with per-(layer, lane, group) absmax scales), against its
    plain version; returns the kernels-line figures at the 8B shape. At
    the bf16 serve shapes it also times the other mode's kernel over the
    same K/V in the same call."""
    from dynamo_tpu_torch.ops import flash_decode as fd

    name = "flash_decode_int8" if quant else "flash_decode"
    cases = [  # (label, dtype, L, nkv, nh, hd, B, S, R, int8 group, tol)
        ("llama3_8b", torch.bfloat16, 32, 8, 32, 128, 8, 4096, 4, 64,
         BF16_P_TOL),
        ("llama3_1b", torch.bfloat16, 16, 8, 32, 64, 8, 4096, 4, 64,
         BF16_P_TOL),
        # f32: a ring of 40 rows spans two of the kernel's 32-row f32
        # tiles; the tiny engine's int8 group (page size 16)
        ("llama3_8b_f32", torch.float32, 2, 8, 32, 128, 8, 4096, 40, 16,
         F32_TOL),
    ]
    report = None
    max_err = 0.0  # bf16, every case and pattern
    for label, dtype, L, nkv, nh, hd, B, S, R, group, tol in cases:
        q, ck, cv, rk, rv = decode_inputs(dtype, L, nkv, nh, hd, B, S, R)
        ksc = vsc = dense_kv = None
        if quant:
            dense_kv = (ck, cv)  # the region before quantization
            ck, ksc = quantize_groups(ck, group)
            cv, vsc = quantize_groups(cv, group)
        # the bf16 kernels round P to bf16 before P.V, as the TPU kernel
        # does, and so does their plain version here
        p_round = torch.bfloat16 if dtype == torch.bfloat16 else None
        what = f"{name} {label}" + (f" (group {group})" if quant else "")
        for pname, (ctx_l, base_l) in decode_patterns(S, R, serve_lens).items():
            ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
            base = torch.tensor(base_l, dtype=torch.int32, device="cuda")
            args = (q, ck, cv, rk, rv)
            err = excess = 0.0
            for layer in (0, L - 1):
                got = fd.flash_decode_attention(*args, layer, ctx, base,
                                                ksc, vsc)
                torch.cuda.synchronize()
                want = plain_f32(fd, *args, layer, ctx, base, ksc, vsc,
                                 p_round)
                err = max(err, (got.float() - want.float()).abs().max().item())
                excess = max(excess, tol_excess(got, want, tol))
                if not excess <= 1.0:
                    raise AssertionError(
                        f"{what} {pname} layer {layer}: |kernel - plain| "
                        f"exceeds atol {tol[0]} + rtol {tol[1]} * |plain| "
                        f"by a factor {excess}")
                if pname != "serve":
                    continue
                # the check must see one dropped row (the plain output
                # without each slot's current token), and K scales (int8)
                # or ctx V rows (dense) 5% off
                controls = {"a dropped row": plain_f32(
                    fd, *args, layer, ctx - 1, base, ksc, vsc, p_round)}
                if quant:
                    controls["K scales x1.05"] = plain_f32(
                        fd, *args, layer, ctx, base, ksc * 1.05, vsc,
                        p_round)
                else:
                    one = [t[layer:layer + 1] for t in (ck, cv, rk, rv)]
                    one[1] = one[1] * 1.05
                    controls["V rows x1.05"] = plain_f32(
                        fd, q, *one, 0, ctx, base, p_round=p_round)
                for bad, out in controls.items():
                    if tol_excess(out, want, tol) <= 1.0:
                        raise AssertionError(
                            f"{what}: tolerance {tol} cannot tell {bad}")
            if dtype == torch.bfloat16:
                max_err = max(max_err, err)
            log(f"kernel {what} {pname}: agrees with plain, max |kernel - "
                f"plain| {err:.3e}, at {excess:.3f} of the tolerance (atol "
                f"{tol[0]} + rtol {tol[1]} * |plain|)"
                + ("; the controls (" + ", ".join(controls) + ") fail it"
                   if pname == "serve" else ""))
            if pname != "serve" or dtype != torch.bfloat16:
                continue
            ms = cuda_time_ms(lambda i: fd.flash_decode_attention(
                *args, i % L, ctx, base, ksc, vsc), iters=100)
            # the other mode in the same call, over the same K/V: dense
            # over the region before quantization, int8 over it quantized
            if quant:
                other, o_args, o_sc = "dense", (q, *dense_kv, rk, rv), ()
            else:
                (kq, ks8), (vq, vs8) = (quantize_groups(ck, group),
                                        quantize_groups(cv, group))
                other, o_args, o_sc = "int8", (q, kq, vq, rk, rv), (ks8, vs8)
            other_ms = cuda_time_ms(lambda i: fd.flash_decode_attention(
                *o_args, i % L, ctx, base, *o_sc), iters=100)
            other_note = (f", {other} kernel over the same K/V "
                          f"{other_ms:.4f} ms, {name}/{other} "
                          f"{ms / other_ms:.3f}")
            del o_args, o_sc
            plain_ms = cuda_time_ms(lambda i: fd.flash_decode_attention_plain(
                *args, i % L, ctx, base, ksc, vsc), iters=5, warmup=1)
            # yardstick: one SDPA call; in int8 mode over the ALREADY
            # dequantized bf16 live K/V (no PyTorch call takes int8 K/V
            # with group scales; the dequantization is not timed)
            lib = sdpa_call(q, dense_layer(ck, ksc, 1, dtype),
                            dense_layer(cv, vsc, 1, dtype), rk[1:2], rv[1:2],
                            0, ctx, base)
            library_ms = cuda_time_ms(lambda i: lib(), iters=20)
            del lib
            bound_ms, bound_by = decode_bound_ms(
                ctx_l, base_l, nkv, nh, hd, R, 2, group if quant else None)
            log(f"kernel {name} {label} serve shape: {ms:.4f} ms/call (plain "
                f"{plain_ms:.4f} ms, sdpa"
                + (" over the dequantized bf16 K/V" if quant else "")
                + f" {library_ms:.4f} ms, {bound_by} bound {bound_ms:.4f} ms"
                + other_note + ")")
            if label == "llama3_8b":
                report = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=library_ms)
        del q, ck, cv, rk, rv, ksc, vsc, args, dense_kv
        torch.cuda.empty_cache()
    report["max_abs_err"] = max_err
    return report


# ---------------------------------------------------------------------------
# w8a16 GEMM

# kernel vs plain (f32 product with the reference's rounding emulated), per
# element: |got - want| <= atol_rel * rms(want) + rtol * |want|. bf16
# outputs: the f32 sums of kernel and plain (another order) can round to
# neighbouring bf16 values, and the product with the bf16 scale rounds
# again: two bf16 steps, 2**-6 of |want|. f32 outputs: the two summation
# orders differ by ~1e-6 of the output's scale. A scale off by 5% on one
# channel and one zeroed k row of the weight must fail both.
W8A16_BF16_TOL = (1e-4, 2.0 ** -6)
W8A16_F32_TOL = (1e-4, 1e-4)
# L2 is 50 MB: timed calls cycle over copies of the weight summing to
# at least this, so each call streams its weight from device memory as a
# layer's weight does in a decode step
COLD_BYTES = 200 * 2**20


def w8a16_want(x, q, s, out_dtype, layout):
    """The plain version on the card, in f32 with the reference's
    rounding: the f32-accumulated product (no TF32), then for a bf16
    layer product bf16(bf16(acc) * bf16(s)), else acc * s."""
    w = q.float() if layout == "kn" else q.float().t()
    acc = x.float() @ w
    if out_dtype == torch.bfloat16:
        return (acc.to(torch.bfloat16).float()
                * s.to(torch.bfloat16).float()).to(torch.bfloat16)
    return acc * s


def w8a16_excess(got, want):
    atol_rel, rtol = (W8A16_BF16_TOL if want.dtype == torch.bfloat16
                      else W8A16_F32_TOL)
    want = want.float()
    rms = want.pow(2).mean().sqrt().item()
    return ((got.float() - want).abs()
            / (atol_rel * rms + rtol * want.abs())).max().item()


def w8a16_bound_ms(M, N, K, x_bytes, out_bytes):
    """Least time of one call: the int8 weight, x and s read once and y
    written once over HBM3's rate, against 2MNK operations at the bf16
    tensor-core rate (f32 x: the f32 rate)."""
    nbytes = K * N + M * K * x_bytes + 4 * N + M * N * out_bytes
    peak = H100_BF16_FLOPS if x_bytes == 2 else H100_F32_FLOPS
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, 2.0 * M * N * K / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# the 8B layer products' widths: a decode step (1, 8, 32) and prefill
# rows (the serve's groups run 128..2048; 200 is ragged; 4096 a chunk at
# the largest bucket)
W8A16_LAYER_M = (1, 8, 32, 64, 128, 136, 200, 512, 1024, 2048, 4096)
W8A16_8B_LAYERS = (("wq/wo", 4096, 4096), ("wk/wv", 4096, 1024),
                   ("wg/wu", 4096, 14336), ("wd", 14336, 4096))
# products a layer of each shape
W8A16_PER_LAYER = {"8b wq/wo": 2, "8b wk/wv": 2, "8b wg/wu": 2, "8b wd": 1}
# a MoE expert's products at the 8B's width (the moe phases): the
# replayed decode's M = groups x C = 16 rows an expert (8 slots, top-2,
# dropless), and two ragged kept counts of the grouped prefill, one below
# w8a16.WGMMA_MIN_M (the mma kernel) and one above it (wgmma)
W8A16_MOE_M = (13, 16, 117)
W8A16_MOE_LAYERS = (("wg/wu", 4096, 14336), ("wd", 14336, 4096))


def w8a16_cases():
    """(label, M, K, N, layout, x dtype, out dtype): every Llama-3.1-8B
    layer weight shape at each M of ``W8A16_LAYER_M`` in bf16 (M >=
    w8a16.WGMMA_MIN_M runs the wgmma kernel, below it the mma kernel); the
    lm_head's f32 logits at M = 1, 8, 32, 40 (a speculative verify of 8
    slots at K = 4), 136 (a tree verify of 8 slots at the auto budget of
    17 nodes) and 1024; a MoE expert's products at the 8B's width at each
    M of ``W8A16_MOE_M``; the Llama-3.2-1B tied
    logits (the embedding [V, H] read as "nk") at M = 8; the tiny model's
    shapes in f32 (both layouts) and in bf16 (tails narrower than a
    128-channel tile)."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for M in W8A16_LAYER_M:
        for name, K, N in W8A16_8B_LAYERS:
            cases.append((f"8b {name}", M, K, N, "kn", bf, bf))
        if M in (1, 8, 32, 1024):
            cases.append(("8b lm_head", M, 4096, 128256, "kn", bf, f32))
    # a speculative verify's logits: B x (K+1) = 8 x 5 rows, and a tree
    # verify's at the auto budget, 8 x (1 + 4 x 4) = 136 (its layer
    # products are W8A16_LAYER_M's 136)
    cases.append(("8b lm_head", 40, 4096, 128256, "kn", bf, f32))
    cases.append(("8b lm_head", 136, 4096, 128256, "kn", bf, f32))
    cases.append(("1b tied logits", 8, 2048, 128256, "nk", bf, f32))
    for M in W8A16_MOE_M:
        for name, K, N in W8A16_MOE_LAYERS:
            cases.append((f"moe {name}", M, K, N, "kn", bf, bf))
    for M in (4, 37):
        for name, K, N in (("wq", 64, 64), ("wk", 64, 32), ("wg", 64, 128),
                           ("wd", 128, 64), ("lm_head", 64, 256)):
            cases.append((f"tiny {name}", M, K, N, "kn", f32, f32))
        cases.append(("tiny tied logits", M, 64, 256, "nk", f32, f32))
        cases.append(("tiny wk bf16", M, 64, 32, "kn", bf, bf))
        cases.append(("tiny lm_head bf16", M, 64, 256, "kn", bf, f32))
    return cases


def int8pack_ms(x, q, s, odt, layout):
    """One PyTorch call of the same function (``torch._weight_int8pack_mm``:
    x @ (q * s) with q as [N, K]) timed over cold weights, or None where
    it does not run on CUDA for these inputs. Timed only: the port never
    calls it."""
    if layout != "kn" or odt != torch.bfloat16:
        return None
    qt = q.t().contiguous()
    sb = s.to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, qt, sb)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"kernel w8a16_gemm: torch._weight_int8pack_mm does not run on "
            f"CUDA here ({type(e).__name__}: {str(e).splitlines()[0][:120]})")
        return None
    copies = max(1, -(-COLD_BYTES // qt.numel()))
    qts = [qt] + [qt.clone() for _ in range(copies - 1)]
    # a few calls: it runs 10-1000x the kernel's time
    return cuda_time_ms(lambda i: torch._weight_int8pack_mm(
        x, qts[i % copies], sb), iters=5, warmup=1)


def check_w8a16():
    """The w8a16 kernels against their plain version on the card at every
    case of ``w8a16_cases``, with both controls failing; at the bf16
    8B/1B cases the time (over cold weights) beside the bound, the plain
    version's and cuBLAS's over a bf16 weight of the same shape (what
    dense serving pays), and ``torch._weight_int8pack_mm``'s where it
    runs on CUDA.
    Returns the kernels-line figures: sums over the 225 products of one
    Llama-3.1-8B decode step (M = 8: 32 layers x 7 + the lm_head), one
    layer's 7 products at each M of the wgmma route, one MoE layer's 24
    expert products at M = 16, and every timed shape."""
    from dynamo_tpu_torch.ops import w8a16

    g = torch.Generator(device="cuda").manual_seed(SEED)
    shapes, max_err = [], 0.0
    tiny = [0, 0.0]  # tiny cases checked, their largest excess
    pack_runs = True  # torch._weight_int8pack_mm, until it fails once
    # no fallback: a dtype the kernel lacks raises on the card
    try:
        w8a16.w8a16_matmul(torch.ones(8, 64, dtype=torch.float16,
                                      device="cuda"),
                           {"q": torch.ones(64, 64, dtype=torch.int8,
                                            device="cuda"),
                            "s": torch.ones(64, device="cuda")},
                           torch.float16)
        raise AssertionError("w8a16: an fp16 x did not raise")
    except ValueError:
        pass
    for br in (128, 256):
        if w8a16.kernel_smem(br) != w8a16.wgmma_smem_bytes(br):
            raise AssertionError(
                f"w8a16 wgmma BR={br}: the library's shared memory "
                f"{w8a16.kernel_smem(br)} != the wrapper's "
                f"{w8a16.wgmma_smem_bytes(br)}")
    for label, M, K, N, layout, xdt, odt in w8a16_cases():
        x = torch.randn(M, K, generator=g, device="cuda").to(xdt)
        qshape = (K, N) if layout == "kn" else (N, K)
        q = torch.randint(-127, 128, qshape, generator=g, device="cuda",
                          dtype=torch.int8)
        s = (torch.rand(N, generator=g, device="cuda") + 0.5) / (73.3 * K ** 0.5)
        w = {"q": q, "s": s}
        kind, kplan = w8a16.route(M, N, K, layout, xdt, odt,
                                  w8a16.card_clusters(x.device))
        wg0 = w8a16.launches_wgmma
        got = w8a16.w8a16_matmul(x, w, odt, layout)
        torch.cuda.synchronize()
        if w8a16.launches_wgmma - wg0 != (kind == "wgmma"):
            raise AssertionError(f"w8a16 {label} M={M}: routed {kind}, the "
                                 f"wgmma count moved by "
                                 f"{w8a16.launches_wgmma - wg0}")
        want = w8a16_want(x, q, s, odt, layout)
        if got.dtype != odt or got.shape != (M, N) or not torch.isfinite(
                got).all():
            raise AssertionError(f"w8a16 {label} M={M}: {got.dtype} "
                                 f"{tuple(got.shape)}, finite "
                                 f"{bool(torch.isfinite(got).all())}")
        excess = w8a16_excess(got, want)
        err = (got.float() - want.float()).abs().max().item()
        if not excess <= 1.0:
            raise AssertionError(
                f"w8a16 {label} M={M} ({kind} {kplan}, {layout}, x {xdt}, "
                f"out {odt}): |kernel - plain| {err:.3e} exceeds the "
                f"tolerance by a factor {excess:.3f}")
        s_bad = s.clone()
        s_bad[N // 3] *= 1.05
        q_bad = q.clone()
        if layout == "kn":
            q_bad[K // 2] = 0
        else:
            q_bad[:, K // 2] = 0
        controls = {"one channel's scale x1.05": (q, s_bad),
                    "one k row zeroed": (q_bad, s)}
        for bad, (qc, sc) in controls.items():
            if w8a16_excess(w8a16_want(x, qc, sc, odt, layout), want) <= 1.0:
                raise AssertionError(f"w8a16 {label} M={M}: the tolerance "
                                     f"cannot tell {bad}")
        del q_bad, s_bad, controls
        if xdt == torch.bfloat16:
            max_err = max(max_err, err)
        if label.startswith("tiny"):
            tiny = [tiny[0] + 1, max(tiny[1], excess)]
            del x, q, s, w, got, want
            continue
        # the 8B and 1B cases (bf16): timed
        copies = max(1, -(-COLD_BYTES // (K * N)))
        qs = [q] + [q.clone() for _ in range(copies - 1)]
        ms = cuda_time_ms(lambda i: w8a16.w8a16_matmul(
            x, {"q": qs[i % copies], "s": s}, odt, layout), iters=50)
        del qs
        plain_ms = cuda_time_ms(lambda i: w8a16.w8a16_matmul_plain(
            x, q, s, odt, layout), iters=5, warmup=1)
        wb = (q.float() * s[:, None] if layout == "nk"
              else q.float() * s).to(torch.bfloat16)
        copies_b = max(1, -(-COLD_BYTES // (2 * K * N)))
        wbs = [wb] + [wb.clone() for _ in range(copies_b - 1)]
        # cuBLAS over a bf16 weight of this shape, the same layout
        # (the tied logits read the [V, H] table transposed)
        lib_ms = cuda_time_ms(lambda i: torch.matmul(
            x, wbs[i % copies_b] if layout == "kn"
            else wbs[i % copies_b].t()), iters=50)
        del wb, wbs
        pack_ms = int8pack_ms(x, q, s, odt, layout) if pack_runs else None
        if pack_ms is None and layout == "kn" and odt == torch.bfloat16:
            pack_runs = False
        bound, by = w8a16_bound_ms(M, N, K, 2, odt.itemsize)
        tc_ms = 2.0 * M * N * K / H100_BF16_FLOPS * 1e3
        shapes.append(dict(shape=label, M=M, K=K, N=N, kernel=kind,
                           plan=list(kplan), ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=by, tc_bound_ms=tc_ms,
                           library_ms=lib_ms, int8pack_ms=pack_ms))
        extra = (f"; _weight_int8pack_mm {pack_ms:.4f} ms"
                 if pack_ms is not None else "")
        log(f"kernel w8a16_gemm {label} M={M} K={K} N={N} ({layout}, out "
            f"{str(odt)[6:]}, {kind} {kplan}): agrees with plain, at "
            f"{excess:.3f} of the tolerance; the controls fail it; "
            f"{ms:.4f} ms/call (plain {plain_ms:.4f} ms, cuBLAS bf16 "
            f"{lib_ms:.4f} ms = {ms / lib_ms:.2f}x, {by} bound "
            f"{bound:.4f} ms, {bound / ms:.2f} of it; tensor-core bound "
            f"{tc_ms:.4f} ms, {tc_ms / ms:.2f} of it){extra}")
        del x, q, s, w, got, want
    torch.cuda.empty_cache()
    log(f"kernel w8a16_gemm tiny shapes: {tiny[0]} cases (M = 4 and 37; "
        f"f32 in both layouts, bf16 narrower than a tile) agree with plain, "
        f"at most {tiny[1]:.3f} of the tolerance; the controls fail each")
    # one 8B decode step's 225 products at M = 8
    per_step = {k: 32 * v for k, v in W8A16_PER_LAYER.items()}
    per_step["8b lm_head"] = 1
    step = {k: sum(r[k] * per_step[r["shape"]] for r in shapes
                   if r["M"] == 8 and r["shape"] in per_step)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    log(f"kernel w8a16_gemm: one Llama-3.1-8B decode step's 225 products at "
        f"M = 8: {step['ms']:.4f} ms (bytes bound {step['bound_ms']:.4f} ms; "
        f"cuBLAS over bf16 weights {step['library_ms']:.4f} ms; plain "
        f"{step['plain_ms']:.4f} ms)")
    # one MoE layer's 24 expert products of a replayed decode step (M = 16:
    # wg, wu and wd of each of 8 experts)
    moe = {k: sum(r[k] * (2 if r["shape"] == "moe wg/wu" else 1) * 8
                  for r in shapes if r["M"] == 16
                  and r["shape"].startswith("moe "))
           for k in ("ms", "bound_ms", "library_ms")}
    log(f"kernel w8a16_gemm: one MoE layer's 24 expert products at the 8B's "
        f"width, M = 16: {moe['ms']:.4f} ms (bytes bound "
        f"{moe['bound_ms']:.4f} ms, {moe['bound_ms'] / moe['ms']:.2f} of it; "
        f"cuBLAS over bf16 weights {moe['library_ms']:.4f} ms)")
    # one layer's 7 prefill products at each M of the wgmma route
    prefill = {}
    for M in W8A16_LAYER_M:
        rows = [r for r in shapes if r["M"] == M
                and r["shape"] in W8A16_PER_LAYER]
        if not rows or rows[0]["kernel"] != "wgmma":
            continue
        layer = {k: sum(r[k] * W8A16_PER_LAYER[r["shape"]] for r in rows)
                 for k in ("ms", "tc_bound_ms", "library_ms")}
        prefill[M] = layer
        log(f"kernel w8a16_gemm: one Llama-3.1-8B layer's 7 products at "
            f"M = {M}: {layer['ms']:.4f} ms (tensor-core bound "
            f"{layer['tc_bound_ms']:.4f} ms, {layer['tc_bound_ms'] / layer['ms']:.2f} "
            f"of it; cuBLAS over bf16 weights {layer['library_ms']:.4f} ms, "
            f"{layer['ms'] / layer['library_ms']:.2f}x)")
    # every timed shape, as one line of the log (summary_block leaves
    # "shapes" out of the kernels line)
    log("kernel w8a16_gemm shapes: " + json.dumps(sig4(shapes)))
    return dict(step, bound_by="bytes", max_abs_err=max_err,
                prefill_layer=prefill, moe_layer_m16=moe, shapes=shapes)


def check_logits_f32():
    """A dense bf16 model's logits product (llama.matmul_f32, the f32
    cuBLAS product of bf16 operands: the reference's
    preferred_element_type=f32) at the 8B lm_head shape, untied and tied
    (the table transposed): against the f32 product of the widened
    operands, per element 1e-5 of the logits' scale."""
    from dynamo_tpu_torch.models import llama

    g = torch.Generator(device="cuda").manual_seed(SEED)
    h = torch.randn(8, 4096, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(4096, 128256, generator=g, device="cuda")
         * 0.02).to(torch.bfloat16)
    for label, wt in (("untied", w), ("tied", w.t().contiguous().t())):
        got = llama.matmul_f32(h, wt)
        want = h.float() @ wt.float()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if got.dtype != torch.float32 or not err <= 1e-5 * scale:
            raise AssertionError(f"logits f32 {label}: {got.dtype}, |got - "
                                 f"want| {err:.3e} against {scale:.3e}")
        ms = cuda_time_ms(lambda i: llama.matmul_f32(h, wt), iters=20)
        log(f"logits f32 ({label}, 8B lm_head, aten::mm.dtype): equals the "
            f"f32 product within {err / scale:.2e} of max |logit|; "
            f"{ms:.4f} ms/call")


# ---------------------------------------------------------------------------
# engine

async def generate_all(engine, prompts, max_tokens, logprobs=None,
                       adapters=None, progress=None, **sampling):
    """Each prompt as a request, all at once; per request (tokens, finish
    reason, final annotations, inter-token gaps, top logprobs). With
    ``adapters`` (an adapter id a prompt), each request carries its id
    and, for a variant, the variant's model name (its prefix-cache salt:
    "base:v<id>"), as a registered variant's chain stamps them. With
    ``progress`` (a list, one entry a prompt), each request's entry holds
    its count of tokens received so far."""
    from dynamo_tpu_torch.protocols.common import (
        OutputOptions,
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    ids = adapters or [0] * len(prompts)

    async def one(i, p, aid):
        req = PreprocessedRequest(
            token_ids=list(p),
            stop_conditions=StopConditions(max_tokens=max_tokens,
                                           ignore_eos=True),
            sampling_options=SamplingOptions(**sampling),
            output_options=OutputOptions(logprobs=logprobs),
            adapter_id=aid, model=f"base:v{aid}" if aid else "")
        toks, ann, finish, gaps, top = [], {}, None, [], []
        last = None
        async for out in engine.generate(req):
            now = time.monotonic()
            if last is not None and out.token_ids:
                # a round's tokens arrive together: spread the gap over them
                gaps += [(now - last) / len(out.token_ids)] * len(out.token_ids)
            if out.token_ids:
                last = now
            toks.extend(out.token_ids)
            if progress is not None:
                progress[i] = len(toks)
            top.extend(out.top_logprobs or [])
            if out.finish_reason is not None:
                finish, ann = out.finish_reason.value, out.annotations
        return toks, finish, ann, gaps, top

    return await asyncio.gather(*[one(i, p, a) for i, (p, a)
                                  in enumerate(zip(prompts, ids))])


def w8a16_step_gemms(cfg) -> int:
    """The w8a16 kernel's launches a decode step: each layer's products
    (q, k, v, o, gate, up, down: 7; a MoE layer's q, k, v, o and one
    gate, up and down an expert: 4 + 3E, its router staying a dense
    product) and the logits."""
    per_layer = 7 if cfg.moe is None else (
        4 + 3 * cfg.moe_dict["num_experts"])
    return per_layer * cfg.num_layers + 1


def gemm_formula(cfg) -> str:
    """w8a16_step_gemms as printed: "(7 x 32 + 1)", "((4 + 3 x 8) x 32 +
    1)"."""
    per_layer = "7" if cfg.moe is None else (
        f"(4 + 3 x {cfg.moe_dict['num_experts']})")
    return f"({per_layer} x {cfg.num_layers} + 1)"


def check_replayed(eng, what):
    """Every decode round and state patch ``eng`` ran on the card was a
    CUDA graph replay (the engine issues no eager round there)."""
    dc = eng.dispatch_counts
    programs = dc["round"] + dc["round_seal"] + dc["patch"]
    if not programs or eng.graphs.replays != programs:
        raise AssertionError(
            f"{what}: {eng.graphs.replays} graph replays for {programs} "
            f"rounds and patches")


def check_tiny_engine(moe=False):
    """Greedy tokens of the tiny model on the card (flash-decode kernel,
    hd 16 f32) vs on the CPU (plain version); with ``moe``, of tiny_moe
    (8 experts, top-2, dropless: the dense-dispatch FFN inside the
    replayed rounds, the grouped one in the eager prefill)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd

    cfg = (ModelConfig.tiny_moe if moe else ModelConfig.tiny)(
        dtype="float32")
    label = "tiny moe" if moe else "tiny"
    ecfg = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
                max_decode_slots=4, prefill_buckets=(32, 64),
                cache_dtype="float32")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (29, 40, 17, 100)]
    params = llama.init_params(cfg, SEED, device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = TorchEngine(cfg, EngineConfig(**ecfg),
                          params=to_device(params, dev), device=dev)
        if dev == "cuda":
            fd.executed(eng.device, reset=True)

        async def drive():
            res = await generate_all(eng, prompts, 12)
            res.append((await generate_all(eng, prompts[:1], 12))[0])
            await eng.stop()
            return res

        outs[dev] = [(t, f) for t, f, *_ in asyncio.run(drive())]
        if dev == "cuda":
            dense, int8 = fd.executed(eng.device)
            if not dense or int8 or eng.kernel_launches != dense:
                raise AssertionError(
                    f"{label} engine on cuda: the kernel ran {dense} times, "
                    f"int8 {int8}, graphs recorded {eng.kernel_launches}")
            check_replayed(eng, label)
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(
            f"{label} engine: cuda {outs['cuda']} != cpu {outs['cpu']}")
    log(f"{label}: cuda engine greedy-identical to cpu engine over "
        f"{len(outs['cpu'])} requests")


def check_tiny_lora():
    """The tiny model (f32) with a resident LoRA bank (4 rows at rank 4;
    rows 1 and 2 from random_adapter, scale 0.5) on the card vs on the
    CPU: a burst with mixed adapter ids 0, 1, 2, 1 in one batch, then
    variant 1's prompt again (its own prefix hit), greedy
    token-identical; the card's rounds are graph replays running the
    dense kernel on every layer of every step."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.tenancy.adapters import random_adapter

    cfg = ModelConfig.tiny(dtype="float32")
    ecfg = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
                max_decode_slots=4, prefill_buckets=(32, 64),
                cache_dtype="float32", lora_adapters=4, lora_rank=4)
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (29, 40, 17, 100)]
    ids = [0, 1, 2, 1]
    params = llama.init_params(cfg, SEED, device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = TorchEngine(cfg, EngineConfig(**ecfg),
                          params=to_device(params, dev), device=dev)
        for aid in (1, 2):
            eng.install_adapter(aid, random_adapter(cfg, 4, seed=6 + aid,
                                                    scale=0.5))
        if dev == "cuda":
            fd.executed(eng.device, reset=True)

        async def drive():
            IntakeGate(eng, len(prompts))
            res = await generate_all(eng, prompts, 12, adapters=ids)
            res.append((await generate_all(eng, prompts[1:2], 12,
                                           adapters=[1]))[0])
            await eng.stop()
            return res

        outs[dev] = [(t, f) for t, f, *_ in asyncio.run(drive())]
        if dev == "cuda":
            dense, int8 = fd.executed(eng.device)
            if (dense != cfg.num_layers * eng.step_count or int8
                    or eng.kernel_launches != dense):
                raise AssertionError(
                    f"tiny lora on cuda: the kernel ran {dense} times over "
                    f"{eng.step_count} steps, int8 {int8}, graphs recorded "
                    f"{eng.kernel_launches}")
            check_replayed(eng, "tiny lora")
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError(
            f"tiny lora: cuda {outs['cuda']} != cpu {outs['cpu']}")
    streams = [t for t, _ in outs["cpu"]]
    if len({tuple(streams[i]) for i in range(3)}) != 3 \
            or streams[4] != streams[1]:
        raise AssertionError(f"tiny lora: the variants do not part from the "
                             f"base, or the repeat differs: {streams}")
    figures(f"mixed ids {ids} + a variant repeat: cuda == cpu over "
            f"{len(streams)} requests")
    log(f"tiny lora: cuda engine with a bank greedy-identical to the cpu "
        f"engine over {len(streams)} requests (adapter ids {ids} in one "
        f"burst, then variant 1 again as a prefix hit)")


def check_tiny_int8():
    """The tiny model with int8 KV (page 16, the int8 kernel at hd 16,
    group 16) on the card vs on the CPU: greedy tokens equal except at a
    CPU near-tie, and a seeded temperature-0.8 stream drawn identically
    (threefry on both devices)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd

    cfg = ModelConfig.tiny(dtype="float32")
    ecfg = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
                max_decode_slots=4, prefill_buckets=(32, 64),
                cache_dtype="float32", kv_quant="int8")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (29, 40, 17, 100)]
    params = llama.init_params(cfg, SEED, device="cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = TorchEngine(cfg, EngineConfig(**ecfg),
                          params=to_device(params, dev), device=dev)
        if dev == "cuda":
            fd.executed(eng.device, reset=True)

        async def drive():
            greedy = await generate_all(eng, prompts, 12, logprobs=2)
            greedy.append((await generate_all(eng, prompts[:1], 12,
                                              logprobs=2))[0])
            seeded = (await generate_all(eng, prompts[1:2], 24,
                                         temperature=0.8, seed=7))[0]
            await eng.stop()
            return greedy, seeded

        outs[dev] = asyncio.run(drive())
        if dev == "cuda":
            # the kernel's own count on the card: the rounds are replays
            dense, int8 = fd.executed(eng.device)
            if not int8 or dense or eng.kernel_launches != int8:
                raise AssertionError(
                    f"tiny int8 engine on cuda: int8 kernel ran {int8} "
                    f"times, dense {dense}, graphs recorded "
                    f"{eng.kernel_launches}")
            check_replayed(eng, "tiny int8")
    compared, ties = compare_near_tie("tiny int8", outs["cuda"][0],
                                      outs["cpu"][0], 12)
    seeded = {dev: o[1][0] for dev, o in outs.items()}
    if seeded["cuda"] != seeded["cpu"] or len(seeded["cpu"]) != 24:
        raise AssertionError(f"tiny int8 seeded stream: cuda "
                             f"{seeded['cuda']} != cpu {seeded['cpu']}")
    log(f"tiny int8: cuda engine agrees with cpu engine on {compared} greedy "
        f"positions ({ties} streams stop at a cpu near-tie, gap <= "
        f"{NEAR_TIE}); the seeded temperature-0.8 stream of 24 tokens is "
        f"identical on both devices")


def compare_near_tie(what, cuda_res, cpu_res, n_new):
    """Greedy streams of the card's engine against the CPU engine's (each
    request's ``generate_all`` result with 2 top logprobs): equal, except
    that a stream may leave the CPU one where the CPU's top-2 logprob gap
    is at most NEAR_TIE. Returns (positions compared, streams stopped at
    a near-tie)."""
    compared = ties = 0
    for (tc, *_), (tg, fg, _, _, top) in zip(cuda_res, cpu_res):
        if fg != "length" or len(tg) != n_new or len(tc) != n_new:
            raise AssertionError(f"{what}: {len(tc)}/{len(tg)} tokens, "
                                 f"finish {fg}")
        for j, (a, b) in enumerate(zip(tc, tg)):
            if a != b:
                gap = top[j][0][1] - top[j][1][1]
                if gap > NEAR_TIE:
                    raise AssertionError(
                        f"{what}: cuda token {a} != cpu token {b} at "
                        f"step {j}, cpu top-2 gap {gap:.4f} > {NEAR_TIE}")
                ties += 1
                break  # past a divergence the streams are not comparable
            compared += 1
    return compared, ties


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def check_tiny_w8a16(moe=False):
    """The tiny model with w8a16 weights (f32: the FMA instantiation of
    the w8a16 kernel, both of its uses: the layer products and the
    logits) on the card vs on the CPU (the plain version): greedy tokens
    equal except at a CPU near-tie. On the card every decode step runs
    the w8a16 kernel 7 times a layer and once for the logits inside the
    replayed rounds, and the prefill launches it eagerly; the kernel's
    own count must equal the two. With ``moe``, tiny_moe's w8a16 expert
    stacks: 4 + 3 x 8 products a layer (w8a16_step_gemms)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import w8a16

    cfg = (ModelConfig.tiny_moe if moe else ModelConfig.tiny)(
        quant="int8", dtype="float32")
    label = "tiny moe w8a16" if moe else "tiny w8a16"
    ecfg = dict(num_pages=64, page_size=16, max_pages_per_seq=8,
                max_decode_slots=4, prefill_buckets=(32, 64),
                cache_dtype="float32")
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, 256, size=n).tolist() for n in (29, 40, 17, 100)]
    params = llama.init_params(cfg, SEED, device="cpu")
    outs, note = {}, ""
    for dev in ("cpu", "cuda"):
        eng = TorchEngine(cfg, EngineConfig(**ecfg),
                          params=to_device(params, dev), device=dev)
        if dev == "cuda":
            w8a16.launches = 0
            w8a16.executed(eng.device, reset=True)

        async def drive():
            res = await generate_all(eng, prompts, 12, logprobs=2)
            res.append((await generate_all(eng, prompts[:1], 12,
                                           logprobs=2))[0])
            await eng.stop()
            return res

        outs[dev] = asyncio.run(drive())
        if dev == "cuda":
            ran = w8a16.executed(eng.device)
            replayed, eager = eng.graphs.w8a16_replayed, w8a16.launches
            want = w8a16_step_gemms(cfg) * eng.step_count
            if replayed != want or not eager or ran != replayed + eager:
                raise AssertionError(
                    f"{label} on cuda: the kernel ran {ran} times, the "
                    f"graphs recorded {replayed} over {eng.step_count} steps "
                    f"(want {want}), the prefill launched {eager}")
            check_replayed(eng, label)
            note = (f"; on the card w8a16_gemm ran {ran} times ({replayed} "
                    f"in replayed rounds = {gemm_formula(cfg)} x "
                    f"{eng.step_count} steps, {eager} in the eager prefill)")
    compared, ties = compare_near_tie(label, outs["cuda"], outs["cpu"], 12)
    log(f"{label}: cuda engine agrees with cpu engine on {compared} "
        f"greedy positions ({ties} streams stop at a cpu near-tie, gap <= "
        f"{NEAR_TIE}){note}")


def check_round_graph(label, cfg, ecfg, params, prompts, adapters=None):
    """An engine on the card admits ``prompts``; then one decode round
    replayed from its CUDA graph must give the tokens (and the state) of
    the same round run eagerly on a clone of the same device state,
    greedy and with logprobs; then torch.profiler counts the CUDA runtime
    calls of one steady pipelined round and the flash-decode kernels
    inside its replay (and, for w8a16 weights, the w8a16 GEMM kernels:
    7 a layer and the logits, a step). With ``adapters`` ((the factors by
    adapter id, an adapter id a prompt); ``ecfg`` with a bank), the
    variants are installed and each prompt carries its id: the round runs
    mixed adapters. Round attribution (prof_attribution, on by default)
    stays on: the profiled round is attributed, its segments summing to
    its wall time, and still costs one graph launch."""
    from dynamo_tpu_torch.engine import graphs as eg
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.ops import w8a16
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        StopConditions,
    )

    eng = TorchEngine(cfg, ecfg, params=params, device="cuda")
    ids = [0] * len(prompts)
    if adapters is not None:
        factors, ids = adapters
        for aid, w in factors.items():
            eng.install_adapter(aid, w)
    # no engine loop: this thread runs the engine's steps one at a time
    # (every graph was captured with the engine)
    eng._started = True
    g = eng.graphs
    B, F = ecfg.max_decode_slots, ecfg.flush_every
    ran = [0, 0]  # the kernel's own count over the profiled round
    ran_w8 = [0]  # the w8a16 kernel's own count over it
    quant_w = cfg.quant == "int8"

    async def consume(p, aid):
        req = PreprocessedRequest(
            token_ids=list(p), adapter_id=aid,
            stop_conditions=StopConditions(max_tokens=64, ignore_eos=True))
        async for _ in eng.generate(req):
            pass

    def compare(want_lp):
        ctx = {k: v.clone() for k, v in eng.ctx.items()}
        ring = {k: v.clone() for k, v in eng.ring.items()}
        dev = {k: v.clone() for k, v in eng._dev.items()}
        out = {k: v.clone() for k, v in g.out.items()}
        eg.run_round(cfg, ecfg, eng.params, ctx, ring, eng.cache, dev, out,
                     False, want_lp)
        g.round(False, want_lp, None)
        torch.cuda.synchronize()
        if not torch.equal(out["toks"], g.out["toks"]):
            raise AssertionError(
                f"round_graph {label}: replayed tokens {g.out['toks']} != "
                f"eager {out['toks']}")
        def live(t):  # the slots' own lanes, not the scratch lane
            return t[:, :, :B] if t.dim() == 5 else t[:, :B]

        same = all(torch.equal(dev[k], eng._dev[k]) for k in dev) and all(
            torch.equal(live(ctx[k]), live(eng.ctx[k])) for k in ctx)
        if not same:
            raise AssertionError(f"round_graph {label}: the replayed round "
                                 f"left another state than the eager one")
        return ((out["lp"] - g.out["lp"]).abs().max().item()
                if want_lp else None)

    async def drive():
        tasks = [asyncio.ensure_future(consume(p, a))
                 for p, a in zip(prompts, ids)]
        while eng._intake.qsize() < len(prompts):
            await asyncio.sleep(0)
        eng._drain_intake()
        for _ in range(200):
            if not (eng._waiting or eng._prefilling):
                break
            eng._admit()
        eng._flush_seals()
        if int(eng._slot_active.sum()) != len(prompts):
            raise AssertionError(f"round_graph {label}: prompts not admitted")
        compare(False)
        lp_diff = compare(True)
        # steady pipelined rounds through the engine's own round
        for _ in range(3):
            eng._round()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        dispatched = eng.pipeline_stats()["pipelined_dispatches"]
        fd.executed(eng.device, reset=True)
        if quant_w:
            w8a16.executed(eng.device, reset=True)
        with torch.profiler.profile(activities=acts) as prof:
            eng._round()
            torch.cuda.synchronize()
        ran[:] = fd.executed(eng.device)
        if quant_w:
            ran_w8[0] = w8a16.executed(eng.device)
        if eng.pipeline_stats()["pipelined_dispatches"] != dispatched + 1:
            raise AssertionError(f"round_graph {label}: the profiled round "
                                 f"was not dispatched early")
        for t in tasks:
            t.cancel()
        return lp_diff, prof

    lp_diff, prof = asyncio.run(drive())
    runtime: dict[str, int] = defaultdict(int)
    device: dict[str, int] = defaultdict(int)   # every kernel, by name
    kernels = gemms = 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device[evt.key[:72]] += evt.count
            if "flash_decode" in evt.key and "combine" not in evt.key:
                kernels += evt.count
            if "w8a16_gemm" in evt.key:
                gemms += evt.count
        elif evt.key.startswith("cuda"):
            runtime[evt.key] += evt.count
    graph_launches = sum(n for k, n in runtime.items() if "GraphLaunch" in k)
    host_kernels = sum(n for k, n in runtime.items() if "LaunchKernel" in k)
    _, wall, acc = eng.prof.recent(1)[0] if eng.prof.recent(1) else \
        (0, 0.0, [0.0])
    if not eng.prof.enabled or not wall or abs(sum(acc) / wall - 1) > 0.02:
        raise AssertionError(f"round_graph {label}: attribution on "
                             f"{eng.prof.enabled}, the profiled round's "
                             f"segments {sum(acc)} s of {wall} s")
    copies = sum(n for k, n in runtime.items() if "Memcpy" in k)
    want_kernels = cfg.num_layers * F
    want_gemms = w8a16_step_gemms(cfg) * F if quant_w else 0
    log(f"round_graph {label}: replayed round == eager round (tokens and "
        f"state, greedy and with logprobs"
        + (f", adapter ids {ids} in one round" if adapters else "")
        + f"; largest logprob difference "
        f"{lp_diff:.3e}); one steady pipelined round: {graph_launches} graph "
        f"launch, {host_kernels} kernels launched from the host, {copies} "
        f"copies (round attribution on: the round's segments "
        f"{sum(acc) / wall:.4f} of its {wall * 1e3:.3f} ms), {kernels} "
        f"flash-decode kernels in the replay "
        f"({cfg.num_layers} layers x {F} steps = {want_kernels}; the "
        f"kernel's own count on the card {sum(ran)})"
        + (f", {gemms} w8a16_gemm kernels in the replay ("
           f"{gemm_formula(cfg)} x {F} = {want_gemms}; the kernel's own "
           f"count {ran_w8[0]})" if quant_w else "")
        + f"; runtime calls {dict(sorted(runtime.items()))}")
    log(f"round_graph {label}: captures " + ", ".join(
        f"{k} {t:.3f} s ({g.recorded[k]} flash-decode"
        + (f", {g.recorded_w8a16[k]} w8a16_gemm" if quant_w else "")
        + " launches recorded)" for k, t in g.capture_s.items())
        + f"; graph pool {g.pool_bytes / 2**20:.1f} MiB")
    if (graph_launches != 1 or host_kernels or kernels != want_kernels
            or sum(ran) != want_kernels or gemms != want_gemms
            or ran_w8[0] != want_gemms):
        raise AssertionError(
            f"round_graph {label}: a steady round must be one graph launch "
            f"with {want_kernels} flash-decode and {want_gemms} w8a16_gemm "
            f"kernels inside and no kernel launched from the host; the "
            f"profile's {sum(device.values())} device kernels by name: "
            f"{dict(sorted(device.items()))}")
    del eng, g
    gc.collect()
    torch.cuda.empty_cache()


def time_block_hashes(prompts, page):
    """The router's block hashing (the port's own XXH3-64) on this
    machine's host: microseconds per block of ``page`` tokens."""
    from dynamo_tpu_torch.tokens import compute_block_hashes

    reps = 20
    n = reps * sum(len(p) // page for p in prompts)
    t0 = time.perf_counter()
    for _ in range(reps):
        for p in prompts:
            compute_block_hashes(p, page, "meta-llama/Llama-3.1-8B")
    us = (time.perf_counter() - t0) / n * 1e6
    log(f"host: block hash (xxh3_64, page {page} = {8 + 4 * page} bytes) "
        f"{us:.1f} us per block over {n} blocks")


class IntakeGate:
    """Holds an engine's intake (or the intakes of several engines, as
    one) until ``n`` requests wait in it. A burst's prefill groups (and
    with them the prefill numerics: a group of one takes another path
    than a batch) then do not depend on when each request arrived, so the
    serve and http phases admit the same prompts in the same order and
    groups, and their greedy tokens can be held equal."""

    def __init__(self, engines, n):
        self.engines = (list(engines) if isinstance(engines, (list, tuple))
                        else [engines])
        self.n, self.open = n, False
        for eng in self.engines:
            eng._drain_intake = self._gated(eng._drain_intake)

    def waiting(self) -> int:
        return sum(e._intake.qsize() for e in self.engines)

    def _gated(self, drain):
        def gated():
            if not self.open:
                if self.waiting() < self.n:
                    return
                self.open = True
            drain()
        return gated


def first_layers(params, n):
    """The first ``n`` layers of a parameter tree, as views (no copy): the
    same model's width at a reduced depth."""
    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        return t[:n]
    return dict(params, layers=cut(params["layers"]))


def weights_gib(params) -> float:
    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        return t.numel() * t.element_size()
    return nbytes(params) / 2**30


class CountReads:
    """While installed, times the MoE grouped path's host reads of its
    kept counts (models/llama.py ``_kept_counts``, one a layer a call):
    their number ``n`` and host seconds ``s``, each read waiting for the
    stream."""

    def __init__(self, llama):
        self.llama, self.read = llama, llama._kept_counts
        self.n, self.s = 0, 0.0

        def timed(*args):
            t0 = time.perf_counter()
            try:
                return self.read(*args)
            finally:
                self.s += time.perf_counter() - t0
                self.n += 1
        llama._kept_counts = timed

    def close(self):
        self.llama._kept_counts = self.read


def serve_llama3_8b(counts, params, kv_quant, dense_tokens=None, cfg=None,
                    tag=None, logprobs=None, time_step=False):
    """The serve burst on Llama-3.1-8B with the given weights and KV mode
    (``cfg``: Llama-3.1-8B, or its w8a16 variant for quantized weights,
    or a MoE model at its width; ``tag`` names the run in the log; each
    request asks for ``logprobs`` top logprobs); returns each request's
    tokens (the burst's 8, then the repeat) and the burst's figures
    (TTFT and gaps in s, decode tok/s, weights GiB, each request's top
    logprobs, the MoE count reads of the prefill; with ``time_step``, a
    replayed decode step's device and wall ms, time_rounds, after the
    counted burst)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.ops import w8a16

    cfg = cfg or ModelConfig.llama3_8b()
    quant = kv_quant == "int8"
    quant_w = cfg.quant == "int8"
    tag = tag or ("w8a16" if quant_w else kv_quant)
    name = "flash_decode_int8" if quant else "flash_decode"
    t0 = time.monotonic()
    eng = TorchEngine(cfg, EngineConfig(kv_quant=kv_quant), params=params,
                      device="cuda")
    torch.cuda.synchronize()
    if quant and not (eng.ctx["k"].dtype == eng.cache["k"].dtype
                      == torch.int8):
        raise AssertionError("int8 engine: ctx or pool is not int8")
    gib = weights_gib(params)
    log(f"serve {tag}: Llama-3.1-8B engine built in "
        f"{time.monotonic() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated, weights "
        f"{gib:.2f} GiB (ctx {eng.ctx['k'].dtype}, pool "
        f"{eng.cache['k'].dtype})")
    prompts = serve_prompts(cfg.vocab_size)
    n_new = 32

    async def drive():
        t_start = time.monotonic()
        res = await generate_all(eng, prompts, n_new, logprobs=logprobs)
        t_batch = time.monotonic() - t_start
        repeat = (await generate_all(eng, prompts[:1], n_new,
                                     logprobs=logprobs))[0]
        await eng.stop()
        return res, repeat, t_batch

    steps0 = eng.step_count
    # every kernel count to 0 just before the main path
    fd.launches = fd.launches_int8 = 0
    eng.kernel_launches = 0
    fd.executed(eng.device, reset=True)
    if quant_w:
        w8a16.launches = w8a16.launches_wgmma = 0
        eng.graphs.w8a16_replayed = 0
        w8a16.executed(eng.device, reset=True)
    IntakeGate(eng, len(prompts))
    reads = CountReads(llama)
    try:
        res, repeat, t_batch = asyncio.run(drive())
    finally:
        reads.close()
    # every round replays a graph captured with the engine, so the
    # wrapper issues nothing here: the kernel counts its executions on the
    # card, and the engine the launches its graphs recorded at capture
    # once a replay (the cross-check)
    ran = fd.executed(eng.device)
    gemms = w8a16.executed(eng.device) if quant_w else 0
    launched, other = (ran[1], ran[0]) if quant else ran
    issued = fd.launches + fd.launches_int8
    if not quant_w:  # the kernels line's launches: the dense-weight runs
        counts[name] = launched
    steps = eng.step_count - steps0
    for toks, finish, *_ in res + [repeat]:
        if len(toks) != n_new or finish != "length":
            raise AssertionError(f"request ended with {len(toks)} tokens, "
                                 f"finish {finish}")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError("token out of the vocabulary")
    cached = repeat[2]["cached_blocks"]
    want_cached = (len(prompts[0]) - 1) // eng.ecfg.page_size
    if cached != want_cached:
        raise AssertionError(f"prefix repeat hit {cached} blocks, "
                             f"expected {want_cached}")
    check_replayed(eng, f"serve {tag}")
    if launched != cfg.num_layers * steps:
        raise AssertionError(
            f"{name} ran {launched} times on the card over {steps} decode "
            f"steps of {cfg.num_layers} layers")
    if eng.kernel_launches != launched or issued:
        raise AssertionError(
            f"serve {tag}: the graphs recorded {eng.kernel_launches} "
            f"launches and the wrapper issued {issued}, the card ran "
            f"{launched}")
    if other:
        raise AssertionError(f"serve {tag}: the other mode's kernel "
                             f"launched {other} times")
    gemm_note = ""
    L = cfg.num_layers
    reads = dict(n=reads.n, s=reads.s)
    if quant_w:
        # decode: w8a16_step_gemms a step, all inside replayed graphs;
        # prefill: the wrapper's eager launches, every layer product of
        # which (every prefill group has >= WGMMA_MIN_M rows) takes the
        # wgmma kernel and each call's logits the mma one; a MoE expert's
        # product takes it only at >= WGMMA_MIN_M kept rows, and each
        # call reads the kept counts once a layer
        replayed, eager = eng.graphs.w8a16_replayed, w8a16.launches
        wg = w8a16.launches_wgmma
        want = w8a16_step_gemms(cfg) * steps
        if replayed != want or not eager or gemms != replayed + eager:
            raise AssertionError(
                f"serve {tag}: w8a16_gemm ran {gemms} times on the card; the "
                f"graphs recorded {replayed} over {steps} decode steps (want "
                f"{want}), the prefill launched {eager}")
        if cfg.moe is None:
            calls = eager - wg
            ok = calls and wg == 7 * L * calls
            want_wg = f"7 x {L} for each of {calls} calls"
        else:
            calls = reads["n"] // L
            ok = (calls and reads["n"] == L * calls and wg >= 4 * L * calls
                  and eager >= wg + calls)
            want_wg = (f"at least 4 x {L} for each of {calls} calls, and "
                       f"their logits and expert products beside them")
        if not ok:
            raise AssertionError(
                f"serve {tag}: the prefill launched {eager} w8a16 products, "
                f"{wg} of them on the wgmma kernel (want {want_wg})")
        counts["w8a16_gemm"] = gemms
        counts["w8a16_gemm_prefill_wgmma"] = wg
        gemm_note = (f"; w8a16_gemm {gemms} (counted by the kernels on the "
                     f"card): {replayed} in the replays = "
                     f"{gemm_formula(cfg)} x {steps} steps, {eager} in "
                     f"the eager prefill of {calls} calls, {wg} of them on "
                     f"the wgmma kernel")
    ttft = [a["timing"]["ttft_s"] for _, _, a, *_ in res]
    e2e = [a["timing"]["e2e_s"] for _, _, a, *_ in res]
    gaps = [g for _, _, _, gs, _ in res for g in gs]
    decode_tokens = sum(len(t) - 1 for t, *_ in res)
    decode_tps = decode_tokens / (max(e2e) - min(ttft))
    log(f"serve {tag}: 8 requests x {n_new} tokens (prompts "
        f"{min(map(len, prompts))}..{max(map(len, prompts))}) in "
        f"{t_batch:.3f} s; TTFT median {np.median(ttft):.4f} s max "
        f"{max(ttft):.4f} s (sorted: "
        f"{', '.join(f'{t:.3f}' for t in sorted(ttft))}); inter-token gap median "
        f"{np.median(gaps) * 1e3:.2f} ms max {max(gaps) * 1e3:.2f} ms (a "
        f"round's gap spread over its tokens); decode {decode_tps:.1f} "
        f"tok/s over the batch (tokens after the first / span from first "
        f"first-token to last finish); {steps} decode steps, {name} "
        f"launches {launched} (counted by the kernel on the card) in "
        f"{eng.graphs.replays} graph replays, {eng.kernel_launches} by the "
        f"graphs' records at capture, {issued} issued eagerly{gemm_note}")
    log(f"serve {tag}: pipeline {eng.pipeline_stats()}; dispatches "
        f"{eng.dispatch_counts}; captures " + ", ".join(
            f"{k} {t:.3f} s" for k, t in eng.graphs.capture_s.items())
        + f"; graph pool {eng.graphs.pool_bytes / 2**20:.1f} MiB")
    log(f"serve {tag}: prefix repeat hit {cached} cached blocks, TTFT "
        f"{repeat[2]['timing']['ttft_s']:.4f} s")
    tokens = [t for t, *_ in res + [repeat]]
    figs = dict(ttft=ttft, gaps=gaps, tps=decode_tps, gib=gib,
                top=[r[4] for r in res + [repeat]], reads=reads,
                steps=steps, launched=launched, gemms=gemms)
    if dense_tokens is not None:
        same = sum(a == b for x, y in zip(tokens, dense_tokens)
                   for a, b in zip(x, y))
        total = sum(len(x) for x in tokens)
        # the step at which each stream first leaves the dense one
        split = [next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                      len(x)) for x, y in zip(tokens, dense_tokens)]
        log(f"serve {tag}: {same}/{total} = {same / total:.4f} of the "
            f"token positions agree with the dense run (greedy, random "
            f"weights: a stream that leaves the dense one at a near-tie "
            f"stays apart); first differing step per request {split} "
            f"({n_new} = never)")
    if time_step:
        figs["step_ms"] = time_rounds(eng, [0] * len(prompts))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return tokens, figs


N_NEW = 32  # tokens a streamed request of the http and distributed phases


async def stream_completion(client, prompt, model, label, **extra):
    """One streamed greedy /v1/completions request of the http,
    distributed and kv router phases (token ids, N_NEW tokens,
    nvext.ignore_eos, and any ``extra`` body fields): its send time, its
    SSE events and each event's arrival time."""
    from dynamo_tpu_torch.protocols.sse import SseDecoder

    t_send = time.monotonic()
    r = await client.request("POST", "/v1/completions", json_body={
        "model": model, "prompt": prompt, "max_tokens": N_NEW,
        "temperature": 0, "stream": True,
        "nvext": {"ignore_eos": True}, **extra}, stream=True)
    if r.status != 200:
        raise AssertionError(f"{label}: status {r.status}")
    dec, events, arrivals = SseDecoder(), [], []
    async for chunk in r.chunks():
        for ev in dec.feed(chunk):
            events.append(ev)
            arrivals.append(time.monotonic())
    return t_send, events, arrivals


async def gated_burst(eng, port, prompts, model, label, **extra):
    """The serve prompts as streamed requests to the HttpService on
    ``port``, sent in prompt order behind an IntakeGate on ``eng`` (an
    engine, or the list of engines a router spreads them over), as the
    serve phase's burst arrived (the last arrival opens the gate, and the
    engine may drain the intake before this loop looks at it); each
    request reaches an intake before the next is sent. Returns each
    request's (send time, events, arrivals)."""
    from dynamo_tpu_torch.frontend.http import HttpClient

    gate = IntakeGate(eng, len(prompts))
    clients = [HttpClient("127.0.0.1", port) for _ in prompts]
    try:
        tasks = []
        for i, (c, p) in enumerate(zip(clients, prompts)):
            tasks.append(asyncio.ensure_future(
                stream_completion(c, p, model, label, **extra)))
            t_wait = time.monotonic()
            while not gate.open and gate.waiting() < i + 1:
                if tasks[-1].done():
                    tasks[-1].result()  # its failure, if it failed
                    raise AssertionError(f"{label}: request {i} ended "
                                         f"before reaching the engine")
                if time.monotonic() - t_wait > 60:
                    raise AssertionError(f"{label}: request {i} did not "
                                         f"reach the engine in 60 s")
                await asyncio.sleep(0.0005)
        return await asyncio.wait_for(asyncio.gather(*tasks), 120)
    finally:
        for c in clients:
            await c.close()


def parse_streams(res, direct_tokens, label):
    """Checks and times a burst's streams: each ends in [DONE] with
    finish_reason length, and its text (one word per token id; ids 0-2
    decode to nothing) maps back to the serve phase's tokens. Returns the
    TTFTs (send to first text), the gaps (between text events, spread
    evenly over the tokens an event carries) and each stream's first and
    last arrival."""
    ttft, gaps, firsts, ends = [], [], [], []
    for i, ((t_send, events, arrivals), want) in enumerate(
            zip(res, direct_tokens)):
        if not events or not events[-1].is_done:
            raise AssertionError(f"{label}: a stream did not end in [DONE]")
        text, last, finish = "", None, None
        for ev, t in zip(events[:-1], arrivals):
            choice = ev.json()["choices"][0]
            finish = choice["finish_reason"] or finish
            piece = choice["text"]
            if not piece:
                continue
            n = len(piece.split())  # one word per token
            if last is None:
                ttft.append(t - t_send)
                firsts.append(t)
            else:
                gaps += [(t - last) / n] * n
            last = t
            text += piece
        if finish != "length":
            raise AssertionError(f"{label}: finish_reason {finish!r}")
        ends.append(arrivals[-1])
        got = [int(w[1:]) for w in text.split()]
        if got != [t for t in want if t > 2]:
            raise AssertionError(
                f"{label}: request {i} streamed {got}, the serve phase's "
                f"generate() gave {want}")
    return ttft, gaps, firsts, ends


class LoopMeter:
    """An event loop thread's host time. ``busy``: the wall time the loop
    spends outside its wait for I/O (each turn of the loop less its time
    in select; waits for the GIL count), at perf_counter's resolution.
    ``cpu``: its thread's CPU clock, whose step on this host
    cpu_clock_step_ms() gives. Made by a coroutine on the loop it
    measures; read() from any thread sees whole turns only."""

    def __init__(self):
        loop = asyncio.get_running_loop()
        self.clock = time.pthread_getcpuclockid(threading.get_ident())
        self.busy = self._wait = 0.0
        selector, run_once = loop._selector, loop._run_once
        select = selector.select

        def timed_select(timeout=None):
            t = time.perf_counter()
            try:
                return select(timeout)
            finally:
                self._wait += time.perf_counter() - t

        def timed_run_once():
            t, self._wait = time.perf_counter(), 0.0
            try:
                run_once()
            finally:
                self.busy += time.perf_counter() - t - self._wait

        selector.select = timed_select
        loop._run_once = timed_run_once

    def read(self):
        """(busy s, CPU s) so far."""
        return self.busy, time.clock_gettime(self.clock)


def cpu_clock_step_ms() -> float:
    """The step of this host's thread CPU clock: spin until it has moved
    twice and return the second move (the first may be partial)."""
    t0 = time.thread_time()
    while (t1 := time.thread_time()) == t0:
        pass
    while (t2 := time.thread_time()) == t1:
        pass
    return (t2 - t1) * 1e3


def record_marks(eng):
    """Wraps ``eng.generate`` to note, by prompt, when each request
    reaches the engine, when its first output reaches the loop that
    called generate(), the engine's own timing annotation and the blocks
    it matched at admission, the router's prefix-hit hint the request
    carried, and the tokens and top logprobs the engine gave."""
    marks: dict[tuple, dict] = {}
    engine_generate = eng.generate

    async def recording_generate(req):
        m = marks[tuple(req.token_ids)] = {
            "in": time.monotonic(), "tokens": [], "top": [],
            "hint": req.estimated_prefix_hit_num_blocks}
        async for out in engine_generate(req):
            if out.token_ids and "first" not in m:
                m["first"] = time.monotonic()
            m["tokens"].extend(out.token_ids)
            m["top"].extend(out.top_logprobs or [])
            if out.finish_reason is not None:
                m["timing"] = out.annotations.get("timing", {})
                m["cached"] = out.annotations.get("cached_blocks")
            yield out

    eng.generate = recording_generate
    return marks


def ttft_split(prompts, res, firsts, marks):
    """Each request's TTFT in three: the client's send to the engine's
    generate() (HTTP, JSON, validation, preprocessing, and any hop), the
    engine's own TTFT (intake to first token, on its thread), and its
    first output to the client's first text (backend, SSE, sockets, the
    loops' turns). Returns a line of medians and maxima."""
    before, engine_ttft, after = [], [], []
    for p, (t_send, _, _), t_first in zip(prompts, res, firsts):
        m = marks[tuple(p)]
        before.append(m["in"] - t_send)
        engine_ttft.append(m["timing"]["ttft_s"])
        after.append(t_first - m["first"])
    return (f"TTFT split, median (max) over the {len(prompts)}: send to "
            f"the engine {np.median(before) * 1e3:.2f} "
            f"({max(before) * 1e3:.2f}) ms, the engine's intake to first "
            f"token {np.median(engine_ttft):.4f} ({max(engine_ttft):.4f}) "
            f"s, first output to the client's first text "
            f"{np.median(after) * 1e3:.2f} ({max(after) * 1e3:.2f}) ms")


def frontend_us_per_token(chain, prompts, streams, reps=3,
                          trace_sample_rate=1.0):
    """The frontend's host time per streamed token: ``streams`` (each
    prompt's tokens) replayed through ``chain``'s preprocessor and backend
    behind an HttpService (tracing ``trace_sample_rate`` of its requests)
    and the port's client, from an engine that only yields them (the
    first token alone, then 4 a round, as the engine emits them); the
    whole burst's wall time over its tokens, median of ``reps``."""
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelChain, ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.protocols.common import FinishReason, LLMEngineOutput

    by_prompt = {tuple(p): s for p, s in zip(prompts, streams)}

    class Replay:
        async def generate(self, req):
            toks = by_prompt[tuple(req.token_ids)]
            for chunk in [toks[:1]] + [toks[i:i + 4]
                                       for i in range(1, len(toks), 4)]:
                await asyncio.sleep(0)
                yield LLMEngineOutput(token_ids=chunk)
            yield LLMEngineOutput(finish_reason=FinishReason.LENGTH)

    manager = ModelManager()
    manager.register(ModelChain(name="replay",
                                preprocessor=chain.preprocessor,
                                engine=Replay(), backend=chain.backend))

    async def burst():
        svc = HttpService(manager, host="127.0.0.1", port=0,
                          trace_sample_rate=trace_sample_rate)
        await svc.start()
        try:
            walls = []
            for _ in range(reps):
                clients = [HttpClient("127.0.0.1", svc.port) for _ in prompts]
                t0 = time.perf_counter()
                await asyncio.gather(*[
                    stream_completion(c, p, "replay", "http replay")
                    for c, p in zip(clients, prompts)])
                walls.append(time.perf_counter() - t0)
                for c in clients:
                    await c.close()
            return float(np.median(walls))
        finally:
            await svc.stop()

    return asyncio.run(burst()) / sum(map(len, streams)) * 1e6


def engine_cpu_s(eng) -> float:
    """The CPU seconds of ``eng``'s loop thread so far."""
    return time.clock_gettime(time.pthread_getcpuclockid(eng._thread.ident))


def decode_rounds(eng) -> int:
    return eng.dispatch_counts["round"] + eng.dispatch_counts["round_seal"]


def prof_switch_us(reps=20000):
    """Round attribution's own host cost a round, on this host: the
    switches a pipelined decode round makes (intake, slot scan, dispatch
    with its seal push, fetch, releases, transfer, offload, admit, slot
    scan, metrics fold) between begin_round and end_round, timed over
    ``reps`` rounds with the profiler enabled and disabled: (on, off) in
    microseconds a round."""
    from dynamo_tpu_torch.telemetry.prof import SEGMENTS, RoundProf

    seq = [SEGMENTS.index(n) for n in (
        "intake", "slot_scan", "dispatch", "fetch", "releases", "transfer",
        "offload", "admit", "slot_scan", "metrics_fold")]
    seal = SEGMENTS.index("seal_assembly")
    out = []
    for enabled in (True, False):
        prof = RoundProf(enabled=enabled)
        t0 = time.perf_counter()
        for _ in range(reps):
            prof.begin_round()
            for seg in seq:
                prof.enter(seg)
                if seg == seq[2]:
                    prof.enter(prof.push(seal))
            prof.end_round()
        out.append((time.perf_counter() - t0) / reps * 1e6)
    return out


def frontend_trace_ids(n):
    """The ids of the last ``n`` completed traces a frontend minted (a
    tokenize span: a worker in this process records its untraced
    requests, a disagg prefill job's among them, in the same store)."""
    from dynamo_tpu_torch.telemetry.trace import TRACES

    ids = []
    for rid in TRACES.recent_ids(TRACES.max_completed):
        tr = TRACES.get(rid)
        if tr is not None and "tokenize" in tr.span_names():
            ids.append(rid)
    return ids[-n:]


async def check_trace_trees(port, ids, label, want_head, n_rounds):
    """Each request's /debug/trace/{id} on the HTTP server at ``port``:
    200, its spans led by ``want_head`` (names), ``n_rounds``
    decode_round spans. Returns the trees."""
    from dynamo_tpu_torch.frontend.http import HttpClient

    trees = []
    async with HttpClient("127.0.0.1", port) as c:
        for rid in ids:
            r = await c.request("GET", f"/debug/trace/{rid}")
            names = [sp["name"] for sp in r.json().get("spans", [])]
            if (r.status != 200 or names[:len(want_head)] != want_head
                    or names.count("decode_round") != n_rounds):
                raise AssertionError(
                    f"{label}: /debug/trace/{rid} answered {r.status} "
                    f"with spans {names}; want {want_head} first and "
                    f"{n_rounds} decode_round spans")
            trees.append(r.json())
    return trees


def round_coverage(eng, since_unix):
    """(min, max) of sum(segments) / wall over the rounds ``eng``
    attributed since ``since_unix``, and their number."""
    covs = [sum(acc) / wall for end, wall, acc in eng.prof.recent(256)
            if end >= since_unix and wall > 0]
    return (min(covs), max(covs), len(covs)) if covs else (0.0, 0.0, 0)


def check_http(params, direct_tokens, direct):
    """The port's entry point at Llama-3.1-8B: launch.run's chain (dense
    KV, default EngineConfig, the serve phase's weights) behind the
    port's HttpService on 127.0.0.1, driven by the port's HTTP client:
    the serve phase's 8 prompts as streamed greedy /v1/completions
    requests (gated_burst, checked by parse_streams: [DONE], finish_reason
    length, the serve phase's tokens), and the kernel's own count on the
    card must rise by layers x decode steps (returned as the launches of
    the http path). A unary chat request runs before the burst, /metrics
    after it. Prints TTFT, gaps and tok/s beside the serve phase's, each
    request's TTFT split at the engine's intake and its first output,
    the event loop's host time per streamed token (LoopMeter: busy and
    CPU; the loop runs service and client), the frontend's host time per
    streamed token (the same streams replayed through the service from
    an engine that only yields them) and DecodeStream's cost per token.

    Telemetry: every burst request's /debug/trace/{id} tree (tokenize,
    queue, prefill, then a decode_round span a round), /debug/prof's
    coverage and every round's within 1 +- 0.02, /debug/flight's ring, an
    OpenMetrics scrape with exemplars, and a Perfetto export of the first
    request that parses. Then the burst once more (the cache cleared)
    with round attribution off and a service that traces no request: the
    engine thread's CPU time a decode round beside the traced burst's,
    the attribution's own cost a round (prof_switch_us), and the
    frontend's host time per streamed token at trace sample rate 1.0 and
    0.0 (the replay)."""
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.launch import run as launch
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.tokenizer import DecodeStream, make_test_tokenizer

    cfg = ModelConfig.llama3_8b()
    # one word per id: a text maps back to its ids (0-2 decode to nothing)
    tok = make_test_tokenizer([f"t{i}" for i in range(3, cfg.vocab_size)])
    args = launch.build_parser().parse_intermixed_args(
        ["in=http", "out=torch", "--model-config", "llama3_8b",
         "--model-name", "llama3_8b"])
    t0 = time.monotonic()
    _, chain = launch.build_chain(args, params=params, tokenizer=tok)
    eng = chain.engine
    log(f"http: launch.run chain built in {time.monotonic() - t0:.1f} s "
        f"(TorchEngine on {eng.device}, kv_quant {eng.ecfg.kv_quant}, "
        f"{eng.ecfg.max_decode_slots} slots)")
    manager = ModelManager()
    manager.register(chain)
    prompts = serve_prompts(cfg.vocab_size)
    marks = record_marks(eng)
    tele: dict = {}

    async def telemetry_reads(port, t_burst):
        """The debug plane after the traced burst (see the docstring)."""
        from dynamo_tpu_torch.tools import trace_export

        t0 = time.monotonic()
        ids = frontend_trace_ids(len(prompts))
        n_rounds = -(-(N_NEW - 1) // eng.ecfg.flush_every)
        trees = await check_trace_trees(
            port, ids, "http", ["tokenize", "queue", "prefill"], n_rounds)
        async with HttpClient("127.0.0.1", port) as c:
            prof = (await c.request("GET", "/debug/prof")).json()
            flight = await c.request("GET", "/debug/flight")
            om = await c.request("GET", "/metrics", headers={
                "Accept": "application/openmetrics-text"})
        cov = prof["engines"]["llama3_8b"]["coverage_ratio"]
        lo, hi, n = round_coverage(eng, t_burst)
        events = flight.json()["engines"]["llama3_8b"]["events"]
        kinds = sorted({e["kind"] for e in events})
        om_text = om.body.decode()
        if (not 0.98 <= cov <= 1.02 or not n or lo < 0.98 or hi > 1.02
                or flight.status != 200 or "round" not in kinds
                or not om_text.endswith("# EOF\n")
                or '# {trace_id="' not in om_text):
            raise AssertionError(
                f"http: /debug/prof coverage {cov}, rounds {lo}..{hi} over "
                f"{n}; /debug/flight {flight.status} kinds {kinds}; "
                f"OpenMetrics exemplars {'# {trace_id=' in om_text}")
        chrome = json.loads(json.dumps(trace_export.build({
            "trace": trees[0], "flight": events,
            "rounds": [[r[0], r[1], list(r[2])]
                       for r in eng.prof.recent(64)]})))
        cats = {e.get("cat") for e in chrome["traceEvents"]}
        if not {"span", "round_segment", "flight"} <= cats:
            raise AssertionError(f"http: the Perfetto export has {cats}")
        tele.update(
            trees=len(trees), spans=[sp["name"] for sp in
                                     trees[0]["spans"]][:4],
            n_rounds=n_rounds, cov=cov, cov_lo=lo, cov_hi=hi, cov_n=n,
            flight=len(events), kinds=kinds,
            perfetto=len(chrome["traceEvents"]),
            secs=time.monotonic() - t0)

    async def untraced_burst(port):
        """The burst again with attribution off, through a service that
        traces no request: the engine thread's CPU seconds and decode
        rounds it took, and the loop's busy seconds."""
        eng.clear_kv_blocks()
        eng.prof.enabled = False
        try:
            cpu0, r0, busy0 = engine_cpu_s(eng), decode_rounds(eng), \
                meter.read()[0]
            res = await gated_burst(eng, port, prompts, "llama3_8b",
                                    "http untraced")
            await settle_engines(eng)
            return (engine_cpu_s(eng) - cpu0, decode_rounds(eng) - r0,
                    meter.read()[0] - busy0, res)
        finally:
            eng.prof.enabled = True

    async def drive():
        nonlocal meter
        svc = HttpService(manager, host="127.0.0.1", port=0,
                          trace_sample_rate=1.0)
        bare = HttpService(manager, host="127.0.0.1", port=0,
                           trace_sample_rate=0.0)
        await svc.start()
        await bare.start()
        meter = LoopMeter()
        try:
            # a unary chat request first: it ends before the counts are
            # zeroed (no round is dispatched once its slot is released)
            async with HttpClient("127.0.0.1", svc.port) as c:
                chat = await c.request("POST", "/v1/chat/completions",
                                       json_body={
                    "model": "llama3_8b", "max_tokens": 4,
                    "messages": [{"role": "user", "content": "t5 t6 t7"}]})
            # every kernel count to 0 just before the main path
            fd.launches = fd.launches_int8 = 0
            eng.kernel_launches = 0
            fd.executed(eng.device, reset=True)
            steps0 = eng.step_count
            host0 = meter.read()
            cpu0, r0, t_burst = engine_cpu_s(eng), decode_rounds(eng), \
                time.time()
            res = await gated_burst(eng, svc.port, prompts, "llama3_8b",
                                    "http")
            host = [b - a for a, b in zip(host0, meter.read())]
            # the counts once the engine is idle (no round in flight)
            await settle_engines(eng)
            torch.cuda.synchronize()
            ran = fd.executed(eng.device)
            steps = eng.step_count - steps0
            # the graphs' record and replays of the counted burst (the
            # untraced burst below adds its own)
            tele["launches"] = eng.kernel_launches
            tele["replays"] = eng.graphs.replays
            tele["on"] = (engine_cpu_s(eng) - cpu0, decode_rounds(eng) - r0,
                          host[0])
            async with HttpClient("127.0.0.1", svc.port) as c:
                metrics = (await c.request("GET", "/metrics")).body.decode()
            await telemetry_reads(svc.port, t_burst)
            t0 = time.monotonic()
            *tele["off"], res_off = await untraced_burst(bare.port)
            for _, events, _ in res_off:
                if not events or not events[-1].is_done:
                    raise AssertionError("http untraced: a stream did not "
                                         "end in [DONE]")
            tele["secs"] += time.monotonic() - t0
            await eng.stop()
            return res, ran, steps, chat, metrics, host
        finally:
            await svc.stop()
            await bare.stop()
            await eng.stop()

    meter = None
    eng.start()
    # a hang here prints every thread's stack and exits, within the
    # script's time limit
    faulthandler.dump_traceback_later(300, exit=True)
    try:
        res, (dense, int8), steps, chat, metrics, host = asyncio.run(drive())
    finally:
        faulthandler.cancel_dump_traceback_later()
    issued = fd.launches + fd.launches_int8
    ttft, gaps, firsts, ends = parse_streams(res, direct_tokens, "http")
    check_replayed(eng, "http")
    if dense != cfg.num_layers * steps or int8 or issued \
            or tele["launches"] != dense:
        raise AssertionError(
            f"http: flash_decode ran {dense} times on the card (int8 "
            f"{int8}, {issued} issued eagerly, graphs recorded "
            f"{tele['launches']}) over {steps} decode steps of "
            f"{cfg.num_layers} layers")
    if chat.status != 200 or not chat.json()["choices"]:
        raise AssertionError(f"http: chat completion status {chat.status}")
    for name in ("ttft", "itl", "e2e"):
        m = re.search(rf"^dynamo_request_{name}_seconds_count (\d+)$",
                      metrics, re.M)
        if not m or int(m.group(1)) == 0:
            raise AssertionError(f"http: /metrics has no {name} series")
    tokens = N_NEW * len(prompts)
    tps = (tokens - len(prompts)) / (max(ends) - min(firsts))
    # the frontend's host time a token traced and untraced, in turns
    # (traced, untraced, untraced, traced), the median of each rate
    t0 = time.monotonic()
    turns: dict[float, list] = {1.0: [], 0.0: []}
    for rate in (1.0, 0.0, 0.0, 1.0):
        turns[rate].append(frontend_us_per_token(
            chain, prompts, direct_tokens, reps=5, trace_sample_rate=rate))
    replay_us = float(np.median(turns[1.0]))
    replay_untraced_us = float(np.median(turns[0.0]))
    switch_on, switch_off = prof_switch_us()
    tele["secs"] += time.monotonic() - t0
    # DecodeStream's cost per token on these streams, this host
    reps, n = 5, 0
    t0 = time.perf_counter()
    for _ in range(reps):
        for p, want in zip(prompts, direct_tokens):
            ds = DecodeStream(tok, p)
            for t in want:
                ds.step(t)
                n += 1
    ds_us = (time.perf_counter() - t0) / n * 1e6
    log(f"http: 8 streamed /v1/completions requests x {N_NEW} tokens, "
        f"token-identical to the serve phase's generate() run; TTFT "
        f"median {np.median(ttft):.4f} s max {max(ttft):.4f} s (client: "
        f"send to first text; generate(): intake to first token "
        f"{np.median(direct['ttft']):.4f} s max {max(direct['ttft']):.4f} "
        f"s); inter-token gap median {np.median(gaps) * 1e3:.2f} ms max "
        f"{max(gaps) * 1e3:.2f} ms (generate(): "
        f"{np.median(direct['gaps']) * 1e3:.2f} ms, max "
        f"{max(direct['gaps']) * 1e3:.2f} ms); decode {tps:.1f} tok/s over "
        f"the batch (generate(): {direct['tps']:.1f} tok/s)")
    log(f"http: {ttft_split(prompts, res, firsts, marks)}")
    step_ms = cpu_clock_step_ms()
    busy_us, cpu_us = (v / tokens * 1e6 for v in host)
    log(f"http: the event loop (service and client) over the burst, per "
        f"streamed token: busy {busy_us:.2f} us (LoopMeter), CPU "
        f"{cpu_us:.2f} us (thread CPU clock, step {step_ms:.4g} ms on "
        f"this host: +-{step_ms * 1e3 / tokens:.2f} us a token); frontend "
        f"host time {replay_us:.1f} us per streamed token (the same 8 "
        f"streams replayed through the service and client, no engine; "
        f"traced, the median of 2 turns of 5); DecodeStream.step "
        f"{ds_us:.1f} us per token; "
        f"{steps} decode steps, flash_decode launches {dense} (counted by "
        f"the kernel on the card) in {tele['replays']} graph replays; "
        f"unary chat 200")
    (cpu_on, r_on, busy_on), (cpu_off, r_off, busy_off) = \
        tele["on"], tele["off"]
    log(f"http telemetry: {tele['trees']} /debug/trace trees, each "
        f"{tele['spans'][:3]} then {tele['n_rounds']} decode_round spans; "
        f"/debug/prof coverage {tele['cov']:.4f}, every attributed round "
        f"of the burst {tele['cov_lo']:.4f}..{tele['cov_hi']:.4f} "
        f"({tele['cov_n']} rounds); /debug/flight {tele['flight']} events "
        f"({', '.join(tele['kinds'])}); OpenMetrics scrape with exemplars; "
        f"Perfetto export of request 0: {tele['perfetto']} events, parsed; "
        f"the checks took {tele['secs']:.1f} s")
    log(f"http telemetry overhead ({smi_line()}): engine thread CPU over "
        f"a burst (its prefills included) a decode round "
        f"{cpu_on / max(r_on, 1) * 1e6:.1f} us with round "
        f"attribution on ({r_on} rounds, traced burst) and "
        f"{cpu_off / max(r_off, 1) * 1e6:.1f} us off ({r_off} rounds, "
        f"untraced burst; thread CPU clock step {step_ms:.4g} ms); the "
        f"attribution's own switches {switch_on:.2f} us a round enabled, "
        f"{switch_off:.2f} us disabled (prof_switch_us, 20000 rounds); the "
        f"frontend's host time per streamed token {replay_us:.1f} us at "
        f"trace sample rate 1.0 and {replay_untraced_us:.1f} us at 0.0 "
        f"(replay in turns traced, untraced, untraced, traced, 5 bursts "
        f"each: {[round(v, 1) for v in turns[1.0]]} and "
        f"{[round(v, 1) for v in turns[0.0]]}); the event loop busy per "
        f"token "
        f"{busy_on / tokens * 1e6:.2f} us traced, "
        f"{busy_off / tokens * 1e6:.2f} us untraced")
    figures(f"TTFT med {np.median(ttft):.4f} s; {tps:.1f} tok/s; "
            f"coverage {tele['cov_lo']:.4f}..{tele['cov_hi']:.4f}; round "
            f"CPU {cpu_on / max(r_on, 1) * 1e6:.1f}/"
            f"{cpu_off / max(r_off, 1) * 1e6:.1f} us prof on/off; switches "
            f"{switch_on - switch_off:.2f} us a round; frontend "
            f"{replay_us:.1f}/{replay_untraced_us:.1f} us a token traced/"
            f"untraced")
    del eng, chain, manager
    gc.collect()
    torch.cuda.empty_cache()
    return dense, dict(ttft=ttft, gaps=gaps, tps=tps, replay_us=replay_us,
                       busy_us=busy_us, cpu_us=cpu_us)


async def settle_engines(*engines):
    """Waits until every engine is idle: once the last stream ended a
    pipelined round may still be in flight; after it the kernel counts
    are final."""
    quiet = 0
    while quiet < 20:
        busy = any(eng._slot_active.any() or eng._entries or eng._waiting
                   or eng._prefilling or eng._intake.qsize()
                   for eng in engines)
        quiet = 0 if busy else quiet + 1
        await asyncio.sleep(0.01)


class LoopThread:
    """An asyncio event loop running on a thread of its own."""

    def __init__(self, name):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name=name, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=300):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        async def cancel_rest():
            rest = [t for t in asyncio.all_tasks()
                    if t is not asyncio.current_task()]
            for t in rest:
                t.cancel()
            await asyncio.gather(*rest, return_exceptions=True)

        if self.loop.is_running():
            self.run(cancel_rest(), timeout=30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


def check_distributed(params, direct_tokens, direct, http):
    """The distributed runtime at Llama-3.1-8B: the port's store
    (serve_store on 127.0.0.1, port 0), a worker (launch.run's
    build_chain with the serve phase's weights, registered through
    launch.run.serve_worker, the function in=endpoint runs, on
    launch.run.connect_runtime's resyncing connection, with
    --router-mode round_robin) and a frontend (ModelWatcher +
    HttpService), each on an event loop of its own thread; the client on
    the main thread. The serve phase's 8 prompts go out as in the http
    phase (gated_burst at the worker's intake, checked by parse_streams),
    and the kernel's own count on the card must rise by layers x decode
    steps (returned as the distributed path's launches, with the
    figures); /clear_kv_blocks
    through the frontend must clear what the worker's engine held; a chat
    request with tools and a streamed one with nvext.annotations
    ["llm_metrics"] must return 200 in the JAX package's shapes.
    Telemetry: each burst request's /debug/trace/{id} on the frontend
    holds the worker's spans, merged across the endpoint hop; a request
    sent through the frontend's remote engine with no trace (as from
    another process) leaves the worker (--forensics-sample-rate 1.0,
    --system-port 0) its own trace and a sampled dossier, served by the
    worker's system server. Prints
    TTFT, gaps and tok/s beside the http and serve phases', each
    request's TTFT split at the worker engine's intake and first output,
    and each loop's host time per streamed token (LoopMeter: frontend,
    worker, client)."""
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.frontend.watcher import ModelWatcher
    from dynamo_tpu_torch.launch import run as launch
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        StopConditions,
    )
    from dynamo_tpu_torch.protocols.sse import SseDecoder
    from dynamo_tpu_torch.runtime.store import serve_store
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer

    cfg = ModelConfig.llama3_8b()
    name = "llama3_8b"
    tok = make_test_tokenizer([f"t{i}" for i in range(3, cfg.vocab_size)])
    loops = {k: LoopThread(f"{k}-loop")
             for k in ("store", "worker", "frontend")}
    faulthandler.dump_traceback_later(600, exit=True)
    try:
        server, _ = loops["store"].run(serve_store("127.0.0.1", 0))
        cp_port = server.sockets[0].getsockname()[1]
        args = launch.build_parser().parse_intermixed_args(
            ["in=endpoint", "out=torch", "--model-config", name,
             "--model-name", name, "--router-mode", "round_robin",
             "--control-plane", f"127.0.0.1:{cp_port}",
             "--forensics-sample-rate", "1.0", "--system-port", "0"])
        t0 = time.monotonic()
        _, chain = launch.build_chain(args, params=params, tokenizer=tok)
        eng = chain.engine
        marks = record_marks(eng)
        worker_rt = loops["worker"].run(launch.connect_runtime(args))
        served = loops["worker"].run(
            launch.serve_worker(args, chain, worker_rt, lease_ttl_s=10.0))
        t_worker = time.monotonic() - t0

        async def frontend_up():
            rt = await launch.connect_runtime(args)
            manager = ModelManager()
            watcher = await ModelWatcher(rt, manager, tokenizer=tok).start()
            svc = HttpService(manager, host="127.0.0.1", port=0)
            await svc.start()
            for _ in range(600):
                if manager.list_models() == [name]:
                    break
                await asyncio.sleep(0.05)
            return rt, manager, watcher, svc

        rt, manager, watcher, svc = loops["frontend"].run(frontend_up())
        if manager.list_models() != [name]:
            raise AssertionError(f"distributed: the frontend discovered "
                                 f"{manager.list_models()}")
        log(f"distributed: store on 127.0.0.1:{cp_port}, worker instance "
            f"{served.lease_id} (TorchEngine on {eng.device}) built and "
            f"registered in {t_worker:.1f} s, frontend on "
            f"127.0.0.1:{svc.port} discovered {manager.list_models()}")
        prompts = serve_prompts(cfg.vocab_size)

        async def install_meter():
            return LoopMeter()

        meters = {k: loops[k].run(install_meter())
                  for k in ("frontend", "worker")}

        async def chats():
            async with HttpClient("127.0.0.1", svc.port) as c:
                tools = await c.request("POST", "/v1/chat/completions",
                                        json_body={
                    "model": name, "max_tokens": 4,
                    "tools": [{"type": "function", "function": {
                        "name": "get_w", "parameters": {}}}],
                    "messages": [{"role": "user", "content": "t5 t6 t7"}]})
                r = await c.request("POST", "/v1/chat/completions",
                                    json_body={
                    "model": name, "max_tokens": 4, "stream": True,
                    "nvext": {"annotations": ["llm_metrics"]},
                    "messages": [{"role": "user", "content": "t8 t9"}]},
                    stream=True)
                dec, events = SseDecoder(), []
                async for chunk in r.chunks():
                    events.extend(dec.feed(chunk))
                return tools, r.status, events

        async def burst():
            meters["client"] = LoopMeter()
            # every kernel count to 0 just before the main path
            fd.launches = fd.launches_int8 = 0
            eng.kernel_launches = 0
            fd.executed(eng.device, reset=True)
            steps0 = eng.step_count
            host0 = {k: m.read() for k, m in meters.items()}
            res = await gated_burst(eng, svc.port, prompts, name,
                                    "distributed")
            host = {k: [b - a for a, b in zip(host0[k], m.read())]
                    for k, m in meters.items()}
            await settle_engines(eng)
            torch.cuda.synchronize()
            # the graphs' record and replays of the burst (the untraced
            # request below adds its own)
            return (res, fd.executed(eng.device), eng.step_count - steps0,
                    host, (eng.kernel_launches, eng.graphs.replays))

        tools, llm_status, llm_events = asyncio.run(chats())
        res, (dense, int8), steps, host, (recorded, replays) = \
            asyncio.run(burst())
        issued = fd.launches + fd.launches_int8
        # ---- telemetry: the merged trees, and the worker's own trace and
        # dossier for a request no frontend traced
        t_tel = time.monotonic()
        n_rounds = -(-(N_NEW - 1) // eng.ecfg.flush_every)
        asyncio.run(check_trace_trees(
            svc.port, frontend_trace_ids(len(prompts)), "distributed",
            ["tokenize", "queue", "prefill"], n_rounds))
        rid = "chip-smoke-untraced"

        async def untraced():
            toks = []
            async for out in manager.get(name).engine.generate(
                    PreprocessedRequest(
                        token_ids=list(prompts[0]), request_id=rid,
                        stop_conditions=StopConditions(max_tokens=8,
                                                       ignore_eos=True))):
                toks.extend(out.token_ids)
            return toks

        untraced_toks = loops["frontend"].run(untraced())

        async def worker_debug():
            async with HttpClient("127.0.0.1", served.system.port) as c:
                return [await c.request("GET", path) for path in (
                    f"/debug/outliers/{rid}", f"/debug/trace/{rid}",
                    f"/debug/outliers/{rid}?format=perfetto")]

        dossier, wtrace, wperf = asyncio.run(worker_debug())
        wnames = [sp["name"] for sp in wtrace.json().get("spans", [])]
        # (its prefill is a group of one, another path than the burst's
        # batch: its tokens are counted, not held to the burst's)
        if (len(untraced_toks) != 8 or dossier.status != 200
                or dossier.json()["reason"] not in (
                    "sampled", "ttft_breach", "itl_breach")
                or not dossier.json()["rounds"]
                or not dossier.json()["flight"] or wtrace.status != 200
                or wnames[:2] != ["queue", "prefill"]
                or wnames.count("decode_round") != 2
                or wperf.status != 200
                or not wperf.json()["traceEvents"]):
            raise AssertionError(
                f"distributed: the untraced request gave {untraced_toks}; "
                f"the worker's dossier {dossier.status} "
                f"{dossier.body[:300]!r}, its trace {wtrace.status} "
                f"{wnames}, Perfetto {wperf.status}")
        d = dossier.json()
        tel = (f"the worker's dossier for an untraced request: reason "
               f"{d['reason']}, {len(d['trace']['spans'])} spans ({wnames[:3]}"
               f"...), {len(d['rounds'])} host rounds, {len(d['flight'])} "
               f"flight events, Perfetto "
               f"{len(wperf.json()['traceEvents'])} events; the checks took "
               f"{time.monotonic() - t_tel:.1f} s")
        # /clear_kv_blocks: the frontend's remote engine fans the clear
        # out to the worker, which returns what its engine held
        held = len(eng.allocator._lru)
        remote = manager.get(name).engine
        cleared = loops["frontend"].run(remote.clear_kv_blocks())

        async def clear_http():
            async with HttpClient("127.0.0.1", svc.port) as c:
                return await c.request("POST", "/clear_kv_blocks")

        cleared_http = asyncio.run(clear_http())
        left = len(eng.allocator._lru)

        async def frontend_down():
            await svc.stop()
            await watcher.stop()
            await rt.close()

        loops["frontend"].run(frontend_down())
        loops["worker"].run(served.shutdown())
        loops["worker"].run(worker_rt.close())
        loops["worker"].run(eng.stop())

        async def store_down():
            server.close()
            await server.wait_closed()

        loops["store"].run(store_down())
    finally:
        faulthandler.cancel_dump_traceback_later()
        for lt in loops.values():
            lt.close()
    # the tool and llm_metrics requests, in the JAX package's shapes
    if tools.status != 200:
        raise AssertionError(f"distributed: tools chat status "
                             f"{tools.status}")
    tchoice = tools.json()["choices"][0]
    msg = tchoice["message"]
    if msg.get("role") != "assistant" or tchoice["finish_reason"] not in (
            "length", "stop", "tool_calls"):
        raise AssertionError(f"distributed: tools chat answered {tchoice}")
    for call in msg.get("tool_calls") or []:
        if call["type"] != "function" or not call["id"].startswith("call_") \
                or set(call["function"]) != {"name", "arguments"}:
            raise AssertionError(f"distributed: tool call {call}")
    if (tchoice["finish_reason"] == "tool_calls") != bool(
            msg.get("tool_calls")):
        raise AssertionError(f"distributed: tools chat answered {tchoice}")
    if llm_status != 200 or not llm_events or not llm_events[-1].is_done:
        raise AssertionError(f"distributed: llm_metrics stream status "
                             f"{llm_status}")
    ann = llm_events[-2].json().get("nvext", {})
    want_keys = {"prompt_tokens", "completion_tokens", "ttft_s",
                 "itl_avg_s", "itl_p50_s", "itl_p95_s"}
    if ann.get("annotation") != "llm_metrics" \
            or set(ann.get("metrics", {})) != want_keys \
            or ann["metrics"]["completion_tokens"] != 4:
        raise AssertionError(f"distributed: llm_metrics event {ann}")
    # the burst
    ttft, gaps, firsts, ends = parse_streams(res, direct_tokens,
                                             "distributed")
    check_replayed(eng, "distributed")
    if dense != cfg.num_layers * steps or int8 or issued \
            or recorded != dense:
        raise AssertionError(
            f"distributed: flash_decode ran {dense} times on the card (int8 "
            f"{int8}, {issued} issued eagerly, graphs recorded "
            f"{recorded}) over {steps} decode steps of "
            f"{cfg.num_layers} layers")
    if not held or cleared != held or left \
            or cleared_http.status != 200 \
            or cleared_http.json() != {"cleared": [name]}:
        raise AssertionError(
            f"distributed: the worker held {held} cached pages, the "
            f"frontend's clear returned {cleared} and left {left}; "
            f"/clear_kv_blocks answered {cleared_http.status} "
            f"{cleared_http.body!r}")
    tokens = N_NEW * len(prompts)
    tps = (tokens - len(prompts)) / (max(ends) - min(firsts))
    log(f"distributed: 8 streamed /v1/completions requests x {N_NEW} "
        f"tokens through store, worker and frontend, token-identical to "
        f"the serve phase's generate() run; TTFT median "
        f"{np.median(ttft):.4f} s max {max(ttft):.4f} s (http "
        f"{np.median(http['ttft']):.4f}, {max(http['ttft']):.4f}; "
        f"generate() {np.median(direct['ttft']):.4f}, "
        f"{max(direct['ttft']):.4f}); inter-token gap median "
        f"{np.median(gaps) * 1e3:.2f} ms max {max(gaps) * 1e3:.2f} ms "
        f"(http {np.median(http['gaps']) * 1e3:.2f}, "
        f"{max(http['gaps']) * 1e3:.2f}; generate() "
        f"{np.median(direct['gaps']) * 1e3:.2f}, "
        f"{max(direct['gaps']) * 1e3:.2f}); decode {tps:.1f} tok/s over "
        f"the batch (http {http['tps']:.1f}, generate() "
        f"{direct['tps']:.1f})")
    log(f"distributed: {ttft_split(prompts, res, firsts, marks)}")
    step_ms = cpu_clock_step_ms()
    us = {k: [v / tokens * 1e6 for v in h] for k, h in host.items()}
    each = "; ".join(f"{k} loop busy {b:.2f} us, CPU {c:.2f} us"
                     for k, (b, c) in us.items())
    log(f"distributed: host time per streamed token over the burst: "
        f"{each} (LoopMeter; thread CPU clock step {step_ms:.4g} ms on "
        f"this host: +-{step_ms * 1e3 / tokens:.2f} us a token); frontend "
        f"+ client busy {us['frontend'][0] + us['client'][0]:.2f} us "
        f"beside the http phase's one loop (service and client) "
        f"{http['busy_us']:.2f} us (CPU {http['cpu_us']:.2f}); "
        f"{steps} decode steps, flash_decode launches {dense} (counted by "
        f"the kernel on the card) in {replays} graph replays; "
        f"/clear_kv_blocks cleared the worker's {cleared} cached pages; "
        f"tools chat 200 (finish_reason {tchoice['finish_reason']!r}), "
        f"llm_metrics {ann['metrics']}")
    log(f"distributed telemetry: {len(prompts)} /debug/trace trees on the "
        f"frontend, each tokenize then the worker's queue, prefill and "
        f"{n_rounds} decode_round spans across the endpoint "
        f"hop; {tel}")
    del eng, chain
    gc.collect()
    torch.cuda.empty_cache()
    return dense, dict(ttft=ttft, gaps=gaps, tps=tps, us=us)


def part_ways(label, got, want):
    """Greedy streams (each request's engine tokens and its top-2
    logprobs) against the serve phase's generate() tokens for the same
    prompts. A stream whose prefill took another path (a group of one
    where the serve phase batched a pair, a prefix hit that prefills only
    the tail) sums in another order and may leave generate()'s stream
    where the two runs' top-2 swap: at the first step where they differ,
    its top-1 is its own token and its runner-up generate()'s. Returns,
    per request, None (identical) or (step, top-2 gap), and the streams
    that part otherwise (wrong blocks or state, not rounding)."""
    splits, problems = [], []
    for i, ((toks, top), w) in enumerate(zip(got, want)):
        if len(toks) != len(w):
            problems.append(f"{label}: request {i} gave {len(toks)} tokens, "
                            f"generate() {len(w)}")
            splits.append(None)
            continue
        j = next((j for j, (a, b) in enumerate(zip(toks, w)) if a != b),
                 None)
        if j is None:
            splits.append(None)
            continue
        (t1, l1), (t2, l2) = top[j][0], top[j][1]
        splits.append((j, l1 - l2))
        if t1 != toks[j] or t2 != w[j]:
            problems.append(
                f"{label}: request {i} left generate()'s stream at step {j} "
                f"({toks[j]} for {w[j]}), where its top-2 were {top[j][:2]}")
    return splits, problems


def rerun(eng, prompts, burst):
    """The prompts through ``eng.generate()`` with top-2 logprobs, greedy,
    N_NEW tokens each: as one burst behind an IntakeGate (burst=True),
    else one at a time. Returns each request's tokens."""
    async def go():
        if burst:
            IntakeGate(eng, len(prompts))
            return [t for t, *_ in await generate_all(eng, prompts, N_NEW,
                                                      logprobs=2)]
        out = []
        for p in prompts:
            out.append((await generate_all(eng, [p], N_NEW,
                                           logprobs=2))[0][0])
        return out

    return asyncio.run(go())


def describe_splits(splits):
    same = sum(s is None for s in splits)
    away = ", ".join(f"step {j} gap {g:.4f}" for j, g in
                     (s for s in splits if s is not None))
    return f"{same}/{len(splits)} identical" + (
        f" (the others part where its top-2 swap: {away})" if away else "")


def check_kv_launches(label, engines, dense, int8, issued, steps, layers,
                      quant=False):
    """The dense kernel (the int8 one with ``quant``) ran on every layer
    of every decode step of the engines, inside replayed graphs (each
    engine's graphs recorded what the card ran), and nothing else
    launched."""
    recorded = sum(e.kernel_launches for e in engines)
    ran, other = (int8, dense) if quant else (dense, int8)
    if ran != layers * steps or other or issued or recorded != ran:
        raise AssertionError(
            f"{label}: flash_decode ran {dense} times on the card (int8 "
            f"{int8}, {issued} issued eagerly, graphs recorded {recorded}) "
            f"over {steps} decode steps of {layers} layers")
    for i, e in enumerate(engines):
        check_replayed(e, f"{label} worker {i}")


def check_kv_router(params, direct_tokens, direct, http):
    """The KV router at Llama-3.1-8B: the port's store, two workers
    (launch.run's build_chain sharing the serve phase's weights, each
    registered through launch.run.serve_worker with the launcher's default
    --router-mode kv, each on its own loop thread with its own engine
    thread) and a frontend (ModelWatcher with KvRouterConfig(
    router_temperature=0.0) + HttpService); the client on the main thread.
    Every request asks top-2 logprobs.

    Wave A: the serve phase's 8 prompts as streamed requests, gated at
    both workers' intakes (gated_burst over both engines). Then, once the
    frontend's indexer holds every sealed prompt block under its worker's
    lease id, wave C: the 8 again, one at a time: each must go to the
    worker that served it in wave A, with the router's overlap the
    prompt's full blocks and the engine's matched blocks that overlap
    (less the last block when the prompt ends on one: a prefill needs a
    token). Wave C': the 8 one at a time straight to the other worker's
    endpoint (the frontend's RemoteWorkerEngine), which recomputes them.
    Failover: one worker shut down (its lease revoked); a prompt it held
    is served by the survivor and its blocks leave the indexer. Every
    HTTP stream maps back to the engine's tokens; every stream must be
    identical to generate() on one engine along the same prefill paths
    (the histories replayed on the survivor once the waves are counted),
    and may leave the serve phase's generate() stream only where their
    top-2 swap (part_ways). The kernel's own count must rise by layers x
    the decode steps of both engines over the waves. Prints memory with
    both workers up,
    TTFT, gaps and tok/s beside the http phase's, the matched blocks, and
    the TTFT of wave C against C' per prompt (the engine's own: intake to
    first token; and the client's)."""
    import random

    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.frontend.watcher import ModelWatcher
    from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig
    from dynamo_tpu_torch.launch import run as launch
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.protocols.common import (
        OutputOptions,
        PreprocessedRequest,
        StopConditions,
    )
    from dynamo_tpu_torch.resilience.metrics import RESILIENCE
    from dynamo_tpu_torch.runtime.store import serve_store
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer
    from dynamo_tpu_torch.tokens import compute_block_hashes

    cfg = ModelConfig.llama3_8b()
    name = "llama3_8b"
    tok = make_test_tokenizer([f"t{i}" for i in range(3, cfg.vocab_size)])
    prompts = serve_prompts(cfg.vocab_size)
    lp = {"logprobs": 2}
    problems: list[str] = []
    loops = {k: LoopThread(f"{k}-loop")
             for k in ("store", "worker0", "worker1", "frontend")}
    faulthandler.dump_traceback_later(900, exit=True)
    try:
        server, _ = loops["store"].run(serve_store("127.0.0.1", 0))
        cp_port = server.sockets[0].getsockname()[1]
        args = launch.build_parser().parse_intermixed_args(
            ["in=endpoint", "out=torch", "--model-config", name,
             "--model-name", name, "--control-plane",
             f"127.0.0.1:{cp_port}"])
        if args.router_mode != "kv":
            raise AssertionError(f"the launcher's default router mode is "
                                 f"{args.router_mode!r}")
        ps = args.page_size
        t0 = time.monotonic()
        engs, marks, chains, rts, served = [], [], [], [], []
        for k in range(2):
            # each engine captures its round graphs as it is built, before
            # the other serves anything
            _, chain = launch.build_chain(args, params=params,
                                          tokenizer=tok)
            chains.append(chain)
            engs.append(chain.engine)
            marks.append(record_marks(chain.engine))
        for k, chain in enumerate(chains):
            lt = loops[f"worker{k}"]
            rts.append(lt.run(launch.connect_runtime(args)))
            served.append(lt.run(launch.serve_worker(
                args, chain, rts[k], lease_ttl_s=10.0)))
        torch.cuda.synchronize()
        t_workers = time.monotonic() - t0
        mem = torch.cuda.memory_allocated()
        wids = [str(s.lease_id) for s in served]
        shared = all(e.params is params for e in engs)

        async def frontend_up():
            rt = await launch.connect_runtime(args)
            manager = ModelManager()
            watcher = await ModelWatcher(
                rt, manager,
                router_config=KvRouterConfig(router_temperature=0.0),
                tokenizer=tok).start()
            svc = HttpService(manager, host="127.0.0.1", port=0)
            await svc.start()
            for _ in range(600):
                push = watcher._routers.get(name)
                if push is not None and sorted(push.workers) == sorted(wids):
                    break
                await asyncio.sleep(0.05)
            return rt, manager, watcher, svc

        rt, manager, watcher, svc = loops["frontend"].run(frontend_up())
        push = watcher._routers.get(name)
        if push is None or sorted(push.workers) != sorted(wids):
            raise AssertionError(
                f"kv router: the frontend routes {name} over "
                f"{None if push is None else sorted(push.workers)}, the "
                f"workers are {wids}")
        log(f"kv router: store on 127.0.0.1:{cp_port}, workers {wids} "
            f"(TorchEngine on {engs[0].device} each, router mode "
            f"{args.router_mode!r}) built and registered in {t_workers:.1f} "
            f"s; {mem / 2**30:.2f} GiB allocated with both up (the weights "
            f"{weights_gib(params):.2f} GiB, {'one copy shared' if shared else 'NOT shared'}; "
            f"each engine's pool {engs[0].cache['k'].nbytes * 2 / 2**30:.2f} "
            f"GiB, ctx {engs[0].ctx['k'].nbytes * 2 / 2**30:.2f} GiB, graph "
            f"pool {engs[0].graphs.pool_bytes / 2**20:.1f} MiB); frontend on "
            f"127.0.0.1:{svc.port}")
        if not shared:
            problems.append("kv router: the engines copied the weights")
        # ties at temperature 0 break by the selector's draws: seeded
        push.router.scheduler.selector.rng = random.Random(SEED)
        hits: list = []
        push.router.scheduler.on_hit_rate = hits.append

        def take_marks():
            out = [dict(m) for m in marks]
            for m in marks:
                m.clear()
            return out

        def engine_streams(wave, ps_list, worker_of):
            return [(wave[worker_of[i]][tuple(p)]["tokens"],
                     wave[worker_of[i]][tuple(p)]["top"])
                    for i, p in enumerate(ps_list)]

        # every kernel count to 0 just before the main path
        fd.launches = fd.launches_int8 = 0
        for e in engs:
            e.kernel_launches = 0
        fd.executed(engs[0].device, reset=True)
        steps0 = [e.step_count for e in engs]

        # ---- wave A: the burst, gated at both intakes
        async def wave_a():
            res = await gated_burst(engs, svc.port, prompts, name,
                                    "kv router wave A", **lp)
            await settle_engines(*engs)
            return res

        res_a = asyncio.run(wave_a())
        ma = take_marks()
        worker_of = []
        for i, p in enumerate(prompts):
            ks = [k for k in range(2) if tuple(p) in ma[k]]
            if len(ks) != 1:
                raise AssertionError(f"kv router wave A: prompt {i} reached "
                                     f"workers {ks}")
            worker_of.append(ks[0])
        got_a = engine_streams(ma, prompts, worker_of)
        marks_a = {**ma[0], **ma[1]}
        ttft_a, gaps_a, firsts_a, ends_a = parse_streams(
            res_a, [t for t, _ in got_a], "kv router wave A")
        split_a, bad = part_ways("kv router wave A", got_a,
                                     direct_tokens)
        problems += bad
        tps_a = (N_NEW - 1) * len(prompts) / (max(ends_a) - min(firsts_a))
        took = [worker_of.count(k) for k in range(2)]

        # ---- the indexer holds every sealed prompt block of each worker
        want = {w: set() for w in wids}
        for i, p in enumerate(prompts):
            want[wids[worker_of[i]]].update(
                compute_block_hashes(p, ps, salt=name))

        async def indexed():
            idx = push.router.indexer
            for _ in range(1200):
                if all(want[w] <= idx._by_worker.get(w, set())
                       for w in wids):
                    return {w: len(idx._by_worker.get(w, ())) for w in wids}
                await asyncio.sleep(0.05)
            raise AssertionError(
                f"kv router: the indexer holds "
                f"{ {w: len(idx._by_worker.get(w, ())) for w in wids} } "
                f"blocks, the workers sealed "
                f"{ {w: len(want[w]) for w in wids} } prompt blocks")

        t0 = time.monotonic()
        held = loops["frontend"].run(indexed(), timeout=120)
        t_indexed = time.monotonic() - t0

        # ---- wave C: one at a time, each to its warm worker
        async def one_by_one(label):
            out = []
            async with HttpClient("127.0.0.1", svc.port) as c:
                for p in prompts:
                    out.append(await stream_completion(c, p, name, label,
                                                       **lp))
                    await settle_engines(*engs)
            return out

        del hits[:]
        res_c = asyncio.run(one_by_one("kv router wave C"))
        mc = take_marks()
        hits_c = list(hits)
        matched, matchable = [], []
        for i, p in enumerate(prompts):
            k = worker_of[i]
            m = mc[k].get(tuple(p))
            hit = hits_c[i] if i < len(hits_c) else None
            if m is None or hit is None or hit.worker_id != wids[k]:
                raise AssertionError(
                    f"kv router wave C: prompt {i} went to "
                    f"{None if hit is None else hit.worker_id}, wave A's "
                    f"worker was {wids[k]}")
            full = len(p) // ps
            can = (len(p) - 1) // ps
            if hit.overlap_blocks != full or m["hint"] != full \
                    or m["cached"] != min(hit.overlap_blocks, can):
                problems.append(
                    f"kv router wave C: prompt {i} ({len(p)} tokens): router "
                    f"overlap {hit.overlap_blocks} (hint at the worker "
                    f"{m['hint']}), the engine matched {m['cached']}, the "
                    f"prompt has {full} full blocks and {can} matchable")
            matched.append(m["cached"])
            matchable.append(can)
        got_c = engine_streams(mc, prompts, worker_of)
        ttft_c, _, _, _ = parse_streams(res_c, [t for t, _ in got_c],
                                        "kv router wave C")
        split_c, bad = part_ways("kv router wave C", got_c,
                                     direct_tokens)
        problems += bad
        eng_c = [mc[worker_of[i]][tuple(p)]["timing"]["ttft_s"]
                 for i, p in enumerate(prompts)]

        # ---- wave C': one at a time straight to the other worker
        async def straight(k, p):
            req = PreprocessedRequest(
                token_ids=list(p), model=name,
                stop_conditions=StopConditions(max_tokens=N_NEW,
                                               ignore_eos=True),
                output_options=OutputOptions(logprobs=2))
            t = time.monotonic()
            first = None
            async for out in push.workers[wids[k]].generate(req):
                if out.token_ids and first is None:
                    first = time.monotonic() - t
            await settle_engines(*engs)
            return first

        ttft_c2 = [loops["frontend"].run(straight(1 - worker_of[i], p))
                   for i, p in enumerate(prompts)]
        mc2 = take_marks()
        other = [1 - k for k in worker_of]
        got_c2 = engine_streams(mc2, prompts, other)
        split_c2, bad = part_ways("kv router wave C'", got_c2,
                                      direct_tokens)
        problems += bad
        eng_c2 = [mc2[other[i]][tuple(p)]["timing"]["ttft_s"]
                  for i, p in enumerate(prompts)]
        cached_c2 = [mc2[other[i]][tuple(p)]["cached"]
                     for i, p in enumerate(prompts)]
        if any(cached_c2):
            problems.append(f"kv router wave C': the other workers matched "
                            f"{cached_c2} blocks of prompts they never saw")

        # ---- failover: worker 0 goes; a prompt it held
        dead = 0
        i_dead = worker_of.index(dead)
        reroutes0 = RESILIENCE.get("dynamo_resilience_reroute_total")
        loops[f"worker{dead}"].run(served[dead].shutdown())
        t0 = time.monotonic()

        async def removed():
            idx = push.router.indexer
            for _ in range(600):
                if wids[dead] not in push.workers \
                        and wids[dead] not in idx._by_worker:
                    return
                await asyncio.sleep(0.02)
            raise AssertionError(
                f"kv router failover: worker {wids[dead]} still routed "
                f"({sorted(push.workers)}) or indexed "
                f"({sorted(idx._by_worker)})")

        loops["frontend"].run(removed())
        t_removed = time.monotonic() - t0
        del hits[:]

        async def failover():
            async with HttpClient("127.0.0.1", svc.port) as c:
                r = await stream_completion(c, prompts[i_dead], name,
                                            "kv router failover", **lp)
            await settle_engines(*engs)
            return r

        res_f = asyncio.run(failover())
        mf = take_marks()
        survivor = 1 - dead
        if tuple(prompts[i_dead]) not in mf[survivor] or not hits \
                or hits[-1].worker_id != wids[survivor]:
            raise AssertionError(
                f"kv router failover: prompt {i_dead} was not served by the "
                f"survivor {wids[survivor]}")
        mfd = mf[survivor][tuple(prompts[i_dead])]
        parse_streams([res_f], [mfd["tokens"]], "kv router failover")
        split_f, bad = part_ways("kv router failover",
                                     [(mfd["tokens"], mfd["top"])],
                                     [direct_tokens[i_dead]])
        problems += bad
        reroutes = RESILIENCE.get("dynamo_resilience_reroute_total") \
            - reroutes0

        # ---- the counts, once both engines idle
        loops["frontend"].run(settle_engines(*engs))
        torch.cuda.synchronize()
        dense, int8 = fd.executed(engs[0].device)
        issued = fd.launches + fd.launches_int8
        steps = sum(e.step_count - s for e, s in zip(engs, steps0))
        check_kv_launches("kv router", engs, dense, int8, issued, steps,
                          cfg.num_layers)

        # ---- the same histories through generate() on one engine: each
        # worker's wave A share as one gated burst, then its wave C
        # prompts one at a time; each wave C' prompt alone on a cold
        # cache; the failover prompt cold, then again as a prefix hit.
        # The prefill groups and cached blocks are then the waves' own,
        # so every stream must be identical
        ref = engs[survivor]
        same = {"A": 0, "C": 0, "C'": 0, "failover": 0}

        def hold(wave, i, got, want):
            if got == want:
                same[wave] += 1
            else:
                j = next(j for j, (a, b) in enumerate(zip(got, want))
                         if a != b)
                problems.append(
                    f"kv router {wave}: prompt {i} streamed {got[j]} at step "
                    f"{j} where generate() on the same prefill path gave "
                    f"{want[j]}")

        t0 = time.monotonic()
        for k in range(2):
            mine = [i for i in range(len(prompts)) if worker_of[i] == k]
            ref.clear_kv_blocks()
            a_ref = rerun(ref, [prompts[i] for i in mine], burst=True)
            c_ref = rerun(ref, [prompts[i] for i in mine], burst=False)
            for i, ta, tc in zip(mine, a_ref, c_ref):
                hold("A", i, got_a[i][0], ta)
                hold("C", i, got_c[i][0], tc)
        for i, p in enumerate(prompts):
            ref.clear_kv_blocks()
            hold("C'", i, got_c2[i][0], rerun(ref, [p], burst=False)[0])
        ref.clear_kv_blocks()
        hold("failover", i_dead, mfd["tokens"],
             rerun(ref, [prompts[i_dead]] * 2, burst=False)[1])
        take_marks()
        t_replay = time.monotonic() - t0

        async def frontend_down():
            await svc.stop()
            await watcher.stop()
            await rt.close()

        loops["frontend"].run(frontend_down())
        loops[f"worker{survivor}"].run(served[survivor].shutdown())
        for k in range(2):
            loops[f"worker{k}"].run(rts[k].close())
            loops[f"worker{k}"].run(engs[k].stop())

        async def store_down():
            server.close()
            await server.wait_closed()

        loops["store"].run(store_down())
    finally:
        faulthandler.cancel_dump_traceback_later()
        for lt in loops.values():
            lt.close()

    ratio = [a / b for a, b in zip(eng_c, eng_c2)]
    log(f"kv router wave A: 8 streamed /v1/completions (top-2 logprobs) "
        f"over 2 workers, gated at both intakes: {took[0]} and {took[1]} "
        f"requests; {describe_splits(split_a)} to the serve phase's "
        f"generate(); TTFT median {np.median(ttft_a):.4f} s max "
        f"{max(ttft_a):.4f} s (http {np.median(http['ttft']):.4f}, "
        f"{max(http['ttft']):.4f}; generate() "
        f"{np.median(direct['ttft']):.4f}, {max(direct['ttft']):.4f}); gap "
        f"median {np.median(gaps_a) * 1e3:.2f} ms max "
        f"{max(gaps_a) * 1e3:.2f} ms (http "
        f"{np.median(http['gaps']) * 1e3:.2f}, "
        f"{max(http['gaps']) * 1e3:.2f}); decode {tps_a:.1f} tok/s over "
        f"the batch (http {http['tps']:.1f}, generate() "
        f"{direct['tps']:.1f})")
    log(f"kv router wave A: "
        f"{ttft_split(prompts, res_a, firsts_a, marks_a)}")
    log(f"kv router: the indexer held every sealed prompt block "
        f"{t_indexed:.2f} s after wave A ({held} blocks by worker)")
    log(f"kv router wave C: 8 of 8 one at a time to the worker that served "
        f"them in wave A, router overlap = the engine's matched blocks: "
        f"matched {sum(matched)} of {sum(matchable)} matchable "
        f"({matched} of {matchable}); {describe_splits(split_c)}; TTFT "
        f"(client) median {np.median(ttft_c):.4f} s max {max(ttft_c):.4f} "
        f"s; engine intake to first token median {np.median(eng_c):.4f} s "
        f"max {max(eng_c):.4f} s")
    log(f"kv router wave C': 8 one at a time straight to the other "
        f"worker, recomputed (0 blocks matched); "
        f"{describe_splits(split_c2)}; TTFT (the frontend's call) median "
        f"{np.median(ttft_c2):.4f} s max {max(ttft_c2):.4f} s; engine "
        f"intake to first token median {np.median(eng_c2):.4f} s max "
        f"{max(eng_c2):.4f} s; wave C / C' engine TTFT per prompt "
        f"{', '.join(f'{r:.3f}' for r in ratio)} (median "
        f"{np.median(ratio):.3f})")
    log(f"kv router failover: worker {wids[dead]} shut down (lease revoked): "
        f"out of the router and its blocks out of the indexer "
        f"{t_removed:.3f} s later (lease-driven removal; reroutes "
        f"{int(reroutes)}); prompt {i_dead}, which it held, served by "
        f"{wids[survivor]} ({mfd['cached']} blocks matched there from wave "
        f"C'), {describe_splits(split_f)}")
    same_c2 = same["C'"]
    log(f"kv router: {steps} decode steps over both engines, flash_decode "
        f"launches {dense} (counted by the kernel on the card) = "
        f"{cfg.num_layers} x {steps}; identical to generate() on one "
        f"engine along the same prefill paths: wave A {same['A']}/8, wave "
        f"C {same['C']}/8, wave C' {same_c2}/8, failover "
        f"{same['failover']}/1 (replayed in {t_replay:.1f} s)")
    if problems:
        raise AssertionError("kv router: " + "; ".join(problems))
    del engs, chains
    gc.collect()
    torch.cuda.empty_cache()
    figures(f"wave A TTFT median {np.median(ttft_a):.4f} s, gap max "
            f"{max(gaps_a) * 1e3:.2f} ms; C engine {np.median(eng_c):.4f} "
            f"s, C' {np.median(eng_c2):.4f} s (C/C' {np.median(ratio):.3f});"
            f" matched {sum(matched)}/{sum(matchable)}; same path A "
            f"{same['A']}/8 C {same['C']}/8 C' {same_c2}/8; launches "
            f"{dense}")
    return dense, dict(ttft_a=ttft_a, gaps_a=gaps_a, ttft_c=ttft_c,
                       eng_c=eng_c, eng_c2=eng_c2, ttft_c2=ttft_c2)


def same_bytes(a, b) -> bool:
    """Two host page payloads (dense, or int8 bundles with their scales)
    hold the same bytes."""
    if hasattr(a, "scales"):
        return same_bytes(a.data, b.data) and same_bytes(a.scales, b.scales)
    return tuple(a.shape) == tuple(b.shape) and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def wire_totals():
    """The transfer plane's bytes sent and received, and the seconds its
    whole moves took (dynamo_kv_transfer_seconds), so far."""
    from dynamo_tpu_torch.kv_transfer_metrics import KV_TRANSFER

    return (KV_TRANSFER.get("dynamo_kv_transfer_tx_bytes_total"),
            KV_TRANSFER.get("dynamo_kv_transfer_rx_bytes_total"),
            KV_TRANSFER.histogram("dynamo_kv_transfer_seconds")
            .snapshot()["sum"])


# the disagg fallback's remote-prefill timeout (s)
DISAGG_FALLBACK_S = 5.0


def check_disagg(params, direct_tokens, kv, smi):
    """Disaggregated prefill/decode at Llama-3.1-8B, dense KV: the port's
    store, a ``--role decode`` worker (engine D: launch.run's build_chain
    and serve_worker with ``--max-local-prefill-length 64``, so every
    serve prompt goes remote), a ``--role prefill`` worker
    (engine P: serve_prefill_worker) and a KV-routing frontend, each on
    its own loop thread, both engines on the serve phase's weights. Every
    request asks top-2 logprobs.

    Wave A: the 8 prompts one at a time through the frontend: 8 remote
    prefills, no local prefill, no fallback (dynamo_disagg_fallback_total
    unmoved), and D's admission matches exactly the blocks P sent. For
    two prompts, D's pages and P's for the same hashes are byte-equal.
    Every stream must equal generate() along the same path (one engine
    that prefilled the prompt alone, max_tokens=1, then serves it from
    that prefix hit), and may leave the serve phase's only where their
    top-2 swap (part_ways). Wave B: both caches cleared, the 8 as one
    ungated burst: 16 remote prefills in all, 0 local, 0 fallbacks.
    Fallback: P stopped, one prompt (D's cache cleared) falls back after
    the 5 s timeout, counted once in remote_fallbacks and in
    dynamo_disagg_fallback_total, with the tokens of a local prefill.
    The kernel's own count rises by layers x the decode steps of D and P.
    Prints TTFT beside the kv router phase's C' (a whole-prompt recompute
    on one engine), each prompt's prefill_ms, chunks and overlap ratio,
    wire GB/s, D's tail prefill, wave B's gaps beside kv router wave A's
    and memory with both engines up. Telemetry: each wave A request's
    /debug/trace/{id} holds disagg_kv_transfer and P's remote_prefill
    span with a kv_chunk child a streamed frame (as many as P's done
    message counts), and wave A's stream timeline counts every frame sent
    and received, one eof-ack wait a stream and P's commit wakeups."""
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.frontend.watcher import ModelWatcher
    from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig
    from dynamo_tpu_torch.kv_transfer_metrics import KV_TRANSFER
    from dynamo_tpu_torch.launch import run as launch
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.runtime.store import serve_store
    from dynamo_tpu_torch.telemetry import timeline as tl
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer
    from dynamo_tpu_torch.tokens import compute_block_hashes

    cfg = ModelConfig.llama3_8b()
    name = "llama3_8b"
    tok = make_test_tokenizer([f"t{i}" for i in range(3, cfg.vocab_size)])
    prompts = serve_prompts(cfg.vocab_size)
    lp = {"logprobs": 2}
    problems: list[str] = []
    loops = {k: LoopThread(f"{k}-loop")
             for k in ("store", "decode", "prefill", "frontend")}
    faulthandler.dump_traceback_later(900, exit=True)
    try:
        server, _ = loops["store"].run(serve_store("127.0.0.1", 0))
        cp_port = server.sockets[0].getsockname()[1]
        base = ["in=endpoint", "out=torch", "--model-config", name,
                "--model-name", name, "--control-plane",
                f"127.0.0.1:{cp_port}"]
        parse = launch.build_parser().parse_intermixed_args
        args_d = parse(base + ["--role", "decode",
                               "--max-local-prefill-length", "64"])
        args_p = parse(base + ["--role", "prefill"])
        ps = args_d.page_size
        t0 = time.monotonic()
        _, chain_d = launch.build_chain(args_d, params=params, tokenizer=tok)
        _, chain_p = launch.build_chain(args_p, params=params, tokenizer=tok)
        eng_d, eng_p = chain_d.engine, chain_p.engine
        marks = record_marks(eng_d)
        rt_d = loops["decode"].run(launch.connect_runtime(args_d))
        served = loops["decode"].run(launch.serve_worker(
            args_d, chain_d, rt_d, lease_ttl_s=10.0))
        dis = served.engine
        rt_p = loops["prefill"].run(launch.connect_runtime(args_p))
        pworker = loops["prefill"].run(launch.serve_prefill_worker(
            args_p, chain_p, rt_p))
        torch.cuda.synchronize()
        t_up = time.monotonic() - t0
        mem = torch.cuda.memory_allocated()

        async def frontend_up():
            rt = await launch.connect_runtime(args_d)
            manager = ModelManager()
            watcher = await ModelWatcher(
                rt, manager,
                router_config=KvRouterConfig(router_temperature=0.0),
                tokenizer=tok).start()
            svc = HttpService(manager, host="127.0.0.1", port=0)
            await svc.start()
            for _ in range(600):
                if manager.list_models() == [name]:
                    break
                await asyncio.sleep(0.05)
            return rt, watcher, svc, manager.list_models()

        rt, watcher, svc, models = loops["frontend"].run(frontend_up())
        if models != [name] or type(dis).__name__ != "DisaggDecodeEngine":
            raise AssertionError(f"disagg: the frontend serves {models}, "
                                 f"the decode worker {type(dis).__name__}")
        log(f"disagg: store on 127.0.0.1:{cp_port}, decode worker "
            f"{served.lease_id} (DisaggDecodeEngine over TorchEngine on "
            f"{eng_d.device}, max_local_prefill_length "
            f"{dis.conf.current.max_local_prefill_length}, prefill timeout "
            f"{dis.prefill_timeout_s} s, kv_transfer_chunk_pages "
            f"{eng_p.ecfg.kv_transfer_chunk_pages}) and prefill worker up in "
            f"{t_up:.1f} s; {mem / 2**30:.2f} GiB allocated with both "
            f"engines up (one weight copy: "
            f"{eng_d.params is params and eng_p.params is params}); {smi}")

        def take_marks():
            out = dict(marks)
            marks.clear()
            return out

        async def one_by_one(label, ps_list):
            out, done = [], []
            async with HttpClient("127.0.0.1", svc.port) as c:
                for p in ps_list:
                    out.append(await stream_completion(c, p, name, label,
                                                       **lp))
                    done.append(dict(dis.last_done or {}))
                    await settle_engines(eng_d, eng_p)
            return out, done

        async def burst(label):
            clients = [HttpClient("127.0.0.1", svc.port) for _ in prompts]
            try:
                return await asyncio.wait_for(asyncio.gather(*[
                    stream_completion(c, p, name, label, **lp)
                    for c, p in zip(clients, prompts)]), 120)
            finally:
                for c in clients:
                    await c.close()

        fb0 = KV_TRANSFER.get("dynamo_disagg_fallback_total")
        # every kernel count to 0 just before the main path
        fd.launches = fd.launches_int8 = 0
        eng_d.kernel_launches = eng_p.kernel_launches = 0
        fd.executed(eng_d.device, reset=True)
        steps0 = (eng_d.step_count, eng_p.step_count)

        # ---- wave A: one at a time
        w0 = wire_totals()
        tl.STREAM_EVENTS.clear()
        res_a, done_a = asyncio.run(one_by_one("disagg wave A", prompts))
        w1 = wire_totals()
        # ---- telemetry of wave A: the spans and the stream timeline
        t_tel = time.monotonic()
        stream = tl.STREAM_EVENTS.snapshot()
        trees = asyncio.run(check_trace_trees(
            svc.port, frontend_trace_ids(len(prompts)), "disagg",
            ["tokenize", "route"],
            -(-(N_NEW - 1) // eng_d.ecfg.flush_every)))
        chunks_seen = []
        for tree, done in zip(trees, done_a):
            byname = {sp["name"]: sp for sp in tree["spans"]}
            rp = byname.get("remote_prefill") or {}
            kids = [c["name"] for c in rp.get("children") or []]
            chunks_seen.append(len(kids))
            if ("disagg_kv_transfer" not in byname or not kids
                    or set(kids) != {"kv_chunk"}
                    or len(kids) != done.get("chunks")):
                problems.append(
                    f"disagg: a wave A trace has spans "
                    f"{sorted(byname)} and remote_prefill children {kids}; "
                    f"P's done message counted {done.get('chunks')} chunks")
        kinds = {k: sum(e["kind"] == k for e in stream) for k in (
            tl.FRAME_SEND, tl.FRAME_RECV, tl.EOF_ACK_WAIT,
            tl.COMMIT_WAKEUP)}
        if (kinds[tl.FRAME_SEND] != sum(chunks_seen)
                or kinds[tl.FRAME_RECV] != sum(chunks_seen)
                or kinds[tl.EOF_ACK_WAIT] != len(prompts)
                or not kinds[tl.COMMIT_WAKEUP]):
            problems.append(f"disagg: wave A's stream events {kinds} for "
                            f"{sum(chunks_seen)} chunks in {len(prompts)} "
                            f"streams")
        tel = (f"{len(trees)} wave A trace trees with disagg_kv_transfer "
               f"and remote_prefill ({sum(chunks_seen)} kv_chunk children "
               f"in all: {chunks_seen}); stream events {kinds}; the checks "
               f"took {time.monotonic() - t_tel:.1f} s")
        ma = take_marks()
        got_a = [(ma[tuple(p)]["tokens"], ma[tuple(p)]["top"])
                 for p in prompts]
        ttft_a, _, _, _ = parse_streams(res_a, [t for t, _ in got_a],
                                        "disagg wave A")
        split_a, bad = part_ways("disagg wave A", got_a, direct_tokens)
        problems += bad
        tail_a = [ma[tuple(p)]["timing"]["ttft_s"] for p in prompts]
        sent = [d.get("blocks") for d in done_a]
        matched = [ma[tuple(p)]["cached"] for p in prompts]
        matchable = [(len(p) - 1) // ps for p in prompts]
        if sent != matchable or matched != matchable:
            problems.append(f"disagg wave A: P sent {sent} blocks, D "
                            f"matched {matched}, the prompts have "
                            f"{matchable} matchable")
        counts_a = (dis.remote_prefills, dis.local_prefills,
                    dis.remote_fallbacks)
        if counts_a != (8, 0, 0):
            problems.append(f"disagg wave A: remote, local, fallbacks "
                            f"{counts_a}, want (8, 0, 0)")
        # ---- the wire's own check: D's pages are P's, byte for byte
        byte_equal = []
        for i in (0, len(prompts) - 1):
            hs = compute_block_hashes(prompts[i], ps, salt=name)[
                :matchable[i]]
            nd, dd = eng_d.export_pages_by_hash(hs)
            np_, pd = eng_p.export_pages_by_hash(hs)
            byte_equal.append(nd == np_ == len(hs) and same_bytes(dd, pd))
        if not all(byte_equal):
            problems.append(f"disagg: D's and P's pages byte-equal for "
                            f"prompts 0 and 7: {byte_equal}")

        # ---- wave B: both caches cleared, one ungated burst
        eng_d.clear_kv_blocks()
        eng_p.clear_kv_blocks()
        res_b = asyncio.run(burst("disagg wave B"))
        loops["frontend"].run(settle_engines(eng_d, eng_p))
        mb = take_marks()
        got_b = [(mb[tuple(p)]["tokens"], mb[tuple(p)]["top"])
                 for p in prompts]
        ttft_b, gaps_b, _, _ = parse_streams(
            res_b, [t for t, _ in got_b], "disagg wave B")
        split_b, bad = part_ways("disagg wave B", got_b,
                                 [t for t, _ in got_a])
        problems += bad
        counts_b = (dis.remote_prefills, dis.local_prefills,
                    dis.remote_fallbacks)
        if counts_b != (16, 0, 0) or KV_TRANSFER.get(
                "dynamo_disagg_fallback_total") != fb0:
            problems.append(f"disagg wave B: remote, local, fallbacks "
                            f"{counts_b}, want (16, 0, 0); fallback total "
                            f"moved {KV_TRANSFER.get('dynamo_disagg_fallback_total') - fb0}")

        # ---- fallback: the prefill worker stopped; the remote prefill's
        # timeout cut from the launcher's 60 s to DISAGG_FALLBACK_S for
        # this request only (waves A and B ran at the default: an
        # ungated burst of 8 queued on P came within a second of 5 s)
        dis.prefill_timeout_s = DISAGG_FALLBACK_S
        loops["prefill"].run(pworker.stop())
        eng_d.clear_kv_blocks()
        t0 = time.monotonic()
        res_f, _ = asyncio.run(one_by_one("disagg fallback", prompts[:1]))
        t_fallback = time.monotonic() - t0
        mf = take_marks()
        got_f = mf[tuple(prompts[0])]["tokens"]
        parse_streams(res_f, [got_f], "disagg fallback")
        fell = (dis.remote_fallbacks - counts_b[2],
                KV_TRANSFER.get("dynamo_disagg_fallback_total") - fb0)
        if fell != (1, 1):
            problems.append(f"disagg fallback: remote_fallbacks and "
                            f"dynamo_disagg_fallback_total rose by {fell}, "
                            f"want (1, 1)")

        # ---- the counts, once both engines idle
        loops["frontend"].run(settle_engines(eng_d, eng_p))
        torch.cuda.synchronize()
        dense, int8 = fd.executed(eng_d.device)
        issued = fd.launches + fd.launches_int8
        steps_d = eng_d.step_count - steps0[0]
        steps_p = eng_p.step_count - steps0[1]
        check_kv_launches("disagg", [eng_d, eng_p], dense, int8, issued,
                          steps_d + steps_p, cfg.num_layers)

        # ---- the same paths through generate() on one engine: the
        # prompt prefilled alone (max_tokens=1, as P runs it), then
        # served from that prefix hit (as D serves it); the fallback
        # prompt alone on a cold cache
        same = {"A": 0, "fallback": 0}

        def hold(wave, i, got, want):
            if got == want:
                same[wave] += 1
                return
            j = next((j for j, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
            problems.append(
                f"disagg {wave}: prompt {i} streamed {got[j:j + 1]} at "
                f"step {j} where generate() on the same path gave "
                f"{want[j:j + 1]}")

        t0 = time.monotonic()
        for i, p in enumerate(prompts):
            eng_d.clear_kv_blocks()
            asyncio.run(generate_all(eng_d, [p], 1))
            hold("A", i, got_a[i][0], rerun(eng_d, [p], burst=False)[0])
        eng_d.clear_kv_blocks()
        hold("fallback", 0, got_f, rerun(eng_d, prompts[:1], burst=False)[0])
        take_marks()
        t_replay = time.monotonic() - t0

        async def frontend_down():
            await svc.stop()
            await watcher.stop()
            await rt.close()

        loops["frontend"].run(frontend_down())
        loops["decode"].run(served.shutdown())
        loops["decode"].run(rt_d.close())
        loops["prefill"].run(rt_p.close())
        loops["decode"].run(eng_d.stop())
        loops["prefill"].run(eng_p.stop())

        async def store_down():
            server.close()
            await server.wait_closed()

        loops["store"].run(store_down())
    finally:
        faulthandler.cancel_dump_traceback_later()
        for lt in loops.values():
            lt.close()

    c2 = kv["ttft_c2"]
    wire_bytes = w1[0] - w0[0]
    wire_s = w1[2] - w0[2]
    gbs = wire_bytes / wire_s / 1e9 if wire_s else float("nan")
    per = "; ".join(
        f"{len(p)} tok: {d.get('prefill_ms', float('nan')):.1f} ms, "
        f"{d.get('chunks')} chunks, overlap {d.get('overlap_ratio')}"
        for p, d in zip(prompts, done_a))
    log(f"disagg wave A: 8 streamed /v1/completions one at a time, each "
        f"prefilled on P and streamed into D ({counts_a[0]} remote, "
        f"{counts_a[1]} local, {counts_a[2]} fallbacks); blocks sent = D's "
        f"matched = {sum(sent)} of {sum(matchable)} matchable; "
        f"{describe_splits(split_a)} to the serve phase's generate(); TTFT "
        f"(client) median {np.median(ttft_a):.4f} s max {max(ttft_a):.4f} "
        f"s beside kv router C' (a whole-prompt recompute on one engine, "
        f"at the frontend) {np.median(c2):.4f} s max {max(c2):.4f} s: "
        f"ratio {np.median(ttft_a) / np.median(c2):.3f}; D's tail prefill "
        f"(intake to first token, after the transfer) median "
        f"{np.median(tail_a):.4f} s max {max(tail_a):.4f} s; {smi}")
    log(f"disagg wave A per prompt (P's done message): {per}")
    log(f"disagg telemetry: {tel}")
    log(f"disagg wire: {wire_bytes / 2**20:.1f} MiB sent in wave A over "
        f"{wire_s:.3f} s of whole moves (dynamo_kv_transfer_seconds): "
        f"{gbs:.2f} GB/s; D's pages byte-equal to P's for prompts 0 and 7: "
        f"{byte_equal}")
    log(f"disagg wave B: 8 as one ungated burst, caches cleared: "
        f"{counts_b[0]} remote in all, {counts_b[1]} local, {counts_b[2]} "
        f"fallbacks; {describe_splits(split_b)} to wave A; TTFT median "
        f"{np.median(ttft_b):.4f} s max {max(ttft_b):.4f} s; D's gap "
        f"median {np.median(gaps_b) * 1e3:.2f} ms max "
        f"{max(gaps_b) * 1e3:.2f} ms beside kv router wave A's "
        f"{np.median(kv['gaps_a']) * 1e3:.2f} ms, "
        f"{max(kv['gaps_a']) * 1e3:.2f} ms")
    log(f"disagg fallback: P stopped; prompt 0 fell back to a local prefill "
        f"after the {dis.prefill_timeout_s} s timeout ({t_fallback:.2f} s "
        f"in all); remote_fallbacks and dynamo_disagg_fallback_total rose "
        f"by {fell[0]} and {fell[1]}")
    why_p = (" (P's max_tokens=1 requests: a pipelined decode round is "
             "dispatched for the slot before its first token is read)"
             if steps_p else "")
    log(f"disagg: {steps_d} decode steps on D and {steps_p} on P{why_p}, "
        f"flash_decode launches "
        f"{dense} (counted by the kernel on the card) = {cfg.num_layers} x "
        f"{steps_d + steps_p}; identical to generate() along the same path: "
        f"wave A {same['A']}/8, fallback {same['fallback']}/1 (replayed in "
        f"{t_replay:.1f} s)")
    if problems:
        raise AssertionError("disagg: " + "; ".join(problems))
    figures(f"16/16 remote, 0 fallbacks, fallback counted 1; matched = sent "
            f"{sum(sent)}/{sum(matchable)}; pages byte-equal; same path "
            f"{same['A']}/8; TTFT median {np.median(ttft_a):.4f} s (C' "
            f"{np.median(c2):.4f}); overlap "
            f"{np.median([d.get('overlap_ratio') or 0 for d in done_a]):.3f}"
            f"; wire {gbs:.2f} GB/s; wave B gap max {max(gaps_b) * 1e3:.1f} "
            f"ms; launches {dense} = {cfg.num_layers} x ({steps_d} D + "
            f"{steps_p} P); "
            f"{mem / 2**30:.2f} GiB")
    del eng_d, eng_p, chain_d, chain_p, dis
    gc.collect()
    torch.cuda.empty_cache()
    return dense, dict(ttft=ttft_a, tail=tail_a, gbs=gbs)


async def timed_generate(eng, prompt, model="llama3_8b"):
    """One greedy request of N_NEW tokens with top-2 logprobs straight to
    ``eng.generate()``: (tokens, top logprobs, seconds from the call to
    the first token, final annotations)."""
    from dynamo_tpu_torch.protocols.common import (
        OutputOptions,
        PreprocessedRequest,
        StopConditions,
    )

    req = PreprocessedRequest(
        token_ids=list(prompt), model=model,
        stop_conditions=StopConditions(max_tokens=N_NEW, ignore_eos=True),
        output_options=OutputOptions(logprobs=2))
    toks, top, first, ann = [], [], None, {}
    t0 = time.monotonic()
    async for out in eng.generate(req):
        if out.token_ids and first is None:
            first = time.monotonic() - t0
        toks.extend(out.token_ids)
        top.extend(out.top_logprobs or [])
        if out.finish_reason is not None:
            ann = out.annotations
    return toks, top, first, ann


def check_remote_kv(params, smi):
    """KVBM G4 at Llama-3.1-8B, int8 KV: the port's store and two
    aggregated in=endpoint workers (launch.run's build_chain and
    serve_worker with ``--remote-kv --kv-quant int8 --host-offload-pages
    128``: each serves its pool on the transfer plane and fetches prefix
    misses from its peer's), W1 and W2, each on its own loop thread, on
    the serve phase's weights. Wave A: the 8 prompts one at a time
    straight to W1's engine: W1 probes W2, misses and recomputes. Wave G:
    the 8 one at a time straight to W2's engine: each prefix is fetched
    from W1 over the wire into W2's G2 and onboarded (remote_onboard_
    blocks reaches every matchable block, the engine matches them all and
    prefills only the tail), the onboarded pages and scales are
    byte-equal to W1's, and the streams are identical to W1's same-path
    replay (the prompt again on W1, from its G1 prefix hit); wave A's
    streams to a cold replay on W1 without G4. Miss: W1's transfer server
    stopped, a fresh prompt on W2 costs at most one probe timeout, then
    recomputes, with the tokens of a cold replay. The int8 kernel's own
    count rises by layers x both engines' decode steps. Prints TTFT per
    wave and G/A per prompt, the probe round's and the fetches' ms, wire
    GB/s, and memory with both engines up."""
    from dynamo_tpu_torch.kv_transfer import BlockTransferServer
    from dynamo_tpu_torch.launch import run as launch
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.runtime.store import serve_store
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer
    from dynamo_tpu_torch.tokens import compute_block_hashes

    cfg = ModelConfig.llama3_8b()
    name = "llama3_8b"
    tok = make_test_tokenizer([f"t{i}" for i in range(3, cfg.vocab_size)])
    prompts = serve_prompts(cfg.vocab_size)
    fresh = offload_prompts(cfg.vocab_size)[0]
    problems: list[str] = []
    loops = {k: LoopThread(f"{k}-loop") for k in ("store", "w1", "w2")}
    faulthandler.dump_traceback_later(900, exit=True)
    try:
        server, _ = loops["store"].run(serve_store("127.0.0.1", 0))
        cp_port = server.sockets[0].getsockname()[1]
        args = launch.build_parser().parse_intermixed_args(
            ["in=endpoint", "out=torch", "--model-config", name,
             "--model-name", name, "--control-plane", f"127.0.0.1:{cp_port}",
             "--remote-kv", "--kv-quant", "int8", "--host-offload-pages",
             "128"])
        ps = args.page_size
        t0 = time.monotonic()
        chains = [launch.build_chain(args, params=params, tokenizer=tok)[1]
                  for _ in range(2)]
        engs = [c.engine for c in chains]
        ws = ("w1", "w2")
        rts = [loops[w].run(launch.connect_runtime(args)) for w in ws]
        served = [loops[w].run(launch.serve_worker(
            args, c, r, lease_ttl_s=10.0)) for w, c, r in zip(ws, chains, rts)]
        torch.cuda.synchronize()
        t_up = time.monotonic() - t0
        mem = torch.cuda.memory_allocated()
        probe_timeout = engs[0].remote_kv.timeout_s
        fetches: list[list] = []
        for e in engs:
            rec: list = []
            fetch = e.remote_kv.fetch

            async def timed_fetch(hashes, on_chunk=None, holders=None,
                                  fetch=fetch, rec=rec):
                t = time.monotonic()
                got = await fetch(hashes, on_chunk=on_chunk, holders=holders)
                rec.append(((time.monotonic() - t) * 1e3, got[0],
                            len(hashes)))
                return got

            e.remote_kv.fetch = timed_fetch
            fetches.append(rec)
        log(f"remote kv: store on 127.0.0.1:{cp_port}, workers "
            f"{[s.lease_id for s in served]} (TorchEngine on "
            f"{engs[0].device}, kv_quant int8, G2 "
            f"{engs[0].offload.num_pages} pages, G4 chunk pages "
            f"{engs[0].remote_kv.chunk_pages}, probe timeout "
            f"{engs[0].remote_kv.timeout_s} s) up in {t_up:.1f} s; "
            f"{mem / 2**30:.2f} GiB allocated with both engines up; {smi}")

        def wave(k, ps_list):
            out = []
            for p in ps_list:
                out.append(loops[ws[k]].run(timed_generate(engs[k], p)))
                loops[ws[k]].run(settle_engines(*engs))
            return out

        # every kernel count to 0 just before the main path
        fd.launches = fd.launches_int8 = 0
        for e in engs:
            e.kernel_launches = 0
        fd.executed(engs[0].device, reset=True)
        steps0 = [e.step_count for e in engs]
        res_a = wave(0, prompts)
        onboard0 = engs[1].remote_onboard_blocks
        w0 = wire_totals()
        res_g = wave(1, prompts)
        w1 = wire_totals()
        onboarded = engs[1].remote_onboard_blocks - onboard0
        # ---- miss: W1's transfer server down, a fresh prompt on W2
        srv1 = next(p for p in served[0].parts
                    if isinstance(p, BlockTransferServer))
        loops["w1"].run(srv1.stop())
        n_fetch = len(fetches[1])
        res_m = wave(1, [fresh])[0]
        miss_fetch = fetches[1][n_fetch:]
        # ---- the counts, once both engines idle
        loops["w1"].run(settle_engines(*engs))
        torch.cuda.synchronize()
        dense, int8 = fd.executed(engs[0].device)
        issued = fd.launches + fd.launches_int8
        steps = sum(e.step_count - s for e, s in zip(engs, steps0))
        check_kv_launches("remote kv", engs, dense, int8, issued, steps,
                          cfg.num_layers, quant=True)
        # ---- wave G's pages and scales are W1's, byte for byte
        matchable = [(len(p) - 1) // ps for p in prompts]
        byte_equal = 0
        for p, n in zip(prompts, matchable):
            hs = compute_block_hashes(p, ps, salt=name)[:n]
            f1, d1 = engs[0].export_pages_by_hash(hs)
            f2, d2 = engs[1].export_pages_by_hash(hs)
            byte_equal += f1 == f2 == n and same_bytes(d1, d2)
        matched_g = [r[3].get("cached_blocks") for r in res_g]
        if onboarded != sum(matchable) or matched_g != matchable \
                or byte_equal != len(prompts):
            problems.append(
                f"remote kv wave G: W2 onboarded {onboarded} blocks from W1 "
                f"and matched {matched_g}; the prompts have {matchable} "
                f"matchable; pages byte-equal for {byte_equal} of 8")
        found_a = [f[1] for f in fetches[0][:len(prompts)]]
        found_g = [f[1] for f in fetches[1][:len(prompts)]]
        if any(found_a) or found_g != matchable:
            problems.append(f"remote kv: wave A's probes found {found_a}, "
                            f"wave G's fetches {found_g}")
        if len(miss_fetch) != 1 or miss_fetch[0][1] != 0 or \
                miss_fetch[0][0] > probe_timeout * 1e3 + 250:
            problems.append(f"remote kv miss: fetches {miss_fetch} (ms, "
                            f"found, asked), want one miss within the "
                            f"{probe_timeout} s probe timeout")
        # ---- the same paths through generate() on one engine: wave G
        # as W1's prefix hit; wave A and the miss cold, without G4
        same = {"G": 0, "A": 0, "miss": 0}

        def hold(wave_name, i, got, want):
            if got == want:
                same[wave_name] += 1
                return
            j = next((j for j, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
            problems.append(
                f"remote kv {wave_name}: prompt {i} streamed {got[j:j + 1]} "
                f"at step {j} where generate() on the same path gave "
                f"{want[j:j + 1]}")

        t0 = time.monotonic()
        for i, p in enumerate(prompts):
            hold("G", i, res_g[i][0],
                 loops["w1"].run(timed_generate(engs[0], p))[0])
        for e in engs:
            e.remote_kv = None
        for i, p in enumerate(prompts):
            engs[0].clear_kv_blocks()
            hold("A", i, res_a[i][0],
                 loops["w1"].run(timed_generate(engs[0], p))[0])
        engs[1].clear_kv_blocks()
        hold("miss", 0, res_m[0],
             loops["w2"].run(timed_generate(engs[1], fresh))[0])
        t_replay = time.monotonic() - t0
        split_g, _ = part_ways("remote kv wave G",
                               [(t, top) for t, top, _, _ in res_g],
                               [t for t, _, _, _ in res_a])
        for k, w in enumerate(ws):
            loops[w].run(served[k].shutdown())
            loops[w].run(rts[k].close())
            loops[w].run(engs[k].stop())

        async def store_down():
            server.close()
            await server.wait_closed()

        loops["store"].run(store_down())
    finally:
        faulthandler.cancel_dump_traceback_later()
        for lt in loops.values():
            lt.close()

    ttft_a = [r[2] for r in res_a]
    ttft_g = [r[2] for r in res_g]
    ratio = [g / a for g, a in zip(ttft_g, ttft_a)]
    probe_a = [f[0] for f in fetches[0][:len(prompts)]]
    fetch_g = [f[0] for f in fetches[1][:len(prompts)]]
    rx = w1[1] - w0[1]
    gbs = rx / (sum(fetch_g) / 1e3) / 1e9
    log(f"remote kv wave A: 8 one at a time straight to W1: each probe of "
        f"W2 missed (found {sum(found_a)}), recomputed; TTFT (the call to "
        f"the first token) median {np.median(ttft_a):.4f} s max "
        f"{max(ttft_a):.4f} s; the probe round median "
        f"{np.median(probe_a):.2f} ms max {max(probe_a):.2f} ms; {smi}")
    log(f"remote kv wave G: 8 one at a time straight to W2: each prefix "
        f"fetched from W1's pool into W2's G2 and onboarded: "
        f"{onboarded} of {sum(matchable)} matchable blocks, matched "
        f"{sum(matched_g)}, pages and scales byte-equal to W1's for "
        f"{byte_equal}/8 prompts; TTFT median {np.median(ttft_g):.4f} s max "
        f"{max(ttft_g):.4f} s; G/A per prompt "
        f"{', '.join(f'{r:.3f}' for r in ratio)} (median "
        f"{np.median(ratio):.3f}); fetch median {np.median(fetch_g):.2f} ms "
        f"max {max(fetch_g):.2f} ms; {rx / 2**20:.1f} MiB received over "
        f"{sum(fetch_g) / 1e3:.3f} s of fetches: {gbs:.2f} GB/s; "
        f"{describe_splits(split_g)} to wave A")
    log(f"remote kv miss: W1's transfer server stopped; a fresh "
        f"{len(fresh)}-token prompt on W2: fetch "
        f"{miss_fetch[0][0] if miss_fetch else float('nan'):.2f} ms "
        f"(probe timeout {probe_timeout} s), found 0, recomputed, TTFT "
        f"{res_m[2]:.4f} s")
    log(f"remote kv: {steps} decode steps over both engines, int8 "
        f"flash_decode launches {int8} (counted by the kernel on the card) "
        f"= {cfg.num_layers} x {steps}; identical to generate() along the "
        f"same path: wave G {same['G']}/8 (W1's prefix hit), wave A "
        f"{same['A']}/8 (cold), miss {same['miss']}/1 (replayed in "
        f"{t_replay:.1f} s)")
    if problems:
        raise AssertionError("remote kv: " + "; ".join(problems))
    figures(f"onboarded {onboarded}/{sum(matchable)} from the peer, pages "
            f"byte-equal {byte_equal}/8, same path G {same['G']}/8 A "
            f"{same['A']}/8 miss {same['miss']}/1; TTFT A "
            f"{np.median(ttft_a):.4f} s, G {np.median(ttft_g):.4f} s (G/A "
            f"{np.median(ratio):.3f}); fetch {np.median(fetch_g):.1f} ms, "
            f"{gbs:.2f} GB/s; miss "
            f"{miss_fetch[0][0] if miss_fetch else float('nan'):.1f} ms; "
            f"int8 launches {int8} = {cfg.num_layers} x {steps}; "
            f"{mem / 2**30:.2f} GiB")
    del engs, chains
    gc.collect()
    torch.cuda.empty_cache()
    return int8, dict(ttft_a=ttft_a, ttft_g=ttft_g, gbs=gbs)


def check_resilience(params):
    """The resilience plane at Llama-3.1-8B, dense KV: the port's store,
    two workers W1 and W2 (launch.run's build_chain on the one weight
    copy, each through launch.run.serve_worker with --system-port 0 and
    --drain-timeout 30, so each runs a system server and a drain
    controller, each on its own loop thread) and a KV-routing frontend
    with --health-heartbeat-ttl 2 (ModelWatcher with
    KvRouterConfig(router_temperature=0.0), its shared breaker board
    running); every request asks top-2 logprobs.

    Migration: kill_worker armed with after=3 (outputs: the first token,
    then two rounds of 4), once, through a worker's POST /chaos; one
    serve prompt streamed for 32 tokens through the frontend must end in
    [DONE] with 32 tokens and finish_reason length; the point fires once
    and dynamo_resilience_chaos_injections_total and
    dynamo_migration_total each rise by 1; the k tokens before the kill
    must equal generate()'s for the prompt alone and the other 32 - k
    generate()'s for the replay request (prompt + the k tokens), each on
    a cold cache on one engine (the paths the two workers took).

    Drain: 4 serve prompts through the frontend, gated at both workers'
    intakes; as soon as one worker's share all has its first token out of
    its engine and none has finished (the workers prefill their shares
    at their own pace on one card), POST /drain to that worker's system
    server (W1). Its streams finish whole, equal to generate() on one engine along the
    same path (its share as one gated burst); its lease is revoked (the
    router drops it); GET /drain reads draining, then drained; 4 new
    prompts then all land on W2 and none fails; a request straight to
    W1's engine raises WorkerDrainingError; dynamo_resilience_drains_total
    rises by 1. Scrape: W2's GET /metrics carries the uptime, W2's
    ForwardPassMetrics gauges and the resilience families. The kernel's
    own count on the card rises by layers x both workers' decode steps
    (the kernels line's launches_resilience). No chaos point is left
    armed. Returns (launches, figures)."""
    import random

    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.frontend.watcher import ModelWatcher
    from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig
    from dynamo_tpu_torch.launch import run as launch
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.resilience.chaos import CHAOS
    from dynamo_tpu_torch.resilience.drain import WorkerDrainingError
    from dynamo_tpu_torch.resilience.metrics import RESILIENCE
    from dynamo_tpu_torch.resilience.migration import build_replay_request
    from dynamo_tpu_torch.runtime.store import serve_store
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer

    cfg = ModelConfig.llama3_8b()
    name = "llama3_8b"
    tok = make_test_tokenizer([f"t{i}" for i in range(3, cfg.vocab_size)])
    prompts = serve_prompts(cfg.vocab_size)
    fresh = offload_prompts(cfg.vocab_size)[:4]
    lp = {"logprobs": 2}
    # the point counts outputs: the engine sends the first token alone and
    # then a round's flush_every tokens as one output, so a kill after 3
    # outputs lands after 1 + 2 x 4 = 9 tokens, with 23 left to replay
    kill_after = 3
    loops = {k: LoopThread(f"{k}-loop")
             for k in ("store", "worker0", "worker1", "frontend")}
    faulthandler.dump_traceback_later(900, exit=True)
    try:
        server, _ = loops["store"].run(serve_store("127.0.0.1", 0))
        cp = f"127.0.0.1:{server.sockets[0].getsockname()[1]}"
        args = launch.build_parser().parse_intermixed_args(
            ["in=endpoint", "out=torch", "--model-config", name,
             "--model-name", name, "--control-plane", cp,
             "--system-port", "0", "--drain-timeout", "30"])
        fargs = launch.build_parser().parse_intermixed_args(
            ["in=http", "--control-plane", cp, "--health-heartbeat-ttl",
             "2"])
        t0 = time.monotonic()
        engs, marks, chains, rts, served = [], [], [], [], []
        for k in range(2):
            _, chain = launch.build_chain(args, params=params,
                                          tokenizer=tok)
            chains.append(chain)
            engs.append(chain.engine)
            marks.append(record_marks(chain.engine))
        for k, chain in enumerate(chains):
            lt = loops[f"worker{k}"]
            rts.append(lt.run(launch.connect_runtime(args)))
            served.append(lt.run(launch.serve_worker(
                args, chain, rts[k], lease_ttl_s=10.0)))
        torch.cuda.synchronize()
        t_workers = time.monotonic() - t0
        wids = [str(s.lease_id) for s in served]
        sys_ports = [s.system.port for s in served]

        async def frontend_up():
            rt = await launch.connect_runtime(fargs)
            manager = ModelManager()
            watcher = await ModelWatcher(
                rt, manager,
                router_config=KvRouterConfig(router_temperature=0.0),
                tokenizer=tok,
                heartbeat_ttl_s=fargs.health_heartbeat_ttl).start()
            svc = HttpService(manager, host="127.0.0.1", port=0)
            await svc.start()
            for _ in range(600):
                push = watcher._routers.get(name)
                if push is not None and sorted(push.workers) == sorted(wids):
                    break
                await asyncio.sleep(0.05)
            return rt, watcher, svc

        rt, watcher, svc = loops["frontend"].run(frontend_up())
        push = watcher._routers.get(name)
        if push is None or sorted(push.workers) != sorted(wids):
            raise AssertionError(f"resilience: the frontend routes over "
                                 f"{None if push is None else push.workers}"
                                 f", the workers are {wids}")
        if (watcher.health.heartbeat_ttl_s != 2.0
                or watcher._breaker_board is None):
            raise AssertionError("resilience: the frontend runs no heartbeat "
                                 "TTL or breaker board")
        push.router.scheduler.selector.rng = random.Random(SEED)
        log(f"resilience: store on {cp}, workers {wids} with system servers "
            f"on ports {sys_ports} (drain timeout {args.drain_timeout} s) "
            f"built and registered in {t_workers:.1f} s; frontend on "
            f"127.0.0.1:{svc.port} (heartbeat TTL "
            f"{fargs.health_heartbeat_ttl} s, breaker board on)")

        async def call(port, method, path, body=None):
            async with HttpClient("127.0.0.1", port) as c:
                r = await c.request(method, path, json_body=body)
            return r.status, (r.json() if r.headers.get(
                "content-type", "").startswith("application/json")
                else r.body.decode())

        def take_marks():
            out = [dict(m) for m in marks]
            for m in marks:
                m.clear()
            return out

        # every kernel count to 0 just before the main path
        fd.launches = fd.launches_int8 = 0
        for e in engs:
            e.kernel_launches = 0
        fd.executed(engs[0].device, reset=True)
        steps0 = [e.step_count for e in engs]
        inj0 = RESILIENCE.get("dynamo_resilience_chaos_injections_total")
        mig0 = RESILIENCE.get("dynamo_migration_total")
        drains0 = RESILIENCE.get("dynamo_resilience_drains_total")
        try:
            # ---- migration: a kill after 8 outputs, armed over HTTP
            status, point = asyncio.run(call(
                sys_ports[1], "POST", "/chaos", {
                    "point": "kill_worker", "after_outputs": kill_after,
                    "once": True}))
            if status != 200 or not point["armed"]:
                raise AssertionError(f"resilience: POST /chaos gave {status} "
                                     f"{point}")

            async def one(p):
                async with HttpClient("127.0.0.1", svc.port) as c:
                    r = await stream_completion(c, p, name,
                                                "resilience migration", **lp)
                await settle_engines(*engs)
                return r

            res_m = asyncio.run(one(prompts[0]))
            mm = take_marks()
            injected = CHAOS.points["kill_worker"].injected_total
            if CHAOS.any_armed() or injected != 1:
                raise AssertionError(f"resilience: kill_worker fired "
                                     f"{injected} times, armed "
                                     f"{CHAOS.any_armed()}")
            orig = [k for k in range(2) if tuple(prompts[0]) in mm[k]]
            replays = [(k, key) for k in range(2) for key in mm[k]
                       if len(key) > len(prompts[0])
                       and key[:len(prompts[0])] == tuple(prompts[0])]
            if len(orig) != 1 or len(replays) != 1 \
                    or replays[0][0] == orig[0]:
                raise AssertionError(f"resilience: the prompt reached "
                                     f"workers {orig}, its replay "
                                     f"{[k for k, _ in replays]}")
            k_orig, (k_rep, rep_key) = orig[0], replays[0]
            m0 = mm[k_orig][tuple(prompts[0])]
            # the TTFT split: send to the engine's intake, intake to the
            # engine's first output
            split_m = (m0["in"] - res_m[0], m0["first"] - m0["in"])
            emitted = list(rep_key[len(prompts[0]):])
            first = mm[k_orig][tuple(prompts[0])]["tokens"][:len(emitted)]
            rest = mm[k_rep][rep_key]["tokens"]
            migrated = first + rest
            ttft_m, gaps_m, _, _ = parse_streams(
                [res_m], [migrated], "resilience migration")
            k_tok = len(emitted)
            if emitted != first or not 0 < k_tok < N_NEW \
                    or len(migrated) != N_NEW:
                raise AssertionError(
                    f"resilience: the replay carried {len(emitted)} tokens "
                    f"(the killed stream gave {first}), the client "
                    f"{len(migrated)} in all")
            inj = RESILIENCE.get(
                "dynamo_resilience_chaos_injections_total") - inj0
            mig = RESILIENCE.get("dynamo_migration_total") - mig0
            if (inj, mig) != (1, 1):
                raise AssertionError(f"resilience: chaos injections +{inj}, "
                                     f"migrations +{mig}")
            # the gap at the kill: the client's wait for the first token
            # after it
            t_send, events, arrivals = res_m
            n_seen, t_prev, kill_gap = 0, None, None
            for ev, t in zip(events[:-1], arrivals):
                n = len(ev.json()["choices"][0]["text"].split())
                if n and n_seen <= k_tok < n_seen + n:
                    kill_gap = t - t_prev
                if n:
                    n_seen, t_prev = n_seen + n, t

            # ---- drain: 4 in flight, then POST /drain to the busier
            # worker
            burst = prompts[1:5]
            gate = IntakeGate(engs, len(burst))

            async def drain_wave():
                clients = [HttpClient("127.0.0.1", svc.port)
                           for _ in burst]
                try:
                    tasks = [asyncio.ensure_future(stream_completion(
                        c, p, name, "resilience drain", **lp))
                        for c, p in zip(clients, burst)]

                    def ready():
                        """The worker whose share of the burst all has a
                        first token and none has finished, if any."""
                        where = [[k for k in range(2) if tuple(p) in marks[k]]
                                 for p in burst]
                        if any(len(w) != 1 for w in where):
                            return None
                        for k in range(2):
                            ms = [marks[k][tuple(p)] for p in burst
                                  if tuple(p) in marks[k]]
                            if ms and all("first" in m and "timing" not in m
                                          for m in ms):
                                return k
                        return None

                    deadline = time.monotonic() + 120
                    while (d := ready()) is None:
                        done = [i for i, t in enumerate(tasks) if t.done()]
                        for i in done:
                            tasks[i].result()   # its failure, if it failed
                        if time.monotonic() > deadline or len(done) == len(
                                tasks):
                            seen = [{k: sorted(m[tuple(p)]) for k, m
                                     in enumerate(marks) if tuple(p) in m}
                                    for p in burst]
                            raise AssertionError(
                                f"resilience drain: no worker had its share "
                                f"of the burst in flight (marks {seen})")
                        await asyncio.sleep(0.001)
                    share = [sum(tuple(p) in marks[k] for p in burst)
                             for k in range(2)]
                    t_post = time.monotonic()
                    st, body = await call(sys_ports[d], "POST", "/drain")
                    st2, body2 = await call(sys_ports[d], "GET", "/drain")
                    if (st, body["state"], st2, body2["state"]) != (
                            200, "draining", 200, "draining"):
                        raise AssertionError(
                            f"resilience: POST /drain {st} {body}, GET "
                            f"/drain {st2} {body2} with streams in flight")
                    # polled while the streams run: POST to drained
                    while True:
                        st, body = await call(sys_ports[d], "GET", "/drain")
                        if body["state"] == "drained":
                            drain_s = time.monotonic() - t_post
                            break
                        if time.monotonic() - t_post > 60:
                            raise AssertionError(f"resilience: drain state "
                                                 f"{body}")
                        await asyncio.sleep(0.005)
                    res = await asyncio.wait_for(asyncio.gather(*tasks), 120)
                    return res, d, share, drain_s
                finally:
                    for c in clients:
                        await c.close()

            res_d, d, share, drain_s = asyncio.run(drain_wave())
            if not gate.open:
                raise AssertionError("resilience drain: the gate never "
                                     "opened")
            md = take_marks()
            live = 1 - d
            got_d = [md[k][tuple(p)]["tokens"] for p in burst
                     for k in range(2) if tuple(p) in md[k]]
            ttft_d, gaps_d, _, _ = parse_streams(res_d, got_d,
                                                 "resilience drain")
            mine = [i for i, p in enumerate(burst) if tuple(p) in md[d]]

            # ---- deregistered: the router drops W1; 4 new prompts on W2
            async def dropped():
                for _ in range(600):
                    if list(push.workers) == [wids[live]]:
                        return
                    await asyncio.sleep(0.02)
                raise AssertionError(f"resilience: the frontend still routes "
                                     f"over {list(push.workers)}")

            loops["frontend"].run(dropped())

            async def after():
                out = []
                async with HttpClient("127.0.0.1", svc.port) as c:
                    for p in fresh:
                        out.append(await stream_completion(
                            c, p, name, "resilience after drain", **lp))
                await settle_engines(*engs)
                return out

            res_a = asyncio.run(after())
            ma = take_marks()
            if any(tuple(p) not in ma[live] or tuple(p) in ma[d]
                   for p in fresh):
                raise AssertionError("resilience: a request after the drain "
                                     "did not land on the live worker")
            parse_streams(res_a, [ma[live][tuple(p)]["tokens"]
                                  for p in fresh], "resilience after drain")

            async def refused():
                try:
                    async for _ in engs[d].generate(PreprocessedRequest(
                            token_ids=list(fresh[0]), model=name)):
                        pass
                except WorkerDrainingError:
                    return True
                return False

            if not asyncio.run(refused()):
                raise AssertionError("resilience: the drained engine took a "
                                     "request")
            drains = RESILIENCE.get("dynamo_resilience_drains_total") \
                - drains0
            if drains != 1 or not engs[d].drained():
                raise AssertionError(f"resilience: drains +{drains}, "
                                     f"engine drained {engs[d].drained()}")

            # ---- scrape the live worker
            st, text = asyncio.run(call(sys_ports[live], "GET", "/metrics"))
            want_lines = (
                "# TYPE dynamo_system_uptime_seconds gauge",
                f'dynamo_worker_total_slots{{worker="{wids[live]}"}} '
                f'{engs[live].ecfg.max_decode_slots}',
                f'dynamo_kv_total_blocks{{worker="{wids[live]}"}}',
                "# TYPE dynamo_migration_total counter",
                "# TYPE dynamo_resilience_drains_total counter",
                "# TYPE dynamo_resilience_chaos_injections_total counter")
            missing = [w for w in want_lines if w not in text]
            st_h, health = asyncio.run(call(sys_ports[live], "GET",
                                            "/health"))
            if st != 200 or missing or st_h != 200:
                raise AssertionError(f"resilience: /metrics {st} lacks "
                                     f"{missing}; /health {st_h}")
        finally:
            CHAOS.reset()

        # ---- the counts, once both engines idle
        loops["frontend"].run(settle_engines(*engs))
        torch.cuda.synchronize()
        dense, int8 = fd.executed(engs[0].device)
        issued = fd.launches + fd.launches_int8
        steps = sum(e.step_count - s for e, s in zip(engs, steps0))
        check_kv_launches("resilience", engs, dense, int8, issued, steps,
                          cfg.num_layers)

        # ---- the same paths through generate() on the live engine
        ref = engs[live]
        problems = []

        def hold(what, got, want):
            if got != want:
                j = next((j for j, (a, b) in enumerate(zip(got, want))
                          if a != b), min(len(got), len(want)))
                problems.append(f"resilience {what}: step {j} gave "
                                f"{got[j:j + 1]} where generate() on the "
                                f"same path gave {want[j:j + 1]}")

        t0 = time.monotonic()
        ref.clear_kv_blocks()
        alone = rerun(ref, [prompts[0]], burst=False)[0]
        hold("migration (before the kill)", first, alone[:k_tok])
        ref.clear_kv_blocks()
        replay = build_replay_request(PreprocessedRequest(
            token_ids=list(prompts[0]), model=name), emitted)

        async def replay_alone():
            return (await generate_all(ref, [replay.token_ids],
                                       N_NEW - k_tok, logprobs=2))[0][0]

        hold("migration (the replay)", rest, asyncio.run(replay_alone()))
        ref.clear_kv_blocks()
        drained_ref = rerun(ref, [burst[i] for i in mine], burst=True)
        for i, want in zip(mine, drained_ref):
            hold(f"drain (prompt {i + 1})", md[d][tuple(burst[i])]["tokens"],
                 want)
        take_marks()
        t_ref = time.monotonic() - t0

        async def frontend_down():
            await svc.stop()
            await watcher.stop()
            await rt.close()

        loops["frontend"].run(frontend_down())
        for k in range(2):
            loops[f"worker{k}"].run(served[k].shutdown())
            loops[f"worker{k}"].run(rts[k].close())
            loops[f"worker{k}"].run(engs[k].stop())

        async def store_down():
            server.close()
            await server.wait_closed()

        loops["store"].run(store_down())
    finally:
        faulthandler.cancel_dump_traceback_later()
        for lt in loops.values():
            lt.close()
    if CHAOS.any_armed():
        raise AssertionError("resilience: a chaos point is left armed")
    med_gap = float(np.median(gaps_d))
    log(f"resilience migration: kill_worker (after {kill_after} outputs, "
        f"once) armed through worker {wids[1]}'s POST /chaos fired once on "
        f"{wids[k_orig]} after {k_tok} tokens; the stream migrated to "
        f"{wids[k_rep]} ({N_NEW - k_tok} tokens replayed there) and ended "
        f"[DONE] with {N_NEW} tokens, finish length (injections +1, "
        f"migrations +1); TTFT {ttft_m[0]:.4f} s (send to the engine's "
        f"intake {split_m[0]:.4f} s, intake to its first output "
        f"{split_m[1]:.4f} s: the first request of two fresh engines); "
        f"the client's gap at the "
        f"kill {kill_gap * 1e3:.1f} ms (detection + the replay's prefill "
        f"of {len(replay.token_ids)} tokens) against the drain wave's "
        f"median gap {med_gap * 1e3:.2f} ms")
    log(f"resilience drain: 4 streams gated at both intakes ({share[0]} on "
        f"{wids[0]}, {share[1]} on {wids[1]}); POST /drain to {wids[d]} with "
        f"{len(mine)} in flight: drained {drain_s:.3f} s after the POST, "
        f"every stream whole; the router dropped it; 4 new prompts all on "
        f"{wids[live]}; a request to the drained engine refused "
        f"(WorkerDrainingError); drains +1; {wids[live]}'s /metrics "
        f"carries uptime, its gauges and the resilience families")
    log(f"resilience: {steps} decode steps over both engines, flash_decode "
        f"ran {dense} times on the card = {cfg.num_layers} x {steps}; "
        f"identical to generate() on one engine along the same paths "
        f"(checked in {t_ref:.1f} s)")
    if problems:
        raise AssertionError("resilience: " + "; ".join(problems))
    del engs, chains
    gc.collect()
    torch.cuda.empty_cache()
    figures(f"migrated TTFT {ttft_m[0]:.4f} s, gap at the kill "
            f"{kill_gap * 1e3:.1f} ms vs median {med_gap * 1e3:.2f} ms; "
            f"drain {drain_s:.3f} s with {len(mine)} in flight, none lost; "
            f"launches {dense}")
    return dense, dict(ttft_m=ttft_m[0], kill_gap=kill_gap,
                       med_gap=med_gap, drain_s=drain_s)


def check_prefix_economy(params, smi):
    """The fleet prefix economy at Llama-3.1-8B, dense KV: the port's
    store, a KV-routing frontend (ModelWatcher with the flags
    ``--kv-replication-target 2 --kv-prefetch-interval 0.5
    --kv-prefetch-hot-k 64`` through launch.run.fleet_configs, at router
    temperature 0, and HttpService serving /debug/kv_fleet) and worker
    W1, then W2 (launch.run's build_chain on the one weight copy and
    serve_worker with ``--remote-kv --host-offload-pages 128
    --system-port 0``), each on its own loop thread.

    Wave H: the 8 serve prompts streamed through the frontend one at a
    time, twice (only W1 exists: the first pass stores their blocks, the
    second is routed onto them, which gives them heat). Wave W: W2
    registers and gets no request; within 3 controller ticks the
    controller warm-starts it (dynamo_kv_fleet_warm_starts_total +1,
    hint pushes +2 or more), every block of its hot chains (which cover
    every matchable block of the 8 prompts) lands in W2's G2, each page
    byte-equal to W1's export_pages_by_hash, and W2's /debug/kv_fleet
    shows the hints applied. Wave O: the 8 straight to W2's engine: no
    G4 fetch, every matchable block onboarded from G2 and none
    recomputed, streams identical to W1's same-path replay (the prompt
    again on W1, a G1 prefix hit). Wave D, with the controller stopped:
    a fresh prompt served by W1 and routed once through the frontend
    (heat), the view's digest published on kv_fleet.{W2's lease} and
    applied, then the prompt straight to W2 is fetched from W1 (its
    matchable blocks counted as recompute avoided; the hint names W1's
    lease id, which no descriptor carries, so the probe falls back to the
    fleet), identical to W1's replay; a second fresh prompt straight to
    W2 skips the probe round (dedup_skipped_probes +1, no fetch),
    identical to W1's cold compute. The kv_fleet tool exits 0 and names
    W1 among the holders of the hottest block. The dense kernel's own
    count rises by layers x both engines' decode steps. Returns
    (launches, figures)."""
    from dynamo_tpu_torch import kv_transfer as kt
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.frontend.watcher import ModelWatcher
    from dynamo_tpu_torch.kv_fleet_metrics import KV_FLEET
    from dynamo_tpu_torch.kv_integrity import KV_INTEGRITY
    from dynamo_tpu_torch.kv_router.prefetch import KV_FLEET_TOPIC
    from dynamo_tpu_torch.launch import run as launch
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.runtime.store import serve_store
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer
    from dynamo_tpu_torch.tokens import compute_block_hashes

    cfg = ModelConfig.llama3_8b()
    name = "llama3_8b"
    tok = make_test_tokenizer([f"t{i}" for i in range(3, cfg.vocab_size)])
    prompts = serve_prompts(cfg.vocab_size)
    late, unknown = offload_prompts(cfg.vocab_size)[:2]
    problems: list[str] = []

    def fleet(key):
        return int(KV_FLEET.get(f"dynamo_kv_fleet_{key}_total"))

    # every G4 fetch, by the fetching worker's descriptor id: (start, end,
    # found, asked, holders hint); a class-level wrapper, so a fetch that
    # races W2's registration is timed too
    fetch_log: list[tuple] = []
    plain_fetch = kt.RemoteKvFetcher.fetch

    async def timed_fetch(self, hashes, on_chunk=None, holders=None):
        t = time.monotonic()
        got = await plain_fetch(self, hashes, on_chunk=on_chunk,
                                holders=holders)
        fetch_log.append((self.self_id, t, time.monotonic(), got[0],
                          len(hashes), holders))
        return got

    loops = {k: LoopThread(f"{k}-loop")
             for k in ("store", "w1", "w2", "frontend")}
    faulthandler.dump_traceback_later(900, exit=True)
    kt.RemoteKvFetcher.fetch = timed_fetch
    try:
        server, _ = loops["store"].run(serve_store("127.0.0.1", 0))
        cp = f"127.0.0.1:{server.sockets[0].getsockname()[1]}"
        args = launch.build_parser().parse_intermixed_args(
            ["in=endpoint", "out=torch", "--model-config", name,
             "--model-name", name, "--control-plane", cp, "--remote-kv",
             "--host-offload-pages", "128", "--system-port", "0"])
        fargs = launch.build_parser().parse_intermixed_args(
            ["in=http", "--control-plane", cp, "--kv-replication-target",
             "2", "--kv-prefetch-interval", "0.5", "--kv-prefetch-hot-k",
             "64"])
        ps = args.page_size
        chains = [launch.build_chain(args, params=params, tokenizer=tok)[1]
                  for _ in range(2)]
        engs = [c.engine for c in chains]
        marks = record_marks(engs[0])
        ws = ("w1", "w2")
        rts, served = [None, None], [None, None]
        rts[0] = loops["w1"].run(launch.connect_runtime(args))
        served[0] = loops["w1"].run(launch.serve_worker(
            args, chains[0], rts[0], lease_ttl_s=10.0))
        wid1 = str(served[0].lease_id)

        async def frontend_up():
            rt = await launch.connect_runtime(fargs)
            conf = launch.fleet_configs(fargs)
            conf["router_config"].router_temperature = 0.0
            watcher = await ModelWatcher(rt, ModelManager(), tokenizer=tok,
                                         **conf).start()
            svc = HttpService(watcher.manager, host="127.0.0.1", port=0)
            svc.fleet_views = watcher.fleet_views
            await svc.start()
            for _ in range(600):
                push = watcher._routers.get(name)
                if push is not None and list(push.workers) == [wid1]:
                    break
                await asyncio.sleep(0.05)
            return rt, watcher, svc

        frt, watcher, svc = loops["frontend"].run(frontend_up())
        push = watcher._routers.get(name)
        ctrl = watcher._prefetchers.get(name)
        if push is None or list(push.workers) != [wid1] or ctrl is None:
            raise AssertionError(
                f"prefix economy: the frontend routes over "
                f"{None if push is None else list(push.workers)} with "
                f"controller {ctrl}")
        view = watcher.fleet_views[name]
        interval = ctrl.cfg.interval_s

        def on_frontend(fn):
            async def call():
                return fn()
            return loops["frontend"].run(call())

        def indexed(p, wid):
            hs = compute_block_hashes(p, ps, salt=name)
            return on_frontend(lambda: all(
                wid in view.holders(h) for h in hs))

        def wait_for(pred, what, timeout):
            deadline = time.monotonic() + timeout
            while not pred():
                if time.monotonic() > deadline:
                    raise AssertionError(f"prefix economy: {what} after "
                                         f"{timeout} s")
                time.sleep(0.005)
            return time.monotonic()

        async def through_frontend(ps_list, label):
            out = []
            async with HttpClient("127.0.0.1", svc.port) as c:
                for p in ps_list:
                    out.append(await stream_completion(c, p, name, label))
                    await settle_engines(*engs)
            return out

        # every kernel count to 0 just before the main path
        fd.launches = fd.launches_int8 = 0
        for e in engs:
            e.kernel_launches = 0
        fd.executed(engs[0].device, reset=True)
        steps0 = [e.step_count for e in engs]
        # ---- wave H: the hot set on W1, then routed onto it for heat
        res_h1 = asyncio.run(through_frontend(prompts, "economy wave H"))
        mh1 = {k: dict(v) for k, v in marks.items()}
        marks.clear()
        for p in prompts:
            wait_for(lambda p=p: indexed(p, wid1), "W1's blocks indexed",
                     30)
        res_h2 = asyncio.run(through_frontend(prompts, "economy wave H'"))
        mh2 = {k: dict(v) for k, v in marks.items()}
        marks.clear()
        parse_streams(res_h1, [mh1[tuple(p)]["tokens"] for p in prompts],
                      "economy wave H")
        parse_streams(res_h2, [mh2[tuple(p)]["tokens"] for p in prompts],
                      "economy wave H'")
        hot_hit = [mh2[tuple(p)]["cached"] for p in prompts]
        # ---- wave W: W2 joins cold and is warm-started; the time W2's
        # loop spends landing fetched pages (crc32s and the G2 puts) is
        # summed beside the fetches
        ingest = {"s": 0.0, "calls": 0}
        drain_ingest = engs[1]._drain_host_ingest

        def timed_ingest():
            if engs[1]._host_ingest.empty():
                return drain_ingest()
            t = time.monotonic()
            drain_ingest()
            ingest["s"] += time.monotonic() - t
            ingest["calls"] += 1

        engs[1]._drain_host_ingest = timed_ingest
        warm0, hints0, pf0 = (fleet("warm_starts"), fleet("hint_pushes"),
                              fleet("prefetched_blocks"))
        rx0 = wire_totals()[1]
        rts[1] = loops["w2"].run(launch.connect_runtime(args))
        served[1] = loops["w2"].run(launch.serve_worker(
            args, chains[1], rts[1], lease_ttl_s=10.0))
        t_reg = time.monotonic()
        wid2 = str(served[1].lease_id)
        t_warm = wait_for(lambda: fleet("warm_starts") > warm0,
                          "no warm start", 3 * interval)
        hot = on_frontend(lambda: view.hot_chains(ctrl.cfg.hot_k))
        chain_blocks = {h for c in hot for h in c}
        matchable = [compute_block_hashes(p, ps, salt=name)[
            :(len(p) - 1) // ps] for p in prompts]
        uncovered = sum(h not in chain_blocks for hs in matchable
                        for h in hs)
        off2 = engs[1].offload

        def landed():
            with engs[1]._tier_lock:
                return all(h in off2 for h in chain_blocks)

        t_landed = wait_for(landed, "the hot chains not in W2's G2", 120)
        warm_s = t_landed - t_reg
        rx_warm = wire_totals()[1] - rx0
        pushed = fleet("prefetched_blocks") - pf0
        w2_fetches = [f for f in fetch_log
                      if f[0] == engs[1].remote_kv.self_id]
        fetch_s = sum(f[2] - f[1] for f in w2_fetches)
        if fleet("warm_starts") - warm0 != 1 or \
                fleet("hint_pushes") - hints0 < 2 or uncovered:
            problems.append(
                f"prefix economy wave W: warm starts "
                f"+{fleet('warm_starts') - warm0}, hint pushes "
                f"+{fleet('hint_pushes') - hints0}; {uncovered} matchable "
                f"blocks outside the {len(hot)} hot chains")
        byte_equal = 0
        for hs in matchable:
            f1, d1 = engs[0].export_pages_by_hash(hs)
            with engs[1]._tier_lock:
                d2 = off2.gather(hs)
            byte_equal += f1 == len(hs) and same_bytes(d1, d2)
        st, body = asyncio.run(call_json(served[1].system.port,
                                         "/debug/kv_fleet"))
        hints_applied = (body.get("hints") or {}).get("applied", 0)
        if byte_equal != len(prompts) or st != 200 or hints_applied < 1:
            problems.append(
                f"prefix economy wave W: pages byte-equal for {byte_equal} "
                f"of {len(prompts)} prompts; W2's /debug/kv_fleet {st} "
                f"{body}")
        # ---- wave O: the 8 straight to W2, onboarded from G2
        f0 = engs[1].remote_kv.fetches
        recomputed0 = KV_INTEGRITY.get("dynamo_kv_integrity_recomputed_total")
        res_o = []
        for p in prompts:
            res_o.append(loops["w2"].run(timed_generate(engs[1], p)))
            loops["w2"].run(settle_engines(*engs))
        matched_o = [r[3].get("cached_blocks") for r in res_o]
        xs_o = engs[1].transfer_stats()
        ingest_warm = dict(ingest)
        want_m = [len(hs) for hs in matchable]
        if engs[1].remote_kv.fetches != f0 or matched_o != want_m or \
                KV_INTEGRITY.get("dynamo_kv_integrity_recomputed_total") \
                != recomputed0:
            problems.append(
                f"prefix economy wave O: W2 fetched "
                f"{engs[1].remote_kv.fetches - f0} times and matched "
                f"{matched_o} of {want_m}")
        res_r = []   # W1's same-path replay: its G1 prefix hit
        for p in prompts:
            res_r.append(loops["w1"].run(timed_generate(engs[0], p)))
            loops["w1"].run(settle_engines(*engs))
        same_o = 0
        for i, (o, r) in enumerate(zip(res_o, res_r)):
            if o[0] == r[0]:
                same_o += 1
            else:
                j = next(j for j, (a, b) in enumerate(zip(o[0], r[0]))
                         if a != b)
                problems.append(
                    f"prefix economy wave O: prompt {i} streamed "
                    f"{o[0][j]} at step {j} where W1's replay gave {r[0][j]}")
        # ---- wave D: the demand path with the controller stopped
        loops["frontend"].run(ctrl.stop())
        lh = compute_block_hashes(late, ps, salt=name)[:(len(late) - 1) // ps]
        late_w1 = loops["w1"].run(timed_generate(engs[0], late))
        loops["w1"].run(settle_engines(*engs))
        wait_for(lambda: indexed(late, wid1), "the late prompt indexed", 30)
        res_hl = asyncio.run(through_frontend([late], "economy late-hot"))
        parse_streams(res_hl, [marks[tuple(late)]["tokens"]],
                      "economy late-hot")
        digest = on_frontend(view.digest)
        applied0 = engs[1].fleet_hints.applied
        loops["frontend"].run(frt.kv.publish(
            f"{KV_FLEET_TOPIC}.{wid2}", json.dumps({"hints": digest})))
        wait_for(lambda: engs[1].fleet_hints.applied > applied0,
                 "the published digest not applied", 10)
        known = [engs[1].fleet_hints.holders(h) for h in lh]
        avoided0, skipped0 = fleet("recompute_avoided_blocks"), \
            fleet("dedup_skipped_probes")
        n_log = len(fetch_log)
        hinted = loops["w2"].run(timed_generate(engs[1], late))
        loops["w2"].run(settle_engines(*engs))
        hinted_fetch = [f for f in fetch_log[n_log:]
                        if f[0] == engs[1].remote_kv.self_id]
        avoided = fleet("recompute_avoided_blocks") - avoided0
        late_rep = loops["w1"].run(timed_generate(engs[0], late))
        loops["w1"].run(settle_engines(*engs))
        if (avoided != len(lh) or len(hinted_fetch) != 1
                or hinted_fetch[0][5] != [wid1]
                or any(k != [wid1] for k in known)
                or hinted[0] != late_rep[0]):
            problems.append(
                f"prefix economy dedup (hinted): recompute avoided "
                f"+{avoided} of {len(lh)}, fetches {hinted_fetch}, the "
                f"digest's holders {known[:2]}..., tokens "
                f"{'equal' if hinted[0] == late_rep[0] else 'differ'}")
        f0 = engs[1].remote_kv.fetches
        unk = loops["w2"].run(timed_generate(engs[1], unknown))
        loops["w2"].run(settle_engines(*engs))
        skipped = fleet("dedup_skipped_probes") - skipped0
        unk_ref = loops["w1"].run(timed_generate(engs[0], unknown))
        loops["w1"].run(settle_engines(*engs))
        if skipped != 1 or engs[1].remote_kv.fetches != f0 or \
                unk[0] != unk_ref[0]:
            problems.append(
                f"prefix economy dedup (unknown): skipped probes "
                f"+{skipped}, W2 fetches +{engs[1].remote_kv.fetches - f0},"
                f" tokens {'equal' if unk[0] == unk_ref[0] else 'differ'} "
                f"to W1's cold compute")
        # ---- the counts, once both engines idle
        loops["w1"].run(settle_engines(*engs))
        torch.cuda.synchronize()
        dense, int8 = fd.executed(engs[0].device)
        issued = fd.launches + fd.launches_int8
        steps = sum(e.step_count - s for e, s in zip(engs, steps0))
        check_kv_launches("prefix economy", engs, dense, int8, issued,
                          steps, cfg.num_layers)
        # ---- the operator tool against the frontend
        tool = subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch.tools.kv_fleet",
             "--frontend", f"127.0.0.1:{svc.port}", "--model", name,
             "--top", "4"], capture_output=True, text=True, timeout=60,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        top = json.loads(tool.stdout)["models"][name]["hot"] \
            if tool.returncode == 0 else []
        if tool.returncode != 0 or not top or wid1 not in top[0]["holders"]:
            problems.append(f"prefix economy: the kv_fleet tool exited "
                            f"{tool.returncode} ({tool.stderr[-200:]}), "
                            f"hottest {top[:1]}")
        mem = torch.cuda.memory_allocated()

        async def frontend_down():
            await svc.stop()
            await watcher.stop()
            await frt.close()

        loops["frontend"].run(frontend_down())
        for k, w in enumerate(ws):
            loops[w].run(served[k].shutdown())
            loops[w].run(rts[k].close())
            loops[w].run(engs[k].stop())

        async def store_down():
            server.close()
            await server.wait_closed()

        loops["store"].run(store_down())
    finally:
        kt.RemoteKvFetcher.fetch = plain_fetch
        faulthandler.cancel_dump_traceback_later()
        for lt in loops.values():
            lt.close()

    def call_first(m):
        return m["first"] - m["in"]

    ttft_h = [call_first(mh1[tuple(p)]) for p in prompts]
    ttft_o = [r[2] for r in res_o]
    ttft_r = [r[2] for r in res_r]
    gbs = rx_warm / fetch_s / 1e9 if fetch_s else float("nan")
    hinted_ms = ((hinted_fetch[0][2] - hinted_fetch[0][1]) * 1e3
                 if hinted_fetch else float("nan"))
    log(f"prefix economy wave H: the 8 through the frontend to W1 "
        f"({wid1}) twice: the call to the first token, recomputed, median "
        f"{np.median(ttft_h):.4f} s max {max(ttft_h):.4f} s; the second "
        f"pass matched {sum(hot_hit)} blocks; {smi}")
    log(f"prefix economy wave W: W2 ({wid2}) warm-started "
        f"{t_warm - t_reg:.3f} s after registering (tick {interval} s); "
        f"{len(hot)} hot chains of {len(chain_blocks)} blocks (every one of "
        f"the {sum(want_m)} matchable blocks) in its G2 "
        f"{warm_s:.3f} s after registering; {pushed} blocks fetched "
        f"over {len(w2_fetches)} fetches, {rx_warm / 2**20:.1f} MiB in "
        f"{fetch_s:.3f} s of fetches: {gbs:.2f} GB/s; W2's loop landed "
        f"them in {ingest_warm['calls']} drains taking "
        f"{ingest_warm['s']:.3f} s (crc32s and G2 puts); pages byte-equal "
        f"to W1's for {byte_equal}/8 prompts; W2's /debug/kv_fleet applied "
        f"{hints_applied}")
    log(f"prefix economy wave O: the 8 straight to W2: no fetch, matched "
        f"{sum(matched_o)} of {sum(want_m)} from G2, none recomputed; the "
        f"call to the first token per prompt (W2 onboarded / W1 "
        f"recomputed / W1 G1 hit): " + "; ".join(
            f"{o:.4f}/{h:.4f}/{r:.4f}" for o, h, r in
            zip(ttft_o, ttft_h, ttft_r)) + f"; medians "
        f"{np.median(ttft_o):.4f} / {np.median(ttft_h):.4f} / "
        f"{np.median(ttft_r):.4f} s; identical to W1's replay {same_o}/8; "
        f"W2's own TTFT (intake to first token) median "
        f"{np.median([r[3]['timing']['ttft_s'] for r in res_o]):.4f} s, W1's "
        f"replay {np.median([r[3]['timing']['ttft_s'] for r in res_r]):.4f}"
        f" s; W2 onboarded {xs_o['onboard_pages']} pages at "
        f"{xs_o['onboard_host_ms_per_page'] or float('nan'):.2f} host ms a "
        f"page (gather, verify, copy issue), H2D "
        f"{xs_o['h2d_gb_s'] or float('nan'):.1f} GB/s")
    log(f"prefix economy wave D: late-hot prompt ({len(late)} tokens, "
        f"{len(lh)} matchable blocks): W1 cold {late_w1[2]:.4f} s, W2 "
        f"hinted fetch {hinted[2]:.4f} s (recompute avoided +{avoided}, "
        f"fetch {hinted_ms:.1f} ms), W1 G1 hit {late_rep[2]:.4f} s; unknown prompt: W2 "
        f"{unk[2]:.4f} s with the probe skipped (+{skipped}), W1 cold "
        f"{unk_ref[2]:.4f} s; the tool named {wid1} among the hottest "
        f"block's holders")
    log(f"prefix economy: {steps} decode steps over both engines, "
        f"flash_decode ran {dense} times on the card = {cfg.num_layers} x "
        f"{steps}; {mem / 2**30:.2f} GiB allocated with both engines up")
    if problems:
        raise AssertionError("prefix economy: " + "; ".join(problems))
    del engs, chains
    gc.collect()
    torch.cuda.empty_cache()
    figures(f"warm start {warm_s:.3f} s, {len(chain_blocks)} blocks in G2, "
            f"{gbs:.2f} GB/s, byte-equal {byte_equal}/8; wave O TTFT "
            f"{np.median(ttft_o):.4f} s (recompute {np.median(ttft_h):.4f}, "
            f"G1 hit {np.median(ttft_r):.4f}), same {same_o}/8; dedup "
            f"hinted {hinted[2]:.4f} s avoided {avoided}, unknown "
            f"{unk[2]:.4f} s skipped {skipped}; launches {dense}")
    return dense, dict(ttft_o=ttft_o, warm_s=warm_s, gbs=gbs)


async def call_json(port, path):
    """GET ``path`` on 127.0.0.1:``port``: (status, JSON body)."""
    from dynamo_tpu_torch.frontend.http import HttpClient

    async with HttpClient("127.0.0.1", port) as c:
        r = await c.request("GET", path)
    return r.status, r.json()


# ---------------------------------------------------------------------------
# speculation

SPEC_K = 4          # num_speculative_tokens (adaptive K on, its cap)
SPEC_NEW = 32       # new tokens a request (64 until the script's time
                    # budget took the telemetry checks)
# the self-draft arms (S, TS: the 8B drafting for itself, a 1.4 s draft a
# dispatch) take this many: the same checks over fewer dispatches
SPEC_SELF_NEW = 8
SPEC_LP = (1, 5)    # the requests that ask for logprobs (the fused round)
# a greedy token of a speculating stream may leave the plain (speculative
# "off") stream only where the plain stream's top-2 logprob gap is at most
# this: the verify's forward (batch_score: products at M = rows x (K+1),
# the plain blocked attention) sums in another order than the decode
# round's (products at M = 8, the flash-decode kernel)
SPEC_TIE = 0.1
# teacher-forced through the verify's scorer, neither the logprob of
# either of the plain stream's top-2 tokens nor their gap may move by more
# than this. On the card the bf16 paths moved a logprob by 0.0825 and a
# gap by 0.1185, and the w8a16 weights (a lower precision) a logprob by
# 0.2549 (PERF.md). A gap in (SPEC_TIE, 0.1185] can thus swap
# legitimately, which the stream check above would fail: none has
SPEC_LP_TOL = 0.15


def spec_prompts(vocab: int):
    """The serve phase's 8 prompts and two built to repeat (a 64-token
    span four times), so that the n-gram proposer finds matches."""
    rng = np.random.RandomState(SEED + 16)
    return serve_prompts(vocab) + [
        rng.randint(0, vocab, size=64).tolist() * 4 for _ in range(2)]


class SpecMeter:
    """Records, on a speculating engine: the host wall and device time
    (CUDA events around the call) of each fused round's graph replay, of
    each draft call (the batched draft or comb, or each per-slot proposal
    or trie) and of each verify (chain or tree), and the effective K (and
    under a tree M) of every slot that joined a verify round."""

    def __init__(self, eng):
        self.rounds, self.drafts, self.verifies = [], [], []
        self.ks, self.fans = [], []
        spec = eng.spec
        eng.graphs.round = self._timed(eng.graphs.round, self.rounds)
        for name in ("propose", "propose_batch", "propose_tree",
                     "propose_batch_tree"):
            setattr(spec, name, self._timed(getattr(spec, name), self.drafts))
        for name in ("verify", "verify_tree"):
            setattr(spec, name, self._timed(getattr(spec, name),
                                            self.verifies))
        for name, into in (("k_for", self.ks), ("m_for", self.fans)):
            setattr(spec, name, self._seen(getattr(spec, name), into))

    @staticmethod
    def _seen(fn, into):
        def seen(slot):
            v = fn(slot)
            into.append(v)
            return v
        return seen

    @staticmethod
    def _timed(fn, into):
        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            wall = time.perf_counter() - t0
            e1.record()
            into.append((e0, e1, wall))
            return out
        return timed

    @staticmethod
    def ms(calls, per):
        """(wall, device) ms summed over ``calls``, over ``per``."""
        torch.cuda.synchronize()
        per = max(per, 1)
        return (sum(w for _, _, w in calls) * 1e3 / per,
                sum(a.elapsed_time(b) for a, b, _ in calls) / per)


def spec_burst(eng, prompts, lps, n_new=SPEC_NEW):
    """The prompts through generate() as one burst held at the intake
    until all wait, ``n_new`` tokens each; ``lps[i]`` top logprobs for
    request i (None: none). Returns (each request's (tokens, finish,
    annotations, gaps, top)), decode tok/s over the burst)."""
    IntakeGate(eng, len(prompts))

    async def go():
        res = await asyncio.gather(*[
            generate_all(eng, [p], n_new, logprobs=lp)
            for p, lp in zip(prompts, lps)])
        await eng.stop()
        return [r[0] for r in res]

    res = asyncio.run(go())
    for toks, finish, *_ in res:
        if len(toks) != n_new or finish != "length":
            raise AssertionError(f"speculation: a request ended with "
                                 f"{len(toks)} tokens, finish {finish}")
    ttft = [a["timing"]["ttft_s"] for _, _, a, *_ in res]
    e2e = [a["timing"]["e2e_s"] for _, _, a, *_ in res]
    tps = sum(len(t) - 1 for t, *_ in res) / (max(e2e) - min(ttft))
    return res, tps


def hold_to_plain(label, got, plain):
    """Greedy speculating streams against the plain engine's (with its
    top-2 logprobs): equal up to the first step where they differ, which
    must be a near-tie of the plain stream (gap <= SPEC_TIE). Returns
    (positions compared, streams stopped at a near-tie, their gaps)."""
    compared, gaps = 0, []
    for i, ((toks, *_), (want, _, _, _, top)) in enumerate(zip(got, plain)):
        for j, (a, b) in enumerate(zip(toks, want)):
            if a != b:
                gap = top[j][0][1] - top[j][1][1]
                if gap > SPEC_TIE:
                    raise AssertionError(
                        f"{label}: request {i} gave {a} for the plain "
                        f"stream's {b} at step {j}, where the plain top-2 "
                        f"gap is {gap:.4f} > {SPEC_TIE}")
                gaps.append(round(gap, 4))
                break  # past a divergence the streams are not comparable
            compared += 1
    return compared, len(gaps), gaps


def score_plain(cfg, params, prompts, plain, ecfg=None):
    """The plain greedy streams of ``prompts`` teacher-forced through the
    verify's scorer (llama.batch_score) at its shape, one row a stream of
    K+1 tokens: each prompt but its last token prefilled (batch_prefill),
    then the stream in chunks of K+1 from the last prompt token on, as a
    verify feeds them, into a region of ``ecfg``'s context (default
    EngineConfig), the span bounded as the engine bounds it. Returns
    the largest difference between the scorer's logprob and the plain
    decode's over each step's top-2 tokens, and the largest between
    their top-2 gaps, each as (difference, (stream, step))."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.models import llama

    S = (ecfg or EngineConfig()).max_context
    B, T = len(prompts), SPEC_K + 1
    dev, dtype = params["norm_f"].device, params["norm_f"].dtype
    seqs = [list(p) + list(toks) for p, (toks, *_) in zip(prompts, plain)]
    worst, worst_gap = (0.0, None), (0.0, None)
    with torch.no_grad():
        ctx = llama.init_ctx(cfg, B, S, dtype, dev)
        for i, p in enumerate(prompts):
            n = len(p) - 1
            llama.batch_prefill(cfg, params, ctx, torch.tensor(
                [p[:n]], device=dev), [i], [0], [n])
        for s in range(0, SPEC_NEW, T):
            q = [len(p) - 1 + s for p in prompts]
            toks = torch.tensor([seq[j:j + T] for seq, j in zip(seqs, q)],
                                device=dev)
            logits = llama.batch_score(cfg, params, ctx, toks, list(range(B)),
                                       q, [j + T for j in q],
                                       llama.spec_span(max(q), S))
            lp = (logits - torch.logsumexp(logits, -1, keepdim=True)).cpu()
            for i, (*_, top) in enumerate(plain):
                for r in range(min(T, SPEC_NEW - s)):
                    (a, want_a), (b, want_b) = top[s + r][:2]
                    got_a, got_b = lp[i, r, a].item(), lp[i, r, b].item()
                    at = (i, s + r)
                    d = max(abs(got_a - want_a), abs(got_b - want_b))
                    worst = max(worst, (d, at), key=lambda w: w[0])
                    d = abs((got_a - got_b) - (want_a - want_b))
                    worst_gap = max(worst_gap, (d, at), key=lambda w: w[0])
        del ctx
    torch.cuda.empty_cache()
    return worst, worst_gap


def check_teacher_forced(cfg, params, prompts, plain):
    """score_plain on the 8 serve prompts' plain dense streams must move
    no logprob of a step's top-2 tokens and no top-2 gap by more than
    SPEC_LP_TOL; the same scorer with the w8a16 quantization of the
    weights, a lower precision, must move a logprob by more (the check
    sees a fault of that size). Returns the three largest differences."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    (err, at), (gap, gap_at) = score_plain(cfg, params, prompts, plain)
    qparams = llama.quantize_params(params)
    (q_err, q_at), _ = score_plain(ModelConfig.llama3_8b_int8(), qparams,
                                   prompts, plain)
    del qparams
    torch.cuda.empty_cache()
    log(f"speculation: the plain dense streams of {len(prompts)} prompts "
        f"teacher-forced through the verify's scorer ({len(prompts)} rows x "
        f"{SPEC_K + 1} tokens a call, {SPEC_NEW} steps): largest logprob "
        f"difference over each step's top-2 tokens {err:.4f} (stream, step "
        f"{at}), largest top-2 gap difference {gap:.4f} ({gap_at}); "
        f"tolerance {SPEC_LP_TOL}; with the w8a16 weights, logprob "
        f"{q_err:.4f} ({q_at})")
    if max(err, gap) > SPEC_LP_TOL:
        raise AssertionError(
            f"speculation: teacher-forced, the verify's scorer moves a "
            f"logprob by {err:.4f} and a top-2 gap by {gap:.4f} "
            f"(tolerance {SPEC_LP_TOL})")
    if q_err <= SPEC_LP_TOL:
        raise AssertionError(
            f"speculation: teacher-forced with the w8a16 weights the "
            f"logprobs move only {q_err:.4f} <= {SPEC_LP_TOL}: the tolerance "
            f"cannot tell a lower precision")
    return err, gap, q_err


def spec_engine(cfg, params, kv_quant, mode, draft=None, tree=False):
    """A speculating engine of the default EngineConfig, K = SPEC_K
    adaptive; ``tree`` turns on tree speculation at the default fan (4)
    and the auto budget (1 + K * 4 = 17 nodes)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine

    kw = {}
    if draft is not None:
        kw = dict(draft_config=draft[0], draft_params=draft[1])
    return TorchEngine(cfg, EngineConfig(
        kv_quant=kv_quant, speculative=mode, num_speculative_tokens=SPEC_K,
        spec_adaptive=True, spec_tree=tree), params=params, device="cuda",
        **kw)


def spec_plain(cfg, params, kv, prompts, lps):
    """The burst on plain engines (speculative off) of the KV mode, twice:
    every request asking for top-2 logprobs (the gaps that hold_to_plain
    reads; a round computing logprobs picks the same greedy tokens), then
    the arms' request mix (the time). Returns (the first run's streams,
    the second's decode tok/s)."""
    eng = spec_engine(cfg, params, kv, "off")
    plain, _ = spec_burst(eng, prompts, [2] * len(prompts))
    del eng
    eng = spec_engine(cfg, params, kv, "off")
    res, tps = spec_burst(eng, prompts, lps)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if [t for t, *_ in res] != [t for t, *_ in plain]:
        raise AssertionError(f"speculation: the plain kv {kv} engine's "
                             f"greedy tokens depend on logprobs asked")
    log(f"speculation: plain {cfg.quant or 'bf16'} weights, kv {kv}: "
        f"decode {tps:.1f} tok/s over the burst")
    return plain, tps


def spec_arm(name, cfg, params, kv, mode, draft, prompts, lps, plain,
             plain_tps, reset=None, tree=False, n_new=SPEC_NEW):
    """One speculative arm's burst on a fresh engine, ``n_new`` tokens a
    request, held to the plain run's streams (their first ``n_new``
    tokens), its fused rounds' kernel launches checked. ``reset`` zeroes
    other kernels' counts, as the flash-decode ones are, after the
    engine is built (its graph captures run rounds) and before the burst;
    ``tree`` speculates trees (the tree node counter must move). Returns
    (spec stats with the arm's verify_ms, draft_ms and tok/s, the mode's
    kernel launches, a short summary)."""
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.spec.metrics import SPEC

    L = cfg.num_layers
    eng = spec_engine(cfg, params, kv, mode, draft, tree)
    meter = SpecMeter(eng)
    nodes0 = SPEC.get("dynamo_spec_tree_nodes_total")
    steps0 = eng.step_count
    fd.launches = fd.launches_int8 = 0
    eng.kernel_launches = 0
    fd.executed(eng.device, reset=True)
    if reset is not None:
        reset()
    res, tps = spec_burst(eng, prompts, lps, n_new)
    dense, int8 = fd.executed(eng.device)
    issued = fd.launches + fd.launches_int8
    steps = eng.step_count - steps0
    ran, other = (int8, dense) if kv == "int8" else (dense, int8)
    if (not ran or ran != L * steps or other or issued
            or eng.kernel_launches != ran):
        raise AssertionError(
            f"speculation {name}: flash_decode ran {dense} times on the "
            f"card (int8 {int8}, {issued} issued eagerly, graphs recorded "
            f"{eng.kernel_launches}) over {steps} fused decode steps of "
            f"{L} layers")
    check_replayed(eng, f"speculation {name}")
    st = eng.spec.stats()
    nodes = SPEC.get("dynamo_spec_tree_nodes_total") - nodes0
    if tree and not (nodes > 0 and nodes == st["spec_tree_nodes_total"]):
        raise AssertionError(f"speculation {name}: dynamo_spec_tree_nodes_"
                             f"total moved by {nodes} (stats "
                             f"{st['spec_tree_nodes_total']})")
    compared, ties, gaps = hold_to_plain(f"speculation {name}", res, plain)
    for i in SPEC_LP:
        if "spec" in res[i][2]:
            raise AssertionError(f"speculation {name}: logprob request {i} "
                                 f"speculated")
    vsteps = st["spec_verify_steps"]
    acc = st["spec_acceptance_rate"]
    per_step = (st["spec_accepted_total"] + vsteps) / max(vsteps, 1)
    ks = np.asarray(meter.ks, np.float64)
    k_dist = ((ks.mean(), np.percentile(ks, 50), np.percentile(ks, 95))
              if len(ks) else (0.0, 0.0, 0.0))
    n = len(meter.verifies)
    draft_ms = meter.ms(meter.drafts, n)
    verify_ms = meter.ms(meter.verifies, n)
    steps_a_round = eng.ecfg.flush_every
    rnd = ("no fused round" if not meter.rounds else
           "fused round {:.2f} ms wall, {:.2f} ms device a step".format(
               *meter.ms(meter.rounds, len(meter.rounds) * steps_a_round)))
    what = ("" if draft is None else ", draft " + (
        "self" if draft[0] is cfg else "Llama-3.2-1B"))
    m_part = ""
    if tree:
        mm = np.asarray(meter.fans, np.float64)
        m_part = (f", M mean {mm.mean() if len(mm) else 0.0:.3f}; "
                  f"{st['spec_tree_nodes_total']} tree nodes scored "
                  f"(dynamo_spec_tree_nodes_total), accepted path tokens "
                  f"{st['spec_tree_accepted_path_len_total']}, "
                  f"branch_accept_hist {st['spec_branch_accept_hist']}")
    log(f"speculation {name} (kv {kv}, {mode}{what}"
        f"{', tree' if tree else ''}): acceptance {acc:.4f} "
        f"({st['spec_accepted_total']}/{st['spec_proposed_total']}), "
        f"{per_step:.3f} tokens a slot's verify step over {vsteps} slot "
        f"steps in {n} verify dispatches; effective K mean "
        f"{k_dist[0]:.3f} p50 {k_dist[1]:.1f} p95 {k_dist[2]:.1f}"
        f"{m_part}; despecs "
        f"{st['spec_despec_total']} (gated {st['spec_gated_despec_total']})"
        f"; a verify dispatch: draft {draft_ms[0]:.2f} ms wall "
        f"{draft_ms[1]:.2f} ms device, verify {verify_ms[0]:.2f} ms wall "
        f"{verify_ms[1]:.2f} ms device; {rnd}; decode {tps:.1f} tok/s "
        f"(plain {plain_tps:.1f}); {compared} greedy positions equal to the "
        f"plain run, {ties} streams stop at a near-tie {gaps}; {ran} "
        f"{'int8' if kv == 'int8' else 'dense'} flash-decode launches over "
        f"{steps} fused steps")
    del eng, meter
    gc.collect()
    torch.cuda.empty_cache()
    st = dict(st, verify_ms=verify_ms, draft_ms=draft_ms, tps=tps,
              per_step=per_step, ties=ties)
    return st, ran, (f"{name} acc {acc:.3f} {per_step:.2f} tok/step "
                     f"{tps:.0f}/{plain_tps:.0f} tok/s verify "
                     f"{verify_ms[1]:.0f} ms ties {ties}")


def time_verify_span(cfg, params, lens):
    """One verify's scorer (llama.batch_score) at the burst's shape, 8
    rows of K+1 = 5 tokens at the given context lengths over a zeroed
    region, under no_grad as the engine runs it, with the span bounded to
    the attention's key block (llama.spec_span) and over the whole region
    as the JAX version reads it: logits and the region bit-equal, each
    one's host wall and device ms (CUDA events; median of 3). Returns
    (bounded, full) as (wall, device). (Its kernels and their device ms:
    python -m dynamo_tpu_torch.tools.profile_verify, in a process of its
    own.)"""
    from dynamo_tpu_torch.models import llama

    S = 4096
    B, T = len(lens), SPEC_K + 1
    dev = params["embed"].device
    toks = torch.randint(0, cfg.vocab_size, (B, T), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             SEED))
    slots, q_starts = list(range(B)), [n - 1 for n in lens]
    seq_lens = [q + T for q in q_starts]
    bounded = llama.spec_span(max(q_starts), S)
    out, times = [], []
    with torch.no_grad():
        for span in (bounded, S):
            ctx = llama.init_ctx(cfg, B, S, params["embed"].dtype, dev)

            def call(ctx=ctx, span=span):
                return llama.batch_score(cfg, params, ctx, toks, slots,
                                         q_starts, seq_lens, span)

            wall, device = [], []
            for _ in range(3):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0.record()
                logits = call()
                e1.record()
                wall.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                device.append(e0.elapsed_time(e1))
            out.append((logits, ctx["k"][:, :, :B].clone()))
            times.append((float(np.median(wall)), float(np.median(device))))
            del ctx
    if not (torch.equal(out[0][0], out[1][0])
            and torch.equal(out[0][1], out[1][1])):
        raise AssertionError("speculation: the bounded span's verify "
                             "differs from the full region's")
    del out
    torch.cuda.empty_cache()
    log(f"speculation: one verify's scorer, 8 rows x {T} tokens at "
        f"contexts {min(lens)}..{max(lens)}: span {bounded} keys "
        f"{times[0][0]:.1f} ms wall {times[0][1]:.1f} ms device; the whole "
        f"region ({S}) "
        f"{times[1][0]:.1f} ms wall {times[1][1]:.1f} ms device; logits "
        f"and region bit-equal (median of 3)")
    return times


def check_seeded_spec(cfg, params, prompt, tree=False):
    """A seeded temperature-0.8 request on two fresh N engines (dense,
    ngram; TN under ``tree``) must draw one stream, speculating."""
    name = "TN" if tree else "N"
    seeded = []
    for _ in range(2):
        eng = spec_engine(cfg, params, "none", "ngram", tree=tree)

        async def go(eng=eng):
            out = await generate_all(eng, [prompt], SPEC_NEW,
                                     temperature=0.8, seed=7)
            await eng.stop()
            return out[0]
        seeded.append(asyncio.run(go()))
        del eng
    if (seeded[0][0] != seeded[1][0] or len(seeded[0][0]) != SPEC_NEW
            or "spec" not in seeded[0][2]):
        raise AssertionError(f"speculation {name}: the seeded "
                             f"temperature-0.8 streams differ")
    log(f"speculation {name}: a seeded temperature-0.8 request on two engines "
        f"drew one stream of {SPEC_NEW} tokens (acceptance "
        f"{seeded[0][2]['spec']['acceptance_rate']:.4f})")


def check_speculation(params):
    """Linear speculation at Llama-3.1-8B's width (the serve weights,
    default EngineConfig, K = 4, adaptive K on): the 8 serve prompts (2 asking for
    logprobs, which stay in the fused round) and 2 repeating prompts, 64
    tokens each, in four arms: N (dense, ngram), Q (int8 KV, ngram), D
    (dense, draft: Llama-3.2-1B, random weights from seed 1, batched
    drafting) and S (dense, self-draft: the target's own weights as the
    draft, SPEC_SELF_NEW tokens a request). Each arm's streams are held against the same engine's plain
    run (speculative off, top-2 logprobs asked); the flash-decode kernel
    of the mode must run on every layer of every fused decode step (the
    kernels line's launches_spec) inside replayed graphs; N must accept
    tokens and D de-speculate; a seeded temperature-0.8 request twice on
    N must draw one stream. Arm N (which must accept: only the model's
    own repetition gives its n-grams a match, and at 8 layers the random
    model did not repeat within the burst) and the teacher-forced check
    (whose w8a16 control was measured at 32 layers) keep all 32 layers;
    Q, D, S and the seeded pair run at the first CUT_LAYERS. Returns the
    (dense, int8) kernel launches of the speculative arms and what the
    tree phase reuses: the prompts, the plain runs and each arm's verify
    and draft ms."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    # the verify is host-bound: threads earlier phases left behind
    # compete with it for the interpreter
    log(f"speculation: {threading.active_count()} threads in this "
        f"process; arms N and the teacher-forced check at Llama-3.1-8B's "
        f"32 layers, the others at its first {CUT_LAYERS}")
    cfg32, params32 = ModelConfig.llama3_8b(), params
    cfg = ModelConfig.llama3_8b(num_layers=CUT_LAYERS)
    params = first_layers(params, CUT_LAYERS)
    prompts = spec_prompts(cfg.vocab_size)
    lps = [2 if i in SPEC_LP else None for i in range(len(prompts))]
    t0 = time.monotonic()
    draft_cfg = ModelConfig.llama3_1b(num_layers=CUT_LAYERS)
    draft_1b = (draft_cfg,
                llama.init_params(draft_cfg, SEED + 1, device="cuda"))
    log(f"speculation: Llama-3.2-1B draft weights ({CUT_LAYERS} of its 16 "
        f"layers, seed {SEED + 1}) made "
        f"on the card in {time.monotonic() - t0:.1f} s; "
        f"{len(prompts)} prompts ({min(map(len, prompts))}.."
        f"{max(map(len, prompts))} tokens), {SPEC_NEW} new tokens each, "
        f"requests {list(SPEC_LP)} ask for top-2 logprobs; K = {SPEC_K}, "
        f"adaptive; the tie threshold {SPEC_TIE}")
    # plain runs by (depth, KV mode): the 32-layer dense one serves arm N
    # and the teacher-forced check
    plain, plain_tps = {}, {}
    plain["full"], plain_tps["full"] = spec_plain(cfg32, params32, "none",
                                                  prompts, lps)
    tf_err, tf_gap, tf_q = check_teacher_forced(cfg32, params32, prompts[:8],
                                                plain["full"][:8])
    for kv in ("none", "int8"):
        plain[kv], plain_tps[kv] = spec_plain(cfg, params, kv, prompts, lps)
    arms = (("N", cfg32, params32, "none", "ngram", None, "full"),
            ("Q", cfg, params, "int8", "ngram", None, "int8"),
            ("D", cfg, params, "none", "draft", draft_1b, "none"),
            ("S", cfg, params, "none", "draft", (cfg, params), "none"))
    launches = {"none": 0, "int8": 0}
    short = []
    linear = {}
    for name, acfg, aparams, kv, mode, draft, pk in arms:
        st, ran, line = spec_arm(
            name, acfg, aparams, kv, mode, draft, prompts, lps, plain[pk],
            plain_tps[pk], n_new=SPEC_SELF_NEW if name == "S" else SPEC_NEW)
        launches[kv] += ran
        short.append(line)
        linear[name] = st
        if name == "N":
            if not st["spec_accepted_total"]:
                raise AssertionError("speculation N: no token accepted")
            check_seeded_spec(cfg, params, prompts[-1])
        if name == "D" and not st["spec_despec_total"]:
            raise AssertionError("speculation D: no slot de-speculated")
    del draft_1b
    bounded, full = time_verify_span(
        cfg, params, [len(p) for p in prompts[:8]])
    short.append(f"span {bounded[1]:.0f}/{full[1]:.0f} ms; forced lp "
                 f"{tf_err:.3f} gap {tf_gap:.3f} (w8a16 lp {tf_q:.3f})")
    figures("; ".join(short))
    return launches["none"], launches["int8"], dict(
        prompts=prompts, lps=lps, plain=plain, plain_tps=plain_tps,
        linear=linear)


# teacher-forced through a tree verify, no committed KV row (a position's
# K or V of one layer, all kv heads) may differ from the one a linear
# batch_score of the same true chain writes by more than this relative L2
# norm. Both compute the same tokens at the same positions over the same
# prior context; only the products' row counts (8 x 6 against 8 x 5) and
# the masked chunk differ, so bf16 rounding apart they agree, while a
# sibling's row or a row at the wrong position differs by about 1.4
SPEC_TREE_KV_TOL = 0.05


def check_tree_forced(cfg, params, prompts, plain):
    """The plain dense streams of ``prompts`` teacher-forced through the
    tree verify (verifier.spec_verify_tree, greedy): each row's tree is
    the pending token with two children, node 1 the plain step's top-2
    runner-up (a wrong token) and node 2 the stream's true next token,
    the true continuation chained under node 2 to depth K. Each row
    advances by the tokens its verify committed. The path must go through
    node 2 and the emitted tokens equal the plain stream, except where
    the plain top-2 gap is a near-tie (<= SPEC_TIE); the committed rows
    must agree with those a linear batch_score of the true chain writes
    at the same positions (SPEC_TREE_KV_TOL). Returns (verify calls,
    steps through node 2, near-ties, the largest row difference)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.spec import verifier

    ecfg = EngineConfig()
    S, K = ecfg.max_context, SPEC_K
    B, T = len(prompts), K + 2
    dev, dtype = params["norm_f"].device, params["norm_f"].dtype
    seqs = [list(p) + list(toks) for p, (toks, *_) in zip(prompts, plain)]
    start = [len(p) - 1 for p in prompts]
    q = list(start)
    parents = torch.tensor([[-1, 0, 0] + list(range(2, K + 1))] * B,
                           device=dev)
    calls = through = 0
    ties = []
    with torch.no_grad():
        tctx = llama.init_ctx(cfg, B, S, dtype, dev)
        for i, p in enumerate(prompts):
            llama.batch_prefill(cfg, params, tctx, torch.tensor(
                [p[:-1]], device=dev), [i], [0], [len(p) - 1])
        lctx = {n: t.clone() for n, t in tctx.items()}
        while True:
            act = [i for i in range(B) if q[i] - start[i] + K < SPEC_NEW]
            if not act:
                break
            calls += 1
            qs = [q[i] for i in act]
            top = [plain[i][4][q[i] - start[i]] for i in act]
            toks = torch.tensor(
                [[seqs[i][q[i]], tp[1][0]] + seqs[i][q[i] + 1:q[i] + K + 1]
                 for i, tp in zip(act, top)], device=dev)
            n = len(act)
            span = llama.spec_span(max(qs), S)
            packed = verifier.spec_verify_tree(
                cfg, params, tctx, toks, None, parents[:n], act, qs,
                [x + T for x in qs], torch.zeros(n, 2, dtype=torch.long,
                                                 device=dev),
                torch.zeros(n, device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev),
                torch.ones(n, device=dev), ecfg.max_top_k, span, K).cpu()
            chain = torch.tensor([seqs[i][q[i]:q[i] + K + 1] for i in act],
                                 device=dev)
            llama.batch_score(cfg, params, lctx, chain, act, qs,
                              [x + K + 1 for x in qs], span)
            for r, i in enumerate(act):
                n_out = int(packed[r, 2 * K + 1])
                path = [int(x) for x in packed[r, K + 1:K + n_out]]
                out = [int(x) for x in packed[r, :n_out]]
                j = q[i] - start[i]            # the plain step of out[0]
                want = seqs[i][q[i] + 1:q[i] + 1 + n_out]
                for m, (a, b) in enumerate(zip(out, want)):
                    if a != b:
                        gap = (plain[i][4][j + m][0][1]
                               - plain[i][4][j + m][1][1])
                        if gap > SPEC_TIE:
                            raise AssertionError(
                                f"speculation tree forced: stream {i} gave "
                                f"{a} for {b} at step {j + m} (path {path},"
                                f" top-2 gap {gap:.4f} > {SPEC_TIE})")
                        ties.append(round(gap, 4))
                        break
                if path and path[0] == 1:
                    # the runner-up won a near-tie: its row is not the
                    # stream's, so only the pending row is kept
                    q[i] += 1
                    continue
                through += bool(path)
                q[i] += n_out
        worst, at = 0.0, None
        for i in range(B):
            for name in ("k", "v"):
                a = tctx[name][:, :, i, start[i]:q[i]].float()
                b = lctx[name][:, :, i, start[i]:q[i]].float()
                # [L, kvh, rows, hd] -> one vector a (layer, row)
                a, b = a.permute(0, 2, 1, 3).flatten(2), \
                    b.permute(0, 2, 1, 3).flatten(2)
                rel = (a - b).norm(dim=-1) / b.norm(dim=-1).clamp(min=1e-6)
                m = rel.max().item()
                if m > worst:
                    flat = int(rel.argmax())
                    worst, at = m, (i, name, flat // rel.shape[1],
                                    start[i] + flat % rel.shape[1])
        del tctx, lctx
    torch.cuda.empty_cache()
    log(f"speculation tree forced: the plain dense streams of {B} prompts "
        f"through {calls} greedy tree verifies (a wrong sibling, then the "
        f"true chain of {K} under node 2): {through} row steps accepted "
        f"through node 2, {len(ties)} near-ties {ties}; committed rows "
        f"against a linear batch_score of the true chain: largest relative "
        f"L2 difference {worst:.5f} (stream, k/v, layer, position {at}); "
        f"tolerance {SPEC_TREE_KV_TOL}")
    if not through:
        raise AssertionError("speculation tree forced: no verify accepted "
                             "through the true sibling")
    if worst > SPEC_TREE_KV_TOL:
        raise AssertionError(
            f"speculation tree forced: a committed row differs from the "
            f"linear scorer's by {worst:.4f} > {SPEC_TREE_KV_TOL} ({at})")
    return calls, through, len(ties), worst


def check_speculation_tree(params, state):
    """Tree speculation at Llama-3.1-8B's width (the speculation phase's
    weights, prompts and plain runs: TN at all 32 layers, as N, the other
    arms, the seeded pair and the teacher-forced tree check at the first
    CUT_LAYERS; default EngineConfig with K = 4 adaptive, 4
    branches, the auto budget of 17 nodes), four arms: TN (dense, n-gram
    trie), TQ (int8 KV, n-gram trie: the int8 commit), TD (dense, comb
    drafts from the Llama-3.2-1B draft, random weights from seed 1:
    m > 1 drafting, rejection, adaptive de-speculation) and TS (dense,
    the 8B as its own comb draft: the accept path along the spine). Each
    arm is held to the plain streams up to a near-tie, its fused rounds'
    flash-decode launches checked (the kernels line's
    launches_spec_tree), the tree node counter must move; TN must accept
    and TD de-speculate; a seeded temperature-0.8 request twice on TN
    draws one stream; then the teacher-forced tree check. Returns the
    (dense, int8) kernel launches of the arms."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg32, params32 = ModelConfig.llama3_8b(), params
    cfg = ModelConfig.llama3_8b(num_layers=CUT_LAYERS)
    params = first_layers(params, CUT_LAYERS)
    prompts, lps = state["prompts"], state["lps"]
    plain, plain_tps, linear = (state["plain"], state["plain_tps"],
                                state["linear"])
    draft_cfg = ModelConfig.llama3_1b(num_layers=CUT_LAYERS)
    draft_1b = (draft_cfg,
                llama.init_params(draft_cfg, SEED + 1, device="cuda"))
    arms = (("TN", cfg32, params32, "none", "ngram", None, "N", "full"),
            ("TQ", cfg, params, "int8", "ngram", None, "Q", "int8"),
            ("TD", cfg, params, "none", "draft", draft_1b, "D", "none"),
            ("TS", cfg, params, "none", "draft", (cfg, params), "S",
             "none"))
    launches = {"none": 0, "int8": 0}
    short = []
    for name, acfg, aparams, kv, mode, draft, lin, pk in arms:
        st, ran, _ = spec_arm(
            name, acfg, aparams, kv, mode, draft, prompts, lps, plain[pk],
            plain_tps[pk], tree=True,
            n_new=SPEC_SELF_NEW if name == "TS" else SPEC_NEW)
        launches[kv] += ran
        lv = linear[lin]
        log(f"speculation {name} beside {lin} (same run): verify "
            f"{st['verify_ms'][0]:.2f} ms wall {st['verify_ms'][1]:.2f} ms "
            f"device a dispatch (linear {lv['verify_ms'][0]:.2f}, "
            f"{lv['verify_ms'][1]:.2f}); draft {st['draft_ms'][0]:.2f} / "
            f"{st['draft_ms'][1]:.2f} ms (linear {lv['draft_ms'][0]:.2f} / "
            f"{lv['draft_ms'][1]:.2f}); decode {st['tps']:.1f} tok/s "
            f"(linear {lv['tps']:.1f}, plain {plain_tps[pk]:.1f}); "
            f"acceptance {st['spec_acceptance_rate']:.4f} (linear "
            f"{lv['spec_acceptance_rate']:.4f})")
        short.append(f"{name} acc {st['spec_acceptance_rate']:.3f} "
                     f"{st['per_step']:.2f} tok/step {st['tps']:.0f}/"
                     f"{plain_tps[pk]:.0f} tok/s verify "
                     f"{st['verify_ms'][1]:.0f} (lin "
                     f"{lv['verify_ms'][1]:.0f}) ms ties {st['ties']}")
        if name == "TN":
            if not st["spec_accepted_total"]:
                raise AssertionError("speculation TN: no token accepted")
            check_seeded_spec(cfg, params, prompts[-1], tree=True)
        if name == "TD" and not st["spec_despec_total"]:
            raise AssertionError("speculation TD: no slot de-speculated")
    del draft_1b
    gc.collect()
    torch.cuda.empty_cache()
    calls, through, ties, worst = check_tree_forced(
        cfg, params, prompts[:8], plain["none"][:8])
    short.append(f"forced: {calls} verifies, {through} rows via node 2, "
                 f"ties {ties}, kv {worst:.4f}")
    figures("; ".join(short))
    return launches["none"], launches["int8"]


def check_speculation_w8a16(qparams):
    """Arm W: n-gram speculation with the w8a16 weights (their first
    CUT_LAYERS layers, as the other arms; dense KV), the
    speculation phase's burst held against the same engine's plain run;
    the verify's products and logits run on the w8a16 kernels at M =
    rows x (K+1), eagerly, and must have launched some. Returns
    (flash-decode launches, w8a16_gemm executions counted by the kernels
    on the card) of the arm."""
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import w8a16

    qcfg = ModelConfig.llama3_8b_int8(num_layers=CUT_LAYERS)
    qparams = first_layers(qparams, CUT_LAYERS)
    prompts = spec_prompts(qcfg.vocab_size)
    lps = [2 if i in SPEC_LP else None for i in range(len(prompts))]
    plain, plain_tps = spec_plain(qcfg, qparams, "none", prompts, lps)
    from dynamo_tpu_torch.spec import decoder

    verify_launches = [0]
    verify = decoder.SpecDecoder.verify

    def counted(self, *a, **kw):
        n0 = w8a16.launches
        out = verify(self, *a, **kw)
        verify_launches[0] += w8a16.launches - n0
        return out

    decoder.SpecDecoder.verify = counted

    def reset():
        w8a16.launches = w8a16.launches_wgmma = 0
        w8a16.executed(torch.device("cuda"), reset=True)

    try:
        st, ran, line = spec_arm("W", qcfg, qparams, "none", "ngram", None,
                                 prompts, lps, plain, plain_tps, reset)
    finally:
        decoder.SpecDecoder.verify = verify
    gemms = w8a16.executed(torch.device("cuda"))
    if not verify_launches[0] or not st["spec_verify_steps"]:
        raise AssertionError(f"speculation W: the verifies launched "
                             f"{verify_launches[0]} w8a16 products")
    log(f"speculation W: w8a16_gemm ran {gemms} times on the card, "
        f"{verify_launches[0]} of them launched by {st['spec_verify_dispatch_total']} "
        f"verify dispatches ({w8a16.launches_wgmma} of all eager launches "
        f"on the wgmma kernel)")
    figures(line + f"; w8a16 {gemms}, verify {verify_launches[0]}")
    return ran, gemms


# ---------------------------------------------------------------------------
# tenancy and overload


def lora_factors(cfg):
    """The variants of the tenancy phases: adapters 1..3 drawn by
    random_adapter (seed = the id) at LORA_RANK."""
    from dynamo_tpu_torch.tenancy.adapters import random_adapter

    return {aid: random_adapter(cfg, LORA_RANK, seed=aid)
            for aid in (1, 2, 3)}


def lora_gather_mb(cfg, slots, elem):
    """MB of the bank rows a decode round gathers for ``slots`` slots
    (every adapted site of every layer, A and B at LORA_RANK)."""
    from dynamo_tpu_torch.tenancy.adapters import adapter_site_dims

    per = sum(di + do for di, do in adapter_site_dims(cfg).values())
    return slots * per * LORA_RANK * cfg.num_layers * elem / 1e6


def lora_arm(label, cfg, params, kv_quant, base_tokens, factors,
             own_bursts=False):
    """One arm of the tenancy phase: an engine with a bank of 4 (adapters
    1..3 installed) serves the 8 serve prompts with LORA_IDS in one gated
    burst (top-2 logprobs). Adapter 0's streams must equal
    ``base_tokens`` (the serve phase's generate() of the same burst on an
    engine without a bank) exactly; every variant parts from them. With
    ``own_bursts``, each variant then serves all 8 prompts in a burst of
    its own on a cold cache (the same prefill groups), whose streams for
    the variant's prompts must equal the mixed burst's up to a top-2 swap
    (part_ways). Every round and patch is a
    replay; the KV mode's flash-decode kernel runs on every layer of
    every decode step inside them (w8a16: 7 products a layer and the
    logits too). Returns (the engine, stopped, its flash-decode launches
    (dense, int8), figures)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.ops import w8a16

    quant = kv_quant == "int8"
    quant_w = cfg.quant == "int8"
    prompts = serve_prompts(cfg.vocab_size)
    eng = TorchEngine(cfg, EngineConfig(kv_quant=kv_quant, lora_adapters=4,
                                        lora_rank=LORA_RANK),
                      params=params, device="cuda")
    for aid, w in factors.items():
        eng.install_adapter(aid, w)
    # every kernel count to 0 just before the main path
    fd.launches = fd.launches_int8 = 0
    eng.kernel_launches = 0
    fd.executed(eng.device, reset=True)
    if quant_w:
        w8a16.launches = w8a16.launches_wgmma = 0
        eng.graphs.w8a16_replayed = 0
        w8a16.executed(eng.device, reset=True)
    steps0 = eng.step_count

    async def drive():
        out = {}
        IntakeGate(eng, len(prompts))
        out[0] = await generate_all(eng, prompts, N_NEW, logprobs=2,
                                    adapters=LORA_IDS)
        for v in (1, 2, 3) if own_bursts else ():
            # a cold cache: the variant's prompts prefill along the mixed
            # burst's path, not as prefix hits on its blocks
            await settle_engines(eng)
            await asyncio.to_thread(eng.clear_kv_blocks)
            IntakeGate(eng, len(prompts))
            out[v] = await generate_all(eng, prompts, N_NEW, logprobs=2,
                                        adapters=[v] * len(prompts))
        await eng.stop()
        return out

    t0 = time.monotonic()
    out = asyncio.run(drive())
    secs = time.monotonic() - t0
    steps = eng.step_count - steps0
    ran = fd.executed(eng.device)
    launched, other = (ran[1], ran[0]) if quant else ran
    issued = fd.launches + fd.launches_int8
    check_replayed(eng, f"tenancy {label}")
    if (launched != cfg.num_layers * steps or other or issued
            or eng.kernel_launches != launched):
        raise AssertionError(
            f"tenancy {label}: the mode's kernel ran {launched} times over "
            f"{steps} decode steps of {cfg.num_layers} layers, the other "
            f"{other}, the wrapper issued {issued}, the graphs recorded "
            f"{eng.kernel_launches}")
    gemm = ""
    if quant_w:
        want = w8a16_step_gemms(cfg) * steps
        if eng.graphs.w8a16_replayed != want:
            raise AssertionError(
                f"tenancy {label}: the replays ran "
                f"{eng.graphs.w8a16_replayed} w8a16_gemm, want "
                f"{gemm_formula(cfg)} x {steps} = {want}")
        gemm = (f"; w8a16_gemm in the replays {eng.graphs.w8a16_replayed} ="
                f" {gemm_formula(cfg)} x {steps} steps")
    mixed = out[0]
    for toks, finish, *_ in mixed:
        if len(toks) != N_NEW or finish != "length":
            raise AssertionError(f"tenancy {label}: a request ended with "
                                 f"{len(toks)} tokens, finish {finish}")
    same0 = parted = 0
    for i, aid in enumerate(LORA_IDS):
        if aid == 0:
            if mixed[i][0] != base_tokens[i]:
                raise AssertionError(
                    f"tenancy {label}: adapter 0's stream for prompt {i} "
                    f"{mixed[i][0]} != the bank-less engine's "
                    f"{base_tokens[i]}")
            same0 += 1
    for v in (1, 2, 3):
        mine = [i for i, a in enumerate(LORA_IDS) if a == v]
        if all(mixed[i][0] == base_tokens[i] for i in mine):
            raise AssertionError(f"tenancy {label}: variant {v}'s streams "
                                 f"equal the base model's")
        parted += 1
    own = ""
    if own_bursts:
        got = [(mixed[i][0], mixed[i][4]) for i, a in enumerate(LORA_IDS)
               if a]
        want = [out[a][i][0] for i, a in enumerate(LORA_IDS) if a]
        splits, problems = part_ways(f"tenancy {label} own bursts", got,
                                     want)
        if problems:
            raise AssertionError("; ".join(problems))
        own = (f"; each variant's streams against its own burst: "
               f"{describe_splits(splits)}")
    ttft = [a["timing"]["ttft_s"] for _, _, a, *_ in mixed]
    gaps = [g for _, _, _, gs, _ in mixed for g in gs]
    log(f"tenancy {label}: 8 requests with adapter ids {LORA_IDS} in one "
        f"burst ({secs:.1f} s with {len(out) - 1} own bursts): adapter 0 "
        f"{same0}/{same0} streams identical to the bank-less engine's, "
        f"{parted}/3 variants part from the base{own}; TTFT median "
        f"{np.median(ttft):.4f} s, gap median {np.median(gaps) * 1e3:.2f} "
        f"ms; {steps} decode steps, the kernel ran {launched} times "
        f"(counted on the card) in replays{gemm}")
    figs = dict(gap=float(np.median(gaps)), ttft=float(np.median(ttft)))
    return eng, ran, figs


def time_rounds(eng, ids, rounds=16):
    """Device and wall ms a decode step of ``eng``'s replayed greedy round
    with the 8 serve prompts admitted (adapter ids ``ids``): ``rounds``
    replays back to back, timed by CUDA events and the host clock. The
    engine's loop is stopped; this thread admits and replays."""
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        StopConditions,
    )

    prompts = serve_prompts(eng.config.vocab_size)
    F = eng.ecfg.flush_every
    # no engine loop (a fresh engine's generate() would start one): this
    # thread runs the engine's steps
    eng._started = True
    while eng._entries:
        eng._process_entries(block=True)
    eng._apply_releases()
    if any(s is not None for s in eng._slots):
        raise AssertionError("time_rounds: the engine still holds requests")

    async def consume(p, aid):
        req = PreprocessedRequest(
            token_ids=list(p), adapter_id=aid,
            model=f"base:v{aid}" if aid else "",
            stop_conditions=StopConditions(max_tokens=2000,
                                           ignore_eos=True))
        async for _ in eng.generate(req):
            pass

    async def go():
        tasks = [asyncio.ensure_future(consume(p, a))
                 for p, a in zip(prompts, ids)]
        while eng._intake.qsize() < len(prompts):
            await asyncio.sleep(0)
        eng._drain_intake()
        for _ in range(200):
            if not (eng._waiting or eng._prefilling):
                break
            eng._admit()
        eng._flush_seals()
        if int(eng._slot_active.sum()) != len(prompts):
            raise AssertionError("time_rounds: prompts not admitted")
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        for _ in range(rounds):
            eng.graphs.round(False, False, None)
        e1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        return (e0.elapsed_time(e1) / (rounds * F),
                wall * 1e3 / (rounds * F))

    return asyncio.run(go())


def check_tenancy(params, qparams, base, direct):
    """The tenancy plane at Llama-3.1-8B on the serve weights: three arms,
    each an engine with a bank of 4 (rank LORA_RANK, adapters 1..3 from
    random_adapter) serving the serve prompts with LORA_IDS in one burst
    (lora_arm): dense KV (and each variant's own burst), int8 KV (the
    kernel's int8 mode), and the w8a16 weights (``qparams``). ``base``
    holds the serve phases' tokens by arm (the bank-less engines' bursts:
    adapter 0 must equal them exactly); ``direct`` the dense serve
    figures. Then a decode step's device and wall ms with the mixed bank
    beside a bank-less engine's over the same prompts (time_rounds, one
    process, one card), and the bytes a round's gather moves. Returns the
    flash-decode launches of the phase by mode (launches_tenancy)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.llama3_8b()
    t0 = time.monotonic()
    factors = lora_factors(cfg)
    log(f"tenancy: 3 variants of rank {LORA_RANK} drawn in "
        f"{time.monotonic() - t0:.1f} s")
    eng, ran, figs = lora_arm("dense", cfg, params, "none", base["none"],
                              factors, own_bursts=True)
    launches = list(ran)
    t_bank = time_rounds(eng, LORA_IDS)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    bare = TorchEngine(cfg, EngineConfig(), params=params, device="cuda")
    t_bare = time_rounds(bare, [0] * len(LORA_IDS))
    del bare
    gc.collect()
    torch.cuda.empty_cache()
    gather = lora_gather_mb(cfg, len(LORA_IDS), 2)
    log(f"tenancy: a decode step of the replayed greedy round, 8 slots "
        f"with adapter ids {LORA_IDS}: {t_bank[0]:.3f} ms device, "
        f"{t_bank[1]:.3f} ms wall; without a bank {t_bare[0]:.3f} ms "
        f"device, {t_bare[1]:.3f} ms wall (+{t_bank[0] - t_bare[0]:.3f} ms "
        f"device); a round's gather of 8 slots' rows moves {gather:.0f} MB "
        f"in bf16 ({2 * gather:.0f} MB in the reference's f32); the burst's "
        f"gap median {figs['gap'] * 1e3:.2f} ms beside the serve phase's "
        f"{np.median(direct['gaps']) * 1e3:.2f} ms")
    eng, ran, _ = lora_arm("int8", cfg, params, "int8", base["int8"],
                           factors)
    launches = [a + b for a, b in zip(launches, ran)]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng, ran, _ = lora_arm("w8a16", ModelConfig.llama3_8b_int8(), qparams,
                           "none", base["w8a16"], factors)
    launches = [a + b for a, b in zip(launches, ran)]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    figures(f"adapter 0 == bank-less, variants part, own bursts held; step "
            f"{t_bank[0]:.3f} ms device with the bank, {t_bare[0]:.3f} "
            f"without; gather {gather:.0f} MB; launches dense "
            f"{launches[0]}, int8 {launches[1]}")
    return launches


def check_overload(params):
    """The overload plane at Llama-3.1-8B's width and its first CUT_LAYERS
    layers (the serve weights'), dense KV:
    engines A and B (2 decode slots, max_waiting_requests 3,
    tenant_max_waiting_requests 2; A with preempt_running) behind the
    port's KvPushRouter (router temperature 0) and HttpService, and a
    reference engine R of the same shape.

    Storm: 12 streamed completions (32 tokens, one tenant each) sent at
    once through the frontend: every one answers 200 and runs to its
    finish, or 429 with a whole-second Retry-After; some answer 429, the
    frontend's dynamo_overload_http_429_total counts them and the router
    spilled each; then every bounced prompt, sent again one at a time,
    answers 200 (the queue recovered).

    Waiting preemption, on B: two low-priority requests hold its lanes,
    three more wait (the budget); a HIGH-priority arrival is admitted and
    the newest waiting one is evicted with EngineOverloadedError
    (waiting_preemptions and dynamo_overload_preempted_total +1); the
    high one then waits ahead of the two low ones left, and all three
    are served.

    Tenant budget, on B: with its lanes held, tenant "storm" sends 4: two
    wait, two bounce naming tenant "storm"; tenant "calm" then admits
    (dynamo_tenant_rejected_total: storm +2, calm 0).

    Running preemption, through the frontend and a router holding only
    A: a low-priority filler on A, then a low-priority stream (the
    victim, top-2 logprobs) through the frontend; once it has streamed,
    B joins the router and a HIGH-priority request goes straight to A. A
    preempts the victim (the newest low-priority stream), whose stream
    migrates to B (PreemptedError: no breaker strike, A stays routed) and
    ends whole: its k tokens before the preemption equal generate()'s on
    R for the prompt alone, the rest R's for the replay request alone
    (the prompt and the k tokens), each on a cold cache, up to a step
    where R's top-2 gap is at most NEAR_TIE. The dense kernel runs on
    every layer of every decode step of A, B and R (launches_overload).
    Returns the launches."""
    from dynamo_tpu_torch.backend import Backend
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import (
        ModelChain,
        ModelManager,
    )
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter
    from dynamo_tpu_torch.kv_router.scheduler import KvRouterConfig
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.overload.errors import EngineOverloadedError
    from dynamo_tpu_torch.overload.metrics import OVERLOAD
    from dynamo_tpu_torch.preprocessor import (
        OpenAIPreprocessor,
        PromptFormatter,
    )
    from dynamo_tpu_torch.protocols.common import (
        OutputOptions,
        PreprocessedRequest,
        StopConditions,
    )
    from dynamo_tpu_torch.protocols.sse import SseDecoder
    from dynamo_tpu_torch.resilience.metrics import RESILIENCE
    from dynamo_tpu_torch.resilience.migration import build_replay_request
    from dynamo_tpu_torch.tenancy.metrics import TENANT
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer

    cfg = ModelConfig.llama3_8b(num_layers=CUT_LAYERS)
    params = first_layers(params, CUT_LAYERS)
    name = "llama3_8b"
    tok = make_test_tokenizer([f"t{i}" for i in range(3, cfg.vocab_size)])
    prompts = serve_prompts(cfg.vocab_size)
    others = offload_prompts(cfg.vocab_size)

    def mk(wid, preempt=False):
        return TorchEngine(cfg, EngineConfig(
            max_decode_slots=2, max_waiting_requests=3,
            tenant_max_waiting_requests=2, preempt_running=preempt,
            worker_id=wid), params=params, device="cuda")

    t0 = time.monotonic()
    A, B, R = mk("A", preempt=True), mk("B"), mk("R")
    engs = (A, B, R)
    log(f"overload: engines A, B, R built in {time.monotonic() - t0:.1f} s")
    pre = OpenAIPreprocessor(tokenizer=tok, formatter=PromptFormatter(),
                             model_name=name)
    push = KvPushRouter(KvRouter(64, KvRouterConfig(router_temperature=0.0)),
                        {"A": A, "B": B})
    push2 = KvPushRouter(KvRouter(64, KvRouterConfig(
        router_temperature=0.0)), {"A": A})
    for p in (push, push2):
        p.retry.base_delay_s = 0.001
    manager = ModelManager()
    manager.register(ModelChain(name=name, preprocessor=pre, engine=push,
                                backend=Backend(tok)))
    manager.register(ModelChain(name="preempt", preprocessor=pre,
                                engine=push2, backend=Backend(tok)))
    svc = HttpService(manager, host="127.0.0.1", port=0)
    o0, r0 = OVERLOAD.snapshot(), RESILIENCE.snapshot()
    t0s = {t: TENANT.get("dynamo_tenant_rejected_total", t)
           for t in ("storm", "calm")}

    def d_o(n):
        return OVERLOAD.get(n) - o0[n]

    def d_r(n):
        return RESILIENCE.get(n) - r0[n]

    def req(p, n, **kw):
        r = PreprocessedRequest(
            token_ids=list(p),
            stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
            output_options=OutputOptions(logprobs=kw.pop("logprobs", None)))
        for k, v in kw.items():
            setattr(r, k, v)
        return r

    async def outcome(eng, r):
        toks, top = [], []
        try:
            async for out in eng.generate(r):
                toks.extend(out.token_ids)
                top.extend(out.top_logprobs or [])
        except EngineOverloadedError as e:
            return ("overloaded", e)
        return ("ok", toks, top)

    async def post(p, model, tenant, seen=None, **extra):
        """One streamed completion: (status, Retry-After or None, the
        token ids its text maps back to, finish, [DONE] seen)."""
        async with HttpClient("127.0.0.1", svc.port) as c:
            r = await c.request("POST", "/v1/completions", json_body={
                "model": model, "prompt": p, "max_tokens": N_NEW,
                "temperature": 0, "stream": True,
                "nvext": {"ignore_eos": True}, **extra},
                headers={"X-Tenant-Id": tenant}, stream=True)
            if r.status != 200:
                await r.read()
                return (r.status, r.headers.get("retry-after"), [], None,
                        False)
            dec, text, finish, done = SseDecoder(), "", None, False
            async for chunk in r.chunks():
                for ev in dec.feed(chunk):
                    if ev.is_done:
                        done = True
                        continue
                    ch = ev.json()["choices"][0]
                    text += ch["text"]
                    finish = ch["finish_reason"] or finish
                    if seen is not None:
                        seen.extend(ch["text"].split())
            return (200, None, [int(w[1:]) for w in text.split()], finish,
                    done)

    async def hold(eng, lanes):
        """``lanes`` low-priority requests holding the engine's lanes until
        cancelled; returns their tasks once they hold them."""
        hogs = [asyncio.ensure_future(outcome(eng, req(others[i], 2000)))
                for i in range(lanes)]
        await wait_for(lambda: sum(s is not None for s in eng._slots)
                       == lanes and not eng._waiting, "lanes held")
        return hogs

    async def release(hogs):
        for h in hogs:
            h.cancel()
        await asyncio.gather(*hogs, return_exceptions=True)

    async def wait_for(cond, what, timeout=120):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"overload: {what} never happened")
            await asyncio.sleep(0.002)

    def waiting(eng):
        return (sum(1 for r in eng._waiting if r.slot < 0)
                + eng._intake.qsize())

    async def drive():
        await svc.start()
        try:
            fig = {}
            # ---- storm: 12 at once through the frontend
            storm = prompts + others[4:8]
            res = await asyncio.gather(*[
                post(p, name, f"t{i}") for i, p in enumerate(storm)])
            bounced = [i for i, r in enumerate(res) if r[0] == 429]
            served = [r for r in res if r[0] == 200]
            if (not bounced or len(bounced) + len(served) != len(storm)
                    or any(r[1] is None or int(r[1]) < 1
                           for r in res if r[0] == 429)
                    or any(r[3] != "length" or not r[4] for r in served)):
                raise AssertionError(f"overload storm: {[r[:2] for r in res]}")
            n429 = d_o("dynamo_overload_http_429_total")
            spills = d_o("dynamo_overload_router_spills_total")
            rejected = d_o("dynamo_overload_rejected_total")
            if n429 != len(bounced) or spills < len(bounced):
                raise AssertionError(
                    f"overload storm: {len(bounced)} answered 429, the "
                    f"counter says {n429}, spills {spills}")
            again = [await post(storm[i], name, f"t{i}") for i in bounced]
            if any(r[0] != 200 or r[3] != "length" for r in again):
                raise AssertionError(f"overload: the queue did not recover: "
                                     f"{[r[:2] for r in again]}")
            fig["storm"] = (len(served), len(bounced),
                            sorted({r[1] for r in res if r[0] == 429}),
                            rejected, spills)
            await settle_engines(A, B)
            # ---- waiting preemption on B
            hogs = await hold(B, 2)
            pre0 = B.waiting_preemptions
            lows = []
            for i in range(3):
                lows.append(asyncio.ensure_future(outcome(
                    B, req(prompts[i], N_NEW, tenant=f"w{i}"))))
                await wait_for(lambda: waiting(B) == i + 1, "a low waits")
            high = asyncio.ensure_future(outcome(B, req(
                prompts[3], N_NEW, tenant="w3", priority=1)))
            evicted = await lows[2]
            # the queue after the eviction: the high one ahead of the
            # two low ones left
            order = [r.req.priority for r in B._waiting if r.slot < 0]
            await release(hogs)
            rest = [await lows[0], await lows[1]]
            out_high = await high
            if (evicted[0] != "overloaded"
                    or "preempted" not in str(evicted[1])
                    or B.waiting_preemptions - pre0 != 1
                    or d_o("dynamo_overload_preempted_total") != 1
                    or out_high[0] != "ok" or len(out_high[1]) != N_NEW
                    or any(r[0] != "ok" or len(r[1]) != N_NEW for r in rest)
                    or order != [1, 0, 0]):
                raise AssertionError(
                    f"overload waiting preemption: evicted {evicted}, "
                    f"high {out_high[0]}, rest {[r[0] for r in rest]}, "
                    f"order {order}")
            await settle_engines(B)
            # ---- a tenant's budget bounces only that tenant
            hogs = await hold(B, 2)
            storm_t = [asyncio.ensure_future(outcome(
                B, req(others[2 + i], N_NEW, tenant="storm")))
                for i in range(4)]
            await wait_for(lambda: sum(t.done() for t in storm_t) >= 2
                           and waiting(B) == 2, "the storm's bounces")
            calm = asyncio.ensure_future(outcome(
                B, req(prompts[4], N_NEW, tenant="calm")))
            await wait_for(lambda: waiting(B) == 3, "calm waits")
            await release(hogs)
            outs = [await t for t in storm_t]
            out_calm = await calm
            tb = [o for o in outs if o[0] == "overloaded"]
            rej = {t: TENANT.get("dynamo_tenant_rejected_total", t) - n
                   for t, n in t0s.items()}
            if (len(tb) != 2 or any(o[1].tenant != "storm" for o in tb)
                    or out_calm[0] != "ok"
                    or rej != {"storm": 2, "calm": 0}):
                raise AssertionError(
                    f"overload tenant budget: storm {[o[0] for o in outs]}, "
                    f"calm {out_calm[0]}, rejected {rej}")
            fig["tenant"] = ([o[1].retry_after_s for o in tb], rej)
            await settle_engines(B)
            # ---- running preemption through the frontend, migrated to B
            for eng in (A, B):
                await asyncio.to_thread(eng.clear_kv_blocks)
            filler = asyncio.ensure_future(outcome(A, req(others[0], 2000)))
            await wait_for(lambda: any(s is not None for s in A._slots)
                           and not A._waiting, "the filler holds a lane")
            seen: list = []
            mig0 = A.preempt_migrations
            victim = asyncio.ensure_future(post(
                prompts[0], "preempt", "victim", seen, logprobs=2))
            await wait_for(lambda: len(seen) >= 8, "the victim streams")
            push2.add_worker("B", B)
            out_high = await outcome(A, req(prompts[5], 8, priority=1))
            got = await victim
            await release([filler])
            k = int(d_r("dynamo_migration_replayed_tokens_total"))
            states = push2.health.states()
            if (got[0] != 200 or got[3] != "length" or not got[4]
                    or A.preempt_migrations - mig0 != 1
                    or d_o("dynamo_overload_preempt_migrations_total") != 1
                    or d_r("dynamo_migration_total") != 1
                    or states.get("A", "closed") != "closed"
                    or "A" not in push2.workers or out_high[0] != "ok"
                    or not 0 < k < N_NEW):
                raise AssertionError(
                    f"overload running preemption: status {got[0]}, finish "
                    f"{got[3]}, preempted {A.preempt_migrations - mig0}, "
                    f"migrations {d_r('dynamo_migration_total')}, replayed "
                    f"{k}, breakers {states}, high {out_high[0]}")
            await settle_engines(A, B)
            # generate() on R along the same paths, each on a cold cache
            ref1 = await outcome(R, req(prompts[0], N_NEW, logprobs=2))
            await asyncio.to_thread(R.clear_kv_blocks)
            replay = build_replay_request(req(prompts[0], N_NEW),
                                          ref1[1][:k])
            replay.output_options = OutputOptions(logprobs=2)
            ref2 = await outcome(R, replay)
            want = ref1[1][:k] + ref2[1]
            tops = ref1[2][:k] + ref2[2]
            shown = [t for t in want if t > 2]
            if got[2] != shown:
                j = next(j for j, (a, b) in enumerate(zip(got[2], shown))
                         if a != b)
                # the step of the j-th shown token, and R's top-2 gap there
                step = [i for i, t in enumerate(want) if t > 2][j]
                gap = tops[step][0][1] - tops[step][1][1]
                if gap > NEAR_TIE:
                    raise AssertionError(
                        f"overload running preemption: the migrated stream "
                        f"{got[2]} != generate()'s {shown} (step {step}, "
                        f"R's top-2 gap {gap:.4f})")
                fig["tie"] = (step, gap)
            fig["preempt"] = (k, len(got[2]))
            return fig
        finally:
            await svc.stop()
            for eng in engs:
                await eng.stop()

    fd.launches = fd.launches_int8 = 0
    fd.executed(A.device, reset=True)
    steps0 = [e.step_count for e in engs]
    fig = asyncio.run(drive())
    steps = sum(e.step_count - s for e, s in zip(engs, steps0))
    dense, int8 = fd.executed(A.device)
    if (dense != cfg.num_layers * steps or int8
            or fd.launches + fd.launches_int8):
        raise AssertionError(
            f"overload: the kernel ran {dense} times (int8 {int8}) over "
            f"{steps} decode steps of {cfg.num_layers} layers")
    for eng in engs:
        check_replayed(eng, f"overload {eng.ecfg.worker_id}")
    n_ok, n_429, retry, rejected, spills = fig["storm"]
    k, n_shown = fig["preempt"]
    tie = (f"; R's near-tie at step {fig['tie'][0]} (gap "
           f"{fig['tie'][1]:.4f})" if "tie" in fig else "")
    log(f"overload: storm of 12: {n_ok} served, {n_429} answered 429 "
        f"(Retry-After {retry} s; engine rejections {rejected:.0f}, router "
        f"spills {spills:.0f}), all {n_429} served on retry; waiting "
        f"preemption evicted the newest low entry, the high one queued "
        f"ahead of the low ones left; tenant storm bounced twice (Retry-After "
        f"{fig['tenant'][0]} s), calm admitted; running preemption "
        f"migrated the victim after {k} tokens, its whole stream "
        f"generate()'s along the same paths{tie}; the kernel ran {dense} "
        f"times over {steps} decode steps of A, B and R")
    figures(f"storm {n_ok} ok / {n_429} x 429 then recovered; waiting, "
            f"tenant and running preemption held (migrated after {k} "
            f"tokens{tie}); launches {dense}")
    del A, B, R, engs
    gc.collect()
    torch.cuda.empty_cache()
    return dense


def offload_prompts(vocab: int):
    """Wave B of the offload phase: 8 prompts of the serve prompts'
    lengths, from seed 1."""
    rng = np.random.RandomState(1)
    return [rng.randint(0, vocab, size=len(p)).tolist()
            for p in serve_prompts(vocab)]


def settle_offloads(eng, want_blocks, timeout_s=60.0):
    """Wait until the engine's offload queue is empty and nothing is in
    flight, with G2 and G3 holding ``want_blocks`` blocks at least."""
    t0 = time.monotonic()
    while True:
        held = len(eng.offload) + len(eng.offload.spill)
        busy = eng.offloads_pending()
        if held >= want_blocks and not busy:
            return
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(
                f"offload: G2 + G3 hold {held} blocks after {timeout_s} s "
                f"(want {want_blocks}); queue busy {bool(busy)}")
        time.sleep(0.02)


def offload_waves(eng, cfg, n_new=32):
    """Waves A (the serve prompts), B (``offload_prompts``) and C (A
    again) on ``eng``, each burst held at the intake until all 8 wait;
    with tiers, G2 and G3 must hold the blocks sealed so far before the
    next wave. Returns each wave's results (generate_all's tuples) and,
    around wave C, the G3 onboard hits and the integrity counters."""
    from dynamo_tpu_torch.kv_integrity import KV_INTEGRITY

    waves = {}
    c_g3 = None
    before = after = None
    for name, prompts in (("A", serve_prompts(cfg.vocab_size)),
                          ("B", offload_prompts(cfg.vocab_size)),
                          ("C", serve_prompts(cfg.vocab_size))):
        if name == "C" and eng.offload is not None:
            before = KV_INTEGRITY.snapshot()
            g3_0 = eng.offload.spill.onboard_hits
        IntakeGate(eng, len(prompts))
        waves[name] = asyncio.run(generate_all(eng, prompts, n_new))
        if eng.offload is not None:
            if name == "C":
                after = KV_INTEGRITY.snapshot()
                c_g3 = eng.offload.spill.onboard_hits - g3_0
            else:
                settle_offloads(eng, eng.allocator.total_pages
                                - len(eng.allocator._free))
    for name, res in waves.items():
        for toks, finish, *_ in res:
            if len(toks) != n_new or finish != "length":
                raise AssertionError(f"offload wave {name}: a request ended "
                                     f"with {len(toks)} tokens, {finish}")
    return waves, c_g3, before, after


def check_export_import(eng, what):
    """export_pages of 16 committed pages (the most recently parked),
    imported into 16 fresh pages and exported again, must be byte-equal;
    clear_kv_blocks must return the G1 + G2 + G3 sizes before it."""
    from dynamo_tpu_torch.kv_integrity import tensor_bytes

    def raw(x):
        if hasattr(x, "scales"):
            return bytes(tensor_bytes(x.data)) + bytes(tensor_bytes(x.scales))
        return bytes(tensor_bytes(x))

    a = eng.allocator
    src = [a._registry[h].page for h in list(a._lru)[-16:]]
    dst = a.allocate(16)
    if len(src) != 16 or dst is None:
        raise AssertionError(f"{what}: no 16 committed and 16 free pages")
    t0 = time.monotonic()
    first = eng.export_pages(src)
    eng.import_pages(dst, first)
    second = eng.export_pages(dst)
    secs = time.monotonic() - t0
    a.free(dst)
    if raw(first) != raw(second) or raw(first) == raw(eng.export_pages(
            [a._registry[h].page for h in list(a._lru)[:16]])):
        raise AssertionError(f"{what}: export -> import -> export is not "
                             f"byte-equal")
    settle_offloads(eng, 0)
    sizes = (len(a._lru), len(eng.offload), len(eng.offload.spill))
    cleared = eng.clear_kv_blocks()
    if cleared != sum(sizes) or len(eng.offload) or len(eng.offload.spill):
        raise AssertionError(f"{what}: clear_kv_blocks returned {cleared}, "
                             f"tiers held G1 {sizes[0]}, G2 {sizes[1]}, G3 "
                             f"{sizes[2]}")
    log(f"offload {what}: 16 pages exported, imported and exported again "
        f"byte-equal ({secs:.3f} s for the three ops); clear_kv_blocks "
        f"dropped {cleared} = G1 {sizes[0]} + G2 {sizes[1]} + G3 "
        f"{sizes[2]}")


def check_offload(params, counts, card):
    """The offload phase: Llama-3.1-8B's width at its first CUT_LAYERS
    layers (the serve phase's bf16 weights; 32 until the script's time
    was cut, so a page is a quarter of the 8B's) with a 96-page pool, a 128-page G2 and a 128-page G3 in a temporary
    directory, through waves A, B and C (``offload_waves``), in dense and
    int8 KV. Wave C must be token-identical to a G1 reference (512 pages,
    no tiers: every block of C a G1 hit), every matchable block of C a G1
    hit or onboarded with no block recomputed or failed, and G3 must
    serve a block of C; then export/import and clear_kv_blocks
    (``check_export_import``). A dense engine without tiers at 96 pages
    gives the recompute baseline. In int8, wave F (``wave_f``): a serve
    prompt evicted from G1 and replayed with flip_kv_bits armed once must
    have one onboarded page quarantined in every tier and recomputed,
    token-identical to the G1 reference's recompute of it alone. Prints
    wave C's TTFT by source, wave F's, wave B's decode gap with offload
    on and off, host ms a page and the copies' GB/s, each line beside
    ``card`` (nvidia-smi's name and power limit); sets the flash-decode
    launches of the offload engines' waves in ``counts`` (each mode's
    kernel on every layer of every step)."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.ops import flash_decode as fd

    cfg = ModelConfig.llama3_8b(num_layers=CUT_LAYERS)
    params = first_layers(params, CUT_LAYERS)
    ps = EngineConfig().page_size
    matchable = [(len(p) - 1) // ps for p in serve_prompts(cfg.vocab_size)]

    def run(ecfg, label, f_prompt=None):
        t0 = time.monotonic()
        eng = TorchEngine(cfg, ecfg, params=params, device="cuda")
        torch.cuda.synchronize()
        steps0 = eng.step_count
        fd.executed(eng.device, reset=True)
        waves, c_g3, before, after = offload_waves(eng, cfg)
        out = dict(waves=waves, c_g3=c_g3, before=before, after=after, f=None)
        if eng.offload is not None:
            # waves A-C's transfers, before wave F adds its own
            out["stats"] = eng.transfer_stats()
            out["kv"] = eng.metrics().kv_stats
            if ecfg.kv_quant == "int8":
                out["f"] = wave_f(eng, label)
        elif f_prompt is not None:
            # the G1 reference recomputes the prompt alone, as wave F does
            eng.clear_kv_blocks()
            out["f"] = asyncio.run(generate_all(eng, [f_prompt], 32))[0]
        out.update(ran=fd.executed(eng.device),
                   steps=eng.step_count - steps0)
        check_replayed(eng, f"offload {label}")
        out["secs"] = time.monotonic() - t0
        if eng.offload is not None:
            check_export_import(eng, label)
        asyncio.run(eng.stop())
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def ttft(res):
        t = [a["timing"]["ttft_s"] for _, _, a, *_ in res]
        return f"median {np.median(t):.4f} s max {max(t):.4f} s"

    def wave_f(eng, label):
        """Wave F: a fresh 4000-token prompt evicts wave A's blocks from
        G1; the first serve prompt whose blocks all left G1 for G2/G3 is
        replayed with flip_kv_bits armed once: the first onboarded page
        fails its crc and is quarantined in every tier, and it and the
        rest of the run are recomputed. Returns (prompt index, the
        replay's tokens, its TTFT, the integrity deltas)."""
        from dynamo_tpu_torch.kv_integrity import KV_INTEGRITY
        from dynamo_tpu_torch.resilience.chaos import CHAOS
        from dynamo_tpu_torch.tokens import compute_block_hashes

        rng = np.random.RandomState(2)
        evict = rng.randint(0, cfg.vocab_size, size=4000).tolist()
        asyncio.run(generate_all(eng, [evict], 1))
        settle_offloads(eng, 0)
        off, a = eng.offload, eng.allocator
        pick = None
        for i, p in enumerate(serve_prompts(cfg.vocab_size)):
            hs = compute_block_hashes(p, ps)[:(len(p) - 1) // ps]
            if a.cached_prefix_len(hs) == 0 and all(
                    h in off or h in off.spill for h in hs):
                pick = i, p, hs
                break
        if pick is None:
            raise AssertionError(f"offload {label} wave F: no serve prompt "
                                 f"left G1 whole for the lower tiers")
        i, p, hs = pick
        before = KV_INTEGRITY.snapshot()
        CHAOS.arm("flip_kv_bits", once=True)
        try:
            toks, finish, ann, *_ = asyncio.run(
                generate_all(eng, [p], 32))[0]
        finally:
            injected = CHAOS.points["flip_kv_bits"].injected_total
            CHAOS.reset()
        after = KV_INTEGRITY.snapshot()
        delta = {k.replace("dynamo_kv_integrity_", ""): int(after[k]
                                                            - before[k])
                 for k in ("dynamo_kv_integrity_failed_total",
                           "dynamo_kv_integrity_quarantined_total",
                           "dynamo_kv_integrity_recomputed_total")}
        q = hs[0]
        if (injected != 1 or delta["failed_total"] != 1
                or delta["quarantined_total"] != 1
                or delta["recomputed_total"] < 1
                or q not in eng.kv_quarantine or q in off or q in off.spill
                or len(toks) != 32 or finish != "length"):
            raise AssertionError(
                f"offload {label} wave F: flip_kv_bits fired {injected} "
                f"times; integrity deltas {delta}; the flipped block "
                f"quarantined {q in eng.kv_quarantine}, in G2 {q in off}, "
                f"in G3 {q in off.spill}; {len(toks)} tokens, {finish}")
        return i, toks, ann["timing"]["ttft_s"], delta

    def gap(res):
        return np.median([g for *_, gs, _ in res for g in gs]) * 1e3

    launches = {}
    by_mode = {}
    for kv_quant in ("none", "int8"):
        tmp = tempfile.mkdtemp(prefix="dynamo-torch-g3-")
        try:
            tiers = run(EngineConfig(
                kv_quant=kv_quant, num_pages=96, host_offload_pages=128,
                disk_offload_pages=128,
                disk_offload_path=os.path.join(tmp, "g3.mmap")),
                f"kv_quant={kv_quant}")
        finally:
            shutil.rmtree(tmp)
        ref = run(EngineConfig(kv_quant=kv_quant, num_pages=512),
                  f"G1 reference kv_quant={kv_quant}",
                  f_prompt=(serve_prompts(cfg.vocab_size)[tiers["f"][0]]
                            if tiers["f"] else None))
        quant = kv_quant == "int8"
        name = "flash_decode_int8" if quant else "flash_decode"
        mine, other = (tiers["ran"][1], tiers["ran"][0]) if quant \
            else tiers["ran"]
        if mine != cfg.num_layers * tiers["steps"] or other:
            raise AssertionError(
                f"offload {kv_quant}: {name} ran {mine} times (the other "
                f"mode {other}) over {tiers['steps']} steps")
        launches[name] = mine
        c_tiers = [t for t, *_ in tiers["waves"]["C"]]
        c_ref = [t for t, *_ in ref["waves"]["C"]]
        if c_tiers != c_ref:
            same = sum(a == b for x, y in zip(c_tiers, c_ref)
                       for a, b in zip(x, y))
            raise AssertionError(
                f"offload {kv_quant}: wave C differs from the G1 reference "
                f"({same} of {sum(map(len, c_ref))} tokens agree)")
        cached = [a["cached_blocks"] for _, _, a, *_ in tiers["waves"]["C"]]
        ref_cached = [a["cached_blocks"] for _, _, a, *_ in ref["waves"]["C"]]
        if cached != matchable or ref_cached != matchable:
            raise AssertionError(
                f"offload {kv_quant}: wave C matched {cached} blocks (G1 "
                f"reference {ref_cached}), want {matchable}")
        b, a = tiers["before"], tiers["after"]
        recomputed = (a["dynamo_kv_integrity_recomputed_total"]
                      - b["dynamo_kv_integrity_recomputed_total"])
        failed = a["dynamo_kv_integrity_failed_total"]
        verified = int(a["dynamo_kv_integrity_verified_total"]
                       - b["dynamo_kv_integrity_verified_total"])
        if recomputed or failed or not tiers["c_g3"]:
            raise AssertionError(
                f"offload {kv_quant}: wave C recomputed {recomputed} blocks, "
                f"{failed} failed verification, G3 served {tiers['c_g3']}")
        st = tiers["stats"]
        log(f"offload kv_quant={kv_quant}: waves A, B, C x 8 requests x 32 "
            f"tokens in {tiers['secs']:.1f} s (engine built in the time); "
            f"wave C token-identical to the G1 reference (512 pages); every "
            f"matchable block of C ({sum(matchable)}) a G1 hit or onboarded: "
            f"{st['onboard_pages']} onboarded, {tiers['c_g3']} of them "
            f"from G3, {verified} verified, 0 recomputed, 0 failed; "
            f"kv_stats {tiers['kv']}; {name} ran {mine} times on the card "
            f"= {cfg.num_layers} x {tiers['steps']} steps")
        log(f"offload kv_quant={kv_quant} ({card}): wave C TTFT onboarded "
            f"{ttft(tiers['waves']['C'])}, G1 hits {ttft(ref['waves']['C'])}"
            f"; host ms a page: offload (put thread: crc + copy into G2 "
            f"+ spill into G3) "
            f"{st['offload_host_ms_per_page']:.3f} over "
            f"{st['offload_pages']} pages, onboard (gather + verify + H2D "
            f"issue) {st['onboard_host_ms_per_page']:.3f}; D2H "
            f"{st['d2h_gb_s']:.2f} GB/s (copy stream), H2D "
            f"{st['h2d_gb_s']:.2f} GB/s")
        if tiers["f"]:
            fi, ftoks, fttft, fdelta = tiers["f"]
            if ftoks != ref["f"][0]:
                raise AssertionError(
                    f"offload {kv_quant} wave F: prompt {fi} after the "
                    f"quarantine differs from the G1 reference's recompute")
            log(f"offload kv_quant={kv_quant} wave F ({card}): a fresh "
                f"4000-token prompt evicted serve prompt {fi} from G1; "
                f"replayed with flip_kv_bits armed once: one onboarded page "
                f"failed its crc, quarantined in every tier, integrity "
                f"{fdelta}; 32 tokens identical to the G1 reference's "
                f"recompute; TTFT {fttft:.4f} s (wave C onboarded "
                f"{ttft(tiers['waves']['C'])})")
        by_mode[kv_quant] = (tiers, ref)
    base = run(EngineConfig(num_pages=96), "recompute baseline")
    tiers, ref = by_mode["none"]
    log(f"offload dense ({card}): wave C TTFT recomputed (96 pages, no "
        f"tiers) "
        f"{ttft(base['waves']['C'])}, onboarded "
        f"{ttft(tiers['waves']['C'])}, G1 hits {ttft(ref['waves']['C'])}; "
        f"wave B decode gap median with offload on "
        f"{gap(tiers['waves']['B']):.2f} ms, off "
        f"{gap(base['waves']['B']):.2f} ms (G1 reference "
        f"{gap(ref['waves']['B']):.2f} ms)")
    counts["flash_decode_offload"] = launches["flash_decode"]
    counts["flash_decode_int8_offload"] = launches["flash_decode_int8"]
    fi, _, fttft, fdelta = by_mode["int8"][0]["f"]
    figures(f"wave C TTFT onboarded {ttft(tiers['waves']['C'])}, recomputed "
            f"{ttft(base['waves']['C'])}; int8 wave F (flip_kv_bits once, "
            f"prompt {fi}): 1 page quarantined, "
            f"{fdelta['recomputed_total']} blocks recomputed, TTFT "
            f"{fttft:.4f} s, tokens = G1 reference")


def check_cli(extra=()):
    """The launcher as a user runs it, with no --device (and ``extra``
    flags): it must serve a prompt on the card (cuda) and exit 0."""
    cmd = [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=text",
           "out=torch", "--model-config", "tiny", "--cache-dtype", "float32",
           "--prompt", "w1 w2 w3", "--max-tokens", "8", *extra]
    t0 = time.monotonic()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if out.returncode != 0 or "on cuda" not in out.stderr:
        raise AssertionError(f"cli: exit {out.returncode}\n{out.stderr}")
    log(f"cli: {' '.join(cmd[1:])} exited 0 in "
        f"{time.monotonic() - t0:.1f} s ({out.stderr.strip().splitlines()[0]}"
        f"); printed {out.stdout.strip()!r}")
    return out.stdout[:-1]


class Proc:
    """A subprocess whose merged output lines a thread collects."""

    def __init__(self, *argv):
        self.argv = argv
        self.p = subprocess.Popen(
            [sys.executable, "-m", *argv], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines: list[str] = []
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self):
        for line in self.p.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_for(self, text, timeout=300.0):
        """The first output line holding ``text``."""
        deadline = time.monotonic() + timeout
        while True:
            hit = next((ln for ln in list(self.lines) if text in ln), None)
            if hit is not None:
                return hit
            if self.p.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(
                    f"cli distributed: {' '.join(self.argv)} printed no "
                    f"{text!r} (exit {self.p.poll()}):\n"
                    + "\n".join(self.lines[-30:]))
            time.sleep(0.05)

    def stop(self, timeout=60.0):
        """SIGTERM; the exit code."""
        if self.p.poll() is None:
            self.p.terminate()
        try:
            self.p.wait(timeout)
        except subprocess.TimeoutExpired:
            self.p.kill()
            self.p.wait()
        self._t.join(10)
        return self.p.returncode


def check_cli_distributed(text_out):
    """The distributed entry points as a user runs them, in subprocesses
    on the card: ``python -m dynamo_tpu_torch.cli cp --port 0``, two
    ``launch.run in=endpoint out=torch --model-config tiny --cache-dtype
    float32 --router-mode round_robin`` workers with no --device, and one
    ``launch.run in=http --control-plane`` frontend. Four greedy chat
    completions of the cli phase's prompt must each equal what in=text
    printed (``text_out``); both workers must run on cuda and have served
    at least one (each prints its own count when SIGTERM stops it); each
    worker runs with --system-port 0, its /health must answer 200, and
    SIGTERM must drain it ("drained; shutting down"); every process must
    exit 0."""
    import socket

    from dynamo_tpu_torch.frontend.http import HttpClient

    t0 = time.monotonic()
    procs = []
    try:
        cp = Proc("dynamo_tpu_torch.cli", "cp", "--port", "0")
        procs.append(cp)
        addr = cp.wait_for("listening on").split()[-1]
        workers = [Proc("dynamo_tpu_torch.launch.run", "in=endpoint",
                        "out=torch", "--model-config", "tiny",
                        "--cache-dtype", "float32", "--router-mode",
                        "round_robin", "--model-name", "tiny",
                        "--control-plane", addr, "--system-port", "0")
                   for _ in range(2)]
        procs += workers
        # the frontend discovers the workers: it starts beside them
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            http_port = sk.getsockname()[1]
        front = Proc("dynamo_tpu_torch.launch.run", "in=http",
                     "--control-plane", addr, "--http-host", "127.0.0.1",
                     "--http-port", str(http_port))
        procs.append(front)
        sys_ports = []
        for w in workers:
            if "on cuda" not in w.wait_for("TorchEngine on"):
                raise AssertionError("cli distributed: a worker is not on "
                                     "cuda")
            sys_ports.append(int(w.wait_for("system server on :").rsplit(
                ":", 1)[1]))
            w.wait_for("serving dynamo/backend/generate")

        async def health():
            out = []
            for port in sys_ports:
                async with HttpClient("127.0.0.1", port) as c:
                    out.append((await c.request("GET", "/health")).status)
            return out

        if asyncio.run(asyncio.wait_for(health(), 60)) != [200, 200]:
            raise AssertionError("cli distributed: a worker's system server "
                                 "did not answer /health")
        front.wait_for("dynamic frontend on")

        async def ask():
            async with HttpClient("127.0.0.1", http_port) as c:
                for _ in range(1200):
                    r = await c.request("GET", "/v1/models")
                    if [m["id"] for m in r.json()["data"]] == ["tiny"]:
                        break
                    await asyncio.sleep(0.05)
                texts = []
                for _ in range(4):
                    r = await c.request("POST", "/v1/chat/completions",
                                        json_body={
                        "model": "tiny", "max_tokens": 8, "messages": [
                            {"role": "user", "content": "w1 w2 w3"}]})
                    if r.status != 200:
                        raise AssertionError(f"cli distributed: status "
                                             f"{r.status} {r.body!r}")
                    texts.append(r.json()["choices"][0]["message"]["content"])
                return texts

        texts = asyncio.run(asyncio.wait_for(ask(), 120))
        if texts != [text_out] * 4:
            raise AssertionError(f"cli distributed: {texts}, in=text "
                                 f"printed {text_out!r}")
        served = []
        for w in workers:
            rc = w.stop()
            line = w.wait_for("served", timeout=10)
            if rc != 0 or not any("drained; shutting down" in ln
                                  for ln in w.lines):
                raise AssertionError(f"cli distributed: a worker exited "
                                     f"{rc} after SIGTERM:\n"
                                     + "\n".join(w.lines[-20:]))
            served.append(int(line.split()[-2]))
        if sum(served) != 4 or min(served) < 1:
            raise AssertionError(f"cli distributed: the workers served "
                                 f"{served} requests")
        for p in (front, cp):
            rc = p.stop()
            if rc != 0:
                raise AssertionError(f"cli distributed: {' '.join(p.argv)} "
                                     f"exited {rc}:\n"
                                     + "\n".join(p.lines[-20:]))
    finally:
        for p in procs:
            p.stop()
    log(f"cli distributed: cli cp ({addr}), two in=endpoint workers on "
        f"cuda (--system-port 0: /health 200 on ports {sys_ports}) and "
        f"in=http --control-plane in {time.monotonic() - t0:.1f} "
        f"s; 4 chat completions equal to in=text's {text_out!r}, served "
        f"{served} by the two workers; SIGTERM drained each worker "
        f"('drained; shutting down'); every process exited 0")


def first_step_logprob_diff(dense, quant, prompt):
    """The largest difference of the first step's logprobs (over the
    vocabulary) of ``prompt`` between Llama-3.1-8B with the dense weights
    and with their w8a16 quantization (llama.prefill of the prompt into a
    one-lane context)."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    toks = torch.tensor(prompt, dtype=torch.int32, device="cuda")
    lps = []
    for cfg, params in ((ModelConfig.llama3_8b(), dense),
                        (ModelConfig.llama3_8b_int8(), quant)):
        ctx = llama.init_ctx(cfg, 1, len(prompt), torch.bfloat16, "cuda")
        logits = llama.prefill(cfg, params, ctx, toks, 0, 0, len(prompt))
        lps.append(torch.log_softmax(logits, dim=-1))
        del ctx
    return (lps[0] - lps[1]).abs().max().item()


# ---------------------------------------------------------------------------
# checkpoint: the serve weights as an HF checkpoint and a GGUF file, loaded
# and served through --model-path

LLAMA31_ROPE = {"factor": 8.0, "low_freq_factor": 1.0,
                "high_freq_factor": 4.0,
                "original_max_position_embeddings": 8192,
                "rope_type": "llama3"}
# Llama-3.1-8B's published config.json
LLAMA31_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 128000,
    "eos_token_id": [128001, 128008, 128009], "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 131072,
    "mlp_bias": False, "model_type": "llama", "num_attention_heads": 32,
    "num_hidden_layers": 32, "num_key_value_heads": 8, "pretraining_tp": 1,
    "rms_norm_eps": 1e-05, "rope_scaling": LLAMA31_ROPE,
    "rope_theta": 500000.0, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "transformers_version": "4.43.0.dev0",
    "use_cache": True, "vocab_size": 128256}
CKPT_SHARD_BYTES = 5 * 10**9    # transformers' default max_shard_size
CKPT_MERGES = 1000
GGUF_LAYERS = 2
CKPT_NEW = 16                   # tokens a launcher request
# the constructs of the Llama 3.1 instruct template: defined tests, the
# strftime_now fallback, the system message split off by a slice, trim,
# tools as JSON in the first user turn, length, raise_exception
CKPT_TEMPLATE = (
    "{{- bos_token }}\n"
    "{%- if not tools_in_user_message is defined %}"
    "{%- set tools_in_user_message = true %}{%- endif %}\n"
    "{%- if not date_string is defined %}{%- if strftime_now is defined %}"
    "{%- set date_string = strftime_now('%d %b %Y') %}{%- else %}"
    "{%- set date_string = '26 Jul 2024' %}{%- endif %}{%- endif %}\n"
    "{%- if not tools is defined %}{%- set tools = none %}{%- endif %}\n"
    "{%- if messages[0]['role'] == 'system' %}"
    "{%- set system_message = messages[0]['content'] | trim %}"
    "{%- set messages = messages[1:] %}"
    "{%- else %}{%- set system_message = '' %}{%- endif %}\n"
    "{{- '<|start_header_id|>system<|end_header_id|>\\n\\n' }}"
    "{%- if tools is not none %}{{- 'Environment: ipython\\n' }}{%- endif %}"
    "{{- 'Cutting Knowledge Date: December 2023\\n' }}"
    "{{- 'Today Date: ' + date_string + '\\n\\n' }}"
    "{{- system_message }}{{- '<|eot_id|>' }}\n"
    "{%- if tools_in_user_message and not tools is none %}"
    "{%- if messages | length != 0 %}"
    "{%- set first_user_message = messages[0]['content'] | trim %}"
    "{%- set messages = messages[1:] %}{%- else %}"
    "{{- raise_exception('Cannot put tools in the first user message when "
    "there is no first user message!') }}{%- endif %}"
    "{{- '<|start_header_id|>user<|end_header_id|>\\n\\n' -}}"
    "{%- for t in tools %}{{- t | tojson(indent=4) }}{{- '\\n\\n' }}"
    "{%- endfor %}{{- first_user_message + '<|eot_id|>' }}{%- endif %}\n"
    "{%- for message in messages %}"
    "{{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'"
    " + message['content'] | trim + '<|eot_id|>' }}{%- endfor %}\n"
    "{%- if add_generation_prompt %}"
    "{{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}"
    "{%- endif %}\n")
CKPT_CHAT = [{"role": "system", "content": " You are a helpful assistant. "},
             {"role": "user", "content": "Explain what a KV cache is, in "
                                         "one sentence."}]


def llama3_specials() -> list[str]:
    """Llama 3's 256 special tokens, ids 128000..128255 in order."""
    named = ["<|begin_of_text|>", "<|end_of_text|>",
             "<|reserved_special_token_0|>", "<|reserved_special_token_1|>",
             "<|finetune_right_pad_id|>", "<|reserved_special_token_2|>",
             "<|start_header_id|>", "<|end_header_id|>", "<|eom_id|>",
             "<|eot_id|>", "<|python_tag|>"]
    return named + [f"<|reserved_special_token_{i}|>"
                    for i in range(3, 256 - len(named) + 3)]


def learn_merges(text: str, n: int) -> list[tuple[str, str]]:
    """``n`` byte-level BPE merges learned greedily from ``text`` (its
    Llama 3 pre-tokens, each merge the most frequent adjacent pair; ties
    to the larger pair), with incremental pair counts."""
    from collections import Counter

    from dynamo_tpu_torch.tokenizer_json import byte_level, llama3_pretokenize

    words = Counter(byte_level(w) for w in llama3_pretokenize(text))
    splits = {w: list(w) for w in words}
    pairs: Counter = Counter()
    where: dict = defaultdict(set)
    for w, c in words.items():
        for p in zip(splits[w], splits[w][1:]):
            pairs[p] += c
            where[p].add(w)
    merges = []
    while len(merges) < n and pairs:
        best, c = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        if c < 2:
            break
        merges.append(best)
        a, b = best
        for w in list(where.pop(best, ())):
            s, cw = splits[w], words[w]
            for p in zip(s, s[1:]):
                pairs[p] -= cw
                if pairs[p] <= 0:
                    del pairs[p]
            out, i = [], 0
            while i < len(s):
                if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            splits[w] = out
            for p in zip(out, out[1:]):
                pairs[p] += cw
                where[p].add(w)
    return merges


def llama3_tokenizer_json(text: str) -> dict:
    """A tokenizer.json of Llama 3's shape (a byte-level BPE with
    ignore_merges, Llama 3's split regex, a <|begin_of_text|> template,
    the ByteLevel decoder): the 256 byte symbols, the merges learned from
    ``text``, reserved tokens up to id 128000, then the 256 specials."""
    from dynamo_tpu_torch.tokenizer_json import BYTE_ENC, LLAMA3_PATTERN

    vocab = {BYTE_ENC[b]: b for b in range(256)}
    merges = learn_merges(text, CKPT_MERGES)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    while len(vocab) < 128000:
        vocab[f"<|pad_{len(vocab)}|>"] = len(vocab)
    added = [{"id": 128000 + i, "content": t, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for i, t in enumerate(llama3_specials())]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": True, "use_regex": True}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
             "behavior": "Isolated", "invert": False},
            dict(byte_level, use_regex=False)]},
        "post_processor": {"type": "Sequence", "processors": [
            dict(byte_level, trim_offsets=False, add_prefix_space=True),
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": "<|begin_of_text|>",
                                          "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [], "special_tokens": {"<|begin_of_text|>": {
                 "id": "<|begin_of_text|>", "ids": [128000],
                 "tokens": ["<|begin_of_text|>"]}}}]},
        "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": [[a, b] for a, b in merges]},
    }


def hf_layout(params, cfg, layers=None):
    """(HF name, HF shape, a function giving the tensor on the card in
    HF's [out, in] layout) of our parameter tree, in the order a
    checkpoint holds them; ``layers`` cuts the depth."""
    from dynamo_tpu_torch.models.llama import _HF_LAYER_MAP

    V, H = cfg.vocab_size, cfg.hidden_size
    out = [("model.embed_tokens.weight", (V, H), lambda: params["embed"])]
    for l in range(cfg.num_layers if layers is None else layers):
        for suffix, (ours, transpose) in _HF_LAYER_MAP.items():
            shape = tuple(params["layers"][ours].shape[1:])
            out.append((f"model.layers.{l}.{suffix}",
                        shape[::-1] if transpose else shape,
                        lambda l=l, ours=ours, t=transpose:
                        params["layers"][ours][l].T.contiguous() if t
                        else params["layers"][ours][l]))
    out.append(("model.norm.weight", (H,), lambda: params["norm_f"]))
    out.append(("lm_head.weight", (V, H),
                lambda: params["lm_head"].T.contiguous()))
    return out


def write_hf_checkpoint(d, params, cfg, tok_spec) -> tuple[int, int]:
    """The weights as bf16 safetensors shards of at most CKPT_SHARD_BYTES
    with model.safetensors.index.json, HF's file names, and the config,
    tokenizer and tokenizer_config files; (bytes of weights, shards)."""
    import struct as st

    os.makedirs(d)
    shards, cur, size = [], [], 0
    for name, shape, fn in hf_layout(params, cfg):
        nbytes = int(np.prod(shape)) * 2
        if cur and size + nbytes > CKPT_SHARD_BYTES:
            shards.append(cur)
            cur, size = [], 0
        cur.append((name, shape, fn, nbytes))
        size += nbytes
    shards.append(cur)
    weight_map, total = {}, 0
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        header, off = {"__metadata__": {"format": "pt"}}, 0
        for name, shape, _, nbytes in shard:
            header[name] = {"dtype": "BF16", "shape": list(shape),
                            "data_offsets": [off, off + nbytes]}
            off += nbytes
            weight_map[name] = fname
        h = json.dumps(header).encode()
        h += b" " * (-len(h) % 8)
        with open(os.path.join(d, fname), "wb") as f:
            f.write(st.pack("<Q", len(h)) + h)
            for _, _, fn, nbytes in shard:
                t = fn().contiguous().view(torch.uint8).cpu()
                f.write(t.numpy().data)
                total += nbytes
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(LLAMA31_CONFIG, num_hidden_layers=cfg.num_layers), f,
                  indent=2)
    with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tok_spec, f, ensure_ascii=False)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"bos_token": "<|begin_of_text|>",
                   "eos_token": "<|eot_id|>",
                   "chat_template": CKPT_TEMPLATE}, f, indent=2)
    return total, len(shards)


def q8_0(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """GGUF Q8_0 of a 2-D weight on the card, blocks of 32 along its rows
    (llama.cpp's quantize_row_q8_0: d = amax/127 stored as f16, q =
    round(x / d)): (the packed blocks [rows, cols/32, 34] uint8, the
    dequantized weight q * f16(d) in f32)."""
    x = w.float().reshape(w.shape[0], -1, 32)
    d = x.abs().amax(-1) / 127.0
    inv = torch.where(d > 0, 1.0 / d, torch.zeros_like(d))
    q = torch.round(x * inv[..., None]).to(torch.int8)
    d16 = d.half()
    blocks = torch.cat([d16[..., None].view(torch.uint8),
                        q.view(torch.uint8)], -1)
    return blocks, (q.float() * d16.float()[..., None]).reshape(w.shape)


def gguf_permute(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """llama.cpp's HF->GGUF q/k row order (rows of anything)."""
    return (x.reshape(n_head, 2, x.shape[0] // n_head // 2, *x.shape[1:])
             .transpose(1, 2).reshape(x.shape))


def write_gguf(path, params, cfg, tok_spec, layers) -> dict:
    """A GGUF v3 file of the first ``layers`` layers: Q8_0 weights (q and
    k in llama.cpp's permuted row order), f32 norms, Llama 3's metadata and
    the BPE tokenizer ("gpt2" model, "llama-bpe" pre-tokenizer). Returns
    the dequantized weights by HF name (f32, HF layout) the loader must
    reproduce."""
    import struct as st

    def s(x):
        b = x.encode()
        return st.pack("<Q", len(b)) + b

    def kv(key, vtype, payload):
        return s(key) + st.pack("<I", vtype) + payload

    def u32(k, v):
        return kv(k, 4, st.pack("<I", v))

    def f32(k, v):
        return kv(k, 6, st.pack("<f", v))

    def strs(k, items):
        return kv(k, 9, st.pack("<IQ", 8, len(items))
                  + b"".join(s(x) for x in items))

    vocab = tok_spec["model"]["vocab"]
    tokens = sorted(vocab, key=vocab.get) + llama3_specials()
    types = [1] * len(vocab) + [3] * 256
    meta = [
        kv("general.architecture", 8, s("llama")),
        u32("llama.block_count", layers),
        u32("llama.embedding_length", cfg.hidden_size),
        u32("llama.feed_forward_length", cfg.intermediate_size),
        u32("llama.attention.head_count", cfg.num_heads),
        u32("llama.attention.head_count_kv", cfg.num_kv_heads),
        u32("llama.context_length", cfg.max_position_embeddings),
        f32("llama.rope.freq_base", cfg.rope_theta),
        f32("llama.attention.layer_norm_rms_epsilon", cfg.rms_norm_eps),
        kv("tokenizer.ggml.model", 8, s("gpt2")),
        kv("tokenizer.ggml.pre", 8, s("llama-bpe")),
        strs("tokenizer.ggml.tokens", tokens),
        kv("tokenizer.ggml.token_type", 9, st.pack("<IQ", 5, len(types))
           + np.asarray(types, "<i4").tobytes()),
        strs("tokenizer.ggml.merges",
             [f"{a} {b}" for a, b in tok_spec["model"]["merges"]]),
        u32("tokenizer.ggml.bos_token_id", 128000),
        u32("tokenizer.ggml.eos_token_id", 128009),
        kv("tokenizer.ggml.add_bos_token", 7, b"\x01"),
    ]
    gnames = {"model.embed_tokens.weight": "token_embd.weight",
              "model.norm.weight": "output_norm.weight",
              "lm_head.weight": "output.weight"}
    sub = {"self_attn.q_proj.weight": "attn_q.weight",
           "self_attn.k_proj.weight": "attn_k.weight",
           "self_attn.v_proj.weight": "attn_v.weight",
           "self_attn.o_proj.weight": "attn_output.weight",
           "mlp.gate_proj.weight": "ffn_gate.weight",
           "mlp.up_proj.weight": "ffn_up.weight",
           "mlp.down_proj.weight": "ffn_down.weight",
           "input_layernorm.weight": "attn_norm.weight",
           "post_attention_layernorm.weight": "ffn_norm.weight"}
    want, blobs, descs, off = {}, [], [], 0
    for name, _, fn in hf_layout(params, cfg, layers):
        w = fn()
        if name.startswith("model.layers."):
            _, _, l, rest = name.split(".", 3)
            gname = f"blk.{l}.{sub[rest]}"
        else:
            gname = gnames[name]
        if w.dim() == 1:
            data, dtype = w.float().cpu().numpy().tobytes(), 0   # F32
            want[name] = w.float()
        else:
            blocks, want[name] = q8_0(w)
            if "attn_q" in gname or "attn_k" in gname:
                heads = cfg.num_heads if "attn_q" in gname \
                    else cfg.num_kv_heads
                blocks = gguf_permute(blocks, heads)
            data, dtype = blocks.contiguous().cpu().numpy().tobytes(), 8
        descs.append((gname, list(reversed(w.shape)), dtype, off))
        blobs.append(data + b"\x00" * (-len(data) % 32))
        off += len(blobs[-1])
    with open(path, "wb") as f:
        f.write(b"GGUF" + st.pack("<IQQ", 3, len(descs), len(meta)))
        for m in meta:
            f.write(m)
        for gname, dims, dtype, o in descs:
            f.write(s(gname) + st.pack("<I", len(dims))
                    + b"".join(st.pack("<Q", x) for x in dims)
                    + st.pack("<IQ", dtype, o))
        f.write(b"\x00" * (-f.tell() % 32))
        for b in blobs:
            f.write(b)
    return want


def leaves_equal(got, want, prefix="") -> int:
    """The number of leaves, after checking every leaf of ``got``
    torch.equal to ``want``'s (the same keys, dtypes and shapes)."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"checkpoint: leaves {sorted(got)} != "
                                 f"{sorted(want)} under {prefix or 'root'}")
        return sum(leaves_equal(got[k], want[k], f"{prefix}{k}/")
                   for k in want)
    if (got.dtype != want.dtype or got.shape != want.shape
            or not torch.equal(got, want)):
        raise AssertionError(f"checkpoint: leaf {prefix} differs ({got.dtype}"
                             f" {tuple(got.shape)} against {want.dtype} "
                             f"{tuple(want.shape)})")
    return 1


async def ask_launcher(port, chat, prompt_ids, text_prompt):
    """One greedy chat streamed (usage included), one completions request
    on a text prompt and one on the chat's prompt ids, to the launcher's
    HTTP service: each one's (text, prompt tokens)."""
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.protocols.sse import SseDecoder

    common = {"model": "Llama-3.1-8B-random", "max_tokens": CKPT_NEW,
              "temperature": 0, "nvext": {"ignore_eos": True}}
    out = []
    async with HttpClient("127.0.0.1", port) as c:
        r = await c.request("POST", "/v1/chat/completions", json_body={
            **common, "messages": chat, "stream": True,
            "stream_options": {"include_usage": True}}, stream=True)
        if r.status != 200:
            raise AssertionError(f"checkpoint launcher: chat status "
                                 f"{r.status}")
        dec, events = SseDecoder(), []
        async for chunk in r.chunks():
            events.extend(dec.feed(chunk))
        if not events or not events[-1].is_done:
            raise AssertionError("checkpoint launcher: the chat stream did "
                                 "not end in [DONE]")
        text, usage = "", None
        for ev in events[:-1]:
            body = ev.json()
            usage = body.get("usage") or usage
            for ch in body["choices"]:
                text += ch["delta"].get("content") or ""
        out.append((text, usage["prompt_tokens"]))
        for prompt in (text_prompt, prompt_ids):
            r = await c.request("POST", "/v1/completions",
                                json_body={**common, "prompt": prompt})
            if r.status != 200:
                raise AssertionError(f"checkpoint launcher: completions "
                                     f"status {r.status}: {r.body[:300]!r}")
            body = r.json()
            out.append((body["choices"][0]["text"],
                        body["usage"]["prompt_tokens"]))
    return out


def check_checkpoint_launcher(d, params, smi):
    """``launch.run in=http out=torch --model-path DIR`` in a subprocess
    against build_chain's engine on the in-memory weights (the same
    flags, in this process): prompt ids and greedy texts must agree,
    request for request along the same path (the third request, the
    chat's ids as a completions prompt, is a prefix hit on the first's
    block in both: prefill numerics depend on the path, so it is held to
    the in-process chain's third request, and its text beside the chat's
    is information)."""
    import socket

    from dynamo_tpu_torch.launch.run import build_chain, build_parser
    from dynamo_tpu_torch.preprocessor import PromptFormatter
    from dynamo_tpu_torch.protocols.openai import (
        ChatCompletionRequest,
        CompletionRequest,
    )
    from dynamo_tpu_torch.tokenizer import HfTokenizer

    fmt, tok = PromptFormatter.from_dir(d), HfTokenizer.from_dir(d)
    chat_ids = tok.encode(fmt.render(CKPT_CHAT))
    text_prompt = open("README.md", encoding="utf-8").read()[:300]
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    proc = Proc("dynamo_tpu_torch.launch.run", "in=http", "out=torch",
                "--model-path", d, "--http-host", "127.0.0.1",
                "--http-port", str(port))
    try:
        proc.wait_for(f"http://127.0.0.1:{port}", timeout=600)
        ready_s = time.monotonic() - t0
        answers = asyncio.run(asyncio.wait_for(ask_launcher(
            port, CKPT_CHAT, chat_ids, text_prompt), 300))
    finally:
        rc = proc.stop()
    if rc not in (0, -15):
        raise AssertionError(f"checkpoint launcher exited {rc}:\n"
                             + "\n".join(proc.lines[-20:]))
    args = build_parser().parse_intermixed_args(
        ["in=http", "out=torch", "--model-path", d])
    _, chain = build_chain(args, params=params)
    try:
        common = {"model": chain.name, "max_tokens": CKPT_NEW,
                  "temperature": 0, "nvext": {"ignore_eos": True}}
        pre_chat = chain.preprocessor.preprocess_chat(
            ChatCompletionRequest.from_dict({**common,
                                             "messages": CKPT_CHAT}))
        pre_text = chain.preprocessor.preprocess_completion(
            CompletionRequest.from_dict({**common, "prompt": text_prompt}))
        pre_ids = chain.preprocessor.preprocess_completion(
            CompletionRequest.from_dict({**common, "prompt": chat_ids}))
        if pre_chat.token_ids != chat_ids:
            raise AssertionError("checkpoint: build_chain's chat prompt ids "
                                 "differ from PromptFormatter + HfTokenizer")
        if pre_text.token_ids != tok.encode(text_prompt):
            raise AssertionError("checkpoint: build_chain's completion ids "
                                 "differ from HfTokenizer's")

        async def through_chain():
            texts = []
            # one at a time, as sent
            for pre in (pre_chat, pre_text, pre_ids):
                parts = []
                async for out in chain.generate(pre):
                    parts.append(out.text or "")
                texts.append("".join(parts))
            await chain.engine.stop()
            return texts

        gen = asyncio.run(through_chain())
    finally:
        del chain
        gc.collect()
        torch.cuda.empty_cache()
    texts = [t for t, _ in answers]
    usage = [n for _, n in answers]
    if usage != [len(chat_ids), len(pre_text.token_ids), len(chat_ids)]:
        raise AssertionError(f"checkpoint launcher: prompt tokens {usage}, "
                             f"in process {len(chat_ids)}, "
                             f"{len(pre_text.token_ids)}")
    if texts != gen:
        raise AssertionError(f"checkpoint launcher: texts {texts!r} != "
                             f"the in-process chain's {gen!r}")
    log(f"checkpoint launcher: launch.run in=http out=torch --model-path "
        f"{d} ready in {ready_s:.1f} s (start to listening, the load "
        f"included, with the GGUF launcher loading beside it; {smi}); chat prompt {len(chat_ids)} ids, completion "
        f"{len(pre_text.token_ids)} ids, both equal to PromptFormatter + "
        f"HfTokenizer in process (prompt_tokens, and the chat's ids as a "
        f"completions prompt gave the chat's text); the chat streamed; "
        f"greedy texts equal to "
        f"build_chain's chain (preprocess, generate() in its engine on the "
        f"in-memory weights, detokenize; {CKPT_NEW} tokens each): "
        f"{texts[0][:60]!r}...; the chat's ids as a completions prompt "
        f"(a prefix hit) gave the chat's text: {gen[2] == gen[0]} "
        f"(information)")
    return ready_s


def check_checkpoint(params, smi):
    """The checkpoint phase (module docstring, 6b). Returns the (dense,
    int8) flash-decode launches of the bursts served from the loaded
    weights."""
    import shutil
    import tempfile
    from dataclasses import replace

    from dynamo_tpu_torch.gguf import config_from_gguf, load_gguf_params
    from dynamo_tpu_torch.gguf import read_gguf as read_gguf_file
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.preprocessor import PromptFormatter
    from dynamo_tpu_torch.tokenizer import HfTokenizer

    full = params
    cfg = ModelConfig.llama3_8b(num_layers=CUT_LAYERS)
    params = first_layers(params, CUT_LAYERS)
    wbytes = int(weights_gib(params) * 2**30)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    d = os.path.join(root, "Llama-3.1-8B-random")
    gguf_path = os.path.join(root, "Llama-3.1-8B-random-2layer.Q8_0.gguf")
    try:
        free = shutil.disk_usage(root).free
        need = wbytes + 3 * 2**30   # the shards, the GGUF, headroom
        log(f"checkpoint: writing to {d} ({free / 1e9:.1f} GB free there, "
            f"{need / 1e9:.1f} GB needed)")
        if free < need:
            raise AssertionError(f"checkpoint: {free / 1e9:.1f} GB free in "
                                 f"{root}, the checkpoint needs "
                                 f"{need / 1e9:.1f} GB")
        t0 = time.monotonic()
        readme = open("README.md", encoding="utf-8").read()
        spec = llama3_tokenizer_json(readme)
        t_tok = time.monotonic() - t0
        t0 = time.monotonic()
        total, nshards = write_hf_checkpoint(d, params, cfg, spec)
        t_write = time.monotonic() - t0
        log(f"checkpoint: tokenizer.json ({len(spec['model']['merges'])} "
            f"merges from README.md, vocab 128000 + 256 specials) in "
            f"{t_tok:.1f} s; {total / 1e9:.2f} GB of bf16 weights in "
            f"{nshards} shards written in {t_write:.1f} s")
        # load
        lcfg = ModelConfig.from_pretrained(d)
        want_cfg = ModelConfig.llama3_8b(
            num_layers=CUT_LAYERS,
            rope_scaling=tuple(sorted(LLAMA31_ROPE.items())))
        if lcfg != want_cfg:
            raise AssertionError(f"checkpoint: from_pretrained gave {lcfg}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        loaded = llama.load_hf_params(lcfg, d, device="cuda")
        torch.cuda.synchronize()
        t_load = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() - base
        n = leaves_equal(loaded, params)
        if peak >= 2 * wbytes:
            raise AssertionError(f"checkpoint: the load peaked at "
                                 f"{peak / 2**30:.2f} GiB over its start, "
                                 f"two copies of the weights are "
                                 f"{2 * wbytes / 2**30:.2f} GiB")
        load = (f"load {t_load:.2f} s = {total / t_load / 1e9:.2f} GB/s "
                f"(page cache warm), peak +{peak / 2**30:.2f} GiB over "
                f"{wbytes / 2**30:.2f} GiB of weights")
        log(f"checkpoint: load_hf_params {load}; {n} leaves torch.equal "
            f"to the in-memory weights; from_pretrained == Llama-3.1-8B at "
            f"{CUT_LAYERS} layers "
            f"with the written rope_scaling ({smi})")
        # serve from the loaded weights, held to the in-memory ones
        launches, same = {}, []
        for kv in ("none", "int8"):
            name = "flash_decode_int8" if kv == "int8" else "flash_decode"
            c_ld, c_mem = {}, {}
            got, _ = serve_llama3_8b(c_ld, loaded, kv, cfg=lcfg,
                                     tag=f"checkpoint {kv}")
            want, _ = serve_llama3_8b(c_mem, params, kv, cfg=lcfg,
                                      tag=f"checkpoint {kv} in-memory")
            if got != want:
                split = [next((j for j, (a, b) in enumerate(zip(x, y))
                               if a != b), None) for x, y in zip(got, want)]
                raise AssertionError(f"checkpoint {kv}: the loaded weights' "
                                     f"streams differ from the in-memory "
                                     f"ones' at steps {split}")
            launches[kv] = c_ld[name]
            same.append(f"{kv} {sum(map(len, got))}/{sum(map(len, want))}")
        del loaded
        gc.collect()
        torch.cuda.empty_cache()
        # quantized at load
        t0 = time.monotonic()
        q = llama.load_hf_params(replace(lcfg, quant="int8"), d,
                                 device="cuda")
        torch.cuda.synchronize()
        t_q = time.monotonic() - t0
        nq = leaves_equal(q, llama.quantize_params(params))
        del q
        gc.collect()
        torch.cuda.empty_cache()
        log(f"checkpoint: --quantize int8 at load in {t_q:.2f} s: {nq} "
            f"leaves bit-equal to quantize_params of the in-memory weights")
        # the host: encode and render
        tok, fmt = HfTokenizer.from_dir(d), PromptFormatter.from_dir(d)
        text = readme[:1000]
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            ids = tok.encode(text)
        enc_us = (time.perf_counter() - t0) / reps * 1e6
        t0 = time.perf_counter()
        for _ in range(reps):
            fmt.render(CKPT_CHAT)
        render_us = (time.perf_counter() - t0) / reps * 1e6
        if tok.decode(ids) != text:
            raise AssertionError("checkpoint: the tokenizer does not round "
                                 "trip README.md")
        log(f"checkpoint: host: encode 1,000 characters ({len(ids)} ids) "
            f"{enc_us:.0f} us, render one chat {render_us:.0f} us "
            f"(information; host CPU of {smi})")
        # GGUF at full width, GGUF_LAYERS layers: its file first, so that
        # its launcher (in=text) runs beside the HF directory's (in=http)
        t0 = time.monotonic()
        expect = write_gguf(gguf_path, full, cfg, spec, GGUF_LAYERS)
        t_gw = time.monotonic() - t0
        t0 = time.monotonic()
        # its output to files: a pipe nobody reads while the other
        # launcher is checked could fill and stall it
        g_files = [open(os.path.join(root, f"gguf.{x}"), "w+")
                   for x in ("out", "err")]
        gguf_proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=text",
             "out=torch", "--model-path", gguf_path, "--prompt",
             "What is a GGUF file?", "--max-tokens", "8"],
            stdout=g_files[0], stderr=g_files[1], text=True)
        try:
            ready_s = check_checkpoint_launcher(d, params, smi)
            md, _ = read_gguf_file(gguf_path)
            gcfg = config_from_gguf(md)
            # the file stores rms_norm_eps as an f32
            if gcfg != ModelConfig.llama3_8b(
                    num_layers=GGUF_LAYERS,
                    rms_norm_eps=float(np.float32(cfg.rms_norm_eps))):
                raise AssertionError(f"checkpoint gguf: config {gcfg}")
            t1 = time.monotonic()
            gp = load_gguf_params(gcfg, gguf_path, device="cuda")
            torch.cuda.synchronize()
            t_gl = time.monotonic() - t1
            bf = torch.bfloat16
            want_gp = {
                "embed": expect["model.embed_tokens.weight"].to(bf),
                "norm_f": expect["model.norm.weight"].to(bf),
                "lm_head": expect["lm_head.weight"].to(bf).T,
                "layers": {ours: torch.stack([
                    (expect[f"model.layers.{l}.{suffix}"].to(bf).T if tr
                     else expect[f"model.layers.{l}.{suffix}"].to(bf))
                    for l in range(GGUF_LAYERS)])
                    for suffix, (ours, tr) in llama._HF_LAYER_MAP.items()}}
            ng = leaves_equal(gp, want_gp)
            del gp, want_gp, expect
            gc.collect()
            torch.cuda.empty_cache()
            gguf_proc.wait(timeout=600)
            t_gs = time.monotonic() - t0
        finally:
            if gguf_proc.poll() is None:
                gguf_proc.kill()
                gguf_proc.wait()
            g_out, g_err = [f.seek(0) or f.read() for f in g_files]
            for f in g_files:
                f.close()
        if gguf_proc.returncode != 0 or "on cuda" not in g_err:
            raise AssertionError(f"checkpoint gguf: launch.run exited "
                                 f"{gguf_proc.returncode}\n{g_err[-3000:]}")
        gsize = os.path.getsize(gguf_path)
        log(f"checkpoint gguf: {GGUF_LAYERS} of 32 layers (reduced depth: "
            f"Q8_0 packing on the host), full width: {gsize / 1e9:.2f} GB "
            f"written in {t_gw:.1f} s; load_gguf_params in {t_gl:.1f} s: "
            f"{ng} leaves equal to the Q8_0 formula q * f16(d) computed "
            f"here; launch.run in=text --model-path FILE.gguf on cuda, "
            f"started beside the in=http launcher, done in {t_gs:.1f} s, "
            f"printed {g_out.strip()[:60]!r}")
        figures(f"{total / 1e9:.1f} GB, {nshards} shards, load "
                f"{t_load:.1f} s {total / t_load / 1e9:.2f} GB/s (warm) peak "
                f"+{peak / 2**30:.1f} GiB, {n} leaves eq; bursts eq "
                f"{', '.join(same)}; q8 {nq} eq; launcher ready "
                f"{ready_s:.0f} s; gguf {GGUF_LAYERS}L {ng} eq; encode 1k "
                f"{enc_us:.0f} us, chat {render_us:.0f} us")
        return launches["none"], launches["int8"]
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# Multimodal prompts and the encoder pass at Llama-3.1-8B's width

# a placeholder id inside Llama 3's reserved special tokens
MM_IMAGE_TOKEN = 128011
MM_NEW = 16          # tokens an image request decodes
# bf16 tower against its plain f32 version (same weights, same image):
# the relative L2 bound, predicted before the first run on the card
TOWER_REL_L2 = 3e-2
# TorchEngine.embed (bf16) against the plain f32 encoder: the cosine
# bound, predicted before the first run on the card
EMBED_COS = 0.999
# the same input padded to two widths
EMBED_PAD_COS = 0.9999
EMBED_LENS = (8, 512, 4096)


def mm_image(vcfg, seed):
    return np.random.RandomState(seed).rand(
        vcfg.image_size, vcfg.image_size, 3).astype(np.float32)


def mm_head_tail(vocab):
    """The image request's text: 4 tokens before the placeholders and 3
    after, from the seed."""
    rng = np.random.RandomState(SEED + 22)
    toks = rng.randint(3, vocab - 256, size=7).tolist()
    return toks[:4], toks[4:]


def mm_request(head, tail, images, vcfg, n_new=MM_NEW):
    """A request whose prompt is ``head``, a run of num_patches
    placeholders per image, then ``tail``; greedy, top-2 logprobs."""
    from dynamo_tpu_torch.multimodal import encode_image_payload
    from dynamo_tpu_torch.protocols.common import (
        OutputOptions,
        PreprocessedRequest,
        StopConditions,
    )

    toks, ims = list(head), []
    for img in images:
        ims.append(dict(encode_image_payload(img), pos=len(toks)))
        toks += [MM_IMAGE_TOKEN] * vcfg.num_patches
    toks += list(tail)
    return PreprocessedRequest(
        token_ids=toks,
        stop_conditions=StopConditions(max_tokens=n_new, ignore_eos=True),
        output_options=OutputOptions(logprobs=2),
        multimodal={"images": ims} if ims else None)


async def mm_run(engine, req):
    """One request's tokens, top-2 logprobs, finish, final annotations
    and client-side TTFT (call to first token)."""
    t0 = time.monotonic()
    out = dict(toks=[], top=[], finish=None, ann={}, ttft=None)
    async for o in engine.generate(req):
        if o.token_ids and out["ttft"] is None:
            out["ttft"] = time.monotonic() - t0
        out["toks"].extend(o.token_ids)
        out["top"].extend(o.top_logprobs or [])
        if o.finish_reason is not None:
            out["finish"], out["ann"] = o.finish_reason.value, o.annotations
    if len(out["toks"]) != req.stop_conditions.max_tokens \
            or out["finish"] != "length":
        raise AssertionError(f"request ended with {len(out['toks'])} "
                             f"tokens, finish {out['finish']}")
    return out


def hold_near_tie(label, got, want):
    """``got``'s stream against ``want``'s: equal, or parting at a step
    where ``want``'s top-2 logprob gap is at most NEAR_TIE. Returns None
    or (step, gap)."""
    j = next((j for j, (a, b) in enumerate(zip(got["toks"], want["toks"]))
              if a != b), None)
    if j is None:
        return None
    gap = want["top"][j][0][1] - want["top"][j][1][1]
    if gap > NEAR_TIE:
        raise AssertionError(f"{label}: {got['toks'][j]} for "
                             f"{want['toks'][j]} at step {j}, where the "
                             f"top-2 gap is {gap:.4f} > {NEAR_TIE}")
    return j, round(gap, 4)


def tower_rel_l2(vcfg, params, ref, image):
    from dynamo_tpu_torch.models.vision import encode_image

    got = encode_image(vcfg, params, image).float()
    return float((got - ref).norm() / ref.norm())


def direct_first_token(cfg, params, req, rows, width, ctx_len, device):
    """The image request's first greedy token from llama.prefill with the
    image rows as ``embeds`` (one chunk of ``width``, a fresh region of
    ``ctx_len``): (argmax, top-2 logprob gap)."""
    from dynamo_tpu_torch.models import llama

    n = len(req.token_ids)
    toks = torch.zeros(width, dtype=torch.long)
    toks[:n] = torch.tensor(req.token_ids)
    ov = torch.zeros(width, cfg.hidden_size)
    msk = torch.zeros(width, dtype=torch.bool)
    for im, r in zip(req.multimodal["images"], rows):
        ov[im["pos"]: im["pos"] + len(r)] = r
        msk[im["pos"]: im["pos"] + len(r)] = True
    ctx = llama.init_ctx(cfg, 1, ctx_len, torch.bfloat16, device)
    logits = llama.prefill(cfg, params, ctx, toks.to(device), 0, 0, n,
                           embeds=ov.to(device),
                           embeds_mask=msk.to(device))
    lp = torch.log_softmax(logits.float(), -1).topk(2)
    del ctx
    return int(lp.indices[0]), float(lp.values[0] - lp.values[1])


def check_multimodal(params, smi, device="cuda"):
    """Image prompts at full width: CLIP ViT-L/14 at 224 (VisionConfig()'s
    defaults: 24 layers, hidden 1024, 256 patches, projected to 4096),
    random bf16 weights from the seed, feeding Llama-3.1-8B (the serve
    weights, 32 layers) through MultimodalEngine(TorchEngine) with a local
    EncodeWorker. Checks: the bf16 tower within TOWER_REL_L2 of its plain
    f32 version (the same weights upcast, the same image), and a control
    that must fail it (one layer's wo zeroed; one layer's wq row zeroed
    is printed too, as information); the image request (4 text tokens,
    256 placeholders, 3 text tokens) gives as its first token the argmax
    of llama.prefill with the rows as ``embeds``, up to a near-tie; its
    stream alone and inside a gated burst of 8 (two images, six serve
    prompts) are equal up to a near-tie; a second image with the same
    placeholder tokens adds no prefix hit and the same image again hits
    every matchable block; served over the port's runtime through an
    EncodeWorker whose rows ride array frames it is token-identical to
    the in-process encoder's; with int8 KV its first token is the
    direct argmax up to a near-tie. The flash-decode kernel of each mode
    ran on every layer of every decode step (the kernels line's
    launches_multimodal). Prints the tower's ms (bf16, plain), the image
    request's TTFT beside a text request's of the same length, and the
    array frame's GB/s for the rows. ``device="cpu"`` rehearses the
    phase on the CPU (with the card's calls stubbed)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.kv_transfer import ArrayFrameServer, take_remote_array
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.vision import (
        VisionConfig,
        encode_image,
        init_vision_params,
    )
    from dynamo_tpu_torch.multimodal import EncodeWorker, MultimodalEngine
    from dynamo_tpu_torch.ops import flash_decode as fd
    from dynamo_tpu_torch.protocols.common import PreprocessedRequest
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.store import serve_store

    cfg = ModelConfig.llama3_8b()
    L = cfg.num_layers
    vcfg = VisionConfig()
    vparams = init_vision_params(vcfg, SEED, dtype=torch.bfloat16,
                                 device=device)
    plain = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict)
                 else v.float()) for k, v in vparams.items()}
    images = [mm_image(vcfg, SEED + i) for i in range(4)]   # A, B, C, D
    # 1. the tower: bf16 against plain f32, the controls, the times
    with torch.no_grad():
        ref = encode_image(vcfg, plain, images[0])
        rel = tower_rel_l2(vcfg, vparams, ref, images[0])
        ctl_layers = dict(vparams["layers"])
        ctl_layers["wo"] = vparams["layers"]["wo"].clone()
        ctl_layers["wo"][vcfg.num_layers // 2].zero_()
        rel_wo = tower_rel_l2(vcfg, {**vparams, "layers": ctl_layers}, ref,
                              images[0])
        ctl_layers["wo"] = vparams["layers"]["wo"]
        ctl_layers["wq"] = vparams["layers"]["wq"].clone()
        ctl_layers["wq"][vcfg.num_layers // 2, 0].zero_()
        rel_wq = tower_rel_l2(vcfg, {**vparams, "layers": ctl_layers}, ref,
                              images[0])
        del ctl_layers
        img_dev = torch.from_numpy(images[0]).to(device)
        ms = {}
        for name, p in (("bf16", vparams), ("plain", plain)):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            encode_image(vcfg, p, img_dev)
            ev[0].record()
            for _ in range(5):
                encode_image(vcfg, p, img_dev)
            ev[1].record()
            torch.cuda.synchronize()
            ms[name] = ev[0].elapsed_time(ev[1]) / 5
    del plain, ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"multimodal: tower (ViT-L/14 224, {vcfg.num_layers} layers, "
        f"{vcfg.num_patches} patches -> {vcfg.out_hidden_size}) bf16 vs "
        f"plain f32 relative L2 {rel:.3e} (bound {TOWER_REL_L2}); control "
        f"layer {vcfg.num_layers // 2} wo zeroed {rel_wo:.3e}; layer "
        f"{vcfg.num_layers // 2} wq row 0 zeroed {rel_wq:.3e} "
        f"(information); encode {ms['bf16']:.2f} ms an image bf16, "
        f"{ms['plain']:.2f} ms plain f32 ({smi})")
    if not rel < TOWER_REL_L2:
        raise AssertionError(f"multimodal: the bf16 tower is {rel:.3e} "
                             f"from its plain version (bound "
                             f"{TOWER_REL_L2})")
    if not rel_wo > TOWER_REL_L2:
        raise AssertionError(f"multimodal: the control (wo zeroed) passed "
                             f"the tower check: {rel_wo:.3e}")

    head, tail = mm_head_tail(cfg.vocab_size)
    req_a = mm_request(head, tail, [images[0]], vcfg)
    n_prompt = len(req_a.token_ids)
    enc = EncodeWorker(None, vcfg, vparams)
    rows_a = asyncio.run(enc.encode_arrays(req_a.multimodal["images"]))
    rng = np.random.RandomState(SEED + 23)
    texts = [PreprocessedRequest(
        token_ids=rng.randint(3, cfg.vocab_size - 256,
                              size=n_prompt).tolist(),
        stop_conditions=req_a.stop_conditions,
        output_options=req_a.output_options) for _ in range(2)]
    prompts = serve_prompts(cfg.vocab_size)
    burst_reqs = [mm_request(head, tail, [images[0]], vcfg)] + [
        PreprocessedRequest(token_ids=list(p),
                            stop_conditions=req_a.stop_conditions,
                            output_options=req_a.output_options)
        for p in prompts[:6]]
    burst_reqs.insert(4, mm_request(head, tail, [images[1]], vcfg))

    def build(kv_quant):
        eng = TorchEngine(cfg, EngineConfig(kv_quant=kv_quant),
                          params=params, device=device)
        torch.cuda.synchronize()
        return eng

    eng = build("none")
    width = eng._chunk_width(n_prompt)
    first, gap = direct_first_token(cfg, params, req_a, rows_a, width,
                                    eng.ecfg.max_context, device)
    mm = MultimodalEngine(eng, local_encoder=enc)
    steps0 = eng.step_count
    fd.executed(eng.device, reset=True)
    figs: dict = {}

    async def drive():
        await mm_run(eng, texts[0])             # warms the 512-wide prefill
        alone = await mm_run(mm, req_a)
        text = await mm_run(eng, texts[1])
        eng.clear_kv_blocks()
        IntakeGate(eng, len(burst_reqs))
        burst = await asyncio.gather(*[mm_run(mm, r) for r in burst_reqs])
        await settle_engines(eng)
        hits0 = eng.allocator.hit_blocks
        await mm_run(mm, mm_request(head, tail, [images[2]], vcfg))
        hits_other = eng.allocator.hit_blocks - hits0
        again = await mm_run(mm, req_a)
        hits_again = eng.allocator.hit_blocks - hits0 - hits_other
        # over the runtime: the rows as array frames
        eng.clear_kv_blocks()
        server, _ = await serve_store(port=0, sweep_interval_s=0.05)
        port = server.sockets[0].getsockname()[1]
        rt_enc = await DistributedRuntime.connect(port=port)
        rt_dec = await DistributedRuntime.connect(port=port)
        worker = await EncodeWorker(rt_enc, vcfg, vparams,
                                    namespace="mm").start()
        remote = MultimodalEngine(eng, rt=rt_dec, namespace="mm")
        try:
            over = await mm_run(remote, req_a)
            served = worker.images_encoded
        finally:
            await worker.stop()
            await rt_dec.close()
            await rt_enc.close()
            server.close()
        await settle_engines(eng)
        # the array frame alone: the 256 x 4096 f32 rows, loopback
        frames = ArrayFrameServer(host="127.0.0.1")
        await frames.start()
        try:
            secs = []
            for _ in range(6):
                t = frames.park(rows_a[0])
                t0 = time.perf_counter()
                got = await take_remote_array(frames.host, frames.port, t)
                secs.append(time.perf_counter() - t0)
            if not torch.equal(got, rows_a[0]):
                raise AssertionError("multimodal: the array frame changed "
                                     "the rows")
        finally:
            await frames.stop()
        figs["frame_gbs"] = rows_a[0].numel() * 4 / np.median(secs[1:]) / 1e9
        ran = fd.executed(eng.device)
        steps = eng.step_count - steps0
        await eng.stop()   # its loop thread would keep it alive
        return (alone, text, burst, hits_other, hits_again, again, over,
                served, ran, steps)

    (alone, text, burst, hits_other, hits_again, again, over, served, ran,
     steps) = asyncio.run(drive())
    check_replayed(eng, "multimodal")
    if ran[0] != L * steps or ran[1]:
        raise AssertionError(f"multimodal: flash_decode ran {ran} times on "
                             f"the card over {steps} decode steps of {L} "
                             f"layers")
    launches = {"none": ran[0]}
    if alone["toks"][0] != first and gap > NEAR_TIE:
        raise AssertionError(
            f"multimodal: the engine's first token {alone['toks'][0]} is "
            f"not the direct prefill's argmax {first} (top-2 gap "
            f"{gap:.4f} > {NEAR_TIE})")
    in_burst = hold_near_tie("multimodal burst", burst[0], alone)
    again_split = hold_near_tie("multimodal repeat", again, alone)
    want_hits = (n_prompt - 1) // eng.ecfg.page_size
    if hits_other or hits_again != want_hits:
        raise AssertionError(
            f"multimodal: another image with the same placeholders hit "
            f"{hits_other} blocks (want 0), the same image again "
            f"{hits_again} (want {want_hits})")
    if over["toks"] != alone["toks"] or served != 1:
        raise AssertionError(
            f"multimodal: over the runtime ({served} images encoded) "
            f"{over['toks']} != in process {alone['toks']}")
    e_ttft = alone["ann"]["timing"]["ttft_s"]
    log(f"multimodal: image request ({n_prompt} tokens, {width}-wide "
        f"prefill) first token {alone['toks'][0]} (direct prefill argmax "
        f"{first}, top-2 gap {gap:.4f}); TTFT {alone['ttft']:.4f} s from "
        f"the call (encode included), {e_ttft:.4f} s in the engine; a text "
        f"request of {n_prompt} tokens {text['ttft']:.4f} s; in the burst "
        f"of 8 (2 images) {'equal' if in_burst is None else in_burst}; "
        f"repeat (prefix hit {hits_again} blocks) "
        f"{'equal' if again_split is None else again_split}; another "
        f"image {hits_other} hits; over the runtime equal; array frame "
        f"{figs['frame_gbs']:.2f} GB/s for {tuple(rows_a[0].shape)} f32 "
        f"rows; flash_decode {ran[0]} = {L} x {steps} steps ({smi})")
    del mm, eng
    gc.collect()
    torch.cuda.empty_cache()
    # int8 KV: one image request
    eng = build("int8")
    mm = MultimodalEngine(eng, local_encoder=enc)
    steps0 = eng.step_count
    fd.executed(eng.device, reset=True)

    async def drive8():
        out = await mm_run(mm, req_a)
        await settle_engines(eng)
        ran, steps = fd.executed(eng.device), eng.step_count - steps0
        await eng.stop()
        return out, ran, steps

    q8, ran, steps = asyncio.run(drive8())
    check_replayed(eng, "multimodal int8")
    if ran[1] != L * steps or ran[0]:
        raise AssertionError(f"multimodal int8: flash_decode ran {ran} "
                             f"times over {steps} decode steps")
    launches["int8"] = ran[1]
    if q8["toks"][0] != first and gap > NEAR_TIE:
        raise AssertionError(
            f"multimodal int8: first token {q8['toks'][0]} is not the "
            f"direct prefill's argmax {first} (top-2 gap {gap:.4f})")
    split = next((j for j, (a, b) in enumerate(zip(q8["toks"],
                                                   alone["toks"]))
                  if a != b), None)
    log(f"multimodal int8: first token {q8['toks'][0]} (direct argmax "
        f"{first}); the stream leaves the dense one at step "
        f"{split if split is not None else 'never'} (information); "
        f"flash_decode_int8 {ran[1]} = {L} x {steps} steps")
    figures(f"tower rel L2 {rel:.2e} (ctl {rel_wo:.2e}), {ms['bf16']:.2f}/"
            f"{ms['plain']:.2f} ms; TTFT image {alone['ttft']:.4f} s text "
            f"{text['ttft']:.4f} s; burst "
            f"{'eq' if in_burst is None else in_burst}; hits other "
            f"{hits_other} same {hits_again}; runtime eq; frame "
            f"{figs['frame_gbs']:.2f} GB/s; int8 first ok; launches "
            f"{launches['none']}/{launches['int8']}")
    del mm, eng, enc, vparams
    gc.collect()
    torch.cuda.empty_cache()
    return launches["none"], launches["int8"]


class _F32Layers:
    """A stacked layer leaf read one layer at a time in f32: the plain
    encoder's weights without an f32 copy of the whole model."""

    def __init__(self, t):
        self.t = t

    def __getitem__(self, l):
        return self.t[l].float()


def check_embeddings(params, smi, device="cuda"):
    """The encoder pass at Llama-3.1-8B's width (the serve weights, 32
    layers), through launch.run's chain (default EngineConfig):
    TorchEngine.embed on inputs of EMBED_LENS tokens against the plain
    f32 encoder on the card (llama.encode over f32 weights, upcast a layer
    at a time): cosine >= EMBED_COS, and a control that must fail it (one
    layer's wo zeroed); the same input padded to two widths within
    EMBED_PAD_COS; the serve burst gated at the intake, then again with
    two threads calling embed() throughout, token-identical; then
    /v1/embeddings and /v1/responses over HTTP on the same engine, unary
    and streamed (the vector equal to embed()'s, the Responses API's
    events in order, status incomplete on max_output_tokens). Prints ms
    an input at each length, the peak allocation of an embed at
    max_context beside what the engine leaves free, and the burst's
    tok/s with and without the embed calls. ``device="cpu"`` rehearses
    the phase on the CPU (with the card's calls stubbed)."""
    from dynamo_tpu_torch.frontend.http import HttpClient
    from dynamo_tpu_torch.frontend.model_manager import ModelManager
    from dynamo_tpu_torch.frontend.service import HttpService
    from dynamo_tpu_torch.launch import run as launch
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.protocols.sse import SseDecoder
    from dynamo_tpu_torch.tokenizer import make_test_tokenizer

    cfg = ModelConfig.llama3_8b()
    tok = make_test_tokenizer([f"t{i}" for i in range(3, cfg.vocab_size)])
    args = launch.build_parser().parse_intermixed_args(
        ["in=http", "out=torch", "--model-config", "llama3_8b",
         "--model-name", "llama3_8b"]
        + (["--device", "cpu"] if device == "cpu" else []))
    _, chain = launch.build_chain(args, params=params, tokenizer=tok)
    eng = chain.engine
    torch.cuda.synchronize()
    rng = np.random.RandomState(SEED + 24)
    inputs = {n: rng.randint(3, cfg.vocab_size, size=n).tolist()
              for n in EMBED_LENS}
    plain_cfg = dataclasses.replace(cfg, dtype="float32")
    # the embedding rows are gathered from the bf16 table and widened
    plain = {"embed": params["embed"], "norm_f": params["norm_f"].float(),
             "layers": {k: _F32Layers(v)
                        for k, v in params["layers"].items()}}
    mid = cfg.num_layers // 2
    wo = params["layers"]["wo"].clone()
    wo[mid].zero_()
    control = {**params, "layers": {**params["layers"], "wo": wo}}

    def cos(a, b):
        return float(torch.dot(a, b) / (a.norm() * b.norm()))

    res, ms = {}, {}
    with torch.no_grad():
        for n, ids in inputs.items():
            got = torch.tensor(eng.embed(ids))
            secs = []
            for _ in range(3):
                t0 = time.perf_counter()
                eng.embed(ids)
                secs.append(time.perf_counter() - t0)
            ms[n] = float(np.median(secs)) * 1e3
            T = max(8, 1 << (n - 1).bit_length())
            toks = torch.zeros(T, dtype=torch.long, device=device)
            toks[:n] = torch.tensor(ids)
            want = llama.encode(plain_cfg, plain, toks, n).cpu()
            ctl = llama.encode(cfg, control, toks, n).float().cpu()
            res[n] = (cos(got, want), cos(ctl, want))
        # padding invariance: 500 tokens padded to 512 and to 1024
        ids = inputs[512][:500]
        pads = []
        for T in (512, 1024):
            toks = torch.zeros(T, dtype=torch.long, device=device)
            toks[:500] = torch.tensor(ids)
            pads.append(llama.encode(cfg, params, toks, 500).float().cpu())
        pad_cos = cos(*pads)
        # the peak of an embed at max_context beside what the engine
        # leaves free
        torch.cuda.synchronize()
        free = torch.cuda.mem_get_info()[0]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng.embed(rng.randint(3, cfg.vocab_size,
                              size=eng.ecfg.max_context).tolist())
        peak = torch.cuda.max_memory_allocated() - base
    del plain, control, wo
    gc.collect()
    torch.cuda.empty_cache()
    log(f"embeddings: TorchEngine.embed (bf16) vs the plain f32 encoder, "
        f"cosine " + ", ".join(f"{n} tokens {c:.6f} (control wo[{mid}] "
                               f"zeroed {k:.4f})" for n, (c, k) in res.items())
        + f" (bound {EMBED_COS}); padded 512 vs 1024 {pad_cos:.7f} (bound "
        f"{EMBED_PAD_COS}); ms an input " + ", ".join(
            f"{n}: {m:.1f}" for n, m in ms.items())
        + f"; peak at max_context {eng.ecfg.max_context}: "
          f"{peak / 2**30:.2f} GiB, free beside the engine "
          f"{free / 2**30:.1f} GiB ({smi})")
    for n, (c, k) in res.items():
        if not c >= EMBED_COS:
            raise AssertionError(f"embeddings: {n} tokens, cosine {c:.6f} "
                                 f"< {EMBED_COS}")
        if not k < EMBED_COS:
            raise AssertionError(f"embeddings: the control passed at {n} "
                                 f"tokens: cosine {k:.6f}")
    if not pad_cos >= EMBED_PAD_COS:
        raise AssertionError(f"embeddings: padded 512 vs 1024 cosine "
                             f"{pad_cos:.7f}")
    if peak >= free:
        raise AssertionError(f"embeddings: an embed at max_context peaks "
                             f"at {peak / 2**30:.2f} GiB, more than the "
                             f"{free / 2**30:.1f} GiB free")

    prompts = serve_prompts(cfg.vocab_size)

    def tps(out):
        ttft = [a["timing"]["ttft_s"] for _, _, a, *_ in out]
        e2e = [a["timing"]["e2e_s"] for _, _, a, *_ in out]
        return sum(len(t) - 1 for t, *_ in out) / (max(e2e) - min(ttft))

    def burst():
        eng.clear_kv_blocks()
        IntakeGate(eng, len(prompts))
        return asyncio.run(generate_all(eng, prompts, 32))

    quiet = burst()
    stop, calls = threading.Event(), [0, 0]

    def hammer(i):
        ids = inputs[512]
        while not stop.is_set():
            eng.embed(ids)
            calls[i] += 1

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    try:
        busy = burst()
    finally:
        stop.set()
        for t in threads:
            t.join()
    if [t for t, *_ in busy] != [t for t, *_ in quiet]:
        raise AssertionError("embeddings: the burst's tokens moved with "
                             "concurrent embed calls")
    if not all(calls):
        raise AssertionError(f"embeddings: the embed threads ran {calls}")

    # over HTTP, on the same engine
    manager = ModelManager()
    manager.register(chain)
    words = " ".join(f"t{i}" for i in inputs[8])
    dims = min(256, cfg.hidden_size // 2)
    http: dict = {}

    async def drive():
        svc = HttpService(manager, host="127.0.0.1", port=0)
        await svc.start()
        try:
            async with HttpClient("127.0.0.1", svc.port) as c:
                r = await c.request("POST", "/v1/embeddings", json_body={
                    "model": "llama3_8b", "input": [words, words]})
                http["emb"] = (r.status, r.json())
                r = await c.request("POST", "/v1/embeddings", json_body={
                    "model": "llama3_8b", "input": inputs[8]})
                http["ids"] = (r.status, r.json())
                r = await c.request("POST", "/v1/embeddings", json_body={
                    "model": "llama3_8b", "input": words,
                    "encoding_format": "base64", "dimensions": dims})
                http["emb64"] = (r.status, r.json())
                r = await c.request("POST", "/v1/responses", json_body={
                    "model": "llama3_8b", "input": words,
                    "instructions": "t5 t6", "max_output_tokens": 8})
                http["resp"] = (r.status, r.json())
                r = await c.request("POST", "/v1/responses", json_body={
                    "model": "llama3_8b", "input": words,
                    "max_output_tokens": 8, "stream": True}, stream=True)
                dec, events = SseDecoder(), []
                async for chunk in r.chunks():
                    events.extend(dec.feed(chunk))
                http["stream"] = (r.status, events)
        finally:
            await svc.stop()

    asyncio.run(drive())
    want = eng.embed(inputs[8])
    st, body = http["emb"]
    st2, body2 = http["ids"]
    if (st != 200 or st2 != 200
            or [d["embedding"] for d in body["data"] + body2["data"]]
            != [want] * 3 or body["usage"]["prompt_tokens"] != 16):
        raise AssertionError(f"embeddings: /v1/embeddings {st} {st2} "
                             f"{str(body)[:200]}")
    st, body = http["emb64"]
    v = np.frombuffer(base64.b64decode(body["data"][0]["embedding"]), "<f4")
    if st != 200 or len(v) != dims or abs(float(v @ v) - 1.0) > 1e-4:
        raise AssertionError(f"embeddings: base64 with dimensions {st}")
    st, body = http["resp"]
    if (st != 200 or body["status"] != "incomplete"
            or body["incomplete_details"] != {"reason": "max_output_tokens"}
            or body["usage"]["output_tokens"] != 8):
        raise AssertionError(f"embeddings: /v1/responses {st} "
                             f"{str(body)[:300]}")
    st, events = http["stream"]
    kinds = [e.event for e in events]
    final = json.loads(events[-1].data)["response"] if events else {}
    if (st != 200 or kinds[0] != "response.created"
            or kinds[-2:] != ["response.output_text.done",
                              "response.incomplete"]
            or set(kinds[1:-2]) != {"response.output_text.delta"}
            or final.get("usage", {}).get("output_tokens") != 8):
        raise AssertionError(f"embeddings: the streamed /v1/responses gave "
                             f"{st} {kinds}")
    tq, tb = tps(quiet), tps(busy)
    log(f"embeddings: serve burst {tq:.1f} tok/s alone, {tb:.1f} tok/s "
        f"with {sum(calls)} concurrent 512-token embed calls, tokens "
        f"identical; /v1/embeddings (float, base64 + dimensions) and "
        f"/v1/responses (unary incomplete, streamed {len(kinds)} events) "
        f"200; dispatches encode {eng.dispatch_counts['encode']} ({smi})")
    asyncio.run(eng.stop())   # its loop thread would keep it alive
    figures("cos " + "/".join(f"{c:.5f}" for c, _ in res.values())
            + " (ctl " + "/".join(f"{k:.3f}" for _, k in res.values())
            + f"); pad {pad_cos:.6f}; ms " + "/".join(
                f"{m:.1f}" for m in ms.values())
            + f"; peak {peak / 2**30:.2f} GiB (free {free / 2**30:.1f}); "
              f"burst {tq:.0f}/{tb:.0f} tok/s with {sum(calls)} embeds; "
              f"http 200")
    del chain, eng, manager
    gc.collect()
    torch.cuda.empty_cache()


def phase(name, fn, *args, **kw):
    """Run one phase, print its seconds, and keep its summary line: its
    key figures (figures()), else its last line, shortened. What the
    phase built (engines in reference cycles) is freed before the next
    phase starts."""
    _PHASE.update(figures=None, last="")
    t0 = time.monotonic()
    out = fn(*args, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    secs = time.monotonic() - t0
    SUMMARY.append(summary_line(name, secs,
                                _PHASE["figures"] or _PHASE["last"]))
    log(f"phase {name}: {secs:.1f} s")
    return out


def summary_line(name, secs, figs):
    """A phase's summary line, its figures cut to SUMMARY_LINE characters
    (the block must fit SUMMARY_BUDGET)."""
    if len(figs) > SUMMARY_LINE:
        figs = figs[:SUMMARY_LINE - 3] + "..."
    return f"summary {name}: {secs:.1f} s; {figs}"


def sig4(x):
    """``x`` with every float rounded to 4 significant digits, through
    dicts and lists (the kernels line's figures)."""
    if isinstance(x, float):
        return float(f"{x:.4g}")
    if isinstance(x, dict):
        return {k: sig4(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [sig4(v) for v in x]
    return x


def summary_block(summary, card, kernels, device):
    """The lines that end the output: each phase's summary line, the card
    line, the block's byte count, the kernels line (floats to 4
    significant digits) and the ok line. The count line states the
    bytes (newlines included) from the first summary line to the ok line,
    its own line counted. The block must fit SUMMARY_BUDGET (a short log
    keeps the last 22,000 bytes of the output, and the rest is room for
    later phases); past it, this raises."""
    # one record a kernel: per-shape lists are log lines of their own
    kern = json.dumps({"kernels": sig4([
        {k: v for k, v in r.items() if k != "shapes"} for r in kernels])})
    ok = json.dumps({"ok": True, "device": device})
    n = 0
    while True:
        count = (f"block bytes: {n} from the first summary line to the ok "
                 f"line (budget {SUMMARY_BUDGET})")
        lines = list(summary) + [card, count, kern, ok]
        size = sum(len(line.encode()) + 1 for line in lines)
        if size == n:
            break
        n = size
    if n > SUMMARY_BUDGET:
        raise AssertionError(f"the summary block takes {n} bytes, over the "
                             f"{SUMMARY_BUDGET}-byte budget")
    return lines


def tail_padding(block_bytes, keeps=(24000, 22000)):
    """Lines printed just before the summary block (of ``block_bytes``
    bytes) so that the last ``keeps[i]`` bytes of the output each start
    at a line: a short log keeps the last 22,000 bytes of a run's output,
    a longer one the last 24,000. One line a window, ASCII, its
    newline counted."""
    lines, after = [], block_bytes
    for keep in sorted(keeps):
        label = f"(the last {keep} bytes of the output start at this line) "
        n = keep - after - 1
        if n < len(label):
            raise AssertionError(f"{after} bytes leave no room for a line "
                                 f"that starts the last {keep}")
        lines.insert(0, label + "." * (n - len(label)))
        after = keep
    return lines


# ---------------------------------------------------------------------------
# Mixture-of-Experts at Llama-3.1-8B's width

# the repo's MoE recipe (ModelConfig.tiny_moe: 8 experts, top-2, dropless)
MOE_RECIPE = (("capacity_factor", 0.0), ("num_experts", 8), ("top_k", 2))
# the bf16 arm's depth: 16 layers of bf16 experts are ~48.5 GB (32, ~95 GB,
# do not fit the card); the w8a16 arm keeps all 32 (~47.5 GB)
MOE_BF16_LAYERS = 16
# one full-width layer's FFN, grouped products against the dense dispatch
# (the same routes; each product's rows are summed by another kernel
# tiling, so bf16 rounding apart they agree): the relative L2 norm of the
# difference, and its largest element over the largest output
MOE_FFN_L2_TOL = 0.01
MOE_FFN_MAX_TOL = 0.05
MOE_FFN_T = 512     # the layer check's tokens (a prefill group's rows)
MOE_ALONE = 3       # the serve prompt served alone and joined
# its tokens alone and joined: the others' prefill takes about a TTFT,
# and the lead must still be decoding when they join
MOE_LEAD_NEW = 40
MOE_LEAD_BESIDE = 8  # the joined lead's least tokens decoded beside them


def moe_cfg(quant: bool):
    from dynamo_tpu_torch.models.config import ModelConfig

    return ModelConfig.llama3_8b(
        moe=MOE_RECIPE, quant="int8" if quant else None,
        num_layers=32 if quant else MOE_BF16_LAYERS)


def check_moe_ffn_paths(cfg, params):
    """Layer 0's MoE FFN at full width on MOE_FFN_T random rows (the
    last 37 masked out of routing): the grouped products (the eager
    paths) against the dense dispatch (the replayed round), within
    MOE_FFN_L2_TOL and MOE_FFN_MAX_TOL; the control, the same layer at
    capacity_factor 0.25 (capacity drops) against the dropless dispatch,
    must fail them. Returns (relative L2, largest element, the control's
    relative L2, grouped ms, dispatch ms) (host wall of a synchronized
    call, median of 3)."""
    from dynamo_tpu_torch.models import llama

    T, H = MOE_FFN_T, cfg.hidden_size
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    x = torch.randn(T, H, generator=gen, device="cuda").to(
        llama.torch_dtype(cfg.dtype))
    valid = torch.arange(T, device="cuda") < T - 37
    lp = llama._layer(params, 0)
    out, ms = {}, {}
    with torch.no_grad():
        for grouped in (True, False):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[grouped] = llama._moe_ffn(cfg, lp, x, valid, 1, grouped)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[grouped] = float(np.median(times))
        drops = dataclasses.replace(cfg, moe=tuple(sorted(dict(
            MOE_RECIPE, capacity_factor=0.25).items())))
        ctl = llama._moe_ffn(drops, lp, x, valid, 1, False)
    want = out[False].float()

    def dist(got):
        d = got.float() - want
        return ((d.norm() / want.norm()).item(),
                (d.abs().max() / want.abs().max()).item())

    l2, mx = dist(out[True])
    c_l2, c_mx = dist(ctl)
    dead = out[True][~valid].abs().max().item()
    log(f"moe ffn ({'w8a16' if cfg.quant else 'bf16'}, layer 0 at full "
        f"width, {T} rows, {T - int(valid.sum())} masked): grouped against "
        f"the dense dispatch: relative L2 {l2:.3e}, largest element "
        f"{mx:.3e} of the largest output (tolerance {MOE_FFN_L2_TOL}, "
        f"{MOE_FFN_MAX_TOL}); masked rows {dead}; the control "
        f"(capacity_factor 0.25) {c_l2:.3e}, {c_mx:.3e}; grouped "
        f"{ms[True]:.2f} ms, dispatch {ms[False]:.2f} ms (host wall, "
        f"synchronized, median of 3)")
    if l2 > MOE_FFN_L2_TOL or mx > MOE_FFN_MAX_TOL or dead != 0:
        raise AssertionError(f"moe ffn: the grouped products differ from "
                             f"the dense dispatch by {l2:.3e} (L2), "
                             f"{mx:.3e} (largest); masked rows {dead}")
    if c_l2 <= MOE_FFN_L2_TOL and c_mx <= MOE_FFN_MAX_TOL:
        raise AssertionError(f"moe ffn: the control with capacity drops "
                             f"passes the tolerance ({c_l2:.3e}, "
                             f"{c_mx:.3e})")
    return l2, mx, c_l2, ms[True], ms[False]


def eager_engine(cfg, ecfg, params):
    """A TorchEngine on the card whose rounds and patches run eagerly,
    each program issued from the host (no graph captured), to hold the
    replayed rounds against."""
    from dynamo_tpu_torch.engine import graphs as eg
    from dynamo_tpu_torch.engine.engine import TorchEngine

    prepare = eg.DeviceGraphs.prepare
    eg.DeviceGraphs.prepare = lambda self: None
    try:
        eng = TorchEngine(cfg, ecfg, params=params, device="cuda")
    finally:
        eg.DeviceGraphs.prepare = prepare
    eng.graphs.on_card = False  # _run() calls the program itself
    return eng


async def eager_paths(eng, prompts, lead, n_new=32,
                      lead_new=MOE_LEAD_NEW):
    """On ``eng`` (behind its IntakeGate): the serve burst and its prefix
    repeat, as serve_llama3_8b drives them; then, after dropping every
    cached block, prompt ``lead`` alone, and again on a cold cache with
    the other prompts sent once its first token is out. Both prefill it
    alone (a group of one, no prefix hit); the second decodes it beside
    the others. Returns the burst's and the repeat's tokens, the lead's
    ``lead_new`` tokens alone and joined, and how many of the joined
    lead's tokens came after another stream's first token."""
    res = await generate_all(eng, prompts, n_new, logprobs=2)
    repeat = (await generate_all(eng, prompts[:1], n_new, logprobs=2))[0]
    eng.clear_kv_blocks()
    alone = (await generate_all(eng, prompts[lead:lead + 1], lead_new))[0]
    eng.clear_kv_blocks()
    mine, others = [0], [0] * (len(prompts) - 1)
    lead_task = asyncio.create_task(generate_all(
        eng, prompts[lead:lead + 1], lead_new, progress=mine))
    while not mine[0] and not lead_task.done():
        await asyncio.sleep(0.001)
    rest_task = asyncio.create_task(generate_all(
        eng, prompts[:lead] + prompts[lead + 1:], n_new, progress=others))
    while not any(others) and not lead_task.done():
        await asyncio.sleep(0.001)
    before = mine[0]
    joined = (await lead_task)[0]
    await rest_task
    await eng.stop()
    for _, _, ann, *_ in (alone, joined):
        if ann.get("cached_blocks"):
            raise AssertionError(f"the lead prompt hit {ann['cached_blocks']} "
                                 f"cached blocks after they were dropped")
    return ([t for t, *_ in res + [repeat]], alone[0], joined[0],
            lead_new - before)


def check_moe(quant, smi):
    """Llama-3.1-8B's width with the repo's MoE recipe (MOE_RECIPE: 8
    experts, top-2, dropless; Mixtral-8x7B's layer shape), random weights
    from the seed: w8a16 at all 32 layers (``quant``) or bf16 at
    MOE_BF16_LAYERS. The serve burst (8 prompts, 32 tokens, top-2
    logprobs) and its prefix repeat through the replayed round, dense KV
    then int8 KV (serve_llama3_8b: flash-decode on every layer of every
    step, w8a16 (4 + 3 x 8) x 32 + 1 products a step inside the replays,
    the prefix repeat's cached blocks). Along the same prefill paths,
    token for token in both KV modes (eager_paths, on an eager engine):
    the burst and the repeat equal to the replayed ones, and prompt
    MOE_ALONE alone equal to itself joined by the other prompts after its
    first token (decode masks the dead lanes, so occupancy moves no
    token). Across prefill paths (the repeat's prefix hit prefills only
    its tail; the burst prefilled the prompt in a group, alone it is a
    group of one) sums run in another order: with dense KV the repeat
    and the burst's stream part from their counterparts at a top-2 swap
    at most (part_ways); with int8 KV the repeat's tail attends its
    prefix's int8 pages where the first prefill attended the same rows
    unquantized, so how far they agree is information. Also a decode
    step's device and wall ms (time_rounds on the dense-KV serve
    engine) and layer 0's grouped FFN held to the dense dispatch
    (check_moe_ffn_paths). Returns (dense, int8) flash-decode launches
    and the w8a16 kernel's executions."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.models import llama

    cfg = moe_cfg(quant)
    label = "w8a16" if quant else "bf16"
    L, E = cfg.num_layers, cfg.moe_dict["num_experts"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = llama.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    lay = params["layers"]
    if not isinstance(lay["wr"], torch.Tensor) or "wg" in lay:
        raise AssertionError("moe: the router must stay a dense tensor and "
                             "the experts replace wg, wu, wd")
    gib = weights_gib(params)
    ex = lay["we_g"]["q"] if quant else lay["we_g"]
    expert_bytes = 3 * ex.numel() * ex.element_size()
    log(f"moe {label}: Llama-3.1-8B width, {L} layers, {E} experts top-2 "
        f"dropless: weights {gib:.2f} GiB ({expert_bytes / 1e9:.2f} GB of "
        f"experts) made on the card in {time.monotonic() - t0:.1f} s")
    ffn = check_moe_ffn_paths(cfg, params)
    prompts = serve_prompts(cfg.vocab_size)
    launches, gemms, figs, held = {}, 0, {}, {}
    for kv in ("none", "int8"):
        what = f"moe {label} kv {kv}"
        toks, f = serve_llama3_8b({}, params, kv, cfg=cfg, tag=what,
                                  logprobs=2, time_step=kv == "none")
        launches[kv], gemms = f["launched"], gemms + f["gemms"]
        # the same requests along the same prefill paths on an eager
        # engine: token for token
        eng = eager_engine(cfg, EngineConfig(kv_quant=kv), params)
        IntakeGate(eng, len(prompts))
        eager, alone, joined, beside = asyncio.run(
            eager_paths(eng, prompts, MOE_ALONE))
        del eng
        gc.collect()
        if eager != toks:
            split = [next((j for j, (a, b) in enumerate(zip(x, y))
                           if a != b), None) for x, y in zip(eager, toks)]
            raise AssertionError(f"{what}: the eager engine's burst and "
                                 f"prefix repeat differ from the replayed "
                                 f"rounds' at {split}")
        if beside < MOE_LEAD_BESIDE:
            raise AssertionError(
                f"{what}: the other prompts' first token came when prompt "
                f"{MOE_ALONE} had {MOE_LEAD_NEW - beside} of its "
                f"{MOE_LEAD_NEW}: fewer than {MOE_LEAD_BESIDE} decoded "
                f"beside them")
        if alone != joined:
            j = next(j for j, (a, b) in enumerate(zip(alone, joined))
                     if a != b)
            raise AssertionError(
                f"{what}: prompt {MOE_ALONE} alone and joined by the other "
                f"{len(prompts) - 1} after its first token (the same "
                f"prefill path, {beside} tokens decoded beside them) part "
                f"at step {j}")
        # across prefill paths (a prefix hit's tail; a group of one where
        # the burst prefilled a group), sums run in another order: with
        # dense KV a top-2 swap at most
        if kv == "none":
            splits, problems = part_ways(
                what, [(toks[-1], f["top"][-1]),
                       (toks[MOE_ALONE], f["top"][MOE_ALONE])],
                [toks[0], alone[:len(toks[0])]])
            if problems:
                raise AssertionError("; ".join(problems))
            cross = [describe_splits(splits[:1]), describe_splits(splits[1:])]
        else:
            # information: the repeat's tail attends its prefix's int8
            # pages where the first prefill attended the same rows
            # unquantized (as the reference's int8 engine does), so it
            # may part wherever quantization moves the top-2
            cross = []
            for a, b, top in ((toks[-1], toks[0], f["top"][0]),
                              (alone[:len(toks[0])], toks[MOE_ALONE],
                               f["top"][MOE_ALONE])):
                j = next((j for j, (x, y) in enumerate(zip(a, b))
                          if x != y), None)
                cross.append(f"{len(b)}/{len(b)} equal" if j is None else
                             f"{j}/{len(b)} equal, then parts where the "
                             f"burst's top-2 gap is "
                             f"{top[j][0][1] - top[j][1][1]:.4f}")
        held[kv] = beside
        figs[kv] = dict(f, repeat=cross[0], alone=cross[1])
    dev_ms, wall_ms = figs["none"]["step_ms"]
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    wbytes = gib * 2**30
    bound = wbytes / H100_BYTES_PER_S * 1e3
    e_bound = expert_bytes / H100_BYTES_PER_S * 1e3
    fd, f8 = figs["none"], figs["int8"]
    rd = fd["reads"]
    log(f"moe {label}: dense KV TTFT median {np.median(fd['ttft']):.4f} s, "
        f"gap median {np.median(fd['gaps']) * 1e3:.2f} ms, "
        f"{fd['tps']:.1f} tok/s; int8 KV {np.median(f8['ttft']):.4f} s, "
        f"{np.median(f8['gaps']) * 1e3:.2f} ms, {f8['tps']:.1f} tok/s; a "
        f"replayed decode step {dev_ms:.3f} ms device, {wall_ms:.3f} ms "
        f"wall (8 slots, time_rounds) against a byte bound of {bound:.3f} "
        f"ms (all weights) / {e_bound:.3f} ms (experts alone) at "
        f"{H100_BYTES_PER_S / 1e12:.2f} TB/s; peak "
        f"{peak:.2f} GiB allocated (max_memory_allocated); the prefill's "
        f"kept-count reads {rd['n']} ({L} a call) took {rd['s'] * 1e3:.1f} "
        f"ms of host time (each waits for the stream); along the same "
        f"prefill paths, token for token in both KV modes: eager == "
        f"replayed 9/9 (the burst and the prefix repeat), prompt "
        f"{MOE_ALONE} alone == joined by the other 7 after its first token "
        f"({held['none']} / {held['int8']} of its tokens decoded beside "
        f"them); across paths, the prefix repeat against its first "
        f"stream: {fd['repeat']} (dense KV), {f8['repeat']} (int8 KV); "
        f"alone against its stream in the burst: {fd['alone']} (dense "
        f"KV), {f8['alone']} (int8 KV); {smi}")
    figures(f"{L}L {gib:.1f} GiB peak {peak:.1f}; TTFT {np.median(fd['ttft']):.3f}"
            f"/{np.median(f8['ttft']):.3f} s; {fd['tps']:.0f}/{f8['tps']:.0f} "
            f"tok/s; step {dev_ms:.2f} dev {wall_ms:.2f} wall ms, bound "
            f"{bound:.2f} (experts {e_bound:.2f}); same path eager==replay "
            f"9/9, alone==joined ({held['none']}/{held['int8']} beside); "
            f"across: repeat {fd['repeat'].split(' ')[0]}/"
            f"{f8['repeat'].split(' ')[0]}, alone {fd['alone'].split(' ')[0]}"
            f"/{f8['alone'].split(' ')[0]}; ffn L2 {ffn[0]:.1e} (ctl "
            f"{ffn[2]:.1e}); reads {rd['s'] * 1e3:.0f} ms; fd "
            f"{launches['none']}/{launches['int8']}, w8a16 {gemms}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches["none"], launches["int8"], gemms


def profiled_checks():
    """Every check that counts kernels with torch.profiler: the
    round_graph phases of the tiny model and tiny_moe (f32) and of
    Llama-3.1-8B's width at CUT_LAYERS layers with dense and int8 KV and
    with w8a16 weights, on weights made here from the seed. run_profiled_checks runs them in a process of its own: in
    a process that has served, torch.profiler may lose kernels of a
    graph replay (PERF.md, "torch.profiler"), so these counts must not
    depend on what ran before them."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    tiny = ModelConfig.tiny(dtype="float32")
    rng = np.random.RandomState(SEED)
    phase("round_graph tiny", check_round_graph,
          "tiny f32", tiny, EngineConfig(
              num_pages=64, page_size=16, max_pages_per_seq=8,
              max_decode_slots=4, prefill_buckets=(32, 64),
              cache_dtype="float32"),
          llama.init_params(tiny, SEED, device="cuda"),
          [rng.randint(1, 256, size=n).tolist() for n in (29, 40, 17, 100)])
    tiny_moe = ModelConfig.tiny_moe(dtype="float32")
    rng = np.random.RandomState(SEED)
    phase("round_graph tiny moe", check_round_graph,
          "tiny_moe f32", tiny_moe, EngineConfig(
              num_pages=64, page_size=16, max_pages_per_seq=8,
              max_decode_slots=4, prefill_buckets=(32, 64),
              cache_dtype="float32"),
          llama.init_params(tiny_moe, SEED, device="cuda"),
          [rng.randint(1, 256, size=n).tolist() for n in (29, 40, 17, 100)])
    cfg = ModelConfig.llama3_8b(num_layers=CUT_LAYERS)
    prompts = serve_prompts(cfg.vocab_size)
    params = llama.init_params(cfg, SEED, device="cuda")
    for kv_quant in ("none", "int8"):
        phase(f"round_graph 8B kv_quant={kv_quant}", check_round_graph,
              f"Llama-3.1-8B {CUT_LAYERS}L kv_quant={kv_quant}", cfg,
              EngineConfig(kv_quant=kv_quant), params, prompts)
    from dynamo_tpu_torch.tenancy.adapters import random_adapter

    factors = {aid: random_adapter(cfg, LORA_RANK, seed=aid)
               for aid in (1, 2, 3)}
    phase("round_graph 8B lora", check_round_graph,
          f"Llama-3.1-8B {CUT_LAYERS}L lora kv_quant=none", cfg,
          EngineConfig(lora_adapters=4, lora_rank=LORA_RANK), params,
          prompts, adapters=(factors, LORA_IDS))
    del factors
    qparams = llama.quantize_params(params)
    del params
    phase("round_graph 8B w8a16", check_round_graph,
          f"Llama-3.1-8B {CUT_LAYERS}L w8a16 kv_quant=none",
          ModelConfig.llama3_8b_int8(num_layers=CUT_LAYERS), EngineConfig(),
          qparams, prompts)


def run_profiled_checks(timeout_s=600):
    """profiled_checks in a fresh process on the same card (``chip_smoke.py
    --profiled-checks``): its output passes through, and its phases'
    summary lines join this run's; it raises if the process fails."""
    sys.stdout.flush()
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--profiled-checks"],
        capture_output=True, text=True, timeout=timeout_s)
    lines = proc.stdout.splitlines()
    done = (proc.returncode == 0 and lines
            and lines[-1].startswith('{"summary": '))
    for line in lines[:-1] if done else lines:
        print(line, flush=True)
    sys.stderr.write(proc.stderr)
    if not done:
        raise AssertionError(f"profiled_checks, in a process of its own, "
                             f"exited {proc.returncode}")
    SUMMARY.extend(json.loads(lines[-1])["summary"])
    log(f"profiled_checks: a process of its own, "
        f"{time.monotonic() - t0:.1f} s")


def build_all():
    """Both kernel libraries, one nvcc each, started together; prints
    ptxas's registers, shared memory and spills per library."""
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.ops import cuda_build, w8a16

    names = ("flash_decode", "w8a16_gemm")
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(names)) as ex:
        outs = list(ex.map(cuda_build.build, names))
    secs = time.monotonic() - t0
    figs = []
    for name, ptxas in zip(names, outs):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
        smem = [int(b) for b in re.findall(r"(\d+) bytes smem", ptxas)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", ptxas))
        dyn = ("; dynamic shared memory " + ", ".join(
            f"{w8a16.smem_bytes(bm)} (mma BM {bm})" for bm in (8, 32, 64))
            + ", " + ", ".join(
                "{} (wgmma BR {}, {} stages)".format(
                    *w8a16.wgmma_smem_bytes(br)[:1], br,
                    w8a16.wgmma_smem_bytes(br)[1]) for br in (128, 256))
            + " bytes a block" if name == "w8a16_gemm" else "")
        log(f"build: {name} in {secs:.1f} s (built in parallel); " + (
            f"{len(regs)} kernels, {min(regs)}..{max(regs)} registers, up to "
            f"{max(smem, default=0)} bytes of static shared memory, {spills} "
            f"bytes of spills{dyn}" if regs else "built before this run"))
        figs.append(f"{name} {len(regs)} kernels, {spills} bytes of spills")
    # the summary stays short: the whole block must fit SUMMARY_BUDGET
    figures(f"built in parallel in {secs:.1f} s; " + "; ".join(figs))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--profiled-checks"]:   # run_profiled_checks
        profiled_checks()
        print(json.dumps({"summary": SUMMARY}), flush=True)
        return 0
    smi = smi_line()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    phase("build", build_all)
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.llama3_8b()
    serve_lens = [len(p) for p in serve_prompts(cfg.vocab_size)]
    fd_report = phase("kernels (flash_decode dense)", check_flash_decode,
                      serve_lens, quant=False)
    fd8_report = phase("kernels (flash_decode int8)", check_flash_decode,
                       serve_lens, quant=True)
    w8_report = phase("kernels (w8a16)", check_w8a16)
    phase("logits f32", check_logits_f32)
    phase("tiny", check_tiny_engine)
    phase("tiny int8", check_tiny_int8)
    phase("tiny w8a16", check_tiny_w8a16)
    phase("tiny moe", check_tiny_engine, moe=True)
    phase("tiny moe w8a16", check_tiny_w8a16, moe=True)
    phase("tiny lora", check_tiny_lora)
    time_block_hashes(serve_prompts(cfg.vocab_size), 64)
    counts: dict[str, int] = {}
    # the 8B weights are made once and serve every 8B phase; the w8a16
    # phases serve their quantization
    t0 = time.monotonic()
    params = llama.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"serve: Llama-3.1-8B bf16 weights made on the card in "
        f"{time.monotonic() - t0:.1f} s")
    dense_tokens, direct = phase("serve none", serve_llama3_8b, counts,
                                 params, "none")
    int8_tokens, _ = phase("serve int8", serve_llama3_8b, counts, params,
                           "int8", dense_tokens)
    ck_launches = phase("checkpoint", check_checkpoint, params, smi)
    http_launches, http_figs = phase("http", check_http, params,
                                     dense_tokens[:8], direct)
    dist_launches, _ = phase("distributed", check_distributed, params,
                             dense_tokens[:8], direct, http_figs)
    kv_launches, kv_figs = phase("kv router", check_kv_router, params,
                                 dense_tokens[:8], direct, http_figs)
    dis_launches, _ = phase("disagg", check_disagg, params, dense_tokens[:8],
                            kv_figs, smi)
    g4_launches, _ = phase("remote kv", check_remote_kv, params, smi)
    res_launches, _ = phase("resilience", check_resilience, params)
    eco_launches, _ = phase("prefix economy", check_prefix_economy, params,
                            smi)
    phase("offload", check_offload, params, counts, smi)
    mm_launches = phase("multimodal", check_multimodal, params, smi)
    phase("embeddings", check_embeddings, params, smi)
    *spec_launches, spec_state = phase("speculation", check_speculation,
                                       params)
    tree_launches = phase("speculation tree", check_speculation_tree, params,
                          spec_state)
    del spec_state
    # w8a16: the same weights quantized per output channel on the card
    t0 = time.monotonic()
    qparams = llama.quantize_params(params)
    torch.cuda.synchronize()
    qcfg = ModelConfig.llama3_8b_int8()
    log(f"w8a16: quantize_params of the bf16 weights on the card in "
        f"{time.monotonic() - t0:.1f} s: {weights_gib(qparams):.2f} GiB "
        f"(bf16 {weights_gib(params):.2f} GiB)")
    lp_diff = first_step_logprob_diff(params, qparams,
                                      serve_prompts(cfg.vocab_size)[0])
    w8_tokens, w8 = phase("serve w8a16", serve_llama3_8b, counts, qparams,
                          "none", dense_tokens, cfg=qcfg)
    spec_w8 = phase("speculation w8a16", check_speculation_w8a16, qparams)
    lora_launches = phase("tenancy", check_tenancy, params, qparams, {
        "none": dense_tokens, "int8": int8_tokens, "w8a16": w8_tokens},
        direct)
    over_launches = phase("overload", check_overload, params)
    log(f"serve w8a16 beside dense (same run, same prompts): TTFT median "
        f"{np.median(w8['ttft']):.4f} s max {max(w8['ttft']):.4f} s "
        f"(dense {np.median(direct['ttft']):.4f}, "
        f"{max(direct['ttft']):.4f}); gap median "
        f"{np.median(w8['gaps']) * 1e3:.2f} ms max "
        f"{max(w8['gaps']) * 1e3:.2f} ms (dense "
        f"{np.median(direct['gaps']) * 1e3:.2f}, "
        f"{max(direct['gaps']) * 1e3:.2f}); decode {w8['tps']:.1f} tok/s "
        f"(dense {direct['tps']:.1f}); weights {w8['gib']:.2f} GiB (dense "
        f"{direct['gib']:.2f}); the first step's largest logprob "
        f"difference to the dense weights (prompt 0) {lp_diff:.4f} "
        f"(information: random weights, quantized)")
    del qparams, params
    gc.collect()
    torch.cuda.empty_cache()
    # MoE at the 8B's width, each model alone on the card
    moe_q = phase("moe w8a16", check_moe, True, smi)
    moe_b = phase("moe bf16", check_moe, False, smi)
    run_profiled_checks()
    text_out = phase("cli", check_cli)
    phase("cli distributed", check_cli_distributed, text_out)
    phase("cli w8a16", check_cli, ["--quantize", "int8"])
    log(f"chip_smoke: {time.monotonic() - t_start:.1f} s in all")
    source = "dynamo_tpu_torch/csrc/flash_decode.cu"
    kernels = [
        dict(name="flash_decode", route="cuda", source=source,
             replaces="dynamo_tpu/ops/flash_decode.py:210",
             launches=counts["flash_decode"], launches_http=http_launches,
             launches_distributed=dist_launches,
             launches_kv_router=kv_launches, launches_disagg=dis_launches,
             launches_resilience=res_launches,
             launches_prefix_economy=eco_launches,
             launches_offload=counts["flash_decode_offload"],
             launches_spec=spec_launches[0] + spec_w8[0],
             launches_spec_tree=tree_launches[0],
             launches_tenancy=lora_launches[0],
             launches_overload=over_launches,
             launches_checkpoint=ck_launches[0],
             launches_multimodal=mm_launches[0],
             launches_moe=moe_q[0] + moe_b[0], **fd_report),
        dict(name="flash_decode_int8", route="cuda", source=source,
             replaces="dynamo_tpu/ops/flash_decode.py:176",
             launches=counts["flash_decode_int8"],
             launches_remote_kv=g4_launches,
             launches_offload=counts["flash_decode_int8_offload"],
             launches_spec=spec_launches[1],
             launches_spec_tree=tree_launches[1],
             launches_tenancy=lora_launches[1],
             launches_checkpoint=ck_launches[1],
             launches_multimodal=mm_launches[1],
             launches_moe=moe_q[1] + moe_b[1], **fd8_report),
        # no Pallas kernel: XLA's fused convert + dot of _mm and the
        # quantized _logits; the figures are one 8B decode step's 225
        # products at M = 8 (per shape: the "kernel w8a16_gemm shapes"
        # log line)
        dict(name="w8a16_gemm", route="cuda",
             source="dynamo_tpu_torch/csrc/w8a16_gemm.cu",
             replaces="dynamo_tpu/models/llama.py:409",
             launches=counts["w8a16_gemm"],
             launches_prefill_wgmma=counts["w8a16_gemm_prefill_wgmma"],
             launches_spec=spec_w8[1], launches_moe=moe_q[2],
             **w8_report),
    ]
    block = summary_block(SUMMARY, smi, kernels, {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()})
    size = sum(len(line.encode()) + 1 for line in block)
    for line in tail_padding(size) + block:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
