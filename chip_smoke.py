#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (xotorch_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --kernels-only  # build the kernels and hold them against
                                          # their plain versions, then stop

Phases, in order; any failure exits nonzero and prints no result line:
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
  2. build: compiles csrc/*.cu with nvcc for sm_90a, one process per source;
  3. kernels: each kernel at synthetic-llama-1b widths (Hq 32, Hkv 8, D 64) in bf16
     against its plain PyTorch version on the same inputs, with times of the kernel,
     the plain version and torch's scaled_dot_product_attention as a yardstick (the
     paged kernels K3/K4 over shuffled page tables, page 128); their int8-cache
     variants K2q, K3q and K4q at the same cases over K/V quantized with the port's
     quantizer, rows' scales spread over 64x, each also bit for bit against its bf16
     twin over the dequantized operands (SDPA over that view as the yardstick); the quantized
     GEMVs K5, K5v4 and K6 at the four projection shapes, rows 1 and 8, with one bf16
     torch.matmul over the pre-dequantized weight as their yardstick; then K1, K4 and
     K4q at the edges of their tensor-core tiles (T off the 16-row tile, groups 1 and
     8, K1 at D 32 and under each XOT_FLASH_BLOCK_Q/_K setting, K4 segments from
     mid-page, window edges mid-tile), and K2, K2q, K3 and K3q at the edges of their
     split-K decode plan (lengths 1, a split -1..+2 and S, windows that empty whole
     splits, B=8 at lengths 1-4095, D 16-128, groups 1-16, pages 16 and 128), with each
     wrapper run once under torch.cuda.set_sync_debug_mode("error"), correctness and
     the int8 twins' bit identity only; then K5, K5v4 and K6 beyond the main path
     (check_gemv_edges: llama-3.1-8B's and 70B's projections, ragged column tiles and
     k-steps, one group, K5 and K5v4 at groups of 32 and 64 values where splits cut
     groups, rows 1, 3 and 8), repeated calls identical, K6's outputs that differ from
     its plain version counted, and each GEMV wrapper once under
     set_sync_debug_mode("error"). The softcapped, windowed cases (K1w, K2qw, K3w, K3q)
     are timed beside one compiled flex_attention call, held against the plain version
     first. Every attention case runs through one case body (attention_case). Then
     the attention kernels at gemma-2-2b's widths (check_gemma_kernels: Hq 8, Hkv 4,
     D 256, window 4096, softcap 50, scale 1/16, queries scaled by 8 so that scores
     reach the softcap): K1/K1w at T 1024 and 4608, K2/K2w/K2q decoding at S 8192
     from 4500 and a 512-query segment, K3/K3w/K3q and K4/K4w/K4q at page 128, each
     held within 2^-6 of its largest |output| and timed beside its plain version, its
     bound and one compiled flex_attention (SDPA without a softcap), with controls:
     the kernel run with its softcap or its window dropped must miss that limit; every
     kernel at D 256 and D 32 with scale 0.1 (a dropped scale a control too), pages 16
     and 128; each D 256 wrapper once under set_sync_debug_mode("error"); then K1-K4 at
     qwen3-moe's (Hq 32, Hkv 4, D 128) and llava's (Hq 32, Hkv 32, D 128) widths, timed
     (check_family_kernels: K1 and K4 at T 1024, K2 and K3 decoding at B 1 and 8, K2
     and K4 over a 16-query verify);
  4. model: a two-layer cut of synthetic-llama-1b at full width, prefill and decode
     through the kernels in bf16 on the card against the plain path in fp32 on the
     CPU: contiguous (K1, K2), then paged (K4 prefill, K3 decode at B=3), then with
     int4 weights through K5 and K5v4 and int8 weights through K6, each kernel call
     also held against its plain version on its own inputs, and a control with one
     group of every contraction dropped that the limit must catch; then with an int8
     KV cache, contiguous (K1, K2q) and paged (K4q, K3q), every K2q/K3q/K4q call held
     against its plain version, and a control with the K and V scales swapped;
  5. main path: the port's server (main.py) serving synthetic-llama-1b at full width
     and depth answers three /v1/chat/completions requests over HTTP, with K1's and
     K2's launch counters read around that run, then one decode under the profiler;
  6. concurrent, paged: a fresh server with XOT_PAGED_KV=1 answers eight concurrent
     streaming requests (64-2000 words, 64 tokens each) through the batcher and the
     page pool: per-request TTFT and decode rate, aggregate tok/s, batch widths, K3's
     and K4's launches against decode steps and prefill segments, pool pages (0 left
     in use), then one B=8 decode chunk under the profiler;
  7. concurrent, contiguous: the same with XOT_PAGED_KV=0 (stacked caches, K1/K2),
     and the share of greedy tokens that agree with the paged phase;
  8. quantized serving: fresh servers with XOT_QUANTIZE=int4 (K5), int4 with
     XOT_INT4_V=4 (K5v4) and int8 with XOT_INT8_KERNEL=1 (K6) answer the main path's
     three requests, each kernel's launches equal to 7 projections x 16 layers x the
     decode steps; each then decodes 32 steps at B=1 and B=8 under the profiler (one
     device kernel in the trace for each call of the wrapper), as
     does the engine alone on the int8 default path (no kernel); then the concurrent
     paged phase's eight requests with int4 weights (K5 launches against decode
     steps), one projection's host time by route, and the five formats' B=1 decode
     steps taken in turn, with bf16 weights over an int8 KV cache as a sixth;
  9. int8 KV cache: a fresh server with --kv-quantize int8 answers the main path's
     three requests (K1 = 16 x fresh prefills, K2q = 16 x (decode steps + segments at
     pos > 0), no K2), decodes 32 steps at B=1 and B=8 under the profiler beside bf16
     (the kernels a step the quantizing writes add), then the eight concurrent
     requests on an int8 page arena (K4q, K3q launches against segments and steps,
     0 pages left, bytes a token against bf16's);
  10. ring, one process: two Nodes (main.build_node, manual discovery, the TCP
     transport on 127.0.0.1), each with its own engine on the card, serve
     synthetic-llama-1b split 8/8 and answer the main path's three requests through
     process_prompt: temperature-0 tokens equal to phase 5's, K1 = 16 x fresh
     prefills and K2 = 16 x (decode steps + segments at pos > 0) summed over both
     engines, every hidden-state hop bfloat16 at 2 x T x 2048 bytes; TTFT, decode
     rate, hop times and wire bytes a decode step; then (c) the fused in-process ring
     (drive_ring_fused): two, then three Nodes in this process linked by
     InProcessPeerHandle (8/8, then three ways) answer the same requests with the
     default decode chunk: the last partition decodes the chain as replays of one
     captured composite step (generate_chunk_ring), hidden states cross on the device;
     temperature-0 streams equal to phase 5's, no per-token decode hop, K1 = 16 x fresh
     prefills and K2 = 16 x (fused steps dispatched + segments at pos > 0), 0 hop bytes
     copied to the host, hops kept on the device = prefills x (Nodes - 1), no decline,
     the chunks run ahead and how they resolved, TPOT beside (a)'s per-token ring; on
     the 2-Node ring four concurrent streams coalesce into batched fused dispatches (mean
     width > 1) and a prompt-lookup request (XOT_SPECULATE 8, phase 18's looping prompt)
     verifies through verify_draft_ring, its stream the plain one's up to a near tie
     (`[time] phase 10 (c)`);
  11. ring, two processes: two `python -m xotorch_tpu_torch.main` peers with a manual
     config naming both and --wait-for-peers 1; the three requests go to the API of
     the peer holding layers 8-15 (each prompt forwarded to layers 0-7's owner) and
     the first also to the other peer's; temperature-0 streams equal to phase 5's
     (read from the sampler peer's DEBUG=2 log; the other runs at DEBUG=1), TTFT and
     decode rate beside phase 5's (DEBUG=0), SendTensor frames a decode step; both
     children stopped, exit 0, none left;
  12. gemma-2-2b from a checkpoint on disk: a gemma-2-2b-shaped HF checkpoint (the
     published config.json of google/gemma-2-2b, seeded random bf16 weights written by
     the port's save_shard_params as two safetensors files and an index, 5.2 GB, and a
     word-level tokenizer) in a temporary seed directory; a two-layer cut of it (layer 0
     windowed, layer 1 global) read by load_shard_params, a 4200-token prefill (past
     the 4096 window) and 4 decode steps through K1/K1w and K2/K2w in bf16 on the card
     against the plain path in fp32 on the CPU (the last 64 positions' logits and each
     step's); then the port's server started with --models-seed-dir (seeding XOT_HOME,
     then the downloader's offline fast path) serving gemma2-2b at full width and
     depth answers the main path's three requests and a 4100-word prompt (its prompt
     and generation pass 4096 positions): K1 = 26 x prefills from 0 outside the scan,
     K2 = 26 x (decode steps + segments at pos > 0 + every scanned segment), half of
     each windowed, TTFT and decode rate, a B=1
     decode chunk under the profiler; the same on a fresh server with XOT_PAGED_KV=1 (K4 = 26 x segments, K3 = 26 x decode
     steps, half windowed, 0 pages left) and the share of temperature-0 tokens the two
     servers agree on; the 4100-word prompt's four leading whole segments go through
     one prefill_scan group (K2, or K4 paged), its last segment through
     forward_sample; the checkpoint deleted at the end;
  13. fused decode: every serving phase above decodes through CUDA-graph replays of one
     captured step (models/graphs.py) and prefills a long prompt's leading whole
     segments through captured prefill_scan groups; this phase holds those programs
     against the eager body (models/generate) on synthetic-llama-1b at full width and
     depth in the five decode formats (bf16, int4 K5, int4 K5v4, int8 K6, bf16 over an
     int8 KV cache) and gemma-2-2b's shape in bf16: 8 graph-replayed steps give the
     eager body's tokens and cache bit for bit at B=1 and B=8 (gemma B=1), contiguous
     (K2/K2q) and paged (K3/K3q), at temperature 0, and with injected Gumbel noise (B=8
     contiguous in every format, paged in bf16; gemma both), the kernels' counters
     reading layers x steps (7 x layers x steps for a GEMV kernel) for the replays;
     then eager against graph, 2 rounds in turn (B=1 and B=8 in bf16, contiguous and
     paged, gemma B=1 both; the quantized formats' timing was cut with the smoke's clock,
     their parity stays): wall ms, device ms and the idle share a
     step, device kernels a step; two fresh graph caches with generators seeded alike
     sampling the same tokens (another seed others); the slab copies' device time; the
     captures, their seconds and the graph pool and slab bytes; a 4096-token prompt
     through prefill_scan against the per-segment loop (hidden states within
     PREFILL_REL_LIMIT) and the engine's TTFT with XOT_SCAN_PREFILL 1 and 0;
  14. sampling extras: OpenAI's seed, logit_bias, presence/frequency penalties,
     min_p, logprobs, stop and n over HTTP on fresh synthetic-llama-1b servers at full
     width and depth (check_sampling_extras): a ban of -100 moves the temperature-0
     first token and +100 on one id makes every token that id; min_p 1 gives the greedy
     stream (parting only where another token's bf16 logit ties the top one); 16 greedy tokens' logprobs and top 5 within 2e-2 of fp32 log-softmax of the
     eager forward's logits; seed 7 reproduces its stream on the same server (the seeded
     graph's generator re-seeded between replays) and on a fresh one, seed 8 and an n 2
     sibling differ; a stop string from the greedy stream with frequency_penalty 2 cuts
     that answer before it (finish "stop", decode steps under max_tokens); plain n 4 coalesces in the batcher;
     frequency_penalty 2 runs on the paged server (K4, K3); graph replays equal the eager
     decode_chunk from the same counts bit for bit over two ladder chunks, contiguous and
     paged; TPOT of an extras request against a plain one at B=1 in turns, the device ms
     the extras add to a step, the captures they add. (Phase 12's gemma-2-2b server
     answers one request with logprobs 3 and a logit_bias, held against the log-softmax
     of its softcapped logits.)
  15. observability (check_observability): a fresh synthetic-llama-1b server at full
     width and depth, bf16, every observability knob at its default, answers the main
     path's three requests (K1 and K2 counted); /v1/perf's bf16_weight_bytes equals the
     nbytes of the parameters on the card (phase 8's quantized servers hold their
     int8/int4 ceilings to their own tensors the same way); after a streamed 64-token
     B=1 request 0 < hbm_util_pct, mfu_pct <= 100 and the decode lane's tok/s is within
     15 % of the client's; over one profiled 32-token chunk the cost model's bytes over
     the card's HBM rate over the kernels' device time (the bound share) is at most 1;
     /v1/trace/device/start and /stop around one request write a Chrome trace holding
     K1's and K2's kernels; with a gate of one slot and a queue of one, three concurrent
     requests give one served, one queued and one 429 with Retry-After, as /v1/queue
     shows; /metrics' request counter and TTFT count equal the requests made and it
     carries xot_mfu_pct and xot_hbm_util_pct; /v1/traces holds one trace per request
     with the JAX package's span names, parents that resolve and ordered times; TPOT and
     device ms a step with every recorder on against all off, 4 rounds in turn. (Phase
     10's ring also keeps one trace id across its hop, shows both peers at
     /v1/cluster/metrics, and splits a token into steps and hops from /v1/anatomy.)
  16. KV reuse and prefill scheduling (check_kv_reuse), with the default knobs
     (phases 4-15 run with XOT_PREFIX_CACHE=0 and XOT_PREFILL_COSCHED=0, as before
     them): synthetic-llama-1b at full width and depth, bf16, XOT_PREFILL_CHUNK 1024.
     A head of 3072 tokens: one cold and three warm requests over HTTP stream bit for
     bit what a XOT_PREFIX_CACHE=0 server streams (hits 3, 3 x 3072 tokens saved; TTFT
     cold against warm), a 2000-token head's warm first-token logits within 5e-2 of the
     cold ones; four warm paged requests (page 128) share the head's pages in place
     (refcounts = holders, no copies) and stream their cold twins; with
     XOT_PREFIX_CACHE=1 three heads in turn spill 96 MiB each to the host tier (the
     third over its 256 MiB budget: host.evict), a returning head restores from the
     host and streams its cold twin, /metrics' host counters equal the bytes, and
     /v1/prefetch restores a queued head before its request (TTFT cold, HBM-warm,
     host-warm); a 6144-token prompt arrives while four streams decode, co-scheduled
     and not (tokens equal up to its join, logits within 5e-2, the longest gap and p50
     TPOT); a forced OOM recovery spills both entries and drops graphs, slab and pool,
     and the next request restores; a real torch.OutOfMemoryError under
     set_per_process_memory_fraction is answered 400 context_length_exceeded and the
     next request 200. K1-K4 launches held exactly to layers x (segments + steps);
  17. survivability (check_survivability): phase 11's two peers as child processes
     (synthetic-llama-1b at full width and depth, bf16, contiguous KV, XOT_PREFILL_CHUNK
     1024) with a 2 s stall watchdog, health checks every 0.5 s evicting after 2
     failures, one restart and one hop retry (SURVIVAL_ENV). Faults go in through POST
     /v1/debug/faults on the peer whose handle sends the hop. An error and a lost ack on
     SendTensor are invisible: the main path's first request streams phase 5's tokens,
     with a retry and exactly one dedup drop on the sampler's /metrics; a sunk SendTensor
     in mid-decode is aborted by the stall watchdog once (a watchdog.fired of kind stall)
     and restarted on the same ring (restarts 1, no eviction) to phase 5's tokens; a
     SIGKILL of layer 0's owner after eight tokens is detected, the peer evicted, the
     ring healed to the sampler alone over every layer (/v1/topology), and the restarted
     answer and a further one are phase 5's tokens; the seconds from the sink to its
     answer, from the kill to detection, to eviction and to the answer (shard load and
     serving); the survivor exits 0 on SIGTERM, the killed child -9, none left;
  18. decode paths (check_decode_paths): synthetic-llama-1b at full width and depth,
     bf16, XOT_PREFILL_CHUNK 1024, XOT_PREFIX_CACHE=0 and XOT_PREFILL_COSCHED=0 (its
     requests repeat prompts). (a) One server holds synthetic-llama-1b and
     synthetic-llama-8b: a request on 1b streams what it streams alone while 8b loads,
     prefills and decodes in the middle of it; /v1/perf lists both contexts with their
     graph-pool and slab bytes; a third model evicts the idle 8b context, whose graphs
     and slab are cleared (no failed capture after), and the paused 1b request then
     finishes as it would alone. (b) The main path's three requests with
     XOT_OVERLAP_CHUNKS 1 and 0 in turn, 4 rounds: temperature-0 streams identical, the
     chunks run ahead resolved (hits, misses), TPOT each way, and the device's idle gaps
     in the decode window of one profiled request each way (the chunk boundaries); eight
     lockstep requests with XOT_OVERLAP_BATCH 1 and 0 stream alike. (c) Prompt lookup
     (XOT_SPECULATE 8) on a 5-word phrase repeated 300 times (1500 tokens: the random
     weights' output then loops, where a repeated paragraph's does not) and on 1500
     tokens that do not repeat, contiguous and paged (page 128): K2 (K4 paged) launch
     16 x verify rounds beyond what the same request's plain decode and prefill launch,
     each verify one graph replay; rounds, tokens a round, /metrics' accept rate, the
     verify's wall ms, TPOT with speculation on and off; the speculative stream equals the
     plain one up to a first divergence that must be a near tie (the two tokens' logits
     within 2^-6 of the row's largest, the kernels' own bound); paged pages back to 0.
     (d) The target as its own draft model (8 + 1 tokens a round unless a near tie),
     synthetic-llama-1b drafting for synthetic-llama-8b (seeded random weights of two
     cards: the acceptance says nothing of real text) with the cost of a round and the
     Node standing down after two bonus-only rounds, and two concurrent requests that
     make no draft call while both are outstanding;
  19. MoE and vision (check_families), with the prefix cache and the lane off:
     Qwen3-30B-A3B's published config cut to 4 of its 48 layers at full width (128
     experts, top 8; 6.2 GB; 8 layers until phase 23 needed the time) and
     LLaVA-1.5-7B's at full width and depth (14.1 GB),
     each written as a seeded checkpoint by the port's writer. The MoE cut's two layers
     against the CPU: every MoE call recomputed in fp32 from the card's input with the
     card's experts within 2^-5, expert flips only at near ties, the logits routed as
     the card routed within 5e-2; LLaVA's tower, projector and a two-layer text cut
     (one 640x480 image merged at <image>) within 5e-2. Then served through main.py:
     the MoE cut's main path with K1 and K2 held exactly to layers x (prefills, steps),
     B=1 and B=8 lockstep chunks under the profiler and the graph pool's bytes after
     each, paged (K4, K3, pages back to 0) and --quantize int8 with XOT_INT8_KERNEL=1
     (K6 = 4 x layers x steps); LLaVA answering two image requests (PNG data URIs) and
     a text one over HTTP, K1 = 32 x prefills, K2 = 32 x steps, the two image streams
     equal, TTFT split into preprocessing, tower, projector and merged prefill, weight
     GB on the card; (c) main.py train on both checkpoints (family_training, a corpus of
     the word tokenizer's "t<id>" words): the MoE cut with LoRA rank 8 then eval, QLoRA
     over int8 experts (B 4, rows of 511, 4 steps each) and a full fine-tune at B 1 (3
     steps); LLaVA-1.5-7B with LoRA rank 8 on its text path then eval; step ms, tokens/s,
     peak GiB, K1 and K1b = layers x steps exactly (`[time] phase 19 (c)`); (d) two-layer
     training cuts of both published configs (check_training_cut: the MoE cut at T 64,
     full fine-tune and LoRA on its attention slots, the reference routed as the card
     routed; llava's text stack at T 200 with LoRA), each gradient within 5e-2 of its
     norm of the plain path's in fp32 on the card, with controls (a window forced, every
     B zeroed) that must miss (`[time] phase 19 (d)`);
  20. multi-LoRA serving (check_adapters), with the prefix cache and the lane off and
     room for three model contexts: the two-layer cut with a seeded rank-16 adapter on
     all seven slots (B nonzero) in bf16 through K1/K2, then over int4 (K5) and int8
     (K6) bases with every kernel call held against its plain version, each within the
     cut's limit and each with a control, every B zeroed, that must miss it; then
     main.py --adapters serving synthetic-llama-1b at full width and depth with `ad1`
     (rank 8, attention) and `ad2` (rank 16, all slots) written by the port's writer:
     each adapter context's load time and the bytes it adds (under a tenth of the
     base's weights, every base tensor's storage shared), /v1/models listing both ready,
     the main path's three requests to the base, @ad1 and @ad2 with K1 and K2 held
     exactly to 16 x (prefills, steps), three different greedy streams of one prompt,
     TPOT and the kernels an adapter adds a step (B=1 under the profiler), each
     context's graph pool and slab bytes, load_checkpoint swapping ad1's context to
     ad2's file (its next stream is @ad2's under the near-tie rule: no stale graph) and
     save_checkpoint writing ad2's tensors back; four base and four adapter streams at
     once on the page pool, each its solo stream under the near-tie rule, pages back
     to 0; an int4 server whose @ad1 requests launch K5 7 x 16 x steps;
  21. training (check_training): (a) K1b, the hand-written gradient of K1, fed the
     log-sum-exp K1 writes, against autograd of flash_attention_ref in fp32 on the card
     (dq, dk and dv each within 2^-6 of its largest |value|, two calls the same bits) at
     synthetic-llama-1b's widths (B 4, T 511: the main path's batch; T 512 and 300),
     softcapped and windowed with queries scaled into the softcap (controls: the softcap
     or the window dropped must miss), at D 128, D 32 with groups 1, D 16 with groups 8
     and gemma-2-2b's widths (D 256, softcap 50; B 4, T 511 and, windowed, B 2, T 512);
     K1's log-sum-exp against its plain version, and K1's output with it requested the
     same bits as without; timed beside the fp32 plain version, SDPA's backward (with a
     softcap or a window, a compiled flex_attention's backward under --yardsticks), each of its two
     device kernels under the profiler, and the bound; ptxas's registers and spills of
     K1, K2, K4 and K1b; each wrapper once under set_sync_debug_mode("error"); (b) a
     two-layer cut at full width, the loss and every trainable leaf's gradient on the card
     (bf16, K1 and K1b) against the plain path in fp32 on the card (TF32 off):
     synthetic-llama-1b's,
     full fine-tune (control: a window forced), LoRA and QLoRA over int8 (control: B
     zeroed), then gemma-2-2b's published config (one windowed layer, one global), full
     fine-tune and LoRA; (c) main.py's train and eval
     commands on synthetic-llama-1b at full width and depth over a seeded "w<id>" corpus
     (B 4, rows of 511, 8 steps): full fine-tune then eval, LoRA rank 8 with saves at 4
     and 8 (base bit for bit; a fresh server resuming the save streams the trained
     engine's temperature-0 tokens), a resume from step 4 (steps 5-8's losses within
     2^-7 of the uninterrupted run's), QLoRA over int8; losses falling, K1 = 16 x
     forwards and K1b = 16 x steps exactly, step ms, tokens/s, peak memory; (d) two Nodes
     over TCP split 8/8 train two steps entering at the peer without layer 0: losses and
     updated adapters within 2^-7 of one peer's, SendExample frames and bytes a step;
  22. the front door (check_front_door): `python -m xotorch_tpu_torch.router
     --fleet-template` over three `python -m xotorch_tpu_torch.main` replicas, each its
     own process and discovery domain, serving synthetic-llama-1b's config and seeded
     weights at full width and depth from a checkpoint with a word-level tokenizer (as
     the llama-3.2-1b card): P (XOT_FABRIC_ROLE=prefill), D1 (contiguous) and D2
     (XOT_PAGED_KV=1), each with the host tier on and XOT_FABRIC_PEERS naming the other
     two, and two references configured as D1 and D2 without the fabric. (a) Three
     requests of one `user` land on D1 and equal its direct answer; (b) a 2104-token
     prompt served and spilled on D1 is fetched by D2 over /v1/kv (D2's fabric hits +1,
     its fabric bytes + the entry's), streaming the reference's cold tokens up to a near
     tie (the logprobs it reported), both TTFTs and the fetch's seconds printed; (c) a
     request prefilled on P and chained to D1 through /v1/kv/offer (the router's
     fabric_chained_total +1, D1's fabric hits +1), its stream the reference's; (d) D1
     SIGKILLed: four requests meanwhile answer 200 from D2, the fleet controller
     respawns D1, the router announces its recent prompts there and D1 streams (a)'s
     answer again; every process stopped, the replicas' K1-K4 launches read from their
     shutdown lines;
  23. parallelism (check_parallel), every mesh's positions on the one card
     (XOT_VIRTUAL_DEVICES): (a) `main.py --serve-tp 2` answers the main path's three
     requests, contiguous then XOT_PAGED_KV=1: greedy streams phase 5's or parting at a
     near tie, K1-K4 launches 2 x the single-card formula, decode steps as graph
     replays keyed by the mesh, each position's weight bytes the cost model's, TTFT,
     TPOT and a B=1 profile; (b) two-layer cuts over tp 2 (bf16, int8 cache and arena,
     int4 K5 and K5v4, int8 K6) against the same cut unsharded, each per-shard kernel
     call against its plain version, a control dropping one position's all-reduce term;
     (c) the 1502-token prompt over sp 2 x tp 2: one ring prefill, the logits against
     one device's, each ring call against plain causal attention in fp32, with a control
     that drops the last rotation's fold; (d) a two-layer cut at Qwen3-30B-A3B's widths
     over ep 2, the dense
     combine against one device's, each MoE call too, with a control; (e) a one-process
     NCCL group's all-reduce (parallel/multihost.py);
  24. training over a mesh (check_mesh_training), every position on the one card
     (XOT_VIRTUAL_DEVICES): (a) `main.py train --serve-tp 2` on synthetic-llama-1b at
     full width and depth over phase 21's corpus (B 4, rows of 511): LoRA rank 8 for 4
     steps with a save at step 4, then eval, and a full fine-tune of 2 steps; K1 = 2 x
     16 x forwards and K1b = 2 x 16 x steps exactly, each loss within 2^-7 of phase 21
     (c)'s single-card loss at the same step, step ms and tokens/s (both positions on
     one card); a fresh single-card engine that loads the step-4 save streams the tp
     engine's temperature-0 tokens (near-tie rule); (b) a two-layer cut at full width
     over dp 2 x tp 2 with ZeRO-1: the gradients of the dp loss against one device's
     (each within 5e-2 of its norm), controls that must miss (one dp replica's term
     dropped; the loss divided per replica), two AdamW steps against the unsharded
     cut's, every per-shard K1b call against its plain version on its own inputs
     (2^-6), the moment bytes position 0 holds against the replicated state's; (c) sp 2
     training on the cut: loss and gradients through ring attention against one
     device's, with a control that drops the last rotation's fold; (d) `main.py
     --serve-tp 2 --adapters ad1=...`: @ad1's greedy stream phase 20's single-card one
     (near-tie rule), K1 and K2 2 x the single-card formula;
  25. the {"kernels": [...]} line (attention launches include phases 10 (c)'s, 12's,
     14's, 15's, 16's, 18's, 19's, 20's, 21's, 22's, 23's and 24's; K6's phase 19's too,
     K5's phase 20's; K1b's phase 19's (c) and (d), phase 21's main-path runs, (c) and
     (d), and phase 24 (a)'s), then the {"ok": true, ...} line last.

`--yardsticks` adds the compiled flex_attention yardsticks (the softcapped and windowed
cases' library times, a library call the port never makes) to phases 3 and 21.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of the card, from the port's tables (NVIDIA's data sheets, at
# the full power limit): bf16 FLOP/s and HBM bytes/s from topology/device_capabilities's
# cuda_chip_peaks, int8 OP/s from its GPU_CHIP_FLOPS row. main() sets them for the card
# it finds (an H100 SXM: 989e12, 1979e12, 3.35e12).
PEAK_BF16_FLOPS = PEAK_INT8_OPS = PEAK_HBM_BYTES = None


def set_peaks(name: str) -> None:
  """The card's peaks into PEAK_*, or a failure for a card the tables lack."""
  global PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_HBM_BYTES
  from xotorch_tpu_torch.topology.device_capabilities import cuda_chip_peaks, lookup_chip_flops
  tflops, gbps = cuda_chip_peaks(name)
  flops = lookup_chip_flops(name)
  if tflops is None or flops is None:
    raise AssertionError(f"no published peaks for {name!r} in the port's tables")
  PEAK_BF16_FLOPS, PEAK_HBM_BYTES, PEAK_INT8_OPS = tflops * 1e12, gbps * 1e9, flops.int8 * 1e12

HQ, HKV, D = 32, 8, 64  # synthetic-llama-1b attention widths
ATOL = 2e-2  # bf16 output rounding (2^-8 relative on |o| <= ~2) plus the plain
             # version's bf16 cast of the probabilities before P.V


def smi_line() -> str:
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
  return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase_env(**env):
  """Set XOT_* knobs for one phase and restore the environment after it."""
  saved = {k: os.environ.get(k) for k in env}
  os.environ.update(env)
  try:
    yield
  finally:
    for k, v in saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v


_L2_FLUSH = []


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
  """Mean device time of one call, from CUDA events around each call, with the
  50 MB L2 flushed before each: on the main path a layer's operands arrive cold,
  after the rest of the model's weights have streamed through. A short spin on the
  card after the flush keeps it busy while the host enqueues the call, so a kernel
  of a few microseconds is not timed with the host's launch latency. The garbage
  collector is off while the calls are issued: a collection that outlasts the spin
  (more likely after a compile) would put the host's pause inside one timed call."""
  import torch
  if not _L2_FLUSH:
    _L2_FLUSH.append(torch.empty(64 << 20, dtype=torch.uint8, device="cuda"))
  for _ in range(warmup):
    fn()
  events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(iters)]
  gc.disable()
  try:
    for start, end in events:
      _L2_FLUSH[0].zero_()
      torch.cuda._sleep(1_000_000)  # ~0.5 ms at the H100's clock
      start.record()
      fn()
      end.record()
    torch.cuda.synchronize()
  finally:
    gc.enable()
  return sum(start.elapsed_time(end) for start, end in events) / iters


def bound(flops: float, nbytes: float, peak: Optional[float] = None):
  t_ops, t_bytes = flops / (peak or PEAK_BF16_FLOPS), nbytes / PEAK_HBM_BYTES
  return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def ptxas_registers(log: str) -> list:
  """(kernel<template arguments>, registers, spill store bytes, spill load bytes) of
  each entry function in nvcc's -Xptxas -v output."""
  import re

  def demangled(sym):  # a length-prefixed "<n>..._kernel" followed by its template arguments
    for m in re.finditer(r"\d+", sym):
      for i in range(len(m.group())):
        n, at = int(m.group()[i:]), m.end()
        if sym[at:at + n].endswith("_kernel") and sym[at + n:at + n + 1] == "I":
          args = re.match(r"I((?:L\w+?E)+)E", sym[at + n:])
          vals = re.findall(r"L\w(\d+)E", args.group(1)) if args else []
          return f"{sym[at:at + n]}<{','.join(vals)}>"
    return sym

  out, name, spills = [], None, (0, 0)
  for line in log.splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
      name = demangled(m.group(1))
      spills = (0, 0)
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    if m:
      spills = (int(m.group(1)), int(m.group(2)))
    m = re.search(r"Used (\d+) registers", line)
    if m and name:
      out.append((name, int(m.group(1)), *spills))
      name = None
  return out


def print_registers(sources=("flash_attention", "flash_decode", "paged_attention",
                             "flash_attention_bwd")) -> None:
  """One line a kernel of the attention sources built in this process: ptxas's registers
  and spills (K1 flash_prefill_kernel, K2's segments flash_cached_segment_kernel, K4
  paged_prefill_kernel, K1b flash_bwd_dq_kernel / flash_bwd_dkdv_kernel; <D, ...>)."""
  from xotorch_tpu_torch.ops import _build
  for source in sources:
    rows = ptxas_registers(_build.LOGS.get(source, ""))
    print(f"[ptxas {source}] " + ("; ".join(f"{n} {r} regs, spills {st}/{ld} B" for n, r, st, ld in rows)
                                  or "no -Xptxas -v output in this process"), flush=True)


def report(name, case, out, ref, ms, plain_ms, lib_ms, b_ms, b_by, limit=ATOL):
  err = (out.float() - ref.float()).abs().max().item()
  rel = err / max(ref.float().abs().max().item(), 1e-12)
  ok = math.isfinite(err) and err <= limit
  print(f"[{name}] {case}: max_abs_err={err:.3e} max_rel_err={rel:.3e} (limit {limit:.3e}) "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
        f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"{name} {case}: kernel disagrees with its plain version ({err})")
  return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound_ms": b_ms, "bound_by": b_by}


# The compiled flex_attention yardsticks (library times of the softcapped and windowed
# cases, a library call the port never makes) run only under --yardsticks: 3-5 s a case.
YARDSTICKS = False


def flex_ms(torch, case, q, k, v, q_pos, lens, window, softcap, ref, scale=None, limit=ATOL):
  """The library time of a softcapped case: one torch.compile'd flex_attention call (a
  yardstick the port never calls) over q [B, T, Hq, D] and bf16 K/V [B, S, Hkv, D],
  with softcap * tanh(score / softcap) as its score_mod and the keys in
  (p - window, p] below each row's length `lens` as its block mask, GQA, at `scale`
  (None: 1/sqrt(D)). The block mask, the compile and a check of the output against
  `ref` (the kernel's plain version) within `limit` stay outside the timed window."""
  from torch.nn.attention.flex_attention import create_block_mask, flex_attention
  B, T, S = q.shape[0], q.shape[1], k.shape[1]

  def score_mod(score, b, h, qi, ki):
    return torch.tanh(score / softcap) * softcap

  def mask_mod(b, h, qi, ki):
    p = q_pos[b, qi]
    return (ki <= p) & (ki > p - window) & (ki < lens[b])

  mask = create_block_mask(mask_mod, B, None, T, S, device="cuda")
  torch._dynamo.reset()  # a fresh compile per case: past 8 shapes dynamo would run it eager
  fn = torch.compile(flex_attention, dynamic=False)
  qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
  call = lambda: fn(qt, kt, vt, score_mod=score_mod, block_mask=mask, scale=scale,
                    enable_gqa=True)
  check_only("flex_attention", case, call().transpose(1, 2), ref, limit)
  return time_ms(call)


def sdpa_ms(torch, q, k, v, q_pos, lens, window, scale=None, causal=False):
  """The library time of a case without a softcap: one scaled_dot_product_attention
  call (a yardstick the port never calls) over bf16 K/V [B, S, Hkv, D], is_causal for
  a segment over its own keys from position 0, else masked to the keys each query at
  q_pos [B, T] sees below its row's length `lens`."""
  import torch.nn.functional as F
  qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
  if causal:
    return time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale,
                                                          enable_gqa=True))
  kv = torch.arange(k.shape[1], device=q.device)
  mask = (kv[None, None, :] <= q_pos[:, :, None]) & (kv[None, None, :] < lens[:, None, None])
  if window:
    mask = mask & (kv[None, None, :] > q_pos[:, :, None] - window)
  m = mask[:, None]
  return time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m, scale=scale,
                                                        enable_gqa=True))


class Widths(NamedTuple):
  """A model's attention widths for the kernel cases. `scale` None is the kernels'
  default, 1/sqrt(D). `q_mul` scales the queries so that scores reach a softcap.
  `strict` holds each case to rel_limit instead of ATOL and runs its controls."""
  hq: int
  hkv: int
  d: int
  tag: str = ""
  scale: Optional[float] = None
  q_mul: float = 1.0
  strict: bool = False

  def queries(self, q):
    return q if self.q_mul == 1.0 else (q.float() * self.q_mul).to(q.dtype)

  def controls(self, window: int, softcap: float):
    """(feature, overrides): the kernel run with that feature dropped, which a strict
    case must tell from its plain version."""
    out = [("softcap", {"softcap": 0.0})] if softcap else []
    if window:
      out.append(("window", {"window": 0}))
    if self.scale is not None and self.scale != self.d ** -0.5:
      out.append(("scale", {"scale": None}))
    return out


LLAMA_1B = Widths(HQ, HKV, D)


def rel_limit(ref) -> float:
  """A strict case's limit: 2^-6 of the largest |output|, four bf16 steps at the top
  of the output's range (the kernels read at most 2^-7.1 of it). It follows the
  outputs where ATOL's |o| <= ~2 does not hold: a decode over 4000 keys of unit
  normals reads |o| <= 0.1, a peaked softmax up to the largest |v|."""
  return 2.0 ** -6 * ref.float().abs().max().item()


def attention_case(torch, w, name, case, call, ref_call, q, view, q_pos, lens, window,
                   softcap, row_bytes, twin=None, timed=True, causal=False):
  """One attention-kernel case. `call(**overrides)` launches the kernel and `ref_call()`
  runs its plain version on the same inputs; the output is held within ATOL, or within
  rel_limit for strict widths, whose controls (the kernel with its softcap, window or
  non-default scale dropped, Widths.controls) must each miss that limit. An int8 case's
  output also equals `twin()`, its bf16 twin over the dequantized operands, bit for bit.
  A timed case adds the kernel's and the plain version's times, the library yardstick
  (flex_ms with a softcap, else sdpa_ms, over `view`, the bf16 K/V [B, S, Hkv, D]) and
  the bound from the keys each query at q_pos [B, T] sees and the cache rows that
  covers (`row_bytes` a row), and returns report's dict."""
  out = call()
  torch.cuda.synchronize()
  ref = ref_call()
  limit = rel_limit(ref) if w.strict else ATOL
  if w.strict:
    for label, over in w.controls(window, softcap):
      err = (call(**over).float() - ref.float()).abs().max().item()
      ok = err > limit
      print(f"[{name}] {case}: control, {label} dropped: max_abs_err={err:.3e} (limit "
            f"{limit:.3e}) {'misses it, as it must' if ok else 'FAIL: within it'}", flush=True)
      if not ok:
        raise AssertionError(f"{name} {case}: a kernel with its {label} dropped passes")
  if twin is not None:
    same = torch.equal(out, twin())
    print(f"[{name}] {case}: bit-identical to its bf16 twin over the dequantized operands: "
          f"{same}", flush=True)
    if not same:
      raise AssertionError(f"{name} {case}: differs from its bf16 twin over the dequantized "
                           "operands (a scale or code read from the wrong place)")
  if not timed:
    check_only(name, case, out, ref, limit)
    return None
  ms = time_ms(call)
  plain_ms = time_ms(ref_call, iters=5)
  k, v = view
  if softcap:
    # A compiled flex_attention costs seconds a case: only with --yardsticks.
    lib = flex_ms(torch, f"{name} {case}", q, k, v, q_pos, lens, window or (1 << 30), softcap,
                  ref, w.scale, limit) if YARDSTICKS else None
  else:
    lib = sdpa_ms(torch, q, k, v, q_pos, lens, window, w.scale, causal)
  qp = q_pos.long().cpu()
  seen = (qp + 1).clamp(max=window) if window else qp + 1
  first = (qp[:, 0] - window + 1).clamp(min=0) if window else 0
  rows = (qp[:, -1] + 1 - first).sum().item()
  b_ms, b_by = bound(4.0 * w.hq * w.d * seen.sum().item(), 2.0 * 2 * q.numel() + rows * row_bytes)
  return report(name, case, out, ref, ms, plain_ms, lib, b_ms, b_by, limit)


def k1_case(torch, w, draw, B, T, window, softcap, timed=True):
  """K1 (flash_attention): B rows of T positions from 0 over their own K/V."""
  from xotorch_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
  q, k, v = w.queries(draw(B, T, w.hq, w.d)), draw(B, T, w.hkv, w.d), draw(B, T, w.hkv, w.d)
  kw = dict(window=window, softcap=softcap, scale=w.scale)
  q_pos = torch.arange(T, device=q.device)[None].expand(B, T)
  return attention_case(torch, w, "flash_attention",
                        f"{w.tag}B={B} T={T} window={window} softcap={softcap}",
                        lambda **o: flash_attention(q, k, v, **{**kw, **o}),
                        lambda: flash_attention_ref(q, k, v, **kw), q, (k, v), q_pos,
                        torch.full((B,), T, device=q.device), window, softcap,
                        4.0 * w.hkv * w.d, timed=timed, causal=not window)


def k2_case(torch, w, draw, gen, B, T, S, starts, window, softcap, int8=False, timed=True):
  """K2 (flash_cached_attention), or K2q over the cache quantized with spread_quantize
  and `gen`: row b's T queries from q_start starts[b] over an S-slot cache."""
  from xotorch_tpu_torch.ops.flash_decode import (dequantize_kv, flash_cached_attention,
                                                  flash_cached_attention_ref)
  q, kc, vc = w.queries(draw(B, T, w.hq, w.d)), draw(B, S, w.hkv, w.d), draw(B, S, w.hkv, w.d)
  q_start = torch.tensor(starts, dtype=torch.int32, device=q.device)
  kw = dict(window=window, softcap=softcap, scale=w.scale)
  name, view, twin, row_bytes = "flash_cached_attention", (kc, vc), None, 4.0 * w.hkv * w.d
  if int8:
    (kc, ks), (vc, vs) = spread_quantize(torch, gen, kc), spread_quantize(torch, gen, vc)
    kw.update(k_scale=ks, v_scale=vs)
    view = dequantize_kv(kc, vc, ks, vs, torch.bfloat16)
    twin = lambda: flash_cached_attention(q, *view, q_start, window=window, softcap=softcap,
                                          scale=w.scale)
    name, row_bytes = "flash_cached_attention_int8", 2.0 * w.hkv * (w.d + 2)
  q_pos = q_start.long()[:, None] + torch.arange(T, device=q.device)[None]
  case = (f"{w.tag}B={B} T={T} S={S} q_start={starts if B == 1 else 'varied'} window={window} "
          f"softcap={softcap}")
  return attention_case(torch, w, name, case,
                        lambda **o: flash_cached_attention(q, kc, vc, q_start, **{**kw, **o}),
                        lambda: flash_cached_attention_ref(q, kc, vc, q_start, **kw), q, view,
                        q_pos, q_pos[:, -1] + 1, window, softcap, row_bytes, twin, timed)


def paged_case(torch, w, draw, gen, lengths, page, T, window, softcap, int8=False, timed=True):
  """K3 (paged_decode_attention, T == 1) or K4 (paged_prefill_attention), or K3q/K4q
  over the arena quantized with spread_quantize and `gen`: row b holds lengths[b]
  positions on shuffled pages of `page` slots, its last T the queries."""
  from xotorch_tpu_torch.ops.flash_decode import dequantize_kv
  from xotorch_tpu_torch.ops.paged_attention import (gather_paged_view, paged_decode_attention,
                                                     paged_decode_attention_ref,
                                                     paged_prefill_attention,
                                                     paged_prefill_attention_ref)
  q, kp, vp, table, lens = paged_inputs(torch, draw, lengths, page, w.hq, w.hkv, w.d, T=T)
  q = w.queries(q)
  fn, ref_fn = ((paged_decode_attention, paged_decode_attention_ref) if T == 1
                else (paged_prefill_attention, paged_prefill_attention_ref))
  kw = dict(window=window, softcap=softcap, scale=w.scale)
  name, twin, row_bytes = fn.__name__, None, 4.0 * w.hkv * w.d
  if int8:
    (kp, ks), (vp, vs) = spread_quantize(torch, gen, kp), spread_quantize(torch, gen, vp)
    kw.update(k_scale_pages=ks, v_scale_pages=vs)
    twin = lambda: fn(q, *dequantize_kv(kp, vp, ks, vs, torch.bfloat16), table, lens,
                      window=window, softcap=softcap, scale=w.scale)
    name, row_bytes = name + "_int8", 2.0 * w.hkv * (w.d + 2)
  view = gather_paged_view(kp, vp, table, kw.get("k_scale_pages"), kw.get("v_scale_pages"),
                           torch.bfloat16)
  q_pos = (lens.long() - T)[:, None] + torch.arange(T, device=q.device)[None]
  shown = lengths if len(lengths) <= 3 else f"{lengths[0]}-{lengths[-1]}"
  case = (f"{w.tag}B={len(lengths)} T={T} lengths={shown} page={page} window={window} "
          f"softcap={softcap}")
  return attention_case(torch, w, name, case,
                        lambda **o: fn(q, kp, vp, table, lens, **{**kw, **o}),
                        lambda: ref_fn(q, kp, vp, table, lens, **kw), q, view, q_pos, lens,
                        window, softcap, row_bytes, twin, timed)


def check_kernels(torch, results: dict) -> None:
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention, flash_cached_attention_ref

  dev = torch.device("cuda")
  gen = torch.Generator(device=dev)
  gen.manual_seed(0)

  def randn(*shape):
    return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)
  seg_randn = seeded_randn(torch, SEGMENT_SEED)

  # K1: prefill from position 0. T=1024 is the main path's first segment below.
  for T, window, softcap in ((512, 0, 0.0), (1024, 0, 0.0), (2048, 0, 0.0), (2048, 256, 50.0)):
    r = k1_case(torch, LLAMA_1B, randn, 1, T, window, softcap)
    if T == 1024 and not window:
      results["flash_attention"] = r

  # K2: decode steps and a chunked-prefill segment over a resident cache.
  # (B, T, S, q_start per row, window); the first case is the main path's decode shape.
  cases = (
    (1, 1, 2048, [640], 0),
    (1, SEGMENT_T, 2048, [1024], 0),  # the main path's second segment (see SEGMENT_T)
    (1, 1, 4096, [4000], 0),
    (8, 1, 4096, [17, 300, 1023, 1024, 2047, 2500, 3333, 4095], 0),
    (1, 64, 4096, [1000], 0),
    (8, 1, 4096, [17, 300, 1023, 1024, 2047, 2500, 3333, 4095], 512),
    (1, 64, 4096, [1000], 256),
  )
  for B, T, S, starts, window in cases:
    draw = seg_randn if T == SEGMENT_T else randn
    r = k2_case(torch, LLAMA_1B, draw, None, B, T, S, starts, window, 0.0)
    if (B, T, S, window) == (1, 1, 2048, 0):
      results["flash_cached_attention"] = r
  # K2's segment rows a block (XOT_FD_BLOCK_Q, 64 or 128) at the main path's second segment.
  q, kc, vc = seg_randn(1, SEGMENT_T, HQ, D), seg_randn(1, 2048, HKV, D), seg_randn(1, 2048, HKV, D)
  q_start = torch.tensor([1024], dtype=torch.int32, device=dev)
  ref = flash_cached_attention_ref(q, kc, vc, q_start)
  for block_q in (64, 128):
    with phase_env(XOT_FD_BLOCK_Q=str(block_q)):
      call = lambda: flash_cached_attention(q, kc, vc, q_start)
      case = f"XOT_FD_BLOCK_Q={block_q} T={SEGMENT_T} S=2048 q_start=[1024]"
      check_only("flash_cached_attention", case, call(), ref)
      print(f"[flash_cached_attention] {case}: ms={time_ms(call):.4f}", flush=True)

  check_paged_kernels(torch, results, randn)
  check_int8_kv_kernels(torch, results, randn)
  check_tile_edges(torch, randn)
  check_split_edges(torch, randn)

  # The other head widths the kernels are built for, at the registry's other
  # llama shapes (synthetic-llama-8b: D 128; synthetic-tiny: Hq 4, Hkv 2, D 16),
  # with ragged lengths, windows and softcaps: correctness only.
  for hq, hkv, d in ((32, 8, 128), (4, 2, 16)):
    w = Widths(hq, hkv, d, f"Hq={hq} Hkv={hkv} D={d} ")
    for T, window, softcap in ((300, 0, 0.0), (300, 64, 30.0)):
      k1_case(torch, w, randn, 2, T, window, softcap, timed=False)
    for T, starts, window in ((1, [0, 200, 511], 0), (20, [100, 37, 400], 50)):
      k2_case(torch, w, randn, None, 3, T, 512 + 32, starts, window, 20.0, timed=False)


# The 1502-token request's second segment on the main path (XOT_PREFILL_CHUNK 1024):
# T=478 at q_start 1024, timed for K2 and K2q. Its inputs come from a generator of
# their own, so the cases drawn after it keep the inputs of runs before it was added
# (the absolute ATOL assumes |o| <= ~2, and other draws can put one output in [4, 8),
# where a bf16 step is 2^-5).
SEGMENT_T, SEGMENT_SEED = 478, 478


def seeded_randn(torch, seed: int):
  """A bf16 standard-normal sampler on the card over a generator seeded with `seed`."""
  gen = torch.Generator(device="cuda")
  gen.manual_seed(seed)
  return lambda *shape: torch.randn(*shape, generator=gen, device="cuda",
                                    dtype=torch.float32).to(torch.bfloat16)


def paged_inputs(torch, randn, kv_rows, page, hq, hkv, d, T=1):
  """One layer's arena [P, page, Hkv, D] whose rows' pages are shuffled across it (page
  0, the scratch page, holds garbage too), the int32 page table and row lengths, and
  q [B, T, Hq, D]. kv_rows[b] is row b's occupied length."""
  B = len(kv_rows)
  maxp = max(-(-n // page) for n in kv_rows)
  P = sum(-(-n // page) for n in kv_rows) + 8
  perm = (torch.randperm(P - 1, generator=torch.Generator().manual_seed(P)) + 1).tolist()
  table = torch.zeros(B, maxp, dtype=torch.int32)
  used = 0
  for b, n in enumerate(kv_rows):
    k = -(-n // page)
    table[b, :k] = torch.tensor(perm[used:used + k], dtype=torch.int32)
    used += k
  q, kp, vp = randn(B, T, hq, d), randn(P, page, hkv, d), randn(P, page, hkv, d)
  return (q, kp, vp, table.to(q.device),
          torch.tensor(kv_rows, dtype=torch.int32, device=q.device))


def check_paged_kernels(torch, results: dict, randn) -> None:
  """K3 and K4 at synthetic-llama-1b widths (page 128) over shuffled page tables
  against their plain versions, timed beside one SDPA call over a pre-gathered
  contiguous view (the gather excluded), or one compiled flex_attention with a
  softcap; then the other head widths and page 16."""
  # K3: decode steps. (lengths per row, window, softcap); the second case is the
  # concurrent phase's shape (eight rows at ragged depths).
  ragged = [100, 300, 700, 1000, 1500, 2200, 3000, 4000]
  for lengths, window, softcap in (([640], 0, 0.0), (ragged, 0, 0.0), (ragged, 512, 50.0)):
    r = paged_case(torch, LLAMA_1B, randn, None, lengths, 128, 1, window, softcap)
    if lengths is ragged and not window:
      results["paged_decode_attention"] = r

  # K4: prefill segments. (T, kv_valid per row, window); the first is the concurrent
  # phase's first segment of a long prompt.
  for T, valid, window in ((1024, [1024], 0), (512, [1536], 0), (300, [700, 1900], 0),
                           (512, [1536], 256)):
    r = paged_case(torch, LLAMA_1B, randn, None, valid, 128, T, window, 0.0)
    if (T, window) == (1024, 0):
      results["paged_prefill_attention"] = r

  # The other head widths (synthetic-llama-8b: D 128; synthetic-tiny: Hq 4, Hkv 2,
  # D 16) at both page sizes, with windows and softcaps: correctness only.
  for hq, hkv, d in ((32, 8, 128), (4, 2, 16)):
    w = Widths(hq, hkv, d, f"Hq={hq} Hkv={hkv} D={d} ")
    for pg in (16, 128):
      for window, softcap in ((0, 0.0), (50, 20.0)):
        paged_case(torch, w, randn, None, [1, 200, 511], pg, 1, window, softcap, timed=False)
        paged_case(torch, w, randn, None, [20, 137, 420], pg, 20, window, softcap, timed=False)


def spread_quantize(torch, gen, x):
  """x [..., Hkv, D] with each (position, head) row scaled by 2^u, u uniform in [-6, 0]
  (so the rows' scales spread over 64x), quantized as the engine writes an int8 cache:
  (codes, bf16 scales)."""
  from xotorch_tpu_torch.models.transformer import _quantize_kv
  u = torch.rand(*x.shape[:-1], 1, generator=gen, device=x.device)
  return _quantize_kv(x * torch.exp2(-6.0 * u).to(x.dtype), torch.bfloat16)


def check_int8_kv_kernels(torch, results: dict, randn) -> None:
  """K2q, K3q and K4q at K2's, K3's and K4's cases over random bf16 K/V quantized
  with the port's quantizer, against their plain versions (dequantize, then attend)
  on the same inputs at ATOL; timed beside one SDPA call over the pre-dequantized
  bf16 view (a yardstick the port never calls). Bound bytes: the visible rows' int8
  codes and bf16 scales, q and o. Each (position, head) row of K and V is first
  scaled by its own 2^u, u uniform in [-6, 0], so the rows' scales spread over 64x
  and a scale read from another row or head changes the result; values stay within
  the unit normal's, so ATOL's bf16 reasoning holds. Every case is also held, bit
  for bit, against its bf16 twin (K2, K3, K4) over the cache or arena dequantized
  beforehand: the int8 kernels stage code x scale rounded once to bf16, the value
  the twin reads, and then run the twin's arithmetic. Then the other head widths and
  page 16, correctness and bit identity only."""
  gen = torch.Generator(device="cuda")
  gen.manual_seed(4)
  seg_gen = torch.Generator(device="cuda")
  seg_gen.manual_seed(SEGMENT_SEED)
  seg_randn = seeded_randn(torch, SEGMENT_SEED + 1)

  # K2q: the main path's decode shape first, then K2's other cases.
  varied = [17, 300, 1023, 1024, 2047, 2500, 3333, 4095]
  for B, T, S, starts, window, softcap in ((1, 1, 2048, [640], 0, 0.0),
                                           (1, SEGMENT_T, 2048, [1024], 0, 0.0),
                                           (8, 1, 4096, varied, 0, 0.0),
                                           (1, 64, 4096, [1000], 0, 0.0),
                                           (8, 1, 4096, varied, 512, 50.0)):
    draw, g = (seg_randn, seg_gen) if T == SEGMENT_T else (randn, gen)
    r = k2_case(torch, LLAMA_1B, draw, g, B, T, S, starts, window, softcap, int8=True)
    if (B, T, S, window) == (1, 1, 2048, 0):
      results["flash_cached_attention_int8"] = r

  # K3q: (lengths per row, window, softcap) at page 128; the second case is the
  # concurrent phase's shape.
  ragged = [100, 300, 700, 1000, 1500, 2200, 3000, 4000]
  for lengths, window, softcap in (([640], 0, 0.0), (ragged, 0, 0.0), (ragged, 512, 50.0)):
    r = paged_case(torch, LLAMA_1B, randn, gen, lengths, 128, 1, window, softcap, int8=True)
    if lengths is ragged and not window:
      results["paged_decode_attention_int8"] = r

  # K4q: (T, kv_valid per row, window); the first is the concurrent phase's first
  # segment of a long prompt.
  for T, valid, window in ((1024, [1024], 0), (512, [1536], 256)):
    r = paged_case(torch, LLAMA_1B, randn, gen, valid, 128, T, window, 0.0, int8=True)
    if (T, window) == (1024, 0):
      results["paged_prefill_attention_int8"] = r

  # The other head widths (synthetic-llama-8b: D 128; synthetic-tiny: Hq 4, Hkv 2,
  # D 16), both page sizes, windows and softcaps: correctness and bit identity only.
  for hq, hkv, d in ((32, 8, 128), (4, 2, 16)):
    w = Widths(hq, hkv, d, f"Hq={hq} Hkv={hkv} D={d} ")
    k2_case(torch, w, randn, gen, 3, 20, 544, [100, 37, 400], 50, 20.0, int8=True, timed=False)
    for pg in (16, 128):
      for window, softcap in ((0, 0.0), (50, 20.0)):
        paged_case(torch, w, randn, gen, [1, 200, 511], pg, 1, window, softcap, int8=True,
                   timed=False)
        paged_case(torch, w, randn, gen, [20, 137, 420], pg, 20, window, softcap, int8=True,
                   timed=False)


def check_tile_edges(torch, randn) -> None:
  """K1, K4 and K4q where their tiles cut the work: T off the 16-row mma tile (1, 15,
  17, 65), groups 1 (Hq = Hkv = 8), 8 (Hq 64, Hkv 8) and 3 (a 16-row tile splits a
  position), K1 at D 32, K4 segments that
  start mid-page at page 16 and 128, windows whose lower edge falls mid-tile, and K1
  under each of its four tile settings (XOT_FLASH_BLOCK_Q / _K in {64, 128}, timed at
  T=1024 as well). Correctness at ATOL against the plain versions; every K4q case also
  bit for bit against K4 over the dequantized arena."""
  from xotorch_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
  from xotorch_tpu_torch.ops.flash_decode import dequantize_kv
  from xotorch_tpu_torch.ops.paged_attention import (paged_prefill_attention,
                                                     paged_prefill_attention_int8,
                                                     paged_prefill_attention_ref)
  for hq, hkv, d in ((8, 8, 64), (64, 8, 64), (24, 8, 64), (16, 4, 32)):
    for T in (1, 15, 17, 65, 300):
      for window, softcap in ((0, 0.0), (37, 30.0)):
        q, k, v = randn(2, T, hq, d), randn(2, T, hkv, d), randn(2, T, hkv, d)
        out = flash_attention(q, k, v, window=window, softcap=softcap)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, window=window, softcap=softcap)
        check_only("flash_attention", f"Hq={hq} Hkv={hkv} D={d} B=2 T={T} window={window} "
                   f"softcap={softcap}", out, ref)
  for block_q in (64, 128):
    for block_k in (64, 128):
      with phase_env(XOT_FLASH_BLOCK_Q=str(block_q), XOT_FLASH_BLOCK_K=str(block_k)):
        for T, window, softcap in ((300, 37, 30.0), (1024, 0, 0.0)):
          q, k, v = randn(1, T, HQ, D), randn(1, T, HKV, D), randn(1, T, HKV, D)
          call = lambda: flash_attention(q, k, v, window=window, softcap=softcap)
          out = call()
          torch.cuda.synchronize()
          ref = flash_attention_ref(q, k, v, window=window, softcap=softcap)
          case = (f"XOT_FLASH_BLOCK_Q={block_q} XOT_FLASH_BLOCK_K={block_k} T={T} "
                  f"window={window} softcap={softcap}")
          check_only("flash_attention", case, out, ref)
          if T == 1024:
            print(f"[flash_attention] {case}: ms={time_ms(call):.4f}", flush=True)

  gen = torch.Generator(device="cuda")
  gen.manual_seed(5)
  for hq, hkv in ((8, 8), (64, 8), (24, 8)):
    for T in (1, 15, 17, 65):
      for pg in (16, 128):
        for window, softcap in ((0, 0.0), (37, 30.0)):
          valid = [T, T + 7, T + 250]  # segments from 0, and from mid-page
          q, kp, vp, table, lens = paged_inputs(torch, randn, valid, pg, hq, hkv, D, T=T)
          out = paged_prefill_attention(q, kp, vp, table, lens, window=window, softcap=softcap)
          torch.cuda.synchronize()
          ref = paged_prefill_attention_ref(q, kp, vp, table, lens, window=window,
                                            softcap=softcap)
          case = (f"Hq={hq} Hkv={hkv} D={D} page={pg} T={T} kv_valid={valid} window={window} "
                  f"softcap={softcap}")
          check_only("paged_prefill_attention", case, out, ref)
          (kq, ks), (vq, vs) = spread_quantize(torch, gen, kp), spread_quantize(torch, gen, vp)
          out8 = paged_prefill_attention_int8(q, kq, vq, ks, vs, table, lens, window=window,
                                              softcap=softcap)
          torch.cuda.synchronize()
          ref8 = paged_prefill_attention_ref(q, kq, vq, table, lens, window=window,
                                             softcap=softcap, k_scale_pages=ks, v_scale_pages=vs)
          check_only("paged_prefill_attention_int8", case, out8, ref8)
          twin = paged_prefill_attention(q, *dequantize_kv(kq, vq, ks, vs, torch.bfloat16), table,
                                         lens, window=window, softcap=softcap)
          if not torch.equal(out8, twin):
            raise AssertionError(f"paged_prefill_attention_int8 {case}: differs from K4 over "
                                 "the dequantized arena")
  print("[paged_prefill_attention_int8] tile edges: every case bit-identical to K4 over the "
        "dequantized arena", flush=True)


def check_split_edges(torch, randn) -> None:
  """K2, K2q, K3 and K3q where the split-K decode plan cuts the cache: rows whose
  length is 1, a split's keys -1, +0, +1 and +2, and S; the same under a window that
  leaves whole splits empty (with a softcap); B=8 at lengths 1 to 4095; head_dim 16,
  32 (K2), 64 and 128; q heads per kv head 1, 4 and 8, and 16 for K2; pages 16 and 128
  for K3. The splits come from the plan the wrappers use (flash_decode.split_plan, this
  card's SM count). Every case at ATOL against its plain version, and each int8 twin
  bit for bit against its bf16 twin over the dequantized operands. Then one call of
  each wrapper under torch.cuda.set_sync_debug_mode("error"): a wrapper that read a
  device tensor back to the host would raise."""
  from xotorch_tpu_torch.ops.flash_decode import (decode_blocks, dequantize_kv,
                                                  flash_cached_attention,
                                                  flash_cached_attention_int8,
                                                  flash_cached_attention_ref, split_plan)
  from xotorch_tpu_torch.ops.paged_attention import (SPLIT_KEYS, paged_decode_attention,
                                                     paged_decode_attention_int8,
                                                     paged_decode_attention_ref)
  dev = torch.device("cuda")
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  gen = torch.Generator(device=dev)
  gen.manual_seed(6)
  bf = torch.bfloat16

  def same(name, case, out8, twin):
    if not torch.equal(out8, twin):
      raise AssertionError(f"{name} {case}: differs from its bf16 twin over the dequantized "
                           "operands")

  def edges(B, hkv, S, max_keys):
    """The keys a split of the plan at (B, hkv, S), and lengths 1, that -1 .. +2, and S."""
    _, kps = split_plan(B, hkv, S, sms, max_keys)
    return kps, [1, kps - 1, kps, kps + 1, kps + 2, S]

  # K2 / K2q: (Hq, Hkv, D), groups 1, 4, 8, 16 at D 64, then D 128, 32 and 16.
  S = 2048
  _, block_k = decode_blocks()
  for hq, hkv, d in ((8, 8, 64), (32, 8, 64), (64, 8, 64), (128, 8, 64), (32, 8, 128),
                     (16, 4, 32), (8, 2, 16)):
    kps, lengths = edges(6, hkv, S, block_k)
    for window, softcap in ((0, 0.0), (kps // 2 + 3, 30.0)):
      cases = [(lengths, window, softcap)]
      if (hq, hkv, d) == (32, 8, 64):
        cases.append(([1, 2, 64, 65, 1000, 2048, 2049, 4095], window, softcap))
      for lens, win, cap in cases:
        B, S_ = len(lens), max(S, max(lens))
        q_start = torch.tensor([n - 1 for n in lens], dtype=torch.int32, device=dev)
        q, kc, vc = randn(B, 1, hq, d), randn(B, S_, hkv, d), randn(B, S_, hkv, d)
        case = (f"Hq={hq} Hkv={hkv} D={d} S={S_} lengths={lens} window={win} softcap={cap} "
                f"({split_plan(B, hkv, S_, sms, block_k)[0]} splits)")
        out = flash_cached_attention(q, kc, vc, q_start, window=win, softcap=cap)
        torch.cuda.synchronize()
        check_only("flash_cached_attention", case, out,
                   flash_cached_attention_ref(q, kc, vc, q_start, window=win, softcap=cap))
        (kq, ks), (vq, vs) = spread_quantize(torch, gen, kc), spread_quantize(torch, gen, vc)
        out8 = flash_cached_attention_int8(q, kq, vq, ks, vs, q_start, window=win, softcap=cap)
        torch.cuda.synchronize()
        check_only("flash_cached_attention_int8", case, out8,
                   flash_cached_attention_ref(q, kq, vq, q_start, window=win, softcap=cap,
                                              k_scale=ks, v_scale=vs))
        same("flash_cached_attention_int8", case, out8,
             flash_cached_attention(q, *dequantize_kv(kq, vq, ks, vs, bf), q_start, window=win,
                                    softcap=cap))

  # K3 / K3q: (Hq, Hkv, D), groups 1, 4, 8 at D 64, then D 128 and 16; pages 16 and 128.
  for hq, hkv, d in ((8, 8, 64), (32, 8, 64), (64, 8, 64), (32, 8, 128), (8, 2, 16)):
    for pg in (16, 128):
      kps, lengths = edges(6, hkv, S, SPLIT_KEYS)
      for window, softcap in ((0, 0.0), (kps // 2 + 3, 30.0)):
        cases = [lengths]
        if (hq, hkv, d) == (32, 8, 64):
          cases.append([1, 2, 64, 65, 1000, 2048, 2049, 4095])
        for lens in cases:
          q, kp, vp, table, ln = paged_inputs(torch, randn, lens, pg, hq, hkv, d)
          case = (f"Hq={hq} Hkv={hkv} D={d} page={pg} lengths={lens} window={window} "
                  f"softcap={softcap} "
                  f"({split_plan(len(lens), hkv, table.shape[1] * pg, sms, SPLIT_KEYS)[0]} splits)")
          out = paged_decode_attention(q, kp, vp, table, ln, window=window, softcap=softcap)
          torch.cuda.synchronize()
          check_only("paged_decode_attention", case, out,
                     paged_decode_attention_ref(q, kp, vp, table, ln, window=window,
                                                softcap=softcap))
          (kq, ks), (vq, vs) = spread_quantize(torch, gen, kp), spread_quantize(torch, gen, vp)
          out8 = paged_decode_attention_int8(q, kq, vq, ks, vs, table, ln, window=window,
                                             softcap=softcap)
          torch.cuda.synchronize()
          check_only("paged_decode_attention_int8", case, out8,
                     paged_decode_attention_ref(q, kq, vq, table, ln, window=window,
                                                softcap=softcap, k_scale_pages=ks,
                                                v_scale_pages=vs))
          same("paged_decode_attention_int8", case, out8,
               paged_decode_attention(q, *dequantize_kv(kq, vq, ks, vs, bf), table, ln,
                                      window=window, softcap=softcap))
  print("[split edges] every K2q and K3q case bit-identical to its bf16 twin over the "
        "dequantized operands", flush=True)

  # No wrapper reads a device tensor back: each runs once with syncs raising.
  q, kc, vc = randn(2, 1, HQ, D), randn(2, S, HKV, D), randn(2, S, HKV, D)
  q_start = torch.tensor([100, 2000], dtype=torch.int32, device=dev)
  (kq, ks), (vq, vs) = spread_quantize(torch, gen, kc), spread_quantize(torch, gen, vc)
  pq, kp, vp, table, ln = paged_inputs(torch, randn, [100, 2000], 128, HQ, HKV, D)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    flash_cached_attention(q, kc, vc, q_start)
    flash_cached_attention_int8(q, kq, vq, ks, vs, q_start)
    paged_decode_attention(pq, kp, vp, table, ln)
  finally:
    torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()
  print("[split edges] flash_cached_attention(_int8) and paged_decode_attention ran with "
        "torch.cuda.set_sync_debug_mode('error'): no host read of a device tensor", flush=True)


def check_only(name, case, out, ref, limit=ATOL) -> None:
  err = (out.float() - ref.float()).abs().max().item()
  ok = math.isfinite(err) and err <= limit
  print(f"[{name}] {case}: max_abs_err={err:.3e} (limit {limit:.3e}) {'ok' if ok else 'FAIL'}",
        flush=True)
  if not ok:
    raise AssertionError(f"{name} {case}: kernel disagrees with its plain version ({err})")


# synthetic-llama-1b's projections: (slot, in, out).
QUANT_SHAPES = (("wq/wo", 2048, 2048), ("wk/wv", 2048, 512), ("w_gate/w_up", 2048, 8192),
                ("w_down", 8192, 2048))
QUANT_REL_TOL = 2.0 ** -7  # two bf16 roundings at the top of the output's range


def check_quant_kernels(torch, results: dict) -> None:
  """K5, K5v4 and K6 at the four projection shapes of synthetic-llama-1b, rows 1 and
  8, against their plain versions on the same card inputs. Tolerance: 2^-7 of the
  output's largest magnitude. The plain versions compute in fp32 and round to bf16
  once; K6 and K5v4 quantize the activations with the same recipe bit for bit, so
  only the order of fp32 sums (K5, K5v4) and the final rounding can differ. The
  library yardstick is one torch.matmul of h by the same weight dequantized to bf16
  beforehand: it reads 2x (int8) or 4x (int4) the weight bytes, and the port never
  calls it. Two calls on the same inputs must give identical outputs; K6 prints how
  many outputs differ from its plain version. Then the edge shapes (check_gemv_edges)."""
  from xotorch_tpu_torch.models.quantize import (dequantize_tensor, dequantize_tensor_grouped,
                                                 quantize_tensor, quantize_tensor_grouped)
  from xotorch_tpu_torch.ops.int4_matmul import (int4_w4a8_matmul, int4_w4a8_matmul_ref,
                                                 int4_w4a16_matmul, int4_w4a16_matmul_ref)
  from xotorch_tpu_torch.ops.int8_matmul import int8_rowquant_matmul, int8_rowquant_matmul_ref

  dev = torch.device("cuda")
  gen = torch.Generator(device=dev)
  gen.manual_seed(3)
  for slot, K, N in QUANT_SHAPES:
    w = torch.randn(1, K, N, generator=gen, device=dev) * 0.02
    q8, s8 = quantize_tensor(w[0], 0)
    q4, s4 = quantize_tensor_grouped(w)
    q4, s4 = q4[0], s4[0]
    dense8 = dequantize_tensor(q8, s8, 0)
    dense4 = dequantize_tensor_grouped(q4[None], s4[None])[0]
    del w
    G = s4.shape[0]
    for rows in (1, 8):
      h = torch.randn(rows, K, generator=gen, device=dev).to(torch.bfloat16)
      io = 2 * rows * (K + N)  # h read, out written (bf16)
      cases = (  # name, kernel, plain, operands, bytes, peak, yardstick weight
        ("int4_w4a16_matmul", int4_w4a16_matmul, int4_w4a16_matmul_ref, (q4, s4),
         io + K * N // 2 + 2 * G * N, PEAK_BF16_FLOPS, dense4),
        ("int4_w4a8_matmul", int4_w4a8_matmul, int4_w4a8_matmul_ref, (q4, s4),
         io + K * N // 2 + 2 * G * N, PEAK_INT8_OPS, dense4),
        ("int8_rowquant_matmul", int8_rowquant_matmul, int8_rowquant_matmul_ref, (q8, s8),
         io + K * N + 2 * N, PEAK_INT8_OPS, dense8),
      )
      for name, fn, ref_fn, ops, nbytes, peak, dense in cases:
        out = fn(h, *ops)
        torch.cuda.synchronize()
        if not torch.equal(out, fn(h, *ops)):
          raise AssertionError(f"{name} {slot} rows={rows}: two calls on the same inputs differ")
        ref = ref_fn(h, *ops)
        if name == "int8_rowquant_matmul":
          print(f"[{name}] {slot} {K}->{N} rows={rows}: {k6_differ(torch, out, ref, ref_fn, h, ops)}",
                flush=True)
        ms = time_ms(lambda: fn(h, *ops))
        plain_ms = time_ms(lambda: ref_fn(h, *ops), iters=5)
        lib_ms = time_ms(lambda: torch.matmul(h, dense))
        b_ms, b_by = bound(2.0 * rows * K * N, nbytes, peak)
        atol = QUANT_REL_TOL * ref.float().abs().max().item()
        r = report(name, f"{slot} {K}->{N} rows={rows}", out, ref, ms, plain_ms, lib_ms, b_ms, b_by,
                   limit=atol)
        if (slot, rows) == ("w_gate/w_up", 1):
          results[name] = r
  gemv_step_us(torch)
  check_gemv_edges(torch)


def gemv_step_us(torch, layers: int = 16) -> None:
  """K5, K5v4 and K6 at one decode row as a decode step meets them: each
  synthetic-llama-1b projection shape `layers` times back to back, a distinct random
  weight each time (one a layer), h resident, no L2 flush, CUDA events around three
  such runs. Once on the one-row kernel (tile 0) and once on the cluster kernels' plan
  (what rows 2-8 take), through the C entry points. Prints device us a call per shape,
  and for a layer's 7 projections on each side and on the launch plan's choice at one
  row (gemv_plan: the one-row kernel for K <= 4096): the measurement behind that
  threshold (PERF.md, Findings on K5 and K6, and on K5v4)."""
  from xotorch_tpu_torch.ops import _build
  from xotorch_tpu_torch.ops.int8_matmul import gemv_plan
  lib = _build.load("quant_matvec")
  dev = torch.device("cuda")
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  stream = torch.cuda.current_stream().cuda_stream
  gen = torch.Generator(device=dev)
  gen.manual_seed(9)
  bf = torch.bfloat16
  entry = {"K6": lib.xot_w8a8_matvec_bf16, "K5": lib.xot_w4a16_matvec_bf16,
           "K5v4": lib.xot_w4a8_matvec_bf16}
  for fmt, fn in entry.items():
    parts, layer = [], {"one-row": 0.0, "cluster": 0.0, "plan": 0.0}
    for slot, K, N in QUANT_SHAPES:
      if fmt == "K6":
        ws = [torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
              for _ in range(layers)]
        scs = [torch.rand(N, generator=gen, device=dev).to(bf) for _ in range(layers)]
      else:
        ws = [torch.randint(0, 256, (K // 128, 64, N), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint8) for _ in range(layers)]
        scs = [torch.rand(K // 128, N, generator=gen, device=dev).to(bf) for _ in range(layers)]
      h = torch.randn(1, K, generator=gen, device=dev).to(bf)
      out = torch.empty(1, N, dtype=bf, device=dev)
      us = {}
      for label, (tile, splits) in (("one-row", (0, 1)), ("cluster", gemv_plan(8, K, N, sms))):
        def run():
          for w, sc in zip(ws, scs):
            gs = () if fmt == "K6" else (128,)
            rc = fn(h.data_ptr(), w.data_ptr(), sc.data_ptr(), out.data_ptr(), 1, K, N, *gs,
                    tile, splits, stream)
            _build.check(rc, f"gemv_step_us {fmt} {slot} tile={tile} splits={splits}")
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # the host enqueues the runs while the card sleeps
        start.record()
        for _ in range(3):
          run()
        end.record()
        torch.cuda.synchronize()
        us[label] = start.elapsed_time(end) / 3 / layers * 1e3
      chosen = "one-row" if gemv_plan(1, K, N, sms)[0] == 0 else "cluster"
      for label in ("one-row", "cluster"):
        layer[label] += us[label] * (1 if slot == "w_down" else 2)
      layer["plan"] += us[chosen] * (1 if slot == "w_down" else 2)
      parts.append(f"{slot} {us['one-row']:.2f} / {us['cluster']:.2f} (plan: {chosen})")
      del ws, scs
    print(f"[gemv step] {fmt} at one row, device us a call over {layers} layers back to back, "
          f"one-row / cluster kernels: " + ", ".join(parts) + f"; a layer's 7 projections "
          f"{layer['one-row']:.2f} / {layer['cluster']:.2f}, on the plan {layer['plan']:.2f} "
          f"({smi_line()})", flush=True)


# K5, K5v4 and K6 beyond the main path: llama-3.1-8B's and 70B's projections, column
# tiles and k-steps cut ragged, one group, h on a 4-byte boundary, and gemma-2-2b's
# projections (so that --quantize on its checkpoint meets no unplanned shape). (label,
# in, out, h offset in bf16 elements from a 16-byte boundary).
GEMV_EDGES = (("8B wq/wo", 4096, 4096, 0), ("8B wk/wv", 4096, 1024, 0),
              ("8B gate/up", 4096, 14336, 0), ("8B down", 14336, 4096, 0),
              ("70B wq/wo", 8192, 8192, 0), ("70B wk/wv", 8192, 1024, 0),
              ("70B gate/up", 8192, 28672, 0), ("70B down", 28672, 8192, 0),
              ("N=4", 2048, 4, 0), ("N=36, ragged tile", 2048, 36, 0),
              ("N=2052, ragged tile", 2048, 2052, 0), ("one group", 128, 2048, 0),
              ("one group, N=36", 128, 36, 0), ("ragged last k-step (K6)", 2052, 36, 0),
              ("h 4-byte aligned", 2048, 512, 2),
              ("gemma-2-2b wq", 2304, 2048, 0), ("gemma-2-2b wk/wv", 2304, 1024, 0),
              ("gemma-2-2b wo", 2048, 2304, 0), ("gemma-2-2b gate/up", 2304, 9216, 0),
              ("gemma-2-2b down", 9216, 2304, 0))


# K5 and K5v4 at groups of 32 and 64 values (label, in, out, group size): at K = 384
# the cluster kernels' 8 splits of 12 k-steps cut groups of 64 (splits start at k-steps
# 1, 3, 4, 6, 7, 9, 10) and each group of 32 is one 16-packed-row chunk; at K = 2048 a
# 128-row tile holds 8 or 4 groups; at 4096 x 4096 the 128-column tile flushes a group
# every chunk. Rows 1 at K <= 4096 take the one-row kernels, at these group sizes too.
GEMV_GROUP_EDGES = (("gs 32, 8 splits", 384, 36, 32), ("gs 64, splits cut groups", 384, 36, 64),
                    ("gs 32", 2048, 36, 32), ("gs 64", 2048, 36, 64),
                    ("8B wq/wo, gs 32", 4096, 4096, 32), ("8B wq/wo, gs 64", 4096, 4096, 64))


def k6_differ(torch, out, ref, ref_fn, h, ops) -> str:
  """How many of K6's outputs differ from its plain version, on the card and on a CPU
  copy of the inputs. The arithmetic is exact, so 0 is expected against the CPU; the
  card's plain version may round its activation scale otherwise (PERF.md, Findings on K5 and K6)."""
  cpu = ref_fn(h.cpu(), *(o.cpu() for o in ops)).to(out.device)
  return (f"{int((out != ref).sum())} of {out.numel()} outputs differ from the plain version "
          f"on the card, {int((out != cpu).sum())} from it on the CPU (exact arithmetic)")


def check_gemv_edges(torch) -> None:
  """K5, K5v4 and K6 at GEMV_EDGES, then K5 and K5v4 at GEMV_GROUP_EDGES, rows 1, 3
  and 8, on random codes and scales: each within 2^-7 of its plain version's range, two
  calls identical, and K6's outputs that differ from its plain version counted
  (k6_differ). K5 and K5v4 need K a multiple of their 128-value group in GEMV_EDGES,
  so they skip the ragged k-step. Then K5, K5v4 and K6 once each under
  torch.cuda.set_sync_debug_mode("error"): no wrapper reads a device tensor back."""
  from xotorch_tpu_torch.ops.int4_matmul import (int4_w4a8_matmul, int4_w4a8_matmul_ref,
                                                 int4_w4a16_matmul, int4_w4a16_matmul_ref)
  from xotorch_tpu_torch.ops.int8_matmul import (gemv_plan, int8_rowquant_matmul,
                                                 int8_rowquant_matmul_ref)
  dev = torch.device("cuda")
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  gen = torch.Generator(device=dev)
  gen.manual_seed(7)
  bf = torch.bfloat16
  cases = ([(label, K, N, off, 128, True) for label, K, N, off in GEMV_EDGES]
           + [(label, K, N, 0, gsz, False) for label, K, N, gsz in GEMV_GROUP_EDGES])
  for label, K, N, off, gsz, with_k6 in cases:
    kernels = []
    if with_k6:
      w8 = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
      ws = (torch.rand(N, generator=gen, device=dev) * 0.02 + 0.005).to(bf)
      kernels.append(("int8_rowquant_matmul", int8_rowquant_matmul, int8_rowquant_matmul_ref,
                      (w8, ws)))
    if K % gsz == 0:
      pk = torch.randint(0, 256, (K // gsz, gsz // 2, N), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint8)
      gs = (torch.rand(K // gsz, N, generator=gen, device=dev) * 0.02 + 0.005).to(bf)
      kernels += [("int4_w4a16_matmul", int4_w4a16_matmul, int4_w4a16_matmul_ref, (pk, gs)),
                  ("int4_w4a8_matmul", int4_w4a8_matmul, int4_w4a8_matmul_ref, (pk, gs))]
    if gsz != 128:
      label = f"{label} ({gsz}-value groups)"
    for rows in (1, 3, 8):
      flat = torch.randn(rows * K + off, generator=gen, device=dev).to(bf)
      h = flat[off:].view(rows, K)
      for name, fn, ref_fn, ops in kernels:
        out = fn(h, *ops)
        torch.cuda.synchronize()
        if not torch.equal(out, fn(h, *ops)):
          raise AssertionError(f"{name} {label} rows={rows}: two calls on the same inputs differ")
        ref = ref_fn(h, *ops)
        tile, splits = gemv_plan(rows, K, N, sms)
        plan = f"tile {tile}, {splits} splits" if tile else "one-row kernel"
        case = f"{label} {K}->{N} rows={rows} ({plan})"
        err = (out.float() - ref.float()).abs().max().item()
        atol = QUANT_REL_TOL * ref.float().abs().max().item()
        ok = math.isfinite(err) and err <= atol
        extra = ""
        if name == "int8_rowquant_matmul":
          extra = "; " + k6_differ(torch, out, ref, ref_fn, h, ops)
        print(f"[{name}] edge {case}: max_abs_err={err:.3e} (atol {atol:.3e}){extra} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
          raise AssertionError(f"{name} {case}: kernel disagrees with its plain version ({err})")
    del kernels
  print("[gemv edges] every K5/K5v4/K6 case within 2^-7 of its range, repeated calls identical",
        flush=True)
  # Why the card's plain K6 can differ from the kernel: its activation scale max / 127.
  x = torch.rand(1 << 20, generator=torch.Generator().manual_seed(0)) * 100
  card = (x.to(dev) / 127.0).cpu()
  print(f"[gemv edges] fp32 x / 127.0 on the card differs from the CPU's in "
        f"{int((card != x / 127.0).sum())} of {x.numel()} values, x * (1 / 127.0) on the CPU "
        f"in {int((x * (1 / 127.0) != x / 127.0).sum())}", flush=True)
  K, N = 2048, 512
  h = torch.randn(8, K, generator=gen, device=dev).to(bf)
  w8 = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
  ws = torch.rand(N, generator=gen, device=dev).to(bf)
  pk = torch.randint(0, 256, (K // 128, 64, N), generator=gen, device=dev,
                     dtype=torch.int32).to(torch.uint8)
  gs = torch.rand(K // 128, N, generator=gen, device=dev).to(bf)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    int8_rowquant_matmul(h, w8, ws)
    int4_w4a16_matmul(h, pk, gs)
    int4_w4a8_matmul(h, pk, gs)
  finally:
    torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()
  print("[gemv edges] int8_rowquant_matmul, int4_w4a16_matmul and int4_w4a8_matmul ran with "
        "torch.cuda.set_sync_debug_mode('error'): no host read of a device tensor", flush=True)


def fp32_copy(torch, params, device):
  """The same tree on `device`, floating leaves in fp32, quantized codes as they are."""
  if isinstance(params, dict):
    return {k: fp32_copy(torch, v, device) for k, v in params.items()}
  return params.to(device=device, dtype=torch.float32 if params.is_floating_point() else params.dtype)


@contextlib.contextmanager
def plain_attention():
  """The training forward's attention through its plain version (flash_attention_ref,
  autograd through PyTorch ops, any dtype and device): the fp32 reference on the card."""
  from xotorch_tpu_torch.models import transformer
  from xotorch_tpu_torch.ops.flash_attention import flash_attention_ref
  real = transformer.flash_attention_train
  transformer.flash_attention_train = flash_attention_ref
  try:
    yield
  finally:
    transformer.flash_attention_train = real


def cpu_copy(torch, params):
  """The same tree on the CPU, floating leaves in fp32, quantized codes as they are."""
  if isinstance(params, dict):
    return {k: cpu_copy(torch, v) for k, v in params.items()}
  return params.float().cpu() if params.is_floating_point() else params.cpu()


def _drop_first_group(torch, params):
  """A control: `params` with the first 128 values of every projection's contraction
  dropped (int4: group 0's scale zeroed; int8: the first 128 weight rows zeroed), as
  a GEMV kernel that lost one of its k-slices would compute. Other leaves shared."""
  layers = dict(params["layers"])
  for slot in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
    if slot + "_gscale" in layers:
      layers[slot + "_gscale"] = layers[slot + "_gscale"].clone()
      layers[slot + "_gscale"][:, 0] = 0
    else:
      layers[slot] = layers[slot].clone()
      layers[slot][:, :128] = 0
  return {**params, "layers": layers}


ADAPTER_B_SCALE = 0.03  # seeded B's std: each adapted projection moves by ~1/8 of its base


def adapter_leaves(torch, cfg, layers: int, rank: int, slots, seed: int, device="cpu",
                   dtype=None) -> dict:
  """Seeded LoRA leaves (`lora_<slot>_a` [L, in, r], `lora_<slot>_b` [L, r, out]) for
  `layers` layers of `cfg`: A ~ N(0, 0.02) as add_lora_params draws it, B ~ N(0,
  ADAPTER_B_SCALE), NONZERO (a fresh B = 0 makes the adapter the base, and every check
  of it pass vacuously), drawn in fp32 on the CPU and moved to `device` in `dtype`."""
  H, I = cfg.hidden_size, cfg.intermediate_size
  q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
  dims = {"wq": (H, q), "wk": (H, kv), "wv": (H, kv), "wo": (q, H), "w_gate": (H, I),
          "w_up": (H, I), "w_down": (I, H)}
  g = torch.Generator().manual_seed(seed)
  out = {}
  for slot in slots:
    d_in, d_out = dims[slot]
    for part, shape, std in (("a", (layers, d_in, rank), 0.02), ("b", (layers, rank, d_out),
                                                                 ADAPTER_B_SCALE)):
      w = torch.randn(shape, generator=g, dtype=torch.float32) * std
      out[f"lora_{slot}_{part}"] = w.to(device=device, dtype=dtype or torch.bfloat16)
  return out


def _drop_b(torch, params):
  """A control: `params` with every adapter's B zeroed (the adapter dropped)."""
  layers = {k: torch.zeros_like(v) if k.startswith("lora_") and k.endswith("_b") else v
            for k, v in params["layers"].items()}
  return {**params, "layers": layers}


def check_model(torch, fmt=None, env=None, kernel=None, limit=5e-2, adapter_rank=0,
                device="cuda", model="synthetic-llama-1b") -> None:
  """A two-layer cut of synthetic-llama-1b at full width: prefill (K1) and decode
  (K2) in bf16 on the card against the plain path in fp32 on the CPU, same weights.
  With `fmt` the weights are quantized on the card first and `env` routes the decode
  projections: on the card through `kernel`, whose launches are counted (7 a layer
  a step), on the CPU through the same function's plain version. `limit` bounds the
  largest logit error as a share of the logits' range.

  With `fmt` two more checks hold the kernel itself: each of its 112 calls in the
  decode steps matches its plain version on the same card inputs, the model's own
  activations, within 2^-7 of the output's range (as in the kernel phase); and a
  control decodes the same steps with one 128-value group of every contraction
  dropped (`_drop_first_group`), which must exceed `limit`.

  With `adapter_rank` a seeded rank-r LoRA adapter sits on all seven slots (over the
  quantized base with `fmt`: QLoRA), on the card in bf16 and on the CPU in fp32; the
  control is then the same prefill and steps with every B zeroed (`_drop_b`), which
  must exceed `limit`. (`device` and `model` let the cut be rehearsed on the CPU.)"""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.models import transformer
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.quantize import quantize_params
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache, init_random_params
  from xotorch_tpu_torch.ops.int4_matmul import int4_w4a8_matmul_ref, int4_w4a16_matmul_ref
  from xotorch_tpu_torch.ops.int8_matmul import int8_rowquant_matmul_ref

  cfg = dataclasses.replace(
    config_from_hf_dict(get_model_card(model)["synthetic_config"]), num_layers=2)
  dev = torch.device(device)
  params = init_random_params(cfg, 2, True, True, seed=0, dtype=torch.bfloat16, device=dev)
  if fmt:
    params = quantize_params(params, fmt, scale_dtype=torch.bfloat16, inplace=True)
  if adapter_rank:
    params["layers"].update(adapter_leaves(torch, cfg, 2, adapter_rank, transformer.LORA_SLOTS,
                                           seed=20, device=dev))
  params_cpu = cpu_copy(torch, params)
  tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 100))
  x = torch.as_tensor(tokens, device=dev)
  x_cpu = torch.as_tensor(tokens)
  cache_cpu = init_kv_cache(cfg, 2, 1, 256, torch.float32, "cpu")
  plain = {"int4_w4a16_matmul": int4_w4a16_matmul_ref, "int4_w4a8_matmul": int4_w4a8_matmul_ref,
           "int8_rowquant_matmul": int8_rowquant_matmul_ref}.get(getattr(kernel, "__name__", ""))
  wrapper = "int8_rowquant_matmul" if fmt == "int8" else "int4_grouped_matmul"
  call_err, original = [], getattr(transformer, wrapper)

  def held(h, w, scale, *variant):
    out = original(h, w, scale, *variant)
    ref = plain(h, w, scale).float()
    call_err.append(((out.float() - ref).abs().max() / ref.abs().max()).item())
    return out

  def card_run(decode_params, prefill_params=params):
    """Card logits of the prefill's last 8 positions, then of 8 decode steps that
    feed the reference's greedy tokens; the kernel's launches in the steps."""
    cache = init_kv_cache(cfg, 2, 1, 256, torch.bfloat16, dev)
    logits, _ = forward_shard(prefill_params, x, cache, 0, cfg, True, True, use_flash=True)
    out = [logits[0, -8:].float().cpu()]
    before = kernel.launches if kernel else 0
    for i, tok in enumerate(fed):
      logits, _ = forward_shard(decode_params, torch.tensor([[tok]], device=dev), cache, 100 + i,
                                cfg, True, True, use_flash_decode=True)
      out.append(logits[0].float().cpu())
    return out, (kernel.launches - before if kernel else 0)

  with phase_env(**(env or {})), torch.inference_mode():
    ref, _ = forward_shard(params_cpu, x_cpu, cache_cpu, 0, cfg, True, True)
    want, fed = [ref[0, -8:]], []
    for i in range(8):
      fed.append(int(want[-1][-1].argmax()))
      ref, _ = forward_shard(params_cpu, torch.tensor([[fed[-1]]]), cache_cpu, 100 + i, cfg,
                             True, True)
      want.append(ref[0])
    if fmt:
      setattr(transformer, wrapper, held)
    try:
      got, launched = card_run(params)
    finally:
      setattr(transformer, wrapper, original)
    if adapter_rank:
      dropped = _drop_b(torch, params)
      control = card_run(dropped, dropped)[0]
    else:
      control = card_run(_drop_first_group(torch, params))[0] if fmt else None

  def error(logits):
    if not all(bool(torch.isfinite(g).all()) for g in logits):
      raise AssertionError("model: non-finite logits on the card")
    return max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(logits, want))

  worst = error(got)
  caught = control is None or error(control) > limit
  calls_ok = not fmt or (len(call_err) == 7 * 2 * 8 and max(call_err) <= QUANT_REL_TOL)
  # bf16 weights are shared; the card keeps activations in bf16 over two layers.
  what = "" if not fmt else f", {fmt} weights, {env} ({kernel.__name__} x{launched})"
  if adapter_rank:
    what += f", a rank-{adapter_rank} LoRA adapter on all seven slots"
  dropped_what = ("every adapter's B zeroed" if adapter_rank else
                  "one 128-value group of every decode contraction dropped")
  ok = worst < limit and caught and calls_ok and (not kernel or launched == 7 * 2 * 8)
  print(f"[{'adapters' if adapter_rank else 'model'}] 2-layer {model} cut{what}, prefill 100 + "
        f"decode 8: max logit error {worst:.3e} of the logits' range (limit {limit:g})"
        + ("" if not fmt else
           f"; {len(call_err)} kernel calls against the plain version on their card inputs: "
           f"worst {max(call_err):.3e} of the output's range (limit 2^-7)")
        + ("" if control is None else
           f"; control, {dropped_what}: {error(control):.3e} ({'caught' if caught else 'NOT caught'})")
        + f" {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"model: card logits disagree with the CPU reference ({worst}), a kernel "
                         f"call with its plain version, the control passed, or the kernel ran "
                         f"{launched} times, not 112")


def check_paged_model(torch) -> None:
  """The same two-layer full-width cut through the paged path: three requests at
  different depths (prompts of 100, 37 and 260 tokens) prefill into one page arena
  over shuffled page tables (one K4 segment each), then decode 8 tokens together,
  B=3 at per-row positions (K3), in bf16 on the card against the plain path in fp32
  on the CPU, same weights."""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.models.transformer import forward_shard, init_random_params
  from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention

  cfg = dataclasses.replace(
    config_from_hf_dict(get_model_card("synthetic-llama-1b")["synthetic_config"]), num_layers=2)
  dev = torch.device("cuda")
  params = init_random_params(cfg, 2, True, True, seed=0, dtype=torch.bfloat16, device=dev)
  params_cpu = cpu_copy(torch, params)
  rng = np.random.default_rng(1)
  lengths, steps, page, P = (100, 37, 260), 8, 128, 16
  prompts = [rng.integers(0, cfg.vocab_size, size=(1, n)) for n in lengths]
  ids = (rng.permutation(P - 1) + 1).tolist()
  table = np.zeros((3, 4), np.int32)
  for b, n in enumerate(lengths):
    k = -(-(n + steps) // page)
    table[b, :k], ids = ids[:k], ids[k:]
  shape = (2, P, page, cfg.num_kv_heads, cfg.head_dim)
  arena = {n: torch.zeros(shape, dtype=torch.bfloat16, device=dev) for n in ("k", "v")}
  arena_cpu = {n: torch.zeros(shape) for n in ("k", "v")}
  table_dev, table_cpu = torch.as_tensor(table, device=dev), torch.as_tensor(table)
  k3, k4 = paged_decode_attention.launches, paged_prefill_attention.launches
  pairs, toks = [], []
  with torch.inference_mode():
    for b, x in enumerate(prompts):
      got, _ = forward_shard(params, torch.as_tensor(x, device=dev), arena, 0, cfg, True, True,
                             page_table=table_dev[b:b + 1])
      want, _ = forward_shard(params_cpu, torch.as_tensor(x), arena_cpu, 0, cfg, True, True,
                              page_table=table_cpu[b:b + 1])
      pairs.append((got[0, -8:].float().cpu(), want[0, -8:]))
      toks.append(int(want[0, -1].argmax()))
    pos = torch.tensor(lengths, dtype=torch.int32)
    for i in range(steps):
      step = torch.tensor(toks)[:, None]
      got, _ = forward_shard(params, step.to(dev), arena, pos.to(dev) + i, cfg, True, True,
                             page_table=table_dev)
      want, _ = forward_shard(params_cpu, step, arena_cpu, pos + i, cfg, True, True,
                              page_table=table_cpu)
      pairs.extend((got[b, -1].float().cpu(), want[b, -1]) for b in range(3))
      toks = [int(want[b, -1].argmax()) for b in range(3)]
  worst = 0.0
  for got, want in pairs:
    if not bool(torch.isfinite(got).all()):
      raise AssertionError("paged model: non-finite logits on the card")
    worst = max(worst, ((got - want).abs().max() / want.abs().max()).item())
  k3, k4 = paged_decode_attention.launches - k3, paged_prefill_attention.launches - k4
  ok = worst < 5e-2 and k3 == 2 * steps and k4 == 2 * 3
  print(f"[model] 2-layer synthetic-llama-1b cut, paged (page 128): prefill 100/37/260 (K4 x{k4}) "
        f"+ decode 8 at B=3 (K3 x{k3}): max logit error {worst:.3e} of the logits' range "
        f"(limit 5e-2) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"paged model: card logits disagree with the CPU reference ({worst}) "
                         f"or the kernels did not run (K3 {k3}, K4 {k4})")


KV8_LIMIT = 5e-2  # the int8-KV cuts: the exact paths' limit, see check_int8_kv_model


def check_int8_kv_model(torch, limit: float = KV8_LIMIT, device: str = "cuda",
                        model: str = "synthetic-llama-1b") -> None:
  """The two-layer full-width cut with an int8 KV cache, in bf16 on the card against
  the plain path in fp32 on the CPU (same weights, same flags, so the CPU's first
  segment also attends its fresh K/V): contiguous, a 100-token prefill from 0 (K1), a
  40-token segment at 100 and 8 decode steps (K2q); paged, prompts of 100, 37 and 260
  tokens into one int8 arena over shuffled page tables (K4q), then 8 decode steps at
  B=3 (K3q). Every K2q/K3q/K4q call is held against its plain version on its own card
  inputs at ATOL. `limit` bounds the largest logit error as a share of the logits'
  largest magnitude, at the bf16 cuts' 5e-2: the card's bf16 K/V and the CPU's fp32
  K/V can take different int8 codes near a step of the grid, which the cuts measured
  at about 2e-2; a control decodes the same steps with each call's K and V scales
  swapped, which must exceed it. (`device` and `model` let it be rehearsed
  on the CPU with a small card.)"""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.inference.torch_engine.paged_cache import PagePool
  from xotorch_tpu_torch.models import transformer
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache, init_random_params
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention_int8, flash_cached_attention_ref
  from xotorch_tpu_torch.ops.paged_attention import (paged_decode_attention_int8,
                                                     paged_decode_attention_ref,
                                                     paged_prefill_attention_int8,
                                                     paged_prefill_attention_ref)

  cfg = dataclasses.replace(config_from_hf_dict(get_model_card(model)["synthetic_config"]),
                            num_layers=2)
  dev = torch.device(device)
  params = init_random_params(cfg, 2, True, True, seed=0, dtype=torch.bfloat16, device=dev)
  params_cpu = cpu_copy(torch, params)
  rng = np.random.default_rng(2)
  x = rng.integers(0, cfg.vocab_size, size=(1, 140))
  lengths, steps, page, P = (100, 37, 260), 8, 128, 16
  prompts = [rng.integers(0, cfg.vocab_size, size=(1, n)) for n in lengths]
  ids = (rng.permutation(P - 1) + 1).tolist()
  table = np.zeros((3, 4), np.int32)
  for b, n in enumerate(lengths):
    k = -(-(n + steps) // page)
    table[b, :k], ids = ids[:k], ids[k:]

  # Each attention call of the transformer, wrapped: its int8 operands held against
  # the plain version on the same inputs (card runs), or its scales swapped (control).
  plain = {"flash_cached_attention": (flash_cached_attention_ref, "k_scale", "v_scale"),
           "paged_decode_attention": (paged_decode_attention_ref, "k_scale_pages", "v_scale_pages"),
           "paged_prefill_attention": (paged_prefill_attention_ref, "k_scale_pages", "v_scale_pages")}
  original = {name: getattr(transformer, name) for name in plain}
  mode = {"swap": False, "hold": False}
  call_err = []

  def wrapped(name):
    ref_fn, ks, vs = plain[name]

    def call(*a, **kw):
      if mode["swap"]:
        kw = {**kw, ks: kw[vs], vs: kw[ks]}
      out = original[name](*a, **kw)
      if mode["hold"]:
        ref = ref_fn(*a, **kw)
        call_err.append((out.float() - ref.float()).abs().max().item())
      return out
    return call

  def contiguous(p, dev_, dtype, fed):
    """Logits of the prefill's last 8 positions, the segment's last 8, then 8 decode
    steps that feed `fed` (the reference's greedy tokens, taken as it runs)."""
    cache = init_kv_cache(cfg, 2, 1, 256, dtype, dev_, kv_quant=True)
    xs = torch.as_tensor(x, device=dev_)
    logits, _ = forward_shard(p, xs[:, :100], cache, 0, cfg, True, True, use_flash=True)
    out = [logits[0, -8:].float().cpu()]
    logits, _ = forward_shard(p, xs[:, 100:], cache, 100, cfg, True, True, use_flash_decode=True)
    out.append(logits[0, -8:].float().cpu())
    for i in range(steps):
      if len(fed) == i:
        fed.append(int(out[-1][-1].argmax()))
      logits, _ = forward_shard(p, torch.tensor([[fed[i]]], device=dev_), cache, 140 + i, cfg, True,
                                True, use_flash_decode=True)
      out.append(logits[0].float().cpu())
    return out

  def paged(p, dev_, dtype, fed):
    arena = PagePool(cfg, 2, P, page, dtype=dtype, device=dev_, kv_quant=True).arena
    tb = torch.as_tensor(table, device=dev_)
    out, last = [], []
    for b, prompt in enumerate(prompts):
      logits, _ = forward_shard(p, torch.as_tensor(prompt, device=dev_), arena, 0, cfg, True, True,
                                page_table=tb[b:b + 1])
      out.append(logits[0, -8:].float().cpu())
      last.append(int(logits[0, -1].argmax()))
    pos = torch.tensor(lengths, dtype=torch.int32, device=dev_)
    for i in range(steps):
      if len(fed) == i:
        fed.append(last)
      logits, _ = forward_shard(p, torch.tensor(fed[i], device=dev_)[:, None], arena, pos + i, cfg,
                                True, True, page_table=tb)
      out.extend(logits[b, -1].float().cpu() for b in range(3))
      last = [int(logits[b, -1].argmax()) for b in range(3)]
    return out

  def error(got, want):
    if not all(bool(torch.isfinite(g).all()) for g in got):
      raise AssertionError("int8-KV model: non-finite logits on the card")
    return max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))

  kernels = (flash_attention, flash_cached_attention_int8, paged_decode_attention_int8,
             paged_prefill_attention_int8)
  with torch.inference_mode():
    for name in plain:
      setattr(transformer, name, wrapped(name))
    try:
      for label, run, want_launches in (
          ("contiguous", contiguous, {"flash_attention": 2, "flash_cached_attention_int8": 2 * (1 + steps)}),
          ("paged", paged, {"paged_prefill_attention_int8": 2 * 3,
                            "paged_decode_attention_int8": 2 * steps})):
        fed = []
        want = run(params_cpu, "cpu", torch.float32, fed)
        before = {k.__name__: k.launches for k in kernels}
        mode["hold"], call_err[:] = True, []
        got = run(params, dev, torch.bfloat16, fed)
        mode["hold"] = False
        launched = {k.__name__: k.launches - before[k.__name__] for k in kernels
                    if k.launches != before[k.__name__]}
        mode["swap"] = True
        control = run(params, dev, torch.bfloat16, fed)
        mode["swap"] = False
        worst, caught = error(got, want), error(control, want)
        ok = (worst < limit and caught > limit and launched == want_launches
              and len(call_err) == sum(want_launches.values()) - want_launches.get("flash_attention", 0)
              and max(call_err) <= ATOL)
        print(f"[model] 2-layer {model} cut, int8 KV, {label}: max logit error "
              f"{worst:.3e} of the logits' range (limit {limit:g}); launches {launched}; "
              f"{len(call_err)} int8 kernel calls against their plain versions on their card inputs: "
              f"worst {max(call_err):.3e} (atol {ATOL}); control, K and V scales swapped: "
              f"{caught:.3e} ({'caught' if caught > limit else 'NOT caught'}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
          raise AssertionError(f"int8-KV model ({label}): card logits disagree with the CPU reference "
                               f"({worst}), a kernel call with its plain version, the control "
                               f"passed ({caught}), or the launches were {launched}")
    finally:
      for name, fn in original.items():
        setattr(transformer, name, fn)


def http_json(url: str, body=None, timeout: float = 300.0):
  import urllib.request
  req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=timeout) as resp:
    return json.loads(resp.read())


def http_stream(url: str, body, timeout: float = 300.0):
  """POST a streaming completion; returns (events, seconds to the first content,
  seconds to the last content)."""
  import urllib.request
  req = urllib.request.Request(url, data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  t0 = time.perf_counter()
  first = last = None
  events = []
  with urllib.request.urlopen(req, timeout=timeout) as resp:
    for raw in resp:
      line = raw.decode().strip()
      if not line.startswith("data: "):
        continue
      data = line[len("data: "):]
      if data == "[DONE]":
        break
      ev = json.loads(data)
      events.append(ev)
      if any(c.get("delta", {}).get("content") for c in ev.get("choices", [])):
        last = time.perf_counter() - t0
        first = last if first is None else first
  return events, first, last


async def profile_decode(torch, engine, model: str, classname: str, card: str,
                         batch: int = 1, tag: str = "profile", focus: str = "",
                         wrapper=None) -> dict:
  """Where a decode chunk's time goes: 32 greedy tokens for each of `batch` requests
  after a 514-token prompt (one batched dispatch when batch > 1), timed once alone
  and once under torch.profiler (CUDA activity). Prints both wall times, the share
  of the profiled one the card spent in kernels, the share of kernels whose name
  holds `focus`, and the kernels by device time. With `wrapper` (a kernel wrapper
  with a launch counter), fails unless the trace holds one `focus` kernel for each of
  the wrapper's launches in the profiled chunk (at most 10 % fewer: the trace drops
  events). Returns the numbers."""
  if engine.device.type != "cuda":
    print(f"[{tag}] no card: busy share not measured", flush=True)
    return {}
  import numpy as np
  from torch.profiler import ProfilerActivity, profile
  from xotorch_tpu_torch.models.registry import build_full_shard

  shard = build_full_shard(model, classname)
  rids = [f"profile{i}" for i in range(batch)]
  toks = {}
  for rid in rids:
    toks[rid], _ = await engine.infer_sample_tensor(rid, shard, np.ones((1, 514), np.int64),
                                                    temp=0.0, top_k=0)

  async def chunk(n):  # every row in the same event-loop pass: one batched dispatch
    outs = await asyncio.gather(*(engine.generate_chunk(rid, shard, int(toks[rid]), n, temp=0.0)
                                  for rid in rids))
    toks.update((rid, int(o[-1])) for rid, o in zip(rids, outs))

  await chunk(8)  # warm
  n = 32
  t0 = time.perf_counter()
  await chunk(n)  # the same chunk without the profiler, and with no HTTP client running
  plain_ms = (time.perf_counter() - t0) * 1e3
  batcher = engine._ctx.batcher
  before = (batcher.dispatches, batcher.rows)
  called = wrapper.launches if wrapper is not None else 0
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    await chunk(n)
    wall_ms = (time.perf_counter() - t0) * 1e3
  called = wrapper.launches - called if wrapper is not None else 0
  widths = f"{batcher.dispatches - before[0]} dispatch(es), {batcher.rows - before[1]} rows"
  for rid in rids:
    await engine.clear_request(rid)
  rows = []
  for evt in prof.key_averages():
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
      us = getattr(evt, "self_cuda_time_total", 0)
    if us > 0:
      rows.append((us / 1e3, evt.key, evt.count))
  if not rows:
    print(f"[{tag}] the trace holds no device time: busy share not measured", flush=True)
    return {}
  rows.sort(reverse=True)
  busy = sum(r[0] for r in rows)
  launches = sum(r[2] for r in rows)
  focus_ms = sum(r[0] for r in rows if focus and focus in r[1])
  out = {"tok_s": batch * n / plain_ms * 1e3, "step_ms": plain_ms / n, "busy_pct": 100 * busy / wall_ms,
         "kernels_per_step": launches / n, "focus_pct": 100 * focus_ms / busy,
         "device_ms": busy / n}
  print(f"[{tag}] B={batch} ({widths}), decode {n} tokens per row after a 514-token prompt: "
        f"{plain_ms:.2f} ms without the profiler ({out['tok_s']:.1f} tok/s); "
        f"wall {wall_ms:.2f} ms ({batch * n / wall_ms * 1e3:.1f} tok/s under the profiler), "
        f"kernels {busy:.2f} ms = {out['busy_pct']:.1f}% busy, "
        f"{100 - out['busy_pct']:.1f}% idle, {out['kernels_per_step']:.0f} device kernels per step, "
        f"{out['device_ms']:.3f} device ms per step"
        + (f", {focus} {focus_ms:.3f} ms = {out['focus_pct']:.1f}% of device time" if focus else "")
        + f" ({card})", flush=True)
  if wrapper is not None:
    # The trace drops events (CUPTI: up to 2.5 % of a chunk's kernels in one run), so the
    # count may fall short of the calls; a second kernel of this name a call would read
    # twice the calls.
    focus_count = sum(r[2] for r in rows if focus in r[1])
    ok = 0.9 * called <= focus_count <= called
    print(f"[{tag}] B={batch}: {focus_count} {focus} kernels in the trace for {called} "
          f"{wrapper.__name__} calls: one kernel a projection {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
      raise AssertionError(f"{tag}: {focus_count} {focus} kernels for {called} calls")
  # The ten longest kernels, and the split-K decode merge wherever it ranks.
  for i, (ms, name, count) in enumerate(rows):
    if i < 10 or "merge_splits" in name:
      print(f"[{tag}]   {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{count:<5d} {name[:90]}", flush=True)
  return out


def main_requests(model: str):
  """The main path's three chat completions: (label, body)."""
  words = lambda n: " ".join(f"w{i % 97}" for i in range(n))
  return [
    ("512-word prompt, 64 tokens", {"model": model, "temperature": 0, "max_tokens": 64,
                                    "messages": [{"role": "user", "content": words(512)}]}),
    ("streaming, 64 tokens", {"model": model, "max_tokens": 64, "stream": True,
                              "stream_options": {"include_usage": True},
                              "messages": [{"role": "user", "content": words(300)}]}),
    # Streamed, so the client reads its TTFT: a first segment of 1024 through K1.
    ("1500-word prompt (> XOT_PREFILL_CHUNK 1024), 32 tokens, streaming",
     {"model": model, "temperature": 0, "max_tokens": 32, "stream": True,
      "stream_options": {"include_usage": True},
      "messages": [{"role": "user", "content": words(1500)}]}),
  ]


def drive_main_path(torch, card: str, device: str = "cuda", model: str = "synthetic-llama-1b",
                    kernels=None, env=None, tag: str = "main", profiles=(1,),
                    focus: str = "", cli=(), wrapper=None, requests=None, after=None,
                    before=None) -> dict:
  """The port's server on `model` (synthetic-llama-1b: full width and depth, on the
  card) answers three chat completions over HTTP, with `env` (XOT_* knobs, e.g. the
  quantized formats) set for the phase and `cli` (e.g. `--kv-quantize int8`) added
  to its command line (`--models-seed-dir` seeds XOT_HOME first, as main.py does).
  `requests` replaces the three (main_requests). Every counter of `kernels` (default K1,
  K2), its windowed launches too, is set to 0 just
  before the three requests and read just after; then a decode chunk runs under the
  profiler at each batch size of `profiles` (with `wrapper`, held to one `focus` kernel
  a call of it); then `after(engine, node, api, base_url)` (a coroutine), if given, while the
  server still runs; `before(engine, base_url)`, if given, runs once the model is loaded
  and listed, before the warm-up. Returns the launch counts, the decode
  steps the batchers ran for the three requests (summed over the model contexts that
  served them: a request may name an adapter, `model@name`), the tokens each request streamed,
  each request's timing line, the profiles, the windowed launches, the page pool's
  occupancy once the requests are done (None without a pool), the served tokenizer's
  class, each request's prompt tokens and what `after` returned. (`device` and `model` let the same phase be rehearsed on the CPU
  with a small card.)"""
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.models.registry import build_full_shard
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention

  kernels = kernels or (flash_attention, flash_cached_attention)
  env = {"XOT_PAGED_KV": "0",
         "XOT_PREFILL_CHUNK": "1024",  # so the long prompt runs K2's T > 1 path
         **(env or {})}
  with phase_env(**env):
    args = port_main.build_parser().parse_args(
      ["--device", device, "--default-model", model, "--chatgpt-api-host", "127.0.0.1",
       "--chatgpt-api-port", "0", "--chatgpt-api-response-timeout", "600", *cli])
    if args.models_seed_dir:
      asyncio.run(port_main.seed_models(args.models_seed_dir))
    node, engine, classname, api = port_main.build_node(args)
    requests = requests or main_requests(model)
    # The request ids the node serves, in order, and the tokens it streams for each.
    served, tokens_of = [], {}
    serve_prompt = node.process_prompt

    async def traced(base_shard, prompt, request_id=None, *a, **kw):
      served.append(request_id)
      return await serve_prompt(base_shard, prompt, request_id, *a, **kw)
    node.process_prompt = traced
    node.on_token.register("chip-smoke-main").on_next(
      lambda rid, toks, finished: tokens_of.__setitem__(rid, list(toks)))

    async def drive():
      server = await api.start("127.0.0.1", 0)
      port = server.sockets[0].getsockname()[1]
      base = f"http://127.0.0.1:{port}"
      loop = asyncio.get_running_loop()
      try:
        t0 = time.perf_counter()
        await engine.ensure_shard(build_full_shard(model, classname))
        source = engine._ctx.model_dir or "random"
        print(f"[{tag}] {model} loaded ({source} {engine.dtype} weights, quantize={engine.quantize}, "
              f"kv_quant={engine.kv_quant}, on {device}) in {time.perf_counter() - t0:.1f} s", flush=True)
        health = await loop.run_in_executor(None, http_json, base + "/healthcheck")
        listed = await loop.run_in_executor(None, http_json, base + "/v1/models")
        if health.get("status") != "ok" or model not in [m["id"] for m in listed["data"]]:
          raise AssertionError(f"{tag}: healthcheck {health} / models {listed}")
        if before is not None:
          await before(engine, base)
        # Warm-up: each request once with 2 tokens, so the measured run below pays no
        # first-use costs (lazy CUDA module loading, cuBLAS heuristics per shape).
        t0 = time.perf_counter()
        for _, body in requests:
          warm = {**body, "max_tokens": 2, "stream": False}
          await loop.run_in_executor(None, http_json, base + "/v1/chat/completions", warm)
        print(f"[{tag}] warm-up: {len(requests)} requests in {time.perf_counter() - t0:.2f} s",
              flush=True)
        batchers = [c.batcher for c in engine._contexts.values() if c.batcher is not None]
        for batcher in batchers:
          batcher.dispatches = batcher.rows = batcher.steps = 0
        served.clear()
        for k in kernels:
          k.launches = k.windowed_launches = 0
        decoded = 0
        timings, prompt_tokens = [], []
        for label, body in requests:
          url = base + "/v1/chat/completions"
          t0 = time.perf_counter()
          if body.get("stream"):
            events, first, last = await loop.run_in_executor(None, http_stream, url, body)
            usage = events[-1].get("usage") or {}
            finish = [c["finish_reason"] for e in events for c in e.get("choices", [])
                      if c.get("finish_reason")]
            n = usage.get("completion_tokens", 0)
            rate = (n - 1) / (last - first) if n > 1 and last > first else float("nan")
            timing = f"TTFT {first * 1e3:.1f} ms, decode {rate:.1f} tok/s"
          else:
            resp = await loop.run_in_executor(None, http_json, url, body)
            usage = resp["usage"]
            n = usage["completion_tokens"]
            finish = [resp["choices"][0]["finish_reason"]]
            timing = f"end to end {(time.perf_counter() - t0) * 1e3:.1f} ms"
          timings.append(timing)
          prompt_tokens.append(usage.get("prompt_tokens", 0))
          want = body["max_tokens"]
          ok = n == want and finish == ["length"]
          print(f"[{tag}] {label}: {n} tokens, finish {finish}, {timing} ({card}) "
                f"{'ok' if ok else 'FAIL'}", flush=True)
          if not ok:
            raise AssertionError(f"{tag}: {label} returned {n} tokens ({finish}), wanted {want}")
          decoded += n - 1  # the first token comes from the prefill
        counts = {k.__name__: k.launches for k in kernels}
        windowed = {k.__name__: k.windowed_launches for k in kernels}
        steps = sum(b.steps for b in batchers)
        streamed = [tokens_of.get(rid, []) for rid in served]
        await wait_idle(engine, every_context=True)
        pool = engine.page_pool_stats()
        profiled = {}
        for b in profiles:
          profiled[b] = await profile_decode(torch, engine, model, classname, card, batch=b,
                                             tag=tag, focus=focus, wrapper=wrapper)
        extra = None if after is None else await after(engine, node, api, base)
        return (counts, decoded, steps, streamed, profiled, timings, windowed, pool, prompt_tokens,
                extra)
      finally:
        server.close()
        await server.wait_closed()
        await node.stop()

    try:
      (counts, decoded, steps, streamed, profiled, timings, windowed, pool,
       prompt_tokens, extra) = asyncio.run(drive())
    finally:
      engine.executor.shutdown(wait=True)
  print(f"[{tag}] launches: {counts} ({decoded} decoded tokens, {steps} decode steps)", flush=True)
  return {"launches": counts, "decoded": decoded, "steps": steps, "tokens": streamed,
          "profiles": profiled, "timings": timings, "windowed": windowed, "pool": pool,
          "tokenizer": type(engine.tokenizer).__name__, "prompt_tokens": prompt_tokens,
          "after": extra}


def quant_phases():
  """(format, knobs, kernel wrapper, what its kernels' names hold in the profile) of
  each quantized serving phase: int4 through K5, int4 with XOT_INT4_V=4 through K5v4,
  int8 with XOT_INT8_KERNEL=1 through K6 (each launches its one-row kernel,
  w4a16_kernel / w4a8_kernel / w8a8_kernel, at one row over K <= 4096, its cluster
  kernel otherwise)."""
  from xotorch_tpu_torch.ops.int4_matmul import int4_w4a8_matmul, int4_w4a16_matmul
  from xotorch_tpu_torch.ops.int8_matmul import int8_rowquant_matmul
  return (("int4", {}, int4_w4a16_matmul, "w4a16_"),
          ("int4", {"XOT_INT4_V": "4"}, int4_w4a8_matmul, "w4a8_"),
          ("int8", {"XOT_INT8_KERNEL": "1"}, int8_rowquant_matmul, "w8a8_"))


def drive_quantized(torch, card: str, fmt: str, env: dict, kernel, focus: str,
                    device: str = "cuda", model: str = "synthetic-llama-1b") -> dict:
  """A fresh server with XOT_QUANTIZE=`fmt` and `env` answers the main path's three
  requests; every decode step's 7 projections a layer go through `kernel`, so its
  launches must equal 7 x layers x the decode steps. Then B=1 and B=8 profiles, and
  /v1/perf's `{fmt}_weight_bytes` ceiling held to the server's own tensors' bytes
  (weight_bytes_held)."""
  from xotorch_tpu_torch.models.registry import get_model_card
  tag = f"{fmt} {kernel.__name__}" + (" XOT_INT4_V=4" if env.get("XOT_INT4_V") == "4" else "")

  async def held(engine, node, api, base):
    return await weight_bytes_held(engine, base, fmt, tag, card)
  run = drive_main_path(torch, card, device=device, model=model, kernels=(kernel,),
                        env={"XOT_QUANTIZE": fmt, **env}, tag=tag, profiles=(1, 8), focus=focus,
                        wrapper=kernel if device == "cuda" else None, after=held)
  layers = get_model_card(model)["layers"]
  launched, want = run["launches"][kernel.__name__], 7 * layers * run["steps"]
  ok = launched == want and run["steps"] >= run["decoded"]
  print(f"[{tag}] {kernel.__name__} launches {launched} = 7 projections x {layers} layers x "
        f"{run['steps']} decode steps ({want}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"{tag}: {launched} launches of {kernel.__name__}, wanted {want}")
  return run


def tensor_bytes(tree) -> int:
  """The nbytes of every tensor of a parameter tree (a packed int4 tensor counts its
  bytes), read from shapes and dtypes on the host."""
  if isinstance(tree, dict):
    return sum(tensor_bytes(v) for v in tree.values())
  if isinstance(tree, (list, tuple)):
    return sum(tensor_bytes(v) for v in tree)
  return tree.nbytes if hasattr(tree, "nbytes") else 0


async def weight_bytes_held(engine, base: str, fmt: str, tag: str, card: str) -> int:
  """/v1/perf's analytic `{fmt}_weight_bytes` ceiling (bf16 for fmt None) and its
  weight_bytes_predicted, against the nbytes of the parameters the server holds on the
  card: equal, exactly."""
  loop = asyncio.get_running_loop()
  perf = await loop.run_in_executor(None, http_json, base + "/v1/perf")
  label = fmt or "bf16"
  held = tensor_bytes(engine._ctx.params)
  got = perf["ceilings"][f"{label}_weight_bytes"]
  ok = got == held == perf["model"]["weight_bytes_predicted"] == perf["model"]["weight_bytes_actual"]
  print(f"[{tag}] /v1/perf ceilings.{label}_weight_bytes {got} against {held} bytes of parameters "
        f"on the card, {perf['ceilings'][f'{label}_tok_s']} tok/s ceiling at "
        f"{perf['ceilings']['hbm_gbps']} GB/s ({card}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"{tag}: {label}_weight_bytes {got}, parameters {held}, model {perf['model']}")
  return held


def drive_engine_alone(torch, card: str, env: dict, tag: str, focus: str = "",
                       model: str = "synthetic-llama-1b") -> dict:
  """The engine without a server, built under `env`: B=1 and B=8 profiles only."""
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  from xotorch_tpu_torch.models.registry import TORCH
  with phase_env(**env):
    engine = TorchShardInferenceEngine(device="cuda", seed=0)
    try:
      async def drive():
        return {b: await profile_decode(torch, engine, model, TORCH, card, batch=b, tag=tag,
                                        focus=focus) for b in (1, 8)}
      return asyncio.run(drive())
    finally:
      engine.executor.shutdown(wait=True)


def projection_host_us(torch, card: str) -> dict:
  """Host time of one decode projection (rows 1, synthetic-llama-1b's wk, 2048->512)
  through transformer._linear, by route: the microseconds the host takes to enqueue
  200 calls while the card sleeps (so it neither drains nor waits), per call."""
  from xotorch_tpu_torch.models.quantize import quantize_tensor, quantize_tensor_grouped
  from xotorch_tpu_torch.models.transformer import QuantRoute, _linear

  dev = torch.device("cuda")
  gen = torch.Generator(device=dev)
  gen.manual_seed(5)
  w = torch.randn(2048, 512, generator=gen, device=dev) * 0.02
  q8, s8 = quantize_tensor(w, 0)
  q4, s4 = quantize_tensor_grouped(w[None])
  h = torch.randn(1, 1, 2048, generator=gen, device=dev).to(torch.bfloat16)
  int4 = {"wk": q4[0], "wk_gscale": s4[0]}
  int8 = {"wk": q8, "wk_scale": s8}
  cases = {"bf16 (h @ w)": ({"wk": w.to(torch.bfloat16)}, QuantRoute()),
           "int4 K5": (int4, QuantRoute(int4_kernel=True)),
           "int4 K5v4": (int4, QuantRoute(int4_kernel=True, int4_variant=4)),
           "int8 K6": (int8, QuantRoute(int8_kernel=True)),
           "int8 default path": (int8, QuantRoute())}
  out = {}
  with torch.inference_mode():
    for label, (layer, route) in cases.items():
      best = float("inf")
      for _ in range(5):
        _linear(layer, "wk", h, route)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # ~25 ms of work ahead of the 200 calls
        t0 = time.perf_counter()
        for _ in range(200):
          _linear(layer, "wk", h, route)
        best = min(best, (time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
      out[label] = best
  print("[host] one decode projection's host time, best of 5 x 200 calls: "
        + ", ".join(f"{k} {v:.1f} us" for k, v in out.items())
        + f"; x112 a step: " + ", ".join(f"{k} {v * 112 / 1e3:.2f} ms" for k, v in out.items())
        + f" ({card})", flush=True)
  return out


def alternate_formats(torch, card: str, rounds: int = 4, n: int = 32,
                      model: str = "synthetic-llama-1b") -> dict:
  """The engine alone in each weight format, and with bf16 weights over an int8 KV
  cache, all resident at once, decoding `n`
  greedy tokens at B=1 after a 514-token prompt, the formats taking turns for
  `rounds` rounds, so that host drift over the call falls on every format alike.
  Returns each format's wall ms per step, round by round."""
  import numpy as np
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  from xotorch_tpu_torch.models.registry import TORCH, build_full_shard

  formats = {"bf16": {}, "int4 K5": {"XOT_QUANTIZE": "int4"},
             "int4 K5v4": {"XOT_QUANTIZE": "int4", "XOT_INT4_V": "4"},
             "int8 K6": {"XOT_QUANTIZE": "int8", "XOT_INT8_KERNEL": "1"},
             "int8 default path": {"XOT_QUANTIZE": "int8", "XOT_INT8_KERNEL": "0"},
             "bf16, int8 KV (K2q)": {"XOT_KV_QUANT": "int8"}}
  shard = build_full_shard(model, TORCH)
  engines = {}
  for label, env in formats.items():
    with phase_env(XOT_PAGED_KV="0", **env):
      engines[label] = TorchShardInferenceEngine(device="cuda", seed=0)

  async def drive():
    last, steps = {}, {label: [] for label in engines}
    for label, engine in engines.items():
      last[label], _ = await engine.infer_sample_tensor("alt", shard, np.ones((1, 514), np.int64),
                                                        temp=0.0, top_k=0)
      out = await engine.generate_chunk("alt", shard, int(last[label]), 8, temp=0.0)  # warm
      last[label] = int(np.asarray(out).reshape(-1)[-1])
    for _ in range(rounds):
      for label, engine in engines.items():
        t0 = time.perf_counter()
        out = await engine.generate_chunk("alt", shard, last[label], n, temp=0.0)
        steps[label].append((time.perf_counter() - t0) * 1e3 / n)
        last[label] = int(np.asarray(out).reshape(-1)[-1])
    for engine in engines.values():
      await engine.clear_request("alt")
    return steps

  try:
    steps = asyncio.run(drive())
  finally:
    for engine in engines.values():
      engine.executor.shutdown(wait=True)
  for label, ms in steps.items():
    print(f"[alternate] {label}: B=1 wall ms a step, {rounds} rounds of {n} taken in turn: "
          + ", ".join(f"{m:.2f}" for m in ms) + f"; median {sorted(ms)[len(ms) // 2]:.2f} ({card})",
          flush=True)
  return steps


CONCURRENT_WORDS = (64, 128, 256, 300, 514, 1000, 1502, 2000)


def drive_concurrent(torch, card: str, paged: bool, device: str = "cuda",
                     model: str = "synthetic-llama-1b", max_tokens: int = 64,
                     env=None, quant_kernel=None) -> dict:
  """A fresh server (XOT_PAGED_KV as `paged`, XOT_PREFILL_CHUNK 1024, and `env`, e.g.
  XOT_QUANTIZE, while it is built) answers eight concurrent streaming chat
  completions of 64 to 2000 words, half at temperature 0 and half at 0.6, after one
  unmeasured warm-up pass of the same eight. The batcher coalesces their decode
  chunks; with `quant_kernel` every decode step's 7 projections a layer must go
  through it. Then one B=8 decode chunk under the profiler. Returns the kernels'
  launch counts over the measured pass and each temperature-0 request's tokens."""
  from concurrent.futures import ThreadPoolExecutor
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.models.registry import build_full_shard, get_model_card
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention

  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention_int8
  from xotorch_tpu_torch.ops.paged_attention import (paged_decode_attention_int8,
                                                     paged_prefill_attention_int8)

  env = env or {}
  kv8 = env.get("XOT_KV_QUANT") == "int8"
  tag = (("paged" if paged else "contiguous") + (f" {env['XOT_QUANTIZE']}" if "XOT_QUANTIZE" in env else "")
         + (" int8-KV" if kv8 else ""))
  os.environ["XOT_PAGED_KV"] = "1" if paged else "0"
  os.environ["XOT_PREFILL_CHUNK"] = "1024"
  args = port_main.build_parser().parse_args(
    ["--device", device, "--default-model", model, "--chatgpt-api-host", "127.0.0.1",
     "--chatgpt-api-port", "0", "--chatgpt-api-response-timeout", "600"])
  with phase_env(**env):  # the engine reads its knobs when it is built
    node, engine, classname, api = port_main.build_node(args)
  layers = get_model_card(model)["layers"]
  bodies = [{"model": model, "max_tokens": max_tokens, "stream": True,
             "temperature": 0.0 if i % 2 == 0 else 0.6, "stream_options": {"include_usage": True},
             "messages": [{"role": "user", "content": " ".join(f"w{j % 97}" for j in range(n))}]}
            for i, n in enumerate(CONCURRENT_WORDS)]
  # The request id the API gives each prompt, and the tokens the node streams for it.
  prompt_of, tokens_of = {}, {}
  serve_prompt = node.process_prompt

  async def traced(base_shard, prompt, request_id=None, *a, **kw):
    prompt_of[request_id] = prompt
    return await serve_prompt(base_shard, prompt, request_id, *a, **kw)
  node.process_prompt = traced
  node.on_token.register("chip-smoke").on_next(
    lambda rid, toks, finished: tokens_of.__setitem__(rid, list(toks)))
  kernels = (flash_attention, flash_cached_attention, paged_decode_attention,
             paged_prefill_attention, flash_cached_attention_int8, paged_decode_attention_int8,
             paged_prefill_attention_int8) + ((quant_kernel,) if quant_kernel else ())
  # The attention kernels of this cache format, and the counters that must stay 0.
  own = "_int8" if kv8 else ""
  other = "" if kv8 else "_int8"

  async def drive():
    server = await api.start("127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}/v1/chat/completions"
    loop = asyncio.get_running_loop()
    pool = ThreadPoolExecutor(max_workers=len(bodies))
    try:
      await engine.ensure_shard(build_full_shard(model, classname))

      async def all_at_once(bs):
        return await asyncio.gather(*(loop.run_in_executor(pool, http_stream, url, b) for b in bs))

      t0 = time.perf_counter()
      await all_at_once([{**b, "max_tokens": 8} for b in bodies])
      print(f"[{tag}] warm-up: 8 concurrent requests in {time.perf_counter() - t0:.2f} s", flush=True)
      await wait_idle(engine)
      batcher = engine._ctx.batcher
      batcher.dispatches = batcher.rows = batcher.steps = 0
      if paged:
        engine._ctx.page_pool.peak_pages_in_use = engine._ctx.page_pool.pages_in_use
      prompt_of.clear()
      for k in kernels:
        k.launches = 0
      t0 = time.perf_counter()
      results = await all_at_once(bodies)
      wall = time.perf_counter() - t0
      counts = {k.__name__: k.launches for k in kernels}
      dispatches, rows, steps = batcher.dispatches, batcher.rows, batcher.steps
      total, segments = 0, 0
      for body, (events, first, last) in zip(bodies, results):
        usage = events[-1].get("usage") or {}
        finish = [c["finish_reason"] for e in events for c in e.get("choices", [])
                  if c.get("finish_reason")]
        n = usage.get("completion_tokens", 0)
        total += n
        segments += -(-usage.get("prompt_tokens", 0) // 1024)
        rate = (n - 1) / (last - first) if n > 1 and last > first else float("nan")
        ok = n == max_tokens and finish == ["length"]
        words = len(body["messages"][0]["content"].split())
        print(f"[{tag}] {words}-word prompt ({usage.get('prompt_tokens')} tokens), temperature "
              f"{body['temperature']}: {n} tokens, finish {finish}, TTFT {first * 1e3:.1f} ms, "
              f"decode {rate:.1f} tok/s ({card}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
          raise AssertionError(f"{tag}: {words}-word request returned {n} tokens ({finish})")
      await wait_idle(engine)
      stats = engine.page_pool_stats()
      print(f"[{tag}] 8 concurrent requests: {total} tokens in {wall:.3f} s = {total / wall:.1f} "
            f"tok/s aggregate; batcher {dispatches} dispatches, mean width {rows / dispatches:.2f}, "
            f"{steps} decode steps; launches {counts}; pool {stats} ({card})", flush=True)
      if rows / dispatches <= 1:
        raise AssertionError(f"{tag}: the batcher never coalesced (mean width {rows / dispatches})")
      idle = [n + other for n in ("flash_cached_attention", "paged_decode_attention",
                                  "paged_prefill_attention")]
      idle += (["flash_cached_attention" + own] if paged
               else ["paged_decode_attention" + own, "paged_prefill_attention" + own])
      if any(counts[n] for n in idle):
        raise AssertionError(f"{tag}: launches {counts}: {idle} should not run")
      if paged:
        k3, k4 = counts["paged_decode_attention" + own], counts["paged_prefill_attention" + own]
        if k3 != steps * layers or k4 != segments * layers:
          raise AssertionError(f"{tag}: launches {counts} disagree with {steps} decode steps and "
                               f"{segments} prefill segments x {layers} layers")
        if stats["pages_in_use"] != 0:
          raise AssertionError(f"{tag}: {stats['pages_in_use']} pool pages left in use")
      elif counts["flash_cached_attention" + own] < steps * layers:
        raise AssertionError(f"{tag}: launches {counts} disagree with {steps} decode steps")
      if quant_kernel and counts[quant_kernel.__name__] != 7 * layers * steps:
        raise AssertionError(f"{tag}: {quant_kernel.__name__} ran {counts[quant_kernel.__name__]} "
                             f"times, not 7 x {layers} layers x {steps} decode steps")
      bytes_per_token = None
      if paged:
        arena_pool = engine._ctx.page_pool
        bytes_per_token = (sum(t.numel() * t.element_size() for t in arena_pool.arena.values())
                           / (arena_pool.num_pages * arena_pool.page_size))
        print(f"[{tag}] page arena: {bytes_per_token:.0f} bytes per token over {layers} layers "
              f"({', '.join(f'{n} {t.dtype}' for n, t in arena_pool.arena.items())})", flush=True)
      profiled = await profile_decode(torch, engine, model, classname, card, batch=len(bodies))
      by_words = sorted(prompt_of, key=lambda rid: len(prompt_of[rid].split()))
      greedy = {CONCURRENT_WORDS[i]: tokens_of[rid] for i, rid in enumerate(by_words)
                if bodies[i]["temperature"] == 0.0}
      return counts, greedy, profiled, bytes_per_token
    finally:
      pool.shutdown(wait=True)
      server.close()
      await server.wait_closed()
      await node.stop()

  counts, greedy, profiled, bytes_per_token = asyncio.run(drive())
  engine.executor.shutdown(wait=True)
  return {"launches": counts, "greedy": greedy, "profile": profiled,
          "bytes_per_token": bytes_per_token}


async def wait_idle(engine, timeout: float = 30.0, every_context: bool = False) -> None:
  """Wait until the node's end-of-request cleanups have run on the engine (the
  client sees a stream end before its request's state is cleared): in the active
  context, or with `every_context` in each resident one."""
  t_end = time.perf_counter() + timeout
  while (any(c.states for c in (list(engine._contexts.values()) if every_context
                                else [engine._ctx]))
         and time.perf_counter() < t_end):
    await asyncio.sleep(0.05)
  await engine._run(lambda: None)


RING_IDS = ("ring-b", "ring-a")  # equal memories: the ring orders its peers by id,
                                 # descending, so ring-b holds the first half of the layers


def write_ring_config(path: str, ports: dict, caps: dict) -> None:
  """The manual discovery config that names the ring's peers, on 127.0.0.1."""
  with open(path, "w") as f:
    json.dump({"peers": {i: {"address": "127.0.0.1", "port": port, "device_capabilities": caps}
                         for i, port in ports.items()}}, f)


def greedy_streams_agree(tag: str, main_run: dict, streams: dict) -> None:
  """Every temperature-0 request's tokens, {main_requests index: tokens}, must equal the
  single-peer main path's for the same request."""
  for j, (label, body) in enumerate(main_requests("synthetic-llama-1b")):
    if body.get("temperature") != 0 or j not in streams:
      continue
    want, got = main_run["tokens"][j], streams[j]
    same = sum(a == b for a, b in zip(want, got))
    ok = got == want
    print(f"[{tag}] {label}: {same}/{len(want)} temperature-0 tokens equal the single-peer "
          f"main path's {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"{tag}: {label} streamed {got}, the main path {want}")


async def ring_observability(nodes: dict, engines: dict, base: str, rids: list, steps: int,
                             tag: str, card: str) -> dict:
  """The ring's observability, read at the API of the peer where the requests entered:
  every request's spans (from both peers, the sampler's flushed over the status bus)
  under one trace id; both peers fresh in /v1/cluster/metrics (each summary rides the
  topology cadence); each request's /v1/anatomy breakdown with its hop stages; and the
  split of a decode token into each peer's step (its engine's decode lane) and the
  breakdown's stages, per token. Returns the split."""
  loop = asyncio.get_running_loop()
  call = lambda fn, *a: loop.run_in_executor(None, fn, *a)  # noqa: E731
  t_end = time.perf_counter() + 15.0
  while True:
    cluster = await call(http_json, base + "/v1/cluster/metrics")
    fresh = {nid for nid, row in cluster["nodes"].items() if not row.get("stale")}
    anatomy = await call(http_json, base + "/v1/anatomy")
    if (fresh >= set(RING_IDS) and set(rids) <= set(anatomy["recent_requests"])) or time.perf_counter() > t_end:
      break
    await asyncio.sleep(0.25)
  spans = (await call(http_json, base + "/v1/traces"))["spans"]
  attr = lambda sp, key: next((a["value"] for a in sp["attributes"] if a["key"] == key), None)  # noqa: E731
  traces, peers = {}, {}
  for sp in spans:
    rid = attr(sp, "request.id")
    traces.setdefault(rid, set()).add(sp["traceId"])
    peers.setdefault(rid, set()).add(attr(sp, "node.id"))
  stages: dict = {}
  for rid in rids:
    b = await call(http_json, f"{base}/v1/anatomy?request_id={rid}")
    for name, row in b["stages"].items():
      stages[name] = stages.get(name, 0.0) + row["secs"]
  ok = (all(len(traces.get(rid, ())) == 1 and peers.get(rid) == set(RING_IDS) for rid in rids)
        and fresh >= set(RING_IDS) and any(k.startswith("hop:") for k in stages))
  print(f"[{tag}] traces: {[len(traces.get(rid, ())) for rid in rids]} trace id(s) a request over "
        f"peers {[sorted(peers.get(rid, ())) for rid in rids]}; /v1/cluster/metrics fresh peers "
        f"{sorted(fresh)}; anatomy for {sorted(set(rids) & set(anatomy['recent_requests']))} "
        f"{'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"{tag}: traces {traces}, peers {peers}, fresh {fresh}, stages {stages}")
  split = {f"step {i}": 1e3 * lane["secs"] / max(lane["dispatches"], 1)
           for i, e in engines.items() for lane in (e.perf.lanes().get("decode"),) if lane}
  split.update({f"stage {k}": 1e3 * v / max(steps, 1) for k, v in sorted(stages.items())})
  print(f"[{tag}] a decode token, ms: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f" (each peer's engine decode lane a dispatch; anatomy stages over the three requests / "
        f"{steps} decode steps) ({card})", flush=True)
  return split


def survival_switch(nodes: dict, on: bool) -> None:
  """The survivability knobs of live ring nodes on (the defaults the nodes were built
  with) or off (XOT_HOP_RETRIES, XOT_STALL_TIMEOUT_S and XOT_HEALTH_INTERVAL_S 0: no hop
  sequence ids or retries, no watchdog or health loop). The taps (one environment read a
  hop, one progress stamp a chunk) run either way."""
  from xotorch_tpu_torch.utils import knobs
  if on:
    os.environ.pop("XOT_HOP_RETRIES", None)
  else:
    os.environ["XOT_HOP_RETRIES"] = "0"
  for node in nodes.values():
    node.stall_timeout_s = knobs.get_float("XOT_STALL_TIMEOUT_S") if on else 0.0
    node.health_interval_s = knobs.get_float("XOT_HEALTH_INTERVAL_S") if on else 0.0
    for attr in ("_watchdog_task", "_health_task"):
      task = getattr(node, attr)
      if task is not None and not on:
        task.cancel()
        setattr(node, attr, None)
    if on:
      node.start_watchdog()
      node.start_health_monitor()


async def survival_taps(nodes: dict, serve, base, model: str, tag: str, card: str,
                        rounds: int = 4, calls: int = 20000) -> dict:
  """The idle-path cost of survivability on phase 10's ring: the host time of one hop's
  tap (faults.apply with no injector, and the sequence id hop_seq takes with retries on)
  and of one progress stamp (Node._note_progress), each over `calls` calls; then TPOT of
  the main path's first request with the knobs on and off (survival_switch), `rounds`
  rounds in turn."""
  from xotorch_tpu_torch.api.chatgpt_api import build_prompt
  from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer
  from xotorch_tpu_torch.networking import faults
  node = nodes[RING_IDS[0]]
  t0 = time.perf_counter()
  for _ in range(calls):
    await faults.apply("SendTensor", RING_IDS[1])
  tap_us = (time.perf_counter() - t0) / calls * 1e6
  t0 = time.perf_counter()
  for _ in range(calls):
    faults.hop_seq()
  seq_us = (time.perf_counter() - t0) / calls * 1e6
  t0 = time.perf_counter()
  for _ in range(calls):
    node._note_progress("taps-bench")
  stamp_us = (time.perf_counter() - t0) / calls * 1e6
  node.finish_request_state("taps-bench")
  label, body = main_requests(model)[0]
  prompt = build_prompt(DummyTokenizer(), body["messages"])
  tpot = {True: [], False: []}
  try:
    for r in range(rounds):
      for on in (True, False):
        survival_switch(nodes, on)
        out = await serve(node, base, prompt, f"taps-{r}-{int(on)}", body)
        n = len(out["tokens"])
        tpot[on].append((out["last"] - out["first"]) / max(n - 1, 1) * 1e3)
  finally:
    survival_switch(nodes, True)
  med = {on: sorted(v)[len(v) // 2] for on, v in tpot.items()}
  print(f"[{tag}] survivability taps on the host: faults.apply {tap_us:.2f} us a call (no injector), "
        f"hop_seq {seq_us:.2f} us, a progress stamp {stamp_us:.2f} us; TPOT of \"{label}\" with the "
        f"knobs on {med[True]:.3f} ms, off {med[False]:.3f} ms (median of {rounds} rounds in turn; "
        f"on {[round(x, 3) for x in tpot[True]]}, off {[round(x, 3) for x in tpot[False]]}) ({card})",
        flush=True)
  return {"tap_us": tap_us, "seq_us": seq_us, "stamp_us": stamp_us, "tpot_on_ms": med[True],
          "tpot_off_ms": med[False]}


def drive_ring_inprocess(torch, card: str, main_run: dict, device: str = "cuda",
                         model: str = "synthetic-llama-1b") -> dict:
  """Phase 10: two Nodes in this process, each with its own engine on `device`, built by
  main.build_node with manual discovery and linked by the TCP transport on 127.0.0.1,
  serve `model` split in two. The main path's three requests enter at the owner of
  layer 0 through process_prompt. Holds K1's and K2's launches to the main path's
  formulas summed over both engines (K1 = layers x fresh prefills, K2 = layers x
  (decode steps + segments at pos > 0)), every hidden-state hop to bf16 at 2 x T x
  hidden bytes, and the temperature-0 streams to the main path's; then the ring's
  observability at the entry peer's API (ring_observability). Returns the hop and wire
  figures."""
  import tempfile
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.api.chatgpt_api import build_prompt
  from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer
  from xotorch_tpu_torch.models.registry import build_base_shard
  from xotorch_tpu_torch.networking.tcp import peer_handle as tcp_peer_handle
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  from xotorch_tpu_torch.topology.device_capabilities import device_capabilities_sync
  from xotorch_tpu_torch.utils.helpers import find_available_port

  tag = "ring, 1 process"
  kernels = (flash_attention, flash_cached_attention)
  hops = []  # (the tensor's descriptor, frame bytes on the wire) of every SendTensor
  real_encode = tcp_peer_handle.encode_message

  def recording(fields, tensors=None):
    frame = real_encode(fields, tensors)
    if fields.get("rpc") == "SendTensor":
      header_len = int.from_bytes(frame[4:8], "big")
      hops.append((json.loads(frame[8:8 + header_len])["tensors"]["tensor"], 4 + len(frame)))
    return frame

  with phase_env(XOT_PAGED_KV="0", XOT_PREFILL_CHUNK="1024"), tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "ring.json")
    ports = {i: find_available_port("127.0.0.1") for i in RING_IDS}
    write_ring_config(path, ports, device_capabilities_sync().to_dict())
    built = {}
    for i in RING_IDS:
      args = port_main.build_parser().parse_args(
        ["--device", device, "--default-model", model, "--node-id", i, "--node-host", "127.0.0.1",
         "--node-port", str(ports[i]), "--discovery-module", "manual",
         "--discovery-config-path", path])
      built[i] = port_main.build_node(args)
    nodes = {i: b[0] for i, b in built.items()}
    engines = {i: b[1] for i, b in built.items()}
    classname = built[RING_IDS[0]][2]
    tokenizer = DummyTokenizer()

    async def serve(node, base, prompt: str, rid: str, body: dict) -> dict:
      done = asyncio.Event()
      out = {"tokens": [], "first": None, "last": None}
      t0 = time.perf_counter()

      def on_token(r, toks, finished):
        if r != rid:
          return
        out["tokens"] = list(toks)
        if toks and out["first"] is None:
          out["first"] = time.perf_counter() - t0
        if finished:
          out["last"] = time.perf_counter() - t0
          done.set()
      node.on_token.register(rid).on_next(on_token)
      await node.process_prompt(base, prompt, rid, max_tokens=body["max_tokens"],
                                temperature=body.get("temperature"))
      await asyncio.wait_for(done.wait(), 600)
      node.on_token.deregister(rid)
      error = node.request_errors.pop(rid, None)
      if error is not None:
        raise AssertionError(f"{tag}: request {rid} failed: {error}")
      return out

    async def drive():
      server = await built[RING_IDS[0]][3].start("127.0.0.1", 0)
      obs_base = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"
      try:
        t0 = time.perf_counter()
        await asyncio.wait_for(asyncio.gather(*(n.start(wait_for_peers=1) for n in nodes.values())), 120)
        base = build_base_shard(model, classname)
        layers = {i: nodes[i].get_current_shard(base) for i in RING_IDS}
        half = base.n_layers // 2
        if [(s.start_layer, s.end_layer) for s in layers.values()] != [(0, half - 1), (half, base.n_layers - 1)]:
          raise AssertionError(f"{tag}: layers {layers}")
        await asyncio.gather(*(engines[i].ensure_shard(layers[i]) for i in RING_IDS))
        print(f"[{tag}] {RING_IDS[0]} layers 0-{half - 1}, {RING_IDS[1]} layers {half}-"
              f"{base.n_layers - 1} on {device}, started and loaded in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        before = {i: port_main.wire_counts(nodes[i]) for i in RING_IDS}
        hops.clear()
        for k in kernels:
          k.launches = 0
        runs, fresh, segments, steps = [], 0, 0, 0
        for j, (label, body) in enumerate(main_requests(model)):
          prompt = build_prompt(tokenizer, body["messages"])
          out = await serve(nodes[RING_IDS[0]], base, prompt, f"ring-inprocess-{j}", body)
          fresh += 1
          segments += (len(tokenizer.encode(prompt)) - 1) // 1024
          steps += len(out["tokens"]) - 1
          runs.append((label, body, out))
        counts = {k.__name__: k.launches for k in kernels}
        wire = {}
        for i in RING_IDS:
          for method, row in port_main.wire_counts(nodes[i]).items():
            was = before[i].get(method, [0, 0, 0])
            acc = wire.setdefault(method, [0, 0, 0])
            for c in range(3):
              acc[c] += row[c] - was[c]
        hop_s = sorted(s for n in nodes.values() for p in n.peers for m, s in p.hop_seconds
                       if m == "SendTensor")
        await ring_observability(nodes, engines, obs_base,
                                 [f"ring-inprocess-{j}" for j in range(len(runs))], steps, tag, card)
        recorded = len(hops)
        await survival_taps(nodes, serve, base, model, tag, card)
        del hops[recorded:]  # the checks below read the main path's hops only
        return runs, counts, fresh, segments, steps, wire, hop_s, base.n_layers, engines[RING_IDS[0]].cfg.hidden_size
      finally:
        server.close()
        for n in nodes.values():
          await n.stop()

    tcp_peer_handle.encode_message = recording
    try:
      runs, counts, fresh, segments, steps, wire, hop_s, n_layers, hidden = asyncio.run(drive())
    finally:
      tcp_peer_handle.encode_message = real_encode
      for e in engines.values():
        e.executor.shutdown(wait=True)

  streams, tpots = {}, {}
  for j, (label, body, out) in enumerate(runs):
    n = len(out["tokens"])
    rate = (n - 1) / (out["last"] - out["first"]) if n > 1 else float("nan")
    tpots[j] = 1e3 / rate
    ok = n == body["max_tokens"]
    print(f"[{tag}] {label}: {n} tokens, TTFT {out['first'] * 1e3:.1f} ms, decode {rate:.1f} tok/s "
          f"(main path: {main_run['timings'][j]}) ({card}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"{tag}: {label} returned {n} tokens, wanted {body['max_tokens']}")
    streams[j] = out["tokens"]
  greedy_streams_agree(tag, main_run, streams)
  want = {"flash_attention": n_layers * fresh, "flash_cached_attention": n_layers * (steps + segments)}
  ok = counts == want
  print(f"[{tag}] launches over both engines {counts}: K1 = {n_layers} layers x {fresh} fresh "
        f"prefills, K2 = {n_layers} x ({steps} decode steps + {segments} segment at pos > 0) "
        f"({want}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"{tag}: launches {counts}, wanted {want}")
  hidden_hops = [(d, b) for d, b in hops if len(d["shape"]) == 3]
  bad = [d for d, _ in hidden_hops
         if d["dtype"] != "bfloat16" or d["nbytes"] != 2 * d["shape"][1] * hidden or d["shape"][0] != 1]
  prefill = [(d, b) for d, b in hidden_hops if d["shape"][1] > 1]
  decode = [(d, b) for d, b in hops if d["shape"][1] == 1]
  ok = not bad and len(prefill) == fresh and len(decode) == 2 * steps
  print(f"[{tag}] hidden-state hops: {len(hidden_hops)}, every one bfloat16 at 2 x T x {hidden} "
        f"bytes ({len(prefill)} prefill hops of {', '.join(str(d['shape'][1]) for d, _ in prefill)} "
        f"positions, {len(decode)} decode-step hops for {steps} steps: hidden state and token) "
        f"{'ok' if ok and not bad else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"{tag}: hops {bad or [d for d, _ in hops]}")
  tokens = steps + fresh
  calls = {m: row[0] for m, row in wire.items() if row[0]}
  decode_bytes = sum(b for _, b in decode)
  result_bytes = wire.get("SendResult", [0, 0, 0])[1]
  acks = sum(wire[m][2] for m in ("SendTensor", "SendResult") if m in wire)
  figures = {
    "hops_per_step": len(decode) / max(steps, 1),
    "hop_bytes_per_step": decode_bytes / max(steps, 1),
    "results_per_token": calls.get("SendResult", 0) / tokens,
    "result_bytes_per_token": result_bytes / tokens,
    "ack_bytes_per_step": acks / max(steps, 1),
    "hop_ms_median": 1e3 * hop_s[len(hop_s) // 2] if hop_s else float("nan"),
    "hop_ms_max": 1e3 * hop_s[-1] if hop_s else float("nan"),
    "tpot_ms": tpots,
  }
  print(f"[{tag}] wire a decode step: {figures['hops_per_step']:.2f} SendTensor frames, "
        f"{figures['hop_bytes_per_step']:.0f} bytes; a sampled token: "
        f"{figures['results_per_token']:.2f} SendResult frames, "
        f"{figures['result_bytes_per_token']:.0f} bytes; acks {figures['ack_bytes_per_step']:.0f} "
        f"bytes a step; SendTensor to ack median {figures['hop_ms_median']:.3f} ms, max "
        f"{figures['hop_ms_max']:.3f} ms (the prefill hops); calls {calls} ({card})", flush=True)
  return figures


RING_FUSED_NODES = (2, 3)  # synthetic-llama-1b's 16 layers over 2 Nodes, then 3
RING_CONCURRENT_WORDS = (200, 300, 400, 500)  # four streams at once on the 2-Node ring
RING_SPEC_NEW = 64  # tokens of the ring's speculative request


async def ring_tie_check(torch, segs: list, ids: list, a: int, b: int) -> tuple:
  """tie_check through a ring: `ids` from position 0 through every segment's layers
  ([(engine, shard)] in ring order, K1 in each), the last segment's fp32 logits at the last
  position. Returns (tie, |l[a] - l[b]|, the bound)."""
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache
  last = segs[-1][0]

  def body():
    h = torch.tensor([ids], dtype=torch.int64, device=last.device)
    for i, (eng, shard) in enumerate(segs):
      ctx = eng._contexts[shard]
      cache = init_kv_cache(ctx.cfg, shard.get_layer_count(), 1, len(ids), eng.dtype, eng.device)
      h, _ = forward_shard(ctx.params, h, cache, 0, ctx.cfg, i == 0, shard.is_last_layer,
                           use_flash=True, start_layer=shard.start_layer, route=eng.quant_route)
    return h[0, -1].float().cpu()
  with launches_kept():
    row = await last._run(body)
  gap, limit = abs(float(row[a] - row[b])), TIE_REL * float(row.abs().max())
  return gap <= limit, gap, limit


def drive_ring_fused(torch, card: str, main_run: dict, per_token: dict, device: str = "cuda",
                     model: str = "synthetic-llama-1b") -> dict:
  """Phase 10 (c): the fused in-process ring. Two, then three Nodes in this process, each
  with its own engine on `device`, linked by InProcessPeerHandle, serve `model` split
  8/8, then three ways, with the default decode chunk (XOT_DECODE_CHUNK 8, doubling to
  64): the last partition decodes the whole chain as replays of one captured composite
  step (the engine's generate_chunk_ring), hidden states cross on the device. The main
  path's three requests: temperature-0 streams equal to phase 5's, no per-token decode
  hop, K1 = layers x fresh prefills and K2 = layers x (fused steps dispatched + segments
  at pos > 0) summed over the engines, no hidden state copied to the host, no decline;
  TPOT fused against the per-token ring of phase 10 (a) in this call; the chunks run
  ahead and how they resolved. On the 2-Node ring: four concurrent streams coalesce into
  batched fused dispatches (mean width printed), then a prompt-lookup speculative request
  (XOT_SPECULATE 8, phase 18's repeat-heavy prompt) through verify_draft_ring against the
  plain stream: equal, or parting first at a near tie within 2^-6. Returns the figures."""
  from xotorch_tpu_torch.api.chatgpt_api import build_prompt
  from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  from xotorch_tpu_torch.models.registry import build_base_shard
  from xotorch_tpu_torch.networking.inprocess import InProcessPeerHandle
  from xotorch_tpu_torch.orchestration.node import Node
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  from xotorch_tpu_torch.topology.device_capabilities import device_capabilities_sync
  from xotorch_tpu_torch.topology.partitioning import RingMemoryWeightedPartitioningStrategy

  t_phase = time.perf_counter()
  kernels = (flash_attention, flash_cached_attention)
  tokenizer = DummyTokenizer()
  caps = device_capabilities_sync()
  figures = {}

  def build(n_nodes: int):
    ids = [f"ring-{chr(ord('a') + i)}" for i in range(n_nodes)]
    engines = {i: TorchShardInferenceEngine(device=device) for i in ids}
    nodes = {i: Node(i, None, engines[i], None, RingMemoryWeightedPartitioningStrategy(),
                     default_sample_temp=0.6) for i in ids}
    for node in nodes.values():
      node.device_capabilities = caps
      for other in ids:
        node.topology.update_node(other, caps)
      node.peers = [InProcessPeerHandle(o) for o in nodes.values() if o is not node]
    return nodes, engines

  async def serve(node, base, prompt: str, rid: str, max_tokens: int, temperature) -> dict:
    done = asyncio.Event()
    out = {"tokens": [], "first": None, "last": None}
    t0 = time.perf_counter()

    def on_token(r, toks, finished):
      if r != rid:
        return
      out["tokens"] = list(toks)
      if toks and out["first"] is None:
        out["first"] = time.perf_counter() - t0
      if finished:
        out["last"] = time.perf_counter() - t0
        done.set()
    node.on_token.register(rid).on_next(on_token)
    await node.process_prompt(base, prompt, rid, max_tokens=max_tokens, temperature=temperature)
    await asyncio.wait_for(done.wait(), 600)
    node.on_token.deregister(rid)
    error = node.request_errors.pop(rid, None)
    if error is not None:
      raise AssertionError(f"ring fused: request {rid} failed: {error}")
    return out

  def tpot(out) -> float:
    n = len(out["tokens"])
    return 1e3 * (out["last"] - out["first"]) / (n - 1) if n > 1 else float("nan")

  async def drive(n_nodes: int) -> dict:
    tag = f"ring fused, {n_nodes} nodes"
    nodes, engines = build(n_nodes)
    t0 = time.perf_counter()
    try:
      first = next(iter(nodes.values()))
      base = build_base_shard(model, "TorchShardInferenceEngine")
      order = [p.node_id for p in first.partitioning_strategy.partition(first.topology)]
      shards = {i: nodes[i].get_current_shard(base) for i in order}
      await asyncio.gather(*(engines[i].ensure_shard(shards[i]) for i in order))
      entry, driver = nodes[order[0]], engines[order[-1]]
      split = "/".join(str(shards[i].get_layer_count()) for i in order)
      print(f"[{tag}] layers {split} ({', '.join(f'{i} {shards[i].start_layer}-{shards[i].end_layer}' for i in order)}) "
            f"on {device}, loaded in {time.perf_counter() - t0:.1f} s", flush=True)
      token_hops = []
      for node in nodes.values():
        real = node.process_tensor

        async def spy(base_shard, tensor, request_id=None, inference_state=None, _real=real):
          if getattr(tensor, "ndim", 0) == 2:
            token_hops.append(request_id)
          return await _real(base_shard, tensor, request_id, inference_state)
        node.process_tensor = spy
      dispatched = [0]
      for eng in engines.values():
        real_dispatch = eng._ring_dispatch

        def counted(members, toks_in, num_tokens, *a, _real=real_dispatch):
          dispatched[0] += num_tokens
          return _real(members, toks_in, num_tokens, *a)
        eng._ring_dispatch = counted
      for k in kernels:
        k.launches = 0
      runs, fresh, segments = [], 0, 0
      for j, (label, body) in enumerate(main_requests(model)):
        prompt = build_prompt(tokenizer, body["messages"])
        out = await serve(entry, base, prompt, f"fused-{n_nodes}-{j}", body["max_tokens"],
                          body.get("temperature"))
        fresh += 1
        segments += (len(tokenizer.encode(prompt)) - 1) // 1024
        runs.append((label, body, out))
      for e in engines.values():
        await wait_idle(e)
      counts = {k.__name__: k.launches for k in kernels}
      layers = base.n_layers
      decoded = sum(len(out["tokens"]) - 1 for _, _, out in runs)
      streams = {}
      for j, (label, body, out) in enumerate(runs):
        n = len(out["tokens"])
        was = per_token["tpot_ms"].get(j, float("nan"))
        ok = n == body["max_tokens"]
        print(f"[{tag}] {label}: {n} tokens, TTFT {out['first'] * 1e3:.1f} ms, TPOT {tpot(out):.3f} ms "
              f"fused against {was:.3f} ms on phase 10's per-token ring (x{was / tpot(out):.1f}) "
              f"({card}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
          raise AssertionError(f"{tag}: {label} returned {n} tokens")
        streams[j] = out["tokens"]
      greedy_streams_agree(tag, main_run, streams)
      want = {"flash_attention": layers * fresh,
              "flash_cached_attention": layers * (dispatched[0] + segments)}
      stats = driver.ring_stats()
      declines = {**stats["declines"]}
      for node in nodes.values():
        for reason, n in node.ring_declines.items():
          declines[reason] = declines.get(reason, 0) + n
      host_bytes = sum(e.host_hop_bytes for e in engines.values())
      device_hops = sum(e.device_hops for e in engines.values())
      ok = (counts == want and dispatched[0] >= decoded and not token_hops and host_bytes == 0
            and not declines and device_hops == fresh * (n_nodes - 1))
      print(f"[{tag}] launches over the engines {counts}: K1 = {layers} x {fresh} fresh prefills, "
            f"K2 = {layers} x ({dispatched[0]} fused steps dispatched for {decoded} decoded + "
            f"{segments} segment at pos > 0) ({want}); {stats['chunks']} fused chunks, overlap "
            f"hits {stats['overlap_hits']} misses {stats['overlap_misses']}; per-token decode hops "
            f"{len(token_hops)}; hidden-state hops kept on the device {device_hops}, hop bytes "
            f"copied to the host {host_bytes}; declines {declines} {'ok' if ok else 'FAIL'}",
            flush=True)
      if not ok:
        raise AssertionError(f"{tag}: launches {counts} (want {want}), dispatched {dispatched[0]} "
                             f"for {decoded}, token hops {len(token_hops)}, host bytes {host_bytes}, "
                             f"device hops {device_hops}, declines {declines}")
      result = {"tpot_ms": {j: tpot(out) for j, (_, _, out) in enumerate(runs)},
                "launches": counts, "overlap": (stats["overlap_hits"], stats["overlap_misses"])}
      if n_nodes == 2:
        result.update(await concurrent_and_spec(tag, nodes, engines, order, shards, base, entry,
                                                driver))
      return result
    finally:
      for e in engines.values():
        e.executor.shutdown(wait=True)

  async def concurrent_and_spec(tag, nodes, engines, order, shards, base, entry, driver) -> dict:
    before = (driver._ring_batch_dispatches, driver._ring_batch_rows)
    t0 = time.perf_counter()
    words = lambda n, off: " ".join(f"w{(i + off) % 97}" for i in range(n))
    outs = await asyncio.gather(*(
      serve(entry, base, build_prompt(tokenizer, [{"role": "user", "content": words(n, 7 * k)}]),
            f"fused-conc-{k}", 64, 0.0) for k, n in enumerate(RING_CONCURRENT_WORDS)))
    secs = time.perf_counter() - t0
    dispatches = driver._ring_batch_dispatches - before[0]
    rows = driver._ring_batch_rows - before[1]
    width = rows / max(dispatches, 1)
    total = sum(len(o["tokens"]) for o in outs)
    ok = dispatches > 0 and width > 1 and all(len(o["tokens"]) == 64 for o in outs)
    print(f"[{tag}] {len(outs)} concurrent streams: {dispatches} batched fused dispatches, mean "
          f"width {width:.2f} rows; {total} tokens in {secs:.2f} s = {total / secs:.1f} tok/s "
          f"aggregate; TPOT {', '.join(f'{tpot(o):.3f}' for o in outs)} ms ({card}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"{tag}: concurrent streams did not coalesce ({dispatches} dispatches, "
                           f"width {width})")
    for e in engines.values():
      await wait_idle(e)
    # Prompt lookup over the ring: exact ids through the id tokenizer.
    ids_tok = id_tokenizer()
    for i in order:
      engines[i]._contexts[shards[i]].tokenizer = ids_tok
    phrase, times = DECODE_SIZES[model]["repeat"]
    vocab = engines[order[0]]._contexts[shards[order[0]]].cfg.vocab_size
    ids = kv_ids(95, phrase, vocab) * times
    runs = {}
    for spec in (0, SPEC_K):
      for node in nodes.values():
        node.speculate_tokens = spec
      proposed, accepted = driver._spec_proposed, driver._spec_accepted
      toks, ms = await node_stream(entry, model, ids, RING_SPEC_NEW, f"fused-spec-{spec}")
      for e in engines.values():
        await wait_idle(e)
      runs[spec] = (toks, ms, driver._spec_proposed - proposed, driver._spec_accepted - accepted)
    for node in nodes.values():
      node.speculate_tokens = 0
    (plain, plain_ms, _, _), (got, spec_ms, drafted, taken) = runs[0], runs[SPEC_K]
    segs = [(engines[i], shards[i]) for i in order]
    first_diff = next((k for k in range(min(len(plain), len(got))) if plain[k] != got[k]), None)
    verdict = "identical"
    if first_diff is not None:
      tie, gap, limit = await ring_tie_check(torch, segs, ids + plain[:first_diff],
                                             plain[first_diff], got[first_diff])
      verdict = (f"first divergence at {first_diff}: logit gap {gap:.4g} against the near-tie "
                 f"bound {limit:.4g} ({'a near tie' if tie else 'NOT a tie'})")
    ok = drafted > 0 and len(got) == RING_SPEC_NEW and (first_diff is None or tie)
    print(f"[{tag}] prompt lookup over the ring (XOT_SPECULATE {SPEC_K}, {len(ids)} prompt tokens): "
          f"{taken}/{drafted} drafted tokens accepted through verify_draft_ring; TPOT {spec_ms:.3f} ms "
          f"on, {plain_ms:.3f} ms off; streams {verdict} ({card}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
      raise AssertionError(f"{tag}: speculation drafted {drafted}, stream {verdict}")
    return {"width": width, "spec": (drafted, taken, spec_ms, plain_ms)}

  with phase_env(XOT_PAGED_KV="0", XOT_PREFILL_CHUNK="1024"):
    for n_nodes in RING_FUSED_NODES:
      figures[n_nodes] = asyncio.run(drive(n_nodes))
      gc.collect()
      torch.cuda.empty_cache() if device == "cuda" else None
  print(f"[time] phase 10 (c), the fused ring: {time.perf_counter() - t_phase:.1f} s", flush=True)
  return figures


def drive_ring_processes(torch, card: str, main_run: dict, device: str = "cuda",
                         model: str = "synthetic-llama-1b", timeout: float = 240.0) -> dict:
  """Phase 11: two `python -m xotorch_tpu_torch.main` peers, each its own process with
  its own CUDA context, found by manual discovery over one config naming both, with
  their own node and API ports and --wait-for-peers 1. The main path's three requests
  go to the API of the peer that holds the last layers (so each prompt is forwarded
  to the owner of layer 0) and the first one also to the other peer's API. The
  temperature-0 streams must equal the main path's: the sampler peer runs at DEBUG=2,
  which logs each sampled token with its request id (so its rates include that log
  line a token), the other at DEBUG=1; each reports its TCP traffic at shutdown. Both children are stopped with SIGTERM and must exit 0; none is left."""
  import signal
  import re
  import tempfile
  from xotorch_tpu_torch.topology.device_capabilities import device_capabilities_sync
  from xotorch_tpu_torch.utils.helpers import find_available_port

  tag = "ring, 2 processes"
  requests = main_requests(model)
  procs, logs, texts = {}, {}, {}
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "ring.json")
    node_ports = {i: find_available_port("127.0.0.1") for i in RING_IDS}
    api_ports = {i: find_available_port("127.0.0.1") for i in RING_IDS}
    write_ring_config(path, node_ports, device_capabilities_sync().to_dict())
    env = {**os.environ, "XOT_PAGED_KV": "0", "XOT_PREFILL_CHUNK": "1024", "PYTHONUNBUFFERED": "1"}
    bases = {i: f"http://127.0.0.1:{api_ports[i]}" for i in RING_IDS}
    results = []
    try:
      t0 = time.perf_counter()
      for i in RING_IDS:
        logs[i] = os.path.join(tmp, f"{i}.log")
        cmd = [sys.executable, "-m", "xotorch_tpu_torch.main", "--device", device,
               "--default-model", model, "--node-id", i, "--node-host", "127.0.0.1",
               "--node-port", str(node_ports[i]), "--chatgpt-api-host", "127.0.0.1",
               "--chatgpt-api-port", str(api_ports[i]), "--chatgpt-api-response-timeout", "600",
               "--discovery-module", "manual", "--discovery-config-path", path,
               "--wait-for-peers", "1"]
        with open(logs[i], "w") as log:
          debug = "2" if i == RING_IDS[1] else "1"
          procs[i] = subprocess.Popen(cmd, cwd=ROOT, env={**env, "DEBUG": debug}, stdout=log,
                                      stderr=subprocess.STDOUT)
      pending = set(RING_IDS)
      while pending:
        for i in sorted(pending):
          if procs[i].poll() is not None:
            raise AssertionError(f"{tag}: {i} exited {procs[i].returncode} while starting")
          try:
            if http_json(bases[i] + "/healthcheck", timeout=5).get("status") == "ok":
              pending.discard(i)
          except OSError:
            pass
        if time.perf_counter() - t0 > timeout:
          raise AssertionError(f"{tag}: {sorted(pending)} not serving after {timeout:.0f} s")
        time.sleep(0.25)
      print(f"[{tag}] both peers serving in {time.perf_counter() - t0:.1f} s", flush=True)
      url = bases[RING_IDS[1]] + "/v1/chat/completions"
      for _, body in requests:  # first-use costs out of the measured run, as on the main path
        http_json(url, {**body, "max_tokens": 2, "stream": False})
      plan = [(RING_IDS[1], j) for j in range(len(requests))] + [(RING_IDS[0], 0)]
      for target, j in plan:
        label, body = requests[j]
        url = bases[target] + "/v1/chat/completions"
        t1 = time.perf_counter()
        if body.get("stream"):
          events, first, last = http_stream(url, body)
          rid = events[0]["id"][len("chatcmpl-"):]
          n = (events[-1].get("usage") or {}).get("completion_tokens", 0)
          rate = (n - 1) / (last - first) if n > 1 and last > first else float("nan")
          timing = f"TTFT {first * 1e3:.1f} ms, decode {rate:.1f} tok/s"
        else:
          resp = http_json(url, body)
          rid = resp["id"][len("chatcmpl-"):]
          n = resp["usage"]["completion_tokens"]
          timing = f"end to end {(time.perf_counter() - t1) * 1e3:.1f} ms"
        results.append((target, j, rid, n, timing))
    finally:
      for p in procs.values():
        if p.poll() is None:
          p.send_signal(signal.SIGTERM)
      for p in procs.values():
        try:
          p.wait(timeout=60)
        except subprocess.TimeoutExpired:
          p.kill()
          p.wait(timeout=60)
      for i, log in logs.items():
        with open(log) as f:
          texts[i] = f.read()
  alive = [i for i, p in procs.items() if p.poll() is None]
  codes = {i: p.returncode for i, p in procs.items()}
  ok = not alive and all(c == 0 for c in codes.values())
  print(f"[{tag}] children stopped: exit codes {codes}, none left {'ok' if ok else 'FAIL'}",
        flush=True)
  if not ok:
    tails = "\n".join(f"--- {i}\n{t[-3000:]}" for i, t in texts.items())
    raise AssertionError(f"{tag}: children left {alive}, exit codes {codes}\n{tails}")
  # The sampler peer (the last layers) logs "[<request id>] token <id> (<n> so far)".
  tokens_of = {}
  for rid, tok in re.findall(r"^\[([0-9a-f-]+)\] token (\d+) \(\d+ so far\)$", texts[RING_IDS[1]], re.M):
    tokens_of.setdefault(rid, []).append(int(tok))
  for target, j, rid, n, timing in results:
    label, body = requests[j]
    got = tokens_of.get(rid, [])
    ok = n == body["max_tokens"] == len(got)
    print(f"[{tag}] {label} into {target}'s API: {n} tokens, {timing} (main path: "
          f"{main_run['timings'][j]}) ({card}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"{tag}: {label} into {target}: {n} tokens, {len(got)} logged\n"
                           f"{texts[RING_IDS[1]][-3000:]}")
    if body.get("temperature") == 0:
      greedy_streams_agree(f"{tag}, into {target}", main_run, {j: got})
  wire = {}
  for i, text in texts.items():
    found = re.findall(r"^wire (\S+): (\{.*\})$", text, re.M)
    if not found:
      raise AssertionError(f"{tag}: {i} reported no wire counts")
    wire[i] = json.loads(found[-1][1])
  prompts = len(requests) + len(plan)
  steps = sum(n - 1 for *_, n, _ in results) + len(requests)  # the warm-up's 2 tokens: one step each
  sent = sum(row[0] for w in wire.values() for m, row in w.items() if m == "SendTensor")
  print(f"[{tag}] over both children's lives: {sent} SendTensor frames for {prompts} prompts "
        f"and {steps} decode steps = {(sent - prompts) / max(steps, 1):.2f} a step; wire "
        f"{json.dumps(wire)} ({card})", flush=True)
  return {"wire": wire}


# gemma-2-2b (google/gemma-2-2b, its published config.json): the family that puts the
# windowed, softcapped kernels and head_dim 256 on a serving path.
GEMMA_CONFIG = {
  "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2", "attention_bias": False,
  "attention_dropout": 0.0, "attn_logit_softcapping": 50.0, "bos_token_id": 2,
  "cache_implementation": "hybrid", "eos_token_id": 1, "final_logit_softcapping": 30.0,
  "head_dim": 256, "hidden_act": "gelu_pytorch_tanh", "hidden_activation": "gelu_pytorch_tanh",
  "hidden_size": 2304, "initializer_range": 0.02, "intermediate_size": 9216,
  "max_position_embeddings": 8192, "num_attention_heads": 8, "num_hidden_layers": 26,
  "num_key_value_heads": 4, "pad_token_id": 0, "query_pre_attn_scalar": 256,
  "rms_norm_eps": 1e-06, "rope_theta": 10000.0, "sliding_window": 4096,
  "torch_dtype": "float32", "use_cache": True, "vocab_size": 256000,
}
GEMMA_CARD = "gemma2-2b"  # its registry card; the repo directory is google--gemma-2-2b-it
GEMMA_WINDOW, GEMMA_SOFTCAP = 4096, 50.0
# The kernel cases at gemma-2-2b's attention widths and scale (query_pre_attn_scalar
# 256). Its queries are scaled by 8, so scores spread with a deviation of 8 and the
# largest of a few thousand reach 30, where the softcap of 50 bends them: dropping the
# softcap, or reading a window's keys past its edge, moves the output far beyond the
# limit.
GEMMA_2B = Widths(8, 4, 256, "gemma-2-2b Hq=8 Hkv=4 D=256 ", 256.0 ** -0.5, 8.0, True)
GEMMA_LONG_WORDS = 4100  # a prompt past the window: its last positions see 4096 keys on
                         # the windowed layers, all of them on the global ones


def check_gemma_kernels(torch) -> None:
  """K1-K4 and their int8 variants at gemma-2-2b's widths (GEMMA_2B: Hq 8, Hkv 4, D 256,
  the query_pre_attn_scalar scale 1/16, softcap 50 on every layer, window 4096 on the
  windowed ones), each against its plain version within rel_limit, with controls: the
  kernel run with its softcap or its window dropped must miss that limit. Timed beside
  the plain version, the bound and one compiled flex_attention (SDPA for the one case
  without a softcap): K1/K1w at T 1024 and 4608; K2/K2w/K2q decoding at S 8192 from
  4500 (the window bites) and a 512-query segment; K3/K3w/K3q and K4/K4w/K4q at page
  128. Then every kernel at D 256 and D 32 (which K3/K4 lacked) with scale 0.1, not
  the default 1/sqrt(D), so a dropped scale is a control too, pages 16 and 128
  (correctness and controls), and each D 256 wrapper once under
  torch.cuda.set_sync_debug_mode("error")."""
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention
  w, cap, win = GEMMA_2B, GEMMA_SOFTCAP, GEMMA_WINDOW
  draw = seeded_randn(torch, 256)
  gen = torch.Generator(device="cuda")
  gen.manual_seed(256)

  for T, window, softcap in ((1024, 0, 0.0), (1024, 0, cap), (4608, 0, cap), (4608, win, cap)):
    k1_case(torch, w, draw, 1, T, window, softcap)
  for T, start, window in ((1, 4500, win), (1, 4500, 0), (512, 4096, win)):
    for int8 in (False, True):
      k2_case(torch, w, draw, gen, 1, T, 8192, [start], window, cap, int8)
  for T, n in ((1, 4501), (512, 4608)):
    for window, int8 in ((0, False), (0, True), (win, False)):
      paged_case(torch, w, draw, gen, [n], 128, T, window, cap, int8)

  for d in (256, 32):
    sw = w._replace(d=d, scale=0.1, tag=f"gemma-2-2b Hq=8 Hkv=4 D={d} scale=0.1 ")
    for window, softcap in ((0, 0.0), (50, 10.0)):
      k1_case(torch, sw, draw, 2, 300, window, softcap, timed=False)
      for int8 in (False, True):
        for T, starts in ((1, [0, 200, 511]), (20, [100, 37, 400])):
          k2_case(torch, sw, draw, gen, 3, T, 544, starts, window, softcap, int8, timed=False)
        for pg in (16, 128):
          for T, lengths in ((1, [1, 200, 511]), (20, [20, 137, 420])):
            paged_case(torch, sw, draw, gen, lengths, pg, T, window, softcap, int8, timed=False)

  # Each D 256 wrapper once with host reads of device tensors refused.
  hq, hkv, d, page = w.hq, w.hkv, w.d, 128
  q1, qs = draw(1, 1, hq, d), draw(1, 64, hq, d)
  kc, vc = draw(1, 8192, hkv, d), draw(1, 8192, hkv, d)
  (kq, ks), (vq, vs) = spread_quantize(torch, gen, kc), spread_quantize(torch, gen, vc)
  start = torch.tensor([4500], dtype=torch.int32, device=q1.device)
  q, kp, vp, table, lens = paged_inputs(torch, draw, [4501], page, hq, hkv, d)
  (kpq, ksp), (vpq, vsp) = spread_quantize(torch, gen, kp), spread_quantize(torch, gen, vp)
  kw = dict(window=win, softcap=cap, scale=w.scale)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    flash_attention(qs, kc[:, :64].contiguous(), vc[:, :64].contiguous(), **kw)
    for qq in (q1, qs):
      flash_cached_attention(qq, kc, vc, start, **kw)
      flash_cached_attention(qq, kq, vq, start, k_scale=ks, v_scale=vs, **kw)
    paged_decode_attention(q, kp, vp, table, lens, **kw)
    paged_decode_attention(q, kpq, vpq, table, lens, k_scale_pages=ksp, v_scale_pages=vsp, **kw)
    paged_prefill_attention(q, kp, vp, table, lens, **kw)
    paged_prefill_attention(q, kpq, vpq, table, lens, k_scale_pages=ksp, v_scale_pages=vsp, **kw)
  finally:
    torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()
  print(f"[gemma kernels] K1, K2, K2q, K3, K3q, K4 and K4q at D=256 ran with "
        f"torch.cuda.set_sync_debug_mode('error'): no host read of a device tensor", flush=True)


# The attention widths of the two families phase 19 serves: qwen3-moe (Qwen3-30B-A3B: Hq
# 32, Hkv 4, D 128) and llava-1.5-7b's text stack (Hq 32, Hkv 32, D 128).
QWEN3_MOE_W = Widths(32, 4, 128, "qwen3-moe Hq=32 Hkv=4 D=128 ")
LLAVA_W = Widths(32, 32, 128, "llava-1.5 Hq=32 Hkv=32 D=128 ")
B8_STARTS = [17, 300, 1023, 1024, 2047, 2500, 3333, 4095]


def check_family_kernels(torch) -> None:
  """K1-K4 at qwen3-moe's and llava's attention widths, each timed beside its plain
  version, SDPA and the bound: K1 over a 1024-token prefill (the main path's first
  segment; llava's merged text-and-image prefill, ~600 positions, runs in the 1024
  bucket); K2 decoding at B=1 (S 2048 from 640) and B=8 (S 4096, lengths 18-4096), and
  K2 over a 16-query verify segment at 600 (MoE's speculative verify); K3 decoding at
  B=8 over page 128, K4 over a 1024-token segment from 0 and a 16-query verify at 600.
  Correctness first, within ATOL."""
  draw = seeded_randn(torch, 1730)
  for w in (QWEN3_MOE_W, LLAVA_W):
    k1_case(torch, w, draw, 1, 1024, 0, 0.0)
    for B, T, S, starts in ((1, 1, 2048, [640]), (8, 1, 4096, B8_STARTS), (1, 16, 2048, [600])):
      k2_case(torch, w, draw, None, B, T, S, starts, 0, 0.0)
    for lengths, T in (([s + 1 for s in B8_STARTS], 1), ([1024], 1024), ([616], 16)):
      paged_case(torch, w, draw, None, lengths, 128, T, 0, 0.0)


def write_gemma_checkpoint(torch, model_dir, device: str = "cuda") -> float:
  """A gemma-2-2b-shaped HF checkpoint in `model_dir`: the published config, seeded
  random bf16 weights written by the port's own save_shard_params as two files (layers
  0-12 with the tied embedding, layers 13-25 with the final norm) plus
  model.safetensors.index.json, and a word-level tokenizer (write_text_checkpoint).
  Returns its GB on disk."""
  from pathlib import Path
  model_dir = Path(model_dir)
  return write_index(model_dir, write_text_checkpoint(torch, model_dir, GEMMA_CONFIG, GEMMA_CARD,
                                                      2, device))


def write_word_tokenizer(model_dir, vocab_size: int, extra: Optional[dict] = None) -> None:
  """A word-level tokenizer over the whole vocabulary (tokenizer.json and
  tokenizer_config.json): gemma's special tokens at its ids (<eos> 1, <bos> 2), the
  requests' words w0-w96 and the chat roles, then t<id> for every other id, so every
  sampled id decodes to text. `extra` adds special tokens at given ids (llava's
  `<image>` at 32000: one token wherever it stands in a prompt). With `transformers`
  the engine and the API build it; without, they serve the DummyTokenizer and the
  config's eos (one token a word either way, plus the roles)."""
  special = ["<pad>", "<eos>", "<bos>", "<unk>"]
  words = special + [f"w{i}" for i in range(97)] + ["user", "assistant", "system", ":"]
  vocab = {t: i for i, t in enumerate(words)}
  taken = set((extra or {}).values())
  vocab.update((f"t{i}", i) for i in range(len(words), vocab_size) if i not in taken)
  vocab.update(extra or {})
  special += list(extra or {})
  (model_dir / "tokenizer.json").write_text(json.dumps({
    "version": "1.0", "truncation": None, "padding": None, "normalizer": None,
    "added_tokens": [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
                      "rstrip": False, "normalized": False, "special": True} for t in special],
    "pre_tokenizer": {"type": "Whitespace"}, "post_processor": None, "decoder": None,
    "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}))
  (model_dir / "tokenizer_config.json").write_text(json.dumps({
    "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<bos>", "eos_token": "<eos>",
    "unk_token": "<unk>", "pad_token": "<pad>", "model_max_length": 8192}))


def check_gemma_model(torch, model_dir, limit: float = 5e-2, T: int = 4200,
                      device: str = "cuda") -> None:
  """Two layers of the gemma-2-2b checkpoint at full width, read by load_shard_params:
  layer 0 windowed (4096), layer 1 global. A T-token prefill (past the window, so it
  bites) through K1/K1w and four decode steps through K2/K2w in bf16 on the card,
  against the plain path in fp32 on the CPU on the same checkpoint: the last 64
  positions' logits (the 256000-row unembedding of every position would cost the CPU
  minutes), then each step's, within `limit` of the logits' range; K1 and K2 launched
  once a layer a call, half of them windowed."""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.inference.shard import Shard
  from xotorch_tpu_torch.models.config import load_model_config
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache, unembed
  from xotorch_tpu_torch.models.weights import load_shard_params
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  cfg = dataclasses.replace(load_model_config(model_dir), num_layers=2)
  shard = Shard(GEMMA_CARD, 0, 1, 2)
  tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(1, T))
  steps = 4

  def run(device, dtype, **kw):
    params = load_shard_params(model_dir, cfg, shard, dtype=dtype, device=device)
    cache = init_kv_cache(cfg, 2, 1, T + steps, dtype, device)
    h, _ = forward_shard(params, torch.as_tensor(tokens, device=device), cache, 0, cfg, True,
                         False, use_flash=bool(kw))
    out = [unembed(params, h[:, -64:], cfg)[0].float().cpu()]
    for i in range(steps):
      tok = torch.tensor([[int(tokens[0, i])]], device=device)
      logits, _ = forward_shard(params, tok, cache, T + i, cfg, True, True,
                                use_flash_decode=bool(kw))
      out.append(logits[0].float().cpu())
    return out

  with torch.inference_mode():
    t0 = time.perf_counter()
    want = run("cpu", torch.float32)
    cpu_s = time.perf_counter() - t0
    for k in (flash_attention, flash_cached_attention):
      k.launches = k.windowed_launches = 0
    got = run(device, torch.bfloat16, kernels=True)
  if not all(bool(torch.isfinite(g).all()) for g in got):
    raise AssertionError("gemma model: non-finite logits on the card")
  worst = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))
  launched = {k.__name__: (k.launches, k.windowed_launches)
              for k in (flash_attention, flash_cached_attention)}
  ok = (worst < limit and launched["flash_attention"] == (2, 1)
        and launched["flash_cached_attention"] == (2 * steps, steps))
  print(f"[gemma model] 2-layer gemma-2-2b cut from the checkpoint (layer 0 window 4096, layer 1 "
        f"global), prefill {T} + decode {steps}: max logit error {worst:.3e} of the logits' range "
        f"(limit {limit:g}) over the last 64 positions and each step; launches (all, windowed) "
        f"{launched}; the CPU's fp32 path took {cpu_s:.1f} s {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"gemma model: error {worst} or launches {launched}")


def gemma_requests(model: str):
  """The main path's three requests, then a prompt past the window (temperature 0,
  streamed): its prompt and generation pass 4096 positions."""
  words = " ".join(f"w{i % 97}" for i in range(GEMMA_LONG_WORDS))
  return main_requests(model) + [
    (f"{GEMMA_LONG_WORDS}-word prompt (past the 4096 window), 64 tokens, streaming",
     {"model": model, "temperature": 0, "max_tokens": 64, "stream": True,
      "stream_options": {"include_usage": True}, "messages": [{"role": "user", "content": words}]})]


def drive_gemma(torch, card: str, device: str = "cuda") -> dict:
  """Phase 12: gemma-2-2b at full width and depth from an HF checkpoint on disk. Writes
  the checkpoint into a seed directory (write_gemma_checkpoint), holds a two-layer cut
  of it against the CPU (check_gemma_model), then serves it through main.py's entry
  points: a server started with --models-seed-dir (the seeding path, then the
  downloader's offline fast path out of XOT_HOME) answers gemma_requests with K1's and
  K2's counters read around them (K1 = 26 x prefills from 0 outside the scan, K2 = 26
  x (decode steps + segments at pos > 0 + the 4100-word prompt's four scanned
  segments), each half windowed) and one B=1 decode chunk under the
  profiler, then a fresh server with XOT_PAGED_KV=1
  the same (K4 = 26 x segments, K3 = 26 x decode steps, half windowed, 0 pages left),
  and the share of temperature-0 tokens the two agree on (bf16: not asserted). The
  contiguous server also answers one request with logprobs and a logit_bias, held
  against the log-softmax of its softcapped logits (gemma_extras). The
  checkpoint is deleted at the end. Returns the phase's launches by wrapper. (`device`
  lets the phase be rehearsed on the CPU with a small GEMMA_CONFIG.)"""
  import shutil
  import tempfile
  from pathlib import Path
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention
  layers = GEMMA_CONFIG["num_hidden_layers"]
  tmp = Path(tempfile.mkdtemp(prefix="xot-gemma-"))
  try:
    seed = tmp / "seed"
    model_dir = seed / "google--gemma-2-2b-it"
    t0 = time.perf_counter()
    gb = write_gemma_checkpoint(torch, model_dir, device)
    print(f"[gemma] checkpoint written by save_shard_params: {gb:.2f} GB in two safetensors files "
          f"and an index, in {time.perf_counter() - t0:.1f} s", flush=True)
    check_gemma_model(torch, model_dir, device=device)
    requests = gemma_requests(GEMMA_CARD)
    runs = {}
    with phase_env(XOT_HOME=str(tmp / "home")):
      for tag, env, kernels, cli, profiles in (
          ("gemma", {}, (flash_attention, flash_cached_attention), ("--models-seed-dir", str(seed)),
           (1,)),
          ("gemma paged", {"XOT_PAGED_KV": "1"}, (paged_prefill_attention, paged_decode_attention),
           (), ())):
        t0 = time.perf_counter()
        after = None
        if tag == "gemma":
          after = lambda *a: gemma_extras(torch, *a, card)  # noqa: E731
        run = drive_main_path(torch, card, device=device, model=GEMMA_CARD, kernels=kernels,
                              env=env, tag=tag, profiles=profiles, cli=cli, requests=requests,
                              focus="flash_cached_", after=after)
        runs[tag] = run
        segments = [-(-n // 1024) for n in run["prompt_tokens"]]
        # JAX's routing: a prompt with two or more whole segments before its last one
        # prefills them through prefill_scan (every segment through K2, the from-zero
        # one too), then its last through forward_sample; others take K1 for the first
        # segment and K2 for each later one.
        scanned = [(n - 1) // 1024 >= 2 for n in run["prompt_tokens"]]
        counts, steps = run["launches"], run["steps"]
        if tag == "gemma":
          if model_dir.exists() or not (tmp / "home" / "models" / model_dir.name).is_dir():
            raise AssertionError("gemma: --models-seed-dir did not move the checkpoint into XOT_HOME")
          want = contiguous_want(run, layers)
          k1 = want["flash_attention"] // layers
          k2 = want["flash_cached_attention"] // layers - steps
          formula = (f"K1 = {layers} x {k1} prefills from 0 outside the scan, K2 = {layers} x "
                     f"({steps} decode steps + {k2} segments: at pos > 0, and every segment of "
                     f"{sum(scanned)} scanned prompt(s))")
        else:
          want = {"paged_prefill_attention": layers * sum(segments),
                  "paged_decode_attention": layers * steps}
          formula = (f"K4 = {layers} x {sum(segments)} segments, K3 = {layers} x {steps} decode "
                     f"steps")
        windowed = run["windowed"]
        pool = run["pool"]
        ok = (counts == want and all(2 * windowed[k] == counts[k] for k in counts)
              and steps >= run["decoded"] and (pool is None) == (tag == "gemma")
              and (pool is None or pool["pages_in_use"] == 0))
        print(f"[{tag}] launches {counts}: {formula} ({want}); prompt tokens "
              f"{run['prompt_tokens']}; tokenizer {run['tokenizer']}; pool {pool}; served in "
              f"{time.perf_counter() - t0:.1f} s with the load {'ok' if ok else 'FAIL'}", flush=True)
        print(f"[{tag}] windowed launches {windowed}: half of each ({card})", flush=True)
        if not ok:
          raise AssertionError(f"{tag}: launches {counts} (windowed {windowed}), wanted {want}; "
                               f"pool {pool}")
    same = total = 0
    for i, (_, body) in enumerate(requests):
      if body.get("temperature") == 0:
        a, b = runs["gemma"]["tokens"][i], runs["gemma paged"]["tokens"][i]
        same += sum(x == y for x, y in zip(a, b))
        total += max(len(a), len(b))
    print(f"[gemma paged] temperature-0 tokens the paged and contiguous servers agree on: "
          f"{same}/{total} = {100 * same / max(total, 1):.1f}% (bf16; not asserted)", flush=True)
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  launches = {}
  for run in runs.values():
    launches.update(run["launches"])
  return launches


# ------------------------------------------------------------------ phase 13: fused decode

FUSED_FORMATS = (("bf16", {}), ("int4 K5", {"XOT_QUANTIZE": "int4"}),
                 ("int4 K5v4", {"XOT_QUANTIZE": "int4", "XOT_INT4_V": "4"}),
                 ("int8 K6", {"XOT_QUANTIZE": "int8", "XOT_INT8_KERNEL": "1"}),
                 ("bf16, int8 KV (K2q)", {"XOT_KV_QUANT": "int8"}))
# Decode steps a parity chunk runs, eager body against graph replays: 64 until the
# training phase (21) needed the time; 16 steps still hold every format, path, batch
# and kernel, and each step's tokens and cache, bit for bit.
FUSED_STEPS = 8  # parity steps a case (16 until the smoke's clock needed the time)
FUSED_PAGE = 128
# The scan prefill against the per-segment loop over a 4096-token prompt: the two take
# different kernels for the from-zero segment (K2 against K1), so bf16 rounds at other
# places and the difference grows through 16 layers; both are held to the largest
# |hidden state| within the model cuts' limit.
PREFILL_REL_LIMIT = 5e-2


class FusedModel(NamedTuple):
  label: str
  cfg: object
  params: dict
  route: object
  kv_quant: bool
  dtype: object
  layers: int


def fused_model(torch, label: str, env: dict, card_config: dict, layers: int,
                device: str = "cuda", dtype=None) -> FusedModel:
  """Seeded random weights of `card_config` at full width in the format `env` asks
  (quantized on the device as the engine quantizes them), with the quantized route
  the engine takes under `env`."""
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.quantize import quantize_params
  from xotorch_tpu_torch.models.transformer import init_random_params, quant_route
  dtype = dtype or torch.bfloat16
  cfg = config_from_hf_dict(card_config)
  params = init_random_params(cfg, layers, True, True, seed=0, dtype=dtype, device=device)
  with phase_env(**env):
    if env.get("XOT_QUANTIZE"):
      params = quantize_params(params, env["XOT_QUANTIZE"], scale_dtype=dtype, inplace=True)
    route = quant_route(device == "cuda")
  return FusedModel(label, cfg, params, route, env.get("XOT_KV_QUANT") == "int8", dtype, layers)


def fused_batch(torch, m: FusedModel, B: int, paged: bool, device: str = "cuda", S: int = 2048,
                seed: int = 0):
  """B requests prefilled from seeded random prompts of 100 + 37 b tokens (K1, or K4 on
  the page arena), on contiguous caches of S slots or in one page pool. Returns
  (caches, or (arena, page table), last tokens [B, 1], positions [B])."""
  from xotorch_tpu_torch.inference.torch_engine.paged_cache import PagePool
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache
  gen = torch.Generator(device=device)
  gen.manual_seed(seed)
  lens = [100 + 37 * b for b in range(B)]
  state, table = [], None
  if paged:
    per = -(-S // FUSED_PAGE)
    pool = PagePool(m.cfg, m.layers, 1 + B * per, FUSED_PAGE, dtype=m.dtype, device=device,
                    kv_quant=m.kv_quant)
    width = 1 << (per - 1).bit_length()
    table = torch.zeros((B, width), dtype=torch.int32)
    for b in range(B):
      table[b, :per] = torch.tensor(pool.alloc(per), dtype=torch.int32)
    table = table.to(device)
    state = (pool.arena, table)
  last = []
  for b, n in enumerate(lens):
    prompt = torch.randint(3, m.cfg.vocab_size, (1, n), generator=gen, device=device)
    if paged:
      logits, _ = forward_shard(m.params, prompt, state[0], 0, m.cfg, True, True,
                                page_table=table[b:b + 1], route=m.route)
    else:
      cache = init_kv_cache(m.cfg, m.layers, 1, S, m.dtype, device, kv_quant=m.kv_quant)
      logits, _ = forward_shard(m.params, prompt, cache, 0, m.cfg, True, True, use_flash=True,
                                route=m.route)
      state.append(cache)
    last.append(logits[0, -1].argmax())
  toks = torch.stack(last)[:, None].to(torch.int64)
  return state, toks, torch.tensor(lens, dtype=torch.int32, device=device)


def _clone_state(state, paged: bool):
  if paged:
    arena, table = state
    return {n: t.clone() for n, t in arena.items()}, table
  return [{n: t.clone() for n, t in c.items()} for c in state]


def _decode_kernels(m: FusedModel, paged: bool):
  """The wrappers a decode step of `m` launches: (the attention kernel, the
  projections' GEMV kernel or None)."""
  from xotorch_tpu_torch.ops import flash_decode, int4_matmul, int8_matmul, paged_attention
  attn = {(False, False): flash_decode.flash_cached_attention,
          (False, True): flash_decode.flash_cached_attention_int8,
          (True, False): paged_attention.paged_decode_attention,
          (True, True): paged_attention.paged_decode_attention_int8}[(paged, m.kv_quant)]
  gemv = None
  if "wq_gscale" in m.params["layers"] and m.route.int4_kernel:
    gemv = int4_matmul.int4_w4a8_matmul if m.route.int4_variant == 4 else int4_matmul.int4_w4a16_matmul
  elif "wq_scale" in m.params["layers"] and m.route.int8_kernel:
    gemv = int8_matmul.int8_rowquant_matmul
  return attn, gemv


def fused_chunk(m: FusedModel, state, toks, pos, n: int, temps, top_k: int, paged: bool,
                gc=None, gumbel=None, generator=None):
  """One decode chunk of `n` steps: the eager body (models/generate) when `gc` is None,
  else graph replays (models/graphs). Returns ([B, n] tokens, the state after it)."""
  from xotorch_tpu_torch.models import generate, graphs
  B = toks.shape[0]
  pad = (1 << (B - 1).bit_length()) - B
  kw = dict(route=m.route, gumbel=gumbel, generator=generator)
  if paged:
    arena, table = state
    if gc is None:
      out, _ = generate.decode_chunk_paged(m.params, arena, table, toks, pos, m.cfg, n, temps,
                                           top_k, pad_rows=pad, **kw)
    else:
      out, _ = graphs.decode_paged(gc, m.params, arena, table, toks, pos, m.cfg, n, temps, top_k,
                                   **kw)
    return out, state
  if gc is None:
    out, split = generate.decode_chunk_batched(m.params, state, toks, pos, m.cfg, n, temps, top_k,
                                               use_flash_decode=True, pad_rows=pad, **kw)
    return out, split
  out, _ = graphs.decode_contiguous(gc, m.params, state, toks, pos, m.cfg, n, temps, top_k, **kw)
  return out, state


def fused_parity(torch, m: FusedModel, B: int, paged: bool, sampled: bool, card: str,
                 make_cache, device: str = "cuda", steps: int = FUSED_STEPS):
  """The graph path's tokens and cache (or arena) against the eager body's, bit for
  bit, over `steps` steps from the same prefilled state: temperature 0, or 0.8 with
  top_k 35 and the same injected Gumbel noise. The kernels' counters, set to 0 just
  before the graph chunk, must read layers x steps for the attention kernel (half of
  them windowed where the model slides) and 7 x layers x steps for a GEMV kernel.
  Returns the graph cache."""
  from xotorch_tpu_torch.models.graphs import counted_wrappers
  from xotorch_tpu_torch.ops.sampling import gumbel_noise
  state, toks, pos = fused_batch(torch, m, B, paged, device)
  eager_state = _clone_state(state, paged)
  Bb = 1 << (B - 1).bit_length()
  temps = torch.full((B,), 0.8 if sampled else 0.0, device=device)
  top_k = 35 if sampled else 0
  noise = None
  if sampled:
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    noise = gumbel_noise((steps, Bb, m.cfg.vocab_size), gen, device)
  want, eager_state = fused_chunk(m, eager_state, toks, pos, steps, temps, top_k, paged,
                                  gumbel=noise)
  gc = make_cache()
  for fn in counted_wrappers():
    fn.launches = 0
    fn.windowed_launches = 0
  got, state = fused_chunk(m, state, toks, pos, steps, temps, top_k, paged, gc=gc, gumbel=noise)
  counts = {fn.__name__: (fn.launches, fn.windowed_launches) for fn in counted_wrappers()
            if fn.launches}
  attn, gemv = _decode_kernels(m, paged)
  windows = sum(bool(m.cfg.layer_window(i)) for i in range(m.layers)) if m.cfg.uses_sliding_window else 0
  want_counts = {attn.__name__: (m.layers * steps, windows * steps)}
  if gemv is not None:
    want_counts[gemv.__name__] = (7 * m.layers * steps, 0)
  if device != "cuda":  # on the CPU no kernel launches
    want_counts = {}
  same_tokens = torch.equal(got, want)
  if paged:
    same_cache = all(torch.equal(state[0][n], eager_state[0][n]) for n in state[0])
    kv_bytes = sum(t.numel() * t.element_size() for t in state[0].values())
  else:
    same_cache = all(torch.equal(c[n], e[n]) for c, e in zip(state, eager_state) for n in c)
    kv_bytes = sum(t.numel() * t.element_size() for c in state for t in c.values())
  ok = same_tokens and same_cache and counts == want_counts
  differ = (got != want).sum().item()
  print(f"[fused] {m.label} B={B} {'paged' if paged else 'contiguous'} "
        f"{'sampled (injected noise, t 0.8, top_k 35)' if sampled else 'temperature 0'}: "
        f"{steps} graph-replayed steps against the eager body: tokens "
        f"{'identical' if same_tokens else f'{differ} of {got.numel()} differ'}, cache "
        f"{'identical' if same_cache else 'DIFFERS'}; launches {counts} (want {want_counts}); "
        f"{gc.captures} capture(s), {gc.replays} replays; graph pool {gc.pool_bytes / 1e6:.1f} "
        f"MB, slab {gc.slab_bytes / 1e6:.1f} MB beside {kv_bytes / 1e6:.1f} MB of KV "
        f"({'arena' if paged else 'caches'}) ({card}) {'ok' if ok else 'FAIL'}",
        flush=True)
  if not ok:
    raise AssertionError(f"fused {m.label} B={B} paged={paged} sampled={sampled}: tokens "
                         f"{same_tokens}, cache {same_cache}, launches {counts} vs {want_counts}")
  return gc


def fused_seeded(torch, m: FusedModel, card: str, make_cache, device: str = "cuda",
                 steps: int = FUSED_STEPS) -> None:
  """The engine's sampling noise on the graph path: two runs from one prefilled B=8
  state, each with a fresh graph cache and a fresh generator seeded alike (registered
  with the captured step), sample the same tokens at temperature 0.8, top_k 35; a third
  seed samples others. Whether the eager body with that seed draws the same noise is
  printed, not asserted (the graph's generator state is its own scheme)."""
  state, toks, pos = fused_batch(torch, m, 8, False, device)
  temps = torch.full((8,), 0.8, device=device)
  runs = []
  for seed, gc in ((7, make_cache()), (7, make_cache()), (8, make_cache()), (7, None)):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out, _ = fused_chunk(m, _clone_state(state, False), toks, pos, steps, temps, 35, False,
                         gc=gc, generator=gen)
    runs.append(out)
  ok = torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
  print(f"[fused] {m.label} B=8 sampled from the generator (t 0.8, top_k 35), {steps} "
        f"steps: two fresh graph caches seeded alike "
        f"{'agree' if torch.equal(runs[0], runs[1]) else 'DIFFER'}, another seed "
        f"{'differs' if not torch.equal(runs[0], runs[2]) else 'AGREES'}; the eager body with "
        f"the same seed {'agrees' if torch.equal(runs[0], runs[3]) else 'differs'} (not "
        f"asserted) ({card}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"fused {m.label}: seeded graph sampling not reproducible")


def _profile_chunk(torch, run) -> tuple:
  """(wall ms, device busy ms, device kernels) of one call of `run` under the profiler;
  busy None when the trace holds no device time."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
  busy = kernels = 0
  for evt in prof.key_averages():
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
      us = getattr(evt, "self_cuda_time_total", 0)
    if us > 0:
      busy += us / 1e3
      kernels += evt.count
  return wall, (busy if kernels else None), kernels


def fused_timing(torch, m: FusedModel, B: int, paged: bool, card: str, make_cache,
                 device: str = "cuda", rounds: int = 4, n: int = 16) -> dict:
  """Eager body against graph replays, `rounds` rounds taken in turn (eager, then
  graph) from the same prefilled state, greedy chunks of `n` steps each: wall ms a
  step (host clock, synchronised); then one chunk of each under the profiler: device
  busy ms a step, device kernels a step and the idle share of the profiled wall time.
  Returns the numbers."""
  state, toks, pos = fused_batch(torch, m, B, paged, device)
  runs = {"eager": [_clone_state(state, paged), toks, pos.clone(), None],
          "graph": [state, toks, pos.clone(), make_cache()]}
  temps = torch.zeros((B,), device=device)

  def chunk(label):
    st = runs[label]
    out, st[0] = fused_chunk(m, st[0], st[1], st[2], n, temps, 0, paged, gc=st[3])
    st[1], st[2] = out[:, -1:].contiguous(), st[2] + n

  chunk("graph")  # the capture
  chunk("eager")
  walls = {"eager": [], "graph": []}
  for _ in range(rounds):
    for label in ("eager", "graph"):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      chunk(label)
      torch.cuda.synchronize()
      walls[label].append((time.perf_counter() - t0) * 1e3 / n)
  out = {}
  for label in ("eager", "graph"):
    wall, busy, kernels = _profile_chunk(torch, lambda: chunk(label))
    med = sorted(walls[label])[len(walls[label]) // 2]
    out[label] = {"wall_ms": med, "walls": walls[label],
                  "device_ms": None if busy is None else busy / n,
                  "idle_pct": None if busy is None else 100 * (1 - busy / wall),
                  "kernels": kernels / n}
  e, g = out["eager"], out["graph"]
  fmt = lambda v, f: "not measured" if v is None else format(v, f) + ("%" if f == ".1f" else "")
  print(f"[fused] {m.label} B={B} {'paged' if paged else 'contiguous'}: wall ms a step, "
        f"{rounds} rounds of {n} in turn: eager " + ", ".join(f"{w:.3f}" for w in e["walls"])
        + " / graph " + ", ".join(f"{w:.3f}" for w in g["walls"])
        + f"; median eager {e['wall_ms']:.3f} graph {g['wall_ms']:.3f} "
        f"({e['wall_ms'] / g['wall_ms']:.2f}x); device ms a step eager "
        f"{fmt(e['device_ms'], '.3f')} graph {fmt(g['device_ms'], '.3f')}; idle eager "
        f"{fmt(e['idle_pct'], '.1f')} graph {fmt(g['idle_pct'], '.1f')}; device kernels a "
        f"step eager {e['kernels']:.0f} graph {g['kernels']:.0f} ({card})", flush=True)
  return out


def slab_copy_ms(torch, m: FusedModel, card: str, device: str = "cuda") -> dict:
  """Device ms of one chunk's stack into the slab and split out of it (CUDA events,
  mean of 10) at B=1 and B=8 over caches of 2048 slots: what a contiguous chunk pays
  besides its replays."""
  from xotorch_tpu_torch.models import graphs
  from xotorch_tpu_torch.models.transformer import init_kv_cache
  out = {}
  for B in (1, 8):
    caches = [init_kv_cache(m.cfg, m.layers, 1, 2048, m.dtype, device, kv_quant=m.kv_quant)
              for _ in range(B)]
    gc = graphs.GraphCache(device)
    slab = gc.slab_views(graphs.slab_leaves(caches[0], B))
    times = {}
    for label, fn in (("stack", lambda: graphs.stack_into(slab, caches)),
                      ("split", lambda: graphs.split_from(slab, caches))):
      fn()
      start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(10):
        fn()
      end.record()
      torch.cuda.synchronize()
      times[label] = start.elapsed_time(end) / 10
    nbytes = sum(t.numel() * t.element_size() for c in caches for t in c.values())
    out[B] = times
    print(f"[fused] {m.label} slab copies at B={B}, S=2048 ({nbytes / 1e6:.1f} MB of caches): "
          f"stack {times['stack']:.3f} ms, split {times['split']:.3f} ms a chunk, "
          f"{2 * nbytes / (times['stack'] * 1e-3) / 1e9:.0f} GB/s read+write on the stack "
          f"({card})", flush=True)
  return out


def fused_prefill(torch, m: FusedModel, card: str, device: str = "cuda", T: int = 4096,
                  chunk: int = 1024) -> dict:
  """A T-token prompt in segments of `chunk`: prefill_scan as graph replays (one group
  of T / chunk, every segment through K2) against the per-segment loop (the first
  segment through K1, the rest through K2): last-layer hidden states of every position
  within PREFILL_REL_LIMIT of the largest |hidden state|, and the device ms of each
  (CUDA events, after a warm-up that captures)."""
  from xotorch_tpu_torch.models import graphs
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache
  gen = torch.Generator(device=device)
  gen.manual_seed(3)
  x = torch.randint(3, m.cfg.vocab_size, (1, T), generator=gen, device=device)
  gc = graphs.GraphCache(device)

  def loop():
    cache = init_kv_cache(m.cfg, m.layers, 1, T, m.dtype, device, kv_quant=m.kv_quant)
    hs = []
    for off in range(0, T, chunk):
      h, _ = forward_shard(m.params, x[:, off:off + chunk], cache, off, m.cfg, True, False,
                           use_flash=off == 0, use_flash_decode=off > 0, route=m.route)
      hs.append(h)
    return torch.cat(hs, dim=1)

  def scan():
    cache = init_kv_cache(m.cfg, m.layers, 1, T, m.dtype, device, kv_quant=m.kv_quant)
    return graphs.prefill(gc, m.params, x, cache, 0, m.cfg, chunk, route=m.route, want_hidden=True)

  ms = {}
  outs = {}
  for label, fn in (("loop", loop), ("scan", scan)):
    outs[label] = fn()  # the scan's first call captures
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
      fn()
    end.record()
    torch.cuda.synchronize()
    ms[label] = start.elapsed_time(end) / 3
  ref = outs["loop"].float()
  err = (outs["scan"].float() - ref).abs().max().item()
  rel = err / max(ref.abs().max().item(), 1e-12)
  ok = math.isfinite(rel) and rel <= PREFILL_REL_LIMIT and gc.captures == 1
  print(f"[fused] prefill {T} tokens in segments of {chunk}: prefill_scan (one graph of "
        f"{T // chunk} segments through K2) against the per-segment loop (K1, then K2): "
        f"max_rel_err {rel:.3e} (limit {PREFILL_REL_LIMIT:.0e}); {ms['scan']:.3f} ms against "
        f"{ms['loop']:.3f} ms ({card}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"fused prefill: rel err {rel} (captures {gc.captures})")
  return {"rel": rel, "ms": ms}


def fused_ttft(torch, card: str, rounds: int = 4, T: int = 4096,
               model: str = "synthetic-llama-1b") -> dict:
  """The engine's time to first token over a T-token prompt at XOT_PREFILL_CHUNK 1024,
  XOT_SCAN_PREFILL 1 (the leading three segments through one captured scan group of
  2 and one of 1, the last through forward_sample) against 0 (segment by segment, K1
  first), taken in turn for `rounds` rounds after one unmeasured round each."""
  import numpy as np
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  from xotorch_tpu_torch.models.registry import TORCH, build_full_shard
  shard = build_full_shard(model, TORCH)
  prompt = np.random.default_rng(4).integers(3, 120000, size=(1, T))
  with phase_env(XOT_PAGED_KV="0", XOT_PREFILL_CHUNK="1024"):
    engine = TorchShardInferenceEngine(device="cuda", seed=0)

  async def drive():
    await engine.ensure_shard(shard)
    ttft = {"1": [], "0": []}
    toks = {}
    for i in range(rounds + 1):
      for scan in ("1", "0"):
        with phase_env(XOT_SCAN_PREFILL=scan, XOT_PREFILL_CHUNK="1024"):
          t0 = time.perf_counter()
          toks[scan], _ = await engine.infer_sample_tensor(f"ttft{i}{scan}", shard, prompt,
                                                           temp=0.0, top_k=0)
          if i:
            ttft[scan].append((time.perf_counter() - t0) * 1e3)
        await engine.clear_request(f"ttft{i}{scan}")
    return ttft, toks

  try:
    ttft, toks = asyncio.run(drive())
  finally:
    engine.executor.shutdown(wait=True)
  print(f"[fused] TTFT of a {T}-token prompt, segments of 1024, {rounds} rounds in turn: "
        f"XOT_SCAN_PREFILL=1 " + ", ".join(f"{t:.1f}" for t in ttft["1"]) + " ms / =0 "
        + ", ".join(f"{t:.1f}" for t in ttft["0"]) + f" ms; medians "
        f"{sorted(ttft['1'])[rounds // 2]:.1f} against {sorted(ttft['0'])[rounds // 2]:.1f} ms; "
        f"first tokens {toks['1']} / {toks['0']} (bf16, K2 against K1 for the first segment: "
        f"not asserted) ({card})", flush=True)
  return ttft


def check_fused(torch, card: str, device: str = "cuda", make_cache=None,
                model: str = "synthetic-llama-1b", gemma: bool = True,
                steps: int = FUSED_STEPS, rounds: int = 2) -> dict:
  """Phase 13: the fused decode programs. synthetic-llama-1b at full width and depth in
  the five decode formats, and gemma-2-2b's shape in bf16: graph replays against the
  eager body (fused_parity) at B=1 and B=8 (gemma B=1), contiguous and paged, at
  temperature 0, and with injected noise at B=8 (paged in bf16 only: the sampler is
  the same code over either cache); eager against graph timing (fused_timing;
  paged in bf16 and gemma);
  the slab copies' device time; the capture count, seconds and graph pool, slab and KV
  bytes; prefill_scan against the per-segment loop and the engine's TTFT both ways.
  (`device`, `make_cache`, `model` and `gemma` let it be rehearsed on the CPU with a
  small card and an eager stand-in for the graph cache.)"""
  from xotorch_tpu_torch.models import graphs
  from xotorch_tpu_torch.models.registry import get_model_card
  make_cache = make_cache or (lambda: graphs.GraphCache(device))
  card_cfg = get_model_card(model)["synthetic_config"]
  layers = card_cfg["num_hidden_layers"]
  dtype = torch.bfloat16 if device == "cuda" else torch.float32
  caches, timing = [], {}
  totals = {"caches": 0, "captures": 0, "seconds": 0.0, "pool": 0, "slab": 0}

  def tracked():
    caches.append(make_cache())
    return caches[-1]

  def release():
    """Fold the model's graph caches into the totals, then drop them: their slabs and
    graph pools are not held through the next model's captures."""
    for c in caches:
      totals["caches"] += 1
      totals["captures"] += c.captures
      totals["seconds"] += c.capture_seconds
      totals["pool"] = max(totals["pool"], c.pool_bytes)
      totals["slab"] = max(totals["slab"], c.slab_bytes)
    caches.clear()

  t0 = time.perf_counter()
  for label, env in FUSED_FORMATS:
    m = fused_model(torch, label, env, card_cfg, layers, device, dtype)
    for paged in (False, True):
      for B in (1, 8):
        fused_parity(torch, m, B, paged, False, card, tracked, device, steps)
      # Injected noise at B=8: contiguous in every format, paged in bf16 (the sampler
      # is the same code over either cache).
      if not paged or label == "bf16":
        fused_parity(torch, m, 8, paged, True, card, tracked, device, steps)
      # Eager against graph: bf16 only (the quantized formats' steps are timed in phase 8).
      if device == "cuda" and label == "bf16":
        for B in (1, 8):
          timing[(label, paged, B)] = fused_timing(torch, m, B, paged, card, tracked, device,
                                                   rounds)
    if label == "bf16":
      fused_seeded(torch, m, card, tracked, device, steps)
    if device == "cuda" and label in ("bf16", "bf16, int8 KV (K2q)"):
      slab_copy_ms(torch, m, card, device)
    if device == "cuda" and label == "bf16":
      fused_prefill(torch, m, card, device)
    release()
    del m
    gc.collect()
    if device == "cuda":
      torch.cuda.empty_cache()
  if gemma:
    m = fused_model(torch, "gemma-2-2b bf16", {}, GEMMA_CONFIG, GEMMA_CONFIG["num_hidden_layers"],
                    device, dtype)
    for paged in (False, True):
      fused_parity(torch, m, 1, paged, False, card, tracked, device, steps)
      fused_parity(torch, m, 1, paged, True, card, tracked, device, steps)
      if device == "cuda":
        timing[("gemma-2-2b bf16", paged, 1)] = fused_timing(torch, m, 1, paged, card, tracked,
                                                             device, rounds)
    release()
    del m
    gc.collect()
  captures, seconds = totals["captures"], totals["seconds"]
  pool, slab = totals["pool"], totals["slab"]
  print(f"[fused] {captures} graphs captured over {totals['caches']} graph caches in "
        f"{seconds:.2f} s ({seconds / max(captures, 1) * 1e3:.1f} ms a capture, warm-up "
        f"excluded, the synchronize and cache release before it included); the largest cache's "
        f"graph pool {pool / 1e6:.1f} MB and slab {slab / 1e6:.1f} MB ({card})", flush=True)
  ttft = fused_ttft(torch, card, rounds) if device == "cuda" else {}
  print(f"[fused] phase 13 took {time.perf_counter() - t0:.1f} s ({card})", flush=True)
  return {"timing": timing, "captures": captures, "capture_s": seconds, "pool_bytes": pool,
          "slab_bytes": slab, "ttft": ttft}


# ------------------------------------------------------------------ phase 14: sampling extras

EXTRAS_WORDS = 200  # prompt words of the extras phase's requests
EXTRAS_LP_LIMIT = 2e-2  # a reported logprob against fp32 log-softmax of the eager forward
EXTRAS_LADDER = (8, 16)  # the eager/graph parity's two chunks
# An extras request (logit bias, both penalties, 5 logprobs), as the API's fields.
EXTRAS_FIELDS = {"logit_bias": {"1000": 2.0}, "presence_penalty": 0.5, "frequency_penalty": 0.5,
                 "logprobs": True, "top_logprobs": 5}


def extras_body(model: str, words: int = EXTRAS_WORDS, **fields) -> dict:
  return {"model": model, "messages": [{"role": "user", "content": " ".join(
    f"w{i % 89}" for i in range(words))}], **fields}


def word_tokenizer():
  """The DummyTokenizer with a decode that names each id (" w<id>"): the API's text then
  shows the token ids, so stop strings and logprob items can be held to the ids the
  engine sampled."""
  from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer

  class WordIds(DummyTokenizer):
    def decode(self, tokens) -> str:
      return "".join(f" w{int(t)}" for t in tokens)
  return WordIds()


def lp_reference(torch, engine, prompt_ids, tokens, bias=None):
  """fp32 log-softmax, plus `bias` {id: value}, of the eager forward's logits at each
  generated token's position ([len(tokens), V]), computed as the server computed them:
  the served params, the prompt padded to the engine's bucket and prefilled (K1) on a
  cache of the engine's initial length, the unembedding on its last real position, then
  one eager decode step (K2) a token (gemma's logits softcapped)."""
  from xotorch_tpu_torch.inference.torch_engine.engine import _bucket
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache, unembed
  ctx = engine._ctx
  cache = init_kv_cache(ctx.cfg, ctx.shard.get_layer_count(), 1, ctx.cache_len, engine.dtype,
                        engine.device)
  kw = dict(cfg=ctx.cfg, is_first=True, route=engine.quant_route)
  n = len(prompt_ids)
  x = torch.zeros((1, _bucket(n)), dtype=torch.int64, device=engine.device)
  x[0, :n] = torch.tensor(list(prompt_ids), dtype=torch.int64)
  h, _ = forward_shard(ctx.params, x, cache, 0, is_last=False, use_flash=True, **kw)
  rows = [unembed(ctx.params, h[:, n - 1:n], ctx.cfg)[0, -1]]
  for i, t in enumerate(tokens[:-1]):
    x = torch.tensor([[int(t)]], dtype=torch.int64, device=engine.device)
    logits, _ = forward_shard(ctx.params, x, cache, n + i, is_last=True, use_flash_decode=True,
                              **kw)
    rows.append(logits[0, -1])
  rows = torch.stack(rows).float()
  for t, v in (bias or {}).items():
    rows[:, int(t)] += float(v)
  return torch.log_softmax(rows, dim=-1)


async def prompt_ids(engine, api, model: str, body: dict) -> list:
  """The token ids the engine prefilled for `body`: the API's prompt, the engine's
  tokenizer."""
  prompt, _ = await api._request_prompt(model, body["messages"], None)
  return (await engine.encode(engine.shard, prompt)).tolist()


def check_logprob_items(torch, tag: str, items: list, tokens: list, ref, k: int, card: str) -> float:
  """The API's logprob items against the reference rows: each sampled token's logprob,
  and its top k (sorted, the sampled one first by value) against the reference's top k,
  within EXTRAS_LP_LIMIT. Returns the largest error."""
  if len(items) != len(tokens):
    raise AssertionError(f"{tag}: {len(items)} logprob items for {len(tokens)} tokens")
  errors = []
  for i, (item, tok) in enumerate(zip(items, tokens)):
    tops = [t["logprob"] for t in item["top_logprobs"]]
    if len(tops) != k or tops != sorted(tops, reverse=True) or tops[0] != item["logprob"]:
      raise AssertionError(f"{tag}: token {i}: top_logprobs {tops} (logprob {item['logprob']})")
    want = torch.topk(ref[i], k).values.tolist()
    errors.append(max([abs(item["logprob"] - float(ref[i, tok]))]
                      + [abs(a - b) for a, b in zip(tops, want)]))
  worst = max(errors)
  ok = worst <= EXTRAS_LP_LIMIT
  print(f"[{tag}] {len(items)} tokens' logprobs and top {k} against fp32 log-softmax of the "
        f"eager forward's logits: largest error {worst:.2e} (limit {EXTRAS_LP_LIMIT}); top {k} "
        f"sorted, the sampled token first ({card}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"{tag}: logprobs off the reference by token: "
                         + ", ".join(f"{e:.2e}" for e in errors))
  return worst


async def gemma_extras(torch, engine, node, api, base: str, card: str) -> dict:
  """Phase 12's gemma-2-2b server (its contiguous one) answers one request with
  logprobs, top_logprobs 3 and a logit_bias (-100 on the temperature-0 first token, +4 on
  another): the first token moves, and each reported logprob is held against the fp32
  log-softmax of the eager forward's softcapped logits with the bias added."""
  loop = asyncio.get_running_loop()
  body = extras_body(GEMMA_CARD, words=64, temperature=0, max_tokens=12, logprobs=True,
                     top_logprobs=3)
  tokens = {}
  node.on_token.register("chip-smoke-gemma-extras").on_next(
    lambda rid, toks, fin: tokens.__setitem__(rid, list(toks)))
  url = base + "/v1/chat/completions"
  plain = await loop.run_in_executor(None, http_json, url, body)
  first = tokens[plain["id"][len("chatcmpl-"):]][0]
  bias = {str(first): -100.0, "1000": 4.0}
  resp = await loop.run_in_executor(None, http_json, url, {**body, "logit_bias": bias})
  got = tokens[resp["id"][len("chatcmpl-"):]]
  if got[0] == first:
    raise AssertionError(f"gemma extras: the banned token {first} came first")
  ids = await prompt_ids(engine, api, GEMMA_CARD, body)
  ref = await engine._run(lp_reference, torch, engine, ids, got, bias)
  items = resp["choices"][0]["logprobs"]["content"]
  return {"max_err": check_logprob_items(torch, "gemma extras", items, got[:len(items)], ref, 3,
                                         card)}


def extras_parity(torch, engine, card: str, paged: bool, make_cache, device: str) -> None:
  """frequency_penalty 2 at temperature 0 on the served params: graph replays over the
  static extras buffers (models/graphs) against the eager decode_chunk (models/generate)
  from one prefilled state (fused_batch: K1, or K4 on the page arena) and the same counts,
  over two ladder chunks (EXTRAS_LADDER): tokens, counts and cache or arena bit for bit,
  and the decode kernel's counter (K2, or K3) reading layers x steps for the replays."""
  from xotorch_tpu_torch.models import generate, graphs
  ctx = engine._ctx
  m = FusedModel("bf16", ctx.cfg, ctx.params, engine.quant_route, engine.kv_quant is not None,
                 engine.dtype, ctx.shard.get_layer_count())
  state, toks, pos = fused_batch(torch, m, 1, paged, device)
  counts0 = torch.zeros((1, ctx.cfg.vocab_size), dtype=torch.int32, device=device)
  counts0[0, toks[0, 0]] = 1  # the prefill's token, counted as the engine counts it
  temps = torch.zeros((1,), device=device)
  attn, _ = _decode_kernels(m, paged)
  gc = make_cache()
  runs = {}
  for label in ("eager", "graph"):
    st, tok, p, counts, outs = _clone_state(state, paged), toks, pos.clone(), counts0.clone(), []
    attn.launches = 0
    for n in EXTRAS_LADDER:
      if label == "eager":
        kw = dict(counts=counts, frequency=2.0, route=m.route)
        if paged:
          out, _, counts = generate.decode_chunk_paged(m.params, st[0], st[1], tok, p, m.cfg, n,
                                                       temps, 0, **kw)
        else:
          out, st, counts = generate.decode_chunk_batched(m.params, st, tok, p, m.cfg, n, temps, 0,
                                                          use_flash_decode=True, **kw)
      else:
        ex = graphs.SamplerExtras(counts=counts, presence=torch.zeros((1,), device=device),
                                  frequency=torch.full((1,), 2.0, device=device))
        if paged:
          out, _ = graphs.decode_paged(gc, m.params, st[0], st[1], tok, p, m.cfg, n, temps, 0,
                                       route=m.route, extras=ex)
        else:
          out, _ = graphs.decode_contiguous(gc, m.params, st, tok, p, m.cfg, n, temps, 0,
                                            route=m.route, extras=ex)
      outs.append(out)
      tok, p = out[:, -1:].contiguous(), p + n
    runs[label] = (st, counts, torch.cat(outs, dim=1), attn.launches)
  (est, ecounts, etoks, _), (gst, gcounts, gtoks, launches) = runs["eager"], runs["graph"]
  steps = sum(EXTRAS_LADDER)
  same_toks = torch.equal(etoks, gtoks)
  same_counts = torch.equal(ecounts, gcounts) and int(gcounts.sum()) == 1 + steps
  if paged:
    same_cache = all(torch.equal(est[0][n], gst[0][n]) for n in gst[0])
  else:
    same_cache = all(torch.equal(a[n], b[n]) for a, b in zip(est, gst) for n in b)
  want = m.layers * steps if device == "cuda" else 0
  ok = same_toks and same_counts and same_cache and launches == want
  print(f"[extras] frequency_penalty 2, temperature 0, {'paged' if paged else 'contiguous'}: "
        f"chunks {EXTRAS_LADDER} of graph replays against the eager decode_chunk from the same "
        f"counts: tokens {'identical' if same_toks else 'DIFFER'}, counts "
        f"{'identical' if same_counts else 'DIFFER'} ({int(gcounts.sum())} counted), "
        f"{'arena' if paged else 'cache'} {'identical' if same_cache else 'DIFFERS'}; "
        f"{attn.__name__} launches {launches} for the replays (want {want}); {gc.captures} "
        f"capture(s) ({card}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"extras parity paged={paged}: tokens {same_toks}, counts {same_counts}, "
                         f"cache {same_cache}, launches {launches} vs {want}")


async def extras_step_ms(torch, engine, card: str, n: int = 32) -> dict:
  """The device ms a decode step takes for a plain request and for an extras one
  (EXTRAS_FIELDS) at B=1: one chunk of `n` greedy steps each under the profiler, after a
  200-token prompt and a warm chunk."""
  import numpy as np
  from torch.profiler import ProfilerActivity, profile
  from xotorch_tpu_torch.api.chatgpt_api import ChatGPTAPI
  shard = engine.shard
  out = {}
  for label, s in (("plain", None), ("extras", ChatGPTAPI._parse_sampling(EXTRAS_FIELDS).sampling)):
    rid = f"extras-profile-{label}"
    tok, _ = await engine.infer_sample_tensor(rid, shard, np.ones((1, 200), np.int64), temp=0.0,
                                              top_k=0, **({"sampling": s} if s else {}))
    toks = await engine.generate_chunk(rid, shard, int(tok), 8, temp=0.0, top_k=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      await engine.generate_chunk(rid, shard, int(toks[-1]), n, temp=0.0, top_k=0)
      torch.cuda.synchronize()
      wall = (time.perf_counter() - t0) * 1e3
    await engine.clear_request(rid)
    busy = kernels = 0
    for evt in prof.key_averages():
      us = getattr(evt, "self_device_time_total", None)
      if us is None:
        us = getattr(evt, "self_cuda_time_total", 0)
      if us > 0:
        busy += us / 1e3
        kernels += evt.count
    out[label] = busy / n if kernels else None
    print(f"[extras] {label} B=1 chunk of {n} under the profiler: wall {wall / n:.3f} ms a step, "
          + ("device time not measured" if not kernels else f"{busy / n:.3f} device ms a step")
          + f", {kernels / n:.0f} device kernels a step ({card})", flush=True)
  if out["plain"] is not None and out["extras"] is not None:
    print(f"[extras] the extras add {out['extras'] - out['plain']:.3f} device ms a step at B=1 "
          f"({card})", flush=True)
  return out


def extras_server(torch, env: dict, device: str, model: str, drive):
  """A fresh server (main.build_node) on `model` under `env`, with the word-id tokenizer
  in its API; returns `await drive(engine, node, api, base_url, tokens, steps)`: `tokens`
  the node's streams by request id, `steps` ([1]) the decode steps the engine ran."""
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.models.registry import build_full_shard
  with phase_env(**{"XOT_PREFILL_CHUNK": "1024", **env}):
    args = port_main.build_parser().parse_args(
      ["--device", device, "--default-model", model, "--chatgpt-api-host", "127.0.0.1",
       "--chatgpt-api-port", "0", "--chatgpt-api-response-timeout", "600"])
    node, engine, classname, api = port_main.build_node(args)
    api._tokenizers[model] = word_tokenizer()
    tokens, steps = {}, [0]
    node.on_token.register("chip-smoke-extras").on_next(
      lambda rid, toks, fin: tokens.__setitem__(rid, list(toks)))
    decode = engine._decode_batch_sync

    def counted(ctx, items, *a):
      res = decode(ctx, items, *a)
      steps[0] += len(res[0])
      return res
    engine._decode_batch_sync = counted

    async def run():
      server = await api.start("127.0.0.1", 0)
      base = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"
      try:
        await engine.ensure_shard(build_full_shard(model, classname))
        return await drive(engine, node, api, base, tokens, steps)
      finally:
        server.close()
        await server.wait_closed()
        await node.stop()

    try:
      return asyncio.run(run())
    finally:
      engine.executor.shutdown(wait=True)


def check_sampling_extras(torch, card: str, device: str = "cuda", model: str = "synthetic-llama-1b",
                          make_cache=None, rounds: int = 4) -> dict:
  """Phase 14: OpenAI's sampling extras served end to end, over HTTP, on fresh servers of
  `model` (contiguous, a second fresh one, paged), each check failing the run: logit_bias
  (-100 on the temperature-0 first token moves it; +100 on one id makes every token that
  id), min_p 1 at temperature 1 taking at every token its row's largest logit in the eager
  forward fed that stream (an exact tie allowed), 16 greedy tokens' logprobs and
  top_logprobs 5 within EXTRAS_LP_LIMIT of fp32 log-softmax of the eager forward's logits
  (sorted, the sampled token first), seed 7 at temperature 1 reproduced on the same server
  (its graph's generator re-seeded between replays) and on a fresh one while seed 8
  differs and n 2 with seed 7 gives two streams, frequency_penalty 2 moving the greedy
  stream and a stop string from that stream cutting its answer before it (finish
  "stop") with the engine's decode steps below max_tokens, plain n 4 at temperature 0.6
  coalescing in the batcher (mean width > 1), frequency_penalty 2 and logprobs through
  the paged server (K4 prefill, K3 decode); graph replays against the eager decode_chunk
  with the same counts bit for bit, contiguous and paged (extras_parity). K1/K2
  (contiguous) and K4/K3 (paged) counters are set to 0 before a server's requests and
  read after them, before any reference runs, and held exactly to layers x prefills and
  layers x decode steps. Then, on the card: TPOT of an extras request
  (EXTRAS_FIELDS) against a plain one at B=1, `rounds` rounds in turn; the device ms the
  extras add to a step (extras_step_ms); the captures the requests added. Returns the
  launches and the numbers. (`device`, `model` and `make_cache` let it be rehearsed on
  the CPU with synthetic-tiny and an eager stand-in for the graph cache.)"""
  from xotorch_tpu_torch.models import graphs
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention
  make_cache = make_cache or (lambda: graphs.GraphCache(device))
  t_phase = time.perf_counter()
  cuda = device == "cuda"
  url = "/v1/chat/completions"
  out: dict = {"launches": {}}

  def need(ok: bool, what: str) -> None:
    print(f"[extras] {what} ({card}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"extras: {what}")

  def asker(base, tokens):
    loop = asyncio.get_running_loop()

    async def ask(**fields):
      """POST one completion; (the response, the node's token list of each choice)."""
      resp = await loop.run_in_executor(None, http_json, base + url, extras_body(model, **fields))
      rid = resp["id"][len("chatcmpl-"):]
      n = fields.get("n", 1)
      return resp, [tokens[rid]] if n == 1 else [tokens[f"{rid}#{i}"] for i in range(n)]
    return ask

  def counted_launches(kernels, prefills: int, decoded: int, tag: str) -> dict:
    """The prefill and decode kernels' counts, held exactly to layers x prefills (one
    segment each) and layers x decode steps (none on the CPU, where no kernel runs)."""
    counts = {k.__name__: k.launches for k in kernels}
    layers = get_model_card(model)["synthetic_config"]["num_hidden_layers"] if cuda else 0
    want = {kernels[0].__name__: layers * prefills, kernels[1].__name__: layers * decoded}
    need(counts == want, f"{tag} launches {counts}: {layers} x {prefills} prefills and "
                         f"{layers} x {decoded} decode steps ({want})")
    return counts

  async def contiguous(engine, node, api, base, tokens, steps):
    ask = asker(base, tokens)
    kernels = (flash_attention, flash_cached_attention)
    await ask(temperature=0, max_tokens=2)  # warm-up
    gcache = engine._ctx.graphs
    before = (gcache.captures, gcache.capture_seconds) if gcache else (0, 0.0)
    for k in kernels:
      k.launches = 0
    steps[0] = 0
    V = engine.cfg.vocab_size
    _, [greedy] = await ask(temperature=0, max_tokens=32)
    _, [banned] = await ask(temperature=0, max_tokens=8, logit_bias={str(greedy[0]): -100})
    need(banned[0] != greedy[0], f"logit_bias -100 on the greedy first token {greedy[0]}: "
                                 f"the first token is {banned[0]}")
    forced = next(t for t in (1000, V // 2, V // 2 + 1) if t < V and t != greedy[0])
    _, [pinned] = await ask(temperature=0.8, max_tokens=16, logit_bias={str(forced): 100})
    need(pinned == [forced] * 16, f"logit_bias +100 on id {forced} at temperature 0.8: "
                                  f"{pinned.count(forced)}/16 tokens that id")
    _, [minp] = await ask(temperature=1.0, max_tokens=32, min_p=1)
    resp, [lp_toks] = await ask(temperature=0, max_tokens=16, logprobs=True, top_logprobs=5)
    items = resp["choices"][0]["logprobs"]["content"]
    need(lp_toks == greedy[:16] and [int(i["token"].strip()[1:]) for i in items] == lp_toks,
         "logprobs 5 at temperature 0: the greedy tokens, one item each naming it")
    seeded = [(await ask(temperature=1.0, max_tokens=32, seed=s))[1][0] for s in (7, 7, 8)]
    need(seeded[0] == seeded[1] != seeded[2], "seed 7 twice on one server, temperature 1 (the "
         "seeded graph's generator re-seeded between replays): the same stream; seed 8 another")
    out["seed7"] = seeded[0]
    _, pair = await ask(temperature=1.0, max_tokens=32, seed=7, n=2)
    need(pair[0] != pair[1], "n 2 with seed 7: two different streams")
    _, [pen] = await ask(temperature=0, max_tokens=32, frequency_penalty=2)
    need(pen != greedy, f"frequency_penalty 2 at temperature 0: {len(set(pen))} distinct tokens of "
                        f"32, the plain greedy stream {len(set(greedy))}")
    out["penalty_tokens"] = pen
    # A stop string from that stream (a random model's plain greedy stream repeats a few
    # tokens, so the stop would show at once): tokens 3 and 4.
    text = word_tokenizer().decode(pen)
    stop = word_tokenizer().decode(pen[3:5]).strip()
    decode_steps = steps[0]
    resp, _ = await ask(temperature=0, max_tokens=64, frequency_penalty=2, stop=[stop])
    choice = resp["choices"][0]
    used = steps[0] - decode_steps
    need(choice["message"]["content"] == text[:text.find(stop)] and choice["finish_reason"] == "stop"
         and used < 63, f"stop {stop!r} from the penalized greedy stream: the answer cut before it "
         f"({len(choice['message']['content'])} of {len(text)} characters), finish "
         f"{choice['finish_reason']!r}, {used} decode steps for max_tokens 64")
    b = engine._ctx.batcher
    dispatches, rows = b.dispatches, b.rows
    await ask(temperature=0.6, max_tokens=32, n=4)
    width = (b.rows - rows) / max(1, b.dispatches - dispatches)
    need(width > 1, f"plain n 4 at temperature 0.6: mean batch width {width:.2f} in the batcher")
    # Prefills: ten requests' and the n siblings' (2 + 4); decode steps the engine ran.
    await wait_idle(engine)
    out["launches"].update(counted_launches(kernels, 16, steps[0], "contiguous server"))
    # The references run K1 and K2 through the same wrappers: only after the counts.
    ids = await prompt_ids(engine, api, model, extras_body(model))
    # min_p 1 keeps the tokens at the largest probability: each token of the stream must
    # sit at its row's largest logit in the eager forward fed that stream (an exact
    # bf16 tie with another id allowed: then the noise picks one).
    ref = await engine._run(lp_reference, torch, engine, ids, minp)
    top = ref.max(dim=-1).values
    off = [i for i, t in enumerate(minp) if ref[i, t] != top[i]]
    tied = sum(int((ref[i] == top[i]).sum()) > 1 for i in range(len(minp)))
    part = next((i for i, (a, b) in enumerate(zip(minp, greedy)) if a != b), None)
    need(not off, f"min_p 1 at temperature 1: {len(minp) - len(off)}/{len(minp)} tokens at their "
                  f"row's largest logit ({tied} rows with a tie for it; the greedy stream "
                  f"{'kept throughout' if part is None else f'left at token {part}'})")
    ref = await engine._run(lp_reference, torch, engine, ids, lp_toks)
    out["lp_err"] = check_logprob_items(torch, "extras", items, lp_toks, ref, 5, card)
    if cuda:
      tpot = {"plain": [], "extras": []}
      loop = asyncio.get_running_loop()
      for _ in range(rounds):
        for label in ("plain", "extras"):
          body = extras_body(model, temperature=0, max_tokens=64, stream=True,
                             **(EXTRAS_FIELDS if label == "extras" else {}))
          _, first, last = await loop.run_in_executor(None, http_stream, base + url, body)
          tpot[label].append((last - first) / 63 * 1e3)
      med = {k: sorted(v)[len(v) // 2] for k, v in tpot.items()}
      print(f"[extras] TPOT at B=1 over 64 tokens, {rounds} rounds in turn: plain "
            + ", ".join(f"{v:.3f}" for v in tpot["plain"]) + " / extras (bias, penalties, "
            + "5 logprobs) " + ", ".join(f"{v:.3f}" for v in tpot["extras"])
            + f" ms; median plain {med['plain']:.3f}, extras {med['extras']:.3f} ms ({card})",
            flush=True)
      out["tpot_ms"] = med
      out["step_device_ms"] = await extras_step_ms(torch, engine, card)
    if gcache:
      out["captures"] = (gcache.captures - before[0], gcache.capture_seconds - before[1])
      print(f"[extras] the phase's requests on this server captured {out['captures'][0]} "
            f"graph(s) in {out['captures'][1]:.2f} s ({card})", flush=True)
    await wait_idle(engine)
    await engine._run(extras_parity, torch, engine, card, False, make_cache, device)
    return out

  async def fresh(engine, node, api, base, tokens, steps):
    return (await asker(base, tokens)(temperature=1.0, max_tokens=32, seed=7))[1][0]

  async def paged(engine, node, api, base, tokens, steps):
    ask = asker(base, tokens)
    kernels = (paged_prefill_attention, paged_decode_attention)
    await ask(temperature=0, max_tokens=2)
    for k in kernels:
      k.launches = 0
    steps[0] = 0
    _, [pen] = await ask(temperature=0, max_tokens=32, frequency_penalty=2)
    resp, [lp_toks] = await ask(temperature=0, max_tokens=16, logprobs=True, top_logprobs=5,
                                presence_penalty=1)
    items = resp["choices"][0]["logprobs"]["content"]
    need(len(items) == 16 and engine.page_pool_stats() is not None,
         "paged server: frequency_penalty 2 and a logprobs request answered from the page pool")
    await wait_idle(engine)
    launches = counted_launches(kernels, 2, steps[0], "paged server")
    same = sum(a == b for a, b in zip(pen, out["penalty_tokens"]))
    print(f"[extras] paged frequency_penalty 2 tokens the contiguous server shares: {same}/32 "
          f"(bf16: not asserted) ({card})", flush=True)
    await wait_idle(engine)
    await engine._run(extras_parity, torch, engine, card, True, make_cache, device)
    return launches

  extras_server(torch, {"XOT_PAGED_KV": "0"}, device, model, contiguous)
  seed7 = extras_server(torch, {"XOT_PAGED_KV": "0"}, device, model, fresh)
  need(seed7 == out["seed7"], "seed 7 at temperature 1 on a fresh server: the first server's "
                              "stream")
  out["launches"].update(extras_server(torch, {"XOT_PAGED_KV": "1"}, device, model, paged))
  print(f"[extras] phase 14 took {time.perf_counter() - t_phase:.1f} s; launches "
        f"{out['launches']} ({card})", flush=True)
  return out


OBSERVE_WORDS = 300  # prompt words of the observability phase's own requests
OBSERVE_SHARE_LIMIT = 0.15  # decode lane tok/s against the client's rate
OBSERVE_KERNELS = ("flash_prefill_kernel", "flash_cached_")  # K1 and K2 in a device trace


def http_text(url: str, timeout: float = 300.0) -> str:
  import urllib.request
  with urllib.request.urlopen(url, timeout=timeout) as resp:
    return resp.read().decode()


def http_status(url: str, body, timeout: float = 300.0):
  """POST `body`; (status, headers, JSON body), an HTTP error's too."""
  import urllib.error
  import urllib.request
  req = urllib.request.Request(url, data=json.dumps(body).encode(),
                               headers={"Content-Type": "application/json"})
  try:
    with urllib.request.urlopen(req, timeout=timeout) as resp:
      return resp.status, dict(resp.headers), json.loads(resp.read())
  except urllib.error.HTTPError as e:
    return e.code, dict(e.headers), json.loads(e.read())


def prom_samples(text: str) -> dict:
  """Prometheus text as {series: value}."""
  out = {}
  for line in text.splitlines():
    if line and not line.startswith("#"):
      series, value = line.rsplit(" ", 1)
      out[series] = float(value)
  return out


def observe_body(model: str, max_tokens: int, stream: bool, words: int = OBSERVE_WORDS) -> dict:
  body = {"model": model, "temperature": 0, "max_tokens": max_tokens,
          "messages": [{"role": "user", "content": " ".join(f"w{i % 89}" for i in range(words))}]}
  if stream:
    body.update(stream=True, stream_options={"include_usage": True})
  return body


async def profiled_chunk(torch, engine, model: str, rid: str, n: int = 32) -> tuple:
  """One n-token B=1 decode chunk of a fresh 514-token request on the engine, under
  torch.profiler (CUDA activity): (kernels' device seconds, the decode lane's booked
  bytes and FLOPs for the chunk, the chunk's wall seconds). Off the card, device time
  is not measured (0)."""
  import numpy as np
  from xotorch_tpu_torch.models.registry import build_full_shard
  shard = build_full_shard(model, type(engine).__name__)
  tok, _ = await engine.infer_sample_tensor(rid, shard, np.ones((1, 514), np.int64), temp=0.0, top_k=0)
  out = await engine.generate_chunk(rid, shard, int(tok), 8, temp=0.0)
  lanes = engine.perf.lanes() if engine.perf is not None else {}
  before = lanes.get("decode", {"hbm_bytes": 0, "flops": 0})
  device_s = 0.0
  t0 = time.perf_counter()
  if engine.device.type == "cuda":
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      await engine.generate_chunk(rid, shard, int(out[-1]), n, temp=0.0)
    for evt in prof.key_averages():
      us = getattr(evt, "self_device_time_total", None)
      device_s += (us if us is not None else getattr(evt, "self_cuda_time_total", 0)) / 1e6
  else:
    await engine.generate_chunk(rid, shard, int(out[-1]), n, temp=0.0)
  wall = time.perf_counter() - t0
  await engine.clear_request(rid)
  after = engine.perf.lanes()["decode"] if engine.perf is not None else before
  return device_s, after["hbm_bytes"] - before["hbm_bytes"], after["flops"] - before["flops"], wall


def observability_switch(node, engine, on: bool, perf) -> None:
  """Every recorder's switch flipped as its XOT_* knob would set it when the node is
  built: tracing, the flight recorder, anatomy and its clock stamps, alerts, history
  and the engine's attribution (XOT_PERF_ATTR)."""
  for rec in (node.tracer, node.flight, node.anatomy, node.clock, node.alerts, node.history):
    rec.enabled = on
  engine.perf = perf if on else None


def check_observability(torch, card: str, device: str = "cuda", model: str = "synthetic-llama-1b",
                        rounds: int = 4) -> dict:
  """Phase 15: the observability layer on a fresh server at full width and depth, bf16,
  every observability knob at its default (the alert and history loops started as
  node.start() starts them). The main path's three requests (drive_main_path: K1's and
  K2's launches counted), then, on the same server: /v1/perf's bf16_weight_bytes held
  to the parameters on the card; a streamed 64-token request, after which 0 <
  hbm_util_pct, mfu_pct <= 100 and the decode lane's tok/s is within
  OBSERVE_SHARE_LIMIT of the client's; one profiled 32-token chunk whose booked bytes
  over the card's peak over the kernels' device time (the bound share) is at most 1;
  the device-trace routes around one request, their Chrome trace holding K1's and K2's
  kernels; admission with XOT_MAX_INFLIGHT=1 and XOT_ADMIT_QUEUE_DEPTH=1 (one request
  served, one queued, one 429 with Retry-After, as /v1/queue shows); /metrics, whose
  request counter and TTFT count equal the requests made and which carries the
  utilization gauges; /v1/traces, one trace per request with the JAX package's span
  names, parents that resolve and ordered times; then TPOT and device ms a step with
  every recorder on against all off, `rounds` rounds in turn. Returns the launches."""
  import tempfile
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  tag = "observe"
  t_phase = time.perf_counter()

  async def after(engine, node, api, base):
    loop = asyncio.get_running_loop()
    call = lambda fn, *a: loop.run_in_executor(None, fn, *a)  # noqa: E731
    node.start_alerts()
    node.start_history()
    made = 2 * len(main_requests(model))  # drive_main_path's warm-up and measured requests
    url = base + "/v1/chat/completions"
    await weight_bytes_held(engine, base, None, tag, card)

    # Shares: a streamed 64-token B=1 request.
    lanes = engine.perf.lanes()["decode"]
    events, first, last = await call(http_stream, url, observe_body(model, 64, True))
    made += 1
    n = (events[-1].get("usage") or {}).get("completion_tokens", 0)
    client = (n - 1) / (last - first)
    now = engine.perf.lanes()["decode"]
    lane = (now["tokens"] - lanes["tokens"]) / (now["secs"] - lanes["secs"])
    gauges = (await call(http_json, base + "/v1/perf"))["gauges"]
    ok = (0 < gauges["hbm_util_pct"] <= 100 and 0 < gauges["mfu_pct"] <= 100
          and abs(lane - client) <= OBSERVE_SHARE_LIMIT * client)
    print(f"[{tag}] streamed {n} tokens: client {client:.1f} tok/s, decode lane {lane:.1f} tok/s "
          f"({100 * (lane / client - 1):+.1f}%), gauges hbm_util_pct {gauges['hbm_util_pct']} "
          f"mfu_pct {gauges['mfu_pct']} decode_tok_s {gauges['decode_tok_s']} ({card}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok and device == "cuda":
      raise AssertionError(f"{tag}: gauges {gauges}, lane {lane} against client {client}")

    # Bound share: the cost model's bytes for one profiled chunk against its device time.
    device_s, nbytes, flops, wall = await profiled_chunk(torch, engine, model, "observe-bound")
    share = nbytes / PEAK_HBM_BYTES / device_s if device_s else float("nan")
    ok = 0 < share <= 1.0
    print(f"[{tag}] a 32-token B=1 chunk: cost model {nbytes} bytes = {1e3 * nbytes / PEAK_HBM_BYTES:.3f} "
          f"ms at {PEAK_HBM_BYTES / 1e12:g} TB/s, {flops} FLOPs = {1e3 * flops / PEAK_BF16_FLOPS:.3f} ms; "
          f"kernels {1e3 * device_s:.3f} device ms ({1e3 * device_s / 32:.3f} a step), wall "
          f"{1e3 * wall:.3f} ms; bound share {share:.4f} ({card}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok and device == "cuda":
      raise AssertionError(f"{tag}: bound share {share} (over 1 means the count is wrong)")

    # Device trace through the routes, around one request.
    logdir = tempfile.mkdtemp(prefix="xot_device_trace_")
    try:
      started = await call(http_status, base + "/v1/trace/device/start", {"logdir": logdir})
      await call(http_json, url, observe_body(model, 16, False, words=600))
      made += 1
      stopped = await call(http_status, base + "/v1/trace/device/stop", {})
      files = os.listdir(logdir)
      with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
      kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
      found = {k: sum(k in name for name in kernels) for k in OBSERVE_KERNELS}
      ok = (started[2]["started"] and stopped[2] == {"stopped": True} and len(files) == 1
            and (device != "cuda" or all(found.values())))
      print(f"[{tag}] device trace: {len(events)} events, {len(kernels)} kernels, {found} "
            f"({card}) {'ok' if ok else 'FAIL'}", flush=True)
      if not ok:
        raise AssertionError(f"{tag}: device trace {started} {stopped} {files} {found}")
    finally:
      import shutil
      shutil.rmtree(logdir, ignore_errors=True)

    # Admission: a gate of one slot and a queue of one, as the knobs would build it.
    from xotorch_tpu_torch.orchestration.admission import AdmissionGate
    with phase_env(XOT_MAX_INFLIGHT="1", XOT_ADMIT_QUEUE_DEPTH="1"):
      gate = AdmissionGate(node)
    saved, node.admission = node.admission, gate
    try:
      held = asyncio.ensure_future(call(http_status, url, observe_body(model, 256, False)))
      while gate.inflight < 1:
        await asyncio.sleep(0.005)
      queued = asyncio.ensure_future(call(http_status, url, observe_body(model, 8, False)))
      while gate.compact()["queued"] < 1:
        await asyncio.sleep(0.005)
      shed = await call(http_status, url, observe_body(model, 8, False))
      queue = await call(http_json, base + "/v1/queue")
      results = [await held, await queued]
      made += 2
    finally:
      node.admission = saved
    adm = queue["admission"]
    ok = (shed[0] == 429 and int(shed[1].get("Retry-After", 0)) >= 1
          and [r[0] for r in results] == [200, 200] and queue["enabled"]
          and (adm["inflight"], adm["queued"], adm["rejected_total"]) == (1, 1, 1))
    print(f"[{tag}] admission (1 slot, a queue of 1): {[r[0] for r in results]} served, one 429 "
          f"Retry-After {shed[1].get('Retry-After')} s, /v1/queue inflight {adm['inflight']} queued "
          f"{adm['queued']} rejected {adm['rejected_total']} est_wait_s {adm['est_wait_s']} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"{tag}: admission {shed[:2]} {results} {queue}")

    # Prometheus text and spans.
    await wait_idle(engine)
    await asyncio.sleep(0.1)  # the last finish's span flush
    samples = prom_samples(await call(http_text, base + "/metrics"))
    requests = next(v for k, v in samples.items() if k.startswith("xot_requests_total{"))
    ttft = next(v for k, v in samples.items() if k.startswith("xot_ttft_seconds_count{"))
    util = [k for k in ("xot_mfu_pct", "xot_hbm_util_pct") if k in samples]
    ok = requests == made and ttft == made and len(util) == 2
    print(f"[{tag}] /metrics: {len(samples)} samples, xot_requests_total {requests:g}, "
          f"xot_ttft_seconds_count {ttft:g} for {made} requests, {util} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"{tag}: /metrics requests {requests}, ttft {ttft}, made {made}, {util}")
    spans = (await call(http_json, base + "/v1/traces"))["spans"]
    traces = {}
    for sp in spans:
      traces.setdefault(sp["traceId"], []).append(sp)
    bad = []
    for tid, trace in traces.items():
      ids = {sp["spanId"]: sp for sp in trace}
      names = {sp["name"] for sp in trace}
      if not {"process_prompt", "engine.prefill"} <= names or not any(x.startswith("tokens[") for x in names):
        bad.append((tid, sorted(names)))
      for sp in trace:
        parent = ids.get(sp["parentSpanId"])
        if (sp["startTimeUnixNano"] > sp["endTimeUnixNano"]
            or (sp["name"] != "process_prompt" and parent is None)
            or (parent is not None and sp["startTimeUnixNano"] < parent["startTimeUnixNano"])):
          bad.append((tid, sp["name"]))
    ok = len(traces) == made and not bad
    print(f"[{tag}] /v1/traces: {len(spans)} spans in {len(traces)} traces for {made} requests, "
          f"names {sorted({sp['name'] for sp in spans if not sp['name'].startswith('tokens[')})} + "
          f"tokens[...] groups {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"{tag}: traces {len(traces)} for {made}, bad {bad[:5]}")

    # Overhead: every recorder on against all off, in turns.
    perf = engine.perf
    runs = {True: [], False: []}
    try:
      for r in range(rounds):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
          observability_switch(node, engine, on, perf)
          events, first, last = await call(http_stream, url, observe_body(model, 64, True))
          n = (events[-1].get("usage") or {}).get("completion_tokens", 0)
          device_s, _, _, _ = await profiled_chunk(torch, engine, model, f"observe-{r}-{on}")
          runs[on].append((1e3 * (last - first) / (n - 1), 1e3 * device_s / 32))
    finally:
      observability_switch(node, engine, True, perf)
    med = {on: (sorted(x[0] for x in v)[len(v) // 2], sorted(x[1] for x in v)[len(v) // 2])
           for on, v in runs.items()}
    print(f"[{tag}] overhead, {rounds} rounds in turn: TPOT median {med[True][0]:.4f} ms on, "
          f"{med[False][0]:.4f} ms off ({med[True][0] - med[False][0]:+.4f}); device ms a step "
          f"{med[True][1]:.4f} on, {med[False][1]:.4f} off ({med[True][1] - med[False][1]:+.4f}); "
          f"each round (TPOT, device ms) on {runs[True]} off {runs[False]} ({card})", flush=True)
    return med

  run = drive_main_path(torch, card, device=device, model=model, tag=tag, profiles=(),
                        kernels=(flash_attention, flash_cached_attention), after=after)
  print(f"[time] phase 15 (observability): {time.perf_counter() - t_phase:.1f} s", flush=True)
  return run["launches"]


KV_SIZES = {
  # chunk: XOT_PREFILL_CHUNK; head: a shared head's tokens (the "user:" token and its
  # words); odd: a head off the segment boundary; tail: a request's own words; new: greedy
  # tokens a request streams; long: phase 16's co-scheduled prompt; rounds: one-token
  # decode rounds of its four streams; short: their prompts' words; page: XOT_KV_PAGE;
  # oom: the words of a prompt whose cache cannot be allocated.
  "synthetic-llama-1b": dict(chunk=1024, head=3072, odd=2000, tail=100, new=32, long=6144,
                             rounds=96, short=300, page=128, oom=30000),
  "synthetic-tiny": dict(chunk=64, head=192, odd=100, tail=12, new=12, long=384, rounds=24,
                         short=20, page=16, oom=1500),
}
KV_KERNELS = ("flash_attention", "flash_cached_attention", "paged_decode_attention",
              "paged_prefill_attention")


def id_tokenizer():
  """The DummyTokenizer that maps a word "w<n>" to token n and any other word (the chat
  template's "user:" and "assistant:") to 1, and decodes ids as words: phase 16's
  prompts are exact token sequences, sent as text."""
  from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer

  class Ids(DummyTokenizer):
    def encode(self, text: str):
      return [int(w[1:]) if w[:1] == "w" and w[1:].isdigit() else 1 for w in text.split()]

    def decode(self, tokens) -> str:
      return "".join(f" w{int(t)}" for t in tokens)
  return Ids()


def kv_ids(seed: int, n: int, vocab: int) -> list:
  """n token ids from a seed, none of them the id tokenizer's "user:" token (1) or its
  eos (69)."""
  import numpy as np
  ids = np.random.default_rng(seed).integers(3, vocab, size=n)
  ids[ids == 69] = 70
  return [int(i) for i in ids]


class KVPrompt(NamedTuple):
  """One request of phase 16: the API's message text and the tokens the engine prefills
  for it ([1] + words + [1], as the DummyTokenizer's template gives them)."""
  text: str
  ids: list

  @staticmethod
  def of(head: list, tail: list) -> "KVPrompt":
    words = head + tail
    return KVPrompt(" ".join(f"w{i}" for i in words), [1] + words + [1])

  def body(self, model: str, max_tokens: int, stream: bool = True) -> dict:
    body = {"model": model, "temperature": 0, "max_tokens": max_tokens,
            "messages": [{"role": "user", "content": self.text}]}
    if stream:
      body.update(stream=True, stream_options={"include_usage": True})
    return body


class KVTally:
  """Phase 16's counted work: the four attention kernels' launches as the wrappers count
  them, and as layers x (prefill segments + decode steps) predict them. A decode step is
  counted where the engine runs it (a wrapper around _decode_batch_sync); `uncounted()`
  brackets the references, whose launches and steps are left out of both."""

  def __init__(self, layers: int, chunk: int):
    from xotorch_tpu_torch.models import graphs
    self.wrappers = {fn.__name__: fn for fn in graphs.counted_wrappers()
                     if fn.__name__ in KV_KERNELS}
    self.layers, self.chunk = layers, chunk
    self.want = dict.fromkeys(KV_KERNELS, 0)
    self.paused = False
    for fn in self.wrappers.values():
      fn.launches = 0

  def counts(self) -> dict:
    return {name: self.wrappers[name].launches for name in KV_KERNELS}

  @contextlib.contextmanager
  def uncounted(self):
    saved, paused, self.paused = self.counts(), self.paused, True
    try:
      yield
    finally:
      for name, n in saved.items():
        self.wrappers[name].launches = n
      self.paused = paused

  def watch(self, engine) -> None:
    """Count `engine`'s decode steps: K2 (contiguous) or K3 (paged) per layer a step."""
    decode = engine._decode_batch_sync

    def counted(ctx, items, *a):
      res = decode(ctx, items, *a)
      if not self.paused:
        name = "paged_decode_attention" if engine.paged else "flash_cached_attention"
        self.want[name] += self.layers * len(res[0])
      return res
    engine._decode_batch_sync = counted

  def prefill(self, T: int, consumed: int, paged: bool, sliced: bool) -> None:
    """A prefill of T tokens, `consumed` of them reused: every segment of the rest runs
    K4 on the page arena; on a contiguous cache a fresh prompt's first segment runs K1
    when it is not in a scan group (the one-call path scans two whole segments or more;
    a co-scheduled slice is one segment), every other segment K2."""
    if self.paused:
      return
    rest = T - consumed
    segs = -(-rest // self.chunk)
    if paged:
      self.want["paged_prefill_attention"] += self.layers * segs
      return
    split = ((rest - 1) // self.chunk) * self.chunk if rest > self.chunk else 0
    k1 = consumed == 0 and (split == 0 or sliced or split < 2 * self.chunk)
    self.want["flash_attention"] += self.layers * int(k1)
    self.want["flash_cached_attention"] += self.layers * (segs - int(k1))

  def check(self, tag: str, card: str) -> dict:
    got = self.counts()
    ok = got == self.want
    print(f"[kv] {tag} launches {got}: layers x (prefill segments + decode steps) = {self.want} "
          f"{'ok' if ok else 'FAIL'} ({card})", flush=True)
    if not ok:
      raise AssertionError(f"kv: {tag} launches {got}, wanted {self.want}")
    return got


@contextlib.contextmanager
def cache_off(engine):
  """The engine's prefix cache switched off (no reuse, no store): its cold twin."""
  saved, engine._prefix_cache_max = engine._prefix_cache_max, 0
  try:
    yield
  finally:
    engine._prefix_cache_max = saved


async def kv_generate(engine, rid: str, ids: list, n: int, shard=None) -> list:
  """`n` greedy tokens of a prompt through the engine (B=1 unless other requests decode
  at the same time), on `shard` (default the active one), the request cleared after."""
  import numpy as np
  shard = shard or engine.shard
  tok, _ = await engine.infer_sample_tensor(rid, shard, np.asarray([ids]), temp=0.0, top_k=0)
  out, size = [int(tok)], 8
  while len(out) < n:
    chunk = await engine.generate_chunk(rid, shard, out[-1], min(size, n - len(out)), temp=0.0, top_k=0)
    out.extend(int(t) for t in np.asarray(chunk).reshape(-1))
    size *= 2
  await engine.clear_request(rid)
  return out[:n]


async def kv_logits(engine, rid: str, ids: list, warm: bool, sliced: bool = False):
  """fp32 logits at a prompt's last position through the engine's own prefill steps:
  prefix reuse first when `warm`, the rest's whole segments as one fill (or one a fill,
  as co-scheduled slices run them), the last segment through the unembedding."""
  import numpy as np
  ctx, toks = engine._ctx, np.asarray([ids])

  def body():
    paged = engine._paged_segment(ctx, rid, toks)
    consumed = engine._prefix_reuse(ctx, rid, toks, paged_native=paged) if warm else 0
    rest, chunk = toks[:, consumed:], engine._prefill_chunk()
    if rest.shape[1] > chunk:
      split = ((rest.shape[1] - 1) // chunk) * chunk
      for off in (range(0, split, chunk) if sliced else (0,)):
        end = off + chunk if sliced else split
        engine._prefill_fill_sync(ctx, rid, rest[:, off:end], paged)
      rest = rest[:, split:]
    out, t = engine._forward_segment(ctx, rid, rest)
    return out[0, t - 1].float().cpu()
  with cache_off(engine) if not warm else contextlib.nullcontext():
    logits = await engine._run(body)
  await engine.clear_request(rid)
  return logits


def rel_err(got, want) -> float:
  return float((got - want).abs().max() / want.abs().max())


def stream_ids(events) -> list:
  """The token ids of a streamed answer whose tokenizer decodes ids as words."""
  text = "".join(c.get("delta", {}).get("content") or "" for e in events for c in e.get("choices", []))
  return [int(w[1:]) for w in text.split()]


def kv_server(torch, env: dict, device: str, model: str, drive):
  """A fresh server on `model` under `env` with the id tokenizer in its API and its
  engine; returns `await drive(engine, node, api, base_url)`."""
  tok = id_tokenizer()

  async def wrapped(engine, node, api, base, tokens, steps):
    api._tokenizers[model] = tok
    engine._ctx.tokenizer = tok
    return await drive(engine, node, api, base)
  return extras_server(torch, env, device, model, wrapped)


def kv_engine(env: dict, device: str, model: str, drive):
  """A fresh engine alone on `model` under `env` (XOT_PREFILL_CHUNK set by the caller);
  returns `await drive(engine)`."""
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  from xotorch_tpu_torch.models.registry import build_full_shard
  with phase_env(**env):
    engine = TorchShardInferenceEngine(device=device, seed=0)

    async def run():
      await engine.ensure_shard(build_full_shard(model, type(engine).__name__))
      engine._ctx.tokenizer = id_tokenizer()
      return await drive(engine)
    try:
      return asyncio.run(run())
    finally:
      engine.executor.shutdown(wait=True)


def check_kv_reuse(torch, card: str, device: str = "cuda", model: str = "synthetic-llama-1b") -> dict:
  """Phase 16: the JAX server's default-on KV reuse and prefill scheduling on `model` at
  full width and depth, bf16, default knobs unless a step says otherwise
  (XOT_PREFILL_CHUNK 1024; sizes in KV_SIZES). Every check fails the run.
  1. contiguous prefix hits, over HTTP: one cold request and three warm ones share a head
     of three whole segments; their temperature-0 streams are bit for bit those of a
     fresh XOT_PREFIX_CACHE=0 server; hits 3 and tokens saved 3 x the head; TTFT cold
     against warm. A head off the segment boundary: its warm first-token logits within
     PREFILL_REL_LIMIT of the cold ones (one segmentation against another), the share
     of greedy tokens its warm and cold streams agree on;
  2. paged hits (page 128), through the engine: four warm requests prefilled at once
     share the head's pages in place (each page's refcount = the entries and requests
     holding it), use under 4 x a cold request's pages, copy nothing (no commit bytes,
     no gathered seed), and decode their cold twins' streams (the same engine with its
     prefix cache off);
  3. the host tier, over HTTP on a paged server with XOT_PREFIX_CACHE=1: three heads in
     turn, each switch spilling the head's pages; the third spill over the 256 MiB budget
     records host.evict; a returning head restores from the host and streams its cold
     twin; /metrics' host hits, spill and fetch bytes equal the engine's and the flight
     recorder's; TTFT cold, HBM-warm and host-warm; /v1/prefetch of a queued head, after
     which its request pays no fetch; no restore fell back to a cold prefill;
  4. co-scheduling, through fresh engines with XOT_PREFILL_COSCHED 1 and 0: a long prompt
     arrives while four streams decode in one-token rounds; the streams agree in both
     modes up to the round the long request joins (the share after it printed), its
     first-token logits agree within the limit, and the longest round (inter-token gap)
     is about one slice with co-scheduling and the whole prefill without; p50 TPOT and
     the prefill slices;
  5. OOM recovery: on step 2's engine a forced _free_device_memory spills both entries and
     drops the graphs, the slab, the pool and every state; the next request on a spilled
     head restores it, captures its graphs afresh and streams its cold twin. Then a fresh
     server whose card allows only 768 MiB more than it holds: a prompt whose cache
     cannot be allocated gets the API's CacheExhausted answer (400,
     context_length_exceeded) through a real torch.OutOfMemoryError, and the next short
     request a 200.
  K1-K4 launches are counted over the steps (the references excluded) and held exactly
  to layers x (prefill segments + decode steps). Returns them."""
  import numpy as np
  from xotorch_tpu_torch.models.registry import get_model_card
  t_phase = time.perf_counter()
  cuda = device == "cuda"
  sz = KV_SIZES[model]
  chunk, page, new = sz["chunk"], sz["page"], sz["new"]
  cfg = get_model_card(model)["synthetic_config"]
  V, L = cfg["vocab_size"], cfg["num_hidden_layers"]
  itemsize = 4 if os.environ.get("XOT_DTYPE") == "float32" else 2
  # K and V of every layer: 32 KiB a token at llama-1b's widths in bf16.
  kv_token_bytes = (2 * L * cfg["num_key_value_heads"]
                    * (cfg["hidden_size"] // cfg["num_attention_heads"]) * itemsize)
  head_bytes = sz["head"] * kv_token_bytes
  tally = KVTally(L, chunk)
  env = {"XOT_PREFILL_CHUNK": str(chunk), "XOT_KV_PAGE": str(page)}
  if model != "synthetic-llama-1b":  # a budget of 8/3 heads, as 256 MiB is of 96 MiB
    env["XOT_KV_HOST_BYTES"] = str(8 * head_bytes // 3)
  url = "/v1/chat/completions"
  head = kv_ids(1, sz["head"] - 1, V)
  heads = [head] + [kv_ids(2 + h, sz["head"] - 1, V) for h in range(2)]
  odd = kv_ids(9, sz["odd"] - 1, V)
  tail = lambda i: kv_ids(100 + i, sz["tail"], V)  # noqa: E731
  out: dict = {}

  def need(ok: bool, what: str) -> None:
    print(f"[kv] {what} ({card}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"kv: {what}")

  def med(xs):
    return sorted(xs)[len(xs) // 2]

  async def serve(base, prompt: KVPrompt):
    """One streamed request: (its tokens, TTFT ms)."""
    loop = asyncio.get_running_loop()
    events, first, _ = await loop.run_in_executor(None, http_stream, base + url,
                                                  prompt.body(model, new))
    return stream_ids(events), 1e3 * first

  async def warm_up(engine, base):
    """A request of a head's shape on another head, uncounted, its entry dropped after:
    the graphs the measured requests replay are captured before their TTFT is read."""
    with tally.uncounted():
      await serve(base, KVPrompt.of(kv_ids(90, sz["head"] - 1, V), tail(90)))
      await wait_idle(engine)
      await engine._run(engine._clear_prefix_cache, engine._ctx)

  # ---------------------------------------------------------- 1. contiguous hits
  warm_prompts = [KVPrompt.of(head, tail(i)) for i in range(4)]
  odd_prompts = [KVPrompt.of(odd, tail(10 + i)) for i in range(2)]

  async def step1(engine, node, api, base):
    tally.watch(engine)
    await warm_up(engine, base)
    streams, ttft = [], []
    for i, p in enumerate(warm_prompts + odd_prompts):
      saved = engine._prefix_tokens_saved
      toks, ms = await serve(base, p)
      consumed = engine._prefix_tokens_saved - saved
      tally.prefill(len(p.ids), consumed, False, False)
      streams.append(toks)
      ttft.append(ms)
      await wait_idle(engine)
    hits, saved = engine._prefix_hits, engine._prefix_tokens_saved
    need(engine._ctx.batcher.slices == 0, "step 1: every prefill one call (no request active beside it)")
    tally.check("step 1 (contiguous server)", card)
    with tally.uncounted():  # a third tail: the warm reference reuses the head alone
      probe = KVPrompt.of(odd, tail(12)).ids
      cold = await kv_logits(engine, "odd-cold", probe, warm=False)
      warm = await kv_logits(engine, "odd-warm", probe, warm=True)
    return streams, ttft, hits, saved, rel_err(warm, cold)

  streams, ttft, hits, saved, odd_err = kv_server(torch, {**env, "XOT_PAGED_KV": "0"}, device,
                                                  model, step1)

  async def reference(engine, node, api, base):
    out = []
    for p in warm_prompts + odd_prompts:
      out.append((await serve(base, p))[0])
      await wait_idle(engine)
    return out
  with tally.uncounted():
    ref = kv_server(torch, {**env, "XOT_PAGED_KV": "0", "XOT_PREFIX_CACHE": "0"}, device, model,
                    reference)
  need(streams[:4] == ref[:4] and all(streams[:4]),
       f"step 1: the cold and three warm temperature-0 streams ({[len(s) for s in streams[:4]]} "
       f"tokens) bit for bit those of a XOT_PREFIX_CACHE=0 server")
  need(hits == 4 and saved == 3 * sz["head"] + (sz["odd"]),
       f"step 1: prefix hits {hits} = 3 warm + 1 off-boundary; tokens saved {saved} = 3 x "
       f"{sz['head']} + {sz['odd']}")
  need(odd_err <= PREFILL_REL_LIMIT,
       f"step 1: a {sz['odd']}-token head (off the segment boundary): warm first-token logits "
       f"within {PREFILL_REL_LIMIT} of the cold ones (max error / max |cold| {odd_err:.2e})")
  agree = sum(a == b for a, b in zip(streams[5], ref[5]))
  print(f"[kv] step 1: the off-boundary head's warm stream shares {agree}/{new} greedy tokens with "
        f"its cold twin (not asserted) ({card})", flush=True)
  print(f"[kv] step 1: TTFT of a {len(warm_prompts[0].ids)}-token prompt, cold {ttft[0]:.1f} ms, "
        f"warm (a {sz['head']}-token hit) {', '.join(f'{t:.1f}' for t in ttft[1:4])} ms (median "
        f"{med(ttft[1:4]):.1f}) ({card})", flush=True)
  out["ttft_contiguous"] = (ttft[0], med(ttft[1:4]))
  contiguous_streams = streams[:4]

  # --------------------------------------------- 2. paged hits, 5. forced OOM recovery
  async def step2(engine):
    tally.watch(engine)
    ctx = engine._ctx
    cold = KVPrompt.of(head, tail(0))
    tally.prefill(len(cold.ids), 0, True, False)
    cold_stream = await kv_generate(engine, "c0", cold.ids, new)
    (etoks, entry), = ctx.prefix_cache.values()
    cold_pages = ctx.page_pool.pages_for(len(cold.ids))
    warm = [KVPrompt.of(head, tail(i)) for i in range(1, 5)]
    shard = engine.shard
    firsts = await asyncio.gather(*(engine.infer_sample_tensor(f"w{i}", shard, np.asarray([p.ids]),
                                                               temp=0.0, top_k=0)
                                    for i, p in enumerate(warm)))
    for p in warm:
      tally.prefill(len(p.ids), sz["head"], True, False)
    pool = ctx.page_pool
    shared = entry["pages"][:sz["head"] // page]
    holders = {p: sum(p in st.pages.blocks for st in ctx.states.values())
               + sum(p in e.get("pages", ()) for _, e in ctx.prefix_cache.values())
               for p in shared}
    refs = {p: pool.refcount(p) for p in shared}
    states = [ctx.states[f"w{i}"] for i in range(4)]
    need(all(refs[p] == holders[p] for p in shared)
         and all(st.pages.blocks[:len(shared)] == shared for st in states),
         f"step 2: four warm requests hold the head's {len(shared)} pages in place; each page's "
         f"refcount {sorted(set(refs.values()))} = the requests (4) and entries holding it "
         f"{sorted(set(holders.values()))}")
    need(pool.pages_in_use < 4 * cold_pages and engine._commit_copy_bytes == 0
         and all(st.paged_seed is None for st in states) and engine._prefix_hits == 4,
         f"step 2: {pool.pages_in_use} pages in use (entries included) < 4 x {cold_pages} of a cold "
         f"request; commit copy bytes {engine._commit_copy_bytes}, no gathered seed")
    got = []
    for i, (tok, _) in enumerate(firsts):
      toks = [int(tok)]
      while len(toks) < new:
        c = await engine.generate_chunk(f"w{i}", shard, toks[-1], min(8, new - len(toks)), temp=0.0,
                                        top_k=0)
        toks.extend(int(t) for t in np.asarray(c).reshape(-1))
      got.append(toks)
      await engine.clear_request(f"w{i}")
    # 5a: the forced recovery, before any reference runs.
    entries, spilled = len(ctx.prefix_cache), engine._host_spill_bytes
    await engine._run(engine._free_device_memory)
    gc = ctx.graphs
    spilled = engine._host_spill_bytes - spilled
    need(entries == 2 and spilled == 2 * (head_bytes + 8 * len(cold.ids))
         and not ctx.prefix_cache and ctx.page_pool is None and not ctx.states
         and (gc is None or (not gc.programs and gc.slab is None)),
         f"step 5: a forced _free_device_memory spilled both prefix entries to the host tier "
         f"({spilled} bytes) and dropped the graphs, the slab, the pool and every state")
    captures = gc.captures if gc is not None else 0
    back = KVPrompt.of(head, tail(5))
    hits = engine._host_kv_hits
    tally.prefill(len(back.ids), sz["head"], True, False)
    after = await kv_generate(engine, "after-oom", back.ids, new)
    recaptured = (gc.captures - captures) if gc is not None else 0
    need(engine._host_kv_hits == hits + 1 and (gc is None or recaptured > 0),
         f"step 5: the next request on a spilled head restored it from the host tier and "
         f"captured {recaptured} graph(s) afresh")
    tally.check("steps 2 and 5 (paged engine)", card)
    with tally.uncounted(), cache_off(engine):
      twins = [await kv_generate(engine, f"twin{i}", p.ids, new)
               for i, p in enumerate([cold] + warm + [back])]
    return cold_stream, got, twins, after

  cold_paged, warm_paged, twins, after = kv_engine({**env, "XOT_PAGED_KV": "1"}, device, model, step2)
  need(cold_paged == twins[0] and warm_paged == twins[1:5] and after == twins[5],
       "steps 2 and 5: the four warm paged streams, and the stream restored after the recovery, "
       "bit for bit their cold twins")
  agree = sum(a == b for s, t in zip(warm_paged[:3], contiguous_streams[1:]) for a, b in zip(s, t))
  print(f"[kv] step 2: paged warm streams share {agree}/{3 * new} tokens with step 1's contiguous "
        f"ones (K4/K3 against K2: not asserted) ({card})", flush=True)

  # ------------------------------------------------------------- 3. the host tier
  # One device entry and room for two heads on the host: H1, H2, H3 cold (the second and
  # third switches spill the head before); H1 returns (restored from the host; the spill
  # of H3 that makes room for it is the third, over the budget: host.evict); /v1/prefetch
  # announces H3 queued (restored before its request); H3 again, warm on the device.
  rotation = [KVPrompt.of(h, tail(20)) for h in heads]
  host_warm, queued, hbm = (KVPrompt.of(heads[0], tail(21)), KVPrompt.of(heads[2], tail(23)),
                            KVPrompt.of(heads[2], tail(24)))
  entry_bytes = head_bytes + 8 * len(rotation[0].ids)  # its pages and its prompt's ids

  async def step3(engine, node, api, base):
    tally.watch(engine)
    await warm_up(engine, base)
    flight, loop = node.flight, asyncio.get_running_loop()
    spill_bytes, ttft, got = [], {}, {}

    def evicts():
      return sum(e["event"] == "host.evict" for e in flight.tail())

    for i, p in enumerate(rotation):
      before = engine._host_spill_bytes
      got[f"cold{i}"], ttft[f"cold{i}"] = await serve(base, p)
      tally.prefill(len(p.ids), 0, True, False)
      spill_bytes.append(engine._host_spill_bytes - before)
      await wait_idle(engine)
    evicts_before = evicts()
    hits, fetched = engine._host_kv_hits, engine._host_fetch_bytes
    got["host"], ttft["host"] = await serve(base, host_warm)
    tally.prefill(len(host_warm.ids), sz["head"], True, False)
    fetch = engine._host_fetch_bytes - fetched
    await wait_idle(engine)
    need(spill_bytes == [0, entry_bytes, entry_bytes],
         f"step 3: each head switch spilled the last head's pages and ids, {entry_bytes} bytes "
         f"({spill_bytes})")
    need(evicts_before == 0 and evicts() == 1,
         f"step 3: the third spill over the {engine._host_kv_max_bytes}-byte budget recorded "
         f"host.evict ({evicts_before} before it, {evicts()} after)")
    need(engine._host_kv_hits == hits + 1 and fetch == entry_bytes,
         f"step 3: the returning head restored from the host tier: {fetch} bytes fetched")
    status = await loop.run_in_executor(None, http_status, base + "/v1/prefetch",
                                        queued.body(model, new, stream=False))
    for _ in range(1000):
      if engine._host_kv_hits > hits + 1:
        break
      await asyncio.sleep(0.01)
    fetched = engine._host_fetch_bytes
    got["prefetched"], ttft["prefetched"] = await serve(base, queued)
    tally.prefill(len(queued.ids), sz["head"], True, False)
    await wait_idle(engine)
    need(status[0] == 202 and engine._host_kv_hits == hits + 2
         and engine._host_fetch_bytes == fetched,
         f"step 3: /v1/prefetch answered {status[0]} and restored the queued head; its request "
         f"then fetched {engine._host_fetch_bytes - fetched} bytes more")
    got["hbm"], ttft["hbm"] = await serve(base, hbm)
    tally.prefill(len(hbm.ids), sz["head"], True, False)
    await wait_idle(engine)
    need(engine._host_kv_hits == hits + 2 and engine._prefix_hits == 3,
         f"step 3: H3 again: warm from the device entry ({engine._prefix_hits} prefix hits, "
         f"{engine._host_kv_hits} from the host)")
    samples = prom_samples(await loop.run_in_executor(None, http_text, base + "/metrics"))
    events = flight.tail()
    spilled = sum(e.get("bytes", 0) for e in events if e["event"] == "host.spill")
    restored = sum(e.get("bytes", 0) for e in events if e["event"] == "host.restore")
    metric = {k: samples.get(k) for k in ("xot_kv_host_hits_total", "xot_kv_spill_bytes_total",
                                         "xot_kv_fetch_bytes_total")}
    need(metric == {"xot_kv_host_hits_total": engine._host_kv_hits,
                    "xot_kv_spill_bytes_total": engine._host_spill_bytes,
                    "xot_kv_fetch_bytes_total": engine._host_fetch_bytes}
         and spilled == engine._host_spill_bytes and restored == engine._host_fetch_bytes == 2 * entry_bytes
         and samples.get("xot_kv_host_entries") == len(engine._host_kv),
         f"step 3: /metrics {metric}, xot_kv_host_bytes {samples.get('xot_kv_host_bytes')}, "
         f"xot_kv_host_entries {samples.get('xot_kv_host_entries')}: the engine's counters and the "
         f"flight recorder's host.spill / host.restore bytes")
    need(engine._host_restore_fallbacks == 0, "step 3: no restore fell back to a cold prefill")
    for kind in ("host.spill", "host.restore"):
      moves = [(e["bytes"], e["secs"]) for e in events if e["event"] == kind]
      print(f"[kv] step 3: {kind}: " + ", ".join(f"{b / 2**20:.1f} MiB in {1e3 * t:.1f} ms"
                                                 for b, t in moves) + f" ({card})", flush=True)
    tally.check("step 3 (paged server, one prefix entry)", card)
    with tally.uncounted(), cache_off(engine):
      twins = {k: await kv_generate(engine, f"twin-{k}", p.ids, new)
               for k, p in (("host", host_warm), ("prefetched", queued), ("hbm", hbm))}
    return got, twins, ttft

  got, twins, ttft = kv_server(torch, {**env, "XOT_PAGED_KV": "1", "XOT_PREFIX_CACHE": "1"},
                               device, model, step3)
  # The API ends a stream at an eos id; the engine's twin decodes on past it.
  need(all(got[k] and got[k] == twins[k][:len(got[k])] for k in twins),
       f"step 3: the host-warm, prefetched and HBM-warm streams ({[len(got[k]) for k in twins]} "
       f"tokens) bit for bit their cold twins")
  print(f"[kv] step 3: TTFT of a {len(rotation[0].ids)}-token prompt on the page pool: cold "
        + ", ".join(f"{ttft[f'cold{i}']:.1f}" for i in range(3))
        + f" ms, HBM-warm {ttft['hbm']:.1f} ms, host-warm {ttft['host']:.1f} ms, prefetched "
        f"{ttft['prefetched']:.1f} ms ({card})", flush=True)
  out["ttft_paged"] = {k: ttft[k] for k in ("cold0", "hbm", "host", "prefetched")}

  # ------------------------------------------------------------- 4. co-scheduling
  long_prompt = KVPrompt.of(kv_ids(30, sz["long"] - 2, V), [])
  shorts = [KVPrompt.of(kv_ids(40 + i, sz["short"], V), []) for i in range(4)]
  rounds = sz["rounds"]

  async def step4(engine):
    tally.watch(engine)
    shard = engine.shard
    with tally.uncounted():
      # Warm-up on other prompts of the same shapes: the scan groups of a one-call long
      # prefill and the decode graphs of four and five rows over the long cache.
      warm = {}
      for i, p in enumerate([KVPrompt.of(kv_ids(50 + i, sz["short"], V), []) for i in range(4)]
                            + [KVPrompt.of(kv_ids(31, sz["long"] - 2, V), [])]):
        t, _ = await engine.infer_sample_tensor(f"warm{i}", shard, np.asarray([p.ids]), temp=0.0,
                                                top_k=0)
        warm[f"warm{i}"] = int(t)
      for rids in (list(warm), list(warm)[:4]):
        await asyncio.gather(*(engine.generate_chunk(r, shard, warm[r], 1, temp=0.0, top_k=0)
                               for r in rids))
      for rid in warm:
        await engine.clear_request(rid)
      # The five-row step grew the slab, which drops the scan groups captured over the
      # old one: a second long prompt captures them over the slab the run will use.
      await kv_generate(engine, "warm-long", KVPrompt.of(kv_ids(32, sz["long"] - 2, V), []).ids, 1)
    toks = {}
    for i, p in enumerate(shorts):
      t, _ = await engine.infer_sample_tensor(f"s{i}", shard, np.asarray([p.ids]), temp=0.0, top_k=0)
      tally.prefill(len(p.ids), 0, False, False)
      toks[f"s{i}"] = [int(t)]
    slices = engine._ctx.batcher.slices if engine._ctx.batcher else 0
    gaps, joined, first_long = [], None, {}

    async def long_request():
      t0 = time.perf_counter()
      captures = engine._ctx.graphs.captures if engine._ctx.graphs is not None else 0
      t, _ = await engine.infer_sample_tensor("long", shard, np.asarray([long_prompt.ids]), temp=0.0,
                                              top_k=0)
      first_long["secs"] = time.perf_counter() - t0
      first_long["captures"] = (engine._ctx.graphs.captures if engine._ctx.graphs is not None
                                else 0) - captures
      first_long["tok"] = int(t)

    task = None
    for r in range(rounds):
      if r == 4:
        task = asyncio.ensure_future(long_request())
      if "tok" in first_long and "long" not in toks:
        toks["long"], joined = [first_long["tok"]], r
      t0 = time.perf_counter()
      outs = await asyncio.gather(*(engine.generate_chunk(rid, shard, s[-1], 1, temp=0.0, top_k=0)
                                    for rid, s in toks.items()))
      gaps.append(time.perf_counter() - t0)
      for (rid, s), o in zip(list(toks.items()), outs):
        s.extend(int(x) for x in np.asarray(o).reshape(-1))
    await task
    sliced = engine._ctx.batcher.slices > slices
    tally.prefill(len(long_prompt.ids), 0, False, sliced)
    for rid in list(toks):
      await engine.clear_request(rid)
    tally.check(f"step 4 (XOT_PREFILL_COSCHED={int(engine.cosched)})", card)
    n_slices = engine._ctx.batcher.slices - slices
    worst = sorted(range(2, len(gaps)), key=lambda r: -gaps[r])[:3]
    print(f"[kv] step 4: XOT_PREFILL_COSCHED={int(engine.cosched)}: the long prompt's first "
          f"token {1e3 * first_long['secs']:.1f} ms after it arrived (round 4; {first_long['captures']} "
          f"captures), joined at round {joined}; the longest rounds "
          + ", ".join(f"{r}: {1e3 * gaps[r]:.1f} ms" for r in worst) + f" ({card})", flush=True)
    with tally.uncounted():
      logits = await kv_logits(engine, "long-ref", long_prompt.ids, warm=False, sliced=sliced)
    return toks, gaps, joined, n_slices, logits

  run = {}
  for flag in ("1", "0"):
    run[flag] = kv_engine({**env, "XOT_PAGED_KV": "0", "XOT_PREFILL_COSCHED": flag}, device, model,
                          step4)
  (on, gaps_on, join_on, slices_on, lg_on), (off, gaps_off, join_off, slices_off, lg_off) = run["1"], run["0"]
  cut = min(join_on, join_off)
  same = all(on[f"s{i}"][:cut + 1] == off[f"s{i}"][:cut + 1] for i in range(4))
  agree = sum(a == b for i in range(4) for a, b in zip(on[f"s{i}"][cut + 1:], off[f"s{i}"][cut + 1:]))
  total = sum(len(on[f"s{i}"]) - cut - 1 for i in range(4))
  need(same and slices_on > 1 and slices_off == 0,
       f"step 4: the four streams agree token for token in both modes up to round {cut}, where "
       f"the {len(long_prompt.ids)}-token request joins (rounds {join_on} co-scheduled, {join_off} "
       f"not); {slices_on} prefill slices with XOT_PREFILL_COSCHED=1, {slices_off} with 0")
  print(f"[kv] step 4: after the join the streams share {agree}/{total} tokens (batch widths "
        f"differ: not asserted) ({card})", flush=True)
  err = rel_err(lg_on, lg_off)
  need(err <= PREFILL_REL_LIMIT,
       f"step 4: the long prompt's first-token logits, slices against one call, within "
       f"{PREFILL_REL_LIMIT} (max error / max |logit| {err:.2e}; first tokens {on['long'][0]} / "
       f"{off['long'][0]})")
  # Rounds from the third on: the first captures the four-row graph over the short caches.
  gaps_on, gaps_off = gaps_on[2:], gaps_off[2:]
  for flag, gaps in (("1", gaps_on), ("0", gaps_off)):
    print(f"[kv] step 4: XOT_PREFILL_COSCHED={flag}: longest inter-token gap of the four streams "
          f"{1e3 * max(gaps):.1f} ms, p50 TPOT {1e3 * med(gaps):.2f} ms over rounds 3-{rounds} (one "
          f"token each), {slices_on if flag == '1' else slices_off} batcher.prefill_slice ({card})",
          flush=True)
  out["gap_ms"] = {"on": 1e3 * max(gaps_on), "off": 1e3 * max(gaps_off)}
  out["tpot_ms"] = {"on": 1e3 * med(gaps_on), "off": 1e3 * med(gaps_off)}
  if cuda:
    need(max(gaps_on) < max(gaps_off),
         f"step 4: the longest gap with co-scheduling ({1e3 * max(gaps_on):.1f} ms) under the "
         f"one without ({1e3 * max(gaps_off):.1f} ms)")

  # ------------------------------------------------------- 5. a real device OOM
  async def step5(engine, node, api, base):
    tally.watch(engine)
    loop = asyncio.get_running_loop()
    ask = lambda p: loop.run_in_executor(None, http_status, base + url, p.body(model, 8, stream=False))  # noqa: E731
    short = KVPrompt.of(kv_ids(60, sz["short"], V), [])
    await ask(short)  # the short path's graphs exist before the limit
    tally.prefill(len(short.ids), 0, False, False)
    await wait_idle(engine)
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    limit = torch.cuda.memory_reserved() + (768 << 20)
    torch.cuda.set_per_process_memory_fraction(limit / total)
    try:
      big = KVPrompt.of(kv_ids(61, sz["oom"], V), [])
      status, _, reply = await ask(big)
      oom = engine._oom_count
      await wait_idle(engine)
      again = KVPrompt.of(kv_ids(62, sz["short"], V), [])
      served = (await ask(again))[0]
      tally.prefill(len(again.ids), 0, False, False)
      await wait_idle(engine)
    finally:
      torch.cuda.set_per_process_memory_fraction(1.0)
    code = (reply.get("error") or {}).get("code")
    need(status == 400 and code == "context_length_exceeded" and oom == 1 and served == 200,
         f"step 5: with {limit} bytes allowed, a {len(big.ids)}-token prompt ran out of device "
         f"memory: {status} {code} (recoveries {oom}); the next short request {served}")
    # An out-of-memory error inside a capture (injected: the decode step raises while the
    # stream captures): the request ends as a length finish after its first token, and
    # the next one captures its graphs again on the same stream.
    from xotorch_tpu_torch.models import graphs
    await engine._run(engine._ctx.graphs.clear)
    step, captures = graphs.decode_step, engine._ctx.graphs.captures

    def oom_in_capture(*a, **kw):
      if torch.cuda.is_current_stream_capturing():
        raise torch.OutOfMemoryError("CUDA out of memory (injected inside a capture)")
      return step(*a, **kw)
    graphs.decode_step = oom_in_capture
    try:
      hit = KVPrompt.of(kv_ids(63, sz["short"], V), [])
      first = await ask(hit)
      # Its prefill, and the decode step a first use runs eagerly before the capture.
      tally.prefill(len(hit.ids), 0, False, False)
      tally.want["flash_cached_attention"] += L
      await wait_idle(engine)
    finally:
      graphs.decode_step = step
    after = KVPrompt.of(kv_ids(64, sz["short"], V), [])
    second = await ask(after)
    tally.prefill(len(after.ids), 0, False, False)
    await wait_idle(engine)
    n1 = first[2].get("usage", {}).get("completion_tokens")
    n2 = second[2].get("usage", {}).get("completion_tokens")
    need(first[0] == 200 and n1 == 1 and engine._oom_count == 2 and second[0] == 200 and n2 > 1
         and engine._ctx.graphs.captures > captures,
         f"step 5: an OOM inside a decode graph's capture: {first[0]} with {n1} token (recoveries "
         f"{engine._oom_count}); the next request {second[0]} with {n2} tokens, "
         f"{engine._ctx.graphs.captures - captures} graph(s) captured after it")
    tally.check("step 5 (real and in-capture OOMs)", card)

  if cuda:
    kv_server(torch, {**env, "XOT_PAGED_KV": "0"}, device, model, step5)
  else:
    print("[kv] step 5: a real device OOM needs the card: not run", flush=True)
  out["launches"] = tally.counts()
  print(f"[time] phase 16 (KV reuse): {time.perf_counter() - t_phase:.1f} s; launches "
        f"{out['launches']} ({card})", flush=True)
  return out


# Phase 17's knobs: a stall watchdog of 2 s, health checks every 0.5 s evicting after 2
# failures, one transparent restart and one hop retry (the JAX package's defaults are 30 s,
# 5 s, 2, 0 and 2). The peers run as phase 11's do, prefix cache and co-scheduled prefill
# off, so their streams are the main path's.
SURVIVAL_ENV = {"XOT_STALL_TIMEOUT_S": "2", "XOT_HEALTH_INTERVAL_S": "0.5", "XOT_HEALTH_FAILS": "2",
                "XOT_REQUEST_RESTARTS": "1", "XOT_HOP_RETRIES": "1", "XOT_PAGED_KV": "0",
                "XOT_PREFILL_CHUNK": "1024", "XOT_PREFIX_CACHE": "0", "XOT_PREFILL_COSCHED": "0"}


def http_delete(url: str, timeout: float = 60.0):
  import urllib.request
  req = urllib.request.Request(url, method="DELETE")
  with urllib.request.urlopen(req, timeout=timeout) as resp:
    return json.loads(resp.read())


def prom_family(samples: dict, family: str) -> float:
  """The sum of a Prometheus family's samples (every label set), 0 when absent."""
  return sum(v for series, v in samples.items() if series.split("{", 1)[0] == family)


def check_survivability(torch, card: str, main_run: dict, device: str = "cuda",
                        model: str = "synthetic-llama-1b", timeout: float = 240.0) -> dict:
  """Phase 17: the ring's survivability on the card. Two `python -m xotorch_tpu_torch.main`
  peers as in phase 11 (manual discovery, --wait-for-peers 1; ring-b holds the first half
  of the layers, ring-a the second, samples and serves the API, at DEBUG=2 so that its
  log names every sampled token), with SURVIVAL_ENV. After a warm-up request (the peers
  load their shards and capture their graphs; a watchdog abort there is counted, and
  every later reading is a difference from the one before its step):
  1. transient faults are invisible: POST /v1/debug/faults on each sending peer, an
     `error` on ring-a's 6th SendTensor and a `lost_ack` on ring-b's 12th; the main path's
     first request (temperature 0) streams phase 5's tokens bit for bit, and ring-a's
     /metrics shows a retry (its error) and exactly one dedup drop (ring-b's redelivery);
  2. a sunk hop: a `sink` of ring-a's 20th SendTensor in mid-decode of the same
     non-streaming request; the watchdog fires once (xot_watchdog_aborts_total over both
     peers 1, a `watchdog.fired` of kind stall in a flight ring), ring-a's restart
     counter reads 1, no peer is evicted, and the restarted answer is phase 5's tokens;
     the seconds from the sink (the fired event's time less its idle seconds) to the
     answer;
  3. a killed peer: once ring-a's log shows eight tokens of the request, SIGKILL ring-b
     (layer 0's owner); ring-a evicts it (evictions 1), /v1/topology lists ring-a alone
     over every layer, it loads the whole model and its restarted answer is phase 5's
     tokens, as is a further request served alone; the seconds from the kill to
     detection (the first watchdog.fired or request.aborted in ring-a's flight ring),
     from detection to the eviction, and from the eviction to the answer, split into the
     shard load (the engine's DEBUG log) and the rest.
  ring-a is stopped with SIGTERM and must exit 0; ring-b's exit code is -9; no child is
  left. (`device` and `model` let the phase be rehearsed on the CPU with a small card.)"""
  import concurrent.futures
  import re
  import signal
  import tempfile
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.topology.device_capabilities import device_capabilities_sync
  from xotorch_tpu_torch.utils.helpers import find_available_port

  tag = "survivability"
  t_phase = time.perf_counter()
  label, body = main_requests(model)[0]
  body = {**body, "stream": False}
  want = main_run["tokens"][0]
  layers = get_model_card(model)["layers"]
  first, sampler = RING_IDS  # ring-b holds layer 0; ring-a samples and serves the API
  procs, logs = {}, {}
  out = {}

  def need(ok: bool, what: str) -> None:
    print(f"[{tag}] {what} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"{tag}: {what}")

  with tempfile.TemporaryDirectory() as tmp, concurrent.futures.ThreadPoolExecutor(2) as pool:
    path = os.path.join(tmp, "ring.json")
    node_ports = {i: find_available_port("127.0.0.1") for i in RING_IDS}
    api_ports = {i: find_available_port("127.0.0.1") for i in RING_IDS}
    write_ring_config(path, node_ports, device_capabilities_sync().to_dict())
    env = {**os.environ, **SURVIVAL_ENV, "PYTHONUNBUFFERED": "1"}
    bases = {i: f"http://127.0.0.1:{api_ports[i]}" for i in RING_IDS}

    def log_text(i: str) -> str:
      with open(logs[i]) as f:
        return f.read()

    def tokens_of(rid: str, text: Optional[str] = None) -> list:
      found = re.findall(rf"^\[{re.escape(rid)}\] token (\d+) \(\d+ so far\)$",
                         text if text is not None else log_text(sampler), re.M)
      return [int(t) for t in found]

    def counters() -> dict:
      """The survivability families of both peers' /metrics (a dead peer's as 0)."""
      rows = {}
      for i in RING_IDS:
        try:
          samples = prom_samples(http_text(bases[i] + "/metrics", timeout=10))
        except OSError:
          samples = {}
        for fam in ("xot_hop_retries_total", "xot_dedup_drops_total", "xot_watchdog_aborts_total",
                    "xot_peer_evictions_total", "xot_request_restarts_total"):
          rows[(i, fam)] = prom_family(samples, fam)
      return rows

    def moved(before: dict, after: dict, i: str, fam: str) -> float:
      return after[(i, fam)] - before[(i, fam)]

    def ask() -> tuple:
      """The request to ring-a's API: (tokens its log names, the answer, wall time at
      the answer)."""
      resp = http_json(bases[sampler] + "/v1/chat/completions", body, timeout=600)
      done = time.time()
      return tokens_of(resp["id"][len("chatcmpl-"):]), resp, done

    def flight(i: str) -> list:
      return http_json(bases[i] + "/v1/debug/flight?live=all", timeout=30)["events"]

    try:
      t0 = time.perf_counter()
      for i in RING_IDS:
        logs[i] = os.path.join(tmp, f"{i}.log")
        cmd = [sys.executable, "-m", "xotorch_tpu_torch.main", "--device", device,
               "--default-model", model, "--node-id", i, "--node-host", "127.0.0.1",
               "--node-port", str(node_ports[i]), "--chatgpt-api-host", "127.0.0.1",
               "--chatgpt-api-port", str(api_ports[i]), "--chatgpt-api-response-timeout", "600",
               "--discovery-module", "manual", "--discovery-config-path", path,
               "--wait-for-peers", "1"]
        with open(logs[i], "w") as log:
          procs[i] = subprocess.Popen(cmd, cwd=ROOT, env={**env, "DEBUG": "2" if i == sampler else "1"},
                                      stdout=log, stderr=subprocess.STDOUT)
      pending = set(RING_IDS)
      while pending:
        for i in sorted(pending):
          if procs[i].poll() is not None:
            raise AssertionError(f"{tag}: {i} exited {procs[i].returncode} while starting\n"
                                 f"{log_text(i)[-3000:]}")
          try:
            if http_json(bases[i] + "/healthcheck", timeout=5).get("status") == "ok":
              pending.discard(i)
          except OSError:
            pass
        if time.perf_counter() - t0 > timeout:
          raise AssertionError(f"{tag}: {sorted(pending)} not serving after {timeout:.0f} s")
        time.sleep(0.25)
      print(f"[{tag}] both peers serving in {time.perf_counter() - t0:.1f} s ({SURVIVAL_ENV})",
            flush=True)
      c0 = counters()
      t1 = time.perf_counter()
      # Not a check: the peers load their shards here, and on a 2 s stall bound a cold
      # peer's first-use costs can end an attempt and its one restart (seen on the H100).
      for attempt in range(1, 7):
        try:
          warm, _, _ = ask()
          break
        except OSError as e:  # an HTTP error
          if attempt == 6:
            raise
          print(f"[{tag}] warm-up attempt {attempt} answered {e!r}; once more", flush=True)
      c1 = counters()
      print(f"[{tag}] warm-up: {len(warm)} tokens in {time.perf_counter() - t1:.1f} s, watchdog aborts "
            f"{sum(moved(c0, c1, i, 'xot_watchdog_aborts_total') for i in RING_IDS):g}, restarts "
            f"{moved(c0, c1, sampler, 'xot_request_restarts_total'):g} (first-use loads and "
            f"captures on a 2 s stall bound)", flush=True)

      # Step 1: an error and a lost ack, each on the peer whose handle sends the hop.
      http_json(bases[sampler] + "/v1/debug/faults",
                {"rules": [{"rpc": "SendTensor", "nth": 6, "action": "error"}]})
      http_json(bases[first] + "/v1/debug/faults",
                {"rules": [{"rpc": "SendTensor", "nth": 12, "action": "lost_ack"}]})
      got, resp, _ = ask()
      time.sleep(0.5)  # the lost ack's redelivery lands beside the generation
      c2 = counters()
      for i in RING_IDS:
        http_delete(bases[i] + "/v1/debug/faults")
      step2_at = time.time()
      retries = moved(c1, c2, sampler, "xot_hop_retries_total")
      dedup = moved(c1, c2, sampler, "xot_dedup_drops_total")
      need(got == want and retries >= 1 and dedup == 1
           and moved(c1, c2, sampler, "xot_request_restarts_total") == 0,
           f"step 1, an error and a lost ack: {sum(a == b for a, b in zip(got, want))}/{len(want)} "
           f"temperature-0 tokens equal phase 5's; {sampler}'s /metrics: {retries:g} retry, "
           f"{dedup:g} dedup drop, no restart")

      # Step 2: one token hop sunk in mid-decode; the stall watchdog ends the attempt.
      http_json(bases[sampler] + "/v1/debug/faults",
                {"rules": [{"rpc": "SendTensor", "nth": 20, "action": "sink"}]})
      got, resp, answered = ask()
      c3 = counters()
      http_delete(bases[sampler] + "/v1/debug/faults")
      fired = [(i, e) for i in RING_IDS for e in flight(i)
               if e["event"] == "watchdog.fired" and e["ts"] > step2_at and e.get("kind") == "stall"]
      aborts = sum(moved(c2, c3, i, "xot_watchdog_aborts_total") for i in RING_IDS)
      restarts = moved(c2, c3, sampler, "xot_request_restarts_total")
      evictions = sum(moved(c2, c3, i, "xot_peer_evictions_total") for i in RING_IDS)
      need(got == want and aborts == 1 and len(fired) == 1 and restarts == 1 and evictions == 0,
           f"step 2, a sunk hop: watchdog aborts {aborts:g}, stall firings in the flight rings "
           f"{[i for i, _ in fired]}, restarts {restarts:g}, evictions {evictions:g}; the restarted "
           f"answer {sum(a == b for a, b in zip(got, want))}/{len(want)} tokens equal phase 5's")
      fired_on, event = fired[0]
      out["sink_to_answer_s"] = answered - (event["ts"] - event["idle_s"])
      print(f"[{tag}] step 2: {out['sink_to_answer_s']:.3f} s from the sink to the restarted answer "
            f"(the watchdog fired on {fired_on} after {event['idle_s']:.3f} s idle) ({card})",
            flush=True)

      # Step 3: ring-b killed once ring-a's log names eight tokens of the request.
      seen = len(log_text(sampler))
      future = pool.submit(ask)
      deadline = time.perf_counter() + 120
      while not re.search(r"^\[[0-9a-f-]+\] token \d+ \(8 so far\)$", log_text(sampler)[seen:], re.M):
        if future.done() or time.perf_counter() > deadline:
          raise AssertionError(f"{tag}: step 3: no eighth token in {sampler}'s log "
                               f"({future.result() if future.done() else 'timed out'})")
        time.sleep(0.005)
      killed_at = time.time()
      procs[first].send_signal(signal.SIGKILL)
      got, resp, answered = future.result(timeout=300)
      c4 = counters()
      events = [e for e in flight(sampler) if e["ts"] >= killed_at]
      detect = next((e for e in events if e["event"] in ("watchdog.fired", "request.aborted")), None)
      evicted = next((e for e in events if e["event"] == "peer.evicted"), None)
      topo = http_json(bases[sampler] + "/v1/topology", timeout=30)
      rows = [(p["node_id"], p["start_layer"], p["end_layer"]) for p in topo.get("partitions", [])]
      evictions = moved(c3, c4, sampler, "xot_peer_evictions_total")
      restarts = moved(c3, c4, sampler, "xot_request_restarts_total")
      need(got == want and evictions == 1 and restarts == 1 and rows == [(sampler, 0, layers - 1)]
           and list(topo["nodes"]) == [sampler] and detect is not None and evicted is not None,
           f"step 3, {first} killed: evictions {evictions:g}, restarts {restarts:g}, /v1/topology "
           f"{rows}; the restarted answer {sum(a == b for a, b in zip(got, want))}/{len(want)} "
           f"tokens equal phase 5's")
      loads = re.findall(rf"^torch engine ready for Shard\(model_id='{re.escape(model)}', start_layer=0, "
                         rf"end_layer={layers - 1}, .*\) in ([0-9.]+) s$", log_text(sampler), re.M)
      load_s = float(loads[-1]) if loads else float("nan")
      d_kind = detect.get("kind") or (detect.get("error") or "")[:60]
      # The health monitor, or a reconcile after discovery's own check, can evict the
      # peer before the request's own failure shows (a request waiting on the dead
      # peer's hop ends only at the stall bound): recovery runs from the later of the two.
      healed = max(detect["ts"], evicted["ts"])
      out.update(kill_to_detect_s=detect["ts"] - killed_at, detect_to_evict_s=evicted["ts"] - detect["ts"],
                 kill_to_evict_s=evicted["ts"] - killed_at, heal_to_answer_s=answered - healed,
                 shard_load_s=load_s)
      print(f"[{tag}] step 3: kill to detection {out['kill_to_detect_s']:.3f} s ({detect['event']}"
            f"{', ' + d_kind if d_kind else ''}), detection to eviction {out['detect_to_evict_s']:.3f} s "
            f"(kill to eviction {out['kill_to_evict_s']:.3f} s, by {evicted.get('by')}), "
            f"then to the restarted answer {out['heal_to_answer_s']:.3f} s (shard load {load_s:.3f} s, "
            f"serving {out['heal_to_answer_s'] - load_s:.3f} s) ({card})", flush=True)
      got, resp, _ = ask()
      need(got == want, f"step 3: a further request served by {sampler} alone: "
           f"{sum(a == b for a, b in zip(got, want))}/{len(want)} tokens equal phase 5's")
    finally:
      for p in procs.values():
        if p.poll() is None:
          p.send_signal(signal.SIGTERM)
      for p in procs.values():
        try:
          p.wait(timeout=60)
        except subprocess.TimeoutExpired:
          p.kill()
          p.wait(timeout=60)
      texts = {i: log_text(i) for i in logs if os.path.exists(logs[i])}
  codes = {i: p.returncode for i, p in procs.items()}
  alive = [i for i, p in procs.items() if p.poll() is None]
  ok = not alive and codes.get(sampler) == 0 and codes.get(first) == -signal.SIGKILL
  print(f"[{tag}] children stopped: exit codes {codes} ({sampler} SIGTERM, {first} SIGKILL), "
        f"none left {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    tails = "\n".join(f"--- {i}\n{t[-3000:]}" for i, t in texts.items())
    raise AssertionError(f"{tag}: children left {alive}, exit codes {codes}\n{tails}")
  print(f"[time] phase 17 (survivability): {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
  return out


# ------------------------------------------------------------------ phase 18

DECODE_SIZES = {
  # repeat: (words of the phrase, times) the repeat-heavy prompt repeats it; plain: the
  # words of the prompt that does not repeat; new: tokens of a speculative request; solo:
  # the resident-models request's prompt words and tokens; batch: the B=8 run's prompt
  # words and tokens; big: the second model the server holds; page: XOT_KV_PAGE.
  "synthetic-llama-1b": dict(repeat=(5, 300), plain=1500, new=64, solo=(300, 64),
                             batch=(300, 64), big="synthetic-llama-8b", page=128),
  "synthetic-tiny": dict(repeat=(5, 19), plain=96, new=24, solo=(20, 24), batch=(20, 24),
                         big="synthetic-tiny-gemma2", page=16),
}
SPEC_K = 8  # phase 18's draft depth (XOT_SPECULATE)
TIE_REL = 2.0 ** -6  # a near tie: two logits within the kernels' own bound (rel_limit)
DECODE_ENV = {"XOT_PREFIX_CACHE": "0", "XOT_PREFILL_COSCHED": "0", "XOT_PAGED_KV": "0"}


def ladder(n: int, first: int = 8, cap: int = 64) -> list:
  """The Node's fused loop for n tokens after the first: [(chunk, next size or None)]."""
  out, size, remaining = [], first, n
  while remaining > 0:
    this = min(size, 1 << (remaining - 1).bit_length())
    rem_after = remaining - this
    nxt = min(min(size * 2, cap), 1 << (rem_after - 1).bit_length()) if rem_after >= 1 else None
    out.append((this, nxt))
    remaining -= this
    size = min(size * 2, cap)
  return out


@contextlib.contextmanager
def launches_kept():
  """Every counted wrapper's launches as they were before the block (a reference forward
  inside it counts nothing)."""
  from xotorch_tpu_torch.models import graphs
  saved = {(fn, a): getattr(fn, a) for fn in graphs.counted_wrappers()
           for a in ("launches", "windowed_launches") if hasattr(fn, a)}
  try:
    yield
  finally:
    for (fn, a), n in saved.items():
      setattr(fn, a, n)


def launch_counts() -> dict:
  from xotorch_tpu_torch.models import graphs
  return {fn.__name__: fn.launches for fn in graphs.counted_wrappers() if fn.__name__ in KV_KERNELS}


async def tie_check(torch, engine, shard, ids: list, a: int, b: int) -> tuple:
  """Whether tokens a and b nearly tie after `ids`: the model's fp32 logits at the last
  position from a forward from position 0 (K1) differ by at most TIE_REL of the row's
  largest |logit|, the bound the kernels hold their outputs to. Returns (tie, |l[a] -
  l[b]|, the bound)."""
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache
  ctx = engine._contexts[shard]

  def body():
    cache = init_kv_cache(ctx.cfg, shard.get_layer_count(), 1, len(ids), engine.dtype, engine.device,
                          kv_quant=engine.kv_quant is not None, mesh=ctx.mesh)
    x = torch.tensor([ids], dtype=torch.int64, device=engine.device)
    logits, _ = forward_shard(ctx.params, x, cache, 0, ctx.cfg, True, True, use_flash=True,
                              route=engine.quant_route)
    return logits[0, -1].float().cpu()
  with launches_kept():
    row = await engine._run(body)
  gap, limit = abs(float(row[a] - row[b])), TIE_REL * float(row.abs().max())
  return gap <= limit, gap, limit


async def streams_agree(torch, engine, shard, tag: str, prompt: list, want: list, got: list,
                        card: str) -> float:
  """`got` against `want` (two greedy streams of one prompt): equal, or equal up to a first
  divergence whose two tokens nearly tie (tie_check) after the common head; fails
  otherwise. Returns the share of tokens equal position for position."""
  n = min(len(want), len(got))
  same = sum(x == y for x, y in zip(want, got)) / max(n, 1)
  first = next((i for i in range(n) if want[i] != got[i]), None)
  if first is None and len(want) == len(got):
    print(f"[decode] {tag}: streams identical ({n} tokens)", flush=True)
    return same
  if first is None:
    raise AssertionError(f"decode: {tag}: {len(got)} tokens against {len(want)}")
  tie, gap, limit = await tie_check(torch, engine, shard, prompt + want[:first], want[first], got[first])
  print(f"[decode] {tag}: {100 * same:.1f}% of {n} tokens agree; first divergence at {first}: "
        f"tokens {want[first]} / {got[first]}, logit gap {gap:.4g} against the near-tie bound "
        f"{limit:.4g} {'(a near tie) ok' if tie else 'FAIL'} ({card})", flush=True)
  if not tie:
    raise AssertionError(f"decode: {tag} parts at {first} where the logits do not tie ({gap} > {limit})")
  return same


class SpecTally:
  """Phase 18's counted speculation on one engine and node: decode steps where they are
  dispatched (a chunk run ahead and then discarded launches like a returned one), verify
  rounds as (drafted, accepted, wall ms), draft calls as (request, outstanding requests,
  context, draft, wall ms), and the verify programs' replays."""

  def __init__(self, engine, node):
    from xotorch_tpu_torch.models import graphs
    self.engine, self.node = engine, node
    self.steps, self.rounds, self.drafts, self.verify_calls = 0, [], [], 0
    dispatch, paged_decode = engine._dispatch_contiguous, engine._decode_batch_paged_sync
    verify, draft, accept = engine.verify_draft, engine.draft_tokens, engine._accept

    def counted_dispatch(ctx, items, toks_in, num_tokens, *a, **kw):
      self.steps += num_tokens
      return dispatch(ctx, items, toks_in, num_tokens, *a, **kw)

    def counted_paged(ctx, items, num_tokens, *a):
      res = paged_decode(ctx, items, num_tokens, *a)
      self.steps += len(res[0])
      return res

    def counted_accept(ctx, rid, draft_, preds, *a):
      out = accept(ctx, rid, draft_, preds, *a)
      self.rounds.append([len(draft_), len(out), None])
      return out

    async def timed_verify(rid, shard, prev, draft_):
      t0 = time.perf_counter()
      out = await verify(rid, shard, prev, draft_)
      if out is not None:
        self.rounds[-1][2] = (time.perf_counter() - t0) * 1e3
      return out

    async def timed_draft(rid, context, k):
      outstanding = len(node.outstanding_requests)
      t0 = time.perf_counter()
      out = await draft(rid, context, k)
      self.drafts.append((rid, outstanding, list(context), list(out), (time.perf_counter() - t0) * 1e3))
      return out
    engine._dispatch_contiguous, engine._decode_batch_paged_sync = counted_dispatch, counted_paged
    engine.verify_draft, engine.draft_tokens, engine._accept = timed_verify, timed_draft, counted_accept
    self._graph_fns = {name: getattr(graphs, name) for name in ("verify_contiguous", "verify_paged")}
    for name, real in self._graph_fns.items():

      def counted(*a, _real=real, **kw):
        self.verify_calls += 1
        return _real(*a, **kw)
      setattr(graphs, name, counted)

  def reset(self) -> None:
    self.steps, self.rounds, self.drafts, self.verify_calls = 0, [], [], 0

  def close(self) -> None:
    from xotorch_tpu_torch.models import graphs
    for name, real in self._graph_fns.items():
      setattr(graphs, name, real)


async def node_stream(node, model: str, ids: list, n: int, rid: str) -> tuple:
  """One temperature-0 request of exact token ids through the Node (the id tokenizer's
  text); returns (its n tokens, TPOT in ms from the token callbacks' clock)."""
  from xotorch_tpu_torch.models.registry import build_base_shard
  done, stamps, out = asyncio.Event(), [], {}

  def on_token(request_id, tokens, finished):
    if request_id == rid:
      stamps.append((time.perf_counter(), len(tokens)))
      out["tokens"] = list(tokens)
      if finished:
        done.set()
  node.on_token.register(f"decode-{rid}").on_next(on_token)
  try:
    await node.process_prompt(build_base_shard(model, "TorchShardInferenceEngine"),
                              " ".join(f"w{i}" for i in ids), rid, max_tokens=n, temperature=0.0)
    await asyncio.wait_for(done.wait(), timeout=600)
  finally:
    node.on_token.deregister(f"decode-{rid}")
  (t0, n0), (t1, n1) = stamps[0], stamps[-1]
  tpot = (t1 - t0) / (n1 - n0) * 1e3 if n1 > n0 else float("nan")
  return out["tokens"], tpot


def device_intervals(prof) -> list:
  """(start us, end us, name) of every kernel, copy and fill the card ran in a profile, by
  start, from its Chrome trace (a graph replay's kernels hang off one launch call there,
  each with its own timestamps)."""
  import tempfile
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f).get("traceEvents", [])
  return sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", "")) for e in events
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "ts" in e)


def boundary_gaps(intervals: list, boundaries: int) -> Optional[dict]:
  """The device's idle gaps in the decode window (from the first K2 decode kernel to the
  last activity): the `boundaries` largest (the chunk boundaries) and the window's total
  idle, in ms. None when the trace holds no decode kernel."""
  start = next((s for s, _, name in intervals if "flash_cached_split" in name), None)
  if start is None:
    return None
  gaps, end = [], None
  for s, e, _ in intervals:
    if e < start:
      continue
    if end is not None and s > end:
      gaps.append((s - end) / 1e3)
    end = e if end is None else max(end, e)
  gaps.sort(reverse=True)
  top = gaps[:boundaries]
  return {"boundary_ms": top, "mean_ms": sum(top) / max(len(top), 1), "idle_ms": sum(gaps),
          "window_ms": (end - start) / 1e3}


async def profile_verify(torch, engine, shard, ids: list, tag: str, card: str) -> Optional[dict]:
  """One verify of an 8-token draft (a 16-row bucket) after `ids`, its program already
  captured, under the profiler: wall ms (the executor call with its readback) and the
  card's busy ms and kernels. None off the card or when the trace holds no device
  time."""
  import numpy as np
  if engine.device.type != "cuda":
    return None
  from torch.profiler import ProfilerActivity, profile
  tok, _ = await engine.infer_sample_tensor("vprof", shard, np.asarray([ids]), temp=0.0, top_k=0)
  draft = ids[:SPEC_K]
  with launches_kept():
    await engine.verify_draft("vprof", shard, int(tok), draft)  # the program's key, warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      await engine.verify_draft("vprof", shard, int(tok), draft)
      wall = (time.perf_counter() - t0) * 1e3
  await engine.clear_request("vprof")
  busy = kernels = 0
  for evt in prof.key_averages():
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
      us = getattr(evt, "self_cuda_time_total", 0)
    if us > 0:
      busy += us / 1e3
      kernels += evt.count
  if not kernels:
    print(f"[decode] verify {tag}: the trace holds no device time: not measured", flush=True)
    return None
  print(f"[decode] verify {tag} (16-row bucket, one replay): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms in {kernels} kernels, {100 * (1 - busy / wall):.1f}% idle ({card})", flush=True)
  return {"wall_ms": wall, "device_ms": busy, "kernels": kernels}


def check_overlap(torch, card: str, device: str, model: str, rounds: int) -> dict:
  """Phase 18 (b): the main path's three requests with the overlap on and off in turn, the
  profiled boundary gaps, and eight lockstep requests with the batch overlap on and off."""
  import numpy as np
  from xotorch_tpu_torch.models.registry import build_full_shard
  sizes = DECODE_SIZES[model]

  async def drive(engine, node, api, base, tokens, steps):
    loop = asyncio.get_running_loop()
    url = base + "/v1/chat/completions"
    reqs = main_requests(model)
    shard = build_full_shard(model, "TorchShardInferenceEngine")
    if not engine.overlap:
      raise AssertionError("decode: XOT_OVERLAP_CHUNKS is not on by default")

    async def one(body):
      before = set(tokens)
      if body.get("stream"):
        events, first, last = await loop.run_in_executor(None, http_stream, url, body)
        n = (events[-1].get("usage") or {}).get("completion_tokens", 0)
        tpot = (last - first) / (n - 1) * 1e3 if n > 1 and last > first else None
      else:
        await loop.run_in_executor(None, http_json, url, body)
        tpot = None
      await wait_idle(engine)
      rid = next(r for r in tokens if r not in before)
      return tokens[rid], tpot
    for _, body in reqs:  # warm-up: every graph captured before the rounds
      await one({**body, "max_tokens": 16})
    greedy = {True: [], False: []}
    tpots = {True: [], False: []}
    counts = {True: [0, 0], False: [0, 0]}
    for r in range(rounds):
      for on in ((True, False) if r % 2 == 0 else (False, True)):
        engine.overlap = on
        h, m = engine._overlap_hits, engine._overlap_misses
        run = []
        for _, body in reqs:
          toks, tpot = await one(body)
          run.append(toks if body.get("temperature") == 0 else None)
          if tpot is not None:
            tpots[on].append(tpot)
        greedy[on].append(run)
        counts[on][0] += engine._overlap_hits - h
        counts[on][1] += engine._overlap_misses - m
    engine.overlap = True
    first = greedy[True][0]
    same = all(run == first for on in (True, False) for run in greedy[on])
    med = {on: float(np.median(v)) if v else float("nan") for on, v in tpots.items()}
    print(f"[decode] overlap: the main path's 3 requests x {rounds} rounds each way: temperature-0 "
          f"streams {'identical' if same else 'DIFFER'}; on: {counts[True][0]} hits, "
          f"{counts[True][1]} misses; off: {counts[False][0]} hits, {counts[False][1]} misses; "
          f"TPOT median {med[True]:.3f} ms on, {med[False]:.3f} ms off ({card})", flush=True)
    if not same or counts[True][0] < rounds or counts[False] != [0, 0]:
      raise AssertionError(f"decode: overlap streams same={same}, counts {counts}")
    # One profiled request each way: the device's idle gaps at the chunk boundaries.
    gaps = {}
    if engine.device.type == "cuda":
      from torch.profiler import ProfilerActivity, profile
      body = reqs[0][1]
      bounds = len(ladder(body["max_tokens"] - 1)) - 1
      for on in (True, False):
        engine.overlap = on
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
          await one(body)
          torch.cuda.synchronize()
        gaps[on] = boundary_gaps(device_intervals(prof), bounds)
      engine.overlap = True
      for on, g in gaps.items():
        if g is None:
          print(f"[decode] overlap {'on' if on else 'off'}: the trace holds no decode kernel: "
                f"boundary gaps not measured", flush=True)
        else:
          print(f"[decode] overlap {'on' if on else 'off'}: device idle at the {bounds} chunk "
                f"boundaries of a 64-token request {', '.join(f'{x:.3f}' for x in g['boundary_ms'])} ms "
                f"(mean {g['mean_ms']:.3f} ms); idle {g['idle_ms']:.3f} ms of a "
                f"{g['window_ms']:.3f} ms decode window ({card})", flush=True)
    else:
      print("[decode] overlap: no card: boundary gaps not measured", flush=True)
    # Eight lockstep requests, the batch overlap on and off.
    words, n = sizes["batch"]
    vocab = engine._ctx.cfg.vocab_size
    prompts = {f"b{i}": kv_ids(80 + i, words, vocab) for i in range(8)}
    batch = {}
    for on in (True, False):
      engine.overlap_batch = on
      h, m = engine._overlap_batch_hits, engine._overlap_batch_misses
      firsts = {}
      for rid, ids in prompts.items():
        tok, _ = await engine.infer_sample_tensor(rid, shard, np.asarray([ids]), temp=0.0, top_k=0)
        firsts[rid] = [int(tok)]

      async def loop_of(rid):
        out = firsts[rid]
        for this, nxt in ladder(n - 1):
          chunk = await engine.generate_chunk(rid, shard, out[-1], this, temp=0.0, top_k=0,
                                              next_size=nxt)
          out.extend(int(t) for t in np.asarray(chunk).reshape(-1))
        return out[:n]
      outs = await asyncio.gather(*(loop_of(rid) for rid in prompts))
      for rid in prompts:
        await engine.clear_request(rid)
      batch[on] = (outs, engine._overlap_batch_hits - h, engine._overlap_batch_misses - m)
    engine.overlap_batch = False
    ok = batch[True][0] == batch[False][0] and batch[True][1] > 0
    print(f"[decode] overlap batch: 8 lockstep requests x {n} tokens: streams "
          f"{'identical' if batch[True][0] == batch[False][0] else 'DIFFER'} with XOT_OVERLAP_BATCH "
          f"1 and 0; on: {batch[True][1]} hits, {batch[True][2]} misses {'ok' if ok else 'FAIL'} "
          f"({card})", flush=True)
    if not ok:
      raise AssertionError(f"decode: batch overlap {batch[True][1:]}")
    return {"tpot": med, "gaps": gaps, "hits": counts}
  return extras_server(torch, DECODE_ENV, device, model, drive)


def check_lookup(torch, card: str, device: str, model: str, paged: bool) -> dict:
  """Phase 18 (c): prompt lookup on a repeat-heavy and a non-repeating prompt, with the
  speculation on and off on one server (contiguous or paged)."""
  from xotorch_tpu_torch.models.registry import build_full_shard
  sizes = DECODE_SIZES[model]
  env = {**DECODE_ENV, "XOT_SPECULATE": str(SPEC_K), "XOT_PAGED_KV": "1" if paged else "0",
         "XOT_KV_PAGE": str(sizes["page"])}
  tag = "paged" if paged else "contiguous"

  async def drive(engine, node, api, base):
    loop = asyncio.get_running_loop()
    shard = build_full_shard(model, "TorchShardInferenceEngine")
    vocab = engine._ctx.cfg.vocab_size
    # Random weights repeat nothing of a repeated paragraph: the lookup drafts only once
    # the output repeats itself, which a prompt of one short phrase over and over makes
    # it do (synthetic-llama-1b loops with period 8 after it), where a paragraph of 375
    # words repeated 4 times and 1500 words that do not repeat give no draft in 256
    # tokens (scripts/lookup_repeat_probe.py shows both on the card).
    words, times = sizes["repeat"]
    prompts = {"repeat": kv_ids(95, words, vocab) * times, "plain": kv_ids(91, sizes["plain"], vocab)}
    n, layers = sizes["new"], shard.get_layer_count()
    spec_kernel = "paged_prefill_attention" if paged else "flash_cached_attention"
    tally = SpecTally(engine, node)
    out = {}
    try:
      # Warm-up: a repeat-heavy prompt of the same length takes verify rounds, so the
      # verify program (its key: the bucket and the cache or page-table width) and the
      # Node's decode keys are captured before the timed requests.
      await node_stream(node, model, kv_ids(96, words, vocab) * times, 32, "warm")
      for name, ids in prompts.items():
        runs = {}
        for spec in (False, True):
          node.speculate_tokens = SPEC_K if spec else 0
          tally.reset()
          base_counts = launch_counts()
          toks, tpot = await node_stream(node, model, ids, n, f"{name}-{tag}-{int(spec)}")
          await wait_idle(engine)
          got = {k: v - base_counts[k] for k, v in launch_counts().items()}
          runs[spec] = dict(tokens=toks, tpot=tpot, launches=got, steps=tally.steps,
                            rounds=list(tally.rounds), verify_calls=tally.verify_calls)
        plain, spec = runs[False], runs[True]
        rounds = spec["rounds"]
        # Beyond decode steps: the prefill's launches (equal in both runs) and, with the
        # speculation on, one launch a layer a verify round.
        beyond = {k: spec["launches"][k] - plain["launches"][k] for k in KV_KERNELS}
        step_kernel = "paged_decode_attention" if paged else "flash_cached_attention"
        beyond[step_kernel] -= layers * (spec["steps"] - plain["steps"])
        want = dict.fromkeys(KV_KERNELS, 0)
        want[spec_kernel] = layers * len(rounds)
        graph_ok = engine.device.type != "cuda" or spec["verify_calls"] == len(rounds)
        ok = beyond == want and graph_ok
        per_round = sum(a for _, a, _ in rounds) / max(len(rounds), 1)
        ms = sorted(r[2] for r in rounds if r[2] is not None)
        med = ms[len(ms) // 2] if ms else float("nan")
        print(f"[decode] lookup {tag} {name} ({len(ids)} prompt tokens, {n} new): {len(rounds)} "
              f"verify rounds, {per_round:.2f} tokens a round, "
              f"{sum(a - 1 for _, a, _ in rounds)}/{sum(d for d, _, _ in rounds)} drafted tokens "
              f"accepted; verify {med:.3f} ms a round (median wall); TPOT "
              f"{spec['tpot']:.3f} ms on, {plain['tpot']:.3f} ms off; {spec_kernel} launches beyond "
              f"decode steps {beyond[spec_kernel]} = {layers} x {len(rounds)} rounds, verify graph "
              f"calls {spec['verify_calls']} {'ok' if ok else 'FAIL'} ({card})", flush=True)
        if not ok:
          raise AssertionError(f"decode: lookup {tag} {name}: launches beyond decode {beyond}, "
                               f"wanted {want}; verify graph calls {spec['verify_calls']}")
        agree = await streams_agree(torch, engine, shard, f"lookup {tag} {name}", ids,
                                    plain["tokens"], spec["tokens"], card)
        out[name] = dict(rounds=len(rounds), per_round=per_round, agree=agree,
                         tpot=(spec["tpot"], plain["tpot"]),
                         verify_ms=med)
      if not out["repeat"]["rounds"]:
        raise AssertionError(f"decode: lookup {tag}: no verify round on the repeat-heavy prompt")
      if not paged:
        # The Node names the next chunk's size whatever comes next, so a chunk runs ahead
        # and the next round's verify discards it and waits for it on the card: the
        # speculative request once more with the overlap off (the paged path runs no
        # chunk ahead).
        node.speculate_tokens, engine.overlap = SPEC_K, False
        toks, tpot = await node_stream(node, model, prompts["repeat"], n, f"repeat-{tag}-nooverlap")
        engine.overlap = True
        await wait_idle(engine)
        print(f"[decode] lookup contiguous repeat with XOT_OVERLAP_CHUNKS 0: TPOT {tpot:.3f} ms "
              f"(on {out['repeat']['tpot'][0]:.3f}, speculation off {out['repeat']['tpot'][1]:.3f}) "
              f"({card})", flush=True)
        out["repeat"]["tpot_no_overlap"] = tpot
      out["profile"] = await profile_verify(torch, engine, shard, prompts["repeat"], tag, card)
      samples = prom_samples(await loop.run_in_executor(None, http_text, base + "/metrics"))
      rate = samples.get("xot_spec_accept_rate")
      proposed = prom_family(samples, "xot_spec_tokens_proposed_total")
      accepted = prom_family(samples, "xot_spec_tokens_accepted_total")
      print(f"[decode] lookup {tag}: /metrics xot_spec_accept_rate {rate}, tokens proposed "
            f"{proposed:.0f}, accepted {accepted:.0f} ({card})", flush=True)
      if rate is None or proposed <= 0:
        raise AssertionError(f"decode: lookup {tag}: /metrics shows no speculation")
      if paged:
        stats = engine.page_pool_stats()
        print(f"[decode] lookup paged: {stats['pages_in_use']} pool pages in use after the "
              f"requests {'ok' if stats['pages_in_use'] == 0 else 'FAIL'}", flush=True)
        if stats["pages_in_use"]:
          raise AssertionError(f"decode: {stats['pages_in_use']} pool pages left in use")
      out["launches"] = launch_counts()
      return out
    finally:
      tally.close()
  return kv_server(torch, env, device, model, drive)


def check_resident_and_drafts(torch, card: str, device: str, model: str) -> dict:
  """Phase 18 (a) and (d) on one server: two resident models, the perfect drafter, the
  small model drafting for the large one, drafts under concurrency, and a third model's
  eviction of the idle context."""
  import numpy as np
  from xotorch_tpu_torch.models import registry
  from xotorch_tpu_torch.models.registry import build_full_shard
  sizes = DECODE_SIZES[model]
  big = sizes["big"]
  third = f"{model}-c"

  async def settle(engine) -> None:
    """wait_idle, but for the paused request A, whose state stays resident throughout."""
    t_end = time.perf_counter() + 30
    while any(r != "A" for c in list(engine._contexts.values()) for r in c.states):
      if time.perf_counter() > t_end:
        raise AssertionError(f"decode: request states left: "
                             f"{[list(c.states) for c in engine._contexts.values()]}")
      await asyncio.sleep(0.05)
    await engine._run(lambda: None)

  async def drive(engine, node, api, base):
    loop = asyncio.get_running_loop()
    cls = "TorchShardInferenceEngine"
    sa, sb = build_full_shard(model, cls), build_full_shard(big, cls)
    vocab = engine._ctx.cfg.vocab_size
    words, n = sizes["solo"]
    ids_a = kv_ids(70, words, vocab)
    plan = ladder(n - 1)
    tally = SpecTally(engine, node)
    try:
      # (a) A alone, then A with B in its middle.
      async def a_chunks(rid, out, chunks):
        for this, nxt in chunks:
          c = await engine.generate_chunk(rid, sa, out[-1], this, temp=0.0, top_k=0, next_size=nxt)
          out.extend(int(t) for t in np.asarray(c).reshape(-1))
      tok, _ = await engine.infer_sample_tensor("A0", sa, np.asarray([ids_a]), temp=0.0, top_k=0)
      alone = [int(tok)]
      await a_chunks("A0", alone, plan)
      await engine.clear_request("A0")
      tok, _ = await engine.infer_sample_tensor("A", sa, np.asarray([ids_a]), temp=0.0, top_k=0)
      got = [int(tok)]
      await a_chunks("A", got, plan[:2])
      t0 = time.perf_counter()
      await engine.ensure_shard(sb)
      load_s = time.perf_counter() - t0
      engine._contexts[sb].tokenizer = id_tokenizer()
      tok_b, _ = await engine.infer_sample_tensor("B", sb, np.asarray([kv_ids(71, words, vocab)]),
                                                  temp=0.0, top_k=0)
      await engine.generate_chunk("B", sb, int(tok_b), 8, temp=0.0, top_k=0)
      await engine.clear_request("B")
      await a_chunks("A", got, plan[2:-1])
      perf = await loop.run_in_executor(None, http_json, base + "/v1/perf")
      ctxs = {c["model_id"]: c for c in perf["contexts"]}
      on_card = engine.device.type == "cuda"
      ok = (got == alone[:len(got)] and set(ctxs) == {model, big}
            and (not on_card or all(c["graph_pool_bytes"] > 0 and c["slab_bytes"] > 0
                                    for c in ctxs.values())))
      print(f"[decode] resident: {big} loaded beside {model} in {load_s:.1f} s; A's {len(got)} "
            f"tokens with B in their middle {'equal' if got == alone[:len(got)] else 'DIFFER from'} "
            f"A alone; /v1/perf contexts: "
            + "; ".join(f"{m}: {c['graphs']} graphs, {c['graph_pool_bytes'] / 2**20:.1f} MiB graph "
                        f"pool, {c['slab_bytes'] / 2**20:.1f} MiB slab, {c['states']} states"
                        for m, c in ctxs.items())
            + f" {'ok' if ok else 'FAIL'} ({card})", flush=True)
      if not ok:
        raise AssertionError(f"decode: resident models: A {got} / alone {alone}; contexts {ctxs}")
      # (d) The target as its own draft model: a non-repeating prompt. Warm-ups first: the
      # Node's sampler keys (top_k) and the draft's and the verify's programs are
      # captured there, not inside the timed requests.
      ids_d = kv_ids(72, words, vocab)
      node.speculate_tokens, node.draft_model = 0, ""
      await node_stream(node, model, kv_ids(77, 64, vocab), 16, "warm-plain")
      await node_stream(node, big, kv_ids(77, 64, vocab), 16, "warm-big")
      want, tpot_plain = await node_stream(node, model, ids_d, n, "draft-plain")
      node.speculate_tokens = SPEC_K
      node.draft_model = engine.draft_model = model
      await node_stream(node, model, kv_ids(78, 64, vocab), 20, "warm-self")
      await node_stream(node, big, kv_ids(78, 64, vocab), 20, "warm-drafted")
      tally.reset()
      spec, tpot_spec = await node_stream(node, model, ids_d, n, "draft-self")
      await settle(engine)
      partial = [(d, a) for d, a, _ in tally.rounds if a < d + 1]
      proposed = [x for x in tally.drafts if len(x[3]) >= 2]
      for (rid, _, context, draft, _), (d, a, _) in zip(proposed, tally.rounds):
        if a < d + 1:  # a short round must be a near tie at its first rejected draft token
          verified = spec[len(context) - len(ids_d):][:a]
          tie, gap, limit = await tie_check(torch, engine, sa, context + verified[:-1],
                                            draft[a - 1], verified[-1])
          if not tie:
            raise AssertionError(f"decode: the self-draft's round ({d}, {a}) rejects without a tie "
                                 f"({gap} > {limit})")
      full = len(tally.rounds) - len(partial)
      draft_ms = [x[4] for x in proposed]
      verify_ms = [r[2] for r in tally.rounds if r[2] is not None]
      print(f"[decode] self-draft: {len(tally.rounds)} rounds, {full} of {SPEC_K} + 1 tokens, "
            f"{len(partial)} shorter (each a near tie); median draft {np.median(draft_ms):.3f} ms "
            f"({SPEC_K} replays and the feed) and verify {np.median(verify_ms):.3f} ms a round "
            f"(wall); TPOT {tpot_spec:.3f} ms against {tpot_plain:.3f} ms plain ({card})", flush=True)
      await streams_agree(torch, engine, sa, "self-draft", ids_d, want, spec, card)
      # (d) The small model drafting for the large one.
      ids_b = kv_ids(73, words, vocab)
      node.speculate_tokens, node.draft_model = 0, ""
      want_b, tpot_b = await node_stream(node, big, ids_b, n, "big-plain")
      node.speculate_tokens, node.draft_model = SPEC_K, model
      tally.reset()
      got_b, tpot_bs = await node_stream(node, big, ids_b, n, "big-drafted")
      await settle(engine)
      lens = [a for _, a, _ in tally.rounds]
      stood_down = len(lens) >= 2 and lens[-2:] == [1, 1] and all(
        not (lens[i] == 1 and lens[i + 1] == 1) for i in range(len(lens) - 2))
      draft_ms = [x[4] for x in tally.drafts]
      verify_ms = [r[2] for r in tally.rounds if r[2] is not None]
      print(f"[decode] {model} drafting for {big} (seeded random weights of two cards: the "
            f"acceptance says nothing of real text): {len(lens)} rounds accepting {lens}; a round "
            f"costs {np.median(draft_ms):.3f} ms of draft ({SPEC_K} replays and the feed) + "
            f"{np.median(verify_ms):.3f} ms of verify (median wall) against a plain step's "
            f"{tpot_b:.3f} ms; the Node stood down after two bonus-only rounds: "
            f"{'yes' if stood_down else 'NO'}; TPOT {tpot_bs:.3f} ms ({card})", flush=True)
      if not stood_down:
        raise AssertionError(f"decode: draft rounds {lens} did not stand down after two bonus-only rounds")
      await streams_agree(torch, engine, sb, f"{model} drafting for {big}", ids_b, want_b, got_b,
                          card)
      # (d) Two concurrent requests: no draft call while both are outstanding.
      tally.reset()
      base_shard = registry.build_base_shard(big, cls)
      events = {r: asyncio.Event() for r in ("c1", "c2")}

      def on_token(rid, tokens, finished):
        if finished and rid in events:
          events[rid].set()
      node.on_token.register("decode-conc").on_next(on_token)
      await asyncio.gather(*(node.process_prompt(base_shard, " ".join(f"w{i}" for i in
                                                                      kv_ids(74 + j, words, vocab)),
                                                 rid, max_tokens=n // 2, temperature=0.0)
                             for j, rid in enumerate(events)))
      await asyncio.wait_for(asyncio.gather(*(e.wait() for e in events.values())), timeout=600)
      node.on_token.deregister("decode-conc")
      await settle(engine)
      busy = [x for x in tally.drafts if x[1] > 1]
      print(f"[decode] two concurrent requests on {big} with a draft model: {len(tally.drafts)} "
            f"draft calls, {len(busy)} of them with both outstanding "
            f"{'ok' if not busy else 'FAIL'} ({card})", flush=True)
      if busy:
        raise AssertionError(f"decode: {len(busy)} draft calls under concurrency")
      node.speculate_tokens, node.draft_model, engine.draft_model = 0, "", ""
      # (a) A third model evicts the idle context (B's); A, paused, finishes as alone.
      registry.model_cards[third] = dict(registry.model_cards[model])
      idle = engine._contexts[sb]
      had = (len(idle.graphs.programs), idle.graphs.slab_bytes) if idle.graphs else (0, 0)
      await engine.ensure_shard(build_full_shard(third, cls))
      sc = build_full_shard(third, cls)
      engine._contexts[sc].tokenizer = id_tokenizer()
      tok_c, _ = await engine.infer_sample_tensor("C", sc, np.asarray([ids_a]), temp=0.0, top_k=0)
      await engine.generate_chunk("C", sc, int(tok_c), 8, temp=0.0, top_k=0)
      await engine.clear_request("C")
      await a_chunks("A", got, plan[-1:])
      await engine.clear_request("A")
      cleared = idle.graphs is None or (not idle.graphs.programs and idle.graphs.slab is None)
      ok = (set(engine._contexts) == {sa, sc} and cleared and got[:n] == alone[:n])
      print(f"[decode] resident: {third} evicted the idle {big} context ({had[0]} graphs, "
            f"{had[1] / 2**20:.1f} MiB slab cleared: {'yes' if cleared else 'NO'}), captured its "
            f"own graphs, and A finished as it streams alone "
            f"({'equal' if got[:n] == alone[:n] else 'DIFFER'}) {'ok' if ok else 'FAIL'} ({card})",
            flush=True)
      if not ok:
        raise AssertionError(f"decode: third model: contexts {list(engine._contexts)}, cleared "
                             f"{cleared}, A equal {got[:n] == alone[:n]}")
      return {"launches": launch_counts()}
    finally:
      tally.close()
      registry.model_cards.pop(third, None)
  return kv_server(torch, DECODE_ENV, device, model, drive)


def check_decode_paths(torch, card: str, device: str = "cuda", model: str = "synthetic-llama-1b",
                       rounds: int = 4) -> dict:
  """Phase 18: the single peer's decode paths besides the plain chunk (see the module
  docstring): two resident models, overlapped chunks and speculative decoding. Every
  check fails the run. Returns the K1-K4 launches its servers counted."""
  from xotorch_tpu_torch.models import graphs
  t0 = time.perf_counter()
  for fn in graphs.counted_wrappers():
    if fn.__name__ in KV_KERNELS:
      fn.launches = 0
  t = time.perf_counter()
  check_resident_and_drafts(torch, card, device, model)
  print(f"[time] phase 18 (a, d): {time.perf_counter() - t:.1f} s", flush=True)
  t = time.perf_counter()
  check_overlap(torch, card, device, model, rounds)
  print(f"[time] phase 18 (b): {time.perf_counter() - t:.1f} s", flush=True)
  for paged in (False, True):
    t = time.perf_counter()
    check_lookup(torch, card, device, model, paged)
    print(f"[time] phase 18 (c, {'paged' if paged else 'contiguous'}): "
          f"{time.perf_counter() - t:.1f} s", flush=True)
  launches = launch_counts()
  print(f"[decode] phase 18: {time.perf_counter() - t0:.1f} s; launches {launches} ({card})",
        flush=True)
  return {"launches": launches}


# ------------------------------------------------------------------ phase 19: MoE and vision

# The published config.json of Qwen/Qwen3-30B-A3B (huggingface.co/Qwen/Qwen3-30B-A3B,
# config.json), as it stands except num_hidden_layers: the smoke writes and serves 4 of
# its 48 layers at full width (all 48 would be ~61 GB of bf16 on disk).
QWEN3_MOE_CONFIG = {
  "architectures": ["Qwen3MoeForCausalLM"], "attention_bias": False, "attention_dropout": 0.0,
  "bos_token_id": 151643, "decoder_sparse_step": 1, "eos_token_id": 151645, "head_dim": 128,
  "hidden_act": "silu", "hidden_size": 2048, "initializer_range": 0.02,
  "intermediate_size": 6144, "max_position_embeddings": 40960, "max_window_layers": 48,
  "mlp_only_layers": [], "model_type": "qwen3_moe", "moe_intermediate_size": 768,
  "norm_topk_prob": True, "num_attention_heads": 32, "num_experts": 128,
  "num_experts_per_tok": 8, "num_hidden_layers": 48, "num_key_value_heads": 4,
  "output_router_logits": False, "rms_norm_eps": 1e-06, "rope_scaling": None,
  "rope_theta": 1000000.0, "router_aux_loss_coef": 0.001, "sliding_window": None,
  "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
  "use_sliding_window": False, "vocab_size": 151936,
}
MOE_LAYERS = 4  # of the card's 48 (8 until phase 23 needed the smoke's time)
# The cut is served under a card of its own depth, added to the registry in this process
# only (the package's qwen-3-30b-a3b card says 48 layers).
MOE_CUT_CARD = f"qwen-3-30b-a3b-cut{MOE_LAYERS}"
MOE_CUT_REPO = f"Qwen/Qwen3-30B-A3B-cut{MOE_LAYERS}"

# The published config.json of llava-hf/llava-1.5-7b-hf (huggingface.co/llava-hf/
# llava-1.5-7b-hf, config.json), as it stands: its text_config states only what differs
# from the llama defaults (4096 hidden, 32 layers and heads, 11008 intermediate), its
# vision_config CLIP ViT-L/14 at 336 pixels (24 layers, quick_gelu).
LLAVA_CONFIG = {
  "architectures": ["LlavaForConditionalGeneration"], "ignore_index": -100,
  "image_token_index": 32000, "model_type": "llava", "pad_token_id": 32001,
  "projector_hidden_act": "gelu",
  "text_config": {"_name_or_path": "lmsys/vicuna-7b-v1.5", "architectures": ["LlamaForCausalLM"],
                  "max_position_embeddings": 4096, "model_type": "llama", "rms_norm_eps": 1e-05,
                  "torch_dtype": "float16", "vocab_size": 32064},
  "tie_word_embeddings": False, "torch_dtype": "float16", "transformers_version": "4.36.0.dev0",
  "vision_config": {"hidden_size": 1024, "image_size": 336, "intermediate_size": 4096,
                    "model_type": "clip_vision_model", "num_attention_heads": 16,
                    "num_hidden_layers": 24, "patch_size": 14, "projection_dim": 768,
                    "vocab_size": 32000},
  "vision_feature_layer": -2, "vision_feature_select_strategy": "default", "vocab_size": 32064,
}
LLAVA_CARD, LLAVA_REPO_DIR = "llava-1.5-7b-hf", "llava-hf--llava-1.5-7b-hf"
LLAVA_IMAGE_SHAPE = (480, 640, 3)  # a 4:3 photo: resized to 336 on its short edge, cropped
MOE_LAYER_REL = 2.0 ** -5  # a card MoE layer's output against the fp32 plain MoE given the
                           # same input and experts: bf16 products over 2048 and 768 terms
ROUTER_TIE_REL = 2.0 ** -8  # a near tie of two experts: probabilities one bf16 step apart
FAMILY_ENV = {"XOT_PREFIX_CACHE": "0", "XOT_PREFILL_COSCHED": "0"}


def write_text_checkpoint(torch, model_dir, config: dict, card: str, files: int,
                          device: str = "cuda") -> dict:
  """Seeded random bf16 weights of `config`'s text stack written by the port's own
  save_shard_params as `files` safetensors files of consecutive layers (the first with
  the embedding, tied or not, the last with the final norm and any lm_head), plus
  config.json (`config` as given) and a word-level tokenizer (write_word_tokenizer,
  `<image>` at the image token of a llava config). Returns the weight map (tensor ->
  file)."""
  from pathlib import Path
  from xotorch_tpu_torch.inference.shard import Shard
  from xotorch_tpu_torch.models import weights
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.transformer import init_random_params
  model_dir = Path(model_dir)
  model_dir.mkdir(parents=True, exist_ok=True)
  cfg = config_from_hf_dict(config)
  n = cfg.num_layers
  bounds = [round(i * n / files) for i in range(files + 1)]
  weight_map = {}
  for i in range(files):
    start, end = bounds[i], bounds[i + 1] - 1
    shard = Shard(card, start, end, n)
    params = init_random_params(cfg, end - start + 1, shard.is_first_layer, shard.is_last_layer,
                                seed=0, dtype=torch.bfloat16, device=device, start_layer=start)
    if not shard.is_first_layer:
      params.pop("embed", None)  # a tied table is written once, with the first shard
    name = f"model-text-{i + 1}.safetensors"
    weights.save_shard_params(params, cfg, shard, model_dir / name)
    del params
    weight_map.update((t, name) for t in weights._read_header(model_dir / name)[0])
  (model_dir / "config.json").write_text(json.dumps(config))
  extra = {"<image>": cfg.image_token_index} if cfg.is_multimodal else None
  write_word_tokenizer(model_dir, cfg.vocab_size, extra)
  return weight_map


def write_index(model_dir, weight_map: dict) -> float:
  """model.safetensors.index.json over `weight_map`; returns the files' GB."""
  total = sum((model_dir / f).stat().st_size for f in set(weight_map.values()))
  (model_dir / "model.safetensors.index.json").write_text(
    json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}))
  return total / 1e9


def write_vision_tower(torch, model_dir, cfg, device: str = "cuda") -> dict:
  """The CLIP tower and the projector of a llava config as HF tensors (the names of
  llava-hf's checkpoints: vision_tower.vision_model.*, multi_modal_projector.*), seeded
  random bf16 (weights ~N(0, 0.02), layer norms at 1 and 0), written by the port's
  safetensors writer as one more file. Returns its weight map."""
  from xotorch_tpu_torch.models import vision, weights
  v = cfg.vision
  H, I, P, N = v.hidden_size, v.intermediate_size, v.patch_size, v.num_patches
  g = torch.Generator(device=device)
  g.manual_seed(19)
  rnd = lambda *shape: (torch.randn(shape, generator=g, device=device) * 0.02).to(torch.bfloat16)  # noqa: E731
  shapes = {"class_embed": (H,), "patch_embed": (H, 3, P, P), "pos_embed": (N + 1, H),
            "wq": (H, H), "wk": (H, H), "wv": (H, H), "wo": (H, H), "w_fc1": (I, H),
            "w_fc2": (H, I), "bq": (H,), "bk": (H,), "bv": (H,), "bo": (H,), "b_fc1": (I,),
            "b_fc2": (H,), "w1": (cfg.hidden_size, H), "b1": (cfg.hidden_size,),
            "w2": (cfg.hidden_size, cfg.hidden_size), "b2": (cfg.hidden_size,)}
  tensors = {}
  for name, slot in vision.vision_tensor_names(v).items():
    key = slot.rsplit(".", 1)[-1]
    hf = name if name.startswith("multi_modal_projector.") else "vision_tower.vision_model." + name
    if key.endswith(("_w", "_b")):  # layer norms
      fill = torch.ones if key.endswith("_w") else torch.zeros
      tensors[hf] = fill(H, dtype=torch.bfloat16, device=device)
    else:
      tensors[hf] = rnd(*shapes[key])
  name = "model-vision.safetensors"
  weights._write_safetensors(tensors, model_dir / name)
  return {t: name for t in tensors}


@contextlib.contextmanager
def moe_recorder(torch):
  """The transformer's MoE MLP wrapped to record every call: the input h, the experts
  the router chose and the output, on the host in fp32; yields the list."""
  from xotorch_tpu_torch.models import transformer
  calls = []
  real_mlp, real_route = transformer._moe_mlp, transformer._moe_route

  def recorded(layer, h, cfg):
    _, idx = real_route(layer, h, cfg)
    out = real_mlp(layer, h, cfg)
    calls.append((h.float().cpu(), idx.cpu(), out.float().cpu()))
    return out
  transformer._moe_mlp = recorded
  try:
    yield calls
  finally:
    transformer._moe_mlp = real_mlp


@contextlib.contextmanager
def routing_recorded(torch):
  """The experts the transformer's router picks, one [B, T, k] index tensor a call on the
  host, in call order (empty for a model without experts); yields the list."""
  from xotorch_tpu_torch.models import transformer
  real = transformer._moe_route
  chosen = []

  def route(layer, h, cfg):
    vals, idx = real(layer, h, cfg)
    chosen.append(idx.cpu())
    return vals, idx
  transformer._moe_route = route
  try:
    yield chosen
  finally:
    transformer._moe_route = real


@contextlib.contextmanager
def forced_routing(torch, choices: list):
  """The transformer's router replaced by the experts in `choices` (one [B, T, k] index
  tensor a call, in call order), weighted by this side's own probabilities at them."""
  from xotorch_tpu_torch.models import transformer
  real = transformer._moe_route

  def route(layer, h, cfg):
    idx = choices.pop(0).to(h.device)
    probs = torch.softmax(h.to(torch.float32) @ layer["router"].to(torch.float32), dim=-1)
    vals = torch.gather(probs, -1, idx)
    if cfg.norm_topk_prob:
      vals = vals / vals.sum(dim=-1, keepdim=True)
    return vals, idx
  transformer._moe_route = route
  try:
    yield
  finally:
    transformer._moe_route = real


def check_moe_model(torch, model_dir, card: str, limit: float = 5e-2, T: int = 64,
                    steps: int = 4, device: str = "cuda") -> None:
  """Two layers of the Qwen3-30B-A3B checkpoint at full width, read by load_shard_params:
  a T-token prefill (the dense combine: all 128 experts) through K1 and `steps` decode
  steps (the routed gather of 8 experts) through K2, in bf16 on the card. On the CPU in
  fp32, from the same checkpoint: (1) every MoE call of the card's run is recomputed
  from the card's own input with the card's chosen experts, within MOE_LAYER_REL of its
  output's largest |value|; the CPU's own routing of that input may choose other
  experts only at a near tie, the two probabilities within ROUTER_TIE_REL of the larger
  (a flip elsewhere fails); (2) the whole cut, routed as the card routed, gives the last
  position's logits and each step's within `limit` of the logits' range. K1 once a layer,
  K2 once a layer a step."""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.inference.shard import Shard
  from xotorch_tpu_torch.models import transformer
  from xotorch_tpu_torch.models.config import load_model_config
  from xotorch_tpu_torch.models.weights import load_shard_params
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  cfg = dataclasses.replace(load_model_config(model_dir), num_layers=2)
  shard = Shard(card, 0, 1, 2)
  tokens = np.random.default_rng(19).integers(0, cfg.vocab_size, size=(1, T))

  def run(dev, dtype, kernels: bool):
    params = load_shard_params(model_dir, cfg, shard, dtype=dtype, device=dev)
    cache = transformer.init_kv_cache(cfg, 2, 1, T + steps, dtype, dev)
    logits, _ = transformer.forward_shard(params, torch.as_tensor(tokens, device=dev), cache, 0,
                                          cfg, True, True, use_flash=kernels)
    out = [logits[0, -1].float().cpu()]
    for i in range(steps):
      tok = torch.tensor([[int(tokens[0, i])]], device=dev)
      logits, _ = transformer.forward_shard(params, tok, cache, T + i, cfg, True, True,
                                            use_flash_decode=kernels)
      out.append(logits[0, -1].float().cpu())
    return out, params

  with torch.inference_mode():
    for k in (flash_attention, flash_cached_attention):
      k.launches = 0
    with moe_recorder(torch) as calls:
      got, card_params = run(device, torch.bfloat16, True)
    launched = {k.__name__: k.launches for k in (flash_attention, flash_cached_attention)}
    del card_params
    t0 = time.perf_counter()
    want_layers = load_shard_params(model_dir, cfg, shard, dtype=torch.float32, device="cpu")
    worst_layer, flips, near, choices = 0.0, 0, 0, 0
    for i, (h, idx, out) in enumerate(calls):
      layer = {name: w[i % 2] for name, w in want_layers["layers"].items()}
      probs = torch.softmax(h @ layer["router"], dim=-1).reshape(-1, cfg.num_experts)
      _, own = transformer._moe_route(layer, h, cfg)
      for row, (a, b) in enumerate(zip(idx.reshape(-1, idx.shape[-1]).tolist(),
                                       own.reshape(-1, own.shape[-1]).tolist())):
        choices += len(a)
        card_only, cpu_only = sorted(set(a) - set(b)), sorted(set(b) - set(a))
        for x, y in zip(card_only, cpu_only):
          flips += 1
          px, py = probs[row, x].item(), probs[row, y].item()
          if abs(px - py) <= ROUTER_TIE_REL * max(px, py):
            near += 1
      with forced_routing(torch, [idx]):
        ref = transformer._moe_mlp(layer, h, cfg)
      worst_layer = max(worst_layer, ((out - ref).abs().max() / ref.abs().max()).item())
    del want_layers
    with forced_routing(torch, [idx for _, idx, _ in calls]):
      want, _ = run("cpu", torch.float32, False)
    cpu_s = time.perf_counter() - t0
  if not all(bool(torch.isfinite(g).all()) for g in got):
    raise AssertionError("moe model: non-finite logits on the card")
  worst = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))
  ok = (worst < limit and worst_layer < MOE_LAYER_REL and flips == near
        and launched == {"flash_attention": 2, "flash_cached_attention": 2 * steps})
  print(f"[moe model] 2-layer Qwen3-30B-A3B cut from the checkpoint (128 experts, top 8), "
        f"prefill {T} (dense combine) + decode {steps} (routed): {len(calls)} MoE calls, each "
        f"within {worst_layer:.3e} of the fp32 plain MoE given the card's input and experts "
        f"(limit {MOE_LAYER_REL:g}); expert flips between the card's and the CPU's routing "
        f"{flips} of {choices} choices, {near} at a near tie (within {ROUTER_TIE_REL:g} of the "
        f"larger probability); max logit error {worst:.3e} of the logits' range routed as the "
        f"card routed (limit {limit:g}); launches {launched}; the CPU's fp32 checks took "
        f"{cpu_s:.1f} s {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"moe model: error {worst}, layer error {worst_layer}, flips {flips} "
                         f"({near} near ties), launches {launched}")


def llava_image(seed: int = 19):
  """A seeded uint8 photo-sized image (LLAVA_IMAGE_SHAPE)."""
  import numpy as np
  return np.random.default_rng(seed).integers(0, 256, size=LLAVA_IMAGE_SHAPE, dtype=np.uint8)


def check_llava_model(torch, model_dir, limit: float = 5e-2, steps: int = 4,
                      device: str = "cuda") -> None:
  """The llava-1.5-7b checkpoint's vision tower and projector in full and two layers of
  its text stack at full width: an image (preprocess_images) through the tower (plain
  matmul and softmax attention) and the projector, its 576 features merged at the
  prompt's <image>, the merged sequence prefilled from 0 through K1 and `steps` decode
  steps through K2, in bf16 on the card, against the same in fp32 on the CPU: the
  projected features and the last 64 positions' logits, then each step's, within
  `limit` of their range; K1 once a layer, K2 once a layer a step."""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.inference.shard import Shard
  from xotorch_tpu_torch.models import transformer, vision
  from xotorch_tpu_torch.models.config import load_model_config
  from xotorch_tpu_torch.models.weights import load_shard_params, load_vision_tower
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  cfg = dataclasses.replace(load_model_config(model_dir), num_layers=2)
  shard = Shard(LLAVA_CARD, 0, 1, 2)
  rng = np.random.default_rng(7)
  ids = np.concatenate([[1], rng.integers(3, cfg.image_token_index, 10), [cfg.image_token_index],
                        rng.integers(3, cfg.image_token_index, 10)]).astype(np.int64)
  pixels = vision.preprocess_images([llava_image()], cfg.vision.image_size)

  def run(dev, dtype, kernels: bool):
    params = load_shard_params(model_dir, cfg, shard, dtype=dtype, device=dev)
    vparams, pparams = load_vision_tower(model_dir, cfg, dtype=dtype, device=dev)
    feats = vision.project_features(
      pparams, vision.encode_images(vparams, torch.from_numpy(pixels).to(dev), cfg.vision,
                                    cfg.vision_feature_layer, cfg.vision_feature_select),
      cfg.projector_hidden_act)
    merged = vision.merge_image_features(
      transformer.embed(params, torch.from_numpy(ids).to(dev)[None])[0], ids, feats,
      cfg.image_token_index)
    n = merged.shape[0]
    cache = transformer.init_kv_cache(cfg, 2, 1, n + steps, dtype, dev)
    h, _ = transformer.forward_shard(params, merged[None].to(dtype), cache, 0, cfg, False, False,
                                     use_flash=kernels)
    out = [feats[0].float().cpu(), transformer.unembed(params, h[:, -64:], cfg)[0].float().cpu()]
    for i in range(steps):
      tok = torch.tensor([[int(ids[i])]], device=dev)
      logits, _ = transformer.forward_shard(params, tok, cache, n + i, cfg, True, True,
                                            use_flash_decode=kernels)
      out.append(logits[0].float().cpu())
    return out, n

  with torch.inference_mode():
    for k in (flash_attention, flash_cached_attention):
      k.launches = 0
    got, n = run(device, torch.bfloat16, True)
    launched = {k.__name__: k.launches for k in (flash_attention, flash_cached_attention)}
    t0 = time.perf_counter()
    want, _ = run("cpu", torch.float32, False)
    cpu_s = time.perf_counter() - t0
  if not all(bool(torch.isfinite(g).all()) for g in got):
    raise AssertionError("llava model: non-finite values on the card")
  errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
  ok = (max(errs) < limit
        and launched == {"flash_attention": 2, "flash_cached_attention": 2 * steps})
  print(f"[llava model] CLIP tower (24 layers) + projector + a 2-layer cut of the text stack from "
        f"the checkpoint: one {LLAVA_IMAGE_SHAPE[1]}x{LLAVA_IMAGE_SHAPE[0]} image, {len(ids)} prompt "
        f"tokens merged to {n} positions, prefill + decode {steps}: projected features within "
        f"{errs[0]:.3e} of their range, logits within {max(errs[1:]):.3e} (limit {limit:g}); "
        f"launches {launched}; the CPU's fp32 path took {cpu_s:.1f} s {'ok' if ok else 'FAIL'}",
        flush=True)
  if not ok:
    raise AssertionError(f"llava model: errors {errs}, launches {launched}")


def contiguous_want(run: dict, layers: int, chunk: int = 1024) -> dict:
  """K1 and K2 launches of drive_main_path's requests on contiguous caches: a prompt of
  two or more whole segments before its last prefills them through prefill_scan (every
  segment through K2), others take K1 for the first segment and K2 for each later one;
  K2 once a decode step. A layer each."""
  segments = [-(-n // chunk) for n in run["prompt_tokens"]]
  scanned = [(n - 1) // chunk >= 2 for n in run["prompt_tokens"]]
  k1 = sum(not sc for sc in scanned)
  k2 = sum(sg if sc else sg - 1 for sg, sc in zip(segments, scanned))
  return {"flash_attention": layers * k1, "flash_cached_attention": layers * (run["steps"] + k2)}


def pool_line(engine, label: str) -> int:
  """The active context's captured graphs and their pool's bytes on the card."""
  stats = next(s for s in engine.context_stats() if s["active"])
  print(f"[{label}] {stats['graphs']} captured graphs, graph pool {stats['graph_pool_bytes']} bytes, "
        f"slab {stats['slab_bytes']} bytes", flush=True)
  return stats["graph_pool_bytes"]


def drive_moe(torch, card: str, device: str = "cuda") -> dict:
  """Qwen3-30B-A3B: MOE_LAYERS of its 48 layers at full width written as a seeded checkpoint
  (write_text_checkpoint, four files), the two-layer cut held against the CPU
  (check_moe_model), then served through main.py's entry points under a card of
  MOE_LAYERS layers added in this process: the main path's three requests (K1 and K2 held to the
  layers x (prefills, steps) formula), B=1 and B=8 lockstep decode chunks under the
  profiler (the routed gather at 1 and 8 rows) with the graph pool's bytes after each;
  then XOT_PAGED_KV=1 (K4 = layers x segments, K3 = layers x steps, pages back to 0);
  then --quantize int8 with XOT_INT8_KERNEL=1 (K6 = 4 attention projections x layers x
  steps; the experts int8 through the plain dequantized product, as JAX). Returns the
  phase's launches."""
  import shutil
  import tempfile
  from pathlib import Path
  from xotorch_tpu_torch.models import registry
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  from xotorch_tpu_torch.ops.int8_matmul import int8_rowquant_matmul
  from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention
  layers = MOE_LAYERS
  registry.model_cards[MOE_CUT_CARD] = {"layers": layers, "repo": {registry.TORCH: MOE_CUT_REPO},
                                        "moe": True}
  tmp = Path(tempfile.mkdtemp(prefix="xot-moe-"))
  launches = {}
  try:
    seed = tmp / "seed"
    model_dir = seed / MOE_CUT_REPO.replace("/", "--")
    t0 = time.perf_counter()
    config = {**QWEN3_MOE_CONFIG, "num_hidden_layers": layers}
    gb = write_index(model_dir, write_text_checkpoint(torch, model_dir, config, MOE_CUT_CARD, 4,
                                                      device))
    print(f"[moe] Qwen3-30B-A3B, {layers} of 48 layers at full width: {gb:.2f} GB of bf16 written "
          f"by save_shard_params in four files and an index, in {time.perf_counter() - t0:.1f} s",
          flush=True)
    check_moe_model(torch, model_dir, MOE_CUT_CARD, device=device)
    pools = {}

    async def lockstep(engine, node, api, base):
      pools[1] = pool_line(engine, "moe B=1")
      gb_held = tensor_bytes(engine._ctx.params) / 1e9
      print(f"[moe] weights on the card {gb_held:.2f} GB ({card})", flush=True)
      prof = await profile_decode(torch, engine, MOE_CUT_CARD, "TorchShardInferenceEngine", card,
                                  batch=8, tag="moe lockstep", focus="flash_cached_")
      pools[8] = pool_line(engine, "moe B=8")
      return prof

    with phase_env(XOT_HOME=str(tmp / "home"), **FAMILY_ENV):
      for tag, env, kernels, cli, profiles, after in (
          ("moe", {}, (flash_attention, flash_cached_attention), ("--models-seed-dir", str(seed)),
           (1,), lockstep),
          ("moe paged", {"XOT_PAGED_KV": "1"}, (paged_prefill_attention, paged_decode_attention),
           (), (), None),
          ("moe int8", {"XOT_QUANTIZE": "int8", "XOT_INT8_KERNEL": "1"},
           (flash_attention, flash_cached_attention, int8_rowquant_matmul), (), (), None)):
        t0 = time.perf_counter()
        run = drive_main_path(torch, card, device=device, model=MOE_CUT_CARD, kernels=kernels,
                              env=env, tag=tag, profiles=profiles, cli=cli,
                              focus="flash_cached_", after=after)
        counts, steps = run["launches"], run["steps"]
        if tag == "moe paged":
          segments = sum(-(-n // 1024) for n in run["prompt_tokens"])
          want = {"paged_prefill_attention": layers * segments,
                  "paged_decode_attention": layers * steps}
        else:
          want = contiguous_want(run, layers)
          if tag == "moe int8":
            want["int8_rowquant_matmul"] = 4 * layers * steps
        pool = run["pool"]
        ok = (counts == want and steps >= run["decoded"]
              and (pool is None) == (tag != "moe paged")
              and (pool is None or pool["pages_in_use"] == 0))
        print(f"[{tag}] launches {counts} against {want} (prompt tokens {run['prompt_tokens']}, "
              f"{steps} decode steps); {'; '.join(run['timings'])}; pool {pool}; served in "
              f"{time.perf_counter() - t0:.1f} s with the load ({card}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
          raise AssertionError(f"{tag}: launches {counts}, wanted {want}; pool {pool}")
        for name, n in counts.items():
          launches[name] = launches.get(name, 0) + n
      t0 = time.perf_counter()
      for name, n in family_training(torch, card, MOE_CUT_CARD, layers, MOE_TRAIN_RUNS, device).items():
        launches[name] = launches.get(name, 0) + n
      print(f"[time] phase 19 (c), {MOE_CUT_CARD} training: {time.perf_counter() - t0:.1f} s",
            flush=True)
    print(f"[moe] graph pool bytes: B=1 {pools.get(1)}, after B=8 {pools.get(8)} ({card})",
          flush=True)
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
    registry.model_cards.pop(MOE_CUT_CARD, None)
  return launches


def image_uri(img) -> str:
  """A PNG data: URI of a uint8 HWC image (PIL)."""
  import base64
  import io
  from PIL import Image
  buf = io.BytesIO()
  Image.fromarray(img).save(buf, format="PNG")
  return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def llava_requests(model: str, uri: str):
  """An image request twice (temperature 0, 32 tokens, streamed: its TTFT holds the
  tower, the projector and the merged prefill), then a 512-word text request."""
  words = " ".join(f"w{i % 97}" for i in range(12))
  image_body = {"model": model, "temperature": 0, "max_tokens": 32, "stream": True,
                "stream_options": {"include_usage": True},
                "messages": [{"role": "user", "content": [
                  {"type": "text", "text": words},
                  {"type": "image_url", "image_url": {"url": uri}}]}]}
  return [("image request, 32 tokens, streaming", image_body),
          ("the same image request again", dict(image_body)),
          ("512-word text prompt, 32 tokens", {**main_requests(model)[0][1], "max_tokens": 32})]


@contextlib.contextmanager
def multimodal_timers(torch):
  """Time the engine's multimodal prefill call and, inside it, the image preprocessing
  (host), the tower, the projector and the text stack's merged forward, each bracketed
  by device syncs; yields a list of {name: ms, "total": ms}, one a request."""
  from xotorch_tpu_torch.inference.torch_engine import engine as engine_mod
  real = {n: getattr(engine_mod, n)
          for n in ("preprocess_images", "encode_images", "project_features", "forward_shard")}
  real_sync = engine_mod.TorchShardInferenceEngine._infer_multimodal_sync
  rows = []
  inside = []
  sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

  def timed(name):
    def call(*a, **kw):
      if not inside:  # forward_shard serves the text requests too
        return real[name](*a, **kw)
      sync()
      t0 = time.perf_counter()
      out = real[name](*a, **kw)
      sync()
      rows[-1][name] = (time.perf_counter() - t0) * 1e3
      return out
    return call

  def total(self, *a, **kw):
    rows.append({})
    inside.append(True)
    t0 = time.perf_counter()
    try:
      out = real_sync(self, *a, **kw)
    finally:
      inside.clear()
    rows[-1]["total"] = (time.perf_counter() - t0) * 1e3
    return out
  for name in real:
    setattr(engine_mod, name, timed(name))
  engine_mod.TorchShardInferenceEngine._infer_multimodal_sync = total
  try:
    yield rows
  finally:
    for name, fn in real.items():
      setattr(engine_mod, name, fn)
    engine_mod.TorchShardInferenceEngine._infer_multimodal_sync = real_sync


def drive_llava(torch, card: str, device: str = "cuda") -> dict:
  """LLaVA-1.5-7B at full width and depth written as a seeded checkpoint (the text
  stack by save_shard_params in four files, the tower and projector in a fifth), its
  tower, projector and a two-layer text cut held against the CPU (check_llava_model),
  then served through main.py's entry points on the registry's llava-1.5-7b-hf card:
  llava_requests over HTTP (the image as a PNG data URI), K1 = 32 x (image prefills +
  text prefills), K2 = 32 x decode steps, the two image requests' greedy streams equal,
  TTFT split into tower, projector and the merged prefill (multimodal_timers). Returns
  the phase's launches."""
  import shutil
  import tempfile
  from pathlib import Path
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  cfg = config_from_hf_dict(LLAVA_CONFIG)
  layers = cfg.num_layers
  tmp = Path(tempfile.mkdtemp(prefix="xot-llava-"))
  try:
    seed = tmp / "seed"
    model_dir = seed / LLAVA_REPO_DIR
    t0 = time.perf_counter()
    weight_map = write_text_checkpoint(torch, model_dir, LLAVA_CONFIG, LLAVA_CARD, 4, device)
    weight_map.update(write_vision_tower(torch, model_dir, cfg, device))
    gb = write_index(model_dir, weight_map)
    print(f"[llava] llava-1.5-7b at full width and depth: {gb:.2f} GB of bf16 (text stack in four "
          f"files by save_shard_params, tower and projector in a fifth) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check_llava_model(torch, model_dir, device=device)
    uri = image_uri(llava_image())
    held = {}

    async def weights_held(engine, node, api, base):
      held["text"] = tensor_bytes(engine._ctx.params) / 1e9
      held["vision"] = tensor_bytes(engine._ctx.vision) / 1e9
      pool_line(engine, "llava")

    with phase_env(XOT_HOME=str(tmp / "home"), **FAMILY_ENV), multimodal_timers(torch) as rows:
      t0 = time.perf_counter()
      run = drive_main_path(torch, card, device=device, model=LLAVA_CARD, env={}, tag="llava",
                            profiles=(1,), cli=("--models-seed-dir", str(seed)),
                            requests=llava_requests(LLAVA_CARD, uri), focus="flash_cached_",
                            after=weights_held)
      served_s = time.perf_counter() - t0
    counts, steps = run["launches"], run["steps"]
    want = {"flash_attention": layers * 3, "flash_cached_attention": layers * steps}
    same = run["tokens"][0] == run["tokens"][1] and len(run["tokens"][0]) == 32
    measured = rows[-2:]  # the two measured image requests (the warm-up's come first)
    ok = counts == want and same and steps >= run["decoded"] and len(measured) == 2
    print(f"[llava] launches {counts} against {want}: K1 = {layers} x (2 image prefills + 1 text "
          f"prefill), K2 = {layers} x {steps} decode steps; the two image requests' greedy "
          f"streams {'equal' if same else 'DIFFER'}; prompt tokens {run['prompt_tokens']}; "
          f"{'; '.join(run['timings'])}; served in {served_s:.1f} s with the load ({card}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    for r, timing in zip(measured, run["timings"]):
      rest = r["total"] - sum(r[n] for n in ("preprocess_images", "encode_images",
                                             "project_features", "forward_shard"))
      print(f"[llava] image TTFT split ({timing}): preprocessing on the host "
            f"{r['preprocess_images']:.1f} ms, tower {r['encode_images']:.1f} ms, projector "
            f"{r['project_features']:.1f} ms, merged prefill (32 layers, K1) "
            f"{r['forward_shard']:.1f} ms, the rest of the call (merge, state, the logits to "
            f"the host) {rest:.1f} ms: the prefill call {r['total']:.1f} ms ({card})", flush=True)
    print(f"[llava] weights on the card: text {held.get('text', 0):.2f} GB, tower and projector "
          f"{held.get('vision', 0):.2f} GB ({card})", flush=True)
    if not ok:
      raise AssertionError(f"llava: launches {counts}, wanted {want}; streams equal {same}")
    counts = dict(counts)
    with phase_env(XOT_HOME=str(tmp / "home"), **FAMILY_ENV):
      t0 = time.perf_counter()
      for name, n in family_training(torch, card, LLAVA_CARD, layers, LLAVA_TRAIN_RUNS, device).items():
        counts[name] = counts.get(name, 0) + n
      print(f"[time] phase 19 (c), {LLAVA_CARD} training: {time.perf_counter() - t0:.1f} s",
            flush=True)
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  return counts


# Phase 19 (c): main.py train on the family checkpoints phase 19 wrote. (tag, CLI flags,
# batch rows, steps, evaluate after): Qwen3-30B-A3B's cut with LoRA and QLoRA at the
# main training batch (B 4, rows of 511), its full fine-tune at one row (the gradients and
# AdamW's two moments add three copies of the cut's 6.2 GB), LLaVA-1.5-7B's text path
# with LoRA.
MOE_TRAIN_RUNS = (("LoRA rank 8", ("--lora-rank", "8"), 4, 4, True),
                  ("QLoRA rank 8 over int8", ("--lora-rank", "8", "--quantize", "int8"), 4, 4, False),
                  ("full fine-tune", (), 1, 3, False))
LLAVA_TRAIN_RUNS = (("LoRA rank 8 on the text path", ("--lora-rank", "8"), 4, 4, True),)
FAMILY_LR = {"LoRA": "3e-3", "QLoRA": "3e-3", "full": "1e-5"}
FAMILY_FIRST_ID = 200  # the family corpora's words t200..: ids the word tokenizer names


def family_training(torch, card: str, model: str, layers: int, runs, device: str = "cuda") -> dict:
  """Phase 19 (c): main.py's train command on `model`'s seeded checkpoint (already in
  XOT_HOME: the phase's servers copied it there) over write_training_corpus's corpus in
  "t<id>" words (the checkpoint's word tokenizer names them), one train_cli each of `runs`:
  step ms, tokens/s after the first step and peak GiB; K1 = layers x steps and K1b =
  layers x steps exactly (the losses printed, not asserted to fall: a few steps on seeded
  random weights). A run with `evaluate` then runs the eval command on the trained model:
  K1 = layers x its batches, the loss finite. Returns the K1 and K1b launches."""
  import shutil
  import tempfile
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  root = tempfile.mkdtemp(prefix="xot-family-train-")
  launches = {"flash_attention": 0, "flash_attention_bwd": 0}
  try:
    os.makedirs(os.path.join(root, "data"))
    data = write_training_corpus(os.path.join(root, "data"), prefix="t", first=FAMILY_FIRST_ID)
    for tag, extra, batch, iters, evaluate in runs:
      argv = ["train", model, "--device", device, "--data", data, "--batch-size", str(batch),
              "--sequence-length", str(TRAIN_SEQ), "--iters", str(iters), "--save-every", "0",
              "--chatgpt-api-host", "127.0.0.1", "--chatgpt-api-port", "0", "--default-temp", "0",
              *extra]

      async def with_eval(node, engine, classname, api, a, run_train):
        run = await run_train()
        before = flash_attention.launches
        run["eval"] = await port_main.eval_model_cli(node, classname, model, a)
        run["eval_launches"] = flash_attention.launches - before
        return run
      run = train_cli(torch, argv, {"XOT_LR": FAMILY_LR[tag.split()[0]]}, with_eval if evaluate else None)
      for name, n in _report_run(f"{model} {tag}, B={batch} T={TRAIN_SEQ - 1}", run, card, layers,
                                 iters, falling=False).items():
        launches[name] += n
      if evaluate:
        n_eval = 8 // batch
        ok = run["eval_launches"] == layers * n_eval and math.isfinite(run["eval"] or math.nan)
        print(f"[training] {model} eval after {tag}: loss {run['eval']:.4f} over {n_eval} batches; "
              f"K1 {run['eval_launches']} = {layers} x {n_eval} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
          raise AssertionError(f"training eval {model}: loss {run['eval']}, K1 {run['eval_launches']}")
        launches["flash_attention"] += run["eval_launches"]
  finally:
    shutil.rmtree(root, ignore_errors=True)
  return launches


def check_families(torch, card: str, device: str = "cuda") -> dict:
  """Phase 19: the two families the port served last, qwen3-moe and llava (drive_moe,
  drive_llava, each serving and then training its checkpoint), then (d) their two-layer
  training cuts against the plain path in fp32 (check_training_cut over the published configs: the
  MoE cut at T 64, B*T 128 through the dense combine, full and with adapters on the
  attention slots, JAX's sites; llava's text stack at T 200 with adapters). Returns their
  attention launches summed by wrapper, K1b's included."""
  from xotorch_tpu_torch.models.transformer import LORA_SLOTS
  t0 = time.perf_counter()
  launches = {}
  for drive in (drive_moe, drive_llava):
    for name, n in drive(torch, card, device).items():
      launches[name] = launches.get(name, 0) + n
  t1 = time.perf_counter()
  for label, config, seq, window, slots, modes in (
      ("qwen3-moe", QWEN3_MOE_CONFIG, 64, 16, LORA_SLOTS[:4], ("full", "lora")),
      # llava's text stack is a llama: phase 21 (b) holds that family's full fine-tune.
      ("llava-1.5-7b", LLAVA_CONFIG, 200, 64, None, ("lora",))):
    for mode in modes:
      for name, n in check_training_cut(torch, mode, device, model=label, hf_config=config, seq=seq,
                                        window=window, slots=slots).items():
        launches[name] = launches.get(name, 0) + n
  print(f"[time] phase 19 (d), the families' two-layer training cuts: {time.perf_counter() - t1:.1f} s",
        flush=True)
  print(f"[families] phase 19 in {time.perf_counter() - t0:.1f} s ({card})", flush=True)
  return launches


ADAPTER_ENV = {"XOT_PREFIX_CACHE": "0", "XOT_PREFILL_COSCHED": "0", "XOT_MAX_RESIDENT_MODELS": "3"}
ADAPTER_WORDS = 300  # the common prompt of the streams held against each other
ADAPTER_BYTES_SHARE = 0.1  # what an adapter context may add, as a share of the base's weights


def write_adapters(torch, root, model: str) -> dict:
  """Phase 20's two adapter-only checkpoints for every layer of `model`, written by the
  port's writer (train/lora.save_lora_checkpoint): `ad1` rank 8 on the attention
  projections, `ad2` rank 16 on all seven slots, seeded, B nonzero. {name: path}."""
  from xotorch_tpu_torch.inference.shard import Shard
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.train import lora
  cfg = config_from_hf_dict(get_model_card(model)["synthetic_config"])
  L = cfg.num_layers
  out = {}
  for name, rank, slots, seed in (("ad1", 8, lora.ATTN_SLOTS, 21),
                                  ("ad2", 16, lora.ATTN_SLOTS + lora.MLP_SLOTS, 22)):
    path = os.path.join(root, f"{name}.safetensors")
    lora.save_lora_checkpoint({"layers": adapter_leaves(torch, cfg, L, rank, slots, seed)},
                              Shard(model, 0, L - 1, L), path)
    out[name] = path
  return out


def shared_ptrs(base_params, params) -> tuple:
  """(base leaves whose storage the adapter context shares, base leaves, bytes of the
  context's own tensors: those sharing no storage with the base's)."""
  def leaves(tree):
    for v in tree.values():
      yield from (leaves(v) if isinstance(v, dict) else [v])
  base = {t.data_ptr() for t in leaves(base_params)}
  mine = list(leaves(params))
  shared = sum(t.data_ptr() in base for t in mine)
  own = sum(t.nbytes for t in mine if t.data_ptr() not in base)
  return shared, len(base), own


def drive_adapters(torch, card: str, paths: dict, device: str = "cuda",
                   model: str = "synthetic-llama-1b", streams: Optional[dict] = None) -> dict:
  """Phase 20 (b): main.py --adapters serving `model` with `ad1` and `ad2` beside the base.

  - Loads: the base, then each adapter context, timed, with the card's allocated bytes
    around each: an adapter context adds under a tenth of the base's weight bytes and
    shares every base tensor's storage (data_ptr).
  - /v1/models lists both adapters, ready.
  - The main path's three requests go to the base, @ad1 and @ad2 (prefix cache and
    lane off, as phases 4-15): K1 and K2 held exactly to 16 x (prefills, steps), the
    steps summed over the three contexts' batchers.
  - One common prompt streamed greedy on each model through the engine: the adapters'
    streams differ from the base's and from each other. B=1 decode under the profiler
    on each: TPOT and the kernels an adapter adds a step. Each context's graph pool and
    slab bytes.
  - load_checkpoint swaps ad1's context to ad2's file: its next stream equals @ad2's
    under the near-tie rule and not ad1's old one (its graphs were dropped: a stale
    replay would read the old adapters), and it still aliases the base;
    save_checkpoint writes back exactly the tensors of ad2's file.
  Returns the launches."""
  import numpy as np
  from xotorch_tpu_torch.models.registry import build_full_shard, get_model_card
  from xotorch_tpu_torch.models.weights import _SafetensorsFile
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  layers = get_model_card(model)["layers"]
  vocab = get_model_card(model)["synthetic_config"]["vocab_size"]
  adapters = ",".join(f"{k}={v}" for k, v in paths.items())
  ids = [int(t) for t in np.random.default_rng(20).integers(3, vocab, size=ADAPTER_WORDS)]
  models = [model] + [f"{model}@{name}" for name in paths]
  requests = [(f"{label} -> {mid}", {**body, "model": mid})
              for (label, body), mid in zip(main_requests(model), models)]

  async def before(engine, base):
    classname = type(engine).__name__
    base_ctx = engine._contexts[build_full_shard(model, classname)]
    base_bytes = tensor_bytes(base_ctx.params)
    for mid in models[1:]:
      if device == "cuda":
        torch.cuda.synchronize()
      m0 = torch.cuda.memory_allocated() if device == "cuda" else 0
      t0 = time.perf_counter()
      await engine.ensure_shard(build_full_shard(mid, classname))
      secs = time.perf_counter() - t0
      m1 = torch.cuda.memory_allocated() if device == "cuda" else 0
      ctx = engine._contexts[build_full_shard(mid, classname)]
      shared, n_base, own = shared_ptrs(base_ctx.params, ctx.params)
      added = m1 - m0 if device == "cuda" else own
      limit = ADAPTER_BYTES_SHARE * base_bytes
      ok = shared == n_base and added < limit and own < limit
      print(f"[adapters] {mid} loaded in {secs:.3f} s: the card's allocated bytes +{added} "
            f"({100 * added / base_bytes:.2f}% of the base's {base_bytes} weight bytes; limit "
            f"{100 * ADAPTER_BYTES_SHARE:g}%), its own tensors {own} bytes, {shared} of the base's {n_base} tensors "
            f"shared (data_ptr equal) ({card}) {'ok' if ok else 'FAIL'}", flush=True)
      if not ok:
        raise AssertionError(f"adapters: {mid} added {added} bytes, shares {shared}/{n_base}")

  async def after(engine, node, api, base):
    loop = asyncio.get_running_loop()
    classname = type(engine).__name__
    shards = {mid: build_full_shard(mid, classname) for mid in models}
    listed = {m["id"]: m for m in (await loop.run_in_executor(None, http_json, base + "/v1/models"))["data"]}
    entries = [listed.get(mid) for mid in models[1:]]
    ok = all(e is not None and e["ready"] and e["adapter_of"] == model and "error" not in e
             for e in entries)
    print(f"[adapters] /v1/models: {entries} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"adapters: /v1/models lists {sorted(listed)}")
    common = {mid: await kv_generate(engine, f"common-{mid}", ids, 32, shards[mid]) for mid in models}
    if streams is not None:
      streams.update(common, ids=ids)
    distinct = len({tuple(v) for v in common.values()}) == len(models)
    print(f"[adapters] a {ADAPTER_WORDS}-token prompt, 32 greedy tokens: base {common[model][:8]}..., "
          + ", ".join(f"{mid} {common[mid][:8]}..." for mid in models[1:])
          + f": three different streams {'ok' if distinct else 'FAIL'}", flush=True)
    if not distinct:
      raise AssertionError("adapters: an adapter streamed the base's tokens, or the two agreed")
    profs = {mid: await profile_decode(torch, engine, mid, classname, card, batch=1,
                                       tag=f"adapters {mid}", focus="flash_cached_")
             for mid in models}
    if all(profs.values()):  # a profile reads on the card only
      b_ms, b_k = profs[model]["step_ms"], profs[model]["kernels_per_step"]
      print("[adapters] TPOT at B=1: " + ", ".join(
        f"{mid} {p['step_ms']:.3f} ms ({p['step_ms'] - b_ms:+.3f} ms, "
        f"{p['kernels_per_step'] - b_k:+.0f} device kernels a step)" for mid, p in profs.items())
        + f" ({card})", flush=True)
    for st in engine.context_stats():
      print(f"[adapters] context {st['model_id']}: {st['graphs']} captured graphs, graph pool "
            f"{st['graph_pool_bytes']} bytes, slab {st['slab_bytes']} bytes ({card})", flush=True)
    # The swap: ad1's context takes ad2's file.
    ad1, ad2 = models[1], models[2]
    t0 = time.perf_counter()
    await engine.load_checkpoint(shards[ad1], paths["ad2"])
    swap_s = time.perf_counter() - t0
    swapped = await kv_generate(engine, "swapped", ids, 32, shards[ad1])
    await streams_agree(torch, engine, shards[ad2], f"adapters {ad1} after load_checkpoint of "
                        f"ad2's file against {ad2}", ids, common[ad2], swapped, card)
    base_ctx = engine._contexts[shards[model]]
    shared, n_base, _ = shared_ptrs(base_ctx.params, engine._contexts[shards[ad1]].params)
    fresh = swapped != common[ad1] and shared == n_base
    print(f"[adapters] load_checkpoint in {swap_s:.3f} s: {ad1}'s stream is no longer its "
          f"old one, {shared}/{n_base} base tensors still shared ({card}) "
          f"{'ok' if fresh else 'FAIL (stale graphs or a copied base)'}", flush=True)
    if not fresh:
      raise AssertionError("adapters: the swapped context streamed its old adapter's tokens")
    out = os.path.join(os.path.dirname(paths["ad2"]), "saved.safetensors")
    await engine.save_checkpoint(shards[ad1], out)
    a, b = _SafetensorsFile(out), _SafetensorsFile(paths["ad2"])
    same = sorted(a.header) == sorted(b.header) and all(
      torch.equal(a.get(n), b.get(n)) for n in b.header)
    print(f"[adapters] save_checkpoint: {len(a.header)} tensors, equal to ad2's file "
          f"{'ok' if same else 'FAIL'}", flush=True)
    if not same:
      raise AssertionError("adapters: save_checkpoint did not write back the loaded tensors")

  with phase_env(XOT_ADAPTERS=adapters, **ADAPTER_ENV):
    run = drive_main_path(torch, card, device=device, model=model, tag="adapters", profiles=(),
                          cli=("--adapters", adapters), requests=requests, before=before,
                          after=after)
  counts, want = run["launches"], contiguous_want(run, layers)
  ok = counts == want and run["steps"] >= run["decoded"]
  print(f"[adapters] launches {counts} against {want} (prompt tokens {run['prompt_tokens']}, "
        f"{run['steps']} decode steps over three contexts); {'; '.join(run['timings'])} ({card}) "
        f"{'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"adapters: launches {counts}, wanted {want}")
  return dict(counts)


def adapters_concurrent(torch, card: str, paths: dict, device: str = "cuda",
                        model: str = "synthetic-llama-1b", n: int = 24) -> dict:
  """Phase 20 (b): a fresh engine on the page pool (XOT_PAGED_KV=1, page 128) with the
  adapters registered: four prompts, each streamed greedy alone on the base and on an
  adapter (ad1 for two, ad2 for two), then all eight at once (three contexts, each its
  own batcher and pool). Each concurrent stream equals its solo one under the near-tie
  rule; every context's pages go back to 0. Returns the paged kernels' launches."""
  import numpy as np
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  from xotorch_tpu_torch.models import graphs
  from xotorch_tpu_torch.models.registry import get_model_card
  vocab = get_model_card(model)["synthetic_config"]["vocab_size"]
  adapters = ",".join(f"{k}={v}" for k, v in paths.items())
  rng = np.random.default_rng(23)
  prompts = [[int(t) for t in rng.integers(3, vocab, size=k)] for k in (64, 200, 300, 514)]
  names = list(paths)
  jobs = [(f"b{i}", model, p) for i, p in enumerate(prompts)]
  jobs += [(f"a{i}", f"{model}@{names[i % 2]}", p) for i, p in enumerate(prompts)]
  counted = [fn for fn in graphs.counted_wrappers() if fn.__name__ in KV_KERNELS]
  # The registry reads XOT_ADAPTERS whenever a context loads: the knobs stay set throughout.
  with phase_env(XOT_ADAPTERS=adapters, XOT_PAGED_KV="1", XOT_KV_PAGE="128", **ADAPTER_ENV):
    return _adapters_concurrent(torch, card, TorchShardInferenceEngine(device=device, seed=0),
                                jobs, counted, model, n)


def _adapters_concurrent(torch, card: str, engine, jobs: list, counted: list, model: str,
                         n: int) -> dict:
  from xotorch_tpu_torch.models.registry import TORCH, build_full_shard
  try:
    async def drive():
      shards = {mid: build_full_shard(mid, TORCH) for mid in {j[1] for j in jobs}}
      solo = {rid: await kv_generate(engine, rid + "-solo", p, n, shards[mid]) for rid, mid, p in jobs}
      before = {fn.__name__: fn.launches for fn in counted}
      t0 = time.perf_counter()
      together = await asyncio.gather(*(kv_generate(engine, rid, p, n, shards[mid])
                                        for rid, mid, p in jobs))
      secs = time.perf_counter() - t0
      launched = {fn.__name__: fn.launches - before[fn.__name__] for fn in counted}
      same = 0
      for (rid, mid, p), got in zip(jobs, together):
        same += await streams_agree(torch, engine, shards[mid], f"adapters paged {rid} ({mid})", p,
                                    solo[rid], got, card) == 1.0
      await engine._run(lambda: None)
      pools = {mid: engine._contexts[s].page_pool for mid, s in shards.items()}
      used = {mid: (p.pages_in_use if p is not None else None) for mid, p in pools.items()}
      widths = {mid: (engine._contexts[s].batcher.rows, engine._contexts[s].batcher.dispatches)
                for mid, s in shards.items() if engine._contexts[s].batcher is not None}
      ok = all(u == 0 for u in used.values()) and len(pools) == 3
      print(f"[adapters paged] 4 base + 4 adapter streams of {n} tokens at once in {secs:.2f} s: "
            f"{same}/8 identical to their solo streams (the rest parted at near ties), pages in "
            f"use after {used}, (rows, dispatches) per context {widths}, launches {launched} "
            f"({card}) {'ok' if ok else 'FAIL'}", flush=True)
      if not ok:
        raise AssertionError(f"adapters paged: pages left {used}")
      return launched
    return asyncio.run(drive())
  finally:
    engine.executor.shutdown(wait=True)


def check_adapters(torch, card: str, device: str = "cuda", model: str = "synthetic-llama-1b",
                   streams: Optional[dict] = None) -> dict:
  """Phase 20: multi-LoRA serving. (a) The two-layer cut with a rank-16 adapter on all
  seven slots in bf16 (K1, K2), then over int4 (K5) and int8 (K6) bases, each kernel
  call held against its plain version, each with a B-dropped control that must miss;
  (b) main.py --adapters at full width and depth (drive_adapters), the eight concurrent
  paged streams (adapters_concurrent), and an int4 server whose @ad1 requests launch
  K5 7 x 16 x steps. Returns the phase's launches; `streams` takes (b)'s greedy streams
  of its common prompt by model id, and the prompt's ids under "ids"."""
  import shutil
  import tempfile
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.ops.int4_matmul import int4_w4a16_matmul
  from xotorch_tpu_torch.ops.int8_matmul import int8_rowquant_matmul
  t0 = time.perf_counter()
  with phase_env(**ADAPTER_ENV):
    check_model(torch, adapter_rank=16, device=device, model=model)
    check_model(torch, "int4", {"XOT_INT4_KERNEL": "force"}, int4_w4a16_matmul, adapter_rank=16,
                device=device, model=model)
    check_model(torch, "int8", {"XOT_INT8_KERNEL": "force"}, int8_rowquant_matmul, limit=1e-1,
                adapter_rank=16, device=device, model=model)
  root = tempfile.mkdtemp(prefix="xot-adapters-")
  launches: dict = {}
  try:
    paths = write_adapters(torch, root, model)
    sizes = {k: os.path.getsize(v) for k, v in paths.items()}
    print(f"[adapters] adapter files written by save_lora_checkpoint: {sizes} bytes", flush=True)
    for name, k in drive_adapters(torch, card, paths, device=device, model=model,
                                  streams=streams).items():
      launches[name] = launches.get(name, 0) + k
    for name, k in adapters_concurrent(torch, card, paths, device=device, model=model).items():
      launches[name] = launches.get(name, 0) + k
    ad1 = f"{model}@ad1"
    body = [(f"int4 server -> {ad1}", {**main_requests(model)[0][1], "model": ad1})]
    adapters = ",".join(f"{k}={v}" for k, v in paths.items())
    with phase_env(XOT_ADAPTERS=adapters, **ADAPTER_ENV):
      run = drive_main_path(torch, card, device=device, model=model, kernels=(int4_w4a16_matmul,),
                            env={"XOT_QUANTIZE": "int4"}, tag="adapters int4", profiles=(),
                            cli=("--adapters", adapters), requests=body)
    layers = get_model_card(model)["layers"]
    got, want = run["launches"]["int4_w4a16_matmul"], 7 * layers * run["steps"]
    ok = got == want and run["steps"] >= run["decoded"]
    print(f"[adapters int4] {ad1} over an int4 base: int4_w4a16_matmul launches {got} = 7 x {layers} "
          f"x {run['steps']} decode steps ({want}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"adapters int4: K5 launches {got}, wanted {want}")
    launches["int4_w4a16_matmul"] = launches.get("int4_w4a16_matmul", 0) + got
  finally:
    shutil.rmtree(root, ignore_errors=True)
  print(f"[adapters] phase 20 in {time.perf_counter() - t0:.1f} s ({card})", flush=True)
  return launches


# ------------------------------------------------------------------ phase 21: training

BWD_REL = 2.0 ** -6  # K1b: each of dq, dk and dv within this share of its largest |value|
TRAIN_GRAD_REL = 5e-2  # the two-layer cut: each gradient's error over its norm
TRAIN_LOSS_REL = 2.0 ** -7  # a loss against its fp32 reference, and a resumed step's
# XOT_SEED fixes the fresh adapters' draw (else the clock seeds it, and with it each
# run's trajectory).
TRAIN_ENV = {"XOT_PREFIX_CACHE": "0", "XOT_PREFILL_COSCHED": "0", "XOT_SAVE_OPT_STATE": "1",
             "XOT_SEED": "0"}
# Learning rates of the main-path runs: bf16 weights near 0.02 take steps of 2^-13
# (1.2e-4), so an update of 1e-5 rounds away. LoRA at 1e-2 moved B by 1e-2 a step and
# diverged by step 7 in one of two runs on the H100 (PERF.md): 3e-3.
TRAIN_LR = {"full": "1e-3", "lora": "3e-3", "qlora": "3e-3"}
TRAIN_ITERS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 512
TRAIN_WORDS = 2000  # the corpus's vocabulary: "w<id>" words, Zipf-distributed
TRAIN_LINE_WORDS = TRAIN_SEQ  # words a line: every row is TRAIN_SEQ - 1 inputs


def k1b_widths():
  """(widths, B, T, window, softcap, timed) of the K1b cases: synthetic-llama-1b's at
  the main path's batch (B 4, T 511) and at T 512 and 300, softcapped and windowed with
  queries scaled into the softcap (strict: its controls must miss), D 128, D 32 with
  groups 1, D 16 with groups 8, and gemma-2-2b's (GEMMA_2B: D 256, scale 1/16, queries
  x 8, strict) at the main path's batch with its softcap, and windowed."""
  soft = Widths(HQ, HKV, D, "llama-1b softcapped, queries x 8 ", q_mul=8.0, strict=True)
  return [(LLAMA_1B, TRAIN_BATCH, TRAIN_SEQ - 1, 0, 0.0, True),
          (LLAMA_1B, TRAIN_BATCH, 512, 0, 0.0, True),
          (LLAMA_1B, 2, 300, 0, 0.0, False),
          (soft, 2, 512, 256, 50.0, True),
          (Widths(32, 8, 128, "D=128 "), 2, 512, 0, 0.0, True),
          (Widths(8, 8, 32, "D=32 groups 1 "), 2, 300, 0, 0.0, False),
          (Widths(16, 2, 16, "D=16 groups 8 "), 2, 200, 64, 0.0, False),
          (GEMMA_2B, TRAIN_BATCH, TRAIN_SEQ - 1, 0, GEMMA_SOFTCAP, True),
          (GEMMA_2B, 2, 512, 256, GEMMA_SOFTCAP, False)]


def sdpa_bwd_ms(torch, q, k, v, dout, scale=None) -> float:
  """The library time of a causal case without a window or a softcap: the backward of
  one scaled_dot_product_attention call (a yardstick the port never calls), over K/V
  repeated to every query head (outside the timed window), from its saved forward."""
  import torch.nn.functional as F
  groups = q.shape[2] // k.shape[2]
  qt = q.transpose(1, 2).detach().requires_grad_(True)
  kt, vt = (x.repeat_interleave(groups, dim=2).transpose(1, 2).detach().requires_grad_(True)
            for x in (k, v))
  with torch.enable_grad():
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale)
  g = dout.transpose(1, 2)
  return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), g, retain_graph=True))


def flex_bwd_ms(torch, q, k, v, dout, window, softcap, scale=None) -> float:
  """The library time of a softcapped or windowed K1b case: the backward of one
  torch.compile'd flex_attention call (a yardstick the port never calls), with flex_ms's
  softcap score_mod and the causal window as its block mask, GQA, from its saved forward."""
  from torch.nn.attention.flex_attention import create_block_mask, flex_attention
  B, T = q.shape[0], q.shape[1]
  win = window or (1 << 30)

  def score_mod(score, b, h, qi, ki):
    return torch.tanh(score / softcap) * softcap

  def mask_mod(b, h, qi, ki):
    return (ki <= qi) & (ki > qi - win)

  mask = create_block_mask(mask_mod, B, None, T, T, device="cuda")
  torch._dynamo.reset()
  fn = torch.compile(flex_attention, dynamic=False)
  qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
  g = dout.transpose(1, 2).contiguous()
  with torch.enable_grad():
    out = fn(qt, kt, vt, score_mod=score_mod if softcap else None, block_mask=mask,
             scale=scale, enable_gqa=True)
  return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), g, retain_graph=True))


def kernel_split_ms(torch, call, names, iters: int = 10) -> Optional[dict]:
  """Device ms a call of each kernel named in `names`, from torch.profiler over `iters`
  calls in a row (warm L2: the split, not the total, is what this reads); None when the
  trace holds no device time for them (seen after the earlier phases' profiles in one
  process: phase 21 alone, scripts/training_probe.py, reads it)."""
  from torch.profiler import ProfilerActivity, profile
  call()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(iters):
      call()
    torch.cuda.synchronize()
  out = {n: 0.0 for n in names}
  for evt in prof.key_averages():
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
      us = getattr(evt, "self_cuda_time_total", 0)
    for n in names:
      if n in evt.key:
        out[n] += us / 1e3 / iters
  return out if any(out.values()) else None


LSE_REL = 2.0 ** -12  # K1's log-sum-exp: fp32 sums of ex2.approx terms, against fp32 torch


def k1b_case(torch, w, draw, B, T, window, softcap, timed=True) -> Optional[dict]:
  """K1b (flash_attention_bwd): the gradient of K1's output, given that output (bf16, as
  the training forward saves it), the log-sum-exp K1 wrote with it and a seeded dO,
  against autograd of flash_attention_ref in fp32 on the card on the same inputs: dq, dk
  and dv each within BWD_REL of its largest |value|, and a second call the same bits.
  K1's log-sum-exp is held within LSE_REL of max(1, its largest |value|) of
  flash_attention_lse_ref, and K1's output with it requested equals its output without,
  bit for bit. A strict case's controls (the kernel run with its softcap or window
  dropped) must each miss that limit. A timed case adds K1b's time, the fp32 plain
  version's, the library's (SDPA's backward without a window or a softcap, else a
  compiled flex_attention's backward), each device kernel's share under the profiler,
  and the bound: the gradient's five products (S, dP, dV, dK, dQ; K1b computes S and dP
  once in each of its kernels, seven in all) of 2 x D a visible (query head, key) pair on
  the bf16 peak, against q, k, v, o, dO and lse read and dq, dk and dv written once."""
  from xotorch_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_lse_ref)
  q = w.queries(draw(B, T, w.hq, w.d))
  k, v, dout = draw(B, T, w.hkv, w.d), draw(B, T, w.hkv, w.d), draw(B, T, w.hq, w.d)
  kw = dict(window=window, softcap=softcap, scale=w.scale)
  out, lse = flash_attention(q, k, v, lse=True, **kw)
  case = f"{w.tag}B={B} T={T} window={window} softcap={softcap}"
  same_out = torch.equal(out, flash_attention(q, k, v, **kw))
  lse_ref = flash_attention_lse_ref(q.float(), k.float(), **kw)
  lse_err = (lse - lse_ref).abs().max().item()
  lse_limit = LSE_REL * max(1.0, lse_ref.abs().max().item())
  ok = same_out and math.isfinite(lse_err) and lse_err <= lse_limit
  print(f"[flash_attention] {case}: log-sum-exp max_abs_err {lse_err:.3e} (limit {lse_limit:.3e}); "
        f"output with it the same bits as without: {same_out} {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"flash_attention {case}: the log-sum-exp output disagrees with its "
                         f"plain version, or requesting it changed the output")
  call = lambda **o: flash_attention_bwd(q, k, v, out, dout, lse, **{**kw, **o})
  got = call()
  again = call()
  torch.cuda.synchronize()
  same = all(torch.equal(a, b) for a, b in zip(got, again))
  print(f"[flash_attention_bwd] {case}: two calls on the same inputs give the same bits: {same}",
        flush=True)
  if not same:
    raise AssertionError(f"flash_attention_bwd {case}: two calls differ")
  plain = lambda: flash_attention_bwd_ref(q.float(), k.float(), v.float(), dout.float(), **kw)
  ref = plain()
  limits = [BWD_REL * r.abs().max().item() for r in ref]

  def errors(grads):
    return [(g.float() - r).abs().max().item() for g, r in zip(grads, ref)]
  errs = errors(got)
  ok = all(math.isfinite(e) and e <= l for e, l in zip(errs, limits))
  print(f"[flash_attention_bwd] {case}: max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
        f"{errs[2]:.3e} (limits {limits[0]:.3e} {limits[1]:.3e} {limits[2]:.3e}: 2^-6 of each "
        f"largest |value|) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"flash_attention_bwd {case}: K1b disagrees with its plain version")
  if w.strict:
    for label, over in w.controls(window, softcap):
      missed = any(e > l for e, l in zip(errors(call(**over)), limits))
      print(f"[flash_attention_bwd] {case}: control, {label} dropped: "
            f"{'misses the limits, as it must' if missed else 'FAIL: within them'}", flush=True)
      if not missed:
        raise AssertionError(f"flash_attention_bwd {case}: K1b with its {label} dropped passes")
  if not timed:
    return None
  ms = time_ms(call)
  plain_ms = time_ms(plain, iters=3)
  if window or softcap:
    lib = flex_bwd_ms(torch, q, k, v, dout, window, softcap, w.scale) if YARDSTICKS else None
    lib_name = "flex_attention backward" + ("" if YARDSTICKS else ", timed with --yardsticks")
  else:
    lib, lib_name = sdpa_bwd_ms(torch, q, k, v, dout, w.scale), "SDPA backward"
  split = kernel_split_ms(torch, call, ("flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel"))
  seen = sum(min(t + 1, window) if window else t + 1 for t in range(T))
  b_ms, b_by = bound(10.0 * B * w.hq * w.d * seen,
                     2.0 * (4 * q.numel() + 4 * k.numel()) + 4.0 * lse.numel())
  if split is None:
    shares = "the kernels' split not measured (no device time in the profiler's trace)"
  else:
    dq_ms, dkdv_ms = split["flash_bwd_dq_kernel"], split["flash_bwd_dkdv_kernel"]
    shares = (f"profiler, warm: dQ kernel {dq_ms:.4f} ms ({100 * dq_ms / (dq_ms + dkdv_ms):.1f} %), "
              f"dK/dV kernel {dkdv_ms:.4f} ms")
  print(f"[flash_attention_bwd] {case}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
        f"{'null' if lib is None else f'{lib:.4f}'} ({lib_name}) bound_ms={b_ms:.4f} ({b_by}); "
        f"{shares}", flush=True)
  return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "library_ms": lib,
          "bound_ms": b_ms, "bound_by": b_by}


def check_training_kernels(torch, results: dict) -> None:
  """Phase 21 (a): K1b against its plain version at every k1b_widths case, each wrapper
  (K1b's, and the autograd Function whose forward is K1 and backward K1b) once under
  torch.cuda.set_sync_debug_mode("error"); the main path's case (B 4, T 511) goes to
  the results line."""
  from xotorch_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_train)
  t0 = time.perf_counter()
  print_registers()
  draw = seeded_randn(torch, 21)
  for i, (w, B, T, window, softcap, timed) in enumerate(k1b_widths()):
    r = k1b_case(torch, w, draw, B, T, window, softcap, timed)
    if i == 0:
      results["flash_attention_bwd"] = r
  q = draw(2, 300, HQ, D).requires_grad_(True)
  k, v = draw(2, 300, HKV, D).requires_grad_(True), draw(2, 300, HKV, D).requires_grad_(True)
  out, lse = flash_attention(q.detach(), k.detach(), v.detach(), lse=True)
  dout = draw(2, 300, HQ, D)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    flash_attention_bwd(q.detach(), k.detach(), v.detach(), out, dout, lse)
    flash_attention_train(q, k, v, window=128).backward(dout)
  finally:
    torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()
  print(f"[flash_attention_bwd] flash_attention_bwd and flash_attention_train's backward ran "
        f"under set_sync_debug_mode('error'): no host sync ok", flush=True)
  print(f"[time] phase 21 (a), K1b: {time.perf_counter() - t0:.1f} s", flush=True)


def _window_forced(window: int):
  """A control for a model without windows: the training forward's attention with
  `window` forced on every layer."""
  from xotorch_tpu_torch.models import transformer
  real = transformer.flash_attention_train

  @contextlib.contextmanager
  def forced():
    transformer.flash_attention_train = lambda q, k, v, **kw: real(q, k, v, **{**kw, "window": window})
    try:
      yield
    finally:
      transformer.flash_attention_train = real
  return forced()


def check_training_cut(torch, mode: str, device: str = "cuda", model: str = "synthetic-llama-1b",
                       limit: float = TRAIN_GRAD_REL, hf_config: Optional[dict] = None,
                       seq: int = 200, window: int = 64, slots=None) -> dict:
  """Phase 21 (b): a two-layer cut of `model` at full width (its registry card's
  synthetic config, or `hf_config`: gemma-2-2b's published one, whose two first layers
  are one windowed and one global; phase 19 (d) gives Qwen3-30B-A3B's and LLaVA-1.5-7B's),
  B 2, T `seq` (rows of seq and 3/4 of it), the loss and every trainable leaf's gradient
  (`mode` full: every float leaf, the tied embedding included; lora: a seeded rank-8
  adapter on `slots`, the seven by default, B nonzero; qlora: that adapter over an int8
  base) on the card in bf16 through K1 and K1b against the plain path in fp32 (attention
  by flash_attention_ref, TF32 off) on the card from the same weights: the loss within TRAIN_LOSS_REL, each gradient's error
  within `limit` of its norm. The control must miss: a window of `window` forced on both
  layers (full), every adapter's B zeroed (lora, qlora). Returns the card's K1 and K1b
  launches (2 each)."""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.models import transformer
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.quantize import quantize_params
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
  from xotorch_tpu_torch.train import lora, step

  cfg = dataclasses.replace(config_from_hf_dict(hf_config or get_model_card(model)["synthetic_config"]),
                            num_layers=2)
  dev = torch.device(device)
  dtype = torch.bfloat16 if device == "cuda" else torch.float32
  params = transformer.init_random_params(cfg, 2, True, True, seed=0, dtype=dtype, device=dev)
  if mode == "qlora":
    params = quantize_params(params, "int8", scale_dtype=dtype, inplace=True)
  if mode != "full":
    params["layers"].update(adapter_leaves(torch, cfg, 2, 8, slots or transformer.LORA_SLOTS,
                                           seed=21, device=dev, dtype=dtype))
  # The fp32 plain path's weights: on the card itself (TF32 off, main() sets it), where a
  # CPU reference took tens of seconds a cut.
  params_ref = fp32_copy(torch, params, dev)
  rng = np.random.default_rng(21)
  x = rng.integers(3, cfg.vocab_size, size=(2, seq + 1))
  batch = {"inputs": x[:, :-1], "targets": x[:, 1:], "lengths": np.array([seq, 3 * seq // 4])}

  def grads(p, on):
    b = {k: torch.as_tensor(v, device=on) for k, v in batch.items()}
    leaves = [t for _, t in lora.trainable_leaves(p)]
    loss, g = step.value_and_grad(lambda: step.full_model_loss(p, b, cfg), leaves)
    return loss.float().cpu(), [t.float().cpu() for t in g]

  counts = (flash_attention.launches, flash_attention_bwd.launches)
  with routing_recorded(torch) as routes:
    loss, got = grads(params, dev)
  launched = {"flash_attention": flash_attention.launches - counts[0],
              "flash_attention_bwd": flash_attention_bwd.launches - counts[1]}
  # A MoE cut's fp32 reference routes as the card routed (forced_routing): a bf16 router
  # may pick another expert at a near tie, and a gradient is only comparable over the
  # same experts. The choices' weights stay each side's own (the router's gradient).
  with forced_routing(torch, list(routes)) if routes else contextlib.nullcontext():
    with plain_attention():
      want_loss, want = grads(params_ref, dev)
  names = ["/".join(path) for path, _ in lora.trainable_leaves(params)]
  if mode == "full":
    with _window_forced(window):
      control = grads(params, dev)
    dropped = f"a window of {window} forced"
  else:
    control = grads(_drop_b(torch, params), dev)
    dropped = "every adapter's B zeroed"

  def worst(g):
    if not all(bool(torch.isfinite(t).all()) for t in g):
      raise AssertionError(f"training cut ({mode}): non-finite gradients")
    return max((((a - b).norm() / b.norm().clamp(min=1e-30)).item(), n)
               for a, b, n in zip(g, want, names))

  loss_err = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
  (err, leaf), (control_err, _) = worst(got), worst(control[1])
  ok = (loss_err <= TRAIN_LOSS_REL and err <= limit and control_err > limit
        and (device != "cuda" or launched == {"flash_attention": 2, "flash_attention_bwd": 2}))
  print(f"[training] 2-layer {model} cut, {mode} ({len(got)} trainable leaves), B=2 T={seq}: loss "
        f"{loss.item():.5f} against {want_loss.item():.5f} in fp32, plain ({loss_err:.2e}, "
        f"limit 2^-7); worst gradient error {err:.3e} of its norm ({leaf}; limit {limit:g}"
        f"{'; the reference routed as the card' if routes else ''}); control, "
        f"{dropped}: {control_err:.3e} ({'caught' if control_err > limit else 'NOT caught'}); "
        f"launches {launched} {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"training cut ({mode}): the card's loss or gradients disagree with the "
                         f"CPU's, the control passed, or the kernels launched {launched}")
  return launched


@contextlib.contextmanager
def word_ids():
  """The DummyTokenizer of synthetic cards with "w<n>" words as token n (any other word
  1) and ids decoded as words, for the phase's corpus and requests; restored after."""
  from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer
  saved = DummyTokenizer.encode, DummyTokenizer.decode
  DummyTokenizer.encode = lambda self, text: [int(w[1:]) if w[:1] == "w" and w[1:].isdigit() else 1
                                              for w in text.split()]
  DummyTokenizer.decode = lambda self, tokens: "".join(f" w{int(t)}" for t in tokens)
  try:
    yield
  finally:
    DummyTokenizer.encode, DummyTokenizer.decode = saved


def write_training_corpus(root: str, words: int = TRAIN_WORDS, lines: int = 40,
                          test_lines: int = 8, prefix: str = "w", first: int = 3) -> str:
  """train.jsonl, valid.jsonl and test.jsonl of seeded "w<id>" lines (TRAIN_LINE_WORDS
  words each, ids first.. drawn from a Zipf law over `words` of them; `prefix` "t" for
  a checkpoint's word tokenizer, which names ids from 105 as t<id>): what a model can
  learn in a few steps is the words' frequencies."""
  import numpy as np
  rng = np.random.default_rng(21)
  ids = rng.permutation(np.arange(first, first + words))
  p = 1.0 / np.arange(1, words + 1)
  p /= p.sum()
  for name, n in (("train", lines), ("valid", test_lines), ("test", test_lines)):
    with open(os.path.join(root, f"{name}.jsonl"), "w") as f:
      for _ in range(n):
        words = rng.choice(ids, size=TRAIN_LINE_WORDS, p=p)
        f.write(json.dumps({"text": " ".join(f"{prefix}{i}" for i in words)}) + "\n")
  return root


def _train_args(model: str, device: str, data: str, *extra) -> list:
  return ["train", model, "--device", device, "--data", data, "--batch-size", str(TRAIN_BATCH),
          "--sequence-length", str(TRAIN_SEQ), "--chatgpt-api-host", "127.0.0.1",
          "--chatgpt-api-port", "0", "--default-temp", "0", *extra]


async def _stream_ids(api, model: str, prompt: str, n: int = 16) -> list:
  """A temperature-0 streamed completion from `api` (started here, stopped after)."""
  server = await api.start("127.0.0.1", 0)
  try:
    url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}/v1/chat/completions"
    body = {"model": model, "temperature": 0, "max_tokens": n, "stream": True,
            "messages": [{"role": "user", "content": prompt}]}
    events, _, _ = await asyncio.to_thread(http_stream, url, body)
    return stream_ids(events)
  finally:
    server.close()
    await server.wait_closed()


def train_cli(torch, argv: list, env: dict, body=None):
  """main.py's train command in this process (build_parser, build_node, train_model_cli,
  as `python -m xotorch_tpu_torch.main train` runs them, without the node's discovery
  and server: one peer) under `env`: each step's loss, wall seconds (ending in the
  loss's readback) and tokens, K1's and K1b's launches in the train loop, the card's
  peak memory. `body(node, engine, classname, api, run)` may run before and after."""
  import numpy as np
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
  with phase_env(**{**TRAIN_ENV, "XOT_LORA_RANK": "0", **env}):
    args = port_main.build_parser().parse_args(argv)
    node, engine, classname, api = port_main.build_node(args)
    steps = []
    enqueue = node.enqueue_example

    async def timed(shard, inputs, targets, lengths, train=False):
      t0 = time.perf_counter()
      out = await enqueue(shard, inputs, targets, lengths, train=train)
      steps.append((time.perf_counter() - t0, int(np.asarray(lengths).sum())))
      return out
    node.enqueue_example = timed

    async def run_train():
      counts = (flash_attention.launches, flash_attention_bwd.launches)
      held = 0
      if engine.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the weights, and what a body holds
      losses = await port_main.train_model_cli(node, classname, args.model_name, args)
      peak = torch.cuda.max_memory_allocated() if engine.device.type == "cuda" else 0
      return {"losses": losses, "steps": list(steps), "peak": peak, "held": held,
              "launches": {"flash_attention": flash_attention.launches - counts[0],
                           "flash_attention_bwd": flash_attention_bwd.launches - counts[1]}}

    async def drive():
      try:
        if body is None:
          return await run_train()
        return await body(node, engine, classname, api, args, run_train)
      finally:
        await node.stop()

    try:
      return asyncio.run(drive())
    finally:
      engine.executor.shutdown(wait=True)
      del node, engine, api
      gc.collect()
      if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _report_run(tag: str, run: dict, card: str, layers: int, train_steps: int,
                falling: bool = True) -> dict:
  """Print a train run's losses, step times, tokens/s and peak memory; hold K1 and K1b
  to layers x steps and, with `falling`, the last loss under the first. Returns its
  launches."""
  losses = [l for _, l in run["losses"]]
  secs = [s for s, _ in run["steps"]]
  later = run["steps"][1:] or run["steps"]  # the first step also allocates the moments
  tok_s = sum(t for _, t in later) / max(sum(s for s, _ in later), 1e-9)
  want = {"flash_attention": layers * train_steps, "flash_attention_bwd": layers * train_steps}
  falls = len(losses) >= 2 and losses[-1] < losses[0]
  ok = run["launches"] == want and len(losses) == train_steps and (falls or not falling)
  run.update(tok_s=tok_s, median_ms=1e3 * sorted(secs)[len(secs) // 2] if secs else 0.0)
  print(f"[training] {tag}: losses {' '.join(f'{l:.4f}' for l in losses)} "
        f"({'falling' if falls else 'not falling'}{'' if falling else ', not asserted'}); step ms {' '.join(f'{1e3 * s:.1f}' for s in secs)} "
        f"(median {run['median_ms']:.1f}); {tok_s:.0f} tokens/s after the first step; peak memory "
        f"{run['peak'] / 2**30:.2f} GiB, {(run['peak'] - run['held']) / 2**30:.2f} over the "
        f"{run['held'] / 2**30:.2f} held before the first step; launches {run['launches']} (want {want}) "
        f"{'ok' if ok else 'FAIL'} ({card})", flush=True)
  if not ok:
    raise AssertionError(f"training {tag}: launches {run['launches']} (want {want}), "
                         f"{len(losses)} steps, losses {losses}")
  return run["launches"]


def drive_training(torch, card: str, device: str = "cuda", model: str = "synthetic-llama-1b") -> dict:
  """Phase 21 (c): main.py's train and eval commands on `model` at full width and depth,
  bf16, over write_training_corpus's corpus (B 4, rows of 511 inputs, 8 steps):
  - full fine-tune (XOT_LR 1e-3), then eval on the trained model: the loss falls, K1 =
    layers x (steps + eval batches) and K1b = layers x steps exactly;
  - LoRA rank 8 (3e-3) with --save-every 4: a server on the node streams a prompt at
    temperature 0 before training (its decode graphs captured) and after; every base
    tensor bit for bit as loaded; a fresh server that resumes the step-8 save streams
    what the trained engine streams (its graphs read the weights trained in place);
  - --resume-checkpoint from the step-4 save: steps 5-8 give the uninterrupted run's
    losses within 2^-7 (the moments came back);
  - QLoRA over int8 (--quantize int8 --lora-rank 8): the loss falls, the int8 base
    bit for bit.
  Step ms, tokens/s and peak memory each. Returns the K1 and K1b launches."""
  import shutil
  import tempfile
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.models.registry import build_base_shard, build_full_shard, get_model_card
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.train.step import leaf_paths
  card_cfg = get_model_card(model)
  layers = card_cfg["layers"]
  words = min(TRAIN_WORDS, card_cfg["synthetic_config"]["vocab_size"] - 3)
  root = tempfile.mkdtemp(prefix="xot-train-")
  launches = {"flash_attention": 0, "flash_attention_bwd": 0}
  prompt = " ".join(f"w{3 + i % min(500, words)}" for i in range(300))
  out = {}

  def add(d):
    for k, v in d.items():
      launches[k] += v

  try:
    os.makedirs(os.path.join(root, "data"))
    data = write_training_corpus(os.path.join(root, "data"), words)
    ckpt = os.path.join(root, "ckpt")
    args = lambda *extra: _train_args(model, device, data, "--iters", str(TRAIN_ITERS), *extra)
    t0 = time.perf_counter()

    async def full_body(node, engine, classname, api, a, run_train):
      run = await run_train()
      before = flash_attention.launches
      run["eval"] = await port_main.eval_model_cli(node, classname, model, a)
      run["eval_launches"] = flash_attention.launches - before
      return run

    with word_ids():
      run = train_cli(torch, args("--save-every", "0"), {"XOT_LR": TRAIN_LR["full"]}, full_body)
      add(_report_run(f"{model} full fine-tune", run, card, layers, TRAIN_ITERS))
      n_eval = (8 // TRAIN_BATCH)
      ok = run["eval_launches"] == layers * n_eval and math.isfinite(run["eval"] or math.nan)
      print(f"[training] {model} eval after the full fine-tune: loss {run['eval']:.4f} over "
            f"{n_eval} batches; K1 {run['eval_launches']} = {layers} x {n_eval} "
            f"{'ok' if ok else 'FAIL'}", flush=True)
      if not ok:
        raise AssertionError(f"training eval: loss {run['eval']}, K1 {run['eval_launches']}")
      launches["flash_attention"] += run["eval_launches"]
      out["full"] = run

      async def lora_body(node, engine, classname, api, a, run_train):
        shard = build_full_shard(model, classname)
        before = await _stream_ids(api, model, prompt)
        params = engine._contexts[shard].params
        frozen = {path: t.clone() for path, t in leaf_paths(params) if not path[-1].startswith("lora_")}
        run = await run_train()
        run["base_same"] = all(torch.equal(t, frozen[path]) for path, t in leaf_paths(params)
                               if path in frozen)
        run["before"], run["after"] = before, await _stream_ids(api, model, prompt)
        return run

      lora = train_cli(torch, args("--lora-rank", "8", "--save-every", "4", "--save-checkpoint-dir",
                                   ckpt), {"XOT_LR": TRAIN_LR["lora"]}, lora_body)
      add(_report_run(f"{model} LoRA rank 8", lora, card, layers, TRAIN_ITERS))
      out["lora"] = lora
      saved = sorted(os.listdir(os.path.join(ckpt, model)))

      async def fresh_body(node, engine, classname, api, a, run_train):
        await node.coordinate_resume(build_base_shard(model, classname),
                                     os.path.join(ckpt, model, f"0-{layers - 1}-{TRAIN_ITERS}.safetensors"))
        return await _stream_ids(api, model, prompt)
      fresh = train_cli(torch, args("--lora-rank", "8"), {"XOT_LR": TRAIN_LR["lora"]}, fresh_body)
      ok = lora["base_same"] and fresh == lora["after"] and len(fresh) > 0
      print(f"[training] LoRA: saves {saved}; every base tensor bit for bit as loaded: "
            f"{lora['base_same']}; temperature-0 stream of the trained engine (decode graphs "
            f"captured before training) {lora['after']}, of a fresh server that resumed the "
            f"step-{TRAIN_ITERS} save {fresh}: {'equal' if fresh == lora['after'] else 'DIFFERENT'}; "
            f"before training {lora['before']} (not asserted) {'ok' if ok else 'FAIL'}", flush=True)
      if not ok:
        raise AssertionError("training LoRA: a base tensor moved, or the resumed server streams "
                             "other tokens than the trained engine")

      half = TRAIN_ITERS // 2
      resumed = train_cli(torch, args("--lora-rank", "8", "--save-every", "0", "--resume-checkpoint",
                                      os.path.join(ckpt, model, f"0-{layers - 1}-{half}.safetensors")),
                          {"XOT_LR": TRAIN_LR["lora"]})
      add(_report_run(f"{model} LoRA resumed at step {half}", resumed, card, layers, TRAIN_ITERS - half,
                      falling=False))
      got = [l for _, l in resumed["losses"]]
      want = [l for _, l in lora["losses"][half:]]
      rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
      ok = [it for it, _ in resumed["losses"]] == list(range(half + 1, TRAIN_ITERS + 1)) and rel <= TRAIN_LOSS_REL
      print(f"[training] resume from step {half}: steps {[it for it, _ in resumed['losses']]} losses "
            f"{' '.join(f'{l:.5f}' for l in got)} against the uninterrupted run's "
            f"{' '.join(f'{l:.5f}' for l in want)}: {rel:.2e} (limit 2^-7) {'ok' if ok else 'FAIL'}",
            flush=True)
      if not ok:
        raise AssertionError(f"training resume: losses {got} against {want}")

      async def qlora_body(node, engine, classname, api, a, run_train):
        await engine.ensure_shard(build_full_shard(model, classname))
        params = engine._contexts[build_full_shard(model, classname)].params
        frozen = {path: t.clone() for path, t in leaf_paths(params) if not path[-1].startswith("lora_")}
        run = await run_train()
        run["base_same"] = all(torch.equal(t, frozen[path]) for path, t in leaf_paths(params)
                               if path in frozen)
        run["int8"] = params["layers"]["wq"].dtype == torch.int8
        return run
      qlora = train_cli(torch, args("--lora-rank", "8", "--quantize", "int8", "--save-every", "0"),
                        {"XOT_LR": TRAIN_LR["qlora"]}, qlora_body)
      add(_report_run(f"{model} QLoRA rank 8 over int8", qlora, card, layers, TRAIN_ITERS))
      ok = qlora["base_same"] and qlora["int8"]
      print(f"[training] QLoRA: int8 base {qlora['int8']}, every base tensor (codes, scales, "
            f"norms) bit for bit as loaded: {qlora['base_same']} {'ok' if ok else 'FAIL'}", flush=True)
      if not ok:
        raise AssertionError("training QLoRA: the int8 base moved")
      out["qlora"] = qlora
    print(f"[time] phase 21 (c), main.py train and eval: {time.perf_counter() - t0:.1f} s", flush=True)
  finally:
    shutil.rmtree(root, ignore_errors=True)
  out["launches"] = launches
  return out


def drive_training_ring(torch, card: str, device: str = "cuda", model: str = "synthetic-llama-1b") -> dict:
  """Phase 21 (d): two Nodes in this process (main.build_node, manual discovery, the TCP
  transport on 127.0.0.1) hold `model` split 8/8 with rank-8 adapters; two training steps
  of the corpus's batches enter through enqueue_example at the peer WITHOUT layer 0
  (sent on to layer 0's owner, then down the ring and back: SendExample). Against one
  engine holding the whole model, from the same adapters (the single peer's initial
  draw copied into both halves) and batches: each step's loss within 2^-7, every
  updated adapter within 2^-7 of its largest |value|. K1 and K1b = layers x steps over
  both engines; SendExample frames and bytes a step. Returns the launches."""
  import tempfile
  import numpy as np
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.inference.tokenizers import DummyTokenizer
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  from xotorch_tpu_torch.models.registry import build_base_shard, build_full_shard, get_model_card
  from xotorch_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
  from xotorch_tpu_torch.topology.device_capabilities import device_capabilities_sync
  from xotorch_tpu_torch.train.dataset import iterate_batches, load_dataset
  from xotorch_tpu_torch.utils.helpers import find_available_port

  t0 = time.perf_counter()
  env = {**TRAIN_ENV, "XOT_LORA_RANK": "8", "XOT_LR": TRAIN_LR["lora"]}
  words = min(TRAIN_WORDS, get_model_card(model)["synthetic_config"]["vocab_size"] - 3)
  with phase_env(**env), word_ids(), tempfile.TemporaryDirectory() as tmp:
    data = write_training_corpus(tmp, words)
    batches = list(iterate_batches(load_dataset(data)[0], DummyTokenizer(), TRAIN_BATCH, TRAIN_SEQ))[:2]
    engine = TorchShardInferenceEngine(device=device, seed=0)
    classname = type(engine).__name__
    full = build_full_shard(model, classname)

    async def single():
      await engine.ensure_shard(full)
      layers = engine._contexts[full].params["layers"]
      init = {k: v.clone() for k, v in layers.items() if k.startswith("lora_")}
      losses = [(await engine.train_example(f"single{i}", full, *b))[0] for i, b in enumerate(batches)]
      return init, losses, {k: layers[k].float().cpu() for k in init}
    try:
      init, want_losses, want = asyncio.run(single())
    finally:
      engine.executor.shutdown(wait=True)
      del engine
      gc.collect()
      if device == "cuda":
        torch.cuda.empty_cache()

    path = os.path.join(tmp, "ring.json")
    ports = {i: find_available_port("127.0.0.1") for i in RING_IDS}
    write_ring_config(path, ports, device_capabilities_sync().to_dict())
    built = {i: port_main.build_node(port_main.build_parser().parse_args(
      ["--device", device, "--node-id", i, "--node-host", "127.0.0.1", "--node-port", str(ports[i]),
       "--discovery-module", "manual", "--discovery-config-path", path, "--lora-rank", "8"]))
      for i in RING_IDS}
    nodes = {i: b[0] for i, b in built.items()}
    engines = {i: b[1] for i, b in built.items()}

    async def ring():
      try:
        await asyncio.wait_for(asyncio.gather(*(n.start(wait_for_peers=1) for n in nodes.values())), 120)
        base = build_base_shard(model, classname)
        for i, node in nodes.items():
          shard = node.get_current_shard(base)
          await engines[i].ensure_shard(shard)
          layers = engines[i]._contexts[shard].params["layers"]
          with torch.no_grad():
            for k, v in init.items():
              layers[k].copy_(v[shard.start_layer:shard.end_layer + 1])
        origin = next(n for n in nodes.values() if n.get_current_shard(base).start_layer > 0)
        counts = (flash_attention.launches, flash_attention_bwd.launches)
        losses, secs = [], []
        for b in batches:
          t = time.perf_counter()
          losses.append((await origin.enqueue_example(base, *b, train=True))[0])
          secs.append(time.perf_counter() - t)
        launched = {"flash_attention": flash_attention.launches - counts[0],
                    "flash_attention_bwd": flash_attention_bwd.launches - counts[1]}
        wire = [0, 0, 0]
        for node in nodes.values():
          for peer in node.peers:
            for j, c in enumerate(getattr(peer, "wire", {}).get("SendExample", [0, 0, 0])):
              wire[j] += c
        errs = {}
        for i, node in nodes.items():
          shard = node.get_current_shard(base)
          layers = engines[i]._contexts[shard].params["layers"]
          for k, ref in want.items():
            ref = ref[shard.start_layer:shard.end_layer + 1]
            errs[f"{i}/{k}"] = ((layers[k].float().cpu() - ref).abs().max() / ref.abs().max()).item()
        return losses, secs, launched, wire, errs, {i: str(n.get_current_shard(base)) for i, n in nodes.items()}, origin.id
      finally:
        for node in nodes.values():
          await node.stop()

    try:
      losses, secs, launched, wire, errs, shards, origin = asyncio.run(ring())
    finally:
      for e in engines.values():
        e.executor.shutdown(wait=True)
  steps = len(batches)
  layers = int(build_base_shard(model, classname).n_layers)
  rel = max(abs(g - w) / abs(w) for g, w in zip(losses, want_losses))
  worst = max(errs.values())
  want_launches = {"flash_attention": layers * steps, "flash_attention_bwd": layers * steps}
  ok = rel <= TRAIN_LOSS_REL and worst <= TRAIN_LOSS_REL and launched == want_launches
  print(f"[training ring] {shards}, examples entering at {origin}: losses "
        f"{' '.join(f'{l:.5f}' for l in losses)} against one peer's {' '.join(f'{l:.5f}' for l in want_losses)} "
        f"({rel:.2e}, limit 2^-7); updated adapters' worst error {worst:.2e} of their largest "
        f"|value| (limit 2^-7); step ms {' '.join(f'{1e3 * s:.1f}' for s in secs)}; SendExample "
        f"{wire[0] / steps:.1f} frames, {wire[1] / steps / 1e6:.2f} MB out and {wire[2] / steps / 1e6:.2f} "
        f"MB back a step; launches {launched} (want {want_launches}) {'ok' if ok else 'FAIL'} ({card})",
        flush=True)
  if not ok:
    raise AssertionError(f"training ring: losses {losses} against {want_losses}, adapters {worst}, "
                         f"launches {launched}")
  print(f"[time] phase 21 (d), ring training: {time.perf_counter() - t0:.1f} s", flush=True)
  return launched


def check_training(torch, card: str, results: dict, device: str = "cuda",
                   model: str = "synthetic-llama-1b", runs: Optional[dict] = None) -> dict:
  """Phase 21: training. (a) K1b against its plain version (check_training_kernels);
  (b) the two-layer cuts' loss and gradients against the plain path in fp32 on the card
  (check_training_cut):
  `model`'s full, LoRA and QLoRA, then gemma-2-2b's (GEMMA_CONFIG: head_dim 256, the
  softcap, a windowed layer) full and LoRA; (c) main.py train and eval (drive_training); (d) ring training
  over TCP against one peer (drive_training_ring). Returns the K1 and K1b launches of
  (c) and (d), the phase's main path ((a) and (b) compare against plain versions);
  `runs` takes (c)'s full and LoRA runs (phase 24 holds its tp runs to their losses)."""
  t0 = time.perf_counter()
  if device == "cuda":
    check_training_kernels(torch, results)
  for mode in ("full", "lora", "qlora"):
    check_training_cut(torch, mode, device=device, model=model)
  t1 = time.perf_counter()
  for mode in ("full", "lora"):
    check_training_cut(torch, mode, device=device, model="gemma-2-2b", hf_config=GEMMA_CONFIG)
  print(f"[time] phase 21 (a, b): {time.perf_counter() - t0:.1f} s, the gemma-2-2b cut "
        f"{time.perf_counter() - t1:.1f} s of it", flush=True)
  run = drive_training(torch, card, device=device, model=model)
  if runs is not None:
    runs.update(full=run["full"], lora=run["lora"])
  launches = dict(run["launches"])
  for name, n in drive_training_ring(torch, card, device=device, model=model).items():
    launches[name] += n
  print(f"[training] phase 21 in {time.perf_counter() - t0:.1f} s; launches {launches} ({card})",
        flush=True)
  return launches


# Phase 22: the front door. Its replicas serve synthetic-llama-1b's config and seeded
# weights written as the llama-3.2-1b card's checkpoint with a word-level tokenizer: the
# synthetic card's stand-in tokenizer gives every word one id, and every prompt would
# then share every other's head.
FRONT_CARD = "llama-3.2-1b"
FRONT_POLL_S = 0.5  # the router's poll (XOT_ROUTER_POLL_S)
FRONT_DEAD_POLLS = 3  # XOT_FLEET_DEAD_POLLS
FRONT_BOOT_S = 240.0  # XOT_FLEET_BOOT_TIMEOUT_S, and the wait for a replica to serve
FRONT_LONG_WORDS = 2100  # (b)'s prompt: 2104 tokens with the template, 16 whole pages of 128
FRONT_WORDS = 300  # (c)'s prompt
FRONT_TIE_LP = 0.05  # a near tie: the two tokens' logprobs within this many nats, as the
                     # reference reported them (bf16 logits round at ~2^-8 of their size)
FRONT_KERNELS = ("flash_attention", "flash_cached_attention", "paged_decode_attention",
                 "paged_prefill_attention")


def front_words(seed: int, n: int) -> str:
  """n seeded words of the word-level tokenizer's vocabulary (w0-w96): one token each."""
  import numpy as np
  return " ".join(f"w{i}" for i in np.random.default_rng(seed).integers(0, 97, n))


def front_body(words: str, max_tokens: int = 16, user: Optional[str] = None, stream: bool = True,
               logprobs: bool = False) -> dict:
  body = {"model": FRONT_CARD, "messages": [{"role": "user", "content": words}],
          "max_tokens": max_tokens, "temperature": 0, "stream": stream}
  if user is not None:
    body["user"] = user
  if logprobs:
    body.update(logprobs=True, top_logprobs=2)
  return body


def front_stream(url: str, body: dict) -> dict:
  """A streamed completion: its text, its tokens' logprob items (when asked) and TTFT."""
  events, first, _ = http_stream(url + "/v1/chat/completions", body)
  text = "".join(c.get("delta", {}).get("content") or "" for ev in events for c in ev.get("choices", []))
  items = [it for ev in events for c in ev.get("choices", [])
           for it in ((c.get("logprobs") or {}).get("content") or [])]
  return {"text": text, "items": items, "ttft_s": first}


def front_agree(tag: str, want: dict, got: dict, card: str) -> None:
  """`got`'s tokens against `want`'s (each a front_stream with logprobs): equal, or equal
  up to a first divergence where `want` reported both tokens within FRONT_TIE_LP of each
  other (the KV each side attended to was computed by different kernels)."""
  a, b = [it["token"] for it in want["items"]], [it["token"] for it in got["items"]]
  if not a or len(a) != len(b):
    raise AssertionError(f"front door: {tag}: {len(b)} tokens against {len(a)}")
  first = next((i for i in range(len(a)) if a[i] != b[i]), None)
  if first is None:
    print(f"[front door] {tag}: streams identical ({len(a)} tokens) ok", flush=True)
    return
  tops = {t["token"]: t["logprob"] for t in want["items"][first]["top_logprobs"]}
  gap = abs(tops[a[first]] - tops[b[first]]) if b[first] in tops and a[first] in tops else math.inf
  ok = gap <= FRONT_TIE_LP
  print(f"[front door] {tag}: streams part at token {first} of {len(a)} ({a[first]} / {b[first]}), "
        f"logprob gap {gap:.4g} against the near-tie bound {FRONT_TIE_LP} "
        f"{'(a near tie) ok' if ok else 'FAIL'} ({card})", flush=True)
  if not ok:
    raise AssertionError(f"front door: {tag} parts at {first} where the tokens do not tie")


def front_metrics(url: str) -> dict:
  samples = prom_samples(http_text(url + "/metrics"))
  return {k: prom_family(samples, f"xot_kv_fabric_{k}_total") for k in ("hits", "misses", "errors", "bytes")}


def front_slots(tmp: str, home: str, device: str) -> dict:
  """The replicas' slots (fleet/__init__.load_template's shape): P (XOT_FABRIC_ROLE
  prefill), D1 (contiguous), D2 (XOT_PAGED_KV=1), each naming the other two in
  XOT_FABRIC_PEERS; and two references outside the template, D1r and D2r, configured as
  D1 and D2 with no fabric: their streams are the cold ones."""
  from xotorch_tpu_torch.utils.helpers import find_available_port
  from xotorch_tpu_torch.topology.device_capabilities import device_capabilities_sync
  caps = device_capabilities_sync().to_dict()
  names = ("P", "D1", "D2", "D1r", "D2r")
  api = {n: find_available_port("127.0.0.1") for n in names}
  urls = {n: f"http://127.0.0.1:{api[n]}" for n in names}
  slots = {}
  for n in names:
    node_port = find_available_port("127.0.0.1")
    cfg = os.path.join(tmp, f"{n}.json")
    write_ring_config(cfg, {n: node_port}, caps)  # a discovery domain of its own
    peers = ",".join(urls[m] for m in ("P", "D1", "D2") if m != n) if n in ("P", "D1", "D2") else ""
    slots[n] = {
      "name": n, "url": urls[n], "active": True, "log": os.path.join(tmp, f"{n}.log"),
      "argv": [sys.executable, "-m", "xotorch_tpu_torch.main", "--device", device,
               "--default-model", FRONT_CARD, "--node-id", n, "--node-host", "127.0.0.1",
               "--node-port", str(node_port), "--chatgpt-api-host", "127.0.0.1",
               "--chatgpt-api-port", str(api[n]), "--chatgpt-api-response-timeout", "600",
               "--discovery-module", "manual", "--discovery-config-path", cfg,
               "--default-temp", "0", "--max-generate-tokens", "64"],
      "env": {"XOT_HOME": home, "DEBUG": "1", "PYTHONUNBUFFERED": "1", "XOT_ALERT": "0",
              "XOT_PREFIX_CACHE": "2", "XOT_PREFIX_CACHE_MIN": "32", "XOT_PREFILL_COSCHED": "1",
              "XOT_KV_HOST_BYTES": str(512 << 20), "XOT_PREFILL_CHUNK": "4096",
              "XOT_PAGED_KV": "1" if n.startswith("D2") else "0",
              "XOT_FABRIC_ROLE": "prefill" if n == "P" else "mixed", "XOT_FABRIC_PEERS": peers}}
  return slots


def front_wait(urls: dict, procs: dict, timeout: float, tag: str) -> float:
  t0 = time.perf_counter()
  pending = set(urls)
  while pending:
    for n in sorted(pending):
      if n in procs and procs[n].poll() is not None:
        raise AssertionError(f"front door: {tag}: {n} exited {procs[n].returncode} while starting")
      try:
        if http_json(urls[n] + "/healthcheck", timeout=5).get("status") == "ok":
          pending.discard(n)
      except OSError:
        pass
    if pending and time.perf_counter() - t0 > timeout:
      raise AssertionError(f"front door: {tag}: {sorted(pending)} not serving after {timeout:.0f} s")
    time.sleep(0.25)
  return time.perf_counter() - t0


def _pid_gone(pid: int) -> bool:
  """True when `pid` has exited (gone, or a zombie its parent has not reaped)."""
  try:
    with open(f"/proc/{pid}/stat") as f:
      return f.read().rsplit(")", 1)[1].split()[0] == "Z"
  except OSError:
    return True


def check_front_door(torch, card: str, device: str = "cuda", config: Optional[dict] = None) -> dict:
  """Phase 22: the front door. `python -m xotorch_tpu_torch.router --fleet-template` over
  three replicas (P, D1, D2; front_slots) serving synthetic-llama-1b's config and seeded
  weights at full width and depth from a checkpoint; poll 0.5 s, the lifecycle's minimum
  out-time 0, drift off. (a) three requests of one `user` land on one replica (D1) and
  stream its direct answer; (b) a 2104-token prompt served on D1 and spilled to its host
  tier by two more, then sent to D2: D2's fabric hits rise by 1 and its fabric bytes by
  D1's entry's, its stream D2r's cold one under the near-tie rule, both TTFTs and the
  fetch's seconds printed; (c) a request through the router prefilled on P and chained to
  D1 through /v1/kv/offer: the router's fabric_chained_total and D1's fabric hits rise by
  1, the stream D1r's cold one under the near-tie rule; (d) D1 SIGKILLed: requests sent
  meanwhile all answer 200 (from D2), the controller respawns D1 within
  FRONT_DEAD_POLLS x poll + boot, the router announces its recent prompts at the new D1,
  which then serves (a)'s stream again. Every process stopped with SIGTERM and reaped;
  returns P's, D1's and D2's K1-K4 launches (their shutdown lines)."""
  import re
  import signal
  import tempfile
  from pathlib import Path
  from xotorch_tpu_torch.models.registry import get_model_card, get_repo
  from xotorch_tpu_torch.router import rendezvous
  from xotorch_tpu_torch.utils.helpers import find_available_port
  started = time.perf_counter()
  config = config or get_model_card("synthetic-llama-1b")["synthetic_config"]
  procs, logs, texts, respawned = {}, {}, {}, []
  out = {}
  with tempfile.TemporaryDirectory() as tmp:
    home = os.path.join(tmp, "home")
    model_dir = os.path.join(home, "models", get_repo(FRONT_CARD, "TorchShardInferenceEngine").replace("/", "--"))
    t0 = time.perf_counter()
    write_index(Path(model_dir), write_text_checkpoint(torch, model_dir, config, FRONT_CARD, 1,
                                                       device=device))
    gc.collect()
    if device == "cuda":
      torch.cuda.empty_cache()
    print(f"[front door] checkpoint written in {time.perf_counter() - t0:.1f} s", flush=True)
    slots = front_slots(tmp, home, device)
    urls = {n: s["url"] for n, s in slots.items()}
    template = os.path.join(tmp, "fleet.json")
    with open(template, "w") as f:
      json.dump({"slots": [slots[n] for n in ("P", "D1", "D2")]}, f)
    router_port = find_available_port("127.0.0.1")
    router = f"http://127.0.0.1:{router_port}"
    try:
      for n, s in slots.items():
        with open(s["log"], "ab") as log:
          procs[n] = subprocess.Popen(s["argv"], cwd=ROOT, env={**os.environ, **s["env"]},
                                      stdout=log, stderr=subprocess.STDOUT)
      boot = front_wait(urls, procs, FRONT_BOOT_S, "boot")
      # Each replica loads its model and tokenizer on a first request of 12 tokens (under
      # XOT_PREFIX_CACHE_MIN: nothing cached, nothing exported), as a deployment warms up
      # before it takes traffic; then the prompt lengths measured below run once on each
      # (prompts of their own, with logprobs), so that no first use of a shape falls in a
      # TTFT.
      from concurrent.futures import ThreadPoolExecutor
      t0 = time.perf_counter()
      with ThreadPoolExecutor(len(urls)) as pool:
        list(pool.map(lambda u: http_json(u + "/v1/chat/completions",
                                          front_body(front_words(20, 8), 2, stream=False)),
                      urls.values()))
        for i, n in enumerate((FRONT_LONG_WORDS, FRONT_WORDS)):
          list(pool.map(lambda j: http_json(list(urls.values())[j] + "/v1/chat/completions",
                                            front_body(front_words(40 + 10 * i + j, n), 2,
                                                       stream=False, logprobs=True)),
                        range(len(urls))))
      warmed = time.perf_counter() - t0
      logs["router"] = os.path.join(tmp, "router.log")
      with open(logs["router"], "ab") as log:
        procs["router"] = subprocess.Popen(
          [sys.executable, "-m", "xotorch_tpu_torch.router", "--fleet-template", template,
           "--host", "127.0.0.1", "--port", str(router_port), "--router-id", "smoke-router"],
          cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
          env={**os.environ, "DEBUG": "1", "PYTHONUNBUFFERED": "1",
               "XOT_ROUTER_POLL_S": str(FRONT_POLL_S), "XOT_ROUTER_MIN_OUT_S": "0",
               "XOT_ROUTER_DRIFT": "0", "XOT_ROUTER_PROBES": "2",
               "XOT_FLEET_DEAD_POLLS": str(FRONT_DEAD_POLLS),
               "XOT_FLEET_BOOT_TIMEOUT_S": str(FRONT_BOOT_S), "XOT_FLEET_WARM_PREFIXES": "4"})
      front_wait({"router": router}, procs, 60, "router")
      for _ in range(200):
        st = http_json(router + "/v1/router")
        if st["routable"] == ["D1", "D2"] and st["prefill_replicas"] == ["P"]:
          break
        time.sleep(0.1)
      else:
        raise AssertionError(f"front door: the router sees {st['routable']}, {st['prefill_replicas']}")
      print(f"[front door] five replicas serving {boot:.1f} s after launch, warm {warmed:.1f} s "
            f"later; the router routes "
            f"{st['routable']}, chains through {st['prefill_replicas']} ({card})", flush=True)

      # (a) Affinity: a `user` whose rendezvous pick is D1.
      user = next(f"user-{i}" for i in range(100) if rendezvous(f"user:user-{i}", ["D1", "D2"]) == "D1")
      body_a = front_body(front_words(21, 40), stream=False, user=user)
      before = http_json(router + "/v1/router")["replicas"]
      answers = [http_json(router + "/v1/chat/completions", body_a)["choices"][0]["message"]["content"]
                 for _ in range(3)]
      after = http_json(router + "/v1/router")["replicas"]
      routed = {n: after[n]["routed_total"] - before[n]["routed_total"] for n in ("D1", "D2")}
      direct = http_json(urls["D1"] + "/v1/chat/completions", body_a)["choices"][0]["message"]["content"]
      ok = routed == {"D1": 3, "D2": 0} and answers == [direct] * 3 and direct
      print(f"[front door] (a) three requests of user {user}: routed {routed}, streams equal to "
            f"D1's direct answer {'ok' if ok else 'FAIL'}", flush=True)
      if not ok:
        raise AssertionError(f"front door: (a) routed {routed}, answers {answers} against {direct!r}")

      # (b) A long prompt served and spilled on D1, then fetched by D2.
      long_words = front_words(22, FRONT_LONG_WORDS)
      for words in (long_words, front_words(31, 60), front_words(32, 60)):
        http_json(urls["D1"] + "/v1/chat/completions", front_body(words, 2, stream=False))
      ids = http_json(urls["D1"] + "/v1/chat/token/encode", front_body(long_words))["encoded_tokens"]
      shard = f"{FRONT_CARD}:0:{config['num_hidden_layers'] - 1}:{config['num_hidden_layers']}"
      match = http_json(urls["D1"] + "/v1/kv/match", {"shard": shard, "toks": ids})
      if not match.get("key") or match["common"] != len(ids) - 1:
        raise AssertionError(f"front door: (b) D1 holds no spilled entry for the prompt: {match}")
      man = http_json(urls["D1"] + f"/v1/kv/{match['key']}")
      entry_bytes = sum(leaf["nbytes"] for leaf in man["leaves"]) + 8 * man["n_toks"]
      cold = front_stream(urls["D2r"], front_body(long_words, logprobs=True))
      m0 = front_metrics(urls["D2"])
      warm = front_stream(urls["D2"], front_body(long_words, logprobs=True))
      m1 = front_metrics(urls["D2"])
      delta = {k: m1[k] - m0[k] for k in m0}
      events = http_json(urls["D2"] + "/v1/debug/flight?live=all")["events"]
      fetch = [e for e in events if e["event"] == "fabric.fetch"]
      restore = [e for e in events if e["event"] == "host.restore" and e.get("source") == "fabric"]
      secs = fetch[-1].get("secs") if fetch else None
      served = [e for e in http_json(urls["D1"] + "/v1/debug/flight?live=all")["events"]
                if e["event"] == "fabric.serve"]
      out["serve_secs"] = served[-1].get("secs") if served else None
      ok = delta["hits"] == 1 and delta["bytes"] == entry_bytes and delta["errors"] == 0 and fetch
      out["fetch"] = {"bytes": entry_bytes, "secs": secs, "ttft_cold_s": cold["ttft_s"],
                      "ttft_warm_s": warm["ttft_s"], "tokens": len(ids)}
      print(f"[front door] (b) {len(ids)}-token prompt spilled on D1 ({man['length']} tokens, "
            f"{entry_bytes} bytes), fetched by D2: fabric {delta}, fetch {secs} s "
            f"({entry_bytes / secs / 1e9 if secs else float('nan'):.3f} GB/s; D1 packed it in "
            f"{out['serve_secs']} s), restore "
            f"{restore[-1].get('secs') if restore else None} s; TTFT cold (D2r) "
            f"{cold['ttft_s'] * 1e3:.1f} ms, fabric-warm (D2) {warm['ttft_s'] * 1e3:.1f} ms "
            f"({card}) {'ok' if ok else 'FAIL'}", flush=True)
      if not ok:
        raise AssertionError(f"front door: (b) fabric {delta}, entry {entry_bytes} bytes, fetch {fetch}")
      front_agree("(b) D2's fabric-warm stream against D2r's cold one", cold, warm, card)

      # (c) Disaggregation: prefilled on P, chained to D1 (the user's affinity pick).
      words_c = front_words(23, FRONT_WORDS)
      cold_c = front_stream(urls["D1r"], front_body(words_c, logprobs=True))
      r0, d0 = http_json(router + "/v1/router"), front_metrics(urls["D1"])
      chained = front_stream(router, front_body(words_c, user=user, logprobs=True))
      r1, d1 = http_json(router + "/v1/router"), front_metrics(urls["D1"])
      rise = (r1["fabric_chained_total"] - r0["fabric_chained_total"], d1["hits"] - d0["hits"],
              r1["replicas"]["D1"]["routed_total"] - r0["replicas"]["D1"]["routed_total"])
      ok = rise == (1, 1, 1)
      print(f"[front door] (c) prefill on P chained to D1: chained, D1's fabric hits, D1's routed "
            f"rose by {rise}; TTFT chained {chained['ttft_s'] * 1e3:.1f} ms, D1r cold "
            f"{cold_c['ttft_s'] * 1e3:.1f} ms ({card}) {'ok' if ok else 'FAIL'}", flush=True)
      if not ok:
        raise AssertionError(f"front door: (c) chained, hits, routed rose by {rise}")
      front_agree("(c) the chained stream against D1r's cold one", cold_c, chained, card)
      out["ttft_chained_s"] = chained["ttft_s"]

      # (d) Failover and respawn.
      st0 = http_json(router + "/v1/router")
      t_kill = time.perf_counter()
      procs["D1"].send_signal(signal.SIGKILL)
      procs["D1"].wait(timeout=60)
      body_d = {**body_a, "max_tokens": 8}
      codes = []
      for _ in range(4):
        try:
          http_json(router + "/v1/chat/completions", body_d)
          codes.append(200)
        except Exception as e:
          codes.append(getattr(e, "code", repr(e)))
      t_respawn = t_back = None
      while time.perf_counter() - t_kill < FRONT_DEAD_POLLS * FRONT_POLL_S + FRONT_BOOT_S:
        st = http_json(router + "/v1/router")
        if t_respawn is None and st["fleet"]["respawns_total"] >= 1:
          t_respawn = time.perf_counter() - t_kill
        if "D1" in st["routable"] and st["replicas"]["D1"]["state"] == "healthy":
          t_back = time.perf_counter() - t_kill
          break
        time.sleep(0.1)
      respawned = list((st["fleet"]["pids"] or {}).values())
      served = st["replicas"]["D2"]["routed_total"] - st0["replicas"]["D2"]["routed_total"]
      announced = st["prefetch_announced_total"] - st0["prefetch_announced_total"]
      again = http_json(router + "/v1/chat/completions", body_a)["choices"][0]["message"]["content"]
      st1 = http_json(router + "/v1/router")
      routed_d1 = st1["replicas"]["D1"]["routed_total"] - st["replicas"]["D1"]["routed_total"]
      ok = (codes == [200] * 4 and served >= 4 and t_back is not None and announced >= 1
            and again == direct and routed_d1 == 1 and st["fleet"]["deaths_total"] == 1)
      out["respawn"] = {"decided_s": t_respawn, "routable_s": t_back}
      print(f"[front door] (d) D1 SIGKILLed: 4 requests meanwhile answered {codes} ({served} routed "
            f"to D2); respawn decided {t_respawn} s after the kill (dead after {FRONT_DEAD_POLLS} "
            f"polls of {FRONT_POLL_S} s), D1 routable again at {t_back} s; {announced} warm "
            f"announces; D1's stream of (a) again {'equal' if again == direct else 'DIFFERENT'} "
            f"({card}) {'ok' if ok else 'FAIL'}", flush=True)
      if not ok:
        raise AssertionError(f"front door: (d) codes {codes}, D2 {served}, back {t_back}, "
                             f"announced {announced}, routed to D1 {routed_d1}, fleet {st['fleet']}")
    finally:
      for n, p in procs.items():
        if p.poll() is None:
          p.send_signal(signal.SIGTERM)
      for pid in respawned:
        try:
          os.kill(pid, signal.SIGTERM)
        except OSError:
          pass
      for p in procs.values():
        try:
          p.wait(timeout=60)
        except subprocess.TimeoutExpired:
          p.kill()
          p.wait(timeout=60)
      deadline = time.perf_counter() + 60
      while respawned and not all(_pid_gone(pid) for pid in respawned) and time.perf_counter() < deadline:
        time.sleep(0.1)
      for pid in respawned:
        if not _pid_gone(pid):
          os.kill(pid, signal.SIGKILL)
      for n, path in [(n, s["log"]) for n, s in slots.items()] + list(logs.items()):
        with open(path) as f:
          texts[n] = f.read()
  left = [n for n, p in procs.items() if p.poll() is None] + [pid for pid in respawned if not _pid_gone(pid)]
  codes = {n: p.returncode for n, p in procs.items()}
  ok = not left and all(c == 0 for n, c in codes.items() if n != "D1") and codes.get("D1") == -9
  print(f"[front door] processes stopped: exit codes {codes}, respawned D1 {respawned}, none left "
        f"{'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    tails = "\n".join(f"--- {n}\n{t[-2000:]}" for n, t in texts.items())
    raise AssertionError(f"front door: left {left}, exit codes {codes}\n{tails}")
  launches = {}
  for n in ("P", "D1", "D2"):
    found = re.findall(rf"^launches {n}: (\{{.*\}})$", texts[n], re.M)
    if not found:
      raise AssertionError(f"front door: {n} reported no launches\n{texts[n][-2000:]}")
    launches[n] = {k: json.loads(found[-1]).get(k, 0) for k in FRONT_KERNELS}
  need = {"P": ("flash_attention",), "D1": ("flash_attention", "flash_cached_attention"),
          "D2": ("paged_decode_attention", "paged_prefill_attention")}
  ok = all(launches[n][k] > 0 for n, ks in need.items() for k in ks) or device != "cuda"
  print(f"[front door] K1-K4 launches by replica (D1 after its respawn): {launches} "
        f"{'ok' if ok else 'FAIL'}; phase {time.perf_counter() - started:.1f} s ({card})", flush=True)
  if not ok:
    raise AssertionError(f"front door: launches {launches}, wanted {need} above 0")
  out["launches"] = {k: sum(launches[n][k] for n in launches) for k in FRONT_KERNELS}
  return out


# ---------------------------------------------------------------- phase 23: parallelism

PARALLEL_TP = 2  # the positions of phase 23's tensor-parallel mesh, on the one card
PARALLEL_CUT_STEPS = 4  # decode steps of each phase 23 (b) cut


def parallel_streams(torch, card: str, main_run: dict, paged: bool, device: str = "cuda",
                     model: str = "synthetic-llama-1b") -> dict:
  """Phase 23 (a): main.py --serve-tp 2 (XOT_VIRTUAL_DEVICES=2: both positions on the one
  card) answers the main path's three requests, on contiguous caches or the page arena.
  Greedy streams equal phase 5's, or part only at a near tie; the attention kernels'
  launches are tp x the single-card formula for the steps the batchers ran (contiguous:
  K1 = 16 layers x 3 fresh prefills, K2 = 16 x (decode steps + the 1502-token prompt's
  second segment); paged: K4 = 16 x the prompts' 1024-token segments, K3 = 16 x decode
  steps); each position holds CostModel.weight_bytes_per_device of weights; the decode
  steps ran as replays of graphs whose keys name the mesh. The contiguous server's B=1
  decode chunk runs under the profiler (device ms a step against phase 5's). Returns the
  launches."""
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention
  from xotorch_tpu_torch.ops.paged_attention import paged_decode_attention, paged_prefill_attention
  from xotorch_tpu_torch.parallel.mesh import device_bytes

  tag = f"tp{PARALLEL_TP} {'paged' if paged else 'contiguous'}"
  kernels = ((paged_prefill_attention, paged_decode_attention) if paged
             else (flash_attention, flash_cached_attention))
  held = {}

  async def after(engine, node, api, base):
    ctx = engine._ctx
    per_position = [device_bytes(piece) for piece in ctx.params.pieces]
    gc = ctx.graphs
    keyed = gc is None or any(("mesh",) + ctx.mesh.key() in key for key in gc.programs)
    held.update(mesh=dict(ctx.mesh.shape), positions=per_position,
                predicted=ctx.costmodel.weight_bytes_per_device(),
                whole=ctx.costmodel.weight_bytes(),
                graphs=(gc.captures, gc.replays, keyed) if gc is not None else None)
  # XOT_SERVE_TP listed so that the phase restores it: main.py writes --serve-tp there.
  env = {"XOT_VIRTUAL_DEVICES": str(PARALLEL_TP), "XOT_PREFIX_CACHE": "0",
         "XOT_PREFILL_COSCHED": "0", "XOT_PAGED_KV": "1" if paged else "0",
         "XOT_SERVE_TP": str(PARALLEL_TP)}
  run = drive_main_path(torch, card, device=device, model=model, kernels=kernels, env=env,
                        tag=tag, profiles=() if paged else (1,), focus="flash_cached_",
                        cli=("--serve-tp", str(PARALLEL_TP)), after=after)
  from xotorch_tpu_torch.models.registry import get_model_card
  tp, layers, steps = PARALLEL_TP, get_model_card(model)["layers"], run["steps"]
  if paged:
    segments = sum(-(-n // 1024) for n in run["prompt_tokens"])
    want = {"paged_prefill_attention": tp * layers * segments,
            "paged_decode_attention": tp * layers * steps}
  else:
    want = {"flash_attention": tp * layers * 3, "flash_cached_attention": tp * layers * (steps + 1)}
  ok_launch = run["launches"] == want
  single = {k: tp * main_run["launches"][k] for k in want if k in main_run["launches"]}
  print(f"[{tag}] launches {run['launches']}: tp x the single-card formula for {steps} decode "
        f"steps {want} {'ok' if ok_launch else 'FAIL'}"
        + (f"; tp x phase 5's counts {single} ({main_run['steps']} steps there)" if single else ""),
        flush=True)
  ok_bytes = held["mesh"] == {"tp": tp} and all(b == held["predicted"] for b in held["positions"])
  print(f"[{tag}] mesh {held['mesh']}: weight bytes at each position {held['positions']} against "
        f"CostModel.weight_bytes_per_device {held['predicted']} (the whole model "
        f"{held['whole']}) {'ok' if ok_bytes else 'FAIL'}", flush=True)
  print(f"[{tag}] {', '.join(run['timings'])} (TTFT / TPOT with both positions on one card, "
        f"not a scaling figure; {card})", flush=True)
  graphs = held["graphs"]
  ok_graphs = graphs is None or (graphs[1] > 0 and graphs[2])
  if graphs is not None:
    print(f"[{tag}] decode as CUDA graphs of every position's kernels, copies and sums: "
          f"{graphs[0]} captures, {graphs[1]} replays, keys naming the mesh "
          f"{'ok' if ok_graphs else 'FAIL'}", flush=True)
  prof, single = run["profiles"].get(1), main_run["profiles"].get(1)
  if prof and single:
    print(f"[{tag}] B=1 decode step: {prof['device_ms']:.3f} device ms, "
          f"{prof['kernels_per_step']:.0f} kernels, {100 - prof['busy_pct']:.1f}% idle; one "
          f"card (phase 5) {single['device_ms']:.3f} device ms, {single['kernels_per_step']:.0f} "
          f"kernels: {prof['device_ms'] / single['device_ms']:.2f}x ({card})", flush=True)
  if not (ok_launch and ok_bytes and ok_graphs):
    raise AssertionError(f"{tag}: launches {run['launches']} (want {want}), bytes or graphs {held}")
  greedy = {j: toks for j, toks in enumerate(run["tokens"])
            if main_requests(model)[j][1].get("temperature") == 0}
  parted = {j: toks for j, toks in greedy.items() if toks != main_run["tokens"][j]}
  for j in greedy:
    if j not in parted:
      print(f"[{tag}] {main_requests(model)[j][0]}: {len(greedy[j])} temperature-0 tokens equal "
            f"phase 5's ok", flush=True)
  if parted:
    parallel_ties(torch, parted, main_run, tag, card, device, model)
  return run["launches"]


def parallel_ties(torch, parted: dict, main_run: dict, tag: str, card: str, device: str,
                  model: str) -> None:
  """Streams of a tp server that parted from phase 5's: each must part only at a near
  tie (streams_agree: the two tokens' logits within TIE_REL of the row's largest), read
  on a fresh tp engine from each request's prompt ids, as the API built them."""
  from xotorch_tpu_torch.api.chatgpt_api import build_prompt
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  from xotorch_tpu_torch.models.registry import build_full_shard

  with phase_env(XOT_VIRTUAL_DEVICES=str(PARALLEL_TP), XOT_TP=str(PARALLEL_TP)):
    engine = TorchShardInferenceEngine(device=device)

  async def check():
    shard = build_full_shard(model, type(engine).__name__)
    await engine.ensure_shard(shard)
    for j, got in parted.items():
      body = main_requests(model)[j][1]
      ids = (await engine.encode(shard, build_prompt(engine.tokenizer, body["messages"]))).tolist()
      await streams_agree(torch, engine, shard, f"{tag} {main_requests(model)[j][0]}", ids,
                          main_run["tokens"][j], got, card)
  try:
    asyncio.run(check())
  finally:
    engine.executor.shutdown(wait=True)


def _held_calls(torch, transformer, names, calls: list):
  """The transformer's kernel entry points `names` wrapped to record every call (its
  inputs and output) into `calls`; returns the originals to restore."""
  originals = {n: getattr(transformer, n) for n in names}

  def wrap(name, fn):
    def held(*args, **kw):
      out = fn(*args, **kw)
      calls.append((name, args, kw, out))
      return out
    return held
  for n, fn in originals.items():
    setattr(transformer, n, wrap(n, fn))
  return originals


def _plain_call(torch, fn, args, kw):
  """A kernel wrapper's plain version on the same inputs: the wrapper given CPU copies
  (a wrapper takes its plain version for tensors on the CPU)."""
  cpu = lambda t: t.cpu() if torch.is_tensor(t) else t  # noqa: E731
  return fn(*(cpu(a) for a in args), **{k: cpu(v) for k, v in kw.items()})


def parallel_cut(torch, card: str, fmt=None, kv_quant: bool = False, paged: bool = False,
                 env=None, limit: float = 5e-2, device: str = "cuda",
                 model: str = "synthetic-llama-1b") -> dict:
  """Phase 23 (b): a two-layer cut of `model` at full width, placed on a tp mesh of
  PARALLEL_TP positions of the card (parallel/mesh.shard_params, a sharded cache or page
  arena), prefill 100 tokens + PARALLEL_CUT_STEPS decode steps against the same cut
  unsharded on the card. Every per-shard kernel call of the sharded run (the attention
  kernels on Hq/tp heads over Hkv/tp cache heads, the GEMV kernels on each position's
  column or row slice) is held against its plain version on its own inputs: within
  rel_limit (2^-6 of the output's largest value) for attention, QUANT_REL_TOL for the
  GEMVs. The sharded logits are held within `limit` of the logits' range of the
  unsharded ones, and a control that drops the last position's term of every all-reduce
  must miss it. Returns {kernel: calls held}."""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.inference.torch_engine.paged_cache import PagePool
  from xotorch_tpu_torch.models import transformer
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.quantize import quantize_params
  from xotorch_tpu_torch.models.registry import get_model_card
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache, init_random_params
  from xotorch_tpu_torch.parallel.mesh import local_devices, make_mesh, shard_params

  cfg = dataclasses.replace(config_from_hf_dict(get_model_card(model)["synthetic_config"]),
                            num_layers=2)
  dev = torch.device(device)
  params = init_random_params(cfg, 2, True, True, seed=0, dtype=torch.bfloat16, device=dev)
  if fmt:
    params = quantize_params(params, fmt, scale_dtype=torch.bfloat16, inplace=True)
  with phase_env(XOT_VIRTUAL_DEVICES=str(PARALLEL_TP)):
    mesh = make_mesh({"tp": PARALLEL_TP}, local_devices(dev))
  sharded = shard_params(params, mesh)
  tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, 100)),
                           device=dev)
  route = None  # the knobs' route, read inside the phase's environment below

  def run(p, on_mesh: bool, fed=None):
    """Logits of the prefill's last 8 positions and of the decode steps (feeding `fed`,
    or the run's own greedy tokens)."""
    m = mesh if on_mesh else None
    if paged:
      pool = PagePool(cfg, 2, 4, 128, dtype=torch.bfloat16, device=dev, kv_quant=kv_quant, mesh=m)
      kw = {"page_table": torch.tensor([[1, 2, 3]], dtype=torch.int32, device=dev)}
      cache = pool.arena
    else:
      cache = init_kv_cache(cfg, 2, 1, 256, torch.bfloat16, dev, kv_quant=kv_quant, mesh=m)
      kw = {}
    logits, _ = forward_shard(p, tokens, cache, 0, cfg, True, True, use_flash=not paged,
                              route=route, **kw)
    out, toks = [logits[0, -8:].float().cpu()], []
    for i in range(PARALLEL_CUT_STEPS):
      toks.append(fed[i] if fed else int(out[-1][-1].argmax()))
      logits, _ = forward_shard(p, torch.tensor([[toks[-1]]], device=dev), cache, 100 + i, cfg,
                                True, True, use_flash_decode=not paged, route=route, **kw)
      out.append(logits[0].float().cpu())
    return out, toks

  names = ("flash_attention", "flash_cached_attention", "paged_decode_attention",
           "paged_prefill_attention", "int4_grouped_matmul", "int8_rowquant_matmul")
  calls: list = []
  with phase_env(**(env or {})), torch.inference_mode():
    route = transformer.quant_route(dev.type == "cuda")
    want, fed = run(params, False)
    originals = _held_calls(torch, transformer, names, calls)
    try:
      got, _ = run(sharded, True, fed)
    finally:
      for n, fn in originals.items():
        setattr(transformer, n, fn)
    real = transformer.all_reduce
    transformer.all_reduce = lambda parts, devices: real(
      list(parts[:-1]) + [torch.zeros_like(parts[-1])], devices)
    try:
      control, _ = run(sharded, True, fed)
    finally:
      transformer.all_reduce = real
    held, worst_call = {}, {}
    for name, args, kw, out in calls:
      ref = _plain_call(torch, originals[name], args, kw).float()
      err = ((out.float().cpu() - ref).abs().max() / ref.abs().max()).item()
      key = {"int4_grouped_matmul": f"int4_v{args[3] if len(args) > 3 else 1}"}.get(name, name)
      if kv_quant and name != "flash_attention":
        key += "_int8"
      held[key] = held.get(key, 0) + 1
      worst_call[key] = max(worst_call.get(key, 0.0), err)

  def error(logits):
    if not all(bool(torch.isfinite(g).all()) for g in logits):
      raise AssertionError("parallel: non-finite logits")
    return max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(logits, want))

  worst, missed = error(got), error(control)
  call_ok = all(e <= (QUANT_REL_TOL if "int" in k and "attention" not in k else 2.0 ** -6)
                for k, e in worst_call.items())
  label = (f"{fmt or 'bf16'} weights, {'int8' if kv_quant else 'bf16'} "
           f"{'page arena' if paged else 'cache'}" + (f", {env}" if env else ""))
  ok = worst < limit and missed > limit and call_ok and held
  print(f"[parallel cut] 2-layer {model} over tp={PARALLEL_TP} ({label}), prefill 100 + decode "
        f"{PARALLEL_CUT_STEPS}: logits within {worst:.3e} of the logits' range of the unsharded "
        f"cut's (limit {limit:g}); control, the last position's all-reduce term dropped: "
        f"{missed:.3e} ({'caught' if missed > limit else 'NOT caught'}); per-shard kernel calls "
        f"against their plain versions: {', '.join(f'{k} x{n} worst {worst_call[k]:.2e}' for k, n in held.items())} "
        f"{'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"parallel cut {label}: {worst}, control {missed}, calls {worst_call}")
  return held


def ring_reference(torch, qs, ks, vs) -> "torch.Tensor":
  """Plain causal GQA attention in fp32 over a ring call's chunks put back in order
  (ops/ring_attention.ring_attention's plain version): [B, T, Hq, D]."""
  dev = qs[0].device
  q = torch.cat([t.to(dev) for t in qs], dim=1).float()
  k = torch.cat([t.to(dev) for t in ks], dim=1).float()
  v = torch.cat([t.to(dev) for t in vs], dim=1).float()
  B, T, Hq, D = q.shape
  g = Hq // k.shape[2]
  k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
  s = torch.einsum("bthd,bshd->bhts", q, k) / D ** 0.5
  causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
  p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
  return torch.einsum("bhts,bshd->bthd", p, v)


def ring_row_err(torch, outs, ref) -> float:
  """The worst query row's error: max |out - ref| over a (position, head) row against
  that row's largest |ref| (a row that lost its earlier chunks reads O(1), however
  small its values are beside another row's)."""
  got = torch.cat([o.to(ref.device) for o in outs], dim=1).float()
  return ((got - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


@contextlib.contextmanager
def ring_folds_dropped(torch):
  """ops/ring_attention's fold of every chunk that comes round from an earlier position
  dropped (at sp 2: the last rotation's): the ring control."""
  from xotorch_tpu_torch.ops import ring_attention as ring_mod
  real = ring_mod._fold_chunk

  def fold(q, k, v, acc, m, l, q_pos, k_pos, scale):
    if int(k_pos[0]) < int(q_pos[0]):
      return acc, m, l
    return real(q, k, v, acc, m, l, q_pos, k_pos, scale)
  ring_mod._fold_chunk = fold
  try:
    yield
  finally:
    ring_mod._fold_chunk = real


def parallel_ring_prefill(torch, card: str, device: str = "cuda", model: str = "synthetic-llama-1b",
                          T: int = 1502) -> None:
  """Phase 23 (c): synthetic-llama-1b at full width and depth over an sp=2 x tp=2 mesh
  (four positions of the card) prefills a T-token prompt in 1024-token segments (the
  engine reads XOT_PREFILL_CHUNK at each call, so it is held through the run): the
  from-zero segment through ring attention (counted once; 512 positions a position),
  the second through K2 on each tp position's cache piece. The last 8 positions' logits
  are held within 5e-2 of the logits' range of the same prompt on one device. Every ring call
  (one a layer and tp index) is held by itself against plain causal attention in fp32
  on its own chunks, within 2^-7 of each query row's largest value (the ring's output
  is bf16: 2^-8 at most). The control drops the last rotation's fold: it must miss that
  limit on every call, and the logits' limit over the whole prefill."""
  import numpy as np
  from xotorch_tpu_torch.inference.torch_engine.engine import TorchShardInferenceEngine
  from xotorch_tpu_torch.models.registry import build_full_shard, get_model_card
  from xotorch_tpu_torch.ops import ring_attention as ring_mod

  vocab = get_model_card(model)["synthetic_config"]["vocab_size"]
  prompt = np.random.default_rng(23).integers(3, vocab, size=(1, T))

  async def logits_of(engine):
    shard = build_full_shard(model, type(engine).__name__)
    t0 = time.perf_counter()
    out, _ = await engine.infer_tensor("sp", shard, prompt)
    secs = time.perf_counter() - t0
    await engine.clear_request("sp")
    return torch.as_tensor(np.asarray(out)[0, -8:]), secs, engine._ctx.mesh

  calls = []
  real_ring = ring_mod.ring_attention

  def recorded(qs, ks, vs, devices):
    outs = real_ring(qs, ks, vs, devices)
    calls.append((qs, ks, vs, devices, outs))
    return outs

  runs = {}
  mesh_env = {"XOT_VIRTUAL_DEVICES": "4", "XOT_TP": "2", "XOT_SERVE_SP": "2"}
  for label, env in (("one device", {"XOT_TP": "0"}), ("sp=2 x tp=2", mesh_env),
                     ("control", mesh_env)):
    # The ring prefill is the contiguous path's (an earlier phase may leave the pool on).
    with contextlib.ExitStack() as stack:
      stack.enter_context(phase_env(XOT_PREFILL_CHUNK="1024", XOT_PREFIX_CACHE="0",
                                    XOT_PAGED_KV="0", **env))
      engine = TorchShardInferenceEngine(device=device)
      if label == "control":
        stack.enter_context(ring_folds_dropped(torch))
      elif label != "one device":
        ring_mod.ring_attention = recorded
        stack.callback(setattr, ring_mod, "ring_attention", real_ring)
      try:
        runs[label] = asyncio.run(logits_of(engine)) + (engine.sp_ring_prefills,)
      finally:
        engine.executor.shutdown(wait=True)
  want, _, _, _ = runs["one device"]
  got, secs, mesh, rings = runs["sp=2 x tp=2"]
  err = ((got - want).abs().max() / want.abs().max()).item()
  control = runs["control"][0]
  control_err = ((control - want).abs().max() / want.abs().max()).item()
  call_errs, control_calls = [], []
  with torch.inference_mode():
    for qs, ks, vs, devices, outs in calls:
      ref = ring_reference(torch, qs, ks, vs)
      call_errs.append(ring_row_err(torch, outs, ref))
      with ring_folds_dropped(torch):
        control_calls.append(ring_row_err(torch, real_ring(qs, ks, vs, devices), ref))
  chunk_len = calls[0][0][0].shape[1] if calls else 0
  del calls
  limit = 2.0 ** -7
  calls_ok = (len(call_errs) == 2 * get_model_card(model)["layers"] and max(call_errs) <= limit
              < min(control_calls))
  ok = (bool(torch.isfinite(got).all()) and err < 5e-2 < control_err and rings == 1
        and calls_ok and dict(mesh.shape) == {"sp": 2, "tp": 2})
  print(f"[parallel sp] {len(call_errs)} ring calls (a layer and tp index each, 2 x "
        f"{chunk_len} positions) against plain causal attention in fp32 on their own chunks: worst query "
        f"row {max(call_errs):.3e} of its largest value (limit 2^-7); control, the last "
        f"rotation's fold dropped: every call {min(control_calls):.3e} or more "
        f"({'caught' if min(control_calls) > limit else 'NOT caught'}) "
        f"{'ok' if calls_ok else 'FAIL'}", flush=True)
  print(f"[parallel sp] {model} {T}-token prompt over {dict(mesh.shape)}: ring prefills {rings} "
        f"(want 1: the from-zero segment), last 8 logits within {err:.3e} of the logits' range "
        f"of one device's (limit 5e-2); control, the last rotation's fold dropped: "
        f"{control_err:.3e} ({'caught' if control_err > 5e-2 else 'NOT caught'}); infer_tensor (every position's logits to the host) "
        f"{secs * 1e3:.1f} ms with the four positions on one card, one device "
        f"{runs['one device'][1] * 1e3:.1f} ms (not a scaling figure; "
        f"{card}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"parallel sp: err {err}, rings {rings}, mesh {mesh}, ring calls "
                         f"{call_errs}, controls {control_calls}")


def parallel_experts(torch, card: str, device: str = "cuda", config=None, T: int = 64) -> None:
  """Phase 23 (d): a seeded two-layer cut at qwen3-moe's published widths (QWEN3_MOE_CONFIG:
  128 experts of 768, top 8) placed on an ep=2 mesh of the card, each position holding 64
  experts: a T-token prefill and two decode steps through the dense combine (JAX's form
  under ep), each position's partial sums all-reduced, held within 5e-2 of the logits'
  range of the same cut on one device through the single-device dense combine (its
  decode steps too, where it would take the routed gather); a control that drops one
  position's experts must miss. Prints the prefill's and the decode steps' errors, the
  tokens at which the mesh chose other experts than one device with the router's gap
  there, and one device's logits routed as the mesh routed (what is left once the
  choices agree); the two ep positions must route alike. Each
  MoE layer call is also held by itself: the two positions' partial sums added in fp32
  against one device's dense combine on the same input (so the same routing), within
  2^-6 of the output's largest value; the logits may move more, where an expert choice
  at a near tie flips on the second layer."""
  import dataclasses
  import numpy as np
  from xotorch_tpu_torch.models import transformer
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.transformer import forward_shard, init_kv_cache, init_random_params
  from xotorch_tpu_torch.parallel.mesh import local_devices, make_mesh, shard_params

  cfg = dataclasses.replace(config_from_hf_dict(config or QWEN3_MOE_CONFIG), num_layers=2)
  dev = torch.device(device)
  params = init_random_params(cfg, 2, True, True, seed=5, dtype=torch.bfloat16, device=dev)
  with phase_env(XOT_VIRTUAL_DEVICES="2"):
    mesh = make_mesh({"ep": 2, "tp": 1}, local_devices(dev))
  sharded = shard_params(params, mesh)
  tokens = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, size=(1, T)),
                           device=dev)

  def run(p, m):
    cache = init_kv_cache(cfg, 2, 1, T + 8, torch.bfloat16, dev, mesh=m)
    logits, _ = forward_shard(p, tokens, cache, 0, cfg, True, True, use_flash=True)
    out = [logits[0, -8:].float().cpu()]
    for i in range(2):
      tok = torch.tensor([[int(out[0][-1].argmax()) + i]], device=dev)
      logits, _ = forward_shard(p, tok, cache, T + i, cfg, True, True, use_flash_decode=True)
      out.append(logits[0].float().cpu())
    return out

  with torch.inference_mode():
    dense = transformer._moe_mlp
    want_h = []

    def single(layer, h, c, **kw):
      want_h.append(h)
      return dense(layer, h, c, routed=False)
    transformer._moe_mlp = single
    try:
      with routing_recorded(torch) as want_idx:
        want = run(params, None)
    finally:
      transformer._moe_mlp = dense
    calls = []

    def recorded(layer, h, c, **kw):
      out = dense(layer, h, c, **kw)
      calls.append((h, out))
      return out
    transformer._moe_mlp = recorded
    try:
      with routing_recorded(torch) as got_idx:
        got = run(sharded, mesh)
    finally:
      transformer._moe_mlp = dense
    # Where the mesh chose other experts than one device: each call's tokens whose top-k
    # set differs, and one device's router gap there between its k-th and (k+1)-th
    # logits (a near tie flips under another order of the partial sums upstream).
    # The mesh routes once an ep position: the two positions' choices must agree.
    mesh_idx = got_idx[0::2]
    flips = []
    for k, (a, b) in enumerate(zip(want_idx, mesh_idx)):
      differ = (a.sort(-1).values != b.sort(-1).values).any(-1).reshape(-1)
      router = params["layers"]["router"][k % 2].float()
      logits = (want_h[k].float() @ router).reshape(-1, cfg.num_experts).sort(-1, descending=True).values
      gaps = (logits[:, cfg.num_experts_per_tok - 1] - logits[:, cfg.num_experts_per_tok]).cpu()
      flips.append((int(differ.sum()), differ.numel(),
                    gaps[differ].max().item() if differ.any() else None, gaps.median().item()))
    positions_agree = all(torch.equal(a, b) for a, b in zip(got_idx[0::2], got_idx[1::2]))
    # One device routed as the mesh routed: what is left is the partial sums' order.
    transformer._moe_mlp = lambda layer, h, c, **kw: dense(layer, h, c, routed=False)
    try:
      with forced_routing(torch, list(mesh_idx)):
        forced = run(params, None)
    finally:
      transformer._moe_mlp = dense
    # Calls come two a layer (ep positions 0 and 1), two layers a forward.
    call_errs = []
    for k in range(len(calls) // 2):
      (h, a), (_, b) = calls[2 * k], calls[2 * k + 1]
      layer = {name: w[k % 2] for name, w in params["layers"].items()}
      ref = dense(layer, h, cfg, routed=False).float()
      call_errs.append(((a.float() + b.float() - ref).abs().max() / ref.abs().max()).item())
    # The control: every ep position's term of the experts' all-reduce but the first dropped.
    transformer._moe_mlp = lambda layer, h, c, **kw: (
      dense(layer, h, c, **kw) * (0 if kw.get("experts", (0,))[0] else 1))
    try:
      control = run(sharded, mesh)
    finally:
      transformer._moe_mlp = dense
  del params, sharded
  errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
  err = max(errs)
  forced_errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, forced)]
  missed = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(control, want))
  calls_ok = len(call_errs) == 6 and max(call_errs) <= 2.0 ** -6
  ok = (err < 5e-2 < missed and calls_ok and positions_agree
        and all(bool(torch.isfinite(g).all()) for g in got))
  names = [f"{part} layer {k % 2}" for part in ("prefill", "step 1", "step 2") for k in range(2)]
  print(f"[parallel ep] expert choices the mesh made otherwise than one device (tokens of "
        f"the call; one device's router gap between its k-th and (k+1)-th largest logits, "
        f"k = {cfg.num_experts_per_tok}, at those tokens, largest, against the median over "
        f"all the call's tokens): "
        + "; ".join(f"{n} {f}/{t}" + (f" (gap {g:.3e}, median {m:.3e})" if g is not None else "")
                    for n, (f, t, g, m) in zip(names, flips))
        + f"; the ep positions routed alike: {positions_agree}; one device routed as the mesh "
        f"routed: logits within {max(forced_errs):.3e} (prefill {forced_errs[0]:.3e})",
        flush=True)
  print(f"[parallel ep] {len(call_errs)} MoE layer calls, the two positions' partial sums "
        f"against one device's dense combine on the same input: worst {max(call_errs):.3e} of "
        f"the output's largest value (limit 2^-6) {'ok' if calls_ok else 'FAIL'}", flush=True)
  print(f"[parallel ep] 2-layer qwen3-moe cut ({cfg.num_experts} experts of "
        f"{cfg.moe_intermediate_size}, top {cfg.num_experts_per_tok}) over ep=2, {T}-token "
        f"prefill + 2 decode steps, dense combine: logits within {err:.3e} of the logits' range "
        f"of one device's dense combine (prefill {errs[0]:.3e}, steps "
        f"{', '.join(f'{e:.3e}' for e in errs[1:])}; limit 5e-2); control, the second "
        f"position's experts dropped: "
        f"{missed:.3e} ({'caught' if missed > 5e-2 else 'NOT caught'}) {'ok' if ok else 'FAIL'}",
        flush=True)
  if not ok:
    raise AssertionError(f"parallel ep: {err}, calls {call_errs}, control {missed}")


def parallel_multihost(torch, device: str = "cuda") -> None:
  """Phase 23 (e): the multihost seam on the card: a one-process group (XOT_COORDINATOR
  on a local port, XOT_NUM_PROCESSES=1; NCCL when CUDA is present) all-reduces a tensor
  on this process's device. Two NCCL ranks need two cards."""
  import socket
  import torch.distributed as dist
  from xotorch_tpu_torch.parallel import multihost

  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
  with phase_env(XOT_COORDINATOR=f"127.0.0.1:{port}", XOT_NUM_PROCESSES="1", XOT_PROCESS_ID="0"):
    n, rank = multihost.init_multihost()
  try:
    x = torch.arange(4, dtype=torch.float32, device=device)
    got = multihost.all_reduce(x.clone())
    ok = (n, rank) == (1, 0) and bool(torch.equal(got, x)) and multihost.is_coordinator()
    print(f"[parallel multihost] {dist.get_backend()} group of {n} process(es), rank {rank}: "
          f"all-reduce of a {device} tensor {got.tolist()} {'ok' if ok else 'FAIL'}", flush=True)
  finally:
    dist.destroy_process_group()
  if not ok:
    raise AssertionError(f"parallel multihost: {(n, rank)}, {got}")


def check_parallel(torch, card: str, main_run: dict, device: str = "cuda") -> dict:
  """Phase 23: tensor, sequence and expert parallelism on the one card (every mesh's
  positions repeat it: correctness and per-shard kernel calls at real widths, not
  scaling), then the multihost seam. Returns the attention kernels' launches of (a)."""
  from xotorch_tpu_torch.ops.int4_matmul import int4_w4a8_matmul, int4_w4a16_matmul
  from xotorch_tpu_torch.ops.int8_matmul import int8_rowquant_matmul

  t0 = time.perf_counter()
  launches = dict(parallel_streams(torch, card, main_run, paged=False, device=device))
  launches.update(parallel_streams(torch, card, main_run, paged=True, device=device))
  parallel_cut(torch, card, device=device)
  parallel_cut(torch, card, paged=True, device=device)
  parallel_cut(torch, card, kv_quant=True, device=device)
  parallel_cut(torch, card, kv_quant=True, paged=True, device=device)
  # K5v4 and K6 quantize each position's activation slice with its own scale: twice the
  # exact kernels' limit, as phase 4 gives them against the CPU.
  for fmt, env, kernel in (("int4", {}, int4_w4a16_matmul), ("int4", {"XOT_INT4_V": "4"},
                                                             int4_w4a8_matmul),
                           ("int8", {"XOT_INT8_KERNEL": "1"}, int8_rowquant_matmul)):
    before = kernel.launches
    parallel_cut(torch, card, fmt=fmt, env=env, device=device,
                 limit=5e-2 if kernel is int4_w4a16_matmul else 1e-1)
    if kernel.launches - before < 7 * 2 * PARALLEL_TP * PARALLEL_CUT_STEPS:
      raise AssertionError(f"parallel cut {fmt}: {kernel.__name__} launched "
                           f"{kernel.launches - before} times")
  parallel_ring_prefill(torch, card, device=device)
  parallel_experts(torch, card, device=device)
  parallel_multihost(torch, device=device)
  print(f"[time] phase 23 (parallelism): {time.perf_counter() - t0:.1f} s", flush=True)
  return launches


# ------------------------------------------------------- phase 24: training over a mesh

MESH_TP = 2  # the tp width of phase 24's runs: both positions on the one card
MESH_LORA_ITERS, MESH_FULL_ITERS = 4, 2  # (a)'s steps: LoRA with a save at the last, full
MESH_STEP_REL = 0.5  # (b): a leaf after two AdamW steps against the unsharded cut's, over
                     # the unsharded cut's own change (AdamW's first steps move each element
                     # by about lr, its sign the gradient's: a bf16 gradient that rounds the
                     # other way at an element near 0 flips that element's step)
MESH_CUT_SEQ = 256  # (b) and (c): rows of the two-layer cut


def mesh_train_cli(torch, card: str, trained: dict, device: str = "cuda",
                   model: str = "synthetic-llama-1b") -> dict:
  """Phase 24 (a): main.py's train command with --serve-tp 2 (XOT_VIRTUAL_DEVICES=2: both
  positions on the one card) over phase 21's corpus: LoRA rank 8 for MESH_LORA_ITERS
  steps with a save at the last, then eval; a full fine-tune of MESH_FULL_ITERS steps.
  K1 = 2 x layers x forwards and K1b = 2 x layers x steps exactly; each loss within
  TRAIN_LOSS_REL of phase 21 (c)'s single-card loss at the same step (`trained`: the same
  batches, the same adapter draw); a fresh single-card engine that loads the save
  streams the tp engine's temperature-0 tokens, or parts at a near tie. Returns the
  launches."""
  import shutil
  import tempfile
  from xotorch_tpu_torch import main as port_main
  from xotorch_tpu_torch.api.chatgpt_api import build_prompt
  from xotorch_tpu_torch.models.registry import build_base_shard, build_full_shard, get_model_card
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  card_cfg = get_model_card(model)
  layers = card_cfg["layers"]
  words = min(TRAIN_WORDS, card_cfg["synthetic_config"]["vocab_size"] - 3)
  prompt = " ".join(f"w{3 + i % min(500, words)}" for i in range(300))
  env = {"XOT_VIRTUAL_DEVICES": str(MESH_TP), "XOT_SERVE_TP": str(MESH_TP)}
  launches = {"flash_attention": 0, "flash_attention_bwd": 0}
  root = tempfile.mkdtemp(prefix="xot-mesh-train-")

  def same_losses(tag, run, want_run, n):
    got = [l for _, l in run["losses"]]
    want = [l for _, l in want_run["losses"][:n]]
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    ok = len(got) == len(want) == n and rel <= TRAIN_LOSS_REL
    print(f"[mesh training] {tag}: losses {' '.join(f'{l:.5f}' for l in got)} against phase 21 "
          f"(c)'s single-card {' '.join(f'{l:.5f}' for l in want)}: {rel:.2e} (limit 2^-7) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
      raise AssertionError(f"mesh training {tag}: losses {got} against {want}")

  try:
    os.makedirs(os.path.join(root, "data"))
    data = write_training_corpus(os.path.join(root, "data"), words)
    ckpt = os.path.join(root, "ckpt")
    args = lambda iters, *extra: _train_args(model, device, data, "--iters", str(iters),
                                             "--serve-tp", str(MESH_TP), *extra)
    t0 = time.perf_counter()
    with word_ids():
      async def lora_body(node, engine, classname, api, a, run_train):
        run = await run_train()
        ctx = engine._contexts[build_full_shard(model, classname)]
        run["mesh"] = dict(ctx.mesh.shape) if ctx.mesh is not None else None
        before = flash_attention.launches
        run["eval"] = await port_main.eval_model_cli(node, classname, model, a)
        run["eval_launches"] = flash_attention.launches - before
        run["stream"] = await _stream_ids(api, model, prompt)
        return run
      lora = train_cli(torch, args(MESH_LORA_ITERS, "--lora-rank", "8", "--save-every",
                                   str(MESH_LORA_ITERS), "--save-checkpoint-dir", ckpt),
                       {"XOT_LR": TRAIN_LR["lora"], **env}, lora_body)
      for name, n in _report_run(f"{model} tp {MESH_TP} LoRA rank 8 (both positions on one card)",
                                 lora, card, MESH_TP * layers, MESH_LORA_ITERS,
                                 falling=False).items():
        launches[name] += n
      n_eval = 8 // TRAIN_BATCH
      ok = (lora["mesh"] == {"tp": MESH_TP} and lora["eval_launches"] == MESH_TP * layers * n_eval
            and math.isfinite(lora["eval"] or math.nan))
      print(f"[mesh training] mesh {lora['mesh']}; eval after LoRA: loss {lora['eval']:.4f} over "
            f"{n_eval} batches; K1 {lora['eval_launches']} = {MESH_TP} x {layers} x {n_eval} "
            f"{'ok' if ok else 'FAIL'}", flush=True)
      if not ok:
        raise AssertionError(f"mesh training eval: mesh {lora['mesh']}, loss {lora['eval']}, "
                             f"K1 {lora['eval_launches']}")
      launches["flash_attention"] += lora["eval_launches"]
      same_losses(f"tp {MESH_TP} LoRA", lora, trained["lora"], MESH_LORA_ITERS)
      save = os.path.join(ckpt, model, f"0-{layers - 1}-{MESH_LORA_ITERS}.safetensors")

      async def fresh_body(node, engine, classname, api, a, run_train):
        shard = build_base_shard(model, classname)
        await node.coordinate_resume(shard, save)
        got = await _stream_ids(api, model, prompt)
        full = build_full_shard(model, classname)
        ctx = engine._contexts[full]
        messages = [{"role": "user", "content": prompt}]
        ids = (await engine.encode(full, build_prompt(engine.tokenizer, messages))).tolist()
        await streams_agree(torch, engine, full, "tp 2 LoRA engine against a single-card engine "
                            "that loaded its step-4 save", ids, got, lora["stream"], card)
        return ctx.mesh
      with phase_env(XOT_VIRTUAL_DEVICES="0", XOT_SERVE_TP="0"):
        mesh = train_cli(torch, _train_args(model, device, data, "--lora-rank", "8"),
                         {"XOT_LR": TRAIN_LR["lora"]}, fresh_body)
      if mesh is not None:
        raise AssertionError(f"mesh training: the fresh engine was to serve on one card, got {mesh}")
      full = train_cli(torch, args(MESH_FULL_ITERS, "--save-every", "0"),
                       {"XOT_LR": TRAIN_LR["full"], **env})
      for name, n in _report_run(f"{model} tp {MESH_TP} full fine-tune (both positions on one card)",
                                 full, card, MESH_TP * layers, MESH_FULL_ITERS,
                                 falling=False).items():
        launches[name] += n
      same_losses(f"tp {MESH_TP} full fine-tune", full, trained["full"], MESH_FULL_ITERS)
    print(f"[time] phase 24 (a), main.py train --serve-tp {MESH_TP}: {time.perf_counter() - t0:.1f} s",
          flush=True)
  finally:
    shutil.rmtree(root, ignore_errors=True)
  return launches


def _cut_batch(torch, cfg, B: int, dev, seed: int):
  import numpy as np
  rng = np.random.default_rng(seed)
  T = MESH_CUT_SEQ
  x = rng.integers(3, cfg.vocab_size, size=(B, T + 1))
  lengths = np.array([T, 3 * T // 4, T // 2, T // 5][:B])
  return {k: torch.as_tensor(v, device=dev) for k, v in
          (("inputs", x[:, :-1]), ("targets", x[:, 1:]), ("lengths", lengths))}


def _cut_params(torch, model: str, dev, dtype):
  import dataclasses
  from xotorch_tpu_torch.models import transformer
  from xotorch_tpu_torch.models.config import config_from_hf_dict
  from xotorch_tpu_torch.models.registry import get_model_card
  cfg = dataclasses.replace(config_from_hf_dict(get_model_card(model)["synthetic_config"]),
                            num_layers=2)
  return cfg, transformer.init_random_params(cfg, 2, True, True, seed=0, dtype=dtype, device=dev)


def _clone_tree(tree):
  return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _grad_errors(torch, got, want) -> tuple:
  """(worst |got - want| / |want| over the leaves, its leaf); non-finite raises."""
  if not all(bool(torch.isfinite(g).all()) for g in got):
    raise AssertionError("mesh training: non-finite gradients")
  return max((((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item(), i)
             for i, (a, b) in enumerate(zip(got, want)))


@contextlib.contextmanager
def k1b_recorded(torch):
  """Every K1b call (ops/flash_attention.flash_attention_bwd, which the training forward's
  backward calls) recorded with its inputs and outputs; yields the list. Its launch
  count carries over."""
  from xotorch_tpu_torch.ops import flash_attention as fa
  real = fa.flash_attention_bwd
  calls = []

  def held(q, k, v, out, dout, lse=None, **kw):
    got = real(q, k, v, out, dout, lse, **kw)
    calls.append((q, k, v, dout, kw, got))
    return got
  held.launches = real.launches
  fa.flash_attention_bwd = held
  try:
    yield calls
  finally:
    real.launches = held.launches
    fa.flash_attention_bwd = real


def mesh_train_cut(torch, card: str, device: str = "cuda", model: str = "synthetic-llama-1b",
                   lr: float = 1e-3) -> None:
  """Phase 24 (b): a two-layer cut of `model` at full width in bf16 over dp 2 x tp 2 (four
  positions of the card) with ZeRO-1, B 4 of unequal lengths, T MESH_CUT_SEQ:
  - the gradients of the dp loss (each replica's masked sum over the global count),
    summed per block and reassembled, against the unsharded cut's on the card: each
    within TRAIN_GRAD_REL of its norm; the controls must miss it: one dp replica's
    gradient term dropped, and the loss divided per replica;
  - every per-shard K1b call of that backward (dp x tp x layers: Hq/tp heads over
    Hkv/tp) against flash_attention_bwd_ref in fp32 on its own inputs (dq, dk, dv each
    within BWD_REL of its largest |value|);
  - two AdamW steps (ZeRO-1's moments split over dp, the slices gathered back into the
    pieces) against the unsharded cut's: the losses within TRAIN_LOSS_REL, each leaf
    within MESH_STEP_REL of the unsharded cut's change;
  - the moment bytes position 0 holds against the replicated state's."""
  from xotorch_tpu_torch.models import transformer
  from xotorch_tpu_torch.ops.flash_attention import flash_attention_bwd_ref
  from xotorch_tpu_torch.parallel import (gather_params, make_mesh, moment_bytes_per_device,
                                          shard_params, zero1_constraint, zero1_shard_opt_state)
  from xotorch_tpu_torch.parallel.collectives import all_reduce
  from xotorch_tpu_torch.parallel.mesh import dp_rows
  from xotorch_tpu_torch.train import lora, step
  t0 = time.perf_counter()
  dev = torch.device(device)
  dtype = torch.bfloat16 if device == "cuda" else torch.float32
  cfg, plain = _cut_params(torch, model, dev, dtype)
  start = _clone_tree(plain)
  mesh = make_mesh({"dp": 2, "tp": MESH_TP}, [dev] * (2 * MESH_TP))
  mp = shard_params(_clone_tree(plain), mesh)
  b1, b2 = _cut_batch(torch, cfg, 4, dev, 24), _cut_batch(torch, cfg, 4, dev, 25)
  paths = [p for p, _ in lora.trainable_leaves(plain)]
  leaves = [t for _, t in lora.trainable_leaves(plain)]
  names = ["/".join(p) for p in paths]
  _, want = step.value_and_grad(lambda: step.full_model_loss(plain, b1, cfg), leaves)
  with k1b_recorded(torch) as calls:
    _, got = step.mesh_value_and_grad(lambda: step.full_model_loss(mp, b1, cfg), mp, paths)
  count = step.unmasked_count(b1["lengths"], MESH_CUT_SEQ)

  def replica_terms(per_replica_mean: bool):
    outs = transformer.forward_replicas(mp, b1["inputs"], cfg, True, True, route=step.TRAIN_ROUTE)
    rows = zip(outs, dp_rows(b1["targets"], mesh), dp_rows(b1["lengths"], mesh))
    if per_replica_mean:
      return [step.masked_ce_loss(o, t, n) / len(outs) for o, t, n in rows]
    return [step.masked_ce_sum(o, t, n) / count.to(o.device) for o, t, n in rows]
  _, dropped = step.mesh_value_and_grad(lambda: replica_terms(False)[0], mp, paths)
  _, per_replica = step.mesh_value_and_grad(
    lambda: all_reduce(replica_terms(True), [dev])[0], mp, paths)
  err, worst = _grad_errors(torch, got, want)
  errs = {label: _grad_errors(torch, g, want)[0] for label, g in
          (("one dp replica's term dropped", dropped), ("the loss divided per replica", per_replica))}
  ok = err <= TRAIN_GRAD_REL and all(e > TRAIN_GRAD_REL for e in errs.values())
  print(f"[mesh training] 2-layer {model} cut over dp 2 x tp {MESH_TP}, B=4 T={MESH_CUT_SEQ} "
        f"(lengths {b1['lengths'].tolist()}): worst gradient error {err:.3e} of its norm "
        f"({names[worst]}; limit {TRAIN_GRAD_REL:g}) against the unsharded cut's; controls "
        + ", ".join(f"{k}: {e:.3e} ({'caught' if e > TRAIN_GRAD_REL else 'NOT caught'})"
                    for k, e in errs.items()) + f" {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"mesh training cut: gradient error {err} or a control passed {errs}")
  worst_k1b = 0.0
  for q, k, v, dout, kw, grads in calls:
    ref = flash_attention_bwd_ref(q.float(), k.float(), v.float(), dout.float(), **kw)
    for g, r in zip(grads, ref):
      e = (g.float() - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
      worst_k1b = max(worst_k1b, e if math.isfinite(e) else math.inf)
  want_calls = 2 * MESH_TP * cfg.num_layers
  heads = {(q.shape[2], k.shape[2]) for q, k, *_ in calls}
  ok = len(calls) == want_calls and worst_k1b <= BWD_REL and (
    not calls or heads == {(cfg.num_heads // MESH_TP, cfg.num_kv_heads // MESH_TP)})
  print(f"[mesh training] per-shard K1b calls: {len(calls)} (dp 2 x tp {MESH_TP} x "
        f"{cfg.num_layers} layers = {want_calls}) on (Hq, Hkv) {sorted(heads)}, worst dq/dk/dv "
        f"error {worst_k1b:.3e} of its largest |value| (limit 2^-6) {'ok' if ok else 'FAIL'}",
        flush=True)
  if not ok:
    raise AssertionError(f"mesh training cut: K1b calls {len(calls)}, error {worst_k1b}")
  del got, want, dropped, per_replica, calls

  opt = lora.optimizer_for(mp, lr)
  repl_bytes = moment_bytes_per_device(opt)
  opt = zero1_shard_opt_state(opt, mesh)
  zstep = step.make_train_step(cfg, opt, opt_sharding_fn=zero1_constraint(mesh))
  pstep = step.make_train_step(cfg, lora.optimizer_for(plain, lr))
  losses = [(float(zstep(mp, b)), float(pstep(plain, b))) for b in (b1, b2)]
  zero_bytes = moment_bytes_per_device(opt)
  flat_got, flat_want, flat_start = (dict(step.leaf_paths(t)) for t in (gather_params(mp), plain, start))
  step_err, step_leaf = max((((flat_got[p].float() - flat_want[p].float()).norm()
                              / (flat_want[p].float() - flat_start[p].float()).norm().clamp(min=1e-30)).item(),
                             "/".join(p)) for p in flat_want)
  loss_err = max(abs(a - b) / abs(b) for a, b in losses)
  split = any("dp" in s for s in opt.moment_specs)
  ok = (loss_err <= TRAIN_LOSS_REL and step_err <= MESH_STEP_REL and split
        and zero_bytes * 2 <= repl_bytes)
  print(f"[mesh training] two AdamW steps (lr {lr:g}) with ZeRO-1: losses "
        f"{' '.join(f'{a:.5f}/{b:.5f}' for a, b in losses)} (sharded/unsharded, {loss_err:.2e}, limit "
        f"2^-7); worst leaf {step_err:.3e} of the unsharded cut's change ({step_leaf}; limit "
        f"{MESH_STEP_REL:g}); moments split over dp: {split}; moment bytes at position 0 "
        f"{zero_bytes} against the replicated state's {repl_bytes} "
        f"({zero_bytes / max(repl_bytes, 1):.3f}x) {'ok' if ok else 'FAIL'} ({card})", flush=True)
  if not ok:
    raise AssertionError(f"mesh training ZeRO-1 steps: losses {losses}, leaf {step_err}, bytes "
                         f"{zero_bytes}/{repl_bytes}")
  print(f"[time] phase 24 (b), the dp x tp cut: {time.perf_counter() - t0:.1f} s", flush=True)


def mesh_ring_cut(torch, card: str, device: str = "cuda", model: str = "synthetic-llama-1b") -> None:
  """Phase 24 (c): the two-layer cut trained sequence-parallel over sp 2 (ring attention
  over the fresh K/V chunks, no cache): the loss within TRAIN_LOSS_REL and each gradient
  within TRAIN_GRAD_REL of its norm of one device's (K1 and K1b); the control, the last
  rotation's fold dropped, must miss."""
  from xotorch_tpu_torch.parallel import make_mesh, shard_params
  from xotorch_tpu_torch.train import lora, step
  t0 = time.perf_counter()
  dev = torch.device(device)
  dtype = torch.bfloat16 if device == "cuda" else torch.float32
  cfg, plain = _cut_params(torch, model, dev, dtype)
  mesh = make_mesh({"sp": 2}, [dev] * 2)
  mp = shard_params(_clone_tree(plain), mesh)
  b = _cut_batch(torch, cfg, 2, dev, 26)
  paths = [p for p, _ in lora.trainable_leaves(plain)]
  names = ["/".join(p) for p in paths]
  want_loss, want = step.value_and_grad(lambda: step.full_model_loss(plain, b, cfg),
                                        [t for _, t in lora.trainable_leaves(plain)])
  ring = lambda: step.full_model_loss(mp, b, cfg, ring_mesh=mesh)
  loss, got = step.mesh_value_and_grad(ring, mp, paths)
  with ring_folds_dropped(torch):
    _, control = step.mesh_value_and_grad(ring, mp, paths)
  err, worst = _grad_errors(torch, got, want)
  control_err, _ = _grad_errors(torch, control, want)
  loss_err = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
  ok = loss_err <= TRAIN_LOSS_REL and err <= TRAIN_GRAD_REL and control_err > TRAIN_GRAD_REL
  print(f"[mesh training] 2-layer {model} cut over sp 2 (ring attention, B=2 T={MESH_CUT_SEQ}): "
        f"loss {loss.item():.5f} against one device's {want_loss.item():.5f} ({loss_err:.2e}, limit "
        f"2^-7); worst gradient error {err:.3e} of its norm ({names[worst]}; limit "
        f"{TRAIN_GRAD_REL:g}); control, the last rotation's fold dropped: {control_err:.3e} "
        f"({'caught' if control_err > TRAIN_GRAD_REL else 'NOT caught'}) {'ok' if ok else 'FAIL'} "
        f"({card})", flush=True)
  if not ok:
    raise AssertionError(f"mesh training sp: loss {loss_err}, gradient {err}, control {control_err}")
  print(f"[time] phase 24 (c), the sp cut: {time.perf_counter() - t0:.1f} s", flush=True)


def mesh_adapters(torch, card: str, adapter_streams: dict, device: str = "cuda",
                  model: str = "synthetic-llama-1b") -> dict:
  """Phase 24 (d): `main.py --serve-tp 2 --adapters ad1=...` (phase 20's ad1, written
  again from its seed) answers the main path's first request for @ad1; K1 and K2 are 2 x
  the single-card formula; @ad1's greedy stream of phase 20's common prompt equals phase
  20's single-card stream, or parts at a near tie. Returns the launches."""
  import shutil
  import tempfile
  from xotorch_tpu_torch.models.registry import build_full_shard, get_model_card
  layers = get_model_card(model)["layers"]
  ad1 = f"{model}@ad1"
  root = tempfile.mkdtemp(prefix="xot-mesh-adapters-")
  try:
    path = write_adapters(torch, root, model)["ad1"]
    adapters = f"ad1={path}"

    async def after(engine, node, api, base):
      shard = build_full_shard(ad1, type(engine).__name__)
      got = await kv_generate(engine, "mesh-ad1", adapter_streams["ids"], 32, shard)
      ctx = engine._contexts[shard]
      await streams_agree(torch, engine, shard, f"tp {MESH_TP} {ad1} against phase 20's single-card "
                          f"stream", adapter_streams["ids"], adapter_streams[ad1], got, card)
      return dict(ctx.mesh.shape) if ctx.mesh is not None else None
    env = {"XOT_VIRTUAL_DEVICES": str(MESH_TP), "XOT_SERVE_TP": str(MESH_TP), **ADAPTER_ENV}
    body = [(f"512-word prompt -> {ad1}", {**main_requests(model)[0][1], "model": ad1})]
    with phase_env(XOT_ADAPTERS=adapters):
      run = drive_main_path(torch, card, device=device, model=model, env=env, tag="mesh adapters",
                            profiles=(), cli=("--serve-tp", str(MESH_TP), "--adapters", adapters),
                            requests=body, after=after)
  finally:
    shutil.rmtree(root, ignore_errors=True)
  want = {k: MESH_TP * n for k, n in contiguous_want(run, layers).items()}
  ok = run["launches"] == want and run["after"] == {"tp": MESH_TP}
  print(f"[mesh adapters] {ad1} over mesh {run['after']}: launches {run['launches']} against "
        f"{MESH_TP} x the single-card formula {want} ({run['steps']} decode steps); "
        f"{'; '.join(run['timings'])} ({card}) {'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"mesh adapters: launches {run['launches']}, wanted {want}; mesh {run['after']}")
  return dict(run["launches"])


def check_mesh_training(torch, card: str, trained: dict, adapter_streams: dict,
                        device: str = "cuda", model: str = "synthetic-llama-1b") -> dict:
  """Phase 24: training over meshes of the one card (every position repeats it: the
  sharded training math and the per-shard K1/K1b calls at full width, not scaling).
  Returns the launches of (a) and (d), the phase's main paths."""
  t0 = time.perf_counter()
  launches = dict(mesh_train_cli(torch, card, trained, device=device, model=model))
  mesh_train_cut(torch, card, device=device, model=model)
  mesh_ring_cut(torch, card, device=device, model=model)
  for name, n in mesh_adapters(torch, card, adapter_streams, device=device, model=model).items():
    launches[name] = launches.get(name, 0) + n
  print(f"[time] phase 24 (training over a mesh): {time.perf_counter() - t0:.1f} s; launches "
        f"{launches} ({card})", flush=True)
  return launches


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--kernels-only", action="store_true",
                      help="stop after holding the kernels against their plain versions")
  parser.add_argument("--yardsticks", action="store_true",
                      help="also time the compiled flex_attention yardsticks of the softcapped "
                           "and windowed cases (their library_ms; seconds a case)")
  args = parser.parse_args(argv)
  global YARDSTICKS
  YARDSTICKS = args.yardsticks

  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
    return 2
  if not os.path.isdir(os.path.join(ROOT, "xotorch_tpu_torch", "csrc")):
    print(f"chip_smoke: no xotorch_tpu_torch package beside {__file__}", file=sys.stderr)
    return 2
  sys.path.insert(0, ROOT)

  # Phase 1: device.
  started = time.perf_counter()
  card = smi_line()
  print(card, flush=True)
  print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  set_peaks(torch.cuda.get_device_name(0))
  print(f"peaks: {PEAK_BF16_FLOPS / 1e12:g} TFLOP/s bf16, {PEAK_INT8_OPS / 1e12:g} TOP/s int8, "
        f"{PEAK_HBM_BYTES / 1e12:g} TB/s HBM", flush=True)

  # Phase 2: build.
  from xotorch_tpu_torch.ops import _build
  secs = _build.load_all(verbose=True)
  print(f"build: {secs:.1f} s for {', '.join(_build.KERNELS)}", flush=True)

  # Phase 3: kernels against their plain versions.
  results: dict = {}
  check_kernels(torch, results)
  check_quant_kernels(torch, results)
  check_gemma_kernels(torch)
  check_family_kernels(torch)
  print(f"[time] phases 1-3: {time.perf_counter() - started:.1f} s", flush=True)
  if args.kernels_only:
    check_training_kernels(torch, results)
    print(f"kernels ok on {card}", flush=True)
    return 0

  # Phases 4-15 run as they did before the prefix cache and co-scheduled prefill were
  # ported: their launch formulas and readings assume cold one-call prefills (their
  # requests repeat prompts). Phase 16 runs the defaults.
  before_kv_reuse = contextlib.ExitStack()
  before_kv_reuse.enter_context(phase_env(XOT_PREFIX_CACHE="0", XOT_PREFILL_COSCHED="0"))

  # Phase 4: the model through the kernels against the plain path.
  check_model(torch)
  check_paged_model(torch)
  check_int8_kv_model(torch)
  for fmt, env, kernel, _ in quant_phases():
    # force: the card's decode rows through the kernel, the CPU's through its plain
    # version. K5v4 and K6 quantize their activations to int8, bf16 ones on the card
    # and fp32 ones on the CPU: a value near a step of the int8 grid takes another
    # code on each side, an error of max|a|/127 where bf16 alone rounds at 2^-9 of
    # the value. Rounding the CPU's activations to bf16 first did not narrow it
    # (PERF.md), so their cuts get twice the exact kernels' limit; the kernel calls
    # themselves are held at 2^-7 and the control reads far above the limit.
    knob = "XOT_INT4_KERNEL" if fmt == "int4" else "XOT_INT8_KERNEL"
    a8 = kernel.__name__ != "int4_w4a16_matmul"
    check_model(torch, fmt, {**env, knob: "force"}, kernel, limit=1e-1 if a8 else 5e-2)

  print(f"[time] phases 1-4: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 5: the main path, with the launch counters read around it.
  main_run = drive_main_path(torch, card, focus="flash_cached_")
  launches = dict(main_run["launches"])
  k1, k2 = launches["flash_attention"], launches["flash_cached_attention"]
  if k1 < 3 * 16 or k2 < 16 * main_run["decoded"]:
    raise AssertionError(f"main: kernel launches too few (K1 {k1}, K2 {k2})")

  print(f"[time] phases 1-5: {time.perf_counter() - started:.1f} s", flush=True)

  # Phases 6 and 7: eight concurrent requests on the page pool (K4 prefill, K3
  # decode), then on stacked contiguous caches (K1/K2).
  paged = drive_concurrent(torch, card, paged=True)
  launches.update((k, paged["launches"][k])
                  for k in ("paged_decode_attention", "paged_prefill_attention"))
  contiguous = drive_concurrent(torch, card, paged=False)
  same = total = 0
  for words, toks in paged["greedy"].items():
    other = contiguous["greedy"][words]
    same += sum(a == b for a, b in zip(toks, other))
    total += len(toks)
  print(f"[concurrent] temperature-0 tokens the paged and contiguous phases agree on: "
        f"{same}/{total} = {100 * same / max(total, 1):.1f}% (bf16: streams may part at a "
        f"near-tie; not asserted)", flush=True)

  print(f"[time] phases 1-7: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 8: quantized serving. Fresh servers under XOT_QUANTIZE answer the main
  # path's three requests through K5, K5v4 and K6 (launches = 7 x 16 x decode steps),
  # then the int8 default path (no kernel) runs in the engine alone.
  rates = {"bf16": {**main_run["profiles"], 8: contiguous["profile"]}}
  for fmt, env, kernel, focus in quant_phases():
    run = drive_quantized(torch, card, fmt, env, kernel, focus)
    launches.update(run["launches"])
    rates[f"{fmt} {kernel.__name__}"] = run["profiles"]
  rates["int8 default path"] = drive_engine_alone(
    torch, card, {"XOT_QUANTIZE": "int8", "XOT_INT8_KERNEL": "0"}, "int8 default path")
  for label, prof in rates.items():
    cells = ", ".join(f"B={b}: {p['tok_s']:.1f} tok/s ({p['step_ms']:.2f} ms a step, "
                      f"{100 - p['busy_pct']:.1f}% idle, kernel {p['focus_pct']:.1f}%)"
                      for b, p in prof.items() if p)
    print(f"[quantized] {label}: {cells or 'not measured'} ({card})", flush=True)
  # The concurrent paged phase's eight requests with int4 weights: K4 prefill, K3
  # decode and K5 on several live rows and pad rows of the page pool.
  from xotorch_tpu_torch.ops.int4_matmul import int4_w4a16_matmul
  drive_concurrent(torch, card, paged=True, env={"XOT_QUANTIZE": "int4"},
                   quant_kernel=int4_w4a16_matmul)
  # Where a quantized step's host time goes: one projection's host cost by route,
  # then the formats' B=1 steps taken in turn.
  projection_host_us(torch, card)
  alternate_formats(torch, card)

  print(f"[time] phases 1-8: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 9: the int8 KV cache. A fresh server with --kv-quantize int8 answers the main
  # path's three requests: K1 for each fresh prefill (over the fresh K/V), K2q for every
  # decode step and for the 1502-token prompt's second segment, no K2. Then the engine
  # alone decodes 32 steps at B=1 and B=8 under the profiler, and the eight concurrent
  # requests run on an int8 page arena (K4q prefill, K3q decode).
  from xotorch_tpu_torch.ops.flash_attention import flash_attention
  from xotorch_tpu_torch.ops.flash_decode import flash_cached_attention, flash_cached_attention_int8
  kv = drive_main_path(torch, card, kernels=(flash_attention, flash_cached_attention,
                                             flash_cached_attention_int8),
                       tag="int8 kv", profiles=(1, 8), focus="flash_cached_",
                       cli=("--kv-quantize", "int8"))
  counted = kv["launches"]
  want = {"flash_attention": 16 * 3, "flash_cached_attention": 0,
          "flash_cached_attention_int8": 16 * (kv["steps"] + 1)}
  ok = counted == want and kv["steps"] >= kv["decoded"]
  print(f"[int8 kv] launches {counted}: K1 = 16 layers x 3 fresh prefills, K2q = 16 x "
        f"({kv['steps']} decode steps + 1 segment at pos > 0), no K2 ({want}) "
        f"{'ok' if ok else 'FAIL'}", flush=True)
  if not ok:
    raise AssertionError(f"int8 kv: launches {counted}, wanted {want}")
  launches["flash_cached_attention_int8"] = counted["flash_cached_attention_int8"]
  same = total = 0
  for i, body in enumerate(main_requests("synthetic-llama-1b")):
    if body[1].get("temperature") == 0:
      a, b = main_run["tokens"][i], kv["tokens"][i]
      same += sum(x == y for x, y in zip(a, b))
      total += max(len(a), len(b))
  print(f"[int8 kv] temperature-0 tokens the int8-KV server shares with the bf16 main path: "
        f"{same}/{total} = {100 * same / max(total, 1):.1f}% (not asserted)", flush=True)
  for label, prof in (("bf16 KV", rates["bf16"]), ("int8 KV", kv["profiles"])):
    cells = ", ".join(f"B={b}: {p['device_ms']:.3f} device ms a step, {p['kernels_per_step']:.0f} "
                      f"kernels a step, {100 - p['busy_pct']:.1f}% idle, {p['step_ms']:.2f} wall ms"
                      for b, p in sorted(prof.items()) if p)
    print(f"[int8 kv] {label}: {cells or 'not measured'} ({card})", flush=True)
  # K2q replaces K2 one for one, so the kernels a step int8 KV adds are its writes':
  # the quantizer's eager ops and two more copies a layer.
  added = {b: kv["profiles"][b]["kernels_per_step"] - rates["bf16"][b]["kernels_per_step"]
           for b in (1, 8) if kv["profiles"].get(b) and rates["bf16"].get(b)}
  print(f"[int8 kv] quantize on write: {added} more device kernels a step than bf16 KV "
        f"({card})", flush=True)
  paged8 = drive_concurrent(torch, card, paged=True, env={"XOT_KV_QUANT": "int8"})
  launches.update((k, paged8["launches"][k])
                  for k in ("paged_decode_attention_int8", "paged_prefill_attention_int8"))
  print(f"[int8 kv] page arena bytes per token: int8 {paged8['bytes_per_token']:.0f} against bf16 "
        f"{paged['bytes_per_token']:.0f} ({card})", flush=True)

  print(f"[time] phases 1-9: {time.perf_counter() - started:.1f} s", flush=True)

  # Phases 10 and 11: the token ring. Two peers hold half the layers each and pass
  # bf16 hidden states over TCP, first as two Nodes in this process (launches counted
  # over both engines, every hop's dtype and size read), then as two processes started
  # the way a user starts them; both must stream the main path's temperature-0 tokens.
  per_token = drive_ring_inprocess(torch, card, main_run)
  fused = drive_ring_fused(torch, card, main_run, per_token)
  launches["flash_attention"] += sum(f["launches"]["flash_attention"] for f in fused.values())
  launches["flash_cached_attention"] += sum(f["launches"]["flash_cached_attention"]
                                            for f in fused.values())
  drive_ring_processes(torch, card, main_run)

  print(f"[time] phases 1-11: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 12: gemma-2-2b from an HF checkpoint on disk, at full width and depth: its
  # attention kernels' launches join the main path's in the results line.
  for name, n in drive_gemma(torch, card).items():
    launches[name] += n

  # Phase 13: the fused decode programs (CUDA graphs) against the eager body, their
  # timing, and the scan prefill against the per-segment loop.
  print(f"[time] phases 1-12: {time.perf_counter() - started:.1f} s", flush=True)
  check_fused(torch, card)

  # Phase 14: OpenAI's sampling extras through the API, the engine and the decode graphs;
  # its attention launches join the results line.
  for name, n in check_sampling_extras(torch, card)["launches"].items():
    launches[name] += n
  print(f"[time] phases 1-14: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 15: the observability layer on a fresh server; its main-path launches join the
  # results line.
  for name, n in check_observability(torch, card).items():
    launches[name] += n
  print(f"[time] phases 1-15: {time.perf_counter() - started:.1f} s", flush=True)
  before_kv_reuse.close()

  # Phase 16: KV reuse and prefill scheduling with the default knobs; its attention
  # launches join the results line.
  for name, n in check_kv_reuse(torch, card)["launches"].items():
    launches[name] += n
  print(f"[time] phases 1-16: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 17: the ring's survivability (watchdog, health monitor, eviction, restarts) in
  # two child processes under injected faults and a real SIGKILL.
  check_survivability(torch, card, main_run)
  print(f"[time] phases 1-17: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 18: the decode paths besides the plain chunk: two resident models, overlapped
  # chunks and speculative decoding; its attention launches join the results line.
  for name, n in check_decode_paths(torch, card)["launches"].items():
    launches[name] += n
  print(f"[time] phases 1-18: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 19: the MoE and vision families from seeded checkpoints at their published
  # widths; their attention and K6 launches join the results line.
  for name, n in check_families(torch, card).items():
    launches[name] = launches.get(name, 0) + n
  print(f"[time] phases 1-19: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 20: multi-LoRA serving (adapter cuts against the CPU, main.py --adapters, the
  # paged streams, an adapter over int4); its attention and K5 launches join the line.
  adapter_streams: dict = {}
  for name, n in check_adapters(torch, card, streams=adapter_streams).items():
    launches[name] += n
  print(f"[time] phases 1-20: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 21: training (K1b, the cut's gradients, main.py train and eval, the ring);
  # its K1 and K1b launches join the results line.
  trained: dict = {}
  for name, n in check_training(torch, card, results, runs=trained).items():
    launches[name] = launches.get(name, 0) + n
  print(f"[time] phases 1-21: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 22: the front door (the router over three replica processes: the KV fabric,
  # prefill/decode chaining, failover and respawn); the replicas' K1-K4 launches join the
  # results line.
  for name, n in check_front_door(torch, card)["launches"].items():
    launches[name] += n
  print(f"[time] phases 1-22: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 23: tensor, sequence and expert parallelism over meshes of the one card, and the
  # multihost seam; the tp servers' K1-K4 launches join the results line.
  for name, n in check_parallel(torch, card, main_run).items():
    launches[name] += n
  print(f"[time] phases 1-23: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 24: training over meshes of the one card; the tp runs' K1, K1b and K2 launches
  # join the results line.
  for name, n in check_mesh_training(torch, card, trained, adapter_streams).items():
    launches[name] = launches.get(name, 0) + n
  print(f"[time] phases 1-24: {time.perf_counter() - started:.1f} s", flush=True)

  # Phase 25: results.
  meta = {
    "flash_attention": ("xotorch_tpu_torch/csrc/flash_attention.cu",
                        "xotorch_tpu/ops/flash_attention.py:54"),
    "flash_cached_attention": ("xotorch_tpu_torch/csrc/flash_decode.cu",
                               "xotorch_tpu/ops/flash_decode.py:62"),
    "paged_decode_attention": ("xotorch_tpu_torch/csrc/paged_attention.cu",
                               "xotorch_tpu/ops/paged_attention.py:129"),
    "paged_prefill_attention": ("xotorch_tpu_torch/csrc/paged_attention.cu",
                                "xotorch_tpu/ops/paged_attention.py:276"),
    "int4_w4a16_matmul": ("xotorch_tpu_torch/csrc/quant_matvec.cu",
                          "xotorch_tpu/ops/int4_matmul.py:46"),
    "int4_w4a8_matmul": ("xotorch_tpu_torch/csrc/quant_matvec.cu",
                         "xotorch_tpu/ops/int4_matmul.py:122"),
    "int8_rowquant_matmul": ("xotorch_tpu_torch/csrc/quant_matvec.cu",
                             "xotorch_tpu/ops/int8_matmul.py:43"),
    "flash_cached_attention_int8": ("xotorch_tpu_torch/csrc/flash_decode.cu",
                                    "xotorch_tpu/ops/flash_decode.py:62 (quant=True)"),
    "paged_decode_attention_int8": ("xotorch_tpu_torch/csrc/paged_attention.cu",
                                    "xotorch_tpu/ops/paged_attention.py:129 (quant=True)"),
    "paged_prefill_attention_int8": ("xotorch_tpu_torch/csrc/paged_attention.cu",
                                     "xotorch_tpu/ops/paged_attention.py:276 (quant=True)"),
    "flash_attention_bwd": ("xotorch_tpu_torch/csrc/flash_attention_bwd.cu",
                            "xotorch_tpu/train/step.py:84 (jax.grad of ops/attention.py:18 "
                            "gqa_attention; no Pallas kernel)"),
  }
  kernels = []
  for name, (source, replaces) in meta.items():
    r = results[name]
    kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
  print(json.dumps({"kernels": kernels}), flush=True)
  print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
