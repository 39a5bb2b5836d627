#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU and the CUDA
toolkit (``nvcc``). Phases, each fatal on failure (non-zero exit):

1. device and build: print ``nvidia-smi``'s name and power limit, build
   every CUDA kernel of the path from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once);
2. kernels against their plain PyTorch versions on the card, at the main
   path's shapes: ``w4a8_matmul`` bitwise at M in {1, slots, 8, 20, the
   route threshold - 1 and itself, 37, 128, one prefill batch (512), 513}
   for every linear of qwen2.5-3b with and without bias and every linear
   of xlstm-125m (K 768, 1024, 1536; N down to 8), by the launcher's own
   route and by each route (decode, tensor cores) forced, and rows alone
   bitwise equal to the same rows inside M = 512;
   ``kvq_decode_attn`` within one bf16 ulp on ragged lengths, on lengths
   around the split-KV kernel's split and group boundaries (with an empty
   row, exactly zero) and at a long cache (32768, 20000, 8192, 1), bitwise
   equal there to ``kvq_paged_decode_attn`` on the same K/V scattered
   into a pool (bs 64, shuffled table), each row bitwise equal alone and
   in a batch of 4;
   ``kvq_paged_decode_attn`` within one bf16 ulp at block sizes 64 and 16
   on shuffled tables with sentinels and a parked row, on lengths around
   its split and group boundaries and at a long cache (32768, 20000,
   8192, 1), each row bitwise equal alone and in a batch of 4;
   ``gather_dequant_paged_kv`` bitwise, one leaf a launch and K and V
   in one launch (as the tail-wave calls it), at the tail-wave's shape
   and at shapes ragged against its tiling (one entry of 16 tokens,
   sentinel entries and an all-sentinel row, a 512-entry table of 32k
   tokens);
   ``pool_block_copy`` bitwise, one leaf a launch and the four pool
   leaves of the paged phase in one launch (as the engine's COW calls
   it) at 1, 2 and 7 pairs, with padding pairs and clamped sources;
   ``kvq_spec_verify_attn`` within one bf16 ulp at both block sizes, on
   windows across split boundaries and ending at the long cache, each
   query bitwise equal to ``kvq_paged_decode_attn`` at its length; the
   three split-KV launchers refuse scratch one element short;
   ``rms_norm`` bitwise across row counts; ``fake_quant_fwd`` and the
   ``dx`` of ``fake_quant_bwd`` bitwise at bits 4 and 8 on every weight
   shape of qwen2.5-3b (the tied head per vocab row), two activation
   shapes per tensor and shapes ragged against the backward's tiling (R
   one past a row band, C not a multiple of 8, an x not 16-byte
   aligned), its ``ds`` within 1e-4 of its sums' mass and bitwise equal
   from call to call, a workspace one element short refused;
   ``flash_attn_fwd`` against its plain version and an f64 oracle at the
   QAT shape, the PTQ phase's (B 8, S 64), S 1024, a ragged S and a
   sliding window (and at head dim
   64: the QAT shape, the ragged S, the window); ``slstm_scan``
   against its plain version and an f64 oracle on each route forced
   (resident, step) at xlstm-125m's width (B 8, T 128; a ragged B 3,
   T 100; B 11, T 37: two batch tiles) and at d 200 and 202, bitwise
   from call to call and for a row alone against the same row in the
   batch, the launcher's own route equal to the resident one, one
   kernel a call on the resident route (``torch.profiler``), a barrier
   scratch too short refused; and in ``carry="gx"`` (the reference's
   cell, which the QAT teacher runs) on each route at the same shapes,
   within 2x the plain version's own gap when its dot is summed in f64
   or in halves (share of hs differing, bf16 steps, cT), hs within one
   bf16 step at T <= 16, bitwise call to call and row alone vs batch;
   at recurrentgemma-2b's shapes (D 256, 10 query heads on 1 KV head)
   and the reduced configs' D 16, on int8 and on bf16 (C16) caches (and
   bf16 at qwen's D 128, G 8): ``kvq_decode_attn`` within one bf16 ulp
   over a full 2048-token ring, an empty row (zero) and ragged lengths,
   and around the split boundaries, bitwise equal to
   ``kvq_paged_decode_attn`` on the same K/V in a pool and for each row
   alone; ``kvq_spec_verify_attn``'s 5 queries within one ulp and each
   bitwise paged decode at its length; the gather bitwise;
   ``flash_attn_fwd`` at D 256, H 10, Hkv 1 (the QAT shape under the
   2048 window, a ragged S, S 4096 under the window) and at D 16 (qwen's
   and recurrentgemma's reduced heads) against plain and the oracle;
   at mixtral-8x7b's shapes: ``fake_quant_fwd`` and the ``dx`` of
   ``fake_quant_bwd`` in mode 3 (an expert bank (e, d_in, d_out) with
   (e, 1, d_out) scales, one launch a bank) bitwise at bits 4 and 8 on
   the banks (8, 4096, 14336) and (8, 14336, 4096) and on ragged banks
   ((3, 100, 70), (2, 33, 8), (3, 65, 264), an x not 16-byte aligned),
   ``ds`` within 1e-4 of its sums' mass and bitwise call to call, a
   mode-3 workspace one short refused; ``w4a8_matmul`` bitwise on its
   linears (K 4096 into N 4096, 1024, 8 and 32000) at M 1, 4, 23, 24 and
   512 by each route; ``kvq_decode_attn`` at D 128, G 4 over a full
   4096-row ring, an empty row and ragged lengths (as for D 256 above);
   ``flash_attn_fwd`` at H 32, Hkv 8, D 128 at the QAT shape under the
   4096 window and at S 8192 under it (the first and last 1024 query
   rows held to plain and the oracle on the keys they see);
   at moonshot-v1-16b-a3b's, qwen3-14b's, qwen3-32b's and qwen2-7b's
   shapes: ``w4a8_matmul`` bitwise on every distinct packed linear (K
   5120 into N 8192 and back, K 3584 into N 512 with a bias, the MLPs'
   17408, 18944 and 25600 and back, the router at N 64, the heads at N
   151936, 152064 and 163840) at M 1, 4, 23, 24 and 512 by each route;
   at D 128 and GQA groups 1 (16 KV heads), 5, 7 and 8 the dense and
   paged decode, verify and gather checks above, on ragged lengths and
   around the split and group boundaries; the gather and the four-leaf
   COW at moonshot's pool (16 KV heads, 48 layers); ``flash_attn_fwd``
   at G 1 (H 16) and G 5 (H 40, Hkv 8) at (8, 128) against plain and the
   oracle; fake-quant mode 3 bitwise on the 64-expert banks (64, 2048,
   1408) and (64, 1408, 2048) at bits 4 and 8, ds within 1e-4;
   at whisper-large-v3's and qwen2-vl-2b's shapes: ``w4a8_matmul``
   bitwise on every distinct packed linear (whisper's K 1280 into N 1280,
   5120 with a bias and back, the tied head at N 51866, a partial last
   column tile; qwen2-vl's q, k, v with biases, k and v at N 256, the
   MLP's 8960 and back, the head at N 151936) at M 1, 4, 23, 24 and 512
   by each route, and the encoder's linears at M 6000; the dense and
   paged decode, verify and gather checks at D 64, G 1 (four full
   1500-row cross caches, ragged rows with an empty one, the split
   boundaries) and at D 128, G 6; ``flash_attn_fwd`` without causality
   at the encoder's (4, 1500) and the cross shape (Sq 128, Skv 1500),
   and at Sq 1 / 128 / 1500 against Skv 1 / 65 / 1500, and causal at G
   6 (8, 384), against plain and the oracle; fake-quant fwd and dx
   bitwise on both archs' weights (the tied heads per row);
3. serve: ``ServeEngine`` on ``cuda`` with qwen2.5-3b at full width
   (random weights from a seed), policy A8d-C8-W4, w4a8 weights, dense
   KV cache; 8 mixed-length requests through 4 slots, both kernels'
   launch counts > 0, every request finished, tokens in the vocabulary;
   one decode step's logits against the same engine on the plain
   versions; then one prompt prefilled alone and in a wave of 4: its
   cache and first-token logits bitwise the same (cold-prefill batch
   invariance), under the w4a8 layout and under bf16 (the serve CLI's
   default; fresh bf16 weights);
3b. paged serve: the same model on the paged pool (4 slots, blocks of
   64, 32 blocks, prefix cache on); 8 requests sharing a 160-token prefix,
   so prefix hits, copy-on-write of the split block and tail-waves all
   happen; the three paged kernels' launch counts > 0 and the dense decode
   kernel's 0, one multi-leaf copy launch per COW event and no one-leaf
   copy; one decode step's logits paged vs dense and kernels vs plain
   versions;
3c. spec serve: the paged phase's requests with speculative decoding at
   the CLI's defaults (k = 4, an 18-layer draft, exact mode); the verify
   kernel and the draft's dense decode kernel launch, the paged decode
   kernel does not, and every stream (12 new tokens) equals the start of
   3b's;
3t, 3u. tensor-parallel serving, ranks in processes of their own on the
   one card (``launch.mesh.spawn_tp``, backend gloo, named: NCCL refuses
   two ranks on one device), one spawn for the passes of one tp, whose
   ranks take them in turn, each building the pass's weights from the
   seed (a checksum of a few leaves against this process's) and freeing
   them after. First, at the shard shapes: the w4a8 kernel's int32
   accumulator-out mode (by its route and each forced) and its epilogue
   kernel bitwise equal to their plain versions at qwen2.5-3b's wo K 1024
   and wd K 5504 and the MoE passes' row-parallel slices, M in {1, 4, 8,
   512}, the two together bitwise the fused kernel, and the fused kernel
   on the column-parallel slices; the paged decode, gather, verify and
   COW checks of phase 2 at qwen2.5-3b's rank (Hkv 1, G 8), moonshot's
   (8 of 16 heads, G 1) and mixtral's (16 on 4 KV heads over 4096-row
   rings, the dense decode too); fake_quant_fwd in mode 3 bitwise its
   plain version on the local banks (moonshot's 32 of 64 experts,
   mixtral's 4 of 8; bits 4 and 8) and timed beside its plain version,
   the library call and the bound. Then the passes, each with its tp=1
   reference computed here and freed first: 3t, qwen2.5-3b at tp=2 (3b's
   requests at 8 new tokens on the pool: prefix hits, COW, tail-waves;
   3c's spec config on 4 of them at 4 new tokens); 3u, moonshot-v1-16b-
   a3b at 16 of 48 layers, tp=2 (expert parallelism: 32 experts a rank),
   on the pool with a shared prefix and spec at k 4 with an 8-layer
   draft; mixtral-8x7b at 4 of 32 layers, tp=2 (4 experts a rank), dense
   rings of 4096, prompts of 300-1500 tokens and one that wraps its ring;
   qwen2-7b at 2 of 28 layers, tp=8 (28 heads: the whole attention and
   pool on every rank). Streams, counters (prefix hits, COW, tail-waves,
   spec waves and accepts), one decode step's gathered logits (mixtral's
   after its rings wrapped) and, on the pool, the cold wave's K/V codes
   at the rank's heads bitwise tp=1's; every serve's kernels launched on
   every rank; the bank fake-quants a rank a decode step tp=1's count,
   each over E / tp experts, and their device ms; a decode step's
   collectives by kind (per layer an amax MAX and an int32 SUM a
   row-parallel linear, an owned-slot sum an MoE; the embedding's SUM,
   the logits' all-gather; no pool leaf in any); pool, packed-plane and
   expert-bank bytes a rank (the pool whole where the attention is, else
   at most 1.1 / tp of tp=1's, the packed planes too; the banks exactly
   1 / tp); peak memory a rank; one decode step's ms beside tp=1's (gloo
   through host memory: not a speed);
3v, 3o at tp=2. passes of the same tp=2 spawn, first the kernels at
   their shard shapes (w4a8 fused and accumulate + epilogue, decode at G
   5, D 256 over a wrapped ring, fake_quant_fwd on the bf16 shards):
   recurrentgemma-2b and xlstm-125m whole under w4a8, their streams,
   logits, gathered recurrent states and rings bitwise tp=1's;
   qwen2.5-3b under bf16 at 2 layers (one decode step's logits within
   ``Q3BF_LOGIT_REL``) and at 36 (within ``Q3BF_DEPTH_FACTOR`` of a
   witness: tp=1 with its GEMMs' f32 sums rounded once, each layer's
   residual gap reported); 3o's frontend and HTTP on rank 0, the other
   rank following: SSE, blocking and shed as tp=1's, timelines equal;
3d. self-draft: the target as its own draft; the verify-wave's logits
   against sequential decode steps' at one wave, and the accept rate;
   then a tail-wave row alone against the same row beside a deeper one,
   bitwise;
3e. optimistic admission on about 60% of the worst-case pool (spec on,
   prefix cache off, 8 new tokens a request): at least one preemption,
   swap bytes out == in, and every stream equal to reserve admission's;
3o. the streaming frontend on phase 3b's weights (paged, blocks of 64,
   prefix cache on, ``sched_policy="edf"``, ``slo_shed="reject"``,
   ``decode_block="auto"``: the probe's pick and its two chunk times),
   through ``AsyncFrontend`` and ``ServeHTTP`` on 127.0.0.1 at an
   ephemeral port: one warm request, then 8 SSE streams and one blocking
   completion sharing its 160-token prefix, each equal to a batch drain of
   the same requests on the same engine; ``/v1/metrics`` scraped mid-serve
   and after, agreeing with ``/v1/stats``; a burst of 12 whose deadlines
   come from the engine's TTFT predictor (exactly the 8 it predicts late
   behind the other 4 shed, before their deadlines pass; the 4 served in
   full); one Poisson pass of 16 arrivals, drawn up front, at half the
   request rate the drain sustained (client TTFT from the scheduled
   arrival, the loop's submit lag, the inbox wait, engine TTFT, tok/s,
   goodput); the exported trace held to the client's clock (each
   request's submit, first token and end against the step that made
   them) and to the scheduler's latencies; launches > 0 for the paged
   decode, gather, COW and w4a8 kernels;
5. QAT: ``run_qat`` on qwen2.5-3b at full width and depth, A8d-C8-W4,
   2 teacher steps (autograd attention), MSE weight calibration, 4 steps
   at B 8, T 128: 253 ``fake_quant_fwd`` and 253 ``fake_quant_bwd``
   launches and 36 ``flash_attn_fwd`` launches (the teacher) per step,
   finite KD losses, every ``s_w`` moved, AdamW moments non-zero on every
   read leaf, no NaN; ms per step split into teacher forward, student
   forward and backward and optimizer, tokens/s, peak memory, the
   device's idle share (``torch.profiler``) and the model-FLOPs share;
   then one loss and backward through the kernels against the plain
   versions;
7. ptq, on phase 5's teacher and student: ``rtn_quantize`` and
   ``smoothquant_quantize`` under A8d-C8-W4 and A8s-C8-W4;
   ``eval_quality`` (2 held-out batches of 8 x 64) of the teacher (fp16),
   of each PTQ tree and of the student, every metric finite; one student
   eval batch launches 253 ``fake_quant_fwd`` and 72 ``flash_attn_fwd``
   (the student's and the teacher's forward), and one student forward
   records 253 ``fq_fwd_kernel`` and 36 ``flash_attn_fwd_kernel`` on the
   device (``torch.profiler``); one eval batch through the kernels
   against the plain versions; ``fold_smoothing`` (alpha 0.4) of the
   teacher and ``rotate_residual`` of a fresh ``init_params`` tree (its
   final norm uniform, so the tied-head rotation is exact) keep the
   logits within twice the tree's own bf16 round-off (its forward with
   f32 params); on the teacher's first 4 layers ``rotation_report`` of
   its rotation has a rotational share above 0.8, and of the teacher
   perturbed by 0.05 std the share that isotropic noise has at these
   shapes (``isotropic_share``, 0.625 at d_ff / d = 5.4); a pure rotation
   of a full-width ``wg`` is rotational to 1e-4, and the Procrustes
   reduction equals the 11008-square product on a full-width ``wd`` to
   1e-9; seconds of each pass;
5b. a static policy (A8s-C8-W4) at full width and 4 layers: percentile
   calibration over 5 batches (``flash_attn_fwd`` in the calibration
   forward), one step, per-tensor fake-quant launches;
3h. a C16 decode, on phase 5's teacher: one qwen2.5-3b dense decode
   step under A16-C16-W16 (a bf16 cache) through ``kvq_decode_attn`` (36
   launches) against the plain versions; Table 2's ``selfgen_corpus``
   for one batch of 8 x 16 tokens on the card;
3f. xlstm-125m at full width (12 layers, 5 mLSTM : 1 sLSTM, random
   weights), A8d-C8-W4, w4a8 weights, dense cache: 8 requests in two
   exact-length admission groups through 4 slots; ``w4a8_matmul``
   launches, no attention kernel and no ``slstm_scan`` does (serving runs
   the quantized per-step cell); one decode step's logits against the
   plain versions; decode tok/s;
6. QAT of xlstm-125m at full width via ``run_qat`` (2 teacher steps, 2
   steps at B 8, T 128): per step 2 ``slstm_scan`` calls (the teacher's
   sLSTM layers) and one ``fake_quant_fwd`` / ``_bwd`` per student weight
   site (69: ``r_h`` once per forward, not once per step), no
   ``flash_attn_fwd``; every ``s_w`` moved; step ms, tokens/s, peak
   memory;
3g. recurrentgemma-2b at full width and depth (26 layers: 18 RG-LRU,
   8 local attention with a 2048-token window; random weights),
   A8d-C8-W4, w4a8 weights, dense layout, 4 slots, cache_len 4096 (rings
   of 2048): one decode step's logits after the rings wrapped (2040-token
   prompts, 24 steps), kernels vs plain; 8 requests of three lengths in
   exact-length waves, two of 2030 tokens whose rings wrap while they
   decode: ``kvq_decode_attn`` 8 launches a decode step, ``w4a8_matmul``
   launches, no other kernel; decode tok/s, TTFT;
6b. QAT of recurrentgemma-2b at full width and depth via ``run_qat`` (2
   teacher steps, MSE calibration, 2 steps at B 8, T 128): per step 201
   ``fake_quant_fwd`` and 201 ``_bwd`` (8 a RG-LRU layer, 7 a local
   layer, the tied head) and 8 ``flash_attn_fwd`` (the teacher's local
   layers); every ``s_w`` moved, no NaN; step ms split, tokens/s, peak
   memory;
3i. mixtral-8x7b at full width and 16 of its 32 layers (46.7 B
   parameters are ~93 GB in bf16 and the expert banks are never packed;
   random weights, bank scales LSQ-initialised), A8d-C8-W4, w4a8 weights
   (attention, router and head packed; the banks bf16, fake-quantized on
   every forward), dense layout, 4 slots, cache_len 8192 (rings of the
   4096 window): one decode step's logits after the rings wrapped (4
   prompts of 4090 tokens, 12 steps) kernels vs plain, on every row
   routed alike in every layer (a row routed to another set of experts
   must owe it to a near tie its router logits' difference crossed); 8
   requests of three lengths, two of 4080 tokens wrapping while they
   decode: ``kvq_decode_attn`` 16 launches a decode step,
   ``fake_quant_fwd`` 48 a forward (3 banks a layer), ``w4a8_matmul``
   launches, no other kernel; a prompt alone and in a wave of 4 padded to
   the same 1024 tokens (one MoE chunk) bitwise, the expert GEMMs batched
   over the wave; each expert's share of the wave's routed pairs and the
   share dropped at capacity; decode tok/s, TTFT, peak memory;
6c. QAT of mixtral-8x7b at full width and 2 layers via ``run_qat`` (2
   teacher steps, MSE calibration, 2 steps at B 8, T 128): per step 17
   ``fake_quant_fwd`` and 17 ``_bwd`` (q, k, v, o, router and three banks
   a layer, the head) and 2 ``flash_attn_fwd``; every ``s_w`` moved (the
   banks' (8, 1, d_out) included), ``moe_aux`` finite and > 0, no NaN;
   step ms split, tokens/s, peak memory, the model-FLOPs share over the
   active experts;
3j. moonshot-v1-16b-a3b at full width and depth (48 layers, 64 experts
   top 6; random weights, scales LSQ-initialised), A8d-C8-W4, w4a8
   weights (attention, router, head packed; banks bf16), on the paged
   pool (4 slots, blocks of 64, prefix cache on): 8 requests sharing a
   160-token prefix, 16 new tokens each (hits, COW, tail-waves): ``kvq_paged_decode_attn``
   48 launches a decode step, ``fake_quant_fwd`` 3 a ``moe_fwd`` call,
   a copy launch a COW, gather and w4a8 launched, no other kernel; one
   decode step's launches (48, 144, 0 dense) and logits kernels vs plain
   on rows routed alike; a tail-wave row bitwise alone and beside a
   deeper row through attention and the MoE; spec decoding at the CLI's
   defaults (k 4, a 24-layer draft) on 4 of the requests, 8 new
   tokens each: verify
   launched, paged decode not, the accept rate and the verify-wave pairs
   dropped at capacity; expert shares, decode tok/s, TTFT, peak memory;
6d. QAT of moonshot at full width and 4 layers via ``run_qat``: 33
   ``fake_quant_fwd`` and 33 ``_bwd`` a step (q, k, v, o, router, three
   64-expert banks a layer, the head) and 4 ``flash_attn_fwd``; every
   ``s_w`` moved, ``moe_aux`` > 0; step splits, tokens/s, peak,
   model-FLOPs share;
3k. qwen3-32b at full width and 48 of 64 layers (the 64 layers and their
   packed planes pass 80 GB at the export), w4a8: one decode step's
   logits kernels vs plain; 8 requests of three lengths, 16 new tokens
   each, on the dense layout (48 ``kvq_decode_attn`` a step) and on the
   paged pool (48
   ``kvq_paged_decode_attn`` a step, cold prefill, prefix cache off),
   the paged streams equal to the dense ones; tok/s, TTFT, peak;
3l. qwen2-7b at full width and depth, dense w4a8: the same (28
   ``kvq_decode_attn`` a step; the untied head at N 152064, G 7);
6e. QAT of qwen3-14b at full width and 4 layers: 29 ``fake_quant_fwd``
   and 29 ``_bwd`` a step, 4 ``flash_attn_fwd`` at G 5; every ``s_w``
   moved, the qk-norm weights' gradients finite and non-zero;
3m. whisper-large-v3 at full width and depth (32 encoder and 32
   decoder layers, random weights), A8d-C8-W4, w4a8, through ``prefill``
   and ``decode_step`` (no engine path supplies frames): two waves of 4
   requests (decoder prompts of 4 and 96 tokens, 1500 frames each), 32
   new tokens, cache_len 160; a prefill launches 32 ``flash_attn_fwd``
   (the encoder, not causal) and 513 ``w4a8_matmul``, a decode step 64
   ``kvq_decode_attn`` (self and the frozen cross caches) and 257
   ``w4a8_matmul``, nothing else; one step's logits kernels vs plain; a
   prompt alone and in its wave: self and cross caches and first logits
   bitwise; the logits move with the frames; tok/s, ms a step, idle,
   TTFT, peak;
6f. whisper QAT through ``make_train_step`` (B 4, T 128 over 1500
   frames, every layer checkpointed, the encoder's included): 1025
   ``fake_quant_fwd`` (the checkpointed layers' again in the backward),
   513 ``_bwd`` and 96 ``flash_attn_fwd`` (the teacher's encoder, self
   and cross) a step; every ``s_w`` moved; step split, peak, the
   model-FLOPs share with the encoder's;
3n. qwen2-vl-2b at full width and depth: ``prefill`` and ``decode_step``
   on 4 requests of 256 patch embeddings + 64 tokens at Qwen2-VL's
   positions (28 ``kvq_decode_attn`` a step), logits vs plain; the
   engine text-only on the pool with a shared prefix (hits, COW, 28
   paged launches a step) and dense vs paged from cold prefills
   (streams equal);
6g. qwen2-vl QAT through ``make_train_step`` (B 8, 128 text tokens after
   256 patches, the loss on the text): 197 / 197 / 28 launches a step,
   every ``s_w`` moved. (Phases 6-6g compare no loss and backward with
   the plain versions' and profile no step for the script's time; phases
   5 and 5d compare, phase 5 profiles. Phase
   2 holds fake_quant_fwd and the dx of fake_quant_bwd bitwise to their
   plain versions on every weight shape of qwen2.5-3b, whisper,
   qwen2-vl, xlstm-125m, recurrentgemma-2b, mixtral, moonshot and
   qwen3-14b, and in mode 3 on mixtral's and moonshot's expert banks;
   flash at qwen2.5-3b's, recurrentgemma's, mixtral's, moonshot's,
   qwen3-14b's, whisper's and qwen2-vl's shapes; the scan at
   xlstm-125m's.);
4. times: each kernel per decode step, verify-wave, tail-wave, COW,
   student step or teacher forward (CUDA events, L2 flushed by rotating
   input copies past 100 MB), its plain version, one PyTorch call
   computing the same function (a yardstick the port never calls) and
   the least time the card needs for the work (``slstm_scan``: per
   teacher forward in both carries, against a per-step GEMM loop;
   ``pool_block_copy`` per COW through one launch beside the four
   one-leaf launches it replaced;
   ``w4a8_matmul`` also per prefill wave, 36 x 7 linears at M = 512,
   beside bf16 ``torch.matmul``, bound by bytes or int8 operations); the paged
   decode, verify and dense decode kernels also per launch at a long
   cache (32768, 20000, 8192, 1 tokens; the dense one beside SDPA with
   ``enable_gqa``), ``flash_attn_fwd`` also at (B 8, S 1024) beside SDPA
   (its bound: bytes or the causal products at the bf16 tensor-core
   rate); decode tok/s and TTFT of the serve phases; at recurrentgemma's
   shapes a decode step's 8 dense decode launches (B 4, full 2048-token
   rings) in int8 and in bf16 and a teacher forward's 8 flash launches
   (B 8, T 128), and one windowed flash launch (S 4096, window 2048)
   beside SDPA with the mask; at mixtral's shapes ``fake_quant_fwd`` and
   ``_bwd`` per bank and per decode step (48 forward launches) beside
   the plain versions, one PyTorch call on the bank permuted to (d_in, e
   d_out) and mode 1 on the same bytes, a decode step's MoE layer by
   parts (router, dispatch, fake-quant, expert GEMMs, combine), its 16
   dense decode launches over full 4096-row rings beside SDPA, flash at
   (8, 128) and ``w4a8_matmul`` per decode step; at moonshot's shapes
   the same per 64-expert bank and per decode step (144 launches), its
   MoE layer by parts, the paged decode launch at G 1 beside SDPA; the
   dense decode launch at qwen3-32b's G 8, flash at G 1 and G 5 beside
   SDPA, and ``w4a8_matmul`` per qwen3-32b decode step (48 layers)
   beside bf16 ``torch.matmul``; flash without causality at whisper's
   encoder and cross shapes, the dense decode over its four cross caches
   and flash at G 6, each beside SDPA, and ``w4a8_matmul`` per whisper
   and per qwen2-vl decode step beside bf16 ``torch.matmul``.

The line before the last is a JSON object with every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20

SLOTS = 4
CACHE_LEN = 256
MAX_NEW = 32
PREFILL_M = SLOTS * 128        # one admission wave: 4 prompts padded to 128
KVQ_TOL = (2.0 ** -7, 1e-4)    # rtol (one bf16 ulp), atol
LOGIT_REL_TOL = 5e-2           # relative L2 error of one decode step


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def import_port():
    """The port's modules this script drives (fails outside a checkout)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import qat
    from repro_torch.core.distill import silq_loss
    from repro_torch.core.quantizer import unpack_int4
    from repro_torch.data import (MixtureIterator, ShardedLoader,
                                  SyntheticConfig, to_device)
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref
    from repro_torch.kernels.quant import ops as fq_ops
    from repro_torch.kernels.quant import ref as fq_ref
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
    from repro_torch.kernels.kvq_attn import ops as kvq_ops
    from repro_torch.kernels.kvq_attn import ref as kvq_ref
    from repro_torch.kernels.kvq_attn.ref import kvq_decode_attn_ref
    from repro_torch.kernels.w4a8 import ops as w4a8_ops
    from repro_torch.kernels.w4a8.ref import w4a8_matmul_ref
    from repro_torch import models
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import spawn, spawn_tp
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.sharding import attn_replicated
    from repro_torch.runtime import sharding
    from repro_torch.runtime.collectives import TPComm
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import cosine_schedule
    from repro_torch.benchmarks import common as bench
    from repro_torch.core.analysis import rotation
    from repro_torch.core.precision import parse_policy
    from repro_torch.core.ptq import rtn, smoothquant
    from repro_torch.data import calibration_batches
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.models import blocks
    from repro_torch.models.common import rms_norm
    from repro_torch.obs import export as obs_export
    from repro_torch.obs.metrics import parse_prometheus
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.frontend import AsyncFrontend
    from repro_torch.serve.http import ServeHTTP
    from repro_torch.serve.scheduler import percentile
    from repro_torch.serve.spec import SpecConfig
    return dict(get_config=get_config, get_reduced_config=get_reduced_config,
                qat=qat, unpack_int4=unpack_int4,
                build=build, kvq_ops=kvq_ops, kvq_ref=kvq_ref,
                kvq_decode_attn_ref=kvq_decode_attn_ref, w4a8_ops=w4a8_ops,
                w4a8_matmul_ref=w4a8_matmul_ref, models=models,
                rms_norm=rms_norm, Request=Request, ServeEngine=ServeEngine,
                SpecConfig=SpecConfig, Tracer=Tracer, TrainConfig=TrainConfig,
                MixtureIterator=MixtureIterator,
                SyntheticConfig=SyntheticConfig, to_device=to_device,
                fa_ops=fa_ops, flash_attn_ref=flash_attn_ref, fq_ops=fq_ops,
                fq_ref=fq_ref, steps=steps, train=train,
                silq_loss=silq_loss, slstm_ops=slstm_ops,
                slstm_scan_ref=slstm_scan_ref, blocks=blocks, bench=bench,
                rotation=rotation, parse_policy=parse_policy, rtn=rtn,
                smoothquant=smoothquant,
                calibration_batches=calibration_batches, tree_map=tree_map,
                adamw_init=adamw_init, obs_export=obs_export,
                parse_prometheus=parse_prometheus,
                AsyncFrontend=AsyncFrontend, ServeHTTP=ServeHTTP,
                percentile=percentile, spawn_tp=spawn_tp, spawn=spawn,
                ShardedLoader=ShardedLoader, tree_leaves=tree_leaves,
                named_leaves=_named_leaves, attn_replicated=attn_replicated,
                sharding=sharding, TPComm=TPComm,
                make_local_mesh=make_local_mesh,
                cosine_schedule=cosine_schedule)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_ms(torch, fn, arg_sets, min_calls=30):
    """Device ms per call of ``fn(*args)`` cycling through ``arg_sets``
    (copies whose total exceeds the L2 cache, so every call reads its
    inputs from device memory). The calls are captured once in a CUDA
    graph and the graph is replayed between two events, so the host's
    per-call launch cost stays out of the number."""
    n = max(min_calls, len(arg_sets))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                   # warmup off-capture
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / n


def host_issued_ms(torch, fn, arg_sets, min_calls=30):
    """Wall ms per call when the host issues the calls one by one (what
    the eager serving loop pays): host launch cost included."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    n = max(min_calls, len(arg_sets))
    t0 = time.perf_counter()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def copies_for(nbytes):
    return max(1, min(256, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# --------------------------------------------------------------------------
# phase 2 + 4: w4a8_matmul
# --------------------------------------------------------------------------

def linear_shapes(cfg):
    """(name, K, N, launches per decode step) of every served linear."""
    d, f, qd, kvd = cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim
    L = cfg.n_layers
    return [("q", d, qd, L), ("k", d, kvd, L), ("v", d, kvd, L),
            ("o", qd, d, L), ("gate", d, f, L), ("up", d, f, L),
            ("down", f, d, L), ("head", d, cfg.vocab_size, 1)]


def w4a8_activations(torch, gen, M, K, dev):
    x_q = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                        dtype=torch.int8)
    s_x = torch.rand((M, 1), generator=gen, device=dev) * 0.05 + 1e-3
    return x_q, s_x


def w4a8_weights(torch, gen, K, N, bias, dev):
    w_p = torch.randint(0, 256, (N, K // 2), generator=gen, device=dev,
                        dtype=torch.uint8)
    s_w = torch.rand((N,), generator=gen, device=dev) * 0.05 + 1e-3
    b = torch.randn((N,), generator=gen, device=dev) if bias else None
    return w_p, s_w, b


def w4a8_bound_ms(M, K, N, bias):
    nbytes = M * K + N * K // 2 + 4 * M + 4 * N + (4 * N if bias else 0) \
        + 2 * M * N
    ops = 2 * M * N * K
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def xlstm_linear_shapes(xcfg):
    """(name, K, N, bias) of every served linear of xlstm-125m: the mLSTM
    block's up, q / k / v, gates (N = 8) and down, the sLSTM block's
    w_x, r_h, up and down, and the untied head."""
    d = xcfg.d_model
    m = int(xcfg.mlstm_proj_factor * d)
    s_in = int(xcfg.slstm_proj_factor * d)
    return [("m_up", d, 2 * m, False), ("m_qkv", m, m, False),
            ("m_gates", m, 2 * xcfg.n_heads, True), ("m_down", m, d, False),
            ("s_x", d, 4 * d, True), ("s_r_h", d, 4 * d, False),
            ("s_up", d, s_in, False), ("s_down", s_in, d, False),
            ("head", d, xcfg.vocab_size, False)]


def w4a8_check_ms(P):
    """The M the bitwise checks take: decode slots, the spec verify wave
    (20), both sides of the route threshold, ragged and full admission
    waves and one past."""
    t = P["w4a8_ops"].prefill_min_m()
    return sorted({1, SLOTS, 8, 20, t - 1, t, 37, 128, PREFILL_M,
                   PREFILL_M + 1})


W4A8_ROUTES = ("decode", "mma")
W4A8_ALONE_ROWS = (0, 1, 255, PREFILL_M - 1)


def check_w4a8(torch, P, cfg, xcfg, dev, report):
    """w4a8_matmul bitwise equal to its plain version on every served
    linear of qwen2.5-3b (with and without bias) and of xlstm-125m, at
    every M of ``w4a8_check_ms``, through the launcher's own pick of route
    and through each route forced; then rows alone (the decode route)
    bitwise equal to the same rows inside M = 512 (the tensor cores)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ops = P["w4a8_ops"]
    ref = P["w4a8_matmul_ref"]
    ms = w4a8_check_ms(P)
    shapes = [(f"qwen {n}", K, N, b) for n, K, N, _ in linear_shapes(cfg)
              for b in (False, True)]
    shapes += [(f"xlstm {n}", K, N, b)
               for n, K, N, b in xlstm_linear_shapes(xcfg)]

    def same(got, want, what):
        check(got.dtype == want.dtype == torch.bfloat16
              and got.shape == want.shape, f"w4a8 {what}: dtype/shape")
        if not torch.equal(got, want):
            diff = (got.float() - want.float()).abs()
            raise SmokeFailure(
                f"w4a8_matmul {what} differs from its plain version: "
                f"{int((diff > 0).sum())} elements, max {float(diff.max())}")

    n_cmp = n_rows = 0
    for name, K, N, bias in shapes:
        w_p, s_w, b = w4a8_weights(torch, gen, K, N, bias, dev)
        for M in ms:
            x_q, s_x = w4a8_activations(torch, gen, M, K, dev)
            want = ref(x_q, w_p, s_x, s_w, b)
            what = f"{name} M={M} bias={bias} K={K} N={N}"
            same(ops.w4a8_matmul(x_q, w_p, s_x, s_w, b), want, what)
            for route in W4A8_ROUTES:
                same(ops.w4a8_matmul_route(x_q, w_p, s_x, s_w, b,
                                           route=route), want,
                     f"{what} route={route}")
            n_cmp += 1
            del want, x_q, s_x
        if name.startswith("qwen") and bias:
            # one row alone against the same row inside an admission wave
            x_q, s_x = w4a8_activations(torch, gen, PREFILL_M, K, dev)
            wave = ops.w4a8_matmul(x_q, w_p, s_x, s_w, b)
            for i in W4A8_ALONE_ROWS:
                alone = ops.w4a8_matmul(x_q[i:i + 1], w_p, s_x[i:i + 1],
                                        s_w, b)
                torch.cuda.synchronize()
                check(torch.equal(alone, wave[i:i + 1]),
                      f"w4a8_matmul {name}: row {i} alone differs from the "
                      f"same row inside M={PREFILL_M}")
                n_rows += 1
            del wave, x_q, s_x
        del w_p, s_w, b
        torch.cuda.empty_cache()
    report["w4a8_compared"] = n_cmp
    report["w4a8_check_ms"] = ms
    report["w4a8_rows_alone"] = n_rows
    print(f"phase 2: w4a8_matmul bitwise equal to its plain version on "
          f"{n_cmp} cases (M in {ms}; 8 linears of qwen2.5-3b with and "
          f"without bias, 9 of xlstm-125m), each by the launcher's route "
          f"and by both routes forced (tensor cores from M = "
          f"{ops.prefill_min_m()}); {n_rows} rows alone bitwise equal to "
          f"the same rows inside M = {PREFILL_M}", flush=True)
    return 0.0


def time_w4a8(torch, P, cfg, dev, report):
    """Per-shape times at M = slots, summed over one decode step (the 252
    linears and the tied head), and at M = one admission wave, summed over
    one prefill wave (the 252 linears: the engine runs the head on the
    last tokens only); beside each, the plain version, bf16
    ``torch.matmul`` on dequantized weights and the bound."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    w4a8_matmul = P["w4a8_ops"].w4a8_matmul
    ref = P["w4a8_matmul_ref"]
    unpack = P["unpack_int4"]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    totals = dict.fromkeys(keys, 0.0)
    wave = dict.fromkeys(keys, 0.0)
    t_bytes = t_ops = w_bytes = w_ops = 0.0
    rows = []
    for name, K, N, per_step in linear_shapes(cfg):
        bias = name in ("q", "k", "v")          # qwen2.5's QKV bias
        per_wave = 0 if name == "head" else per_step
        row = {"linear": name, "K": K, "N": N, "per_decode_step": per_step,
               "per_prefill_wave": per_wave}
        nb = N * K // 2 + 4 * N * (2 if bias else 1)
        sets = []
        for _ in range(copies_for(nb)):
            w_p, s_w, b = w4a8_weights(torch, gen, K, N, bias, dev)
            sets.append((w_p, s_w, b))
        lib_w = [(unpack(w_p).float() * s_w[:, None]).to(torch.bfloat16).T
                 for w_p, s_w, _ in sets[:copies_for(N * K * 2)]]
        for M, key, n in ((SLOTS, "", per_step), (PREFILL_M, "prefill_",
                                                  per_wave)):
            if not n:
                continue
            x_q, s_x = w4a8_activations(torch, gen, M, K, dev)
            args = [(x_q, w_p, s_x, s_w, b) for w_p, s_w, b in sets]
            t_k = time_ms(torch, w4a8_matmul, args,
                          min_calls=30 if M == SLOTS else 10)
            if M == SLOTS:
                row["host_issued_ms"] = host_issued_ms(torch, w4a8_matmul,
                                                       args)
            t_p = time_ms(torch, ref, args[:copies_for(nb * 9)],
                          min_calls=5)
            x_deq = (x_q.float() * s_x).to(torch.bfloat16)
            t_l = time_ms(torch, torch.matmul, [(x_deq, w) for w in lib_w])
            bound, by = w4a8_bound_ms(M, K, N, bias)
            row.update({f"{key}M": M, f"{key}ms": t_k, f"{key}plain_ms": t_p,
                        f"{key}library_ms": t_l, f"{key}bound_ms": bound,
                        f"{key}bound_by": by})
            acc = totals if M == SLOTS else wave
            for k_, v_ in zip(keys, (t_k, t_p, t_l, bound)):
                acc[k_] += n * v_
            nbytes = M * K + N * K // 2 + 8 * M + 4 * N * (
                2 if bias else 1) + 2 * M * N
            if M == SLOTS:
                t_bytes += n * nbytes / HBM_BYTES_PER_S
                t_ops += n * 2 * M * N * K / INT8_OPS_PER_S
            else:
                w_bytes += n * nbytes / HBM_BYTES_PER_S
                w_ops += n * 2 * M * N * K / INT8_OPS_PER_S
            del args, x_q, s_x, x_deq
        rows.append(row)
        del sets, lib_w
        torch.cuda.empty_cache()
    report["w4a8_per_shape"] = rows
    totals["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    wave["bound_by"] = "bytes" if w_bytes >= w_ops else "operations"
    wave["M"] = PREFILL_M
    wave["per"] = (f"one prefill wave at M={PREFILL_M}: 36 layers x 7 "
                   f"linears")
    report["w4a8_prefill_wave"] = wave
    print(f"phase 4: w4a8_matmul per prefill wave (M={PREFILL_M}): "
          f"{wave['ms']:.4f} ms (bound {wave['bound_ms']:.4f} ms by "
          f"{wave['bound_by']}), plain {wave['plain_ms']:.4f} ms, bf16 "
          f"matmul {wave['library_ms']:.4f} ms", flush=True)
    totals["prefill_wave"] = wave
    return totals


# --------------------------------------------------------------------------
# phase 2 + 4: kvq_decode_attn
# --------------------------------------------------------------------------

def kvq_inputs(torch, gen, cfg, lengths, dev, S=CACHE_LEN):
    """A dense int8 cache of ``S`` tokens a slot, one slot a length."""
    B, H, Hkv = len(lengths), cfg.n_heads, cfg.n_kv_heads
    D = cfg.resolved_head_dim
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randint(-127, 128, (B, Hkv, S, D), generator=gen, device=dev,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (B, Hkv, S, D), generator=gen, device=dev,
                      dtype=torch.int8)
    s_k = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.02 + 1e-3
    s_v = torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.02 + 1e-3
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, s_k, s_v, lens


# ragged decode-time lengths inside cache_len (one full row, one fresh)
KVQ_LENGTHS = (CACHE_LEN, 1, 97, 160)


def kvq_cases(P):
    """(lengths, S) of the dense decode checks: the dense serve phase's
    lengths in its cache, the split-KV kernel's split and group boundaries
    (with an empty row) in a cache just long enough, and the long cache."""
    return ((KVQ_LENGTHS, CACHE_LEN), (split_lengths(P),
                                       max(split_lengths(P))),
            (PAGED_LONG, max(PAGED_LONG)))


def check_kvq(torch, P, cfg, dev, report):
    """The dense decode kernel against its plain version within one bf16
    ulp on every case of ``kvq_cases``; an empty row exactly zero."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rtol, atol = KVQ_TOL
    worst, errs = 0.0, []
    for lengths, S in kvq_cases(P):
        args = kvq_inputs(torch, gen, cfg, lengths, dev, S)
        got = P["kvq_ops"].kvq_decode_attn(*args).float()
        want = P["kvq_decode_attn_ref"](*args).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), "kvq_decode_attn: non-finite")
        check(torch.allclose(got, want, rtol=rtol, atol=atol),
              f"kvq_decode_attn lengths {lengths} (S {S}) differs from its "
              f"plain version: max abs err {err} (rtol {rtol}, atol {atol})")
        for i, n in enumerate(lengths):
            if n == 0:
                check(bool((got[i] == 0).all()),
                      "kvq_decode_attn: an empty row is not zero")
        worst = max(worst, err)
        errs.append({"lengths": list(lengths), "S": S, "max_abs_err": err})
        del args, got, want
    report["kvq_max_abs_err"] = worst
    report["kvq_cases"] = errs
    print(f"phase 2: kvq_decode_attn within rtol {rtol} atol {atol} of its "
          f"plain version (max abs err {worst:.3g}; lengths {KVQ_LENGTHS}, "
          f"split boundaries {split_lengths(P)}, long cache {PAGED_LONG})",
          flush=True)
    return worst


def dense_to_pool(torch, gen, args, bs):
    """Paged decode's arguments for the same K/V as the dense ``args``:
    each slot's tokens scattered into a pool of ``bs``-token blocks
    through a shuffled table (sentinels past each slot's extent; their
    rows land in the sink block, which is never read)."""
    q, k, v, s_k, s_v, lens = args
    B, Hkv, S, D = k.shape
    T = -(-S // bs)
    nb = B * T + 8
    tbl = shuffled_table(torch, gen, nb, B, T, lens.tolist(), bs, q.device)
    idx = tbl.long()

    def scatter(x):
        pad = T * bs - S
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 3) + (0, pad))
        x = x.reshape((B, Hkv, T, bs) + x.shape[3:]).transpose(1, 2)
        pool = torch.zeros((nb + 1, Hkv, bs) + x.shape[4:], dtype=x.dtype,
                           device=x.device)
        pool[idx] = x
        return pool

    return (q, scatter(k), scatter(v), scatter(s_k), scatter(s_v), tbl,
            lens)


def check_kvq_bitwise(torch, P, cfg, dev, report):
    """Dense decode on every case of ``kvq_cases`` bitwise equal to the
    paged decode kernel on the same K/V scattered into a pool (bs 64, a
    shuffled table): the same arithmetic, only the address differs; and
    at the serve phase's lengths and the long cache each row bitwise equal
    alone and in the batch of 4."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    ops = P["kvq_ops"]
    for lengths, S in kvq_cases(P):
        args = kvq_inputs(torch, gen, cfg, lengths, dev, S)
        full = ops.kvq_decode_attn(*args)
        paged = ops.kvq_paged_decode_attn(*dense_to_pool(torch, gen, args,
                                                         PAGED_BS[0]))
        check(torch.equal(full, paged),
              f"kvq_decode_attn lengths {lengths} (S {S}) is not bitwise "
              f"equal to kvq_paged_decode_attn on the same K/V")
        if len(lengths) == SLOTS:
            for i in range(SLOTS):
                one = ops.kvq_decode_attn(*(a[i:i + 1] for a in args))
                check(torch.equal(full[i:i + 1], one),
                      f"kvq_decode_attn: row {i} (length {lengths[i]}) "
                      f"differs alone and in a batch of {SLOTS}")
        del args, full, paged
    report["kvq_bitwise_vs_paged_decode"] = True
    report["kvq_batch_invariant"] = True
    print(f"phase 2: kvq_decode_attn bitwise equal to kvq_paged_decode_attn "
          f"on the same K/V (bs {PAGED_BS[0]}, shuffled table) at lengths "
          f"{KVQ_LENGTHS}, {split_lengths(P)} and {PAGED_LONG}; rows bitwise "
          f"alone and in a batch of {SLOTS} at {KVQ_LENGTHS} and "
          f"{PAGED_LONG}", flush=True)


def time_dense_launch(torch, P, cfg, dev, gen, lengths, S, expanded,
                      c16=False):
    """One dense decode launch on rotated inputs: device ms (graph
    replay), host-issued ms, the plain version, SDPA with ``enable_gqa``
    (and, if ``expanded``, on K/V expanded to every query head) over the
    dequantized bf16 cache with a length mask, and the bound. ``c16``: a
    bf16 cache with unit scales (a C16 policy's) instead of int8."""
    import torch.nn.functional as F

    def make():
        args = kvq_inputs(torch, gen, cfg, lengths, dev, S)
        return to_c16(torch, args) if c16 else args

    base = make()
    sets = [base] + [make()
                     for _ in range(copies_for(tensor_bytes(*base)) - 1)]
    kern = P["kvq_ops"].kvq_decode_attn
    t_k = time_ms(torch, kern, sets)
    t_host = host_issued_ms(torch, kern, sets)
    t_p = time_ms(torch, P["kvq_decode_attn_ref"], sets, min_calls=10)
    G = cfg.n_heads // cfg.n_kv_heads
    lib = {}
    for gqa in (True, False) if expanded else (True,):
        lib_sets = []
        for q, k, v, s_k, s_v, lens in sets:
            kd = (k.float() * s_k[..., None]).to(torch.bfloat16)
            vd = (v.float() * s_v[..., None]).to(torch.bfloat16)
            if not gqa:
                kd = kd.repeat_interleave(G, dim=1)
                vd = vd.repeat_interleave(G, dim=1)
            mask = (torch.arange(S, device=dev)[None, :]
                    < lens[:, None])[:, None, None, :]
            lib_sets.append((q[:, :, None, :], kd, vd, mask))
        lib[gqa] = time_ms(torch, lambda q, k, v, m, gqa=gqa: (
            F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                           enable_gqa=gqa)), lib_sets)
        del lib_sets
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, tokens = len(lengths), sum(lengths)
    es = base[1].element_size()
    nbytes = (2 * B * H * D                 # q
              + tokens * Hkv * (2 * D * es + 8)  # K/V rows + f32 scales
              + 4 * B + 2 * B * H * D)      # lengths, out
    flops = 4 * tokens * H * D
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    del sets
    torch.cuda.empty_cache()
    return {"ms": t_k, "host_issued_ms": t_host, "plain_ms": t_p,
            "library_ms": lib[not expanded], "library_gqa_ms": lib[True],
            "bound_ms": max(t_b, t_o) * 1e3, "byte_bound_ms": t_b * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "byte_bound_share": t_b * 1e3 / t_k, "lengths": list(lengths),
            "S": S}


def time_kvq(torch, P, cfg, dev, report):
    """Per dense decode step (36 launches) at the serve phase's shapes,
    and one launch at the long cache (PAGED_LONG in a 32768-token
    cache)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    t = time_dense_launch(torch, P, cfg, dev, gen, KVQ_LENGTHS, CACHE_LEN,
                          True)
    lt = time_dense_launch(torch, P, cfg, dev, gen, PAGED_LONG,
                           max(PAGED_LONG), False)
    report["kvq_per_launch"], report["kvq_long"] = t, lt
    print(f"phase 4: kvq_decode_attn per launch: {t['ms'] * 1e3:.2f} us "
          f"(host-issued {t['host_issued_ms'] * 1e3:.2f} us), SDPA "
          f"{t['library_ms'] * 1e3:.2f} us, SDPA gqa "
          f"{t['library_gqa_ms'] * 1e3:.2f} us; long cache {PAGED_LONG}: "
          f"{lt['ms'] * 1e3:.2f} us, byte bound "
          f"{lt['byte_bound_ms'] * 1e3:.2f} us (share "
          f"{lt['byte_bound_share']:.3f}), SDPA gqa "
          f"{lt['library_gqa_ms'] * 1e3:.1f} us", flush=True)
    return per_step(t, cfg.n_layers)


# --------------------------------------------------------------------------
# phase 2 + 4: the paged kernels (kvq_paged_decode_attn,
# gather_dequant_paged_kv, pool_block_copy)
# --------------------------------------------------------------------------

PAGED_TOKENS = 512             # the paged serve phase's per-slot extent
PAGED_BS = (64, 16)            # the engine's block size and the tests'
PAGED_LENGTHS = (512, 1, 97, 200)
PAGED_LONG = (32768, 20000, 8192, 1)   # qwen2.5-3b's context, ragged


MERGE_GROUP = 16   # splits a first-level merger of the paged kernels
#                    takes (NG in csrc/kvq_paged_split.cuh)


def split_lengths(P):
    """Lengths on and around the paged kernels' split boundaries (SPLIT
    tokens a CTA) and their group boundary (MERGE_GROUP splits, where the
    second merge level starts), with a parked row."""
    S, NG = P["kvq_ops"].SPLIT, MERGE_GROUP
    return (0, 1, S - 1, S, S + 1, 3 * S, NG * S, NG * S + 1)
GATHER_SHAPE = (4, 8, 64)      # n rows, T table entries, bs
COPY_LAYERS = 36


def paged_pool(torch, gen, cfg, nb, bs, dev):
    """Random int8 K/V pools and f32 scales of ``nb`` blocks plus the
    sink block."""
    Hkv, D = cfg.n_kv_heads, cfg.resolved_head_dim
    k = torch.randint(-127, 128, (nb + 1, Hkv, bs, D), generator=gen,
                      device=dev, dtype=torch.int8)
    v = torch.randint(-127, 128, (nb + 1, Hkv, bs, D), generator=gen,
                      device=dev, dtype=torch.int8)
    s_k = torch.rand((nb + 1, Hkv, bs), generator=gen, device=dev) * 0.02 \
        + 1e-3
    s_v = torch.rand((nb + 1, Hkv, bs), generator=gen, device=dev) * 0.02 \
        + 1e-3
    return k, v, s_k, s_v


def shuffled_table(torch, gen, nb, rows, T, lengths, bs, dev):
    """Distinct non-contiguous blocks per row in a shuffled order, the
    sentinel ``nb`` past each row's extent (all of a length-0 row)."""
    perm = torch.randperm(nb, generator=gen, device=dev)[:rows * T]
    tbl = perm.reshape(rows, T).to(torch.int32)
    used = torch.tensor([-(-n // bs) for n in lengths], device=dev)
    col = torch.arange(T, device=dev)[None]
    return torch.where(col < used[:, None], tbl,
                       torch.full_like(tbl, nb)).contiguous()


def paged_inputs(torch, gen, cfg, bs, lengths, dev):
    B, T = len(lengths), -(-max(PAGED_TOKENS, *lengths) // bs)
    nb = B * T + 8                     # spare blocks the tables skip
    H, D = cfg.n_heads, cfg.resolved_head_dim
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    k, v, s_k, s_v = paged_pool(torch, gen, cfg, nb, bs, dev)
    tbl = shuffled_table(torch, gen, nb, B, T, lengths, bs, dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, s_k, s_v, tbl, lens


def check_paged_decode(torch, P, cfg, dev, report):
    """The paged decode kernel against its plain version at both block
    sizes, on ragged lengths, with one parked (all-sentinel, length 0)
    row in place of the one-token row, on the lengths around the split
    and group boundaries, and at a long cache."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    kern = P["kvq_ops"].kvq_paged_decode_attn
    ref = P["kvq_ref"].kvq_paged_decode_attn_ref
    rtol, atol = KVQ_TOL
    worst = 0.0
    cases = (PAGED_LENGTHS, (PAGED_LENGTHS[0], 0) + PAGED_LENGTHS[2:],
             split_lengths(P), PAGED_LONG)
    errs = []
    for bs in PAGED_BS:
        for lengths in cases:
            args = paged_inputs(torch, gen, cfg, bs, lengths, dev)
            got = kern(*args).float()
            want = ref(*args).float()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"kvq_paged_decode_attn bs={bs}: non-finite output")
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=rtol, atol=atol),
                  f"kvq_paged_decode_attn bs={bs} lengths {lengths} differs "
                  f"from its plain version: max abs err {err} (rtol {rtol}, "
                  f"atol {atol})")
            for i, n in enumerate(lengths):
                if n == 0:
                    check(bool((got[i] == 0).all()),
                          "kvq_paged_decode_attn: a parked row is not zero")
            worst = max(worst, err)
            errs.append({"bs": bs, "lengths": list(lengths),
                         "max_abs_err": err})
            del args, got, want
    report["paged_decode_max_abs_err"] = worst
    report["paged_decode_cases"] = errs
    print(f"phase 2: kvq_paged_decode_attn within rtol {rtol} atol {atol} "
          f"of its plain version at bs {PAGED_BS} (max abs err {worst:.3g}, "
          f"lengths {PAGED_LENGTHS}, a parked row, split boundaries "
          f"{split_lengths(P)}, long cache {PAGED_LONG})", flush=True)
    return worst


def check_paged_scratch(torch, P, cfg, dev):
    """The three split-KV launchers refuse (cudaErrorInvalidValue, 1) a
    workspace or ticket buffer one element shorter than the source's
    ``kvq_paged_split_scratch`` asks for, and write nothing. Calls the C
    launchers directly: nothing launches, no count moves."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    ops = P["kvq_ops"]
    bs = PAGED_BS[0]
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    cases = []
    q, k, v, s_k, s_v, lens = kvq_inputs(torch, gen, cfg, KVQ_LENGTHS, dev)
    B, S = q.shape[0], k.shape[2]
    cases.append(("kvq_decode_attn", (q, k, v, s_k, s_v, lens),
                  (B, 1, H, Hkv, D, 1, S), (B, H, Hkv, S, D)))
    for name, args in (
            ("kvq_paged_decode_attn",
             paged_inputs(torch, gen, cfg, bs, PAGED_LENGTHS, dev)),
            ("kvq_spec_verify_attn", spec_inputs(torch, gen, cfg, bs, dev))):
        q, k, tbl = args[0], args[1], args[5]
        B, T = tbl.shape
        C = q.shape[1] if q.dim() == 4 else 1
        shape = (B, H, Hkv) if q.dim() == 3 else (B, C, H, Hkv)
        cases.append((name, args, (B, C, H, Hkv, D, T, bs),
                      shape + (k.shape[0] - 1, bs, T, D)))
    for name, args, need, shape in cases:
        ws_n, tk_n = ops._scratch_need(*need)
        ws = torch.empty(ws_n, dtype=torch.float32, device=dev)
        tk = torch.zeros(tk_n, dtype=torch.int32, device=dev)
        out = torch.zeros_like(args[0])
        for ws_len, tk_len in ((ws_n - 1, tk_n), (ws_n, tk_n - 1)):
            err = ops._fn(name)(
                *(a.data_ptr() for a in args), out.data_ptr(),
                ws.data_ptr(), ws_len, tk.data_ptr(), tk_len, *shape,
                ops.KV_DTYPES[args[1].dtype], D ** -0.5,
                torch.cuda.current_stream(dev).cuda_stream)
            torch.cuda.synchronize()
            check(err == 1 and not bool(out.any()),
                  f"{name} took {ws_len} of {ws_n} workspace and {tk_len} "
                  f"of {tk_n} tickets: error {err}")
    print(f"phase 2: the split-KV launchers (dense decode, paged decode, "
          f"verify) refuse scratch one element short of "
          f"kvq_paged_split_scratch's", flush=True)


def check_paged_rows(torch, P, cfg, dev, report):
    """Batch invariance of paged decode: each row of a 4-slot call is
    bitwise equal to the same row run alone (B = 1), at both block sizes,
    at the serve phase's lengths and at a long cache."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    kern = P["kvq_ops"].kvq_paged_decode_attn
    for bs in PAGED_BS:
        for lengths in (PAGED_LENGTHS, PAGED_LONG):
            q, k, v, s_k, s_v, tbl, lens = paged_inputs(torch, gen, cfg, bs,
                                                        lengths, dev)
            full = kern(q, k, v, s_k, s_v, tbl, lens)
            for i in range(len(lengths)):
                one = kern(q[i:i + 1], k, v, s_k, s_v, tbl[i:i + 1],
                           lens[i:i + 1])
                check(torch.equal(full[i:i + 1], one),
                      f"kvq_paged_decode_attn bs={bs}: row {i} (length "
                      f"{lengths[i]}) differs alone and in a batch of "
                      f"{len(lengths)}")
            del k, v, s_k, s_v
    report["paged_decode_batch_invariant"] = True
    print(f"phase 2: kvq_paged_decode_attn rows bitwise equal alone and in a "
          f"batch of 4 at bs {PAGED_BS} (lengths {PAGED_LENGTHS} and "
          f"{PAGED_LONG})", flush=True)


# (n, T, bs, per-row lengths): the tail-wave's shape, then shapes ragged
# against the kernel's tiling (16-row parts of a tile at D 128): one entry
# of a 16-token block; sentinel entries past each row's extent and an
# all-sentinel row; a 512-entry table (32k tokens a row)
GATHER_CASES = ((*GATHER_SHAPE, (8 * 64, 3 * 64 + 5, 1, 5 * 64)),
                (1, 1, 16, (16,)),
                (3, 5, 64, (5 * 64, 2 * 64 + 3, 0)),
                (4, 512, 64, (512 * 64,) * 4))


def gather_inputs(torch, gen, cfg, dev, case=GATHER_CASES[0]):
    """(k pool, s_k, v pool, s_v, table) of one gather case."""
    n, T, bs, lengths = case
    nb = n * T + 8
    k, v, s_k, s_v = paged_pool(torch, gen, cfg, nb, bs, dev)
    tbl = shuffled_table(torch, gen, nb, n, T, lengths, bs, dev)
    return k, s_k, v, s_v, tbl


def check_gather(torch, P, cfg, dev, report, report_key="gather_bitwise"):
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    ops, ref = P["kvq_ops"], P["kvq_ref"].gather_dequant_paged_kv_ref
    for case in GATHER_CASES:
        k, s_k, v, s_v, tbl = gather_inputs(torch, gen, cfg, dev, case)
        check(bool((tbl >= k.shape[0] - 1).any())
              == (min(case[3]) < case[1] * case[2]),
              f"gather case {case[:3]}: sentinel entries as planned")
        want = (ref(k, s_k, tbl), ref(v, s_v, tbl))
        for how, got in (
                ("one leaf", (ops.gather_dequant_paged_kv(k, s_k, tbl),
                              ops.gather_dequant_paged_kv(v, s_v, tbl))),
                ("K and V in one launch",
                 ops.gather_dequant_paged_kv_pair(k, s_k, v, s_v, tbl))):
            torch.cuda.synchronize()
            for leaf, g, w in zip("KV", got, want):
                check(g.shape == w.shape and g.dtype == w.dtype,
                      f"gather_dequant_paged_kv {case[:3]} {how}: "
                      f"dtype/shape")
                if not torch.equal(g, w):
                    diff = (g - w).abs()
                    raise SmokeFailure(
                        f"gather_dequant_paged_kv ({how}, {leaf}) differs "
                        f"from its plain version at (n, T, bs) = "
                        f"{case[:3]}: {int((diff > 0).sum())} elements, "
                        f"max {float(diff.max())}")
        del k, s_k, v, s_v, tbl, got, want
    report[report_key] = [list(c[:3]) for c in GATHER_CASES]
    print(f"phase 2: gather_dequant_paged_kv bitwise equal to its plain "
          f"version, one leaf a launch and K and V in one, at (n, T, bs) = "
          f"{[c[:3] for c in GATHER_CASES]}, {cfg.n_kv_heads} KV heads",
          flush=True)
    return 0.0


def copy_leaves(torch, gen, cfg, nb, bs, dev, layers=COPY_LAYERS):
    """A stacked pool leaf of each dtype (36 layers unless told),
    sink block included."""
    Hkv, D = cfg.n_kv_heads, cfg.resolved_head_dim
    payload = torch.randint(-127, 128, (layers, nb + 1, Hkv, bs, D),
                            generator=gen, device=dev, dtype=torch.int8)
    scales = torch.rand((layers, nb + 1, Hkv, bs), generator=gen,
                        device=dev)
    return payload, scales


def check_copy(torch, P, cfg, dev, report):
    """Bitwise COW clone on both leaf dtypes: real pairs copied, padding
    pairs (dst >= NB) write nothing, every other block untouched."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    nb, bs = PAGED_TOKENS * SLOTS // 64, 64
    src = torch.tensor([3, 17, 0, 0], dtype=torch.int32, device=dev)
    dst = torch.tensor([20, 5, nb, nb], dtype=torch.int32, device=dev)
    kern = P["kvq_ops"].copy_pool_blocks
    ref = P["kvq_ref"].copy_pool_blocks_ref
    for leaf in copy_leaves(torch, gen, cfg, nb, bs, dev):
        got, want = leaf.clone(), leaf.clone()
        kern(got, src, dst)
        ref(want, src, dst)
        torch.cuda.synchronize()
        name = f"pool_block_copy ({leaf.dtype})"
        check(torch.equal(got[:, :nb], want[:, :nb]),
              f"{name} differs from its plain version")
        check(torch.equal(got[:, 20], leaf[:, 3])
              and torch.equal(got[:, 5], leaf[:, 17]),
              f"{name}: a destination block does not hold its source")
        keep = [b for b in range(nb) if b not in (20, 5)]
        check(torch.equal(got[:, keep], leaf[:, keep]),
              f"{name}: a block outside dst changed")
    report["copy_bitwise"] = True
    print(f"phase 2: pool_block_copy bitwise equal to its plain version on "
          f"{COPY_LAYERS}-layer int8 and f32 leaves, padding pairs dropped, "
          f"untouched blocks unchanged", flush=True)
    check_copy_multi(torch, P, cfg, dev, report)
    return 0.0


def pool_leaves(torch, gen, cfg, nb, bs, dev, layers=COPY_LAYERS):
    """The paged serve phase's four pool leaves (k_q, v_q, s_k, s_v: the
    engine's ``POOL_KEYS`` order) at ``cfg``'s width and ``layers``."""
    (k, sk), (v, sv) = (copy_leaves(torch, gen, cfg, nb, bs, dev, layers)
                        for _ in range(2))
    return [k, v, sk, sv]


def copy_pairs(nb):
    """(src, dst) lists the multi-leaf copy is checked on: 1 pair, 2
    pairs, and 7 pairs of which 2 are padding (dst >= NB) and 2 take a
    src clamped into [0, NB - 1] (NB + 5 and -2). No src is a dst."""
    return (([3], [20]), ([3, 17], [20, 5]),
            ([3, 17, nb + 5, -2, 9, 0, 0], [20, 5, 11, 12, 14, nb, nb + 7]))


def check_copy_multi(torch, P, cfg, dev, report, layers=COPY_LAYERS,
                     report_key="copy_multi_bitwise"):
    """The COW of every pool leaf in one launch (the engine's call),
    bitwise equal to the plain version leaf by leaf: real pairs copied,
    clamped sources read, padding pairs dropped, other blocks
    untouched."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    nb, bs = PAGED_TOKENS * SLOTS // 64, 64
    leaves = pool_leaves(torch, gen, cfg, nb, bs, dev, layers)
    kern = P["kvq_ops"].copy_pool_blocks_multi
    ref = P["kvq_ref"].copy_pool_blocks_multi_ref
    for src, dst in copy_pairs(nb):
        pairs = torch.tensor([src, dst], dtype=torch.int32, device=dev)
        got = [x.clone() for x in leaves]
        want = [x.clone() for x in leaves]
        kern(got, pairs)
        ref(want, pairs)
        torch.cuda.synchronize()
        real = [(min(max(s_, 0), nb - 1), d_) for s_, d_ in zip(src, dst)
                if d_ < nb]
        for key, leaf, g, w in zip(("k_q", "v_q", "s_k", "s_v"), leaves,
                                   got, want):
            name = f"pool_block_copy_multi ({key}, {len(src)} pairs)"
            check(torch.equal(g[:, :nb], w[:, :nb]),
                  f"{name} differs from its plain version")
            check(all(torch.equal(g[:, d_], leaf[:, s_]) for s_, d_ in real),
                  f"{name}: a destination block does not hold its source")
            keep = [b for b in range(nb) if b not in {d_ for _, d_ in real}]
            check(torch.equal(g[:, keep], leaf[:, keep]),
                  f"{name}: a block outside dst changed")
        del got, want
    report[report_key] = [len(src) for src, _ in copy_pairs(nb)]
    print(f"phase 2: pool_block_copy_multi (k_q, v_q, s_k, s_v of "
          f"{layers} layers, {cfg.n_kv_heads} KV heads, in one launch) "
          f"bitwise equal to its plain "
          f"version at 1, 2 and 7 pairs (padding pairs dropped, clamped "
          f"sources read)", flush=True)


def sdpa_paged_sets(torch, P, cfg, sets, lens_of, gqa):
    """SDPA's inputs for each paged arg set: the table's K/V gathered and
    dequantized to bf16 (expanded to every query head, or kept per KV head
    for ``enable_gqa``) and a boolean length mask; ``lens_of(lens)`` is
    the mask's (B, 1 | C, S) form."""
    G = cfg.n_heads // cfg.n_kv_heads
    gather = P["kvq_ref"].gather_paged_kv
    out = []
    for q, k, v, s_k, s_v, tbl, lens in sets:
        kd = (gather(k, tbl).float() * gather(s_k, tbl)[..., None])
        vd = (gather(v, tbl).float() * gather(s_v, tbl)[..., None])
        kd, vd = kd.to(torch.bfloat16), vd.to(torch.bfloat16)
        if not gqa:
            kd = kd.repeat_interleave(G, dim=1)
            vd = vd.repeat_interleave(G, dim=1)
        S = kd.shape[2]
        mask = lens_of(torch.arange(S, device=q.device), lens)[:, None]
        qq = q[:, :, None, :] if q.dim() == 3 else q.transpose(1, 2)
        out.append((qq, kd, vd, mask))
    return out


def time_paged_launch(torch, P, cfg, name, base, make):
    """One launch of the paged decode (``name`` "paged_decode") or verify
    kernel on ``base`` and rotated copies from ``make()``: device ms
    (graph replay), host-issued ms, the plain version, SDPA (K/V expanded
    to every head, and with ``enable_gqa``) and the bound."""
    import torch.nn.functional as F
    sets = [base] + [make() for _ in range(copies_for(tensor_bytes(*base))
                                           - 1)]
    ops, ref = P["kvq_ops"], P["kvq_ref"]
    verify = name == "spec_verify"
    kern = ops.kvq_spec_verify_attn if verify else ops.kvq_paged_decode_attn
    plain = (ref.kvq_spec_verify_attn_ref if verify
             else ref.kvq_paged_decode_attn_ref)
    t_k = time_ms(torch, kern, sets)
    t_host = host_issued_ms(torch, kern, sets)
    t_p = time_ms(torch, plain, sets, min_calls=10)
    if verify:
        def lens_of(pos, lens):                          # (B, C, S)
            return pos[None, None, :] < lens[:, :, None]
    else:
        def lens_of(pos, lens):                          # (B, 1, S)
            return (pos[None, :] < lens[:, None])[:, None, :]
    lib = {}
    for gqa in (False, True):
        lib_sets = sdpa_paged_sets(torch, P, cfg, sets, lens_of, gqa)
        lib[gqa] = time_ms(torch, lambda q, k, v, m: (
            F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                           enable_gqa=gqa)), lib_sets)
        del lib_sets
        torch.cuda.empty_cache()
    q, _, _, _, _, tbl, lens = base
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    B, T = tbl.shape
    l2 = lens if verify else lens[:, None]
    resident = int(l2.max(dim=1).values.sum())      # each token read once
    nq = q.numel() // (H * D)                       # (slot, query) rows
    es = base[1].element_size()                     # int8 1, bf16 2
    nbytes = (2 * q.numel()                          # q
              + resident * Hkv * (2 * D * es + 8)    # K/V + f32 scales
              + 4 * B * T + 4 * l2.numel()           # table + lengths
              + 2 * q.numel())                       # out
    flops = 4 * int(l2.sum()) * H * D
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    del sets
    torch.cuda.empty_cache()
    return {"ms": t_k, "host_issued_ms": t_host, "plain_ms": t_p,
            "library_ms": lib[False], "library_gqa_ms": lib[True],
            "bound_ms": max(t_b, t_o) * 1e3, "byte_bound_ms": t_b * 1e3,
            "operation_bound_ms": t_o * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bound_share": max(t_b, t_o) * 1e3 / t_k,
            "byte_bound_share": t_b * 1e3 / t_k,
            "lengths": lens.tolist(), "block_size": base[1].shape[2],
            "T": T, "rows": nq}


def per_step(t, n):
    """A per-launch timing as ``n`` launches (a decode step or a
    verify-wave of every layer)."""
    return {"ms": n * t["ms"], "plain_ms": n * t["plain_ms"],
            "library_ms": n * t["library_ms"],
            "bound_ms": n * t["bound_ms"], "bound_by": t["bound_by"]}


def time_paged_decode(torch, P, cfg, dev, report):
    """Per decode step (36 launches) at the paged serve phase's shapes:
    B = 4 slots, T = 8 table entries of 64 tokens; and one launch at the
    long cache (PAGED_LONG, bs 64)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    bs = PAGED_BS[0]
    out = {}
    for key, lengths in (("paged_decode_per_launch", PAGED_LENGTHS),
                         ("paged_decode_long", PAGED_LONG)):
        def make():
            return paged_inputs(torch, gen, cfg, bs, lengths, dev)
        out[key] = time_paged_launch(torch, P, cfg, "paged_decode",
                                     make(), make)
        report[key] = out[key]
    t, lt = out["paged_decode_per_launch"], out["paged_decode_long"]
    print(f"phase 4: kvq_paged_decode_attn per launch: {t['ms'] * 1e3:.2f} "
          f"us (host-issued {t['host_issued_ms'] * 1e3:.2f} us), SDPA "
          f"{t['library_ms'] * 1e3:.2f} us; long cache {PAGED_LONG}: "
          f"{lt['ms'] * 1e3:.2f} us, byte bound "
          f"{lt['byte_bound_ms'] * 1e3:.2f} us (share "
          f"{lt['byte_bound_share']:.3f}), SDPA {lt['library_ms'] * 1e3:.1f}"
          f" us, SDPA gqa {lt['library_gqa_ms'] * 1e3:.1f} us", flush=True)
    return per_step(t, cfg.n_layers)


def time_gather(torch, P, cfg, dev, report):
    """Per tail-wave (one launch per layer, K and V together: 36) at the
    serve phase's largest wave: n = 4 rows, T = 8 entries of 64 tokens;
    a one-leaf launch beside it."""
    ops, ref = P["kvq_ops"], P["kvq_ref"].gather_dequant_paged_kv_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    base = gather_inputs(torch, gen, cfg, dev)
    n, T, bs = GATHER_SHAPE
    Hkv, D = cfg.n_kv_heads, cfg.resolved_head_dim
    out_bytes = 2 * 4 * n * Hkv * T * bs * D
    sets = [base] + [gather_inputs(torch, gen, cfg, dev) for _ in range(
        copies_for(tensor_bytes(*base) + out_bytes) - 1)]
    t_k = time_ms(torch, ops.gather_dequant_paged_kv_pair, sets)
    t_one = time_ms(torch, lambda k, s_k, v, s_v, tbl:
                    ops.gather_dequant_paged_kv(k, s_k, tbl), sets)
    t_host = host_issued_ms(torch, ops.gather_dequant_paged_kv_pair, sets)
    t_p = time_ms(torch, lambda k, s_k, v, s_v, tbl:
                  (ref(k, s_k, tbl), ref(v, s_v, tbl)), sets)
    nb = base[0].shape[0] - 1

    def library(k, s_k, v, s_v, tbl):
        idx = tbl.long().clamp(0, nb - 1)
        return (k[idx].float() * s_k[idx][..., None],
                v[idx].float() * s_v[idx][..., None])

    t_l = time_ms(torch, library, sets)
    rows = n * Hkv * T * bs
    nbytes = 2 * rows * (D + 4) + 4 * n * T + out_bytes
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = 2 * rows * D / F32_FLOPS_PER_S
    per_wave = cfg.n_layers
    report["gather_per_launch"] = {
        "ms": t_k, "us": t_k * 1e3, "one_leaf_us": t_one * 1e3,
        "host_issued_ms": t_host, "plain_ms": t_p, "library_ms": t_l,
        "bound_ms": max(t_b, t_o) * 1e3, "n_T_bs": list(GATHER_SHAPE),
        "leaves": 2}
    return {"ms": per_wave * t_k, "plain_ms": per_wave * t_p,
            "library_ms": per_wave * t_l,
            "bound_ms": per_wave * max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def time_copy(torch, P, cfg, dev, report, layers=COPY_LAYERS):
    """Per COW event: one pair cloned in the four pool leaves (two int8
    payloads, two f32 scale leaves) of the serve phase's 36-layer pool
    (``layers``),
    through one multi-leaf launch (the engine's call); beside it the four
    one-leaf launches it replaced, the plain version and ``x[:, dst] =
    x[:, src]`` on each leaf."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    nb, bs = PAGED_TOKENS * SLOTS // 64, 64
    src = torch.tensor([3], dtype=torch.int32, device=dev)
    dst = torch.tensor([20], dtype=torch.int32, device=dev)
    pairs = torch.stack([src, dst])
    base = pool_leaves(torch, gen, cfg, nb, bs, dev, layers)
    n_copies = copies_for(tensor_bytes(*base))
    sets = [(base,)] + [([x.clone() for x in base],)
                        for _ in range(n_copies - 1)]
    ops, ref = P["kvq_ops"], P["kvq_ref"]

    def one_leaf(leaves):
        for x in leaves:
            ops.copy_pool_blocks(x, src, dst)

    def library(leaves):
        for x in leaves:
            x[:, dst.long()] = x[:, src.long()]

    out = {"ms": time_ms(torch, lambda lv: ops.copy_pool_blocks_multi(
               lv, pairs), sets),
           "one_leaf_ms": time_ms(torch, one_leaf, sets),
           "plain_ms": time_ms(
               torch, lambda lv: ref.copy_pool_blocks_multi_ref(lv, pairs),
               sets),
           "library_ms": time_ms(torch, library, sets)}
    # each leaf's block read once and written once in every layer, and
    # the pair's two ids
    nbytes = sum(2 * x[:, 0].numel() * x.element_size() for x in base) + 8
    out["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    out["bound_by"] = "bytes"
    report["copy_per_cow"] = {**out, "bytes": nbytes, "copies": n_copies}
    del sets, base
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 2 + 4: kvq_spec_verify_attn (the verify-wave's attention)
# --------------------------------------------------------------------------

SPEC_K = 4                     # the CLI's default draft length
SPEC_C = SPEC_K + 1            # window queries per slot
SPEC_T = 8                     # table entries per slot


def spec_histories(bs):
    """Committed history per slot before the window: a long row, a parked
    row (None: every length 0), a window straddling a block boundary and
    a mid-length row."""
    return (SPEC_T * bs - SPEC_C, None, bs - 2, 3 * bs + 8)


def spec_lengths(hist):
    """Per-query extents of verify windows after the histories ``hist``
    (None: a parked row, every length 0)."""
    return [[0] * SPEC_C if h is None else [h + 1 + c for c in range(SPEC_C)]
            for h in hist]


def window_lengths(ends):
    """Per-query extents of windows whose last query reads ``ends[b]``
    tokens (clamped at 0)."""
    return [[max(0, n - SPEC_C + 1 + c) for c in range(SPEC_C)]
            for n in ends]


def spec_inputs(torch, gen, cfg, bs, dev, lens=None):
    """Verify inputs for per-query extents ``lens`` (B lists of C), by
    default the windows after ``spec_histories``; the table spans SPEC_T
    entries or the longest extent."""
    lens = spec_lengths(spec_histories(bs)) if lens is None else lens
    B, C = len(lens), SPEC_C
    T = max(SPEC_T, -(-max(max(x) for x in lens) // bs))
    nb = B * T + 8
    H, D = cfg.n_heads, cfg.resolved_head_dim
    q = torch.randn((B, C, H, D), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v, s_k, s_v = paged_pool(torch, gen, cfg, nb, bs, dev)
    tbl = shuffled_table(torch, gen, nb, B, T, [max(x) for x in lens],
                         bs, dev)
    return (q, k, v, s_k, s_v, tbl,
            torch.tensor(lens, dtype=torch.int32, device=dev))


def check_spec_verify(torch, P, cfg, dev, report):
    """The verify kernel against its plain version within one bf16 ulp at
    both block sizes, a parked row exactly zero, and each query bitwise
    equal to the paged decode kernel at its own length (the property
    exact-mode speculative decoding rests on)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    ops = P["kvq_ops"]
    ref = P["kvq_ref"].kvq_spec_verify_attn_ref
    rtol, atol = KVQ_TOL
    S, NG = ops.SPLIT, MERGE_GROUP
    worst = 0.0
    errs = []
    for bs in PAGED_BS:
        # the serve phase's histories; windows straddling a split and the
        # group boundary beside a parked row and one ending on a split;
        # windows ending at the long cache's lengths
        for lens in (None, spec_lengths((S - 3, None, NG * S - 3, 2 * S - 5)),
                     window_lengths(PAGED_LONG)):
            q, k, v, s_k, s_v, tbl, lens = spec_inputs(torch, gen, cfg, bs,
                                                       dev, lens)
            got = ops.kvq_spec_verify_attn(q, k, v, s_k, s_v, tbl, lens)
            want = ref(q, k, v, s_k, s_v, tbl, lens)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()),
                  f"kvq_spec_verify_attn bs={bs}: non-finite output")
            err = float((got.float() - want.float()).abs().max())
            check(torch.allclose(got.float(), want.float(), rtol=rtol,
                                 atol=atol),
                  f"kvq_spec_verify_attn bs={bs} lengths {lens.tolist()} "
                  f"differs from its plain version: max abs err {err} "
                  f"(rtol {rtol}, atol {atol})")
            for b in range(lens.shape[0]):
                for c in range(SPEC_C):
                    if int(lens[b, c]) == 0:
                        check(bool((got[b, c] == 0).all()),
                              "kvq_spec_verify_attn: a parked row is not "
                              "zero")
            for c in range(SPEC_C):
                one = ops.kvq_paged_decode_attn(q[:, c].contiguous(), k, v,
                                                s_k, s_v, tbl,
                                                lens[:, c].contiguous())
                check(torch.equal(got[:, c], one),
                      f"kvq_spec_verify_attn bs={bs} query {c} is not "
                      f"bitwise equal to kvq_paged_decode_attn at its "
                      f"length (lengths {lens[:, c].tolist()})")
            worst = max(worst, err)
            errs.append({"bs": bs, "lengths": lens.tolist(),
                         "max_abs_err": err})
            del q, k, v, s_k, s_v, got, want
    report["spec_verify_max_abs_err"] = worst
    report["spec_verify_cases"] = errs
    report["spec_verify_bitwise_vs_paged_decode"] = True
    print(f"phase 2: kvq_spec_verify_attn within rtol {rtol} atol {atol} of "
          f"its plain version at bs {PAGED_BS} (max abs err {worst:.3g}; "
          f"B=4, C={SPEC_C}, T={SPEC_T}, a boundary-straddling window and a "
          f"parked row; windows across split {S} and group {NG * S} "
          f"boundaries; windows ending at {PAGED_LONG}); every query "
          f"bitwise equal to kvq_paged_decode_attn", flush=True)
    return worst


def check_norm_rows(torch, P, cfg, dev, report):
    """rms_norm gives each row the same bits in a batch of any row count
    (a verify-wave runs it at M = slots * C rows, decode at M = slots)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    w = {"w": torch.ones(cfg.d_model, device=dev, dtype=torch.bfloat16)}
    rows = SLOTS * SPEC_C
    diffs = mean_diffs = n_rows = 0

    def mean_sq(x):                 # one torch.mean, the CPU path's form
        xf = x.float()
        return torch.mean(xf * xf, dim=-1, keepdim=True)

    for _ in range(8):
        x = torch.randn((rows, cfg.d_model), generator=gen, device=dev).to(
            torch.bfloat16) * 3
        full = P["rms_norm"](x, w, cfg.norm_eps)
        full_var = mean_sq(x)
        for m in (1, SLOTS, 2 * SLOTS):
            diffs += int((P["rms_norm"](x[:m].contiguous(), w, cfg.norm_eps)
                          != full[:m]).sum())
            mean_diffs += int((mean_sq(x[:m].contiguous())
                               != full_var[:m]).sum())
            n_rows += m
        x3 = x.reshape(SLOTS, SPEC_C, cfg.d_model)
        diffs += int((P["rms_norm"](x3[:, :1].contiguous(), w, cfg.norm_eps)
                      != P["rms_norm"](x3, w, cfg.norm_eps)[:, :1]).sum())
    report["rms_norm_row_count_diffs"] = diffs
    # what the two-stage sum replaced: torch.mean's variance, per row
    report["torch_mean_row_count_var_diffs"] = mean_diffs
    check(diffs == 0, f"rms_norm differs across row counts: {diffs} "
                      f"elements")
    print(f"phase 2: rms_norm bitwise equal across row counts 1..{rows} "
          f"(one torch.mean's variance differed in {mean_diffs} of "
          f"{n_rows} rows)",
          flush=True)


def time_spec_verify(torch, P, cfg, dev, report):
    """Per verify-wave (36 launches) at bs = 64: B = 4 slots, C = 5, T = 8,
    the histories of ``spec_histories``; and one launch of windows ending
    at the long cache's lengths."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    bs = PAGED_BS[0]
    out = {}
    for key, lens in (("spec_verify_per_launch", None),
                      ("spec_verify_long", window_lengths(PAGED_LONG))):
        def make():
            return spec_inputs(torch, gen, cfg, bs, dev, lens)
        out[key] = time_paged_launch(torch, P, cfg, "spec_verify",
                                     make(), make)
        report[key] = out[key]
    t, lt = out["spec_verify_per_launch"], out["spec_verify_long"]
    print(f"phase 4: kvq_spec_verify_attn per launch: {t['ms'] * 1e3:.2f} us "
          f"(byte bound {t['byte_bound_ms'] * 1e3:.3f} us, operation bound "
          f"{t['operation_bound_ms'] * 1e3:.3f} us), plain "
          f"{t['plain_ms'] * 1e3:.1f} us, SDPA {t['library_ms'] * 1e3:.2f} "
          f"us; windows ending at {PAGED_LONG}: {lt['ms'] * 1e3:.2f} us, "
          f"bound {lt['bound_ms'] * 1e3:.2f} us ({lt['bound_by']}), SDPA "
          f"{lt['library_ms'] * 1e3:.1f} us, SDPA gqa "
          f"{lt['library_gqa_ms'] * 1e3:.1f} us", flush=True)
    return per_step(t, cfg.n_layers)


# --------------------------------------------------------------------------
# phase 2 + 4: fake_quant_fwd / fake_quant_bwd (the QAT path's LSQ sites)
# --------------------------------------------------------------------------

BF16_PEAK_FLOPS = 989e12       # dense bf16 tensor-core peak
TRAIN_B, TRAIN_T = 8, 128      # the QAT phase's batch and sequence
TRAIN_STEPS = 4
FLASH_TOL = (2.0 ** -7, 2.0 ** -7)   # rtol, atol (see check_flash)
FLASH_ULP_SHARE = 5e-2         # of elements allowed beyond one ulp
FLASH_ORACLE_RATIO = 1.5       # kernel's f64-oracle error / plain's
FQ_DS_TOL = 1e-4               # of gscale * sum |g * dq/ds| per scale
GRAD_REL_TOL = 1e-3            # per-leaf relative L2, fake-quant kernels
GRAD_REL_TOL_STEP = 1e-1       # the same, whole step (see grads_vs_plain)


def fq_shapes(cfg):
    """(site, R, C, mode, bits, launches per student step): every weight
    of A8d-C8-W4 (mode 1: per output channel; the tied head in mode 2, per
    vocab row of embed.w, at head_bits 8) and, per tensor (mode 0), the
    activation sites a static policy adds at B * T = 1024 tokens: s_in on
    the linears' inputs, and s_q / s_k / s_v on the (B, T, heads, D)
    attention operands, which the kernel reads as (B * T * heads, D)."""
    d, f, qd, kvd, L = (cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim,
                        cfg.n_layers)
    tok = TRAIN_B * TRAIN_T
    return [("wq", d, qd, 1, 4, L), ("wk", d, kvd, 1, 4, L),
            ("wv", d, kvd, 1, 4, L), ("wo", qd, d, 1, 4, L),
            ("wg", d, f, 1, 4, L), ("wu", d, f, 1, 4, L),
            ("wd", f, d, 1, 4, L), ("head", cfg.vocab_size, d, 2, 8, 1),
            ("act_d", tok, d, 0, 8, 0), ("act_ff", tok, f, 0, 8, 0),
            ("act_q", tok * cfg.n_heads, cfg.resolved_head_dim, 0, 8, 0),
            ("act_kv", tok * cfg.n_kv_heads, cfg.resolved_head_dim, 0, 8, 0)]


def fq_inputs(torch, gen, R, C, mode, bits, dev):
    """x bf16 (weights ~0.02, activations ~1), s near absmax / qp so some
    values clip, g bf16 for the backward."""
    qp = 2 ** (bits - 1) - 1
    x = torch.randn((R, C), generator=gen, device=dev) * (
        1.0 if mode == 0 else 0.02)
    if mode == 0:
        s = x.abs().amax() / qp * 0.8
    elif mode == 1:
        s = x.abs().amax(0, keepdim=True) / qp * (
            0.5 + 0.5 * torch.rand((1, C), generator=gen, device=dev))
    else:
        s = x.abs().amax(1, keepdim=True) / qp * (
            0.5 + 0.5 * torch.rand((R, 1), generator=gen, device=dev))
    g = torch.randn((R, C), generator=gen, device=dev) * 1e-3
    return (x.to(torch.bfloat16), s.float().contiguous(),
            g.to(torch.bfloat16))


def fq_ds_mass(torch, P, x, s, g, bits):
    """gscale * sum |g * dq/ds| per scale: the scale of the f32 sums'
    order error."""
    qn, qp = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    v = x.float() / torch.clamp_min(s, 1e-9)
    dq = torch.where((v >= qn) & (v <= qp), torch.round(v) - v,
                     torch.clamp(v, qn, qp))
    mass = (g.float() * dq).abs()
    del v, dq
    dims = {0: None, 1: (0,), 2: (1,), 3: (1,)}[
        P["fq_ops"].scale_mode(x, s)]
    mass = mass.sum() if dims is None else mass.sum(dim=dims, keepdim=True)
    return mass.reshape(s.shape) * P["fq_ops"].grad_scale(x, s, bits)


def fq_ragged_shapes(cfg):
    """(case, R, C, mode, bits, offset) ragged against the backward's
    per-column tiling (bands of rows in multiples of 32, strips of 256
    bf16 columns, 16-byte packs): R one past a band (33 rows at C 256:
    bands of 32; 2049 at C 2048: bands of 64), C not a multiple of 8 (the
    one-element path) in each mode, and an x that starts one element into
    its buffer (``offset``: not 16-byte aligned, the one-element path)."""
    d, kvd = cfg.d_model, cfg.kv_dim
    return [("R one past a band", 33, kvd, 1, 4, 0),
            ("R one past a band", d + 1, d, 1, 4, 0),
            ("C not a multiple of 8", 300, 1001, 1, 8, 0),
            ("C not a multiple of 8", 77, 1001, 2, 8, 0),
            ("C not a multiple of 8", 129, 1001, 0, 8, 0),
            ("x not 16-byte aligned", 257, d, 1, 4, 1),
            ("x not 16-byte aligned", 100, d, 0, 8, 1)]


def fq_case_checks(torch, P, gen, cases, dev):
    """fake_quant_fwd and the dx of fake_quant_bwd bitwise equal to their
    plain versions, ds within FQ_DS_TOL of its sums' mass and bitwise
    equal from one call to the next, at bits 4 and 8, on each (site, R,
    C, mode, offset) of ``cases`` (``offset``: x starts that many
    elements into its buffer). Returns (cases compared, worst ds)."""
    ops, ref = P["fq_ops"], P["fq_ref"]
    worst_ds, n = 0.0, 0
    for site, R, C, mode, off in cases:
        for bits in (4, 8):
            x, s, g = fq_inputs(torch, gen, R, C, mode, bits, dev)
            if off:
                buf = torch.empty(R * C + off, dtype=x.dtype, device=dev)
                buf[off:] = x.reshape(-1)
                x = buf[off:].view(R, C)
                check(x.data_ptr() % 16 != 0, f"{site}: x is aligned")
            got = ops.fake_quant_fwd(x, s, bits)
            want = ref.fake_quant_fwd_ref(x, s, bits)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"fake_quant_fwd {site} bits {bits} differs from its plain "
                  f"version in {int((got != want).sum())} elements")
            del got, want
            dx, ds = ops.fake_quant_bwd(x, s, g, bits)
            _, ds2 = ops.fake_quant_bwd(x, s, g, bits)
            dx_p, ds_p = ops.fake_quant_bwd(x, s, g, bits, plain=True)
            torch.cuda.synchronize()
            check(torch.equal(dx, dx_p),
                  f"fake_quant_bwd {site} bits {bits}: dx differs from its "
                  f"plain version in {int((dx != dx_p).sum())} elements")
            check(torch.equal(ds, ds2),
                  f"fake_quant_bwd {site} bits {bits}: ds differs between "
                  f"two calls in {int((ds != ds2).sum())} scales")
            mass = fq_ds_mass(torch, P, x, s, g, bits)
            rel = float(((ds - ds_p).abs() / mass.clamp_min(1e-30)).max())
            check(bool(torch.isfinite(ds).all()) and rel <= FQ_DS_TOL,
                  f"fake_quant_bwd {site} bits {bits}: ds off its plain "
                  f"version by {rel} of its sums' mass (> {FQ_DS_TOL})")
            worst_ds = max(worst_ds, rel)
            n += 1
            del x, s, g, dx, ds, ds2, dx_p, ds_p, mass
    torch.cuda.empty_cache()
    return n, worst_ds


def check_fake_quant(torch, P, cfg, dev, report):
    """fake_quant_fwd and the dx of fake_quant_bwd bitwise equal to their
    plain versions, ds within FQ_DS_TOL of its sums' mass and bitwise
    equal from one call to the next, on every weight shape of qwen2.5-3b,
    the activation shapes of a static policy and the ragged cases; then
    the backward's launcher refuses a workspace one element short."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    cases = [(site, R, C, mode, 0) for site, R, C, mode, _, _ in
             fq_shapes(cfg)]
    cases += [(f"{what} ({R} x {C}, mode {mode})", R, C, mode, off)
              for what, R, C, mode, _, off in fq_ragged_shapes(cfg)]
    n, worst_ds = fq_case_checks(torch, P, gen, cases, dev)
    check_fq_workspace(torch, P, cfg, dev)
    report["fake_quant_checked"] = n
    report["fake_quant_ds_rel_mass_err"] = worst_ds
    print(f"phase 2: fake_quant_fwd and dx of fake_quant_bwd bitwise equal "
          f"to their plain versions on {n} cases (every weight shape of "
          f"qwen2.5-3b per channel, the tied head per row, two linear-input "
          f"and two attention shapes per tensor, {len(fq_ragged_shapes(cfg))}"
          f" ragged or misaligned shapes; bits 4 and 8); ds within "
          f"{worst_ds:.3g} of its sums' mass (tolerance {FQ_DS_TOL}) and "
          f"bitwise equal from call to call; the backward refuses a "
          f"workspace one element short", flush=True)
    return 0.0


# the archs whose QAT phases (6-6g) compare no loss and backward with the
# plain versions: (arch, layers built for the shapes, one of each kind)
FQ_CUT_ARCHS = (("xlstm-125m", 12), ("recurrentgemma-2b", 3),
                ("mixtral-8x7b", 1), ("moonshot-v1-16b-a3b", 1),
                ("qwen3-14b", 1))


def weight_fq_cases(torch, P, arch, layers, dev):
    """(site, R, C, mode, offset) of every distinct weight shape the QAT
    student of ``arch`` fake-quantizes outside the expert banks (whose
    mode-3 checks are ``check_mx_kernels``' and ``check_new_kernels'``):
    each linear's (d_in, d_out) weight per output channel (mode 1) and a
    tied head's (vocab, d) table per vocab row (mode 2), read off the
    tree ``init_params`` builds at full width and ``layers`` layers."""
    cfg = P["get_config"](arch).replace(n_layers=layers)
    leaves = dict(_named_leaves(P["models"].init_params(cfg, seed=0,
                                                        device=dev)))
    seen, out = set(), []
    for path, t in leaves.items():
        if (path.endswith("/w") and t.dim() == 2
                and path[:-1] + "s_w" in leaves
                and tuple(t.shape) not in seen):
            seen.add(tuple(t.shape))
            out.append((f"{arch} {path}", t.shape[0], t.shape[1], 1, 0))
    if cfg.tie_embeddings:
        out.append((f"{arch} tied head", cfg.vocab_size, cfg.d_model, 2, 0))
    del leaves
    torch.cuda.empty_cache()
    return out


def check_cut_fake_quant(torch, P, dev, report):
    """``fq_case_checks`` (fwd and dx bitwise, ds within FQ_DS_TOL) on the
    weight shapes of the archs whose QAT phases compare no loss and
    backward with the plain versions (``FQ_CUT_ARCHS``)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    cases = [c for arch, layers in FQ_CUT_ARCHS
             for c in weight_fq_cases(torch, P, arch, layers, dev)]
    n, worst_ds = fq_case_checks(torch, P, gen, cases, dev)
    report["fake_quant_cut_archs"] = {
        "cases": n, "ds_rel_mass_err": worst_ds,
        "shapes": [c[:4] for c in cases]}
    print(f"phase 2: fake_quant_fwd and dx of fake_quant_bwd bitwise equal "
          f"to their plain versions on {n} cases, every weight shape "
          f"outside the expert banks of "
          f"{[a for a, _ in FQ_CUT_ARCHS]} (bits 4 and 8; ds within "
          f"{worst_ds:.3g} of its sums' mass)", flush=True)
    return worst_ds


def check_fq_workspace(torch, P, cfg, dev):
    """fake_quant_bwd's launcher refuses (cudaErrorInvalidValue, 1) a
    workspace one element shorter than ``fake_quant_bwd_workspace`` asks
    for, per column and per tensor, and writes nothing. Calls the C
    launcher directly: nothing launches, no count moves."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    d = cfg.d_model
    for R, C, mode in ((d, d, 1), (d + 1, cfg.kv_dim, 1), (d, d, 0)):
        x, s, g = fq_inputs(torch, gen, R, C, mode, 4, dev)
        workspace_refused(torch, P, x, s, g, (1, R, C), mode, dev)


def time_fake_quant(torch, P, cfg, dev, report, shapes=None):
    """Per student step: the forward and the backward of every weight site
    (253 launches each), summed over the shapes' per-step counts
    (``shapes``: ``fq_shapes``' rows, qwen's when not given)."""
    ops, ref = P["fq_ops"], P["fq_ref"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    fwd = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    bwd = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    fwd_bytes = bwd_bytes = fwd_ops = bwd_ops = 0
    rows = []
    for site, R, C, mode, bits, per_step in shapes or fq_shapes(cfg):
        if not per_step:
            continue
        nb = R * C * 2
        sets = [fq_inputs(torch, gen, R, C, mode, bits, dev)
                for _ in range(copies_for(nb))]
        qn, qp = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
        axis = 1 if mode == 1 else 0
        row = {"site": site, "R": R, "C": C, "mode": mode, "bits": bits,
               "per_step": per_step}
        row["fwd_ms"] = time_ms(torch, lambda x, s, g: ops.fake_quant_fwd(
            x, s, bits), sets)
        row["fwd_plain_ms"] = time_ms(
            torch, lambda x, s, g: ref.fake_quant_fwd_ref(x, s, bits),
            sets[:1], min_calls=5)
        row["bwd_ms"] = time_ms(torch, lambda x, s, g: ops.fake_quant_bwd(
            x, s, g, bits), sets)
        row["bwd_plain_ms"] = time_ms(
            torch, lambda x, s, g: ops.fake_quant_bwd(x, s, g, bits,
                                                      plain=True),
            sets[:1], min_calls=5)
        n_s = sets[0][1].numel()
        zp = torch.zeros(n_s, dtype=torch.int32, device=dev)
        lib = [(x, s.reshape(-1), g) for x, s, g in sets]
        # the library op checks its zero points on the host, which a
        # CUDA graph capture refuses: timed as eager calls
        row["fwd_library_ms"] = time_eager_ms(
            torch, lambda x, s, g: torch.fake_quantize_per_channel_affine(
                x, s, zp, axis, qn, qp), lib)
        zpf = torch.zeros(n_s, dtype=torch.float32, device=dev)

        def lib_bwd(x, s, g):
            xr = x.detach().requires_grad_(True)
            sr = s.detach().requires_grad_(True)
            y = torch._fake_quantize_learnable_per_channel_affine(
                xr, sr, zpf, axis, qn, qp, 1.0)
            return torch.autograd.grad(y, (xr, sr), g)

        row["bwd_library_ms"] = time_eager_ms(torch, lib_bwd, lib)
        rows.append(row)
        for d_, k in ((fwd, "fwd"), (bwd, "bwd")):
            d_["ms"] += per_step * row[f"{k}_ms"]
            d_["plain_ms"] += per_step * row[f"{k}_plain_ms"]
            d_["library_ms"] += per_step * row[f"{k}_library_ms"]
        n_el = R * C
        fwd_bytes += per_step * (4 * n_el + 4 * n_s)
        bwd_bytes += per_step * (6 * n_el + 8 * n_s)
        fwd_ops += per_step * 4 * n_el          # divide, clip, round, scale
        bwd_ops += per_step * 8 * n_el
        del sets, lib
        torch.cuda.empty_cache()
    report["fake_quant_per_shape"] = rows
    out = []
    for d_, nbytes, nops in ((fwd, fwd_bytes, fwd_ops),
                             (bwd, bwd_bytes, bwd_ops)):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS_PER_S
        d_["bound_ms"] = max(t_b, t_o) * 1e3
        d_["bound_by"] = "bytes" if t_b >= t_o else "operations"
        out.append(d_)
    return out


def time_eager_ms(torch, fn, arg_sets, min_calls=10):
    """Device ms per call issued eagerly between two events (for a call
    that runs autograd, which a CUDA graph capture would not take)."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    n = max(min_calls, len(arg_sets))
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(*arg_sets[i % len(arg_sets)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


# --------------------------------------------------------------------------
# phase 2 + 4: flash_attn_fwd (attention without a gradient)
# --------------------------------------------------------------------------

# (B, S, window): the QAT phase's shape, the PTQ phase's evaluation shape
# (the tables' batch 8 x 64), TrainConfig's default seq_len, a ragged
# length and a sliding window
FLASH_CASES = ((TRAIN_B, TRAIN_T, 0), (8, 64, 0), (2, 1024, 0),
               (3, 333, 0), (2, 200, 64))
# the same checks at the kernel's other head dim, 64 (qwen's heads are 128)
FLASH_D64_CASES = ((TRAIN_B, TRAIN_T, 0), (3, 333, 0), (2, 200, 64))
FLASH_LONG = (TRAIN_B, 1024)   # the paper's sequence length, timed


def flash_inputs(torch, gen, cfg, B, S, dev, D=None, Skv=None):
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    D = D or cfg.resolved_head_dim
    Skv = Skv or S
    return tuple(torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in ((B, S, H, D), (B, Skv, Hkv, D),
                                      (B, Skv, Hkv, D)))


def check_flash(torch, P, cfg, dev, report):
    """The kernel against its plain version, and both against an f64
    softmax attention with unrounded probabilities (the oracle).

    P is rounded to bf16 before P.V, as in the reference. Scores summed in
    another order than cuBLAS's put some probabilities on the neighbouring
    bf16 value (one in a few thousand), and for a query with few keys
    (early causal rows) one such flip moves the output by up to about
    2^-8 of the spread of its V rows, whatever the output's own size
    (1.05% of the elements beyond one ulp, max 0.0039, read at S 128 on
    the card). So the kernel is held to ``FLASH_TOL`` (rtol one bf16 ulp,
    atol 2^-7 for V rows of unit scale) and ``FLASH_ULP_SHARE`` beyond
    one ulp, and its error against the oracle to at most
    ``FLASH_ORACLE_RATIO`` times the plain version's."""
    fa, ref = P["fa_ops"].flash_attn_fwd, P["flash_attn_ref"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    rtol, atol = FLASH_TOL
    worst, cases = 0.0, []
    D0 = cfg.resolved_head_dim
    for B, S, window, D in ([c + (D0,) for c in FLASH_CASES]
                            + [c + (64,) for c in FLASH_D64_CASES]):
        q, k, v = flash_inputs(torch, gen, cfg, B, S, dev, D)
        got = fa(q, k, v, causal=True, window=window).float()
        want = ref(q, k, v, causal=True, window=window).float()
        oracle = flash_oracle(torch, q, k, v, window)
        torch.cuda.synchronize()
        err = (got - want).abs()
        beyond_ulp = float((err > KVQ_TOL[1] + KVQ_TOL[0] * want.abs())
                           .float().mean())
        e_k = float((got - oracle).abs().max())
        e_p = float((want - oracle).abs().max())
        cases.append({"B": B, "S": S, "window": window, "D": D,
                      "max_abs_err": float(err.max()),
                      "share_beyond_one_ulp": beyond_ulp,
                      "kernel_vs_oracle": e_k, "plain_vs_oracle": e_p})
        check(bool(torch.isfinite(got).all()),
              f"flash_attn_fwd B={B} S={S}: non-finite")
        check(torch.allclose(got, want, rtol=rtol, atol=atol)
              and beyond_ulp <= FLASH_ULP_SHARE
              and e_k <= FLASH_ORACLE_RATIO * e_p,
              f"flash_attn_fwd B={B} S={S} window={window} D={D} differs "
              f"from its "
              f"plain version: {cases[-1]} (rtol {rtol}, atol {atol}, at "
              f"most {FLASH_ULP_SHARE} beyond one ulp, oracle error at most "
              f"{FLASH_ORACLE_RATIO}x the plain version's)")
        worst = max(worst, float(err.max()))
        del q, k, v, got, want, oracle, err
    report["flash_check"] = cases
    print(f"phase 2: flash_attn_fwd within rtol {rtol} atol {atol} of its "
          f"plain version at H={cfg.n_heads}, Hkv={cfg.n_kv_heads}, "
          f"D={D0} and 64: {cases}", flush=True)
    return worst


def flash_oracle(torch, q, k, v, window, causal=True):
    """Softmax attention in f64 with unrounded probabilities, causal (and
    windowed) or, not ``causal``, each query over every key."""
    B, S, H, D = q.shape
    g = H // k.shape[2]
    kr = k.double().repeat_interleave(g, dim=2)
    vr = v.double().repeat_interleave(g, dim=2)
    s_ = torch.einsum("bqhd,bkhd->bhqk", q.double(), kr) * D ** -0.5
    i = torch.arange(S, device=q.device)
    j = torch.arange(k.shape[1], device=q.device)
    mask = (i[:, None] >= j[None, :] if causal
            else torch.ones((S, k.shape[1]), dtype=torch.bool,
                            device=q.device))
    if window:
        mask &= i[:, None] - i[None, :] < window
    s_ = s_.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s_, -1), vr).float()


def time_flash_launch(torch, P, cfg, dev, gen, B, S, plain_calls,
                      Skv=None, causal=True):
    """One flash launch at (B, S), causal (or, not ``causal``, S queries
    over ``Skv`` keys, every pair), on rotated inputs: device ms, the
    plain version (``plain_calls`` calls on two sets), SDPA with
    ``enable_gqa`` and the bound: the bytes (q, k, v read once, out
    written once) or the QK^T and P.V of the unmasked pairs at the bf16
    tensor-core rate, the larger."""
    import torch.nn.functional as F
    fa, ref = P["fa_ops"].flash_attn_fwd, P["flash_attn_ref"]
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    Skv = Skv or S
    base = flash_inputs(torch, gen, cfg, B, S, dev, Skv=Skv)
    sets = [base] + [flash_inputs(torch, gen, cfg, B, S, dev, Skv=Skv)
                     for _ in range(copies_for(tensor_bytes(*base)) - 1)]
    t_k = time_ms(torch, lambda q, k, v: fa(q, k, v, causal=causal), sets)
    t_p = time_ms(torch, lambda q, k, v: ref(q, k, v, causal=causal),
                  sets[:2], min_calls=plain_calls)
    lib = [tuple(t.transpose(1, 2) for t in s) for s in sets]
    t_l = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True), lib)
    pairs = S * (S + 1) // 2 if causal else S * Skv   # (query, key) pairs
    flops = 4 * B * H * D * pairs               # QK^T and P.V
    nbytes = 2 * (2 * B * S * H * D + 2 * B * Skv * Hkv * D)  # q, o, k, v
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_PEAK_FLOPS
    del sets, lib
    torch.cuda.empty_cache()
    return {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
            "bound_ms": max(t_b, t_o) * 1e3, "byte_bound_ms": t_b * 1e3,
            "operation_bound_ms": t_o * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "flops": flops, "bytes": nbytes, "B": B, "S": S, "Skv": Skv,
            "causal": causal}


def time_flash(torch, P, cfg, dev, report):
    """Per teacher forward: 36 launches at the QAT phase's shape; and one
    launch at FLASH_LONG (S 1024)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    t = time_flash_launch(torch, P, cfg, dev, gen, TRAIN_B, TRAIN_T, 10)
    lt = time_flash_launch(torch, P, cfg, dev, gen, *FLASH_LONG, 4)
    report["flash_per_launch"], report["flash_long"] = t, lt
    print(f"phase 4: flash_attn_fwd per launch at (B, S) = "
          f"({TRAIN_B}, {TRAIN_T}): {t['ms'] * 1e3:.2f} us (bound "
          f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}), SDPA "
          f"{t['library_ms'] * 1e3:.2f} us; at {FLASH_LONG}: "
          f"{lt['ms'] * 1e3:.2f} us (bound {lt['bound_ms'] * 1e3:.2f} us by "
          f"{lt['bound_by']}), SDPA {lt['library_ms'] * 1e3:.2f} us",
          flush=True)
    return per_step(t, cfg.n_layers)


# --------------------------------------------------------------------------
# phase 5: QAT at full width; 5b: a static policy
# --------------------------------------------------------------------------

def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def train_counters(P):
    return (P["fq_ops"].fake_quant_fwd, P["fq_ops"].fake_quant_bwd,
            P["fa_ops"].flash_attn_fwd, P["slstm_ops"].slstm_scan)


def train_flops(cfg, B, T):
    """Model FLOPs of one QAT step: the teacher's forward (2 N per token)
    and the student's forward and backward (6 N), N the matmul weights a
    token meets (the tied head counted once; an MoE layer's active
    experts and its router, as ``param_counts``' active count), plus
    attention's QK^T and P.V over all (query, key) pairs, three times for
    the student."""
    d, f, qd, kvd, L = (cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim,
                        cfg.n_layers)
    ffn = (cfg.n_experts_active * 3 * d * f + d * cfg.n_experts
           if cfg.is_moe else 3 * d * f)
    n_mm = L * (2 * d * qd + 2 * d * kvd + ffn) + d * cfg.vocab_size
    attn = L * 4 * B * T * T * qd
    return 8 * n_mm * B * T + 4 * attn


def train_full(torch, P, cfg, dev, report):
    """run_qat on qwen2.5-3b at full width and depth, A8d-C8-W4."""
    tcfg = P["TrainConfig"](precision="A8d-C8-W4", total_steps=TRAIN_STEPS,
                            ref_steps=TRAIN_STEPS, batch_size=TRAIN_B,
                            seq_len=TRAIN_T)
    fq_fwd, fq_bwd, fa, _ = train_counters(P)
    steps, state = [], {}

    def on_start(student, opt):
        state["s_w0"] = {k: t.detach().clone() for k, t in
                         _named_leaves(student) if k.endswith("s_w")}
        state["counts"] = tuple(fn.launches for fn in train_counters(P))

    def on_step(step, metrics, student, opt):
        counts = tuple(fn.launches for fn in train_counters(P))
        steps.append({"step": step, "loss": float(metrics["loss"]),
                      "ms": metrics["ms"],
                      "launches": [a - b for a, b in
                                   zip(counts, state["counts"])]})
        state["counts"] = counts
        state["opt"] = opt

    for fn in train_counters(P):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    teacher, student, _ = P["train"].run_qat(
        "qwen2.5-3b", tcfg, reduced=False, teacher_steps=2, device=dev,
        log_every=1, split_times=True, on_start=on_start, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fake_quant_fwd": fq_fwd.launches,
                "fake_quant_bwd": fq_bwd.launches,
                "flash_attn_fwd": fa.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    n_w = 7 * cfg.n_layers + 1
    for s in steps:
        check(s["launches"] == [n_w, n_w, cfg.n_layers, 0],
              f"QAT step {s['step']}: launches (fake_quant_fwd, "
              f"fake_quant_bwd, flash_attn_fwd, slstm_scan) = "
              f"{s['launches']}, want ({n_w}, {n_w}, {cfg.n_layers}, 0)")
        check(math.isfinite(s["loss"]), f"QAT step {s['step']}: KD loss "
                                        f"{s['loss']}")
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} QAT steps ran")
    opt = state.pop("opt")
    named = dict(_named_leaves(student))
    unmoved = [k for k, t0_ in state["s_w0"].items()
               if torch.equal(named[k], t0_)]
    check(len(state["s_w0"]) == n_w and not unmoved,
          f"s_w that did not move: {unmoved[:5]} ({len(unmoved)})")
    zero_m = sorted({k.split("/")[-1] for k, m in _named_leaves(opt.m)
                     if not bool(m.any())})
    check(zero_m == ["s_in", "s_k", "s_q", "s_v"],
          f"AdamW first moments all zero on {zero_m}: under A8d exactly the "
          f"unread activation scales may be")
    check(all(bool(v.any()) for k, v in _named_leaves(opt.v)
              if k.split("/")[-1] not in zero_m),
          "a read leaf has all-zero second moments")
    check(all(bool(torch.isfinite(t).all()) for t in named.values()),
          "a parameter is not finite after QAT")
    check(int(opt.step) == TRAIN_STEPS, f"AdamW step {int(opt.step)}")

    # the device's idle share over one more step, under the profiler
    idle = profile_train_step(torch, P, cfg, tcfg, teacher, student, opt,
                              steps, dev, report)
    del opt, state
    torch.cuda.empty_cache()

    per = {k: sum(s["ms"][k] for s in steps[1:]) / (len(steps) - 1)
           for k in ("teacher", "student", "optimizer")}
    step_ms = sum(per.values())
    flops = train_flops(cfg, TRAIN_B, TRAIN_T)
    trained = {"steps": TRAIN_STEPS, "batch": TRAIN_B, "seq": TRAIN_T,
               "losses": [s["loss"] for s in steps],
               "ms_per_step": step_ms, "ms_split": per,
               "ms_first_step": sum(steps[0]["ms"].values()),
               "tokens_per_s": TRAIN_B * TRAIN_T / (step_ms / 1e3),
               "peak_memory_bytes": peak, "wall_s": wall,
               "device_idle_share": idle,
               "model_flops_per_step": flops,
               "model_flops_share": flops / (step_ms / 1e3) / BF16_PEAK_FLOPS,
               "launches": launches}
    report["train"] = trained
    print("phase 5: " + json.dumps(trained), flush=True)
    grads_vs_plain(torch, P, cfg, tcfg, teacher, student, dev, report)
    return launches, teacher, student


def profile_train_step(torch, P, cfg, tcfg, teacher, student, opt, steps,
                       dev, report, key="train_profile"):
    """One train step under ``torch.profiler`` (phase 5's; the other QAT
    phases' idle shares stand in PERF.md as measured before): the
    device's busy ms beside the step's wall ms; returns the idle share."""
    from torch.profiler import ProfilerActivity, profile
    step_fn = P["steps"].make_train_step(cfg, tcfg)
    it = P["MixtureIterator"](P["SyntheticConfig"](
        vocab_size=cfg.vocab_size, seq_len=TRAIN_T,
        batch_size=TRAIN_B), start_step=1 + TRAIN_STEPS)
    batch = P["to_device"](next(it), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(student, teacher, opt, batch, TRAIN_STEPS - 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        report[key] = "not measured: no device records"
        return None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    report[key] = {
        "step_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
        "kernels": len(kernels),
        "top_kernels_us": [(n[:90], us) for n, us in top]}
    return max(0.0, 1.0 - busy_ms / wall_ms)


def _grad_gaps(torch, ga, gb):
    """Per-leaf relative L2 gaps of two gradient trees: (worst, its leaf,
    leaves compared, leaves bitwise equal)."""
    worst, worst_key, n, same = 0.0, "", 0, 0
    for (k, a), (_, b) in zip(_named_leaves(ga), _named_leaves(gb)):
        if a is None or b is None:
            check(a is None and b is None, f"gradient {k} only on one side")
            continue
        rel = float(torch.linalg.vector_norm(a.float() - b.float())
                    / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))
        n += 1
        same += int(torch.equal(a, b))
        if rel > worst:
            worst, worst_key = rel, k
    return worst, worst_key, n, same


def grads_vs_plain(torch, P, cfg, tcfg, teacher, student, dev, report,
                   key="train_vs_plain", phase="phase 5", batch=None):
    """One loss and backward on one batch (``batch``, or a synthetic B 8,
    T 128 one) and the same parameters, through the kernels and through
    their plain versions (launches not counted).

    Twice: the whole step (teacher forward through ``flash_attn_fwd`` or
    ``slstm_scan``, or their plain versions), and the student alone
    against one set of teacher logits, which isolates the fake-quant
    kernels. The teacher's logits are bf16: a one-ulp move of a logit
    near 16 (0.125) moves its probability by 13%, and the teacher's
    kernels move some logits so (check on the teacher logits below), so
    the whole step's gradients are held
    to ``GRAD_REL_TOL_STEP``; with the teacher's logits shared, the
    forward is bitwise and the backward differs only in the order of the
    LSQ step-size sums: ``GRAD_REL_TOL``."""
    t_start = time.perf_counter()
    qat, models = P["qat"], P["models"]
    text = P["steps"]._text_logits
    if batch is None:
        it = P["MixtureIterator"](P["SyntheticConfig"](
            vocab_size=cfg.vocab_size, seq_len=TRAIN_T, batch_size=TRAIN_B),
            start_step=1)
        batch = P["to_device"](next(it), dev)
    counts = [fn.launches for fn in train_counters(P)]
    lk, gk = P["steps"].make_train_step(cfg, tcfg).loss_and_grads(
        student, teacher, batch)
    lp, gp = P["steps"].make_train_step(
        cfg, tcfg, kernel_backend="ref").loss_and_grads(student, teacher,
                                                        batch)
    step_gap = _grad_gaps(torch, gk, gp)
    del gk, gp
    with torch.no_grad():
        t_k = text(cfg, models.forward(cfg, teacher, qat.make_ctx(
            "A16-C16-W16", mode="off"), batch)[0])
        t_p = text(cfg, models.forward(cfg, teacher, qat.make_ctx(
            "A16-C16-W16", mode="off", kernel_backend="ref"), batch)[0])
        t_rel = float(torch.linalg.vector_norm((t_k - t_p).float())
                      / torch.linalg.vector_norm(t_p.float()))
        t_flips = float((t_k != t_p).float().mean())
    del t_p
    student_only = {}
    for backend in ("auto", "ref"):
        ctx = qat.make_ctx(tcfg.precision, kernel_backend=backend)
        logits, aux = models.forward(cfg, student, ctx, batch,
                                     remat=tcfg.remat != "none")
        loss = P["silq_loss"](text(cfg, logits), t_k, batch["labels"],
                              mask=batch["loss_mask"])
        if cfg.is_moe:
            loss = loss + P["steps"].MOE_AUX_COEF * aux["moe_aux"]
        del logits
        student_only[backend] = (loss.detach(),
                                 P["steps"].grads_of(loss, student))
        del loss
    (ls_k, gs_k), (ls_p, gs_p) = student_only["auto"], student_only["ref"]
    fq_gap = _grad_gaps(torch, gs_k, gs_p)
    del student_only, gs_k, gs_p, t_k
    for fn, c in zip(train_counters(P), counts):
        fn.launches = c
    torch.cuda.empty_cache()
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    out = {"loss_kernels": float(lk), "loss_plain": float(lp),
           "loss_rel_err": loss_rel, "teacher_logits_rel_l2": t_rel,
           "teacher_logits_share_differing": t_flips,
           "step_grad_max_rel_l2": step_gap[0],
           "step_grad_worst_leaf": step_gap[1], "grad_leaves": step_gap[2],
           "student_only_loss_equal": bool(float(ls_k) == float(ls_p)),
           "student_only_grad_max_rel_l2": fq_gap[0],
           "student_only_grad_worst_leaf": fq_gap[1],
           "student_only_grad_leaves_bitwise": fq_gap[3],
           "seconds": time.perf_counter() - t_start}
    report[key] = out
    check(loss_rel <= 1e-3, f"KD loss through the kernels {float(lk)} vs "
                            f"plain {float(lp)}: relative {loss_rel}")
    check(step_gap[0] <= GRAD_REL_TOL_STEP,
          f"gradient {step_gap[1]} of the whole step through the kernels "
          f"off the plain versions' by relative L2 {step_gap[0]} > "
          f"{GRAD_REL_TOL_STEP}")
    check(float(ls_k) == float(ls_p),
          f"student loss through the fake-quant kernels {float(ls_k)} vs "
          f"plain {float(ls_p)} on the same teacher logits")
    check(fq_gap[0] <= GRAD_REL_TOL,
          f"gradient {fq_gap[1]} through the fake-quant kernels off the "
          f"plain versions' by relative L2 {fq_gap[0]} > {GRAD_REL_TOL}")
    print(f"{phase}: one loss and backward, kernels vs plain versions: "
          + json.dumps(out), flush=True)


def train_static(torch, P, cfg, dev, report):
    """A8s-C8-W4 at full width, 4 layers: percentile calibration over 5
    batches (the calibration forward runs flash_attn_fwd), then one step."""
    L = 4
    tcfg = P["TrainConfig"](precision="A8s-C8-W4", total_steps=1,
                            ref_steps=1, batch_size=TRAIN_B, seq_len=TRAIN_T)
    seen = {}

    def on_start(student, opt):
        seen["calib"] = [fn.launches for fn in train_counters(P)]
        s_in = student["layers"][0]["attn"]["wq"]["s_in"]
        seen["s_in"] = float(s_in.detach())

    def on_step(step, metrics, student, opt):
        seen["loss"] = float(metrics["loss"])

    for fn in train_counters(P):
        fn.launches = 0
    P["train"].run_qat("qwen2.5-3b", tcfg, reduced=False, teacher_steps=1,
                       device=dev, n_layers=L, log_every=1,
                       on_start=on_start, on_step=on_step)
    torch.cuda.synchronize()
    calib = seen["calib"]
    step = [fn.launches - c for fn, c in zip(train_counters(P), calib)]
    n_w = 7 * L + 1
    per_tensor = step[0] - n_w
    out = {"layers": L, "calib_launches": calib, "step_launches": step,
           "per_tensor_fwd_launches": per_tensor, "loss": seen["loss"],
           "calibrated_s_in": seen["s_in"]}
    report["train_static"] = out
    check(calib[2] == 5 * L, f"calibration launched flash_attn_fwd "
                             f"{calib[2]} times, want {5 * L}")
    check(per_tensor == 10 * L + 1 and step[1] == step[0],
          f"A8s step launches {step}: want {n_w} weight + {10 * L + 1} "
          f"per-tensor forward and as many backward launches")
    check(math.isfinite(seen["loss"]) and seen["s_in"] != 1.0,
          f"A8s: loss {seen['loss']}, calibrated s_in {seen['s_in']}")
    print("phase 5b: " + json.dumps(out), flush=True)


# --------------------------------------------------------------------------
# phase 3: serve
# --------------------------------------------------------------------------

def serve(torch, P, cfg, dev, report):
    import numpy as np
    qat, models = P["qat"], P["models"]
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=0, device=dev)
    eng = P["ServeEngine"](cfg, params, policy="A8d-C8-W4", slots=SLOTS,
                           cache_len=CACHE_LEN, max_new_cap=MAX_NEW,
                           decode_block=8, weights_layout="w4a8", device=dev)
    del params
    # the w4a8 forward never reads the bf16 linear weights
    eng.params = qat.drop_exported_weights(eng.params)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    report["setup_s"] = time.perf_counter() - t0
    report["weights_bytes_after_drop"] = sum(
        t.numel() * t.element_size() for t in _leaves(eng.params))

    rng = np.random.default_rng(0)
    lens = rng.integers(32, 129, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]

    # one decode step: kernels vs the same engine on the plain versions,
    # from the same post-prefill cache (launches here are not counted)
    L = int(math.ceil(max(lens[:SLOTS]) / 16) * 16)
    toks = torch.zeros((SLOTS, L), dtype=torch.int32, device=dev)
    for i in range(SLOTS):
        toks[i, :lens[i]] = torch.from_numpy(prompts[i]).to(dev)
    batch = {"tokens": toks, "lengths": torch.tensor(
        lens[:SLOTS], dtype=torch.int32, device=dev)}
    logits0, cache = models.prefill(cfg, eng.params, eng.ctx, batch,
                                    cache_budget=CACHE_LEN)
    tok1 = torch.argmax(logits0[:, -1].float(), -1).to(torch.int32)[:, None]
    lk, _ = models.decode_step(cfg, eng.params, eng.ctx, tok1,
                               models.clone_cache(cache))
    plain_ctx = replace(eng.ctx, kernel_backend="ref")
    lp, _ = models.decode_step(cfg, eng.params, plain_ctx, tok1,
                               models.clone_cache(cache))
    lk, lp = lk.float(), lp.float()
    check(bool(torch.isfinite(lk).all()), "decode logits not finite")
    rel = float(torch.linalg.vector_norm(lk - lp)
                / torch.linalg.vector_norm(lp))
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    report["decode_logits"] = {"rel_l2_err": rel,
                               "max_abs_err": float((lk - lp).abs().max()),
                               "argmax_agreement": agree,
                               "logit_absmax": float(lp.abs().max())}
    check(rel <= LOGIT_REL_TOL,
          f"kernel decode logits differ from the plain versions' by "
          f"relative L2 {rel} > {LOGIT_REL_TOL}")
    print(f"phase 3: one decode step's logits, kernels vs plain versions: "
          f"relative L2 {rel:.3g}, argmax agreement {agree:.2f}", flush=True)
    del cache, logits0, lk, lp

    reqs = [P["Request"](uid=i, prompt=p, max_new_tokens=MAX_NEW,
                         temperature=0.8 if i % 4 == 3 else 0.0,
                         top_k=8 if i % 4 == 3 else 0, seed=i)
            for i, p in enumerate(prompts)]
    w4a8_fn = P["w4a8_ops"].w4a8_matmul
    kvq_fn = P["kvq_ops"].kvq_decode_attn
    for r in reqs:
        eng.submit(r)
    w4a8_fn.launches = 0
    kvq_fn.launches = 0
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"w4a8_matmul": w4a8_fn.launches,
                "kvq_decode_attn": kvq_fn.launches}
    check(all(r.done for r in reqs), "not every request finished")
    check(all(len(r.generated) == MAX_NEW for r in reqs),
          "a request stopped short of max_new_tokens (no EOS was set)")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "a generated token is outside the vocabulary")
    check(launches["w4a8_matmul"] > 0 and launches["kvq_decode_attn"] > 0,
          f"a kernel of the path never launched: {launches}")
    decode_tokens = stats["tokens_out"] - len(reqs)
    served = {"requests": len(reqs), "tokens_out": stats["tokens_out"],
              "wall_s": wall, "tokens_per_s": stats["tokens_out"] / wall,
              "decode_tokens_per_s": decode_tokens / stats["decode_s"],
              "decode_step_ms": 1e3 * stats["decode_step_s"],
              "decode_steps": stats["decode_steps"],
              "ttft_p50_s": stats["ttft_p50_s"],
              "ttft_p95_s": stats["ttft_p95_s"],
              "prefill_s": stats["prefill_s"],
              "launches": launches,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    report["serve"] = served
    print("serve " + json.dumps(served), flush=True)
    return launches, eng


# --------------------------------------------------------------------------
# phase 3b: paged serve, with prefix sharing, COW and the tail-wave
# --------------------------------------------------------------------------

PAGED_ENGINE = dict(kv_layout="paged", slots=SLOTS, cache_len=PAGED_TOKENS,
                    block_size=64, prefill_chunk=64, max_new_cap=MAX_NEW,
                    decode_block=8)
SHARED_PREFIX = 160            # 2.5 blocks: the split block is shared


def paged_engine(P, cfg, params, dev, **kw):
    """An engine with the paged phase's settings (``kw`` overrides them;
    ``kv_layout="dense"`` gives the dense engine of the same geometry)."""
    return P["ServeEngine"](cfg, params, policy="A8d-C8-W4",
                            weights_layout="w4a8", device=dev,
                            **{**PAGED_ENGINE, **kw})


def shared_prefix_requests(P, cfg, n, uid0, seed):
    """n requests sharing a 160-token prefix, each with its own suffix of
    24 to 72 tokens; every fourth samples (temperature 0.8, top-k 8).

    The first suffix is the shortest, so the first prompt (184 tokens)
    ends inside the block where the prompts diverge: the prefix index
    registers that block as a split block with its content, and the
    followers admitted after it share it and copy it on first write."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, SHARED_PREFIX)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, cfg.vocab_size, 24 + 48 * i // max(n - 1, 1))
        sampled = i % 4 == 3
        reqs.append(P["Request"](
            uid=uid0 + i, prompt=np.concatenate([prefix, tail]).astype(
                np.int32), max_new_tokens=MAX_NEW,
            temperature=0.8 if sampled else 0.0,
            top_k=8 if sampled else 0, seed=uid0 + i))
    return reqs


def logit_gap(torch, got, want):
    got, want = got.float(), want.float()
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return rel, agree


def check_paged_logits(torch, P, cfg, dev, params, report):
    """Two one-step logit checks of the paged path, each within the
    relative L2 bound: (a) paged vs dense engines on the same prompts with
    the prefix cache off, both on the kernels; (b) on a paged state with
    prefix hits, COW and tail-waves behind it, the kernels vs the plain
    versions. No launch here is counted."""
    import numpy as np
    models = P["models"]
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(32, 65, SLOTS)]
    logits = {}
    for layout, kw in (("dense", dict(kv_layout="dense")),
                       ("paged", dict(prefix_cache=False))):
        eng = paged_engine(P, cfg, params, dev, **kw)
        for i, pr in enumerate(prompts):
            eng.submit(P["Request"](uid=i, prompt=pr,
                                    max_new_tokens=MAX_NEW))
        eng._admit()
        check(len(eng._slot_req) == SLOTS, f"{layout}: a wave short")
        if layout == "paged":
            eng._ensure_decode_blocks()
        lg, _ = models.decode_step(cfg, eng.params, eng.ctx,
                                   eng.state["tokens"],
                                   models.clone_cache(eng.state["cache"]))
        logits[layout] = lg
        del eng
    rel_a, agree_a = logit_gap(torch, logits["paged"], logits["dense"])
    check(bool(torch.isfinite(logits["paged"]).all()),
          "paged decode logits not finite")
    check(rel_a <= LOGIT_REL_TOL,
          f"paged decode logits differ from dense by relative L2 {rel_a} "
          f"> {LOGIT_REL_TOL}")

    eng = paged_engine(P, cfg, params, dev)
    reqs = shared_prefix_requests(P, cfg, 2 * SLOTS, 300, seed=13)
    for r in reqs:
        eng.submit(r)
    for _ in range(64):          # until a full slate decodes after a COW
        eng.step()
        if (len(eng._slot_req) == SLOTS and not eng._tail_jobs
                and eng.stats()["cow_copies"] > 0):
            break
    st = eng.stats()
    check(len(eng._slot_req) == SLOTS and st["cow_copies"] > 0
          and st["tail_waves"] > 0,
          f"logit check state lacks residents, COW or tail-waves: {st}")
    eng._ensure_decode_blocks()
    tokens = eng.state["tokens"]
    lk, _ = models.decode_step(cfg, eng.params, eng.ctx, tokens,
                               models.clone_cache(eng.state["cache"]))
    plain_ctx = replace(eng.ctx, kernel_backend="ref")
    lp, _ = models.decode_step(cfg, eng.params, plain_ctx, tokens,
                               models.clone_cache(eng.state["cache"]))
    rel_b, agree_b = logit_gap(torch, lk, lp)
    check(bool(torch.isfinite(lk).all()), "paged kernel logits not finite")
    check(rel_b <= LOGIT_REL_TOL,
          f"paged kernel decode logits differ from the plain versions' by "
          f"relative L2 {rel_b} > {LOGIT_REL_TOL}")
    eng.run_until_drained()
    check(all(r.done for r in reqs), "logit-check requests not finished")
    report["paged_logits"] = {
        "paged_vs_dense_rel_l2": rel_a, "paged_vs_dense_argmax": agree_a,
        "kernels_vs_plain_rel_l2": rel_b, "kernels_vs_plain_argmax": agree_b}
    print(f"phase 3b: one paged decode step's logits: vs dense relative L2 "
          f"{rel_a:.3g} (argmax agreement {agree_a:.2f}); kernels vs plain "
          f"versions {rel_b:.3g} ({agree_b:.2f})", flush=True)


def serve_paged(torch, P, cfg, dev, params, report):
    """qwen2.5-3b at full width on the paged pool: 8 requests sharing a
    160-token prefix through 4 slots, prefix cache on."""
    ops = P["kvq_ops"]
    counted = {"kvq_paged_decode_attn": ops.kvq_paged_decode_attn,
               "gather_dequant_paged_kv": ops.gather_dequant_paged_kv,
               "pool_block_copy": ops.copy_pool_blocks_multi,
               "pool_block_copy_one_leaf": ops.copy_pool_blocks,
               "kvq_decode_attn": ops.kvq_decode_attn,
               "w4a8_matmul": P["w4a8_ops"].w4a8_matmul}
    eng = paged_engine(P, cfg, params, dev)
    check(eng.num_blocks == 32 and eng.table_len == 8,
          f"paged engine geometry: {eng.num_blocks} blocks, table "
          f"{eng.table_len}")
    cow_events = []                      # pairs of each resolved COW
    apply_cow = eng._apply_cow

    def counted_cow(pairs):
        cow_events.append(len(pairs))
        return apply_cow(pairs)

    eng._apply_cow = counted_cow
    reqs = shared_prefix_requests(P, cfg, 2 * SLOTS, 200, seed=14)
    for r in reqs:
        eng.submit(r)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    check(all(r.done for r in reqs), "paged: not every request finished")
    check(all(len(r.generated) == MAX_NEW for r in reqs),
          "paged: a request stopped short of max_new_tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "paged: a generated token is outside the vocabulary")
    check(stats["prefix_hit_blocks"] > 0 and stats["cow_copies"] > 0
          and stats["tail_waves"] > 0,
          f"paged: no prefix hit, COW or tail-wave: {stats}")
    for name in ("kvq_paged_decode_attn", "gather_dequant_paged_kv",
                 "pool_block_copy", "w4a8_matmul"):
        check(launches[name] > 0, f"paged: {name} never launched: "
                                  f"{launches}")
    check(launches["kvq_decode_attn"] == 0,
          f"paged: the dense decode kernel ran: {launches}")
    check(launches["pool_block_copy"] == len(cow_events)
          and launches["pool_block_copy_one_leaf"] == 0
          and sum(cow_events) == stats["cow_copies"],
          f"paged: want one multi-leaf copy launch per COW event and no "
          f"one-leaf copy: {len(cow_events)} events of {cow_events} pairs, "
          f"{stats['cow_copies']} COW copies, launches {launches}")
    del eng._apply_cow
    check(stats["free_blocks"] == eng.num_blocks,
          "paged: blocks leaked after the drain")
    decode_tokens = stats["tokens_out"] - len(reqs)
    served = {"requests": len(reqs), "tokens_out": stats["tokens_out"],
              "wall_s": wall, "tokens_per_s": stats["tokens_out"] / wall,
              "decode_tokens_per_s": decode_tokens / stats["decode_s"],
              "decode_step_ms": 1e3 * stats["decode_step_s"],
              "decode_steps": stats["decode_steps"],
              "ttft_p50_s": stats["ttft_p50_s"],
              "ttft_p95_s": stats["ttft_p95_s"],
              "prefill_s": stats["prefill_s"],
              "tail_waves": stats["tail_waves"],
              "prefill_chunks": stats["prefill_chunks"],
              "prefix_hit_tokens": stats["prefix_hit_tokens"],
              "prefix_hit_blocks": stats["prefix_hit_blocks"],
              "cow_copies": stats["cow_copies"],
              "cow_events": len(cow_events),
              "prompt_tokens_prefilled": stats["prompt_tokens_prefilled"],
              "peak_cache_tokens": stats["peak_cache_tokens"],
              "launches": launches,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    report["serve_paged"] = served
    print("serve_paged " + json.dumps(served), flush=True)
    return launches, eng, {r.uid: r.generated for r in reqs}


# --------------------------------------------------------------------------
# phases 3c-3e: speculative decoding and optimistic admission
# --------------------------------------------------------------------------

def counted_kernels(P):
    ops = P["kvq_ops"]
    return {"kvq_spec_verify_attn": ops.kvq_spec_verify_attn,
            "kvq_decode_attn": ops.kvq_decode_attn,
            "kvq_paged_decode_attn": ops.kvq_paged_decode_attn,
            "gather_dequant_paged_kv": ops.gather_dequant_paged_kv,
            "pool_block_copy": ops.copy_pool_blocks_multi,
            "w4a8_matmul": P["w4a8_ops"].w4a8_matmul}


def drive(torch, P, eng, reqs):
    """Serve ``reqs`` to the end with every launch count set to 0 just
    before and read just after. Returns (stats, launches, wall s)."""
    counted = counted_kernels(P)
    for r in reqs:
        eng.submit(r)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return stats, {n: fn.launches for n, fn in counted.items()}, wall


def span_ms(tracer, name):
    durs = [e["dur"] for e in tracer.events()
            if e["ph"] == "span" and e["name"] == name]
    return 1e3 * sum(durs) / max(len(durs), 1), len(durs)


def spec_summary(stats, reqs, wall, launches, tracer):
    verify_ms, waves = span_ms(tracer, "spec_verify")
    draft_ms, _ = span_ms(tracer, "spec_draft")
    decode_tokens = stats["tokens_out"] - len(reqs)
    return {"requests": len(reqs), "tokens_out": stats["tokens_out"],
            "wall_s": wall, "tokens_per_s": stats["tokens_out"] / wall,
            "decode_tokens_per_s": decode_tokens / stats["decode_s"],
            "verify_wave_ms": verify_ms, "draft_ms_per_wave": draft_ms,
            "wave_ms": 1e3 * stats["decode_s"] / max(stats["spec_waves"], 1),
            "ttft_p50_s": stats["ttft_p50_s"],
            "ttft_p95_s": stats["ttft_p95_s"],
            "spec_waves": stats["spec_waves"],
            "spec_drafted": stats["spec_drafted"],
            "spec_accepted": stats["spec_accepted"],
            "spec_rolled_back": stats["spec_rolled_back"],
            "spec_accept_rate": stats["spec_accept_rate"],
            "spec_draft_layers": stats["spec_draft_layers"],
            "tail_waves": stats["tail_waves"],
            "cow_copies": stats["cow_copies"],
            "preemptions": stats["preemptions"],
            "swap_out_bytes": stats["swap_out_bytes"],
            "swap_in_bytes": stats["swap_in_bytes"],
            "swap_s": stats["swap_s"],
            "launches": launches}


def check_streams(cfg, reqs, what, n=MAX_NEW):
    check(all(r.done for r in reqs), f"{what}: not every request finished")
    check(all(len(r.generated) == n for r in reqs),
          f"{what}: a request stopped short of max_new_tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"{what}: a generated token is outside the vocabulary")


SPEC_NEW = 12          # new tokens a request in phase 3c (the script's
                       # time limit)


def serve_spec(torch, P, cfg, dev, params, report, plain_streams):
    """The paged phase's 8 shared-prefix requests, SPEC_NEW new tokens
    each, with speculative decoding at the CLI's defaults (k = 4, a draft
    of half the layers, exact mode): the verify kernel and the draft's
    dense decode kernel launch, the paged decode kernel does not, and
    every stream equals the start of the plain paged phase's stream of
    the same request."""
    tracer = P["Tracer"](capacity=1 << 16)
    eng = paged_engine(P, cfg, params, dev, spec=P["SpecConfig"](k=SPEC_K),
                       trace=tracer)
    check(eng.spec.resolved_layers(cfg) == cfg.n_layers // 2,
          "spec: the default draft is not half the target's layers")
    reqs = shared_prefix_requests(P, cfg, 2 * SLOTS, 200, seed=14)
    for r in reqs:
        r.max_new_tokens = SPEC_NEW
    stats, launches, wall = drive(torch, P, eng, reqs)
    check_streams(cfg, reqs, "spec", n=SPEC_NEW)
    for name in ("kvq_spec_verify_attn", "kvq_decode_attn", "w4a8_matmul"):
        check(launches[name] > 0, f"spec: {name} never launched: {launches}")
    check(launches["kvq_paged_decode_attn"] == 0,
          f"spec: the paged decode kernel ran: {launches}")
    check(stats["free_blocks"] == eng.num_blocks,
          "spec: blocks leaked after the drain")
    differ = [r.uid for r in reqs
              if r.generated != plain_streams[r.uid][:SPEC_NEW]]
    served = spec_summary(stats, reqs, wall, launches, tracer)
    served["streams_differing_from_plain"] = differ
    report["serve_spec"] = served
    print("serve_spec " + json.dumps(served), flush=True)
    check(not differ, f"spec: exact-mode streams differ from plain paged "
                      f"decode for requests {differ}")
    print(f"phase 3c: spec serve, {served['decode_tokens_per_s']:.2f} decode "
          f"tok/s, {served['verify_wave_ms']:.1f} ms per verify-wave, "
          f"TTFT p50 {served['ttft_p50_s']:.3f} s p95 "
          f"{served['ttft_p95_s']:.3f} s; {served['spec_waves']} waves, "
          f"{served['spec_drafted']} drafted, {served['spec_accepted']} "
          f"accepted, {served['spec_rolled_back']} rolled back, accept rate "
          f"{served['spec_accept_rate']:.3f}; streams equal plain decode",
          flush=True)
    return launches


def verify_vs_decode(torch, P, cfg, eng):
    """At one wave of ``eng``'s residents: the logits of ``spec_verify``
    over a greedy window against C sequential ``decode_step`` calls
    consuming the same tokens, each on its own copy of the cache."""
    models = P["models"]
    C = SPEC_C
    tails = torch.zeros((eng.slots,), dtype=torch.int32)
    for s, r in list(eng._slot_req.items()):
        w = eng._written[s]
        t = min(C, len(r.prompt) + r.max_new_tokens - 1 - w)
        check(eng._ensure(s, w + t) and eng._cow_guard(s, w, w + t),
              "verify-vs-decode: a resident was swapped out")
        tails[s] = t
    eng._push_tables()
    st = eng.state
    tok = st["tokens"].clone()
    window, seq = [tok], []
    cache_a = models.clone_cache(st["cache"])
    for j in range(C):
        lg, cache_a = models.decode_step(cfg, eng.params, eng.ctx, tok,
                                         cache_a)
        seq.append(lg[:, 0].float())
        tok = torch.argmax(lg[:, -1].float(), -1).to(torch.int32)[:, None]
        if j < C - 1:
            window.append(tok)
    cache_b = models.clone_cache(st["cache"])
    vl, _ = models.spec_verify(
        cfg, eng.params, eng.ctx, torch.cat(window, dim=1), cache_b,
        torch.arange(eng.slots, dtype=torch.int32, device=tok.device),
        cache_b["position"].clone(), tails.to(tok.device),
        hist_blocks=eng.table_len)
    seq = torch.stack(seq, dim=1)
    rows = [(s, j) for s in eng._slot_req for j in range(int(tails[s]))]
    got = torch.stack([vl[s, j].float() for s, j in rows])
    want = torch.stack([seq[s, j] for s, j in rows])
    rel, agree = logit_gap(torch, got, want)
    return bool(torch.equal(got, want)), rel, agree, len(rows)


def serve_self_draft(torch, P, cfg, dev, params, report):
    """Greedy requests with the target as its own draft (36 layers): the
    verify logits against decode's at one wave, then the accept rate
    (1.0 when they agree bitwise). Prompts fit one prefill window and the
    prefix cache is off, so the draft's dense prefill and the target's
    paged prefill compute the same cache."""
    import numpy as np
    rng = np.random.default_rng(18)
    reqs = [P["Request"](uid=500 + i, prompt=rng.integers(
        0, cfg.vocab_size, int(n)).astype(np.int32), max_new_tokens=MAX_NEW)
        for i, n in enumerate(rng.integers(40, 65, SLOTS))]
    eng = paged_engine(P, cfg, params, dev, prefix_cache=False,
                       spec=P["SpecConfig"](k=SPEC_K,
                                            draft_layers=cfg.n_layers))
    for r in reqs:
        eng.submit(r)
    eng._admit()
    check(len(eng._slot_req) == SLOTS, "self-draft: a wave short")
    bitwise, rel, agree, n_rows = verify_vs_decode(torch, P, cfg, eng)
    check(rel <= LOGIT_REL_TOL,
          f"verify logits differ from decode's by relative L2 {rel} > "
          f"{LOGIT_REL_TOL}")
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_streams(cfg, reqs, "self-draft")
    out = {"verify_vs_decode_bitwise": bitwise,
           "verify_vs_decode_rel_l2": rel,
           "verify_vs_decode_argmax": agree, "positions": n_rows,
           "spec_accept_rate": stats["spec_accept_rate"],
           "spec_waves": stats["spec_waves"],
           "spec_drafted": stats["spec_drafted"],
           "spec_accepted": stats["spec_accepted"],
           "decode_tokens_per_s": (stats["tokens_out"] - len(reqs))
           / stats["decode_s"],
           "wave_ms": 1e3 * stats["decode_s"] / max(stats["spec_waves"], 1),
           "wall_s": wall}
    report["self_draft"] = out
    print(f"phase 3d: self-draft ({cfg.n_layers} layers): accept rate "
          f"{out['spec_accept_rate']:.3f} over {out['spec_waves']} waves; "
          f"verify logits vs decode at one wave ({n_rows} positions): "
          f"bitwise {'yes' if bitwise else 'no'}, relative L2 {rel:.3g}, "
          f"argmax agreement {agree:.3f}", flush=True)


def check_tail_rows(torch, P, cfg, dev, params, report, ffn=False,
                    report_key="tail_row_invariant", phase="phase 3b"):
    """A tail-wave row gives the same bits alone as in a wave with a
    deeper row (whose history sets the wave's table walk): one attention
    layer of ``cfg`` (with ``ffn``, then the layer's ln2 and MLP or MoE:
    the expert GEMMs run over the wave's rows), its output and the cache
    blocks it commits compared bitwise."""
    import numpy as np
    from repro_torch.models import blocks
    from repro_torch.models.common import rope_tables
    from repro_torch.models.model import _ffn_tail
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    bs, NB, C = 64, 24, 64
    ctx = P["qat"].make_ctx("A8d-C8-W4", weights_layout="w4a8")
    pool, layers = blocks.init_paged_attn_cache(cfg, 2, NB, bs, layers=1,
                                                device=dev)
    for key in ("k_q", "v_q"):
        pool[key].copy_(torch.randint(-127, 128, pool[key].shape,
                                      generator=gen, device=dev,
                                      dtype=torch.int8))
    for key in ("s_k", "s_v"):
        pool[key].copy_(torch.rand(pool[key].shape, generator=gen,
                                   device=dev) * 0.02 + 1e-3)
    perm = torch.randperm(NB, generator=gen, device=dev).to(torch.int32)
    tbl = perm[:16].reshape(2, 8).contiguous()
    offs = [100, 400]
    x = torch.randn((2, C, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    p = params["layers"][0]["attn"]

    def run(rows, hb):
        pl = {k: v.clone() for k, v in pool.items()}
        layer = {**{k: pl[k][0] for k in pl},
                 "length": torch.zeros((2,), dtype=torch.int32, device=dev)}
        off = torch.tensor([offs[i] for i in rows], dtype=torch.int32,
                           device=dev)
        pos = off.long()[:, None] + torch.arange(C, device=dev)[None]
        rope = rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)
        own = [min(int(2 ** np.ceil(np.log2(-(-(offs[i] + C) // bs)))), 8)
               for i in rows]
        y, _ = blocks.attn_chunk_prefill(
            cfg, ctx, p, x[rows], rope, layer, tbl[rows, :hb].contiguous(),
            torch.tensor(rows, dtype=torch.int32, device=dev), off,
            torch.full((len(rows),), C, dtype=torch.int32, device=dev),
            hist_rows=own)
        if ffn:
            y = _ffn_tail(cfg, ctx, params["layers"][0], x[rows] + y)[0]
        return y, pl

    y_wave, pool_wave = run([0, 1], 8)
    y_alone, pool_alone = run([0], 4)
    own = tbl[0].long()                 # row 0's blocks (row 1's differ)
    same = (torch.equal(y_wave[0], y_alone[0])
            and all(torch.equal(pool_wave[k][:, own], pool_alone[k][:, own])
                    for k in pool))
    report[report_key] = same
    check(same, f"{cfg.name}: a tail-wave row differs alone and inside a "
                f"deeper wave (ffn {ffn})")
    print(f"{phase}: a tail-wave row is bitwise the same alone and beside "
          f"a deeper row ({cfg.name}, {'with' if ffn else 'without'} the "
          f"layer's FFN half)", flush=True)


OPTIMISTIC_NEW = 8     # new tokens a request in phase 3e (its preemptions
                       # come from prompts outgrowing a 60% pool: a
                       # verify-wave writes k + 1 = 5 positions ahead, so
                       # the 184- and 190-token prompts need a 4th block
                       # of 64 within their first 8 tokens; the script's
                       # time limit)


def serve_optimistic(torch, P, cfg, dev, params, report):
    """The paged phase's requests, prefix cache off, under optimistic
    admission (speculative decoding at the CLI's defaults) on a pool of
    about 60% of the reserve worst case: at least one preemption, the
    bytes swapped out all swapped back in, and every stream equal to the
    same request's under reserve admission on a full pool. The prefix
    cache is off on both sides because the admission order decides which
    prompt tokens a request finds cached, and a cached token is read back
    quantized where a computed one is not."""
    def run(**kw):
        reqs = shared_prefix_requests(P, cfg, 2 * SLOTS, 200, seed=14)
        for r in reqs:
            r.max_new_tokens = OPTIMISTIC_NEW
        tracer = P["Tracer"](capacity=1 << 16)
        eng = paged_engine(P, cfg, params, dev, prefix_cache=False,
                           max_seq_len=PAGED_TOKENS, trace=tracer, **kw)
        stats, launches, wall = drive(torch, P, eng, reqs)
        check_streams(cfg, reqs, f"optimistic phase {kw}",
                      n=OPTIMISTIC_NEW)
        check(stats["free_blocks"] == eng.num_blocks,
              f"optimistic phase {kw}: blocks leaked after the drain")
        return reqs, stats, launches, wall, tracer

    reqs, _, _, _, _ = run()                          # reserve, plain decode
    reserve_streams = {r.uid: r.generated for r in reqs}
    need = sorted(-(-(len(r.prompt) + OPTIMISTIC_NEW - 1) // 64)
                  for r in reqs)
    worst = sum(need[-SLOTS:])
    nb = max(need[-1], int(0.6 * worst))
    reqs, stats, launches, wall, tracer = run(
        num_blocks=nb, admission="optimistic",
        spec=P["SpecConfig"](k=SPEC_K))
    served = spec_summary(stats, reqs, wall, launches, tracer)
    served.update(num_blocks=nb, reserve_worst_case_blocks=worst)
    differ = [r.uid for r in reqs if r.generated != reserve_streams[r.uid]]
    served["streams_differing_from_reserve"] = differ
    report["serve_optimistic"] = served
    print("serve_optimistic " + json.dumps(served), flush=True)
    check(stats["preemptions"] >= 1,
          f"optimistic: no preemption on {nb} blocks")
    check(stats["swap_out_bytes"] == stats["swap_in_bytes"] > 0,
          f"optimistic: swap bytes out {stats['swap_out_bytes']} != in "
          f"{stats['swap_in_bytes']}")
    check(not differ, f"optimistic: streams differ from reserve admission "
                      f"for requests {differ}")
    print(f"phase 3e: optimistic admission on {nb} of {worst} worst-case "
          f"blocks: {stats['preemptions']} preemptions, "
          f"{stats['swap_out_bytes']} bytes out and in, swap "
          f"{1e3 * stats['swap_s']:.1f} ms; streams equal reserve "
          f"admission's", flush=True)


# --------------------------------------------------------------------------
# phase 3o: the streaming frontend, HTTP, SLO admission and observability
# --------------------------------------------------------------------------

FRONTEND_NEW = 8               # new tokens of a phase-3o request
FRONTEND_STREAMS = 8           # SSE streams beside one blocking completion
BURST_ONTIME, BURST_HOPELESS = 4, 8
POISSON_REQUESTS = 8           # nearest-rank p95 of 8 is the 8th (cut
                               # from 16 for the script's time)
DELIVERY_TOL_S = 0.25          # a span reaches the loop after its step
POISSON_DEADLINE_MS = 5000.0


def frontend_body(r):
    """The /v1/completions body of one engine Request."""
    return {"prompt": [int(t) for t in r.prompt],
            "max_tokens": r.max_new_tokens, "temperature": r.temperature,
            "top_k": r.top_k, "seed": r.seed}


async def http_request(asyncio, port, method, path, payload=None):
    """One HTTP/1.1 exchange: (status, body bytes)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode() if payload is not None else b""
    writer.write(b"%s %s HTTP/1.1\r\nContent-Length: %d\r\n\r\n"
                 % (method.encode(), path.encode(), len(body)) + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    header, _, out = raw.partition(b"\r\n\r\n")
    return int(header.split()[1]), out


async def sse_completion(asyncio, port, payload):
    """One streamed completion: its uid, tokens, span count, finish
    reason and the client's seconds to the first token."""
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(dict(payload, stream=True)).encode()
    writer.write(b"POST /v1/completions HTTP/1.1\r\n"
                 b"Content-Length: %d\r\n\r\n" % len(body) + body)
    await writer.drain()
    status = (await reader.readline()).split()
    check(status[1] == b"200", f"phase 3o: SSE status {status}")
    while (await reader.readline()) not in (b"\r\n", b"\n", b""):
        pass
    out = {"tokens": [], "spans": 0, "done": False, "ttft_s": None}
    async for raw in reader:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        if line == "data: [DONE]":
            out["done"] = True
            break
        chunk = json.loads(line[len("data: "):])
        choice = chunk["choices"][0]
        out["uid"] = int(chunk["id"].split("-")[1])
        if choice["token_ids"] and out["ttft_s"] is None:
            out["ttft_s"] = time.perf_counter() - t0
        out["tokens"] += choice["token_ids"]
        out["spans"] += 1
        out["reason"] = choice["finish_reason"]
    writer.close()
    await writer.wait_closed()
    return out


def serve_frontend(torch, P, cfg, dev, params, report):
    """Phase 3o: qwen2.5-3b at full width served through the port's
    asyncio frontend and HTTP endpoint (see the module docstring)."""
    import asyncio
    counted = counted_kernels(P)
    for fn in counted.values():
        fn.launches = 0
    t_phase = time.perf_counter()
    tracer = P["Tracer"](capacity=1 << 16)
    eng = paged_engine(P, cfg, params, dev, decode_block="auto",
                       sched_policy="edf", slo_shed="reject", trace=tracer)
    probe = eng.decode_block_probe
    check(probe is not None and eng.decode_block == probe["pick"]
          in (4, 8, 16, 32), f"phase 3o: decode_block auto probe {probe}")
    print(f"phase 3o: decode_block auto picked {probe['pick']}: a chunk "
          f"of 1 step {1e3 * probe['t1_s']:.2f} ms, of 8 "
          f"{1e3 * probe['t8_s']:.2f} ms ({1e3 * probe['per_step_s']:.2f} "
          f"ms a step, {1e3 * probe['overhead_s']:.2f} ms fixed)",
          flush=True)
    reqs = shared_prefix_requests(P, cfg, FRONTEND_STREAMS + 2, 0, seed=21)
    for r in reqs:
        r.max_new_tokens = FRONTEND_NEW
    warm, streamed, blocking = reqs[0], reqs[1:-1], reqs[-1]

    # (a) HTTP: the warm request registers the shared prefix, then 8 SSE
    # streams and one blocking completion arrive together; each finds the
    # same 160 cached tokens whatever the arrival order, so each stream
    # must equal a batch drain of the same requests
    async def http_pass():
        async with P["AsyncFrontend"](eng) as fe:
            async with P["ServeHTTP"](fe, port=0) as srv:
                port = srv.port
                code, _ = await http_request(asyncio, port, "POST",
                                             "/v1/completions",
                                             frontend_body(warm))
                check(code == 200, f"phase 3o: warm request HTTP {code}")
                t0 = time.perf_counter()
                tasks = [asyncio.create_task(sse_completion(
                    asyncio, port, frontend_body(r))) for r in streamed]
                tasks.append(asyncio.create_task(http_request(
                    asyncio, port, "POST", "/v1/completions",
                    frontend_body(blocking))))
                for _ in range(200):       # every request reached the queue
                    if len(fe._inbox) + len(fe._streams) >= len(tasks):
                        break
                    await asyncio.sleep(0.01)
                mid = await http_request(asyncio, port, "GET", "/v1/metrics")
                outs = await asyncio.gather(*tasks)
                wall = time.perf_counter() - t0
                after = await http_request(asyncio, port, "GET",
                                           "/v1/metrics")
                st = await http_request(asyncio, port, "GET", "/v1/stats")
                health = await http_request(asyncio, port, "GET", "/health")
        return outs, mid, after, st, health, wall

    outs, mid, after, st, health, http_wall = asyncio.run(http_pass())
    sse, (bcode, bbody) = outs[:-1], outs[-1]
    check(health == (200, b'{"status": "ok"}'), f"phase 3o: /health {health}")
    check(bcode == 200, f"phase 3o: blocking completion HTTP {bcode}")
    bjson = json.loads(bbody)
    check(all(o["done"] and o["reason"] == "length"
              and len(o["tokens"]) == FRONTEND_NEW for o in sse),
          "phase 3o: an SSE stream ended short or without [DONE]")
    check(bjson["choices"][0]["finish_reason"] == "length" and len(
        bjson["choices"][0]["token_ids"]) == FRONTEND_NEW,
        f"phase 3o: blocking completion {bjson}")
    stats_http = json.loads(st[1])
    pm = P["parse_prometheus"](mid[1].decode())
    pa = P["parse_prometheus"](after[1].decode())
    check(pm["serve_pending_requests"] + pm["serve_resident_requests"] > 0,
          f"phase 3o: the mid-serve scrape saw nothing in flight: {pm}")
    for key, name in (("tokens_out", "serve_tokens_out_total"),
                      ("requests_finished", "serve_requests_finished_total"),
                      ("decode_steps", "serve_decode_steps_total"),
                      ("prefix_hit_tokens", "serve_prefix_hit_tokens_total"),
                      ("cow_copies", "serve_cow_copies_total"),
                      ("free_blocks", "serve_free_blocks")):
        check(pa[name] == stats_http[key],
              f"phase 3o: /v1/metrics {name} {pa[name]} != /v1/stats "
              f"{key} {stats_http[key]}")
        check(key == "free_blocks" or pm[name] <= pa[name],
              f"phase 3o: mid-serve {name} {pm[name]} > final {pa[name]}")
    check(pa["serve_ttft_seconds_count"] == stats_http["requests_finished"]
          == FRONTEND_STREAMS + 2,
          f"phase 3o: TTFT histogram count {pa['serve_ttft_seconds_count']}")
    check(stats_http["prefix_hit_tokens"] > 0 and stats_http["cow_copies"]
          > 0, f"phase 3o: no prefix hit or COW: {stats_http}")

    # the batch drain of the same requests (their frontend uids: the warm
    # one got 0) on the same engine
    eng.reset()
    uids = [o["uid"] for o in sse] + [int(bjson["id"].split("-")[1])]
    toks = [o["tokens"] for o in sse] + [bjson["choices"][0]["token_ids"]]

    def again(r, uid):
        return P["Request"](uid=uid, prompt=r.prompt,
                            max_new_tokens=FRONTEND_NEW,
                            temperature=r.temperature, top_k=r.top_k,
                            seed=r.seed)

    w = again(warm, 0)
    eng.submit(w)
    eng.run_until_drained()
    drain = [again(r, u) for r, u in zip(streamed + [blocking], uids)]
    for r in drain:
        eng.submit(r)
    t0 = time.perf_counter()
    dstats = eng.run_until_drained()
    torch.cuda.synchronize()
    drain_wall = time.perf_counter() - t0
    differ = [r.uid for r, t in zip(drain, toks) if r.generated != t]
    check(not differ, f"phase 3o: HTTP streams differ from the batch drain "
                      f"for uids {differ}")
    check_streams(cfg, drain, "phase 3o drain", n=FRONTEND_NEW)
    closed_rps = len(drain) / drain_wall

    # (b) an over-capacity burst under EDF + reject shedding. Four on-time
    # requests (priority 0, 120 s deadlines) queue ahead of eight in a
    # lower class (priority 1) whose deadlines come from the engine's own
    # TTFT predictor, its rates as the drain measured them: each is half
    # its own prompt's predicted prefill past the four's predicted TTFT,
    # so it would be on time at the head of the queue and is late behind
    # the four (a rejected request's prompt never joins the backlog). The
    # margins are far above the time between submit and the shed pass,
    # and no deadline has passed when the pass runs: the predictor
    # decides.
    burst = shared_prefix_requests(P, cfg, BURST_ONTIME + BURST_HOPELESS,
                                   100, seed=22)
    lens = [len(r.prompt) for r in burst]
    check(eng._pred_per_tok is not None and eng._pred_round_s is not None,
          "phase 3o: the drain left the TTFT predictor cold")
    ahead = sum(lens[:BURST_ONTIME])
    base = eng._predict_ttft_s(ahead)
    deadline_s = ([120.0] * BURST_ONTIME
                  + [base + 0.5 * eng._pred_per_tok * n
                     for n in lens[BURST_ONTIME:]])
    predicted_s = ([eng._predict_ttft_s(sum(lens[:i + 1]))
                    for i in range(BURST_ONTIME)]
                   + [eng._predict_ttft_s(ahead + n)
                      for n in lens[BURST_ONTIME:]])
    alone_s = [eng._predict_ttft_s(n) for n in lens]
    want_shed = [i for i, (p, d) in enumerate(zip(predicted_s, deadline_s))
                 if p > d]
    check(want_shed == list(range(BURST_ONTIME, len(burst)))
          and all(a < d for a, d in zip(alone_s, deadline_s)),
          f"phase 3o: burst deadlines {deadline_s} against predictions "
          f"{predicted_s} (alone {alone_s}) do not split four on time "
          f"from eight over capacity")
    shed0 = eng.stats()["requests_shed"]

    async def burst_pass():
        async with P["AsyncFrontend"](eng) as fe:
            hs = [await fe.submit(r.prompt, max_new_tokens=FRONTEND_NEW,
                                  deadline_ms=1e3 * d,
                                  priority=int(i >= BURST_ONTIME))
                  for i, (r, d) in enumerate(zip(burst, deadline_s))]
            got = [await h.tokens() for h in hs]
            return hs, got, await fe.stats()

    hs, got, bstats = asyncio.run(burst_pass())
    shed = [i for i, h in enumerate(hs) if h.shed]
    check(shed == want_shed and all(t == [] for t in got[BURST_ONTIME:]),
          f"phase 3o: burst shed {shed}, the predictor's set {want_shed}")
    shed_early_s = [h.request._deadline_t - h.finish_t for h in hs
                    if h.shed]
    check(all(x > 0 for x in shed_early_s),
          f"phase 3o: a burst request was shed after its deadline had "
          f"passed ({shed_early_s} s to spare): the clock decided, not "
          f"the predictor")
    check(all(len(t) == FRONTEND_NEW and all(0 <= x < cfg.vocab_size
                                             for x in t)
              for t in got[:BURST_ONTIME]),
          "phase 3o: an on-time burst request was not served in full")
    check(bstats["requests_shed"] - shed0 == BURST_HOPELESS,
          f"phase 3o: requests_shed {bstats['requests_shed']}")
    ontime_ttft_s = [h.request._timing.ttft for h in hs[:BURST_ONTIME]]

    # (c) open loop: Poisson arrivals at half the drain's request rate,
    # with a first-token deadline. The arrival times are drawn up front
    # and client TTFT counts from them, so a loop the step worker holds
    # back delays the submission (the lag is reported), not the schedule.
    # The trace covers this pass only.
    import numpy as np
    eng.reset()
    rate = 0.5 * closed_rps
    pois = shared_prefix_requests(P, cfg, POISSON_REQUESTS, 200, seed=23)

    async def poisson_pass():
        gaps = np.random.default_rng(24).exponential(1.0 / rate, len(pois))
        async with P["AsyncFrontend"](
                eng, default_deadline_ms=POISSON_DEADLINE_MS) as fe:
            t0 = time.perf_counter()
            due = t0 + np.cumsum(gaps)
            hs = []
            for r, at in zip(pois, due):
                await asyncio.sleep(max(0.0, at - time.perf_counter()))
                hs.append(await fe.submit(
                    r.prompt, max_new_tokens=FRONTEND_NEW,
                    temperature=r.temperature, top_k=r.top_k, seed=r.seed))
            got = [await h.tokens() for h in hs]
            st = await fe.stats()
        return due.tolist(), hs, got, st, time.perf_counter() - t0

    due, hs, got, pstats, pwall = asyncio.run(poisson_pass())
    served = [(at, h, t) for at, h, t in zip(due, hs, got) if not h.shed]
    check(served and all(len(t) == FRONTEND_NEW for _, _, t in served),
          "phase 3o: a Poisson request was cut short")
    client_ttft = [h.first_token_t - at for at, h, _ in served]
    submit_lag = [h.submit_t - at for at, h in zip(due, hs)]
    met = sum(1 for x in client_ttft if x <= POISSON_DEADLINE_MS / 1e3)
    trace = P["obs_export"].chrome_trace(tracer)
    bd = P["obs_export"].step_breakdown(trace)
    ra = P["obs_export"].request_attribution(trace)
    cs = P["obs_export"].compile_split(trace)
    check(ra["finished"] == len(served) and ra["reconcile_max_err"] <= 0.05,
          f"phase 3o: trace attribution {ra}")

    # the trace against the client's clock, which no span feeds: each
    # request's engine-side submit follows the frontend's; its first token
    # reaches the event loop after the trace records it, and it and the
    # request's end reach the loop inside the step that made them or at
    # most DELIVERY_TOL_S after that step ended (the engine streams the
    # end a moment before the scheduler records ``finished``)
    def at_s(e):
        return tracer.t0 + e["ts"] / 1e6
    steps = sorted((at_s(e), at_s(e) + e["dur"] / 1e6)
                   for e in trace["traceEvents"]
                   if e["ph"] == "X" and e["name"] == "step")
    life = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "request" and e["ph"] == "n":
            life.setdefault(e["id"], {}).setdefault(e["args"]["event"],
                                                    at_s(e))

    def step_of(t):
        return next(((a, b) for a, b in steps if a <= t <= b), None)

    inbox_wait, delivery = [], []
    for at, h, _ in served:
        ev = life.get(h.request.uid, {})
        t_sub, t_first, t_fin = (ev.get("submit"), ev.get("first_token"),
                                 ev.get("finished"))
        check(None not in (t_sub, t_first, t_fin),
              f"phase 3o: uid {h.request.uid} lifecycle {sorted(ev)}")
        for what, t_eng, t_cli in (("first token", t_first,
                                    h.first_token_t),
                                   ("finish", t_fin, h.finish_t)):
            st = step_of(t_eng)
            check(st is not None and st[0] <= t_cli <= st[1] + DELIVERY_TOL_S
                  and (what == "finish" or t_eng <= t_cli),
                  f"phase 3o: uid {h.request.uid}'s {what} reached the "
                  f"loop at {t_cli}, traced at {t_eng} in step {st}")
            if what == "first token":
                delivery.append(t_cli - st[1])
        check(h.submit_t <= t_sub, f"phase 3o: uid {h.request.uid} was "
                                   f"traced before the client submitted")
        inbox_wait.append(t_sub - h.submit_t)
    launches = {n: fn.launches for n, fn in counted.items()}
    for name in ("kvq_paged_decode_attn", "gather_dequant_paged_kv",
                 "pool_block_copy", "w4a8_matmul"):
        check(launches[name] > 0, f"phase 3o: {name} never launched: "
                                  f"{launches}")
    check(launches["kvq_decode_attn"] == 0,
          f"phase 3o: the dense decode kernel ran: {launches}")
    http_ttft = [o["ttft_s"] for o in sse]
    out = {
        "decode_block_probe": probe,
        "http": {"streams": len(sse), "wall_s": http_wall,
                 "client_ttft_n": len(http_ttft),
                 "client_ttft_p50_s": P["percentile"](http_ttft, 50),
                 "client_ttft_p95_s": P["percentile"](http_ttft, 95),
                 "sse_spans": [o["spans"] for o in sse],
                 "engine_ttft_p50_s": stats_http["ttft_p50_s"],
                 "engine_ttft_p95_s": stats_http["ttft_p95_s"],
                 "tokens_out": stats_http["tokens_out"],
                 "prefix_hit_tokens": stats_http["prefix_hit_tokens"],
                 "cow_copies": stats_http["cow_copies"],
                 "tail_waves": stats_http["tail_waves"],
                 "metrics_ttft_p95_s": stats_http["metrics"]["ttft"][
                     "p95_s"]},
        "drain": {"requests": len(drain), "wall_s": drain_wall,
                  "requests_per_s": closed_rps,
                  "tokens_per_s": dstats["tokens_out"] / drain_wall,
                  "ttft_p50_s": dstats["ttft_p50_s"],
                  "decode_step_ms": 1e3 * dstats["decode_step_s"]},
        "burst": {"requests": len(burst), "shed": len(shed),
                  "deadline_s": deadline_s, "predicted_ttft_s": predicted_s,
                  "predicted_alone_s": alone_s,
                  "shed_before_deadline_min_s": min(shed_early_s),
                  "ontime_engine_ttft_s": ontime_ttft_s,
                  "pred_per_prompt_token_s": eng._pred_per_tok,
                  "pred_round_s": eng._pred_round_s},
        "poisson": {"requests": len(pois), "rate_rps": rate,
                    "wall_s": pwall, "shed": len(pois) - len(served),
                    "deadline_ms": POISSON_DEADLINE_MS,
                    "client_ttft_n": len(client_ttft),
                    "client_ttft_p50_s": P["percentile"](client_ttft, 50),
                    "client_ttft_p95_s": P["percentile"](client_ttft, 95),
                    "submit_lag_p50_s": P["percentile"](submit_lag, 50),
                    "submit_lag_max_s": max(submit_lag),
                    "inbox_wait_p50_s": P["percentile"](inbox_wait, 50),
                    "inbox_wait_max_s": max(inbox_wait),
                    "delivery_after_step_max_s": max(delivery),
                    "engine_ttft_n": pstats["requests_finished"],
                    "engine_ttft_p50_s": pstats["ttft_p50_s"],
                    "engine_ttft_p95_s": pstats["ttft_p95_s"],
                    "trace_ttft_p50_s": ra["ttft"]["p50_s"],
                    "tokens_per_s": pstats["tokens_out"] / pwall,
                    "goodput_rps": met / pwall,
                    "slo_attainment": met / len(pois),
                    "decode_step_ms": 1e3 * pstats["decode_step_s"]},
        "trace": {"step_s": bd["step"]["total_s"],
                  "breakdown_pct": {k: v["pct_of_step"]
                                    for k, v in bd.items()},
                  "compile_calls": sum(d["compile_calls"]
                                       for d in cs.values()),
                  "reconcile_max_err": ra["reconcile_max_err"]},
        "launches": launches,
        "phase_s": time.perf_counter() - t_phase}
    report["serve_frontend"] = out
    print("serve_frontend " + json.dumps(out), flush=True)
    p = out["poisson"]
    print(f"phase 3o: {len(sse)} SSE streams + 1 blocking completion equal "
          f"to the batch drain; client TTFT p50 (n={len(http_ttft)}) "
          f"{1e3 * out['http']['client_ttft_p50_s']:.0f} ms; burst shed "
          f"{len(shed)} of {len(burst)}, the predictor's set; Poisson at "
          f"{rate:.3f} req/s: client TTFT from the scheduled arrival "
          f"(n={p['client_ttft_n']}) p50 "
          f"{1e3 * p['client_ttft_p50_s']:.0f} ms p95 "
          f"{1e3 * p['client_ttft_p95_s']:.0f} ms (engine p50 "
          f"{1e3 * p['engine_ttft_p50_s']:.0f} ms), submissions late by "
          f"up to {1e3 * p['submit_lag_max_s']:.0f} ms, inbox wait up to "
          f"{1e3 * p['inbox_wait_max_s']:.0f} ms, {p['tokens_per_s']:.1f} "
          f"tok/s, goodput {p['goodput_rps']:.3f} req/s; phase "
          f"{out['phase_s']:.1f} s", flush=True)
    return launches


# decode steps profiled (a spec engine: one wave). Only qwen2.5-3b's
# dense and paged serve phases are profiled: the other archs' profiles
# (nine, 12-47 s each on a slow host, PR 27) left the script to keep it
# inside its time limit; their idle shares stand in PERF.md as measured.
PROFILE_STEPS = 2


def profile_decode(torch, P, cfg, eng, report, key="serve"):
    """Device busy time of decode steps, from the profiler's CUDA
    kernel records, beside the un-profiled decode step time of the serve
    phase ``key``. The requests last one unprofiled chunk and one
    profiled chunk of ``PROFILE_STEPS`` steps, so nothing is left to
    serve after the profile (a spec engine's wave commits a varying
    count: its drain may take a few waves more)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    block = eng.decode_block
    spec = eng.spec is not None
    rng = np.random.default_rng(5)
    reqs = [P["Request"](uid=100 + i, prompt=rng.integers(
        0, cfg.vocab_size, 64).astype(np.int32),
        max_new_tokens=1 + block + (block if spec else PROFILE_STEPS))
        for i in range(SLOTS)]
    for r in reqs:
        eng.submit(r)
    eng.step()                          # admission + first chunk, unprofiled
    torch.cuda.synchronize()
    steps0 = eng.stats()["decode_steps"]
    # a short chunk: the profiler's records of thousands of kernels a
    # step take it seconds to collect, and a few steps' mean suffices
    if not spec:
        eng.decode_block = PROFILE_STEPS
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
    finally:
        eng.decode_block = block
    steps = eng.stats()["decode_steps"] - steps0
    eng.run_until_drained()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    name = "decode_profile" if key == "serve" else f"{key}_decode_profile"
    if not kernels or not steps:
        report[name] = "not measured: no device records"
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3 / steps
    step_ms = report[key]["decode_step_ms"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    report[name] = {
        "decode_steps": steps, "device_busy_ms_per_step": busy_ms,
        "decode_step_ms_unprofiled": step_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
        "kernels_per_step": len(kernels) / steps,
        "top_kernels_us_per_step": [(n[:90], us / steps) for n, us in top]}
    print(f"{key} decode profile: device busy {busy_ms:.2f} ms of a "
          f"{step_ms:.2f} ms step ({len(kernels) / steps:.0f} kernels per "
          f"step)", flush=True)


# --------------------------------------------------------------------------
# phase 2 + 4: slstm_scan (the sLSTM recurrence of the QAT teacher)
# --------------------------------------------------------------------------

XLSTM = "xlstm-125m"
# (B, T, d): the QAT phase's shape, a ragged one, two batch tiles (the
# kernel loops over tiles of 8 rows) at xlstm-125m's width, and narrow
# widths (2 hidden indices a CTA, fewer than the 8 it works at once; 202
# is not a multiple of 4, so h is read into shared memory by floats)
SLSTM_CASES = ((TRAIN_B, TRAIN_T, 0), (3, 100, 0), (11, 37, 0), (5, 64, 200),
               (2, 16, 202))
SLSTM_ROUTES = ("resident", "step")
SLSTM_STATE_ATOL = 1e-4        # hT, cT (f32) against the plain version
SLSTM_ORACLE_RATIO = 4.0       # kernel's f64-oracle error / plain's
SLSTM_ORACLE_FLOOR = 1e-6
# carry="gx": a cell step of the kernel against plain, at most this times
# the floor (see check_slstm_gx)
SLSTM_GX_RATIO = 2.0
SLSTM_GX_SHORT_T = 16          # at T <= 16, hs within one bf16 ulp


def slstm_inputs(torch, gen, B, T, d, dev):
    """The teacher's operands: bf16 gx and r_h, f32 h0 and c0 (non-zero
    here; the model starts from zeros)."""
    return ((torch.randn((B, T, 4 * d), generator=gen, device=dev) * 0.5
             ).to(torch.bfloat16),
            (torch.randn((d, 4 * d), generator=gen, device=dev) * d ** -0.5
             ).to(torch.bfloat16),
            torch.randn((B, d), generator=gen, device=dev) * 0.1,
            torch.randn((B, d), generator=gen, device=dev) * 0.1)


def same(torch, a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_slstm(torch, P, xcfg, dev, report):
    """The kernel against its plain version (torch's f32 GEMM per step)
    and both against an f64 run of the plain version (the oracle), on
    each route forced.

    Both compute each step's h . r_h in f32 over d products in different
    orders, and the state carries those ulps through up to 128 steps: hT
    and cT are held to ``SLSTM_STATE_ATOL``, hs (bf16) to one bf16 ulp
    (``KVQ_TOL``), and the kernel's error against the oracle to at most
    ``SLSTM_ORACLE_RATIO`` times the plain version's (plus
    ``SLSTM_ORACLE_FLOOR``). Each route's sum order depends on nothing
    but the route, so a second call and a row run alone must be bitwise
    the same; the launcher's own choice (the main path) must be the
    resident route at these widths, bitwise."""
    ops, ref = P["slstm_ops"], P["slstm_scan_ref"]
    scan = ops.slstm_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    rtol, atol = KVQ_TOL
    cases, worst = [], 0.0
    for B, T, d in SLSTM_CASES:
        d = d or xcfg.d_model
        check(ops.route_for(d) == "resident",
              f"slstm_scan at d {d} takes the {ops.route_for(d)} route")
        args = slstm_inputs(torch, gen, B, T, d, dev)
        want = ref(*args)
        oracle = slstm_oracle(torch, *args)
        auto = scan(*args)
        b = B // 2
        for route in SLSTM_ROUTES:
            got = scan(*args, route=route)
            again = scan(*args, route=route)
            gx, r_h, h0, c0 = args
            alone = scan(gx[b:b + 1], r_h, h0[b:b + 1], c0[b:b + 1],
                         route=route)
            torch.cuda.synchronize()
            case = {"B": B, "T": T, "d": d, "route": route}
            for name, g, w, o in zip(("hs", "hT", "cT"), got, want, oracle):
                g, w = g.double(), w.double()
                case[name] = {"max_abs_err": float((g - w).abs().max()),
                              "kernel_vs_oracle": float((g - o).abs().max()),
                              "plain_vs_oracle": float((w - o).abs().max())}
                check(bool(torch.isfinite(g).all()),
                      f"slstm_scan {case}: {name} not finite")
            cases.append(case)
            ok = (torch.allclose(got[0].float(), want[0].float(), rtol=rtol,
                                 atol=atol)
                  and case["hT"]["max_abs_err"] <= SLSTM_STATE_ATOL
                  and case["cT"]["max_abs_err"] <= SLSTM_STATE_ATOL
                  and all(case[n]["kernel_vs_oracle"] <= SLSTM_ORACLE_RATIO
                          * case[n]["plain_vs_oracle"] + SLSTM_ORACLE_FLOOR
                          for n in ("hs", "hT", "cT")))
            check(ok, f"slstm_scan B={B} T={T} d={d} ({route}) differs "
                      f"from its plain version: {case} (hs within rtol "
                      f"{rtol} atol {atol}, hT/cT within "
                      f"{SLSTM_STATE_ATOL}, oracle error at most "
                      f"{SLSTM_ORACLE_RATIO}x the plain version's)")
            check(same(torch, got, again),
                  f"slstm_scan {route} B={B} T={T} d={d}: two calls differ")
            check(same(torch, (got[0][b:b + 1], got[1][b:b + 1],
                               got[2][b:b + 1]), alone),
                  f"slstm_scan {route} B={B} T={T} d={d}: row {b} alone "
                  f"differs from the same row in the batch")
            if route == "resident":
                check(same(torch, got, auto),
                      f"slstm_scan B={B} T={T} d={d}: the launcher's own "
                      f"route differs from the resident route")
            worst = max(worst, *(case[n]["max_abs_err"]
                                 for n in ("hs", "hT", "cT")))
            del got, again, alone
        del args, want, oracle, auto
    report["slstm_check"] = cases
    print(f"phase 2: slstm_scan against its plain version and an f64 "
          f"oracle, each route, bitwise call to call and row alone vs "
          f"batch: {cases}", flush=True)
    report["slstm_kernels_per_call"] = slstm_kernels_per_call(
        torch, P, xcfg, dev)
    check_slstm_scratch(torch, P, xcfg, dev)
    return max(worst, check_slstm_gx(torch, P, xcfg, dev, report))


def bf16_steps(torch, a, b):
    """|a - b| in bf16 steps of the larger magnitude (2^(e - 7) for a
    magnitude in [2^e, 2^(e + 1)); normal range)."""
    a, b = a.double(), b.double()
    m = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)


def gx_gaps(torch, h, c, h_ref, c_ref):
    """The gx carry's three metrics between two runs: the share of h
    values that differ, their largest difference in bf16 steps, and c's
    largest absolute difference."""
    return {"hs_share": float((h != h_ref).double().mean()),
            "hs_steps": float(bf16_steps(torch, h, h_ref).max()),
            "cT": float((c.double() - c_ref.double()).abs().max())}


def gx_dot(torch, h, rf, how):
    """h . r_h in f32 for the gx carry: "plain" (one GEMM, as the plain
    version), "f64" (in f64, then to f32) or "halves" (over each half of
    h's entries, then added, as the resident route splits them)."""
    if how == "f64":
        return (h.double() @ rf.double()).float()
    if how == "halves":
        m = h.shape[-1] // 2
        return h[:, :m] @ rf[:m] + h[:, m:] @ rf[m:]
    return h @ rf


def gx_cell(torch, g, c_prev, dtype):
    """The cell's gates from g (f32 holding gx's dtype): (h in dtype, c)."""
    i, f, z, o = g.split(g.shape[-1] // 4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(z)
    return (torch.sigmoid(o) * torch.tanh(c)).to(dtype), c


def gx_step(torch, gx_t, h_prev, c_prev, rf, how="plain"):
    """One step of the plain version's gx carry, its dot summed ``how``."""
    s = gx_dot(torch, h_prev.float(), rf, how).to(gx_t.dtype)
    g = (gx_t.float() + s.float()).to(gx_t.dtype).float()
    return gx_cell(torch, g, c_prev, gx_t.dtype)


def gx_trajectory(torch, gx, r_h, h0, c0, how="plain"):
    """The plain version's gx carry over gx's T steps, its dot summed
    ``how``; with "plain" the same operations as ``slstm_scan_ref(...,
    carry="gx")``. Returns (hs, cs): every step's h and c."""
    rf = r_h.float()
    h, c = h0.to(gx.dtype), c0.float()
    hs, cs = [], []
    for t in range(gx.shape[1]):
        h, c = gx_step(torch, gx[:, t], h, c, rf, how)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def gx_one_flip(torch, gx, h_prev, c_prev, rf):
    """The largest change of one cell step (h in bf16 steps, c absolute)
    when one gate pre-activation moves by one bf16 step: what a single
    rounding of h . r_h or of its sum with gx that lands on the other
    side of a bf16 boundary does."""
    s = gx_dot(torch, h_prev.float(), rf, "plain").to(gx.dtype)
    g = (gx.float() + s.float()).to(gx.dtype).float()
    h0, c0 = gx_cell(torch, g, c_prev, gx.dtype)
    d = g.shape[-1] // 4
    ulp = torch.exp2(torch.floor(torch.log2(g.abs().clamp_min(2.0 ** -126)))
                     - 7)
    out = {"hs_steps": 0.0, "cT": 0.0}
    for k in range(4):
        for sign in (-1.0, 1.0):
            g2 = g.clone()
            g2[:, k * d:(k + 1) * d] += sign * ulp[:, k * d:(k + 1) * d]
            h2, c2 = gx_cell(torch, g2, c_prev, gx.dtype)
            out["hs_steps"] = max(out["hs_steps"], float(
                bf16_steps(torch, h2, h0).max()))
            out["cT"] = max(out["cT"], float((c2 - c0).abs().max()))
    return out


def check_slstm_gx(torch, P, xcfg, dev, report):
    """``carry="gx"`` (the reference model's cell, the QAT teacher's
    mode) on each route forced, against its plain version.

    Both round h . r_h and its sum with gx to bf16 and carry h in bf16,
    so a sum that lands near a bf16 rounding boundary can round one way
    in the kernel's f32 order and the other in cuBLAS's. Over a sequence
    the recurrence carries such a flip on and amplifies it, so whole
    trajectories from two sum orders differ by amounts that vary several
    fold from one order to the next (the plain version re-summed in f64
    and in halves gave 1.3% of hs apart at (11, 37) on the card where
    the kernel gave 3.2%, with the same steps and cT). The gate is
    therefore taken on the cell: every step is rerun from the plain
    trajectory's own (h, c) before it, in one kernel call with the B x T
    steps as rows of T = 1 (a row's sums do not depend on the batch), and
    its three gaps to the plain trajectory (``gx_gaps``: the share of h
    that differs, the largest difference in bf16 steps, c's largest
    absolute difference) may be at most ``SLSTM_GX_RATIO`` times the
    floor: the larger of the plain cell's own gaps with its dot summed
    in f64 or in halves, what one bf16 step of one gate pre-activation
    moves (``gx_one_flip``), and 16 values of h. The whole trajectory's
    gaps are reported beside the same two re-summed trajectories' (the
    noise floor of a rounding-defined recurrence); at T <= 16 its hs
    must be within one bf16 ulp of plain's (``KVQ_TOL``, as the f32
    carry's). As for the f32 carry: two calls are bitwise equal, a row
    alone is bitwise the same row in the batch, and the launcher's own
    route is the resident one, bitwise. Returns the largest cell c gap.
    """
    ops, ref = P["slstm_ops"], P["slstm_scan_ref"]
    scan = ops.slstm_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(45)
    rtol, atol = KVQ_TOL
    cases, worst = [], 0.0
    for B, T, d in SLSTM_CASES:
        d = d or xcfg.d_model
        check(ops.route_for(d, carry="gx") == "resident",
              f"slstm_scan carry gx at d {d} takes the "
              f"{ops.route_for(d, carry='gx')} route")
        args = slstm_inputs(torch, gen, B, T, d, dev)
        gx, r_h, h0, c0 = args
        rf = r_h.float()
        want = ref(*args, carry="gx")
        hs, cs = gx_trajectory(torch, *args)
        check(same(torch, (hs, hs[:, -1], cs[:, -1]), want),
              f"slstm_scan carry gx B={B} T={T} d={d}: the stepwise plain "
              f"trajectory differs from the plain version")
        # the cell, every step from the plain trajectory's state before it
        h_prev = torch.cat([h0.to(gx.dtype)[:, None], hs[:, :-1]], dim=1)
        c_prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
        rows = (gx.reshape(B * T, 1, 4 * d), h_prev.reshape(B * T, d),
                c_prev.reshape(B * T, d))
        h_cell, c_cell = hs.reshape(B * T, d), cs.reshape(B * T, d)
        traj_floor, cell_floor = {}, {}
        for how in ("f64", "halves"):
            h2, c2 = gx_trajectory(torch, *args, how)
            traj_floor[how] = gx_gaps(torch, h2, c2[:, -1], hs, cs[:, -1])
            h2, c2 = gx_step(torch, rows[0][:, 0], rows[1], rows[2], rf, how)
            cell_floor[how] = gx_gaps(torch, h2, c2, h_cell, c_cell)
        flip = gx_one_flip(torch, rows[0][:, 0], rows[1], rows[2], rf)
        floor = {"hs_share": max(16 / h_cell.numel(), *(
                     f["hs_share"] for f in cell_floor.values())),
                 "hs_steps": max(flip["hs_steps"], *(
                     f["hs_steps"] for f in cell_floor.values())),
                 "cT": max(flip["cT"], *(f["cT"] for f in
                                         cell_floor.values()))}
        auto = scan(*args, carry="gx")
        b = B // 2
        for route in SLSTM_ROUTES:
            got = scan(*args, carry="gx", route=route)
            again = scan(*args, carry="gx", route=route)
            alone = scan(gx[b:b + 1], r_h, h0[b:b + 1], c0[b:b + 1],
                         carry="gx", route=route)
            cell = scan(rows[0], r_h, rows[1].float(), rows[2],
                        carry="gx", route=route)
            torch.cuda.synchronize()
            cell_gaps = gx_gaps(torch, cell[0][:, 0], cell[2], h_cell,
                                c_cell)
            case = {"B": B, "T": T, "d": d, "route": route,
                    "cell": cell_gaps, "cell_floor": floor,
                    "cell_floors": {**cell_floor, "one_flip": flip},
                    "trajectory": gx_gaps(torch, got[0], got[2], want[0],
                                          want[2]),
                    "trajectory_floors": traj_floor}
            cases.append(case)
            check(all(bool(torch.isfinite(t.float()).all())
                      for t in got + cell)
                  and got[0].dtype == got[1].dtype == gx.dtype,
                  f"slstm_scan carry gx {case}: not finite, or hs / hT "
                  f"not in gx's dtype")
            check(all(cell_gaps[k] <= SLSTM_GX_RATIO * floor[k]
                      for k in floor),
                  f"slstm_scan carry gx B={B} T={T} d={d} ({route}): a "
                  f"cell step differs from its plain version beyond "
                  f"{SLSTM_GX_RATIO}x the floor: {case}")
            check(T > SLSTM_GX_SHORT_T or torch.allclose(
                      got[0].float(), want[0].float(), rtol=rtol, atol=atol),
                  f"slstm_scan carry gx B={B} T={T} d={d} ({route}): hs "
                  f"beyond one bf16 ulp of plain at T <= "
                  f"{SLSTM_GX_SHORT_T}: {case}")
            check(same(torch, got, again),
                  f"slstm_scan carry gx {route} B={B} T={T} d={d}: two "
                  f"calls differ")
            check(same(torch, (got[0][b:b + 1], got[1][b:b + 1],
                               got[2][b:b + 1]), alone),
                  f"slstm_scan carry gx {route} B={B} T={T} d={d}: row {b} "
                  f"alone differs from the same row in the batch")
            if route == "resident":
                check(same(torch, got, auto),
                      f"slstm_scan carry gx B={B} T={T} d={d}: the "
                      f"launcher's own route differs from the resident one")
            worst = max(worst, cell_gaps["cT"])
            del got, again, alone, cell
        del args, want, auto, hs, cs, rows
    report["slstm_gx_check"] = cases
    print("phase 2: slstm_scan carry gx against its plain version, each "
          "route: " + json.dumps([
              {k: c[k] for k in ("B", "T", "d", "route", "cell",
                                 "cell_floor", "trajectory")}
              for c in cases]), flush=True)
    return worst


PROFILE_ATTEMPTS = 3


def device_kernel_names(torch, dev, fn, what):
    """Names of the kernels ``fn`` launches, from ``torch.profiler``'s
    device records. A fill of one element runs inside each profile, so
    a profile with no device record at all lost its records (seen once
    on the card, in the third of four profiles of one process): it is
    taken again, up to ``PROFILE_ATTEMPTS`` times, and the run fails
    if none records anything. The fill's record stays in the list: the
    callers count kernels by names that it does not carry."""
    from torch.profiler import ProfilerActivity, profile
    probe = torch.empty(1, device=dev)
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            probe.fill_(1.0)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    check(False, f"{what}: the profiler recorded no device event, not "
                 f"even a fill, in {PROFILE_ATTEMPTS} attempts")


def slstm_kernels_per_call(torch, P, xcfg, dev):
    """Kernels named ``slstm_*`` that one call launches on each route and
    carry at the QAT shape, from ``torch.profiler``'s device records: 1
    resident, T step."""
    scan = P["slstm_ops"].slstm_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(43)
    args = slstm_inputs(torch, gen, TRAIN_B, TRAIN_T, xcfg.d_model, dev)
    out = {}
    for carry, route, want in (("f32", "resident", 1),
                               ("f32", "step", TRAIN_T),
                               ("gx", "resident", 1), ("gx", "step", TRAIN_T)):
        key = route if carry == "f32" else f"{route}_gx"
        scan(*args, carry=carry, route=route)
        torch.cuda.synchronize()
        names = device_kernel_names(
            torch, dev, lambda: scan(*args, carry=carry, route=route),
            f"slstm_scan {route} carry {carry}")
        out[key] = sum("slstm_" in n for n in names)
        check(out[key] == want,
              f"slstm_scan {route} carry {carry}: {out[key]} slstm kernels "
              f"in one call (want {want}; device records: "
              f"{sorted(set(names))[:8]})")
    print(f"phase 2: slstm_scan kernels a call at B {TRAIN_B}, T "
          f"{TRAIN_T}: {out}", flush=True)
    return out


def check_slstm_scratch(torch, P, xcfg, dev):
    """The launcher refuses (cudaErrorInvalidValue, 1) a barrier scratch
    shorter than ``BAR_INTS`` and writes nothing. Calls the C launcher
    directly: nothing launches, no count moves."""
    ops = P["slstm_ops"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(44)
    B, T, d = 3, 4, xcfg.d_model
    gx, r_h, h0, c0 = slstm_inputs(torch, gen, B, T, d, dev)
    hbuf = torch.zeros((2, B, d), dtype=torch.float32, device=dev)
    c = torch.zeros((B, d), dtype=torch.float32, device=dev)
    hs = torch.zeros((B, T, d), dtype=gx.dtype, device=dev)
    bar = torch.zeros(ops.BAR_INTS, dtype=torch.int32, device=dev)
    for carry in (0, 1):
        for route in (0, 1, 2):
            err = ops._fn()(gx.data_ptr(), r_h.data_ptr(), hbuf.data_ptr(),
                            c.data_ptr(), hs.data_ptr(), bar.data_ptr(),
                            ops.BAR_INTS - 1, B, T, d, 1, 1, carry, route,
                            torch.cuda.current_stream(dev).cuda_stream)
            torch.cuda.synchronize()
            check(err == 1 and not bool(hs.any()) and not bool(hbuf.any())
                  and not bool(c.any()),
                  f"slstm_scan took {ops.BAR_INTS - 1} of {ops.BAR_INTS} "
                  f"barrier ints on route {route}, carry {carry}: error "
                  f"{err}")


def slstm_oracle(torch, gx, r_h, h0, c0):
    """The recurrence in f64 throughout (hs not rounded to gx's dtype)."""
    d = h0.shape[-1]
    g_x, rf, h, c = gx.double(), r_h.double(), h0.double(), c0.double()
    hs = []
    for t in range(gx.shape[1]):
        i, f, z, o = (g_x[:, t] + h @ rf).split(d, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1), h, c


def slstm_library(torch, gx, r_h, h0, c0, carry="f32"):
    """The same recurrence as one torch GEMM per step plus torch's
    elementwise gates (a yardstick; the port never calls it): f32
    ``torch.addmm``, or under ``carry="gx"`` ``torch.mm`` on the bf16 h
    with the roundings of the reference's cell."""
    d = h0.shape[-1]
    gxf, rf = gx.float(), r_h.float()
    h, c = (h0.to(gx.dtype) if carry == "gx" else h0), c0
    hs = torch.empty(gx.shape[:2] + (d,), dtype=gx.dtype, device=gx.device)
    for t in range(gx.shape[1]):
        if carry == "gx":
            s = torch.mm(h.float(), rf).to(gx.dtype)
            g = (gxf[:, t] + s.float()).to(gx.dtype).float()
        else:
            g = torch.addmm(gxf[:, t], h, rf)
        i, f, z, o = g.split(d, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
        h = torch.sigmoid(o) * torch.tanh(c)
        if carry == "gx":
            h = h.to(gx.dtype)
        hs[:, t] = h
    return hs, h, c


def time_slstm(torch, P, xcfg, dev, report):
    """Per teacher forward: 2 calls (the two sLSTM layers) at the QAT
    phase's shape, in the teacher's mode (``carry="gx"``); the f32
    carry's times beside it (``f32_carry_*``)."""
    scan, ref = P["slstm_ops"].slstm_scan, P["slstm_scan_ref"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    B, T, d = TRAIN_B, TRAIN_T, xcfg.d_model
    base = slstm_inputs(torch, gen, B, T, d, dev)
    base = base[:2] + (torch.zeros_like(base[2]), torch.zeros_like(base[3]))
    nb = tensor_bytes(*base)
    sets = [base] + [slstm_inputs(torch, gen, B, T, d, dev)
                     for _ in range(copies_for(nb) - 1)]
    flops = 2 * B * T * d * 4 * d               # h . r_h, every step
    # gx and r_h read once (bf16), h0 and c0 read, hs (bf16), hT, cT out
    nbytes = 2 * B * T * 4 * d + 2 * d * 4 * d + 2 * B * T * d \
        + 4 * 4 * B * d
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    n = sum(k == "slstm" for k in xcfg.layer_kinds())
    per_call = {}
    for carry in ("gx", "f32"):
        t_k = time_ms(torch, lambda *a: scan(*a, carry=carry), sets,
                      min_calls=10)
        t_p = time_ms(torch, lambda *a: ref(*a, carry=carry), sets[:4],
                      min_calls=4)
        t_l = time_ms(torch, lambda *a: slstm_library(torch, *a, carry),
                      sets[:4], min_calls=4)
        t_host = host_issued_ms(torch, lambda *a: scan(*a, carry=carry),
                                sets, min_calls=10)
        per_call[carry] = {
            "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
            "host_issued_ms": t_host, "bound_ms": max(t_b, t_o) * 1e3,
            "flops": flops, "bytes": nbytes, "steps": T,
            "ms_per_step": t_k / T,
            "route": P["slstm_ops"].route_for(d, carry=carry),
            "launches_per_call": report["slstm_kernels_per_call"][
                "resident" if carry == "f32" else "resident_gx"]}
    report["slstm_per_call"] = per_call
    gx, f32 = per_call["gx"], per_call["f32"]
    return {"ms": n * gx["ms"], "plain_ms": n * gx["plain_ms"],
            "library_ms": n * gx["library_ms"],
            "bound_ms": n * max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "f32_carry_ms": n * f32["ms"],
            "f32_carry_plain_ms": n * f32["plain_ms"],
            "f32_carry_library_ms": n * f32["library_ms"]}


# --------------------------------------------------------------------------
# cold-prefill batch invariance (qwen2.5-3b, w4a8 and bf16 layouts, dense)
# --------------------------------------------------------------------------

PREFILL_ROW_LENS = (37, 128, 90, 61)     # the prompt under test first


def prefill_rows(torch, P, cfg, dev, params, report):
    """One prompt prefilled alone and in a wave of 4 beside longer and
    shorter prompts (so the wave's padded length and row count differ):
    its cache codes and scales and its first-token logits must be
    bitwise the same. Under the w4a8 layout, measured first with the
    wave's attention batched (the reference's form, patched in for this
    run), then with the port's row-by-row attention on CUDA
    (``blocks._prefill_attention_rows``), which must hold. Under the bf16
    layout (the serve CLI's default; fresh bf16 weights from the same
    seed), whose linears are cuBLAS GEMMs over the whole wave, it must
    hold as well. The wave's prefill ms beside each."""
    import numpy as np
    models, blocks, qat = P["models"], P["blocks"], P["qat"]
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PREFILL_ROW_LENS]

    def wave(rows, prm, ctx):
        lens = [len(prompts[i]) for i in rows]
        L = int(math.ceil(max(lens) / 16) * 16)
        toks = torch.zeros((len(rows), L), dtype=torch.int32, device=dev)
        for j, i in enumerate(rows):
            toks[j, :lens[j]] = torch.from_numpy(prompts[i]).to(dev)
        logits, cache = models.prefill(
            cfg, prm, ctx, {"tokens": toks, "lengths": torch.tensor(
                lens, dtype=torch.int32, device=dev)},
            cache_budget=CACHE_LEN)
        return logits[0], [{k: v[0] for k, v in c.items()}
                           for c in cache["layers"]]

    def compare(prm, ctx):
        la, ca = wave([0], prm, ctx)
        lw, cw = wave(range(len(prompts)), prm, ctx)
        torch.cuda.synchronize()
        differ = sum(int((a[k] != b[k]).sum()) for a, b in zip(ca, cw)
                     for k in ("k_q", "v_q", "s_k", "s_v"))
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            wave(range(len(prompts)), prm, ctx)
        torch.cuda.synchronize()
        return {"logits_bitwise": bool(torch.equal(la, lw)),
                "logits_max_abs_diff": float((la.float() - lw.float())
                                             .abs().max()),
                "cache_values_differing": differ,
                "wave_ms": (time.perf_counter() - t0) * 1e3 / reps}

    def batched(q, k, v, lengths, window=0, causal=True):   # in one call
        return blocks.blockwise_attention(q, k, v, causal=causal,
                                          window=window)

    out = {"lens": list(PREFILL_ROW_LENS)}
    ctx = qat.make_ctx("A8d-C8-W4", weights_layout="w4a8")
    rows = blocks._prefill_attention_rows
    try:
        blocks._prefill_attention_rows = batched
        out["batched_attention"] = compare(params, ctx)
    finally:
        blocks._prefill_attention_rows = rows
    out["row_attention"] = compare(params, ctx)
    bf16 = models.init_params(cfg, seed=0, device=dev)
    out["bf16"] = compare(bf16, qat.make_ctx("A8d-C8-W4",
                                             weights_layout="bf16"))
    del bf16
    torch.cuda.empty_cache()
    report["prefill_row_invariance"] = out
    for key in ("row_attention", "bf16"):
        row = out[key]
        check(row["logits_bitwise"] and row["cache_values_differing"] == 0,
              f"cold prefill ({key}): a prompt's cache or logits differ "
              f"alone and in a wave of 4: {out}")
    print(f"phase 3: cold prefill batch invariance (one prompt alone vs in "
          f"a wave of 4): {out}", flush=True)


# --------------------------------------------------------------------------
# phase 3f: dense w4a8 serving of xlstm-125m
# --------------------------------------------------------------------------

XLSTM_LENS = (64, 96)          # two exact-length admission groups
ATTENTION_KERNELS = ("kvq_decode_attn", "kvq_paged_decode_attn",
                     "kvq_spec_verify_attn", "gather_dequant_paged_kv",
                     "pool_block_copy", "flash_attn_fwd")


def serve_xlstm(torch, P, xcfg, dev, report):
    """xlstm-125m at full width (12 layers, random weights from a seed),
    A8d-C8-W4, w4a8 weights, dense: 8 requests in two exact-length groups
    through 4 slots. w4a8_matmul launches, no attention kernel does, and
    neither does slstm_scan (serving runs the quantized per-step cell);
    one decode step's logits through the kernels against the plain
    versions."""
    import numpy as np
    qat, models = P["qat"], P["models"]
    torch.cuda.reset_peak_memory_stats(dev)
    params = models.init_params(xcfg, seed=0, device=dev)
    eng = P["ServeEngine"](xcfg, params, policy="A8d-C8-W4", slots=SLOTS,
                           cache_len=CACHE_LEN, max_new_cap=MAX_NEW,
                           decode_block=8, weights_layout="w4a8", device=dev)
    del params
    eng.params = qat.drop_exported_weights(eng.params)
    torch.cuda.synchronize()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, xcfg.vocab_size, XLSTM_LENS[i // SLOTS])
               .astype(np.int32) for i in range(2 * SLOTS)]

    toks = torch.from_numpy(np.stack(prompts[:SLOTS])).to(dev)
    logits0, cache = models.prefill(xcfg, eng.params, eng.ctx,
                                    {"tokens": toks}, cache_budget=CACHE_LEN)
    tok1 = torch.argmax(logits0[:, -1].float(), -1).to(torch.int32)[:, None]
    lk, _ = models.decode_step(xcfg, eng.params, eng.ctx, tok1,
                               models.clone_cache(cache))
    lp, _ = models.decode_step(xcfg, eng.params,
                               replace(eng.ctx, kernel_backend="ref"), tok1,
                               models.clone_cache(cache))
    lk, lp = lk.float(), lp.float()
    check(bool(torch.isfinite(lk).all()), "xlstm decode logits not finite")
    rel = float(torch.linalg.vector_norm(lk - lp)
                / torch.linalg.vector_norm(lp))
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    check(rel <= LOGIT_REL_TOL,
          f"xlstm: kernel decode logits differ from the plain versions' by "
          f"relative L2 {rel} > {LOGIT_REL_TOL}")
    del cache, logits0, lk, lp

    reqs = [P["Request"](uid=i, prompt=p, max_new_tokens=MAX_NEW,
                         temperature=0.8 if i % 4 == 3 else 0.0,
                         top_k=8 if i % 4 == 3 else 0, seed=i)
            for i, p in enumerate(prompts)]
    counted = {**counted_kernels(P),
               "flash_attn_fwd": P["fa_ops"].flash_attn_fwd,
               "slstm_scan": P["slstm_ops"].slstm_scan}
    for r in reqs:
        eng.submit(r)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counted.items()}
    check_streams(xcfg, reqs, "xlstm serve")
    check(launches["w4a8_matmul"] > 0,
          f"xlstm serve: w4a8_matmul never launched: {launches}")
    check(all(launches[n] == 0 for n in ATTENTION_KERNELS + ("slstm_scan",)),
          f"xlstm serve: an attention kernel or the scan ran: {launches}")
    check(stats["prefill_calls"] == 2,
          f"xlstm serve: {stats['prefill_calls']} prefill waves, want 2 "
          f"exact-length groups")
    decode_tokens = stats["tokens_out"] - len(reqs)
    served = {"requests": len(reqs), "prompt_lens": list(XLSTM_LENS),
              "tokens_out": stats["tokens_out"], "wall_s": wall,
              "tokens_per_s": stats["tokens_out"] / wall,
              "decode_tokens_per_s": decode_tokens / stats["decode_s"],
              "decode_step_ms": 1e3 * stats["decode_step_s"],
              "decode_steps": stats["decode_steps"],
              "ttft_p50_s": stats["ttft_p50_s"],
              "ttft_p95_s": stats["ttft_p95_s"],
              "prefill_s": stats["prefill_s"],
              "prefill_calls": stats["prefill_calls"],
              "decode_logits_rel_l2_kernels_vs_plain": rel,
              "decode_logits_argmax_agreement": agree,
              "launches": launches,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    report["serve_xlstm"] = served
    print("serve_xlstm " + json.dumps(served), flush=True)
    print(f"phase 3f: xlstm-125m dense w4a8 serve, "
          f"{served['decode_tokens_per_s']:.2f} decode tok/s, "
          f"{served['decode_step_ms']:.2f} ms per decode step; one decode "
          f"step's logits kernels vs plain relative L2 {rel:.3g}",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# phase 6: QAT of xlstm-125m at full width
# --------------------------------------------------------------------------

XLSTM_TRAIN_STEPS = 2


def xlstm_weight_sites(xcfg):
    """Fake-quantized weights of one student forward: 6 per mLSTM layer,
    4 per sLSTM layer (r_h once, not once per step) and the head."""
    kinds = xcfg.layer_kinds()
    return 6 * kinds.count("mlstm") + 4 * kinds.count("slstm") + 1


def train_xlstm(torch, P, xcfg, dev, report):
    """run_qat on xlstm-125m at full width (12 layers), A8d-C8-W4, B 8,
    T 128: 2 teacher steps, 2 steps. Per step slstm_scan launches once
    per sLSTM layer (the teacher forward), fake_quant_fwd / _bwd once per
    weight site (no T-fold multiplication from the sLSTM loop),
    flash_attn_fwd never; every s_w moves."""
    tcfg = P["TrainConfig"](precision="A8d-C8-W4",
                            total_steps=XLSTM_TRAIN_STEPS,
                            ref_steps=XLSTM_TRAIN_STEPS, batch_size=TRAIN_B,
                            seq_len=TRAIN_T)
    steps, state = [], {}

    def on_start(student, opt):
        state["s_w0"] = {k: t.detach().clone() for k, t in
                         _named_leaves(student) if k.endswith("s_w")}
        state["counts"] = tuple(fn.launches for fn in train_counters(P))

    def on_step(step, metrics, student, opt):
        counts = tuple(fn.launches for fn in train_counters(P))
        steps.append({"step": step, "loss": float(metrics["loss"]),
                      "ms": metrics["ms"],
                      "launches": [a - b for a, b in
                                   zip(counts, state["counts"])]})
        state["counts"] = counts
        state["opt"] = opt

    for fn in train_counters(P):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    teacher, student, _ = P["train"].run_qat(
        XLSTM, tcfg, reduced=False, teacher_steps=2, device=dev,
        log_every=1, split_times=True, on_start=on_start, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    names = ("fake_quant_fwd", "fake_quant_bwd", "flash_attn_fwd",
             "slstm_scan")
    launches = dict(zip(names, (fn.launches for fn in train_counters(P))))
    peak = torch.cuda.max_memory_allocated(dev)
    n_w = xlstm_weight_sites(xcfg)
    n_s = xcfg.layer_kinds().count("slstm")
    for s in steps:
        got = dict(zip(names, s["launches"]))
        check(s["launches"] == [n_w, n_w, 0, n_s],
              f"xlstm QAT step {s['step']}: launches {got}, want "
              f"({n_w}, {n_w}, 0, {n_s})")
        check(math.isfinite(s["loss"]),
              f"xlstm QAT step {s['step']}: KD loss {s['loss']}")
    check(len(steps) == XLSTM_TRAIN_STEPS, f"{len(steps)} xlstm QAT steps")
    opt = state.pop("opt")
    named = dict(_named_leaves(student))
    unmoved = [k for k, t0_ in state["s_w0"].items()
               if torch.equal(named[k], t0_)]
    check(len(state["s_w0"]) == n_w and not unmoved,
          f"xlstm: s_w that did not move: {unmoved[:5]} ({len(unmoved)})")
    check(all(bool(torch.isfinite(t).all()) for t in named.values()),
          "xlstm: a parameter is not finite after QAT")
    del opt, state
    torch.cuda.empty_cache()
    per = {k: sum(s["ms"][k] for s in steps[1:]) / (len(steps) - 1)
           for k in ("teacher", "student", "optimizer")}
    step_ms = sum(per.values())
    trained = {"arch": XLSTM, "steps": XLSTM_TRAIN_STEPS, "batch": TRAIN_B,
               "seq": TRAIN_T, "losses": [s["loss"] for s in steps],
               "ms_per_step": step_ms, "ms_split": per,
               "ms_first_step": sum(steps[0]["ms"].values()),
               "tokens_per_s": TRAIN_B * TRAIN_T / (step_ms / 1e3),
               "peak_memory_bytes": peak, "wall_s": wall,
               "launches_per_step": dict(zip(names, steps[-1]["launches"])),
               "weight_sites": n_w, "launches": launches}
    report["train_xlstm"] = trained
    print("phase 6: " + json.dumps(trained), flush=True)
    return launches


# --------------------------------------------------------------------------
# phase 7: the PTQ baselines, the residual rotation and Procrustes
# --------------------------------------------------------------------------

PTQ_POLICIES = ("A8d-C8-W4", "A8s-C8-W4")   # Table 1's first two configs
PTQ_EVAL_BATCHES = 2
PTQ_CALIB_BATCHES = 5                       # as ptq_baselines calibrates
FOLD_ALPHA = 0.4                            # SiLQ App. D
ROT_SEED = 11
# The folded / rotated tree's logits (B 8, T 64, mode off) against the
# original's, relative L2, within ROUNDOFF_MULT times the original's own
# bf16 round-off at 36 layers: its bf16 forward against the same forward
# with f32 params (plain versions). Two bf16 forwards that round apart
# independently part by sqrt(2) of it.
ROUNDOFF_MULT = 2.0
# The rotational shares are read on the first SHARE_LAYERS layers: every
# layer of a type has the same shape and the same init, so its share is
# the same up to the spread between layers.
SHARE_LAYERS = 4
# The perturbed share against isotropic_share(cfg). A bound of 0.5 cannot
# hold at full width, where noise of one relative size is 0.625
# rotational by the shapes alone (it holds at the reduced shapes, 0.454,
# which the CPU test asserts).
ISO_SHARE_TOL = 2e-2
SHARE_MARGIN = 0.15          # rotated share over perturbed (fig3's margin)
PURE_ROT_TOL = 1e-4          # non-rotational part of R @ W (f32 product)
NUC_REL_TOL = 1e-9           # the m x m reduction against the n x n product
# One eval_quality batch through the kernels against the plain versions.
# The fake-quant kernels are bitwise; flash rounds P in another order and
# moves about half the logits by a bf16 ulp, which per-token
# dynamic fake-quant carries on. Phase 5's 2-step teacher is near uniform
# over 151936 entries, so its top-1 sits at near ties: the agreement
# moved by 0.6% and 1.5% of the batch's scored tokens in two runs.
EVAL_LOSS_RTOL = 1e-3
EVAL_KL_RTOL = 5e-2
EVAL_AGREE_ATOL = 5e-2       # share of the batch's scored tokens


def ptq_counters(P):
    return (P["fq_ops"].fake_quant_fwd, P["fa_ops"].flash_attn_fwd)


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _logits_gap(torch, a, b):
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()))


def ptq_eval_vs_plain(torch, P, cfg, teacher, student, report):
    """One eval_quality batch of the student through the kernels and
    through their plain versions (launches not counted), and the launches
    of one student forward read from the device records."""
    C = P["bench"]
    counts = [fn.launches for fn in ptq_counters(P)]
    pol = PTQ_POLICIES[0]
    kern = C.eval_quality(cfg, student, teacher, pol, n_batches=1)
    plain = C.eval_quality(cfg, student, teacher, pol, n_batches=1,
                           kernel_backend="ref")
    it = P["MixtureIterator"](C.data_cfg(cfg, seed=777),
                              start_step=50_000_000)
    batch = P["to_device"](next(it), teacher["embed"]["w"].device)
    ctx = P["qat"].make_ctx(pol)
    with torch.no_grad():
        P["models"].forward(cfg, student, ctx, batch)
        torch.cuda.synchronize()
        names = device_kernel_names(
            torch, teacher["embed"]["w"].device,
            lambda: P["models"].forward(cfg, student, ctx, batch),
            "one student forward")
    for fn, c in zip(ptq_counters(P), counts):
        fn.launches = c
    recorded = {"fq_fwd_kernel": sum("fq_fwd_kernel" in n for n in names),
                "flash_attn_fwd_kernel": sum("flash_attn_fwd_kernel" in n
                                             for n in names)}
    out = {"kernels": kern, "plain": plain,
           "loss_rel_err": abs(kern["ntp_loss"] - plain["ntp_loss"])
           / abs(plain["ntp_loss"]),
           "kl_rel_err": abs(kern["teacher_kl"] - plain["teacher_kl"])
           / abs(plain["teacher_kl"]),
           "agree_err": abs(kern["teacher_agreement"]
                            - plain["teacher_agreement"]),
           "student_forward_device_records": recorded}
    report["ptq_eval_vs_plain"] = out
    n_w = 7 * cfg.n_layers + 1
    check(recorded == {"fq_fwd_kernel": n_w,
                       "flash_attn_fwd_kernel": cfg.n_layers},
          f"one student forward recorded {recorded} kernels, want "
          f"{n_w} fq_fwd_kernel and {cfg.n_layers} flash_attn_fwd_kernel")
    check(out["loss_rel_err"] <= EVAL_LOSS_RTOL
          and out["kl_rel_err"] <= EVAL_KL_RTOL
          and out["agree_err"] <= EVAL_AGREE_ATOL,
          f"an eval_quality batch through the kernels vs plain: {out}")
    print("phase 7: one eval_quality batch, kernels vs plain versions: "
          + json.dumps(out), flush=True)


def isotropic_share(cfg):
    """A check helper, the prediction phase 7 holds a perturbed tree's
    rotational share to: the share (rotational over total, summed over
    ``rotation_report``'s layer types) of a small isotropic perturbation
    of every weight by one relative size, from the shapes alone.

    A rotation on the m side of an (m, n) weight reaches the tangent
    directions ``K A`` (K skew): a share ``(m - 1) / 2n`` of a random
    perturbation's energy where m <= n, ``1 - (n + 1) / 2m`` where m > n.
    The better side leaves ``sqrt(1 - f)`` of its norm non-rotational, so
    a layer type's share is ``1 - sqrt(1 - f)``. A wide weight absorbs most
    of such noise on its long side: the share grows with d_ff / d_model
    (0.625 at qwen2.5-3b's full width, where it is 5.4)."""
    def reach(m, n):
        return (m - 1) / (2 * n) if m <= n else 1 - (n + 1) / (2 * m)

    d = cfg.d_model
    shapes = ((d, cfg.q_dim), (d, cfg.kv_dim), (d, cfg.d_ff), (d, cfg.d_ff),
              (cfg.d_ff, d))                # wq, wk, wg, wu, wd
    shares = [1 - (1 - max(reach(m, n), reach(n, m))) ** 0.5
              for m, n in shapes]
    return sum(shares) / len(shares)


def first_layers(cfg, tree, n):
    """The config and tree of a model's first ``n`` layers (the tensors
    are shared)."""
    return cfg.replace(n_layers=n), {**tree, "layers": tree["layers"][:n]}


def ptq_function_checks(torch, P, cfg, teacher, report, times):
    """The fold (on the teacher) and the residual rotation (on a fresh
    init_params tree: its final norm is uniform, so the tied-head rotation
    is exact) keep the function at 36 layers, mode off; the Fig. 3
    mechanism on the teacher's first ``SHARE_LAYERS`` layers and the
    Procrustes reduction on full-width weights."""
    C, rot, sq = P["bench"], P["rotation"], P["smoothquant"]
    dev = teacher["embed"]["w"].device
    off = P["qat"].make_ctx("A16-C16-W16", mode="off")
    it = P["MixtureIterator"](C.data_cfg(cfg, seed=777),
                              start_step=50_000_000)
    batch = P["to_device"]({"tokens": next(it)["tokens"]}, dev)
    cb = P["calibration_batches"](C.data_cfg(cfg), PTQ_CALIB_BATCHES)
    f32_ref = P["qat"].make_ctx("A16-C16-W16", mode="off",
                                kernel_backend="ref")

    def roundoff(tree, l0):
        t32 = P["tree_map"](lambda t: t.float(), tree)
        l32 = P["models"].forward(cfg, t32, f32_ref, batch)[0]
        del t32
        torch.cuda.empty_cache()
        return _logits_gap(torch, l0, l32)

    out = {}
    gen = torch.Generator(device=dev).manual_seed(ROT_SEED)
    with torch.no_grad():
        l0 = P["models"].forward(cfg, teacher, off, batch)[0]
        out["teacher_bf16_roundoff"] = roundoff(teacher, l0)
        folded, times["fold_smoothing_s"] = _timed(
            torch, lambda: sq.fold_smoothing(cfg, teacher, FOLD_ALPHA, cb))
        l1 = P["models"].forward(cfg, folded, off, batch)[0]
        out["fold_logits_rel_l2"] = _logits_gap(torch, l1, l0)
        del folded, l0, l1
        torch.cuda.empty_cache()
        fresh = P["models"].init_params(cfg, seed=1, device=dev)
        l0 = P["models"].forward(cfg, fresh, off, batch)[0]
        out["fresh_bf16_roundoff"] = roundoff(fresh, l0)
        rotated, times["rotate_residual_s"] = _timed(
            torch, lambda: rot.rotate_residual(cfg, fresh, gen))
        l1 = P["models"].forward(cfg, rotated, off, batch)[0]
        out["rotation_logits_rel_l2"] = _logits_gap(torch, l1, l0)
        del fresh, rotated, l0, l1
        torch.cuda.empty_cache()
    # the shares: the teacher against its rotation and against itself
    # perturbed by 0.05 std, on its first layers
    scfg, steacher = first_layers(cfg, teacher, SHARE_LAYERS)
    with torch.no_grad():
        srot = rot.rotate_residual(scfg, steacher, gen)
    report_rot, times["rotation_report_s"] = _timed(
        torch, lambda: rot.rotation_report(scfg, steacher, srot))
    del srot
    noise = torch.Generator(device=dev).manual_seed(ROT_SEED + 1)
    with torch.no_grad():
        perturbed = {"layers": P["tree_map"](
            lambda x: (x + 0.05 * torch.std(x.float()) * torch.randn(
                x.shape, generator=noise, device=dev)).to(x.dtype)
            if x.dim() >= 2 else x, steacher["layers"])}
    report_pert, times["rotation_report_perturbed_s"] = _timed(
        torch, lambda: rot.rotation_report(scfg, steacher, perturbed))
    out["share_layers"] = SHARE_LAYERS
    out["rotated_share"] = rot.rotational_share(report_rot)
    out["perturbed_share"] = rot.rotational_share(report_pert)
    out["isotropic_share"] = isotropic_share(cfg)
    out["rotated_report"] = report_rot
    out["perturbed_report"] = report_pert
    # a pure rotation of one full-width wg, and the m x m reduction
    # against the n x n product on one full-width wd
    w = teacher["layers"][0]["mlp"]["wg"]["w"].float()          # (d, d_ff)
    R = rot.random_rotation(cfg.d_model, gen)
    pure = rot.procrustes_distances(w, R @ w)
    out["pure_rotation"] = pure
    A = teacher["layers"][0]["mlp"]["wd"]["w"].double()         # (d_ff, d)
    B = perturbed["layers"][0]["mlp"]["wd"]["w"].double()
    (reduced, direct), times["procrustes_wd_direct_s"] = _timed(
        torch, lambda: (rot._nuclear_of_product(B, A),
                        torch.linalg.svdvals(
                            B @ A.T, driver="gesvd" if B.is_cuda else None
                        ).sum()))
    out["wd_nuclear_reduced"] = float(reduced)
    out["wd_nuclear_direct"] = float(direct)
    out["wd_nuclear_rel_err"] = abs(float(reduced) - float(direct)) / abs(
        float(direct))
    del perturbed, w, R, A, B
    torch.cuda.empty_cache()
    report["ptq_function"] = out
    fold_tol = ROUNDOFF_MULT * out["teacher_bf16_roundoff"]
    rot_tol = ROUNDOFF_MULT * out["fresh_bf16_roundoff"]
    check(out["fold_logits_rel_l2"] <= fold_tol,
          f"fold_smoothing moved the logits by relative L2 "
          f"{out['fold_logits_rel_l2']} > {fold_tol}")
    check(out["rotation_logits_rel_l2"] <= rot_tol,
          f"rotate_residual moved the logits by relative L2 "
          f"{out['rotation_logits_rel_l2']} > {rot_tol}")
    check(out["rotated_share"] > 0.8
          and out["rotated_share"] - out["perturbed_share"] > SHARE_MARGIN
          and abs(out["perturbed_share"] - out["isotropic_share"])
          <= ISO_SHARE_TOL,
          f"rotational share {out['rotated_share']} rotated (want > 0.8), "
          f"{out['perturbed_share']} perturbed (want within "
          f"{ISO_SHARE_TOL} of the isotropic {out['isotropic_share']} and "
          f"{SHARE_MARGIN} below the rotated)")
    check(pure["non_rotational"] < PURE_ROT_TOL and pure["rotational"] > 0.1,
          f"a pure rotation of wg: {pure}")
    check(out["wd_nuclear_rel_err"] <= NUC_REL_TOL,
          f"Procrustes on wd: m x m reduction {float(reduced)} vs n x n "
          f"{float(direct)}")
    print("phase 7: fold, rotation and Procrustes at full width: "
          + json.dumps(out), flush=True)


def ptq_full(torch, P, cfg, dev, teacher, student, report):
    """RTN and SmoothQuant of the QAT phase's teacher under A8d-C8-W4 and
    A8s-C8-W4, eval_quality of the teacher, of each PTQ tree and of the
    QAT phase's student on held-out batches; then the eval batch against
    the plain versions and the function checks."""
    C, rtn, sq = P["bench"], P["rtn"], P["smoothquant"]
    cb = P["calibration_batches"](C.data_cfg(cfg), PTQ_CALIB_BATCHES)
    times, evals = {}, {}
    for fn in ptq_counters(P):
        fn.launches = 0
    evals["fp16"] = C.eval_quality(cfg, teacher, teacher, "A16-C16-W16",
                                   n_batches=PTQ_EVAL_BATCHES)
    for pol in PTQ_POLICIES:
        policy = P["parse_policy"](pol)
        for name, fn in (("RTN", lambda: rtn.rtn_quantize(
                              cfg, teacher, policy, cb)),
                         ("SmoothQuant", lambda: sq.smoothquant_quantize(
                              cfg, teacher, policy, cb, alpha=FOLD_ALPHA))):
            q, times[f"{name}-{pol}_s"] = _timed(torch, fn)
            evals[f"{name}-{pol}"] = C.eval_quality(
                cfg, q, teacher, pol, n_batches=PTQ_EVAL_BATCHES)
            del q
            torch.cuda.empty_cache()
    before = [fn.launches for fn in ptq_counters(P)]
    evals["SiLQ-A8d-C8-W4"], dt = _timed(torch, lambda: C.eval_quality(
        cfg, student, teacher, "A8d-C8-W4", n_batches=PTQ_EVAL_BATCHES))
    times["eval_quality_batch_s"] = dt / PTQ_EVAL_BATCHES
    per_batch = [(fn.launches - b) / PTQ_EVAL_BATCHES
                 for fn, b in zip(ptq_counters(P), before)]
    launches = {"fake_quant_fwd": ptq_counters(P)[0].launches,
                "flash_attn_fwd": ptq_counters(P)[1].launches}
    n_w = 7 * cfg.n_layers + 1
    bad = {k: v for k, e in evals.items() for k, v in
           ((f"{k}/{m}", x) for m, x in e.items()) if not math.isfinite(v)}
    out = {"policies": PTQ_POLICIES, "eval_batches": PTQ_EVAL_BATCHES,
           "calib_batches": PTQ_CALIB_BATCHES, "evals": evals,
           "times": times, "launches": launches,
           "student_eval_batch_launches": per_batch}
    report["ptq"] = out
    check(not bad, f"eval_quality metrics not finite: {bad}")
    check(per_batch == [n_w, 2 * cfg.n_layers],
          f"one student eval_quality batch launched (fake_quant_fwd, "
          f"flash_attn_fwd) {per_batch}, want ({n_w}, {2 * cfg.n_layers}: "
          f"the student's and the teacher's forward)")
    check(all(v > 0 for v in launches.values()),
          f"phase 7 launches {launches}")
    print("phase 7: " + json.dumps(out), flush=True)
    ptq_eval_vs_plain(torch, P, cfg, teacher, student, report)
    ptq_function_checks(torch, P, cfg, teacher, report, times)
    print(f"phase 7: seconds: {json.dumps(times)}", flush=True)
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------
# recurrentgemma-2b: the widened kernels (phase 2), serve (3g), a C16
# decode (3h), QAT (6b) and times (phase 4)
# --------------------------------------------------------------------------

RG = "recurrentgemma-2b"
RG_WINDOW = 2048               # the local layers' window, the ring's rows
RG_LENGTHS = (RG_WINDOW, 0, 1, 1500)     # a full ring, an empty row, ragged
RG_CACHE_LEN = 4096            # the serve phase's cache_len: rings of 2048
RG_WRAP_PROMPT = 2030          # + 32 new tokens: the ring wraps in decode
RG_SERVE_LENS = (RG_WRAP_PROMPT, RG_WRAP_PROMPT, 700, 700, 700, 700, 256,
                 256)          # three lengths: exact-length admission waves
RG_WRAP_STEPS = 24             # decode steps before the wrapped logit check
RG_FLASH_CASES = ((TRAIN_B, TRAIN_T, RG_WINDOW), (3, 333, 0),
                  (1, 2 * RG_WINDOW, RG_WINDOW))
RG_TRAIN_STEPS = 2


def d16_cfg(P, arch):
    """``arch``'s reduced attention shape (head dim 16) at full depth and
    width otherwise: the shape the reduced configs give the kernels."""
    r = P["get_reduced_config"](arch)
    return replace(P["get_config"](arch), n_heads=r.n_heads,
                   n_kv_heads=r.n_kv_heads, head_dim=r.head_dim,
                   d_model=r.d_model)


def to_c16(torch, args):
    """Dense decode arguments with the int8 K/V dequantized to a bf16
    cache and unit scales: what a C16 policy stores."""
    q, k, v, s_k, s_v, lens = args
    kb = (k.float() * s_k[..., None]).to(torch.bfloat16)
    vb = (v.float() * s_v[..., None]).to(torch.bfloat16)
    return q, kb, vb, torch.ones_like(s_k), torch.ones_like(s_v), lens


def check_decode_case(torch, P, gen, cfg, dev, lengths, S, c16, what):
    """The dense decode kernel within one bf16 ulp of its plain version,
    an empty row exactly zero, bitwise equal to the paged decode kernel on
    the same K/V scattered into a pool, each row bitwise alone; verify's
    queries (C 5) within one ulp of plain and each bitwise equal to paged
    decode at its length; the gather bitwise. Returns the worst errors
    {kernel: max abs err}."""
    ops, ref = P["kvq_ops"], P["kvq_ref"]
    rtol, atol = KVQ_TOL
    args = kvq_inputs(torch, gen, cfg, lengths, dev, S)
    if c16:
        args = to_c16(torch, args)
    got = ops.kvq_decode_attn(*args)
    want = P["kvq_decode_attn_ref"](*args)
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got.float()).all())
          and torch.allclose(got.float(), want.float(), rtol=rtol,
                             atol=atol),
          f"{what}: kvq_decode_attn differs from its plain version by "
          f"{err} (rtol {rtol}, atol {atol})")
    for i, n in enumerate(lengths):
        if n == 0:
            check(bool((got[i] == 0).all()), f"{what}: an empty row")
    pa = dense_to_pool(torch, gen, args, PAGED_BS[0])
    paged = ops.kvq_paged_decode_attn(*pa)
    check(torch.equal(got, paged), f"{what}: kvq_decode_attn is not bitwise "
                                   f"kvq_paged_decode_attn on the same K/V")
    for i in range(len(lengths)):
        one = ops.kvq_decode_attn(*(a[i:i + 1] for a in args))
        check(torch.equal(got[i:i + 1], one),
              f"{what}: row {i} differs alone and in the batch")
    q, kp, vp, skp, svp, tbl, lens = pa
    C = SPEC_C
    qv = torch.randn((len(lengths), C) + tuple(q.shape[1:]), generator=gen,
                     device=dev).to(torch.bfloat16)
    lv = torch.clamp_min(lens[:, None] - torch.arange(
        C - 1, -1, -1, device=dev)[None], 0).to(torch.int32).contiguous()
    ver = ops.kvq_spec_verify_attn(qv, kp, vp, skp, svp, tbl, lv)
    vref = ref.kvq_spec_verify_attn_ref(qv, kp, vp, skp, svp, tbl, lv)
    v_err = float((ver.float() - vref.float()).abs().max())
    check(torch.allclose(ver.float(), vref.float(), rtol=rtol, atol=atol),
          f"{what}: kvq_spec_verify_attn differs from its plain version by "
          f"{v_err}")
    for c in range(C):
        one = ops.kvq_paged_decode_attn(qv[:, c].contiguous(), kp, vp, skp,
                                        svp, tbl, lv[:, c].contiguous())
        check(torch.equal(ver[:, c], one),
              f"{what}: verify query {c} is not bitwise paged decode")
    g = ops.gather_dequant_paged_kv(kp, skp, tbl)
    gk, gv = ops.gather_dequant_paged_kv_pair(kp, skp, vp, svp, tbl)
    check(torch.equal(g, ref.gather_dequant_paged_kv_ref(kp, skp, tbl))
          and torch.equal(gk, g)
          and torch.equal(gv, ref.gather_dequant_paged_kv_ref(vp, svp, tbl)),
          f"{what}: gather_dequant_paged_kv is not bitwise its plain "
          f"version")
    torch.cuda.synchronize()
    return {"kvq_decode_attn": err, "kvq_paged_decode_attn": err,
            "kvq_spec_verify_attn": v_err, "gather_dequant_paged_kv": 0.0}


def check_flash_case(torch, P, gen, cfg, dev, B, S, window, Skv=None,
                     causal=True):
    """flash_attn_fwd against its plain version and the f64 oracle, held
    as ``check_flash`` holds it; not ``causal``: S queries over ``Skv``
    keys."""
    fa, ref = P["fa_ops"].flash_attn_fwd, P["flash_attn_ref"]
    rtol, atol = FLASH_TOL
    q, k, v = flash_inputs(torch, gen, cfg, B, S, dev, Skv=Skv)
    got = fa(q, k, v, causal=causal, window=window).float()
    want = ref(q, k, v, causal=causal, window=window).float()
    oracle = flash_oracle(torch, q, k, v, window, causal)
    err = (got - want).abs()
    beyond = float((err > KVQ_TOL[1] + KVQ_TOL[0] * want.abs()).float()
                   .mean())
    e_k = float((got - oracle).abs().max())
    e_p = float((want - oracle).abs().max())
    case = {"B": B, "S": S, "Skv": Skv or S, "causal": causal,
            "window": window, "D": cfg.resolved_head_dim, "H": cfg.n_heads,
            "Hkv": cfg.n_kv_heads, "max_abs_err": float(err.max()),
            "share_beyond_one_ulp": beyond, "kernel_vs_oracle": e_k,
            "plain_vs_oracle": e_p}
    check(bool(torch.isfinite(got).all())
          and torch.allclose(got, want, rtol=rtol, atol=atol)
          and beyond <= FLASH_ULP_SHARE and e_k <= FLASH_ORACLE_RATIO * e_p,
          f"flash_attn_fwd differs from its plain version: {case}")
    return case


def check_rg_kernels(torch, P, cfg, rcfg, dev, report):
    """Phase 2 at the new shapes: the split-KV kernels at recurrentgemma's
    D 256, G 10 (a full 2048-token ring, an empty row, ragged) and at the
    reduced configs' D 16, in int8 and bf16 (C16) caches; the same in bf16
    at qwen2.5-3b's D 128, G 8; flash at D 256, H 10, Hkv 1 (the QAT
    shape with the 2048 window, a ragged S, 4096 tokens under the window)
    and at D 16. Returns the worst error per kernel."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    worst = {}
    cases = []
    d16 = d16_cfg(P, RG)
    for shape_cfg, lengths, S, name in (
            (rcfg, RG_LENGTHS, RG_WINDOW, "D256 G10"),
            (rcfg, split_lengths(P), max(split_lengths(P)), "D256 G10 "
             "split boundaries"),
            (d16, RG_LENGTHS, RG_WINDOW, "D16 G4"),
            (cfg, KVQ_LENGTHS, CACHE_LEN, "D128 G8")):
        for c16 in (False, True):
            if shape_cfg is cfg and not c16:
                continue            # qwen's int8 cases: phase 2 above
            what = f"{name} {'bf16' if c16 else 'int8'}"
            errs = check_decode_case(torch, P, gen, shape_cfg, dev, lengths,
                                     S, c16, what)
            cases.append({"case": what, "lengths": list(lengths), "S": S,
                          **errs})
            for k, e in errs.items():
                worst[k] = max(worst.get(k, 0.0), e)
            torch.cuda.empty_cache()
    flash = []
    for B, S, window in RG_FLASH_CASES:
        flash.append(check_flash_case(torch, P, gen, rcfg, dev, B, S,
                                      window))
        torch.cuda.empty_cache()
    for arch in ("qwen2.5-3b", RG):
        shape = d16_cfg(P, arch)
        for B, S, window in ((TRAIN_B, TRAIN_T, 0), (3, 333, 16)):
            flash.append(check_flash_case(torch, P, gen, shape, dev, B, S,
                                          window))
    worst["flash_attn_fwd"] = max(c["max_abs_err"] for c in flash)
    report["rg_kernel_cases"] = cases
    report["rg_flash_cases"] = flash
    print(f"phase 2: at D 256 G 10, D 16 and on bf16 caches (and bf16 at "
          f"D 128 G 8): kvq_decode_attn within one bf16 ulp of plain and "
          f"bitwise kvq_paged_decode_attn, verify queries bitwise paged "
          f"decode, the gather bitwise: {cases}; flash: {flash}",
          flush=True)
    return worst


def rg_gap_location(torch, P, rcfg, eng, tok, cache):
    """Where phase 3g's wrapped-ring logits gap (kernels against plain)
    comes from, on one decode step from the same wrapped cache: each
    layer's residual output of the kernels' step against the plain
    step's (relative L2); each local layer's decode attention (the ring
    read, D 256, G 10), kernel against its plain version on the kernels'
    step's own inputs (max abs error, its share of outputs beyond one
    bf16 ulp of plain, relative L2); and the logits' gap with only the
    attention kernel (w4a8 plain) and with only the w4a8 kernels
    (attention plain). The RG-LRU's gates, scan and state requantization
    run the same torch ops on both paths (no kernel)."""
    import repro_torch.kernels.w4a8.ops as W
    import repro_torch.models.blocks as B
    import repro_torch.models.model as M
    models = P["models"]
    plain_ctx = replace(eng.ctx, kernel_backend="ref")
    attn_err = []

    def step(attn="auto", w4a8="auto", probe=False):
        outs = []
        block, dattn, mm = M._block_decode, B._decode_attn, W.w4a8_matmul

        def rec_block(*a, **k):
            y = block(*a, **k)
            outs.append(y.float())
            return y

        def one_attn(c, q, k_q, v_q, s_k, s_v, lengths):
            y = dattn(c if attn == "auto" else plain_ctx, q, k_q, v_q, s_k,
                      s_v, lengths)
            if probe:
                want = B.decode_attention_intcache(q, k_q, v_q, s_k, s_v,
                                                   lengths).float()
                d = (y.float() - want).abs()
                ulp = torch.clamp_min(want.abs(), 2.0 ** -126) * 2.0 ** -7
                attn_err.append({
                    "max_abs": float(d.max()),
                    "beyond_one_ulp": float((d > ulp).float().mean()),
                    "rel_l2": float(torch.linalg.vector_norm(d)
                                    / torch.linalg.vector_norm(want))})
            return y
        M._block_decode, B._decode_attn = rec_block, one_attn
        if w4a8 == "ref":
            W.w4a8_matmul = (lambda x_q, w_p, s_x, s_w, b=None,
                             out_dtype=torch.bfloat16:
                             W.w4a8_matmul_ref(x_q, w_p, s_x, s_w, b,
                                               out_dtype))
        try:
            logits, _ = models.decode_step(rcfg, eng.params, eng.ctx, tok,
                                           models.clone_cache(cache))
        finally:
            M._block_decode, B._decode_attn, W.w4a8_matmul = block, dattn, mm
        return logits.float(), outs

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    lk, ok = step(probe=True)
    lp, op = step(attn="ref", w4a8="ref")
    la, _ = step(w4a8="ref")
    lw, _ = step(attn="ref")
    kinds = rcfg.layer_kinds()
    layers = [{"layer": i, "kind": k, "rel_l2": rel(a, b)}
              for i, (k, a, b) in enumerate(zip(kinds, ok, op))]
    return {"logits_rel_l2": rel(lk, lp),
            "logits_rel_l2_attention_kernel_only": rel(la, lp),
            "logits_rel_l2_w4a8_kernels_only": rel(lw, lp),
            "residual_rel_l2_by_layer": layers,
            "attention_vs_plain_by_local_layer": attn_err}


def serve_rg(torch, P, rcfg, dev, report):
    """Phase 3g: recurrentgemma-2b at full width and depth (26 layers,
    random weights from a seed) on ``ServeEngine``: A8d-C8-W4, w4a8
    weights, dense layout, 4 slots, cache_len 4096 (the local layers'
    rings hold the 2048-token window). First one decode step's logits
    after the rings wrapped, kernels against plain; then 8 requests of
    three lengths in exact-length waves, two of 2030 tokens whose rings
    wrap while they
    decode. kvq_decode_attn launches 8 times a decode step (one a local
    layer), w4a8_matmul launches, no other attention kernel does."""
    import numpy as np
    qat, models = P["qat"], P["models"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = models.init_params(rcfg, seed=0, device=dev)
    eng = P["ServeEngine"](rcfg, params, policy="A8d-C8-W4", slots=SLOTS,
                           cache_len=RG_CACHE_LEN, max_new_cap=MAX_NEW,
                           decode_block=8, weights_layout="w4a8", device=dev)
    del params
    eng.params = qat.drop_exported_weights(eng.params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_local = rcfg.layer_kinds().count("local_attn")
    ring = [c["k_q"].shape[2] for c, k in zip(
        eng.state["cache"]["layers"], rcfg.layer_kinds())
        if k == "local_attn"]
    check(ring == [RG_WINDOW] * n_local,
          f"recurrentgemma: local rings of {ring} rows, want {RG_WINDOW}")

    # the wrapped ring: 2 prompts of 2040 tokens, 24 decode steps through
    # the kernels, then one step kernels vs plain from the same cache
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(
        0, rcfg.vocab_size, (2, RG_WINDOW - 8)).astype(np.int32)).to(dev)
    logits, cache = models.prefill(rcfg, eng.params, eng.ctx,
                                   {"tokens": toks},
                                   cache_budget=RG_CACHE_LEN)
    tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
    for _ in range(RG_WRAP_STEPS):
        logits, cache = models.decode_step(rcfg, eng.params, eng.ctx, tok,
                                           cache)
        tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
    length = int(cache["layers"][2]["length"][0])
    check(length > RG_WINDOW, f"the ring did not wrap: length {length}")
    lk, _ = models.decode_step(rcfg, eng.params, eng.ctx, tok,
                               models.clone_cache(cache))
    lp, _ = models.decode_step(rcfg, eng.params,
                               replace(eng.ctx, kernel_backend="ref"), tok,
                               models.clone_cache(cache))
    lk, lp = lk.float(), lp.float()
    check(bool(torch.isfinite(lk).all()), "recurrentgemma logits not finite")
    rel = float(torch.linalg.vector_norm(lk - lp)
                / torch.linalg.vector_norm(lp))
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    check(rel <= LOGIT_REL_TOL,
          f"recurrentgemma: decode logits after the wrap, kernels vs plain, "
          f"relative L2 {rel} > {LOGIT_REL_TOL}")
    gap = rg_gap_location(torch, P, rcfg, eng, tok, cache)
    check(gap["logits_rel_l2_w4a8_kernels_only"] == 0.0,
          f"recurrentgemma: the w4a8 kernels alone move the wrapped "
          f"logits from plain: {gap}")
    print("phase 3g: the wrapped-ring logits gap by op and layer "
          + json.dumps(gap), flush=True)
    del cache, logits, lk, lp
    torch.cuda.empty_cache()

    prompts = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32)
               for n in RG_SERVE_LENS]
    reqs = [P["Request"](uid=i, prompt=p, max_new_tokens=MAX_NEW,
                         temperature=0.8 if i % 4 == 3 else 0.0,
                         top_k=8 if i % 4 == 3 else 0, seed=i)
            for i, p in enumerate(prompts)]
    counted = {**counted_kernels(P),
               "flash_attn_fwd": P["fa_ops"].flash_attn_fwd,
               "slstm_scan": P["slstm_ops"].slstm_scan}
    for r in reqs:
        eng.submit(r)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counted.items()}
    check_streams(rcfg, reqs, "recurrentgemma serve")
    check(launches["w4a8_matmul"] > 0,
          f"recurrentgemma serve: w4a8_matmul never launched: {launches}")
    check(launches["kvq_decode_attn"] == n_local * stats["decode_steps"],
          f"recurrentgemma serve: {launches['kvq_decode_attn']} "
          f"kvq_decode_attn launches over {stats['decode_steps']} decode "
          f"steps, want {n_local} a step")
    others = [n for n in counted if n not in ("w4a8_matmul",
                                              "kvq_decode_attn")]
    check(all(launches[n] == 0 for n in others),
          f"recurrentgemma serve: another kernel ran: {launches}")
    check(stats["prefill_calls"] >= len(set(RG_SERVE_LENS)),
          f"recurrentgemma serve: {stats['prefill_calls']} prefill waves "
          f"for {len(set(RG_SERVE_LENS))} prompt lengths: a wave mixed "
          f"lengths")
    decode_tokens = stats["tokens_out"] - len(reqs)
    served = {"requests": len(reqs), "prompt_lens": list(RG_SERVE_LENS),
              "setup_s": setup_s, "tokens_out": stats["tokens_out"],
              "wall_s": wall, "tokens_per_s": stats["tokens_out"] / wall,
              "decode_tokens_per_s": decode_tokens / stats["decode_s"],
              "decode_step_ms": 1e3 * stats["decode_step_s"],
              "decode_steps": stats["decode_steps"],
              "ttft_p50_s": stats["ttft_p50_s"],
              "ttft_p95_s": stats["ttft_p95_s"],
              "prefill_s": stats["prefill_s"],
              "prefill_calls": stats["prefill_calls"],
              "wrapped_length": length,
              "decode_logits_rel_l2_kernels_vs_plain": rel,
              "decode_logits_argmax_agreement": agree,
              "decode_logits_gap_location": gap,
              "launches": launches,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    report["serve_rg"] = served
    print("serve_rg " + json.dumps(served), flush=True)
    print(f"phase 3g: recurrentgemma-2b dense w4a8 serve, "
          f"{served['decode_tokens_per_s']:.2f} decode tok/s, "
          f"{served['decode_step_ms']:.2f} ms a decode step, TTFT p50 "
          f"{served['ttft_p50_s']:.3f} s; logits after the wrap kernels vs "
          f"plain relative L2 {rel:.3g}", flush=True)
    del eng
    torch.cuda.empty_cache()
    return launches


def c16_decode(torch, P, cfg, dev, teacher, report):
    """Phase 3h: one qwen2.5-3b dense decode step under A16-C16-W16 with
    quantization off (a bf16 cache) through kvq_decode_attn against the
    plain version; then Table 2's self-generation (``selfgen_corpus``)
    for one short batch on the card."""
    import numpy as np
    from repro_torch.benchmarks import table2_time_to_quality as t2
    qat, models = P["qat"], P["models"]
    ctx = qat.make_ctx("A16-C16-W16", mode="off")
    rng = np.random.default_rng(12)
    lens = (97, 128, 40, 128)
    toks = torch.zeros((SLOTS, 128), dtype=torch.int32, device=dev)
    for i, n in enumerate(lens):
        toks[i, :n] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, n).astype(np.int32)).to(dev)
    kvq = P["kvq_ops"].kvq_decode_attn
    base = kvq.launches
    with torch.no_grad():
        logits, cache = models.prefill(cfg, teacher, ctx, {
            "tokens": toks, "lengths": torch.tensor(
                lens, dtype=torch.int32, device=dev)},
            cache_budget=CACHE_LEN)
        check(cache["layers"][0]["k_q"].dtype == torch.bfloat16,
              f"A16-C16-W16: cache dtype {cache['layers'][0]['k_q'].dtype}")
        tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
        n0 = kvq.launches
        lk, _ = models.decode_step(cfg, teacher, ctx, tok,
                                   models.clone_cache(cache))
        n_step = kvq.launches - n0
        lp, _ = models.decode_step(cfg, teacher,
                                   replace(ctx, kernel_backend="ref"), tok,
                                   models.clone_cache(cache))
    lk, lp = lk.float(), lp.float()
    rel = float(torch.linalg.vector_norm(lk - lp)
                / torch.linalg.vector_norm(lp))
    check(n_step == cfg.n_layers,
          f"C16 decode step: {n_step} kvq_decode_attn launches, want "
          f"{cfg.n_layers}")
    check(bool(torch.isfinite(lk).all()) and rel <= LOGIT_REL_TOL,
          f"C16 decode step: kernels vs plain relative L2 {rel}")
    del cache, logits, lk, lp
    n0 = kvq.launches
    length = 16
    corpus, secs = t2.selfgen_corpus(cfg, teacher, 8, length)
    n_gen = kvq.launches - n0
    check(tuple(corpus.shape) == (8, length)
          and int(corpus.min()) >= 0 and int(corpus.max()) < cfg.vocab_size,
          f"selfgen_corpus on the card: shape {tuple(corpus.shape)}")
    check(n_gen == cfg.n_layers * (length - 1),
          f"selfgen_corpus: {n_gen} kvq_decode_attn launches, want "
          f"{cfg.n_layers * (length - 1)}")
    kvq.launches = base              # not the main path's launches
    out = {"decode_logits_rel_l2_kernels_vs_plain": rel,
           "kvq_decode_attn_per_step": n_step,
           "selfgen_batch_s": secs, "selfgen_tokens": 8 * length,
           "selfgen_kvq_launches": n_gen}
    report["c16_decode"] = out
    print("phase 3h: " + json.dumps(out), flush=True)


def rg_weight_sites(rcfg):
    """Fake-quantized weights of one student forward: 8 per RG-LRU layer
    (w_in, w_gate, w_ig, w_rg, w_out and the MLP's 3), 7 per local
    attention layer (wq, wk, wv, wo and the MLP's 3) and the tied head."""
    kinds = rcfg.layer_kinds()
    return 8 * kinds.count("rglru") + 7 * kinds.count("local_attn") + 1


def train_rg(torch, P, rcfg, dev, report):
    """Phase 6b: run_qat on recurrentgemma-2b at full width and depth,
    A8d-C8-W4, 2 teacher steps, MSE weight calibration, 2 steps at B 8,
    T 128. Per step one fake_quant_fwd and one _bwd per student weight
    site (201) and one flash_attn_fwd per local layer (8, the teacher's);
    losses finite, every s_w moved, no NaN."""
    tcfg = P["TrainConfig"](precision="A8d-C8-W4", total_steps=RG_TRAIN_STEPS,
                            ref_steps=RG_TRAIN_STEPS, batch_size=TRAIN_B,
                            seq_len=TRAIN_T)
    steps, state = [], {}

    def on_start(student, opt):
        state["s_w0"] = {k: t.detach().clone() for k, t in
                         _named_leaves(student) if k.endswith("s_w")}
        state["counts"] = tuple(fn.launches for fn in train_counters(P))

    def on_step(step, metrics, student, opt):
        counts = tuple(fn.launches for fn in train_counters(P))
        steps.append({"step": step, "loss": float(metrics["loss"]),
                      "ms": metrics["ms"],
                      "launches": [a - b for a, b in
                                   zip(counts, state["counts"])]})
        state["counts"] = counts
        state["opt"] = opt

    for fn in train_counters(P):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    teacher, student, _ = P["train"].run_qat(
        RG, tcfg, reduced=False, teacher_steps=2, device=dev, log_every=1,
        split_times=True, on_start=on_start, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    names = ("fake_quant_fwd", "fake_quant_bwd", "flash_attn_fwd",
             "slstm_scan")
    launches = dict(zip(names, (fn.launches for fn in train_counters(P))))
    peak = torch.cuda.max_memory_allocated(dev)
    n_w = rg_weight_sites(rcfg)
    n_l = rcfg.layer_kinds().count("local_attn")
    for s in steps:
        got = dict(zip(names, s["launches"]))
        check(s["launches"] == [n_w, n_w, n_l, 0],
              f"recurrentgemma QAT step {s['step']}: launches {got}, want "
              f"({n_w}, {n_w}, {n_l}, 0)")
        check(math.isfinite(s["loss"]),
              f"recurrentgemma QAT step {s['step']}: KD loss {s['loss']}")
    check(len(steps) == RG_TRAIN_STEPS,
          f"{len(steps)} recurrentgemma QAT steps")
    opt = state.pop("opt")
    named = dict(_named_leaves(student))
    unmoved = [k for k, t0_ in state["s_w0"].items()
               if torch.equal(named[k], t0_)]
    check(len(state["s_w0"]) == n_w and not unmoved,
          f"recurrentgemma: s_w that did not move: {unmoved[:5]} "
          f"({len(unmoved)} of {len(state['s_w0'])})")
    check(all(bool(torch.isfinite(t).all()) for t in named.values()),
          "recurrentgemma: a parameter is not finite after QAT")
    del opt, state
    torch.cuda.empty_cache()
    per = {k: sum(s["ms"][k] for s in steps[1:]) / (len(steps) - 1)
           for k in ("teacher", "student", "optimizer")}
    step_ms = sum(per.values())
    trained = {"arch": RG, "steps": RG_TRAIN_STEPS, "batch": TRAIN_B,
               "seq": TRAIN_T, "losses": [s["loss"] for s in steps],
               "ms_per_step": step_ms, "ms_split": per,
               "ms_first_step": sum(steps[0]["ms"].values()),
               "tokens_per_s": TRAIN_B * TRAIN_T / (step_ms / 1e3),
               "peak_memory_bytes": peak, "wall_s": wall,
               "launches_per_step": dict(zip(names, steps[-1]["launches"])),
               "weight_sites": n_w, "launches": launches}
    report["train_rg"] = trained
    print("phase 6b: " + json.dumps(trained), flush=True)
    del teacher, student
    torch.cuda.empty_cache()
    return launches


def time_flash_window(torch, P, cfg, dev, gen, B, S, window, plain_calls):
    """One windowed flash launch beside SDPA with an explicit
    causal-and-window mask (``enable_gqa``), its plain version and the
    bound (the window's (query, key) pairs at the bf16 tensor-core rate,
    or the bytes)."""
    import torch.nn.functional as F
    fa, ref = P["fa_ops"].flash_attn_fwd, P["flash_attn_ref"]
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    base = flash_inputs(torch, gen, cfg, B, S, dev)
    sets = [base] + [flash_inputs(torch, gen, cfg, B, S, dev)
                     for _ in range(copies_for(tensor_bytes(*base)) - 1)]
    t_k = time_ms(torch, lambda q, k, v: fa(q, k, v, causal=True,
                                            window=window), sets)
    t_p = time_ms(torch, lambda q, k, v: ref(q, k, v, causal=True,
                                             window=window), sets[:2],
                  min_calls=plain_calls)
    i = torch.arange(S, device=dev)
    mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    lib = [tuple(t.transpose(1, 2) for t in s) for s in sets]
    t_l = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True), lib)
    pairs = int(mask.sum())
    flops = 4 * B * H * D * pairs
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * Hkv * D)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_PEAK_FLOPS
    del sets, lib
    torch.cuda.empty_cache()
    return {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
            "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "B": B, "S": S, "window": window}


def rg_pool_inputs(torch, gen, rcfg, dev, c16, C=0):
    """recurrentgemma's 4 full 2048-token rings in a paged pool (bs 64, a
    shuffled table), int8 or bf16 (``c16``); with ``C`` the verify-wave's
    C queries a slot, windows ending at the full ring."""
    args = kvq_inputs(torch, gen, rcfg, (RG_WINDOW,) * SLOTS, dev,
                      RG_WINDOW)
    if c16:
        args = to_c16(torch, args)
    q, k, v, s_k, s_v, tbl, lens = dense_to_pool(torch, gen, args,
                                                 PAGED_BS[0])
    if C:
        q = torch.randn((SLOTS, C) + tuple(q.shape[1:]), generator=gen,
                        device=dev).to(torch.bfloat16)
        lens = (lens[:, None] - torch.arange(C - 1, -1, -1, device=dev)
                [None]).to(torch.int32).contiguous()
    return q, k, v, s_k, s_v, tbl, lens


def time_rg_gather(torch, P, gen, rcfg, dev, c16):
    """One K+V gather launch of the 4 rings' 32 table entries at D 256,
    beside its plain version, indexing and the bound (bytes)."""
    ops, ref = P["kvq_ops"], P["kvq_ref"].gather_dequant_paged_kv_ref

    def make():
        q, k, v, s_k, s_v, tbl, lens = rg_pool_inputs(torch, gen, rcfg, dev,
                                                      c16)
        return k, s_k, v, s_v, tbl

    base = make()
    n, T = base[4].shape
    bs, D = base[0].shape[2], base[0].shape[3]
    rows = n * rcfg.n_kv_heads * T * bs
    out_bytes = 2 * 4 * rows * D
    sets = [base] + [make() for _ in range(
        copies_for(tensor_bytes(*base) + out_bytes) - 1)]
    t_k = time_ms(torch, ops.gather_dequant_paged_kv_pair, sets)
    t_p = time_ms(torch, lambda k, s_k, v, s_v, tbl:
                  (ref(k, s_k, tbl), ref(v, s_v, tbl)), sets)
    nb = base[0].shape[0] - 1

    def library(k, s_k, v, s_v, tbl):
        idx = tbl.long().clamp(0, nb - 1)
        return (k[idx].float() * s_k[idx][..., None],
                v[idx].float() * s_v[idx][..., None])

    t_l = time_ms(torch, library, sets)
    es = base[0].element_size()
    nbytes = 2 * rows * (D * es + 4) + 4 * n * T + out_bytes
    del sets
    torch.cuda.empty_cache()
    return {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "n_T_bs": [n, T, bs]}


def time_rg(torch, P, rcfg, dev, report):
    """Phase 4 at recurrentgemma's shapes: a decode step's 8 dense decode
    launches at B 4 over full 2048-token rings (D 256, H 10, Hkv 1) in
    int8 and in bf16, beside plain, SDPA (``enable_gqa``, the same cache
    dequantized to bf16) and the bound; a teacher forward's 8 flash
    launches at (B 8, T 128) beside SDPA, and one windowed launch (B 1,
    S 4096, window 2048) beside SDPA with the mask."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    n_local = rcfg.layer_kinds().count("local_attn")
    lengths = (RG_WINDOW,) * SLOTS
    dec = time_dense_launch(torch, P, rcfg, dev, gen, lengths, RG_WINDOW,
                            False)
    dec16 = time_dense_launch(torch, P, rcfg, dev, gen, lengths, RG_WINDOW,
                              False, c16=True)
    fl = time_flash_launch(torch, P, rcfg, dev, gen, TRAIN_B, TRAIN_T, 10)
    flw = time_flash_window(torch, P, rcfg, dev, gen, 1, 2 * RG_WINDOW,
                            RG_WINDOW, 4)
    out = {"decode_step": per_step(dec, n_local), "decode_launch": dec,
           "decode_step_bf16": per_step(dec16, n_local),
           "decode_launch_bf16": dec16,
           "flash_teacher_forward": per_step(fl, n_local),
           "flash_launch": fl, "flash_window_launch": flw}
    # the paged launchers and the gather at the same shapes (served
    # recurrentgemma stays dense: these time the kernels' new D, G, dtype)
    for c16 in (False, True):
        tag = "_bf16" if c16 else ""
        for name, C in (("paged_decode", 0), ("spec_verify", SPEC_C)):
            def make(c16=c16, C=C):
                return rg_pool_inputs(torch, gen, rcfg, dev, c16, C)
            out[f"{name}_launch{tag}"] = time_paged_launch(
                torch, P, rcfg, name, make(), make)
        out[f"gather_launch{tag}"] = time_rg_gather(torch, P, gen, rcfg,
                                                    dev, c16)
    report["rg_times"] = out
    print(f"phase 4: recurrentgemma kvq_decode_attn per launch (B 4, Sc "
          f"2048, D 256, G 10): int8 {dec['ms'] * 1e3:.2f} us, bf16 "
          f"{dec16['ms'] * 1e3:.2f} us, plain {dec['plain_ms'] * 1e3:.2f} "
          f"us, SDPA {dec['library_ms'] * 1e3:.2f} us, bound "
          f"{dec['bound_ms'] * 1e3:.2f} us; flash per launch at (8, 128): "
          f"{fl['ms'] * 1e3:.2f} us (SDPA {fl['library_ms'] * 1e3:.2f}, "
          f"bound {fl['bound_ms'] * 1e3:.2f}); windowed (1, 4096, 2048): "
          f"{flw['ms'] * 1e3:.2f} us (SDPA with the mask "
          f"{flw['library_ms'] * 1e3:.2f}, bound "
          f"{flw['bound_ms'] * 1e3:.2f})", flush=True)
    for key in ("paged_decode_launch", "spec_verify_launch",
                "gather_launch"):
        a, b = out[key], out[key + "_bf16"]
        print(f"phase 4: recurrentgemma {key}: int8 {a['ms'] * 1e3:.2f} us "
              f"(plain {a['plain_ms'] * 1e3:.2f}, library "
              f"{a['library_ms'] * 1e3:.2f}, bound "
              f"{a['bound_ms'] * 1e3:.3f}), bf16 {b['ms'] * 1e3:.2f} us "
              f"(bound {b['bound_ms'] * 1e3:.3f})", flush=True)
    return out

# --------------------------------------------------------------------------
# mixtral-8x7b: phase 2 at its shapes, 3i serve, 6c QAT, 4 times
# --------------------------------------------------------------------------

MX = "mixtral-8x7b"
# depth cuts (full width): the 32 layers hold 46.7 B parameters, ~93 GB in
# bf16, and neither package packs the expert banks (2.82 GB a layer), so
# serving keeps 16 layers (~47 GB of weights, 54.8 GB peak on the H100);
# QAT holds ~17 B a parameter (weights, teacher, AdamW, gradients: 53.9 GB
# peak for the 3.16 B of 2 layers with the embedding and head), so 3
# layers (4.6 B) would not fit the card's 80 GB
MX_SERVE_LAYERS = 16
MX_TRAIN_LAYERS = 2
MX_WINDOW = 4096               # sliding_window: the global layers' rings
MX_CACHE_LEN = 2 * MX_WINDOW   # the serve phase's cache_len: rings of 4096
MX_WRAP_PROMPT = 4090          # + 12 decode steps: the rings wrap
MX_WRAP_ROWS = 4
MX_WRAP_STEPS = 12
MX_SERVE_LENS = (4080, 4080, 1500, 1500, 1500, 1500, 300, 300)
MX_ROW_LENS = (601, 1024, 880, 197)   # the prompt under test first; the
#                                        wave fills one MoE chunk (1024)
MX_LENGTHS = (MX_WINDOW, 0, 1, 3000)  # a full ring, an empty row, ragged
MX_W4A8_MS = (1, SLOTS, 23, 24, PREFILL_M)
MX_BANKS = ((8, 4096, 14336), (8, 14336, 4096))   # wg / wu, wd
# (e, R, C, offset): ragged against the backward's bands of rows and
# strips of 256 bf16 columns, C not a multiple of 8, and an x one element
# into its buffer (not 16-byte aligned: the one-element path)
MX_FQ_RAGGED = ((3, 100, 70, 0), (2, 33, 8, 0), (3, 65, 264, 0),
                (2, 40, 256, 1))
MX_FLASH_LONG = (1, 2 * MX_WINDOW)    # S 8192 under the 4096 window
MX_FLASH_ROWS = 1024                  # query rows held to plain at S 8192
MX_TRAIN_STEPS = 2


def mx_cfg(P, n_layers=MX_SERVE_LAYERS):
    return P["get_config"](MX).replace(n_layers=n_layers)


def mx_linear_shapes(mcfg):
    """(name, K, N, launches per decode step) of mixtral's packed linears:
    attention, the router (N 8) and the untied head."""
    d, qd, kvd, L = mcfg.d_model, mcfg.q_dim, mcfg.kv_dim, mcfg.n_layers
    return [("q", d, qd, L), ("k", d, kvd, L), ("v", d, kvd, L),
            ("o", qd, d, L), ("router", d, mcfg.n_experts, L),
            ("head", d, mcfg.vocab_size, 1)]


def bank_inputs(torch, gen, e, R, C, bits, dev, offset=0):
    """An expert bank x (e, R, C) bf16 (~0.02, a weight's scale), its
    scales (e, 1, C) near each column's absmax / qp (some values clip),
    g bf16; ``offset`` starts x that many elements into its buffer."""
    qp = 2 ** (bits - 1) - 1
    x = torch.randn((e, R, C), generator=gen, device=dev).mul_(0.02)
    s = (x.abs().amax(1, keepdim=True) / qp * (
        0.5 + 0.5 * torch.rand((e, 1, C), generator=gen, device=dev)))
    x = x.to(torch.bfloat16)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
        buf[offset:] = x.reshape(-1)
        x = buf[offset:].view(e, R, C)
    g = (torch.randn((e, R, C), generator=gen, device=dev) * 1e-3).to(
        torch.bfloat16)
    return x, s.contiguous(), g


def check_mx_fake_quant(torch, P, dev):
    """Mode 3 on mixtral's banks and the ragged ones (``check_banks``);
    the backward's launcher refuses a mode-3 workspace one element short.
    Returns (cases, worst ds error)."""
    n, worst = check_banks(torch, P, dev, MX_BANKS, MX_FQ_RAGGED, 41)
    gen = torch.Generator(device=dev)
    gen.manual_seed(46)
    for e, R, C in ((3, 100, 70), MX_BANKS[1]):
        x, s, g = bank_inputs(torch, gen, e, R, C, 4, dev)
        workspace_refused(torch, P, x, s, g, (e, R, C), 3, dev)
        del x, s, g
    torch.cuda.empty_cache()
    return n, worst


def check_banks(torch, P, dev, banks, ragged, seed):
    """Mode 3 (an expert bank per (expert, column)): fake_quant_fwd and
    the dx of fake_quant_bwd bitwise equal to the plain versions at bits 4
    and 8 on ``banks`` (e, R, C) and ``ragged`` (e, R, C, offset), ds
    within FQ_DS_TOL of its sums' mass and bitwise from call to call.
    Returns (cases, worst ds error)."""
    ops, ref = P["fq_ops"], P["fq_ref"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    worst, n = 0.0, 0
    for e, R, C, off in [b + (0,) for b in banks] + list(ragged):
        for bits in (4, 8):
            x, s, g = bank_inputs(torch, gen, e, R, C, bits, dev, off)
            what = f"bank ({e}, {R}, {C}) offset {off} bits {bits}"
            check(ops.scale_mode(x, s) == 3, f"{what}: not mode 3")
            got = ops.fake_quant_fwd(x, s, bits)
            want = ref.fake_quant_fwd_ref(x, s, bits)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"fake_quant_fwd {what} differs from its plain version in "
                  f"{int((got != want).sum())} elements")
            del got, want
            dx, ds = ops.fake_quant_bwd(x, s, g, bits)
            _, ds2 = ops.fake_quant_bwd(x, s, g, bits)
            dx_p, ds_p = ops.fake_quant_bwd(x, s, g, bits, plain=True)
            torch.cuda.synchronize()
            check(torch.equal(dx, dx_p),
                  f"fake_quant_bwd {what}: dx differs from its plain "
                  f"version in {int((dx != dx_p).sum())} elements")
            check(torch.equal(ds, ds2),
                  f"fake_quant_bwd {what}: ds differs between two calls")
            mass = fq_ds_mass(torch, P, x, s, g, bits)
            rel = float(((ds - ds_p).abs() / mass.clamp_min(1e-30)).max())
            check(bool(torch.isfinite(ds).all()) and rel <= FQ_DS_TOL,
                  f"fake_quant_bwd {what}: ds off its plain version by "
                  f"{rel} of its sums' mass (> {FQ_DS_TOL})")
            worst = max(worst, rel)
            n += 1
            del x, s, g, dx, ds, ds2, dx_p, ds_p, mass
            torch.cuda.empty_cache()
    return n, worst


def workspace_refused(torch, P, x, s, g, shape, mode, dev):
    """fake_quant_bwd's launcher refuses (cudaErrorInvalidValue, 1) a
    workspace one element shorter than ``fake_quant_bwd_workspace`` asks
    for and writes nothing. Calls the C launcher: no count moves."""
    ops = P["fq_ops"]
    E, R, C = shape
    need = ops._fn("fake_quant_bwd_workspace")(E, R, C, mode)
    check(need > 0, f"fake_quant_bwd_workspace({E}, {R}, {C}, {mode}) = "
                    f"{need}")
    work = torch.zeros(need, dtype=torch.float32, device=dev)
    dx = torch.zeros_like(x)
    ds = torch.zeros(s.shape, dtype=torch.float32, device=dev)
    err = ops._fn("fake_quant_bwd_launch")(
        x.data_ptr(), s.data_ptr(), g.data_ptr(), dx.data_ptr(),
        work.data_ptr(), ds.data_ptr(), E, R, C, mode, 1, 4,
        ops.grad_scale(x, s, 4), need - 1,
        torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    check(err == 1 and not bool(dx.any()) and not bool(ds.any())
          and not bool(work.any()),
          f"fake_quant_bwd took {need - 1} of {need} workspace at "
          f"({E}, {R}, {C}, mode {mode}): error {err}")


def check_mx_w4a8(torch, P, mcfg, dev):
    """w4a8_matmul bitwise on mixtral's packed linears (K 4096 into N
    4096, 1024, 8 and 32000; o from q_dim 4096): ``check_w4a8_linears``.
    Returns the cases compared."""
    return check_w4a8_linears(
        torch, P, [(f"mixtral {name}", K, N, False)
                   for name, K, N, _ in mx_linear_shapes(mcfg)], dev, 42)


def check_w4a8_linears(torch, P, shapes, dev, seed, ms=None):
    """w4a8_matmul bitwise equal to its plain version on each (name, K,
    N, bias) of ``shapes`` at M 1, 4, 23, 24 and 512 (or ``ms``), by the
    launcher's route and each route forced. Returns the cases
    compared."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ops, ref = P["w4a8_ops"], P["w4a8_matmul_ref"]
    n = 0
    for name, K, N, bias in shapes:
        w_p, s_w, b = w4a8_weights(torch, gen, K, N, bias, dev)
        for M in ms or MX_W4A8_MS:
            x_q, s_x = w4a8_activations(torch, gen, M, K, dev)
            want = ref(x_q, w_p, s_x, s_w, b)
            got = [ops.w4a8_matmul(x_q, w_p, s_x, s_w, b)] + [
                ops.w4a8_matmul_route(x_q, w_p, s_x, s_w, b, route=r)
                for r in W4A8_ROUTES]
            torch.cuda.synchronize()
            for r, out in zip(("launcher",) + W4A8_ROUTES, got):
                check(torch.equal(out, want),
                      f"w4a8_matmul {name} M={M} K={K} N={N} bias={bias} "
                      f"route={r} differs from its plain version")
            n += 1
        del w_p, s_w, b
    torch.cuda.empty_cache()
    return n


def attn_rows_case(torch, P, mcfg, dev, gen, S, window, rows):
    """flash_attn_fwd at (1, S) under ``window`` against its plain version
    and the f64 oracle on query rows [S - rows, S) and [0, rows): each
    held to the rows' own keys (a query attends to at most ``window``
    keys, so the plain version and the oracle run on the slice of keys
    the rows see, their first rows discarded), as ``check_flash_case``
    holds the whole output."""
    fa, ref = P["fa_ops"].flash_attn_fwd, P["flash_attn_ref"]
    rtol, atol = FLASH_TOL
    q, k, v = flash_inputs(torch, gen, mcfg, 1, S, dev)
    got = fa(q, k, v, causal=True, window=window).float()
    out = []
    for a in (S - rows, 0):
        b = a + rows
        lo = max(0, a - window + 1)
        sl = (q[:, lo:b], k[:, lo:b], v[:, lo:b])
        want = ref(*sl, causal=True, window=window).float()[:, a - lo:]
        oracle = flash_oracle(torch, *sl, window)[:, a - lo:]
        g = got[:, a:b]
        err = (g - want).abs()
        beyond = float((err > KVQ_TOL[1] + KVQ_TOL[0] * want.abs()).float()
                       .mean())
        case = {"B": 1, "S": S, "window": window, "rows": [a, b],
                "D": mcfg.resolved_head_dim, "H": mcfg.n_heads,
                "Hkv": mcfg.n_kv_heads, "max_abs_err": float(err.max()),
                "share_beyond_one_ulp": beyond,
                "kernel_vs_oracle": float((g - oracle).abs().max()),
                "plain_vs_oracle": float((want - oracle).abs().max())}
        check(bool(torch.isfinite(g).all())
              and torch.allclose(g, want, rtol=rtol, atol=atol)
              and beyond <= FLASH_ULP_SHARE
              and case["kernel_vs_oracle"]
              <= FLASH_ORACLE_RATIO * case["plain_vs_oracle"],
              f"flash_attn_fwd differs from its plain version: {case}")
        out.append(case)
        del want, oracle, err
        torch.cuda.empty_cache()
    return out


def check_mx_kernels(torch, P, dev, report):
    """Phase 2 at mixtral-8x7b's shapes: the fake-quant kernels in mode 3
    on its expert banks; w4a8_matmul on its linears; kvq_decode_attn at
    D 128, G 4 over a full 4096-row ring, an empty row and ragged lengths
    (bitwise paged decode on the same K/V, each row alone, verify and the
    gather as ``check_decode_case`` holds them); flash_attn_fwd at H 32,
    Hkv 8, D 128 at the QAT shape under the 4096 window and at S 8192
    under it. Returns the worst error per kernel."""
    mcfg = mx_cfg(P)
    n_fq, fq_ds = check_mx_fake_quant(torch, P, dev)
    n_w4 = check_mx_w4a8(torch, P, mcfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(43)
    dec = check_decode_case(torch, P, gen, mcfg, dev, MX_LENGTHS, MX_WINDOW,
                            False, "mixtral D128 G4")
    torch.cuda.empty_cache()
    flash = [check_flash_case(torch, P, gen, mcfg, dev, TRAIN_B, TRAIN_T,
                              MX_WINDOW)]
    torch.cuda.empty_cache()
    flash += attn_rows_case(torch, P, mcfg, dev, gen, MX_FLASH_LONG[1],
                            MX_WINDOW, MX_FLASH_ROWS)
    out = {"fake_quant_mode3_cases": n_fq, "fake_quant_mode3_ds_rel_mass_err":
           fq_ds, "w4a8_cases": n_w4, "decode": dec, "flash": flash}
    report["mx_kernel_cases"] = out
    print(f"phase 2: mixtral-8x7b shapes: fake_quant_fwd and dx bitwise in "
          f"mode 3 on {n_fq} bank cases (ds within {fq_ds:.3g} of its mass, "
          f"a short workspace refused), w4a8_matmul bitwise on {n_w4} "
          f"cases, kvq_decode_attn within one ulp and bitwise paged decode "
          f"({dec}), flash: {flash}", flush=True)
    return {"kvq_decode_attn": dec["kvq_decode_attn"],
            "flash_attn_fwd": max(c["max_abs_err"] for c in flash)}


class RouteLog:
    """Records every ``blocks.moe_route`` call (the router's f32 logits,
    the top-k experts and ``keep``) while the block is active."""

    def __init__(self, blocks):
        self.blocks, self.real, self.calls = blocks, blocks.moe_route, []

    def __enter__(self):
        def record(logits, k, cap):
            out = self.real(logits, k, cap)
            self.calls.append((logits.detach().clone(), out[0], out[3]))
            return out
        self.blocks.moe_route = record
        return self

    def __exit__(self, *exc):
        self.blocks.moe_route = self.real


def route_flips(torch, kern, plain, k):
    """Rows whose routing differs between two decode steps' RouteLogs, at
    the first layer where it does: {row: {layer, gap, moved, rms,
    explained}}. Routing is the set of a token's k experts: their order
    (the top two swapped at a near tie) gives the same output, a sum of
    k exact products. ``gap`` is the plain step's margin between the row's
    k-th and (k+1)-th router logits, ``moved`` the largest difference of
    the row's router logits between the two steps, ``rms`` their size.
    The order of two logits can swap only if they moved by ``gap``
    together, so a flip is explained when ``gap <= 2 moved`` and the
    logits moved by at most LOGIT_REL_TOL of their size: the routing then
    amplified a difference the gate allows, at a near tie."""
    flips = {}
    for layer, ((lk, ik, _), (lp, ip, _)) in enumerate(zip(kern.calls,
                                                           plain.calls)):
        for row in range(ik.shape[0]):
            if row in flips or torch.equal(ik[row].sort(-1).values,
                                           ip[row].sort(-1).values):
                continue
            a, b = lk[row].reshape(-1), lp[row].reshape(-1)
            top = torch.sort(b, descending=True).values
            gap = float(top[k - 1] - top[k])
            moved = float((a - b).abs().max())
            rms = float(b.pow(2).mean().sqrt())
            flips[row] = {"layer": layer, "gap": gap, "moved": moved,
                          "rms": rms,
                          "explained": gap <= 2 * moved
                          and moved <= LOGIT_REL_TOL * rms}
    return flips


def mx_wrapped_logits(torch, P, mcfg, eng, dev):
    """(a): 4 prompts of 4090 tokens prefilled, 12 decode steps through
    the kernels (the 4096-row rings wrap), then one step from the same
    cache through the kernels and through their plain versions. Held to
    LOGIT_REL_TOL on every row whose routing matched in every layer; a
    row whose routing differs must owe it to a near tie that its router
    logits' allowed difference crossed (``route_flips``)."""
    import numpy as np
    models, blocks = P["models"], P["blocks"]
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(
        0, mcfg.vocab_size, (MX_WRAP_ROWS, MX_WRAP_PROMPT)).astype(
            np.int32)).to(dev)
    logits, cache = models.prefill(mcfg, eng.params, eng.ctx,
                                   {"tokens": toks},
                                   cache_budget=MX_CACHE_LEN)
    tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
    for _ in range(MX_WRAP_STEPS):
        logits, cache = models.decode_step(mcfg, eng.params, eng.ctx, tok,
                                           cache)
        tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
    length = int(cache["layers"][0]["length"][0])
    check(length > MX_WINDOW, f"mixtral: the ring did not wrap: {length}")
    with RouteLog(blocks) as rk:
        lk, _ = models.decode_step(mcfg, eng.params, eng.ctx, tok,
                                   models.clone_cache(cache))
    with RouteLog(blocks) as rp:
        lp, _ = models.decode_step(mcfg, eng.params,
                                   replace(eng.ctx, kernel_backend="ref"),
                                   tok, models.clone_cache(cache))
    lk, lp = lk.float()[:, 0], lp.float()[:, 0]
    check(bool(torch.isfinite(lk).all()), "mixtral logits not finite")
    flips = route_flips(torch, rk, rp, mcfg.n_experts_active)
    same = [r for r in range(lk.shape[0]) if r not in flips]
    rel = {r: float(torch.linalg.vector_norm(lk[r] - lp[r])
                    / torch.linalg.vector_norm(lp[r])) for r in range(
                        lk.shape[0])}
    check(all(rel[r] <= LOGIT_REL_TOL for r in same),
          f"mixtral: decode logits after the wrap, kernels vs plain, "
          f"relative L2 per row {rel} > {LOGIT_REL_TOL} on rows routed "
          f"alike {same}")
    check(all(f["explained"] for f in flips.values()),
          f"mixtral: routing differs between kernels and plain away from a "
          f"near tie: {flips}")
    all_rel = float(torch.linalg.vector_norm(lk - lp)
                    / torch.linalg.vector_norm(lp))
    del cache, logits
    torch.cuda.empty_cache()
    return {"wrapped_length": length, "rows": MX_WRAP_ROWS,
            "rel_l2_per_row": rel, "rel_l2_all_rows": all_rel,
            "rows_routed_differently": {str(r): f
                                        for r, f in flips.items()},
            "argmax_agreement": float((lk.argmax(-1) == lp.argmax(-1))
                                      .float().mean())}


def mx_prefill_rows(torch, P, mcfg, params, dev, report):
    """(c): one prompt prefilled alone and in a wave of 4, both padded to
    the wave's 1024 tokens (one MoE chunk; the capacity, 320 slots an
    expert and row, follows the padded length): its cache and first-token
    logits must be bitwise the same, attention row by row and the expert
    GEMMs batched over the wave (M 320 alone, 1280 in the wave). Also
    each expert's share of the wave's routed (token, slot) pairs and the
    share dropped at capacity (real tokens)."""
    import numpy as np
    models, blocks, qat = P["models"], P["blocks"], P["qat"]
    rng = np.random.default_rng(32)
    prompts = [rng.integers(0, mcfg.vocab_size, n).astype(np.int32)
               for n in MX_ROW_LENS]
    L = max(MX_ROW_LENS)
    ctx = qat.make_ctx("A8d-C8-W4", weights_layout="w4a8")

    def wave(rows):
        lens = [len(prompts[i]) for i in rows]
        toks = torch.zeros((len(rows), L), dtype=torch.int32, device=dev)
        for j, i in enumerate(rows):
            toks[j, :lens[j]] = torch.from_numpy(prompts[i]).to(dev)
        logits, cache = models.prefill(
            mcfg, params, ctx, {"tokens": toks, "lengths": torch.tensor(
                lens, dtype=torch.int32, device=dev)},
            cache_budget=MX_CACHE_LEN)
        return logits[0], [{k: v[0] for k, v in c.items()}
                           for c in cache["layers"]]

    def compare():
        la, ca = wave([0])
        lw, cw = wave(range(len(prompts)))
        torch.cuda.synchronize()
        differ = sum(int((a[k] != b[k]).sum()) for a, b in zip(ca, cw)
                     for k in ("k_q", "v_q", "s_k", "s_v"))
        t0 = time.perf_counter()
        wave(range(len(prompts)))
        torch.cuda.synchronize()
        return {"logits_bitwise": bool(torch.equal(la, lw)),
                "logits_max_abs_diff": float((la.float() - lw.float())
                                             .abs().max()),
                "cache_values_differing": differ,
                "wave_ms": (time.perf_counter() - t0) * 1e3}

    out = {"lens": list(MX_ROW_LENS), "padded_to": L}
    with RouteLog(blocks) as log:
        out.update(compare())
    check(out["logits_bitwise"] and out["cache_values_differing"] == 0,
          f"mixtral cold prefill: a prompt's cache or logits differ alone "
          f"and in a wave of 4: {out}")
    # routing of the wave (the last wave of 4 logged: its 16 layers)
    e, k = mcfg.n_experts, mcfg.n_experts_active
    wave_calls = [c for c in log.calls if c[1].shape[0] == len(prompts)]
    wave_calls = wave_calls[-mcfg.n_layers:]
    lens = torch.tensor(MX_ROW_LENS, device=dev)
    counts = torch.zeros(e, device=dev)
    kept = total = 0
    for _, idx, keep in wave_calls:
        real_tok = (torch.arange(idx.shape[1], device=dev)[None]
                    < lens[:, None])[..., None].expand_as(idx)
        sel = idx[real_tok & keep]
        counts += torch.bincount(sel, minlength=e).float()
        kept += int((real_tok & keep).sum())
        total += int(real_tok.sum())
    out["expert_share"] = (counts / counts.sum()).tolist()
    out["dropped_share"] = 1.0 - kept / max(total, 1)
    out["routed_pairs"] = total
    check(total == sum(MX_ROW_LENS) * k * mcfg.n_layers,
          f"mixtral: {total} routed pairs logged, want "
          f"{sum(MX_ROW_LENS) * k * mcfg.n_layers}")
    report["mx_prefill_rows"] = out
    print(f"phase 3i: cold prefill batch invariance (a prompt alone vs in "
          f"a wave of 4, padded to {L}) and routing: {out}", flush=True)
    return out


def serve_mx(torch, P, dev, report):
    """Phase 3i: mixtral-8x7b at full width and 16 layers (random weights
    from a seed, bank scales LSQ-initialised) on ``ServeEngine``:
    A8d-C8-W4, w4a8 weights (attention, router and head packed; the banks
    bf16, fake-quantized on every forward), dense layout, 4 slots,
    cache_len 8192 (rings of 4096). (a) the wrapped rings' logits,
    kernels vs plain; (b) 8 requests of three lengths, two of 4080 tokens
    wrapping while they decode: kvq_decode_attn 16 launches a decode step,
    fake_quant_fwd 48 a forward (decode step or prefill wave: 3 banks a
    layer), w4a8_matmul launches, no other kernel; (c) cold-prefill batch
    invariance and the routing shares; decode tok/s, TTFT, peak
    memory."""
    import numpy as np
    qat, models = P["qat"], P["models"]
    mcfg = mx_cfg(P)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = models.init_params(mcfg, seed=0, device=dev)
    policy = P["parse_policy"]("A8d-C8-W4")
    # a served tree carries calibrated scales; the banks' placeholder
    # all-ones s_w would round every 4-bit expert weight to zero. LSQ's
    # init (2 mean|w| / sqrt(qp)) is one pass over each bank.
    params = qat.calibrate_weight_scales(params, policy, method="lsq")
    eng = P["ServeEngine"](mcfg, params, policy="A8d-C8-W4", slots=SLOTS,
                           cache_len=MX_CACHE_LEN, max_new_cap=MAX_NEW,
                           decode_block=8, weights_layout="w4a8", device=dev)
    del params
    eng.params = qat.drop_exported_weights(eng.params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ring = [c["k_q"].shape[2] for c in eng.state["cache"]["layers"]]
    check(ring == [MX_WINDOW] * mcfg.n_layers,
          f"mixtral: rings of {ring} rows, want {MX_WINDOW}")
    check(all("w" in lay["moe"][b] and "w4a8" not in lay["moe"][b]
              and "w4a8" in lay["moe"]["router"]
              for lay in eng.params["layers"] for b in ("wg", "wu", "wd")),
          "mixtral: the served tree's banks are packed or gone")
    wrapped = mx_wrapped_logits(torch, P, mcfg, eng, dev)

    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, mcfg.vocab_size, n).astype(np.int32)
               for n in MX_SERVE_LENS]
    reqs = [P["Request"](uid=i, prompt=p, max_new_tokens=MAX_NEW,
                         temperature=0.8 if i % 4 == 3 else 0.0,
                         top_k=8 if i % 4 == 3 else 0, seed=i)
            for i, p in enumerate(prompts)]
    counted = {**counted_kernels(P),
               "flash_attn_fwd": P["fa_ops"].flash_attn_fwd,
               "slstm_scan": P["slstm_ops"].slstm_scan,
               "fake_quant_fwd": P["fq_ops"].fake_quant_fwd,
               "fake_quant_bwd": P["fq_ops"].fake_quant_bwd}
    for r in reqs:
        eng.submit(r)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counted.items()}
    check_streams(mcfg, reqs, "mixtral serve")
    L = mcfg.n_layers
    forwards = stats["decode_steps"] + stats["prefill_calls"]
    check(launches["w4a8_matmul"] > 0,
          f"mixtral serve: w4a8_matmul never launched: {launches}")
    check(launches["kvq_decode_attn"] == L * stats["decode_steps"],
          f"mixtral serve: {launches['kvq_decode_attn']} kvq_decode_attn "
          f"launches over {stats['decode_steps']} decode steps, want {L} a "
          f"step")
    check(launches["fake_quant_fwd"] == 3 * L * forwards,
          f"mixtral serve: {launches['fake_quant_fwd']} fake_quant_fwd "
          f"launches over {stats['decode_steps']} decode steps and "
          f"{stats['prefill_calls']} prefill waves, want {3 * L} a forward")
    others = [n for n in counted if n not in ("w4a8_matmul",
                                              "kvq_decode_attn",
                                              "fake_quant_fwd")]
    check(all(launches[n] == 0 for n in others),
          f"mixtral serve: another kernel ran: {launches}")
    decode_tokens = stats["tokens_out"] - len(reqs)
    served = {"arch": MX, "layers": L, "requests": len(reqs),
              "prompt_lens": list(MX_SERVE_LENS), "setup_s": setup_s,
              "tokens_out": stats["tokens_out"], "wall_s": wall,
              "tokens_per_s": stats["tokens_out"] / wall,
              "decode_tokens_per_s": decode_tokens / stats["decode_s"],
              "decode_step_ms": 1e3 * stats["decode_step_s"],
              "decode_steps": stats["decode_steps"],
              "ttft_p50_s": stats["ttft_p50_s"],
              "ttft_p95_s": stats["ttft_p95_s"],
              "prefill_s": stats["prefill_s"],
              "prefill_calls": stats["prefill_calls"],
              "wrapped_logits": wrapped, "launches": launches,
              "launches_per_decode_step": {
                  "kvq_decode_attn": L, "fake_quant_fwd": 3 * L},
              "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    report["serve_mx"] = served
    print("serve_mx " + json.dumps(served), flush=True)
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    mx_prefill_rows(torch, P, mcfg, params, dev, report)
    print(f"phase 3i: mixtral-8x7b ({L} layers) dense w4a8 serve, "
          f"{served['decode_tokens_per_s']:.2f} decode tok/s, "
          f"{served['decode_step_ms']:.2f} ms a decode step, TTFT p50 "
          f"{served['ttft_p50_s']:.3f} s; logits after the wrap kernels vs "
          f"plain {wrapped['rel_l2_per_row']}", flush=True)
    del params
    torch.cuda.empty_cache()
    return launches


def weight_sites(cfg):
    """Fake-quantized weights of one student forward: q, k, v, o and the
    MLP's three, or the router and the three banks, a layer; and the
    head."""
    return (8 if cfg.is_moe else 7) * cfg.n_layers + 1


def train_mx(torch, P, dev, report):
    """Phase 6c: ``train_cut`` on mixtral-8x7b at full width and 2
    layers: per step 17 fake_quant_fwd and 17 _bwd (q, k, v, o, router
    and three banks a layer, then the head) and 2 flash_attn_fwd (the
    teacher's layers)."""
    return train_cut(torch, P, dev, report, MX, MX_TRAIN_LAYERS,
                     "train_mx", "phase 6c")


def train_cut(torch, P, dev, report, arch, n_layers, key, phase):
    """run_qat on ``arch`` at full width and ``n_layers`` layers,
    A8d-C8-W4, 2 teacher steps, MSE weight calibration, 2 steps at B 8,
    T 128: per step one fake_quant_fwd and one _bwd per weight site
    (``weight_sites``) and one flash_attn_fwd a layer (the teacher's);
    losses finite, every s_w moved (an MoE's (e, 1, d_out) bank scales
    and its router's included), no NaN; an MoE's moe_aux finite and > 0;
    a qk-norm model's q_norm and k_norm weights received finite,
    non-zero gradients (AdamW's first moments; a bf16 weight of 1.0 does
    not move at the QAT learning rate); step ms split, tokens/s, peak
    memory, idle share, model-FLOPs share (an MoE's over its active
    experts)."""
    mcfg = P["get_config"](arch).replace(n_layers=n_layers)
    tcfg = P["TrainConfig"](precision="A8d-C8-W4", total_steps=MX_TRAIN_STEPS,
                            ref_steps=MX_TRAIN_STEPS, batch_size=TRAIN_B,
                            seq_len=TRAIN_T)
    steps, state = [], {}

    def on_start(student, opt):
        state["w0"] = {k: t.detach().clone() for k, t in
                       _named_leaves(student) if k.endswith("s_w")}
        state["counts"] = tuple(fn.launches for fn in train_counters(P))

    def on_step(step, metrics, student, opt):
        counts = tuple(fn.launches for fn in train_counters(P))
        steps.append({"step": step, "loss": float(metrics["loss"]),
                      "ms": metrics["ms"],
                      "launches": [a - b for a, b in
                                   zip(counts, state["counts"])]})
        state["counts"] = counts
        state["opt"] = opt

    for fn in train_counters(P):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    teacher, student, _ = P["train"].run_qat(
        arch, tcfg, reduced=False, teacher_steps=2, device=dev, log_every=1,
        n_layers=n_layers, split_times=True, on_start=on_start,
        on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    names = ("fake_quant_fwd", "fake_quant_bwd", "flash_attn_fwd",
             "slstm_scan")
    launches = dict(zip(names, (fn.launches for fn in train_counters(P))))
    peak = torch.cuda.max_memory_allocated(dev)
    n_w = weight_sites(mcfg)
    L = mcfg.n_layers
    for s in steps:
        check(s["launches"] == [n_w, n_w, L, 0],
              f"{arch} QAT step {s['step']}: launches "
              f"{dict(zip(names, s['launches']))}, want ({n_w}, {n_w}, {L}, "
              f"0)")
        check(math.isfinite(s["loss"]),
              f"{arch} QAT step {s['step']}: loss {s['loss']}")
    check(len(steps) == MX_TRAIN_STEPS, f"{len(steps)} {arch} QAT steps")
    opt = state.pop("opt")
    named = dict(_named_leaves(student))
    unmoved = [k for k, t0_ in state["w0"].items()
               if torch.equal(named[k], t0_)]
    s_w = list(state["w0"])
    banks = [k for k in s_w if "/moe/w" in k]
    qk = {k: m for k, m in _named_leaves(opt.m)
          if k.endswith(("q_norm/w", "k_norm/w"))}
    check(all(bool(torch.isfinite(m).all()) and bool(m.any())
              for m in qk.values()),
          f"{arch}: a qk-norm weight's gradient is zero or not finite "
          f"(AdamW first moments)")
    check(len(s_w) == n_w and not unmoved
          and len(banks) == (3 * L if mcfg.is_moe else 0)
          and len(qk) == (2 * L if mcfg.qk_norm else 0)
          and all(tuple(named[k].shape) == (mcfg.n_experts, 1,
                                            named[k].shape[-1])
                  for k in banks),
          f"{arch}: s_w that did not move: {unmoved[:5]} "
          f"({len(unmoved)} of {len(state['w0'])}; banks {banks}, qk-norm "
          f"{sorted(qk)})")
    check(all(bool(torch.isfinite(t).all()) for t in named.values()),
          f"{arch}: a parameter is not finite after QAT")
    aux = None
    if mcfg.is_moe:
        it = P["MixtureIterator"](P["SyntheticConfig"](
            vocab_size=mcfg.vocab_size, seq_len=TRAIN_T, batch_size=TRAIN_B),
            start_step=1)
        batch = P["to_device"](next(it), dev)
        with torch.no_grad():
            aux = float(P["models"].forward(
                mcfg, student, P["qat"].make_ctx(tcfg.precision),
                batch)[1]["moe_aux"])
        check(math.isfinite(aux) and aux > 0.0, f"{arch}: moe_aux {aux}")
    del opt, state
    torch.cuda.empty_cache()
    per = {k: sum(s["ms"][k] for s in steps[1:]) / (len(steps) - 1)
           for k in ("teacher", "student", "optimizer")}
    step_ms = sum(per.values())
    flops = train_flops(mcfg, TRAIN_B, TRAIN_T)
    trained = {"arch": arch, "layers": L, "steps": MX_TRAIN_STEPS,
               "batch": TRAIN_B, "seq": TRAIN_T,
               "params_total": mcfg.param_counts()["total"],
               "params_active": mcfg.param_counts()["active"],
               "losses": [s["loss"] for s in steps], "moe_aux": aux,
               "ms_per_step": step_ms, "ms_split": per,
               "ms_first_step": sum(steps[0]["ms"].values()),
               "tokens_per_s": TRAIN_B * TRAIN_T / (step_ms / 1e3),
               "peak_memory_bytes": peak, "wall_s": wall,
               "model_flops_per_step": flops,
               "model_flops_share": flops / (step_ms / 1e3) / BF16_PEAK_FLOPS,
               "launches_per_step": dict(zip(names, steps[-1]["launches"])),
               "weight_sites": n_w, "qk_norm_leaves_with_grads": len(qk),
               "launches": launches}
    report[key] = trained
    print(f"{phase}: " + json.dumps(trained), flush=True)
    del teacher, student
    torch.cuda.empty_cache()
    return launches


def time_bank(torch, P, e, R, C, bits, dev, gen):
    """One bank (e, R, C) in mode 3: fake_quant_fwd and _bwd per launch
    beside the plain versions, one PyTorch call on the bank permuted to
    (R, e * C) (the permute outside the timed call:
    ``fake_quantize_per_channel_affine`` forward, the learnable op's
    forward and backward), the same kernels in mode 1 on the same bytes
    ((e * R, C), one scale a column), and the bounds (bytes)."""
    ops, ref = P["fq_ops"], P["fq_ref"]
    qn, qp = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    x, s, g = bank_inputs(torch, gen, e, R, C, bits, dev)
    sets = [(x, s, g)]
    out = {"shape": [e, R, C], "bits": bits}
    out["fwd_ms"] = time_ms(torch, lambda x, s, g: ops.fake_quant_fwd(
        x, s, bits), sets, min_calls=20)
    out["bwd_ms"] = time_ms(torch, lambda x, s, g: ops.fake_quant_bwd(
        x, s, g, bits), sets, min_calls=20)
    out["fwd_plain_ms"] = time_eager_ms(
        torch, lambda x, s, g: ref.fake_quant_fwd_ref(x, s, bits), sets,
        min_calls=3)
    out["bwd_plain_ms"] = time_eager_ms(
        torch, lambda x, s, g: ops.fake_quant_bwd(x, s, g, bits,
                                                  plain=True), sets,
        min_calls=3)
    x1, g1 = x.view(e * R, C), g.view(e * R, C)
    s1 = s[:1].contiguous()
    m1 = [(x1, s1, g1)]
    out["mode1_fwd_ms"] = time_ms(torch, lambda x, s, g: ops.fake_quant_fwd(
        x, s, bits), m1, min_calls=20)
    out["mode1_bwd_ms"] = time_ms(torch, lambda x, s, g: ops.fake_quant_bwd(
        x, s, g, bits), m1, min_calls=20)
    xp = x.permute(1, 0, 2).reshape(R, e * C).contiguous()
    gp = g.permute(1, 0, 2).reshape(R, e * C).contiguous()
    sp = s.reshape(-1).contiguous()
    del m1, x1, g1
    zp = torch.zeros(e * C, dtype=torch.int32, device=dev)
    zpf = torch.zeros(e * C, dtype=torch.float32, device=dev)
    lib = [(xp, sp, gp)]
    out["fwd_library_ms"] = time_eager_ms(
        torch, lambda x, s, g: torch.fake_quantize_per_channel_affine(
            x, s, zp, 1, qn, qp), lib, min_calls=5)

    def lib_bwd(x, s, g):
        xr = x.detach().requires_grad_(True)
        sr = s.detach().requires_grad_(True)
        y = torch._fake_quantize_learnable_per_channel_affine(
            xr, sr, zpf, 1, qn, qp, 1.0)
        return torch.autograd.grad(y, (xr, sr), g)

    out["bwd_library_ms"] = time_eager_ms(torch, lib_bwd, lib, min_calls=3)
    n, n_s = e * R * C, e * C
    out["fwd_bound_ms"] = (4 * n + 4 * n_s) / HBM_BYTES_PER_S * 1e3
    out["bwd_bound_ms"] = (6 * n + 8 * n_s) / HBM_BYTES_PER_S * 1e3
    del sets, lib, xp, gp, x, s, g
    torch.cuda.empty_cache()
    return out


def bank_step(banks, L):
    """A decode step's bank fake-quants from ``time_bank``'s two banks
    (wg and wu shaped as the first, wd as the second): 3 L forward
    launches."""
    step = {k: 2 * L * banks[0][f"fwd_{k}"] + L * banks[1][f"fwd_{k}"]
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    step["mode1_ms"] = 2 * L * banks[0]["mode1_fwd_ms"] + \
        L * banks[1]["mode1_fwd_ms"]
    step["bound_by"] = "bytes"
    return step


def mx_moe_split(torch, P, mcfg, dev):
    """One MoE layer of a decode step (B 4, one token a slot) timed by
    parts, each part issued eagerly between two CUDA events (what the
    eager decode loop pays, host launches included): the router (its
    w4a8 linear and the top-2, gates and positions), the dispatch (slot
    table and gather), the three banks' fake-quant, the expert GEMMs
    (activation quantization, three bmm, SwiGLU) and the combine; and
    the whole ``moe_fwd`` the same way and by CUDA-graph replay (device
    time)."""
    qat, blocks = P["qat"], P["blocks"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(44)
    p = blocks.init_moe(mcfg, gen)
    p = qat.calibrate_weight_scales({"moe": p}, P["parse_policy"](
        "A8d-C8-W4"), method="lsq")
    p = qat.attach_w4a8_exports(p, P["parse_policy"]("A8d-C8-W4"))["moe"]
    ctx = qat.make_ctx("A8d-C8-W4", weights_layout="w4a8")
    Bn, e, k, d = SLOTS, mcfg.n_experts, mcfg.n_experts_active, \
        mcfg.d_model
    x = torch.randn((Bn, 1, d), generator=gen, device=dev).to(torch.bfloat16)
    cap = blocks.moe_capacity(mcfg, 1)
    bidx = torch.arange(Bn, device=dev)
    tok = torch.zeros((Bn, 1, k), dtype=torch.long, device=dev)

    def router():
        logits = qat.qlinear(ctx, x, p["router"], act_bits=8,
                             weight_bits=8).float()
        return blocks.moe_route(logits, k, cap)

    idx, gates, pos, keep = router()

    def dispatch():
        slot = torch.where(keep, idx * cap + pos, e * cap)
        table = torch.full((Bn, e * cap + 1), 1, dtype=torch.long,
                           device=dev)
        table.scatter_(1, slot.reshape(Bn, -1), tok.reshape(Bn, -1))
        table = table[:, :e * cap].reshape(Bn, e, cap).transpose(0, 1)
        xz = torch.cat([x, x.new_zeros((Bn, 1, d))], dim=1)
        return xz[bidx[None, :, None], table]

    xe = dispatch()

    def fake_quant():
        return {n: qat.quantize_weight_p(ctx, p[n]) for n in
                ("wg", "wu", "wd")}

    wq = fake_quant()

    def experts():
        g = blocks._expert_linear(ctx, xe, p["wg"], None, wq["wg"])
        u = blocks._expert_linear(ctx, xe, p["wu"], None, wq["wu"])
        h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
        return blocks._expert_linear(ctx, h, p["wd"], None, wq["wd"])

    ye = experts()

    def combine():
        ysel = ye[idx, bidx[:, None, None], torch.clamp_max(pos, cap - 1)]
        gk = torch.where(keep, gates.to(torch.bfloat16).float(),
                         torch.zeros_like(gates))
        return torch.sum(ysel.float() * gk[..., None], dim=2).to(x.dtype)

    def whole():
        return blocks.moe_fwd(mcfg, ctx, p, x, with_aux=False)[0]

    one = [()]
    out = {name: time_eager_ms(torch, fn, one, min_calls=20)
           for name, fn in (("router", router), ("dispatch", dispatch),
                            ("fake_quant", fake_quant),
                            ("expert_gemms", experts),
                            ("combine", combine), ("moe_fwd", whole))}
    out["moe_fwd_device_ms"] = time_ms(torch, whole, one, min_calls=10)
    ref = whole()
    check(torch.equal(combine(), ref), f"{mcfg.name}: the timed MoE parts "
                                       f"do not compose to moe_fwd")
    del p, wq, xe, ye
    torch.cuda.empty_cache()
    return out


def w4a8_step_times(torch, P, shapes, dev, gen):
    """w4a8_matmul over one decode step (M 4) of the packed linears
    ``shapes`` (name, K, N, launches a step): device ms, the plain
    version, bf16 ``torch.matmul`` on the dequantized operands and the
    bound, each summed over the step."""
    w4 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    ref, w4a8 = P["w4a8_matmul_ref"], P["w4a8_ops"].w4a8_matmul

    def w4a8_set(K, N):
        x_q, s_x = w4a8_activations(torch, gen, SLOTS, K, dev)
        w_p, s_w, _ = w4a8_weights(torch, gen, K, N, False, dev)
        return x_q, w_p, s_x, s_w

    for name, K, N, per in shapes:
        base = w4a8_set(K, N)
        sets = [base] + [w4a8_set(K, N)
                         for _ in range(copies_for(N * K // 2) - 1)]
        x_q, w_p, s_x, s_w = base
        wf = (P["unpack_int4"](w_p).float().T * s_w[None]).to(torch.bfloat16)
        xf = (x_q.float() * s_x).to(torch.bfloat16)
        w4["ms"] += per * time_ms(torch, w4a8, sets)
        w4["plain_ms"] += per * time_ms(torch, ref, sets[:1], min_calls=5)
        w4["library_ms"] += per * time_ms(torch, torch.matmul, [(xf, wf)])
        w4["bound_ms"] += per * w4a8_bound_ms(SLOTS, K, N, False)[0]
        del sets, base, wf, xf
    w4["bound_by"] = "bytes"
    torch.cuda.empty_cache()
    return w4


def time_mx(torch, P, dev, report):
    """Phase 4 at mixtral-8x7b's shapes: fake_quant_fwd and _bwd per bank
    in mode 3 (and the 48 forward launches of a decode step) beside the
    plain versions, one PyTorch call and mode 1 on the same bytes; a
    decode step's MoE by parts; its 16 dense decode launches at B 4 over
    full 4096-row rings (D 128, H 32, Hkv 8) beside SDPA
    (``enable_gqa``); a 2-layer teacher forward's flash launches at (B 8,
    T 128); w4a8_matmul per decode step (M 4) over its packed linears."""
    mcfg = mx_cfg(P)
    gen = torch.Generator(device=dev)
    gen.manual_seed(45)
    banks = [time_bank(torch, P, *shape, 4, dev, gen) for shape in MX_BANKS]
    L = mcfg.n_layers
    step = bank_step(banks, L)
    split = mx_moe_split(torch, P, mcfg, dev)
    dec = time_dense_launch(torch, P, mcfg, dev, gen, (MX_WINDOW,) * SLOTS,
                            MX_WINDOW, False)
    fl = time_flash_launch(torch, P, mcfg, dev, gen, TRAIN_B, TRAIN_T, 10)
    w4 = w4a8_step_times(torch, P, mx_linear_shapes(mcfg), dev, gen)
    out = {"banks": banks, "fake_quant_fwd_decode_step": step,
           "moe_decode_layer_split_ms": split,
           "decode_attn_launch": dec, "decode_attn_step": per_step(dec, L),
           "flash_launch": fl,
           "flash_teacher_forward": per_step(fl, MX_TRAIN_LAYERS),
           "w4a8_decode_step": w4}
    report["mx_times"] = out
    for b in banks:
        print(f"phase 4: mixtral bank {b['shape']}: fake_quant_fwd "
              f"{b['fwd_ms']:.4f} ms (mode 1 on the same bytes "
              f"{b['mode1_fwd_ms']:.4f}, bound {b['fwd_bound_ms']:.4f}, "
              f"plain {b['fwd_plain_ms']:.3f}, library "
              f"{b['fwd_library_ms']:.3f}); fake_quant_bwd "
              f"{b['bwd_ms']:.4f} ms (mode 1 {b['mode1_bwd_ms']:.4f}, bound "
              f"{b['bwd_bound_ms']:.4f}, plain {b['bwd_plain_ms']:.3f}, "
              f"library {b['bwd_library_ms']:.3f})", flush=True)
    print(f"phase 4: mixtral decode step: fake_quant_fwd {step}; MoE layer "
          f"by parts {split}; kvq_decode_attn per launch "
          f"{dec['ms'] * 1e3:.2f} us (SDPA gqa {dec['library_ms'] * 1e3:.2f}"
          f" us, bound {dec['bound_ms'] * 1e3:.2f} us); flash per launch "
          f"{fl['ms'] * 1e3:.2f} us (SDPA {fl['library_ms'] * 1e3:.2f} us); "
          f"w4a8 per decode step {w4}", flush=True)
    return out


# --------------------------------------------------------------------------
# moonshot-v1-16b-a3b (top 6 of 64 experts on the paged pool), qwen3-14b,
# qwen3-32b (qk-norm) and qwen2-7b: phases 2, 3j-3l, 6d-6e and 4
# --------------------------------------------------------------------------

MS = "moonshot-v1-16b-a3b"
Q14, Q32, Q7 = "qwen3-14b", "qwen3-32b", "qwen2-7b"
# depth cuts (full width): moonshot's 48 layers (28.06 B parameters, 56.1
# GB in bf16) are served whole, its QAT keeps 4 layers (2.95 B at QAT's
# 17-21 B a parameter: 50-62 GB); qwen3-32b's 64 layers (65.5 GB in
# bf16) and their packed planes (15.6 GB) pass the card's 80 GB at the
# w4a8 export, so serving keeps 48 (25.0 B: 49.9 + 12.1 GB at the
# export); qwen3-14b's QAT keeps 4 layers (2.88 B); qwen2-7b (15.2 GB) is
# served whole
MS_TRAIN_LAYERS = 4
Q32_SERVE_LAYERS = 48
Q14_TRAIN_LAYERS = 4
MS_BANKS = ((64, 2048, 1408), (64, 1408, 2048))   # wg / wu, wd
NEW_ATTN = (MS, Q14, Q7, Q32)    # GQA groups 1, 5, 7 and 8 at D 128
DENSE_SERVE_LENS = (200, 200, 120, 120, 120, 48, 48, 48)


def new_linear_shapes(P):
    """(name, K, N, bias) of every distinct packed linear the new archs
    serve: q, k, v, o, the MLP's three (an MoE: the router), the untied
    head; qwen3-32b's q widens d 5120 to q_dim 8192 and o narrows it
    back, qwen2-7b's q, k, v carry a bias (k and v at N 512)."""
    seen, out = set(), []
    for arch in NEW_ATTN:
        c = P["get_config"](arch)
        shapes = (mx_linear_shapes(c) if c.is_moe else linear_shapes(c))
        for name, K, N, _ in shapes:
            bias = c.qkv_bias and name in ("q", "k", "v")
            if (K, N, bias) not in seen:
                seen.add((K, N, bias))
                out.append((f"{arch} {name}", K, N, bias))
    return out


def check_new_kernels(torch, P, dev, report):
    """Phase 2 at this slice's shapes: w4a8_matmul bitwise on every new
    packed linear; at D 128 and GQA groups 1 (moonshot, 16 KV heads), 5
    (qwen3-14b), 7 (qwen2-7b) and 8 (qwen3-32b) the dense decode kernel
    within one bf16 ulp of plain and bitwise the paged one on the same
    K/V, each row bitwise alone, verify's queries within one ulp and each
    bitwise paged decode, the gather bitwise (``check_decode_case``), on
    ragged lengths and around the split and group boundaries; the gather
    and the four-leaf COW at moonshot's pool (16 KV heads, 48 layers);
    flash at G 1 (H 16) and G 5 (H 40, Hkv 8) at (8, 128) against plain
    and the f64 oracle; fake-quant mode 3 bitwise on moonshot's 64-expert
    banks at bits 4 and 8. Returns the worst error per kernel."""
    cfgs = {a: P["get_config"](a) for a in NEW_ATTN}
    n_w4 = check_w4a8_linears(torch, P, new_linear_shapes(P), dev, 51)
    gen = torch.Generator(device=dev)
    gen.manual_seed(52)
    cases, worst = [], {}
    for arch, c in cfgs.items():
        G = c.n_heads // c.n_kv_heads
        for lengths, S in ((KVQ_LENGTHS, CACHE_LEN),
                           (split_lengths(P), max(split_lengths(P)))):
            what = f"{arch} D{c.resolved_head_dim} G{G}"
            errs = check_decode_case(torch, P, gen, c, dev, lengths, S,
                                     False, what)
            cases.append({"case": what, "lengths": list(lengths), "S": S,
                          **errs})
            for k, e in errs.items():
                worst[k] = max(worst.get(k, 0.0), e)
            torch.cuda.empty_cache()
    ms = cfgs[MS]
    check_gather(torch, P, ms, dev, report, report_key="ms_gather_bitwise")
    check_copy_multi(torch, P, ms, dev, report, layers=ms.n_layers,
                     report_key="ms_copy_multi_bitwise")
    torch.cuda.empty_cache()
    flash = [check_flash_case(torch, P, gen, cfgs[a], dev, TRAIN_B, TRAIN_T,
                              0) for a in (MS, Q14)]
    worst["flash_attn_fwd"] = max(c["max_abs_err"] for c in flash)
    torch.cuda.empty_cache()
    n_fq, fq_ds = check_banks(torch, P, dev, MS_BANKS, (), 53)
    out = {"w4a8_cases": n_w4, "decode": cases, "flash": flash,
           "fake_quant_mode3_cases": n_fq,
           "fake_quant_mode3_ds_rel_mass_err": fq_ds}
    report["new_kernel_cases"] = out
    print(f"phase 2: moonshot, qwen3 and qwen2-7b shapes: w4a8_matmul "
          f"bitwise on {n_w4} cases; at G 1, 5, 7, 8 kvq_decode_attn within "
          f"one ulp and bitwise paged decode, verify queries bitwise paged "
          f"decode, the gather bitwise: {cases}; the gather and the COW at "
          f"16 KV heads x 48 layers bitwise; flash {flash}; fake-quant "
          f"mode 3 fwd and dx bitwise on {n_fq} 64-expert bank cases (ds "
          f"within {fq_ds:.3g} of its mass)", flush=True)
    return worst


class RouteCounts:
    """While active, counts the routing of every ``blocks.moe_route``
    call on the device (no host sync): each expert's kept (token, slot)
    pairs, and over calls whose window holds ``window`` tokens (every
    call when 0) the pairs routed and those dropped at capacity; and
    counts ``moe_fwd`` calls on the host."""

    def __init__(self, torch, blocks, e, dev, window=0):
        self.torch, self.blocks, self.window = torch, blocks, window
        self.real_route, self.real_fwd = blocks.moe_route, blocks.moe_fwd
        self.kept = torch.zeros(e, dtype=torch.float32, device=dev)
        self.dropped = torch.zeros((), dtype=torch.float32, device=dev)
        self.pairs = self.calls = 0

    def __enter__(self):
        torch = self.torch

        def route(logits, k, cap):
            out = self.real_route(logits, k, cap)
            if not self.window or logits.shape[1] == self.window:
                idx, keep = out[0], out[3]
                self.kept.scatter_add_(0, idx.reshape(-1),
                                       keep.reshape(-1).to(torch.float32))
                self.dropped += (~keep).sum().to(torch.float32)
                self.pairs += idx.numel()
            return out

        def fwd(*args, **kw):
            self.calls += 1
            return self.real_fwd(*args, **kw)

        self.blocks.moe_route, self.blocks.moe_fwd = route, fwd
        return self

    def __exit__(self, *exc):
        self.blocks.moe_route = self.real_route
        self.blocks.moe_fwd = self.real_fwd

    def shares(self):
        return {"expert_share": (self.kept / self.kept.sum()).tolist(),
                "dropped_share": float(self.dropped) / max(self.pairs, 1),
                "routed_pairs": self.pairs}


def ms_served_tree(torch, P, mcfg, dev):
    """moonshot's serving tree on the paged phase's engine: random
    weights from a seed, scales LSQ-initialised (the banks' placeholder
    all-ones s_w would round every 4-bit expert weight to zero), the
    attention, router and head packed and their bf16 weights dropped, the
    banks bf16 (fake-quantized on every forward). Returns (engine,
    setup s)."""
    qat, models = P["qat"], P["models"]
    t0 = time.perf_counter()
    params = models.init_params(mcfg, seed=0, device=dev)
    params = qat.calibrate_weight_scales(
        params, P["parse_policy"]("A8d-C8-W4"), method="lsq")
    eng = paged_engine(P, mcfg, params, dev)
    del params
    eng.params = qat.drop_exported_weights(eng.params)
    torch.cuda.synchronize()
    check(all("w" in lay["moe"][b] and "w4a8" not in lay["moe"][b]
              and "w4a8" in lay["moe"]["router"]
              for lay in eng.params["layers"] for b in ("wg", "wu", "wd")),
          "moonshot: the served tree's banks are packed or gone")
    return eng, time.perf_counter() - t0


def ms_step_logits(torch, P, mcfg, params, dev):
    """(b) and (c): on a paged state with prefix hits, COW and
    tail-waves behind it, one decode step through the kernels (its
    launches counted: 48 paged decode, 144 fake-quant, no dense decode)
    and through the plain versions from the same cache. Held to
    LOGIT_REL_TOL on every row routed to the same experts in every
    layer; a row routed otherwise must owe it to a near tie
    (``route_flips``)."""
    models, blocks = P["models"], P["blocks"]
    eng = paged_engine(P, mcfg, params, dev)
    for r in shared_prefix_requests(P, mcfg, 2 * SLOTS, 300, seed=13):
        eng.submit(r)
    for _ in range(64):          # until a full slate decodes after a COW
        eng.step()
        if (len(eng._slot_req) == SLOTS and not eng._tail_jobs
                and eng.stats()["cow_copies"] > 0):
            break
    st = eng.stats()
    check(len(eng._slot_req) == SLOTS and st["cow_copies"] > 0
          and st["tail_waves"] > 0,
          f"moonshot logit state lacks residents, COW or tail-waves: {st}")
    eng._ensure_decode_blocks()
    tokens = eng.state["tokens"]
    counted = {**counted_kernels(P),
               "fake_quant_fwd": P["fq_ops"].fake_quant_fwd}
    for fn in counted.values():
        fn.launches = 0
    with RouteLog(blocks) as rk:
        lk, _ = models.decode_step(mcfg, eng.params, eng.ctx, tokens,
                                   models.clone_cache(eng.state["cache"]))
    step = {n: fn.launches for n, fn in counted.items()}
    with RouteLog(blocks) as rp:
        lp, _ = models.decode_step(mcfg, eng.params,
                                   replace(eng.ctx, kernel_backend="ref"),
                                   tokens,
                                   models.clone_cache(eng.state["cache"]))
    for fn in counted.values():
        fn.launches = 0
    del eng
    torch.cuda.empty_cache()
    L = mcfg.n_layers
    want = {"kvq_paged_decode_attn": L, "fake_quant_fwd": 3 * L,
            "kvq_decode_attn": 0, "kvq_spec_verify_attn": 0,
            "gather_dequant_paged_kv": 0, "pool_block_copy": 0}
    check(all(step[n] == v for n, v in want.items())
          and step["w4a8_matmul"] > 0,
          f"moonshot: one decode step launched {step}, want {want} and "
          f"w4a8_matmul > 0")
    lk, lp = lk.float()[:, 0], lp.float()[:, 0]
    check(bool(torch.isfinite(lk).all()), "moonshot logits not finite")
    flips = route_flips(torch, rk, rp, mcfg.n_experts_active)
    same = [r for r in range(lk.shape[0]) if r not in flips]
    rel = {r: float(torch.linalg.vector_norm(lk[r] - lp[r])
                    / torch.linalg.vector_norm(lp[r])) for r in range(
                        lk.shape[0])}
    check(all(rel[r] <= LOGIT_REL_TOL for r in same),
          f"moonshot: paged decode logits, kernels vs plain, relative L2 "
          f"per row {rel} > {LOGIT_REL_TOL} on rows routed alike {same}")
    check(all(f["explained"] for f in flips.values()),
          f"moonshot: routing differs between kernels and plain away from "
          f"a near tie: {flips}")
    return {"launches_one_decode_step": step, "rel_l2_per_row": rel,
            "rows_routed_differently": {str(r): f
                                        for r, f in flips.items()},
            "argmax_agreement": float((lk.argmax(-1) == lp.argmax(-1))
                                      .float().mean())}


MS_SPEC_NEW = 8        # new tokens a request of phase 3j's spec serve
CUT_NEW = 16           # new tokens a request in phases 3j, 3k and 3l (half
                       # of MAX_NEW: the script's time limit)


def serve_ms(torch, P, dev, report):
    """Phase 3j: moonshot-v1-16b-a3b at full width and depth (48 layers,
    64 experts top 6) on the paged pool: A8d-C8-W4, w4a8 weights
    (``ms_served_tree``), 4 slots, blocks of 64, prefix cache on. (a) 8
    requests sharing a 160-token prefix, CUT_NEW new tokens each: prefix
    hits, COW and tail-waves,
    every request finished, tokens in the vocabulary; paged decode 48
    launches a decode step, fake-quant 3 a ``moe_fwd`` call (48 a
    forward), one multi-leaf copy a COW, the gather and w4a8 launched,
    no dense decode, verify, flash or scan; (b)-(c) one decode step's
    launches and logits, kernels vs plain (``ms_step_logits``); (d) a
    tail-wave row bitwise alone and beside a deeper row through a layer's
    attention and MoE; (e) speculative decoding at the CLI's defaults
    (k 4, a 24-layer draft) on 4 of (a)'s requests, MS_SPEC_NEW new
    tokens each: every request
    finished, the verify kernel
    launched and paged decode not, the accept rate and the share of
    verify-wave (token, slot) pairs dropped at capacity (one slot an
    expert at C 5); streams are not held to (a)'s (the verify-wave's
    capacity drops pairs decode keeps); (f) each expert's share of
    (a)'s kept pairs, decode tok/s, TTFT, peak memory."""
    blocks = P["blocks"]
    mcfg = P["get_config"](MS)
    L = mcfg.n_layers
    torch.cuda.reset_peak_memory_stats(dev)
    eng, setup_s = ms_served_tree(torch, P, mcfg, dev)
    params = eng.params
    ops = P["kvq_ops"]
    counted = {**counted_kernels(P),
               "pool_block_copy_one_leaf": ops.copy_pool_blocks,
               "flash_attn_fwd": P["fa_ops"].flash_attn_fwd,
               "slstm_scan": P["slstm_ops"].slstm_scan,
               "fake_quant_fwd": P["fq_ops"].fake_quant_fwd,
               "fake_quant_bwd": P["fq_ops"].fake_quant_bwd}
    cow_events = []
    apply_cow = eng._apply_cow

    def counted_cow(pairs):
        cow_events.append(len(pairs))
        return apply_cow(pairs)

    eng._apply_cow = counted_cow
    reqs = shared_prefix_requests(P, mcfg, 2 * SLOTS, 200, seed=14)
    for r in reqs:
        r.max_new_tokens = CUT_NEW
        eng.submit(r)
    with RouteCounts(torch, blocks, mcfg.n_experts, dev) as rc:
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        stats = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counted.items()}
    del eng._apply_cow
    check_streams(mcfg, reqs, "moonshot paged serve", n=CUT_NEW)
    check(stats["prefix_hit_blocks"] > 0 and stats["cow_copies"] > 0
          and stats["tail_waves"] > 0,
          f"moonshot: no prefix hit, COW or tail-wave: {stats}")
    check(launches["kvq_paged_decode_attn"] == L * stats["decode_steps"],
          f"moonshot: {launches['kvq_paged_decode_attn']} paged decode "
          f"launches over {stats['decode_steps']} decode steps, want {L} "
          f"a step")
    check(launches["fake_quant_fwd"] == 3 * rc.calls > 0
          and rc.calls % L == 0,
          f"moonshot: {launches['fake_quant_fwd']} fake_quant_fwd launches "
          f"over {rc.calls} moe_fwd calls, want 3 a call ({L} calls a "
          f"forward)")
    check(launches["w4a8_matmul"] > 0
          and launches["gather_dequant_paged_kv"] > 0
          and launches["pool_block_copy"] == len(cow_events) > 0
          and sum(cow_events) == stats["cow_copies"],
          f"moonshot: w4a8, gather or COW launches off: {launches}, COW "
          f"events {cow_events}")
    others = ("kvq_decode_attn", "kvq_spec_verify_attn",
              "pool_block_copy_one_leaf", "flash_attn_fwd", "slstm_scan",
              "fake_quant_bwd")
    check(all(launches[n] == 0 for n in others),
          f"moonshot: another kernel ran: {launches}")
    check(stats["free_blocks"] == eng.num_blocks,
          "moonshot: blocks leaked after the drain")
    decode_tokens = stats["tokens_out"] - len(reqs)
    served = {"arch": MS, "layers": L, "setup_s": setup_s,
              "requests": len(reqs), "tokens_out": stats["tokens_out"],
              "wall_s": wall, "tokens_per_s": stats["tokens_out"] / wall,
              "decode_tokens_per_s": decode_tokens / stats["decode_s"],
              "decode_step_ms": 1e3 * stats["decode_step_s"],
              "decode_steps": stats["decode_steps"],
              "ttft_p50_s": stats["ttft_p50_s"],
              "ttft_p95_s": stats["ttft_p95_s"],
              "prefill_s": stats["prefill_s"],
              "tail_waves": stats["tail_waves"],
              "prefix_hit_blocks": stats["prefix_hit_blocks"],
              "cow_copies": stats["cow_copies"],
              "cow_events": len(cow_events), "moe_fwd_calls": rc.calls,
              "routing": rc.shares(), "launches": launches,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    report["serve_ms"] = served
    print("serve_ms " + json.dumps(served), flush=True)
    del eng
    torch.cuda.empty_cache()
    served["step"] = ms_step_logits(torch, P, mcfg, params, dev)
    print(f"phase 3j: moonshot one paged decode step: {served['step']}",
          flush=True)
    check_tail_rows(torch, P, mcfg, dev, params, report, ffn=True,
                    report_key="ms_tail_row_invariant", phase="phase 3j")

    tracer = P["Tracer"](capacity=1 << 16)
    eng = paged_engine(P, mcfg, params, dev, spec=P["SpecConfig"](k=SPEC_K),
                       trace=tracer)
    check(eng.spec.resolved_layers(mcfg) == L // 2,
          "moonshot spec: the default draft is not half the layers")
    # one slate of (a)'s requests: every wave drafts 4 tokens through 24
    # layers whose banks are fake-quantized on every forward
    sreqs = shared_prefix_requests(P, mcfg, 2 * SLOTS, 200, seed=14)[:SLOTS]
    for r in sreqs:
        r.max_new_tokens = MS_SPEC_NEW
    with RouteCounts(torch, blocks, mcfg.n_experts, dev,
                     window=SPEC_C) as vc:
        stats, slaunches, swall = drive(torch, P, eng, sreqs)
    check_streams(mcfg, sreqs, "moonshot spec", n=MS_SPEC_NEW)
    check(slaunches["kvq_spec_verify_attn"] > 0
          and slaunches["kvq_paged_decode_attn"] == 0
          and slaunches["kvq_decode_attn"] > 0,
          f"moonshot spec: verify must launch, paged decode not, the "
          f"draft's dense decode must: {slaunches}")
    check(stats["free_blocks"] == eng.num_blocks,
          "moonshot spec: blocks leaked after the drain")
    spec = spec_summary(stats, sreqs, swall, slaunches, tracer)
    spec["verify_routing"] = vc.shares()
    spec["streams_differing_from_plain"] = [
        r.uid for r, p in zip(sreqs, reqs)
        if r.generated != p.generated[:MS_SPEC_NEW]]
    report["serve_ms_spec"] = spec
    print("serve_ms_spec " + json.dumps(spec), flush=True)
    del eng, params
    torch.cuda.empty_cache()
    print(f"phase 3j: moonshot-v1-16b-a3b (48 layers, paged) "
          f"{served['decode_tokens_per_s']:.2f} decode tok/s, "
          f"{served['decode_step_ms']:.2f} ms a decode step, TTFT p50 "
          f"{served['ttft_p50_s']:.3f} s, peak "
          f"{served['peak_memory_bytes'] / 1e9:.1f} GB; spec accept rate "
          f"{spec['spec_accept_rate']:.3f}, verify pairs dropped at "
          f"capacity {spec['verify_routing']['dropped_share']:.3f}",
          flush=True)
    return launches, slaunches


def dense_requests(P, cfg, uid0=0, max_new=MAX_NEW):
    """8 requests of three lengths (DENSE_SERVE_LENS); every fourth
    samples (temperature 0.8, top-k 8)."""
    import numpy as np
    rng = np.random.default_rng(21)
    return [P["Request"](
        uid=uid0 + i, prompt=rng.integers(0, cfg.vocab_size, n).astype(
            np.int32), max_new_tokens=max_new,
        temperature=0.8 if i % 4 == 3 else 0.0,
        top_k=8 if i % 4 == 3 else 0, seed=i)
        for i, n in enumerate(DENSE_SERVE_LENS)]


def one_step_vs_plain(torch, P, cfg, params, ctx, batch, cache_len):
    """One decode step after a prefill of ``batch``, through the kernels
    and through the plain versions from the same cache: (relative L2,
    argmax agreement)."""
    models = P["models"]
    logits, cache = models.prefill(cfg, params, ctx, batch,
                                   cache_budget=cache_len)
    tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
    lk, _ = models.decode_step(cfg, params, ctx, tok,
                               models.clone_cache(cache))
    lp, _ = models.decode_step(cfg, params,
                               replace(ctx, kernel_backend="ref"), tok,
                               models.clone_cache(cache))
    check(bool(torch.isfinite(lk.float()).all()),
          f"{cfg.name}: decode logits not finite")
    rel, agree = logit_gap(torch, lk, lp)
    check(rel <= LOGIT_REL_TOL,
          f"{cfg.name}: decode logits, kernels vs plain, relative L2 {rel} "
          f"> {LOGIT_REL_TOL}")
    return rel, agree


def decode_logits_vs_plain(torch, P, cfg, eng, dev):
    """One decode step after a padded prefill wave of the first SLOTS
    prompts of ``dense_requests``, through the kernels and through the
    plain versions from the same cache: (relative L2, argmax
    agreement)."""
    prompts = [r.prompt for r in dense_requests(P, cfg)[:SLOTS]]
    L = int(math.ceil(max(len(p) for p in prompts) / 16) * 16)
    toks = torch.zeros((SLOTS, L), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.from_numpy(p).to(dev)
    batch = {"tokens": toks, "lengths": torch.tensor(
        [len(p) for p in prompts], dtype=torch.int32, device=dev)}
    out = one_step_vs_plain(torch, P, cfg, eng.params, eng.ctx, batch,
                            PAGED_TOKENS)
    torch.cuda.empty_cache()
    return out


def serve_cut(torch, P, dev, report, arch, n_layers, key, phase,
              paged=False):
    """Phases 3k and 3l: ``arch`` at full width and ``n_layers`` layers
    (random weights, scales LSQ-initialised), A8d-C8-W4, w4a8 weights
    (the bf16 linears dropped), 4 slots, cache_len 512: one decode step's
    logits kernels vs plain; 8 requests of three lengths on the dense
    layout (dense decode a layer a decode step, w4a8 launched, no other
    kernel); with ``paged``, the same requests on the paged pool (blocks
    of 64, prefix cache off, one prefill window: a cold prefill, as the
    dense engine's), paged decode a layer a step, and every stream equal
    to the dense engine's. Decode tok/s, TTFT, peak memory."""
    qat, models = P["qat"], P["models"]
    cfg = P["get_config"](arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=0, device=dev)
    params = qat.calibrate_weight_scales(
        params, P["parse_policy"]("A8d-C8-W4"), method="lsq")
    eng = paged_engine(P, cfg, params, dev, kv_layout="dense")
    del params
    eng.params = qat.drop_exported_weights(eng.params)
    params = eng.params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rel, agree = decode_logits_vs_plain(torch, P, cfg, eng, dev)
    counted = {**counted_kernels(P),
               "fake_quant_fwd": P["fq_ops"].fake_quant_fwd,
               "flash_attn_fwd": P["fa_ops"].flash_attn_fwd}
    out = {"arch": arch, "layers": L, "setup_s": setup_s,
           "decode_logits_rel_l2": rel, "decode_logits_argmax": agree}
    streams = {}
    for layout in ("dense", "paged") if paged else ("dense",):
        if layout == "paged":
            eng = paged_engine(P, cfg, params, dev, prefix_cache=False,
                               prefill_chunk=PAGED_TOKENS)
        reqs = dense_requests(P, cfg, max_new=CUT_NEW)
        for r in reqs:
            eng.submit(r)
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        stats = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counted.items()}
        check_streams(cfg, reqs, f"{arch} {layout} serve", n=CUT_NEW)
        kern = ("kvq_paged_decode_attn" if layout == "paged"
                else "kvq_decode_attn")
        check(launches[kern] == L * stats["decode_steps"]
              and launches["w4a8_matmul"] > 0
              and all(v == 0 for n, v in launches.items()
                      if n not in (kern, "w4a8_matmul")),
              f"{arch} {layout}: launches {launches} over "
              f"{stats['decode_steps']} decode steps, want {kern} {L} a "
              f"step, w4a8_matmul > 0, nothing else")
        streams[layout] = [r.generated for r in reqs]
        decode_tokens = stats["tokens_out"] - len(reqs)
        out[layout] = {
            "requests": len(reqs), "prompt_lens": list(DENSE_SERVE_LENS),
            "tokens_out": stats["tokens_out"], "wall_s": wall,
            "decode_tokens_per_s": decode_tokens / stats["decode_s"],
            "decode_step_ms": 1e3 * stats["decode_step_s"],
            "decode_steps": stats["decode_steps"],
            "ttft_p50_s": stats["ttft_p50_s"],
            "ttft_p95_s": stats["ttft_p95_s"],
            "prefill_s": stats["prefill_s"], "launches": launches,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
        report[f"{key}_{layout}"] = out[layout]
        del eng
        torch.cuda.empty_cache()
    if paged:
        differ = [i for i, (a, b) in enumerate(zip(streams["dense"],
                                                   streams["paged"]))
                  if a != b]
        out["paged_streams_differing"] = differ
        check(not differ, f"{arch}: paged streams differ from dense for "
                          f"requests {differ}")
    report[key] = out
    print(f"{phase}: " + json.dumps(out), flush=True)
    del params
    torch.cuda.empty_cache()
    return out


def time_new(torch, P, dev, report):
    """Phase 4 at this slice's shapes: fake_quant_fwd and _bwd per
    64-expert bank in mode 3 and per moonshot decode step (144 forward
    launches) beside the plain versions, one PyTorch call and mode 1 on
    the same bytes; moonshot's MoE layer of a decode step by parts; the
    paged decode launch at G 1 (moonshot, 16 KV heads) and the dense one
    at G 8 (qwen3-32b) beside SDPA; flash at G 1 and G 5 (qwen3-14b) at
    (8, 128) beside SDPA; w4a8_matmul per decode step of qwen3-32b (48
    layers) beside bf16 ``torch.matmul``."""
    ms, q32 = P["get_config"](MS), P["get_config"](Q32)
    q14 = P["get_config"](Q14)
    gen = torch.Generator(device=dev)
    gen.manual_seed(55)
    banks = [time_bank(torch, P, *shape, 4, dev, gen) for shape in MS_BANKS]
    L = ms.n_layers
    step = bank_step(banks, L)
    split = mx_moe_split(torch, P, ms, dev)

    def make():
        return paged_inputs(torch, gen, ms, PAGED_BS[0], PAGED_LENGTHS, dev)

    paged = time_paged_launch(torch, P, ms, "paged_decode", make(), make)
    dense = time_dense_launch(torch, P, q32, dev, gen, KVQ_LENGTHS,
                              CACHE_LEN, False)
    fl1 = time_flash_launch(torch, P, ms, dev, gen, TRAIN_B, TRAIN_T, 10)
    fl5 = time_flash_launch(torch, P, q14, dev, gen, TRAIN_B, TRAIN_T, 10)
    w4 = w4a8_step_times(
        torch, P, linear_shapes(q32.replace(n_layers=Q32_SERVE_LAYERS)),
        dev, gen)
    out = {"banks": banks, "fake_quant_fwd_decode_step": step,
           "moe_decode_layer_split_ms": split,
           "paged_decode_launch_g1": paged,
           "paged_decode_step_g1": per_step(paged, L),
           "dense_decode_launch_g8": dense,
           "flash_launch_g1": fl1, "flash_launch_g5": fl5,
           "flash_teacher_forward_g1": per_step(fl1, MS_TRAIN_LAYERS),
           "flash_teacher_forward_g5": per_step(fl5, Q14_TRAIN_LAYERS),
           "w4a8_decode_step_qwen3_32b": w4}
    report["new_times"] = out
    for b in banks:
        print(f"phase 4: moonshot bank {b['shape']}: fake_quant_fwd "
              f"{b['fwd_ms']:.4f} ms (mode 1 on the same bytes "
              f"{b['mode1_fwd_ms']:.4f}, bound {b['fwd_bound_ms']:.4f}, "
              f"plain {b['fwd_plain_ms']:.3f}, library "
              f"{b['fwd_library_ms']:.3f}); fake_quant_bwd "
              f"{b['bwd_ms']:.4f} ms (mode 1 {b['mode1_bwd_ms']:.4f}, bound "
              f"{b['bwd_bound_ms']:.4f}, plain {b['bwd_plain_ms']:.3f}, "
              f"library {b['bwd_library_ms']:.3f})", flush=True)
    print(f"phase 4: moonshot decode step: fake_quant_fwd {step}; MoE layer "
          f"by parts {split}; kvq_paged_decode_attn at G 1 per launch "
          f"{paged['ms'] * 1e3:.2f} us (SDPA {paged['library_ms'] * 1e3:.2f}"
          f" us, gqa {paged['library_gqa_ms'] * 1e3:.2f} us, bound "
          f"{paged['bound_ms'] * 1e3:.2f} us); kvq_decode_attn at G 8 "
          f"{dense['ms'] * 1e3:.2f} us (SDPA gqa "
          f"{dense['library_ms'] * 1e3:.2f} us); flash G 1 "
          f"{fl1['ms'] * 1e3:.2f} us (SDPA {fl1['library_ms'] * 1e3:.2f} "
          f"us), G 5 {fl5['ms'] * 1e3:.2f} us (SDPA "
          f"{fl5['library_ms'] * 1e3:.2f} us); w4a8 per qwen3-32b decode "
          f"step {w4}", flush=True)
    return out


# --------------------------------------------------------------------------
# whisper-large-v3 (the encoder-decoder) and qwen2-vl-2b (the M-RoPE VLM)
# --------------------------------------------------------------------------

WH, VL = "whisper-large-v3", "qwen2-vl-2b"
# both at full width and depth: whisper's 32 encoder and 32 decoder layers
# (1.58 B parameters, 3.2 GB in bf16) and qwen2-vl's 28 (1.54 B)
WH_PROMPTS = (4, 96)           # decoder prompts of the two waves of 4
WH_CACHE_LEN = 160
WH_XLENS = (1500, 0, 1, 777)   # cross-cache rows: full, empty, ragged
WH_TRAIN_B = 4                 # x T 128 decoder tokens over 1500 frames
VL_GRID, VL_TEXT = 16, 64      # 256 patches on a 16 x 16 grid, 64 tokens
VL_CACHE_LEN = 384
VL_TRAIN_S = 384               # 256 patches + T 128 text tokens, B 8
# flash without causality: (B, Sq, Skv); the encoder, the cross-attention
# of a QAT step, and query / key counts ragged against the 128-query and
# 32-key tiles
WV_FLASH_X = ((4, 1500, 1500), (4, 128, 1500)) + tuple(
    (2, sq, skv) for sq in (1, 128, 1500) for skv in (1, 65, 1500)
    if (sq, skv) != (1500, 1500))


def wv_cfgs(P):
    return P["get_config"](WH), P["get_config"](VL)


def wv_linear_shapes(P):
    """(name, K, N, bias) of every distinct packed linear of the two
    archs: whisper's attention (self and cross) at d 1280, its GELU MLP
    with biases, its tied head at N 51866 (N % 64 = 26: a partial last
    column tile); qwen2-vl's q, k, v with biases (k and v at N 256), o,
    its SwiGLU MLP and its tied head at N 151936."""
    wh, vl = wv_cfgs(P)
    d, f = wh.d_model, wh.d_ff
    out = [("whisper q/k/v/o", d, d, False), ("whisper w1", d, f, True),
           ("whisper w2", f, d, True),
           ("whisper head", d, wh.vocab_size, False)]
    d, f = vl.d_model, vl.d_ff
    return out + [("qwen2-vl q", d, d, True), ("qwen2-vl k/v", d, vl.kv_dim,
                                                True),
                  ("qwen2-vl o", d, d, False), ("qwen2-vl gate/up", d, f,
                                                False),
                  ("qwen2-vl down", f, d, False),
                  ("qwen2-vl head", d, vl.vocab_size, False)]


def wv_fq_cases(P):
    """(site, R, C, mode, offset) of the two archs' weights: per output
    channel (mode 1), the tied heads per vocab row (mode 2)."""
    wh, vl = wv_cfgs(P)
    out = []
    for c in (wh, vl):
        d, f = c.d_model, c.d_ff
        out += [(f"{c.name} {n}", R, C, 1, 0) for n, R, C in (
            ("wq", d, c.q_dim), ("wk", d, c.kv_dim), ("up", d, f),
            ("down", f, d))]
        out.append((f"{c.name} head", c.vocab_size, d, 2, 0))
    return out


def check_wv_kernels(torch, P, dev, report):
    """Phase 2 at the two archs' shapes: w4a8_matmul bitwise on every
    new packed linear at M 1, 4, 23, 24 and 512 by each route, and the
    encoder's linears at M 6000 (4 x 1500 frames); the split-KV checks
    (``check_decode_case``: dense decode within one ulp, bitwise paged
    decode, each row alone, verify, gather) at D 64, G 1 (whisper) over
    4 full 1500-row cross caches, ragged rows with an empty one and
    around the split boundaries, and at D 128, G 6 (qwen2-vl); flash
    without causality at the encoder's (4, 1500) and the cross shape
    (Sq 128, Skv 1500) and ragged Sq / Skv, and causal at G 6 (8, 384),
    against plain and the f64 oracle; fake-quant fwd and dx bitwise on
    the new weights. Returns the worst error per kernel."""
    wh, vl = wv_cfgs(P)
    shapes = wv_linear_shapes(P)
    n_w4 = check_w4a8_linears(torch, P, shapes, dev, 61)
    n_w4 += check_w4a8_linears(torch, P, shapes[:3], dev, 62,
                               ms=(4 * wh.encoder_seq,))
    gen = torch.Generator(device=dev)
    gen.manual_seed(63)
    split = split_lengths(P)
    cases, worst = [], {}
    for c, lengths, S, what in (
            (wh, (wh.encoder_seq,) * SLOTS, wh.encoder_seq,
             "whisper cross cache D64 G1"),
            (wh, WH_XLENS, wh.encoder_seq, "whisper D64 G1 ragged"),
            (wh, split, max(split), "whisper D64 G1 split boundaries"),
            (vl, KVQ_LENGTHS, CACHE_LEN, "qwen2-vl D128 G6"),
            (vl, split, max(split), "qwen2-vl D128 G6 split boundaries")):
        errs = check_decode_case(torch, P, gen, c, dev, lengths, S, False,
                                 what)
        cases.append({"case": what, "lengths": list(lengths), "S": S,
                      **errs})
        for k, e in errs.items():
            worst[k] = max(worst.get(k, 0.0), e)
        torch.cuda.empty_cache()
    flash = [check_flash_case(torch, P, gen, wh, dev, B, Sq, 0, Skv=Skv,
                              causal=False) for B, Sq, Skv in WV_FLASH_X]
    flash.append(check_flash_case(torch, P, gen, vl, dev, TRAIN_B,
                                  VL_TRAIN_S, 0))
    worst["flash_attn_fwd"] = max(c["max_abs_err"] for c in flash)
    torch.cuda.empty_cache()
    n_fq, fq_ds = fq_case_checks(torch, P, gen, wv_fq_cases(P), dev)
    out = {"w4a8_cases": n_w4, "decode": cases, "flash": flash,
           "fake_quant_cases": n_fq, "fake_quant_ds_rel_mass_err": fq_ds}
    report["wv_kernel_cases"] = out
    print(f"phase 2: whisper and qwen2-vl shapes: w4a8_matmul bitwise on "
          f"{n_w4} cases (N 51866, M 6000 included); at D 64 G 1 and D 128 "
          f"G 6 kvq_decode_attn within one ulp and bitwise paged decode, "
          f"verify queries bitwise paged decode, the gather bitwise: "
          f"{cases}; flash non-causal and at G 6: {flash}; fake-quant fwd "
          f"and dx bitwise on {n_fq} cases (ds within {fq_ds:.3g} of its "
          f"mass)", flush=True)
    return worst


def served_tree(torch, P, cfg, dev):
    """Random weights from seed 0, scales LSQ-initialised, the w4a8
    exports attached and the bf16 linears dropped."""
    qat, pol = P["qat"], P["parse_policy"]("A8d-C8-W4")
    params = P["models"].init_params(cfg, seed=0, device=dev)
    params = qat.calibrate_weight_scales(params, pol, method="lsq")
    params = qat.drop_exported_weights(qat.attach_w4a8_exports(params, pol))
    torch.cuda.synchronize()
    return params


def generate(torch, P, cfg, params, ctx, batch, cache_len, counted):
    """Greedy: prefill ``batch`` (cache_len rows a slot), then MAX_NEW - 1
    decode steps. Each phase's launches counted from 0. Returns (tokens
    (B, MAX_NEW), {"ttft_s", "decode_s", "steps", "prefill_launches",
    "decode_launches"})."""
    models = P["models"]
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = models.prefill(cfg, params, ctx, batch,
                                   cache_budget=cache_len)
    tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
    out = [tok]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pre = {n: fn.launches for n, fn in counted.items()}
    for fn in counted.values():
        fn.launches = 0
    for _ in range(MAX_NEW - 1):
        logits, cache = models.decode_step(cfg, params, ctx, tok, cache)
        tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    toks = torch.cat(out, dim=1)
    del cache
    return toks, {"ttft_s": t1 - t0, "decode_s": t2 - t1,
                  "steps": MAX_NEW - 1, "prefill_launches": pre,
                  "decode_launches": {n: fn.launches
                                      for n, fn in counted.items()}}


def check_launches(got, want, what):
    """Every counted kernel launched ``want[name]`` times (0 if absent)."""
    bad = {n: v for n, v in got.items() if v != want.get(n, 0)}
    check(not bad, f"{what}: launches {got}, want {want} (the others 0)")


def decode_busy_ms(torch, P, cfg, params, ctx, batch, cache_len):
    """Device busy ms of two decode steps after a prefill of ``batch``
    (``torch.profiler``'s CUDA kernel records) and their wall ms."""
    from torch.profiler import ProfilerActivity, profile
    models = P["models"]
    logits, cache = models.prefill(cfg, params, ctx, batch,
                                   cache_budget=cache_len)
    tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
    models.decode_step(cfg, params, ctx, tok, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            models.decode_step(cfg, params, ctx, tok, cache)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 2
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 2e3
    del cache
    if not busy:
        return {"device_busy_ms_per_step": "not measured: no device records"}
    return {"device_busy_ms_per_step": busy, "profiled_step_ms": wall,
            "device_idle_share": max(0.0, 1.0 - busy / wall)}


def wh_batch(torch, cfg, B, S, seed, dev):
    """Decoder tokens and each request's own 1500 bf16 frames."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                    device=dev, dtype=torch.int32),
            "frames": torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                  generator=gen, device=dev).to(
                                      torch.bfloat16)}


def serve_wh(torch, P, dev, report):
    """Phase 3m: whisper-large-v3 at full width and depth, A8d-C8-W4,
    w4a8 weights, through ``prefill`` and ``decode_step`` (no engine path
    supplies frames): two exact-length waves of 4 requests (decoder
    prompts of 4 and 96 tokens, each request its own 1500 frames), 32
    new tokens each, cache_len 160. A prefill launches 32 flash_attn_fwd
    (the encoder) and 513 w4a8_matmul (the encoder's 32 x 6 linears, the
    decoder's 32 x 10 and the head), a decode step 64 kvq_decode_attn
    (32 self, 32 over the frozen cross caches) and 257 w4a8_matmul (32 x
    8 and the head), nothing else. One decode step's logits kernels vs
    plain; a prompt prefilled alone and in its wave: self and cross
    caches and first logits bitwise; the logits move when only the
    frames change. Decode tok/s, ms a step, busy ms and idle share, TTFT
    (the encoder included), peak memory."""
    models, qat = P["models"], P["qat"]
    cfg = P["get_config"](WH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = served_tree(torch, P, cfg, dev)
    setup_s = time.perf_counter() - t0
    ctx = qat.make_ctx("A8d-C8-W4", weights_layout="w4a8")
    counted = {**counted_kernels(P),
               "fake_quant_fwd": P["fq_ops"].fake_quant_fwd,
               "flash_attn_fwd": P["fa_ops"].flash_attn_fwd}
    Le, L = cfg.encoder_layers, cfg.n_layers
    want_pre = {"flash_attn_fwd": Le, "w4a8_matmul": 6 * Le + 10 * L + 1}
    waves = [wh_batch(torch, cfg, SLOTS, n, 70 + i, dev)
             for i, n in enumerate(WH_PROMPTS)]
    out = {"arch": WH, "encoder_layers": Le, "layers": L,
           "params_total": cfg.param_counts()["total"], "setup_s": setup_s,
           "waves": []}
    for batch, n in zip(waves, WH_PROMPTS):
        toks, st = generate(torch, P, cfg, params, ctx, batch, WH_CACHE_LEN,
                            counted)
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"{WH}: a token outside the vocabulary")
        check_launches(st["prefill_launches"], want_pre, f"{WH} prefill")
        steps = st["steps"]
        check_launches(st["decode_launches"],
                       {"kvq_decode_attn": 2 * L * steps,
                        "w4a8_matmul": (8 * L + 1) * steps},
                       f"{WH} {steps} decode steps")
        out["waves"].append({
            "prompt_len": n, "requests": SLOTS, "new_tokens": MAX_NEW,
            "ttft_s": st["ttft_s"],
            "decode_step_ms": 1e3 * st["decode_s"] / steps,
            "decode_tokens_per_s": SLOTS * steps / st["decode_s"],
            "prefill_launches": st["prefill_launches"],
            "decode_launches_per_step": {
                k: v / steps for k, v in st["decode_launches"].items()}})
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    for fn in counted.values():
        fn.launches = 0
    rel, agree = one_step_vs_plain(torch, P, cfg, params, ctx, waves[1],
                                   WH_CACHE_LEN)
    out.update(decode_logits_rel_l2=rel, decode_logits_argmax=agree)
    out.update(decode_busy_ms(torch, P, cfg, params, ctx, waves[1],
                              WH_CACHE_LEN))

    # a prompt alone and in its wave of 4: caches and first logits bitwise
    def pre(batch):
        logits, cache = models.prefill(cfg, params, ctx, batch,
                                       cache_budget=WH_CACHE_LEN)
        return logits[0], cache["layers"]

    la, ca = pre({k: v[:1] for k, v in waves[1].items()})
    lw, cw = pre(waves[1])
    differ = 0
    for a, b in zip(ca, cw):
        for part_a, part_b in ((a, b), (a["cross"], b["cross"])):
            differ += sum(int((part_a[k][0] != part_b[k][0]).sum())
                          for k in ("k_q", "v_q", "s_k", "s_v"))
    out["alone_vs_wave"] = {"logits_bitwise": bool(torch.equal(la, lw)),
                            "cache_values_differing": differ}
    check(torch.equal(la, lw) and differ == 0,
          f"{WH}: a prompt's caches or first logits differ alone and in a "
          f"wave of 4: {out['alone_vs_wave']}")
    del ca, cw
    other = dict(waves[1], frames=waves[0]["frames"])
    lo, _ = pre(other)
    moved = float((lo.float() - lw.float()).abs().max())
    out["frames_move_logits_max_abs"] = moved
    check(moved > 1e-3, f"{WH}: the logits do not move with the frames "
                        f"({moved})")
    torch.cuda.empty_cache()
    report["serve_wh"] = out
    print("phase 3m: " + json.dumps(out), flush=True)
    del params
    torch.cuda.empty_cache()
    return out


def vl_positions(torch, B, grid, n_text, dev):
    """Qwen2-VL's position streams: the patches at t 0 and (h, w) their
    place on a ``grid`` x ``grid`` raster, the text from max + 1 on all
    three streams. (3, B, grid**2 + n_text)."""
    i = torch.arange(grid * grid, device=dev)
    text = grid + torch.arange(n_text, device=dev)
    pos = torch.stack([torch.cat([torch.zeros_like(i), text]),
                       torch.cat([i // grid, text]),
                       torch.cat([i % grid, text])])
    return pos[:, None].expand(3, B, pos.shape[1]).contiguous()


def vl_batch(torch, cfg, B, S, seed, dev):
    """Text tokens after ``vision_tokens`` bf16 patch embeddings, and
    Qwen2-VL's positions."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    grid = math.isqrt(cfg.vision_tokens)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                    device=dev, dtype=torch.int32),
            "patches": torch.randn((B, cfg.vision_tokens, cfg.d_model),
                                   generator=gen, device=dev).to(
                                       torch.bfloat16),
            "positions": vl_positions(torch, B, grid, S, dev)}


def serve_vl(torch, P, dev, report):
    """Phase 3n: qwen2-vl-2b at full width and depth, A8d-C8-W4, w4a8
    weights. (a) ``prefill`` and ``decode_step`` on 4 requests of 256
    patch embeddings + 64 text tokens at Qwen2-VL's positions, 32 new
    tokens: 197 w4a8_matmul a prefill, 28 kvq_decode_attn and 197
    w4a8_matmul a decode step, nothing else; one step's logits kernels
    vs plain; TTFT, tok/s, idle, peak. (b) the engine, text-only, on the
    pool with a 160-token shared prefix: prefix hits and COW, 28 paged
    decode launches a step; then (``serve_cut``) dense and paged from
    cold prefills, streams equal."""
    qat = P["qat"]
    cfg = P["get_config"](VL)
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = served_tree(torch, P, cfg, dev)
    setup_s = time.perf_counter() - t0
    ctx = qat.make_ctx("A8d-C8-W4", weights_layout="w4a8")
    counted = {**counted_kernels(P),
               "fake_quant_fwd": P["fq_ops"].fake_quant_fwd,
               "flash_attn_fwd": P["fa_ops"].flash_attn_fwd}
    batch = vl_batch(torch, cfg, SLOTS, VL_TEXT, 80, dev)
    toks, st = generate(torch, P, cfg, params, ctx, batch, VL_CACHE_LEN,
                        counted)
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{VL}: a token outside the vocabulary")
    steps = st["steps"]
    check_launches(st["prefill_launches"], {"w4a8_matmul": 7 * L + 1},
                   f"{VL} prefill")
    check_launches(st["decode_launches"],
                   {"kvq_decode_attn": L * steps,
                    "w4a8_matmul": (7 * L + 1) * steps},
                   f"{VL} {steps} decode steps")
    out = {"arch": VL, "layers": L, "setup_s": setup_s,
           "params_total": cfg.param_counts()["total"],
           "requests": SLOTS, "patches": cfg.vision_tokens,
           "text_tokens": VL_TEXT, "new_tokens": MAX_NEW,
           "ttft_s": st["ttft_s"],
           "decode_step_ms": 1e3 * st["decode_s"] / steps,
           "decode_tokens_per_s": SLOTS * steps / st["decode_s"],
           "prefill_launches": st["prefill_launches"],
           "decode_launches_per_step": {
               k: v / steps for k, v in st["decode_launches"].items()},
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    rel, agree = one_step_vs_plain(torch, P, cfg, params, ctx, batch,
                                   VL_CACHE_LEN)
    out.update(decode_logits_rel_l2=rel, decode_logits_argmax=agree)
    out.update(decode_busy_ms(torch, P, cfg, params, ctx, batch,
                              VL_CACHE_LEN))
    eng = paged_engine(P, cfg, params, dev)
    reqs = shared_prefix_requests(P, cfg, 8, 300, 81)
    stats, launches, wall = drive(torch, P, eng, reqs)
    check_streams(cfg, reqs, f"{VL} paged shared-prefix serve")
    check(stats["prefix_hit_tokens"] > 0 and stats["cow_copies"] > 0
          and launches["kvq_paged_decode_attn"] == L * stats["decode_steps"]
          and launches["kvq_decode_attn"] == 0
          and launches["pool_block_copy"] == stats["cow_copies"]
          and launches["gather_dequant_paged_kv"] > 0,
          f"{VL} paged: stats {stats}, launches {launches}")
    out["paged_shared_prefix"] = {
        "requests": len(reqs), "tokens_out": stats["tokens_out"],
        "wall_s": wall, "prefix_hit_tokens": stats["prefix_hit_tokens"],
        "cow_copies": stats["cow_copies"], "tail_waves": stats["tail_waves"],
        "decode_tokens_per_s": (stats["tokens_out"] - len(reqs))
        / stats["decode_s"], "ttft_p50_s": stats["ttft_p50_s"],
        "launches": launches}
    del eng, params
    torch.cuda.empty_cache()
    report["serve_vl"] = out
    print("phase 3n: " + json.dumps(out), flush=True)
    out["engines"] = serve_cut(torch, P, dev, report, VL, 0, "serve_vl_engine",
                               "phase 3n", paged=True)
    return out


def encdec_train_flops(cfg, B, T):
    """``train_flops`` for an encoder-decoder: the decoder's T tokens
    through self-attention, the cross-attention's q and o, the GELU MLP
    (two matrices) and the head; the encoder's ``encoder_seq`` frames
    through its layers and the cross-attention's k and v; attention over
    every (query, key) pair of the encoder, the decoder and the cross
    products."""
    d, f, qd, kvd = cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim
    L, Le, Te = cfg.n_layers, cfg.encoder_layers, cfg.encoder_seq
    dec = L * (2 * d * qd + 2 * d * kvd + 2 * d * f + 2 * d * qd) \
        + d * cfg.vocab_size
    enc = Le * (2 * d * qd + 2 * d * kvd + 2 * d * f) + L * 2 * d * kvd
    attn = 4 * B * qd * (L * T * T + L * T * Te + Le * Te * Te)
    return 8 * (dec * B * T + enc * B * Te) + 4 * attn


def train_direct(torch, P, dev, report, arch, B, T, key, phase):
    """Phases 6f and 6g: ``make_train_step`` at full width and depth
    (``run_qat``'s batches carry no frames or patches): random teacher
    weights from seed 0, the student MSE-calibrated, A8d-C8-W4, 2 steps
    at B x T (whisper: T decoder tokens over each row's 1500 frames,
    every layer checkpointed, the encoder's included; qwen2-vl: T text
    tokens after 256 patches, the loss on the text). Per step one
    fake_quant_fwd and _bwd per weight site (whisper 32 x 6 + 32 x 10 +
    1, qwen2-vl 28 x 7 + 1; whisper's checkpointed layers fake-quantize
    their weights again in the backward: 2 x 512 + 1 forward launches)
    and one flash_attn_fwd per teacher attention (whisper: encoder, self
    and cross, 96; qwen2-vl 28);
    every s_w moved, losses finite, no NaN; step split, tokens/s, peak,
    idle share, model-FLOPs share."""
    qat, steps_mod = P["qat"], P["steps"]
    cfg = P["get_config"](arch)
    encdec = cfg.is_encdec
    tcfg = P["TrainConfig"](precision="A8d-C8-W4", total_steps=MX_TRAIN_STEPS,
                            ref_steps=MX_TRAIN_STEPS, batch_size=B,
                            seq_len=T, remat="block" if encdec else "none")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    teacher = P["models"].init_params(cfg, seed=0, device=dev)
    student = P["train"]._trainable(qat.calibrate_weight_scales(
        P["tree_map"](lambda t: t.detach().clone(), teacher),
        P["parse_policy"](tcfg.precision), method="mse"))
    opt = P["adamw_init"](student)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    it = P["MixtureIterator"](P["SyntheticConfig"](
        vocab_size=cfg.vocab_size, seq_len=T, batch_size=B), start_step=1)

    def batch_of(i):
        b = P["to_device"](next(it), dev)
        extra = (wh_batch if encdec else vl_batch)(torch, cfg, B, T, 90 + i,
                                                   dev)
        b.update({k: v for k, v in extra.items() if k != "tokens"})
        return b

    step_fn = steps_mod.make_train_step(cfg, tcfg, split_times=True)
    w0 = {k: t.detach().clone() for k, t in _named_leaves(student)
          if k.endswith("s_w")}
    n_w = (6 * cfg.encoder_layers + 10 * cfg.n_layers + 1 if encdec
           else 7 * cfg.n_layers + 1)
    # a checkpointed layer's forward runs again in the backward, so its
    # weights are fake-quantized twice a step (the head, outside, once)
    n_fwd = n_w + (n_w - 1 if tcfg.remat != "none" else 0)
    n_fa = (cfg.encoder_layers + 2 * cfg.n_layers if encdec
            else cfg.n_layers)
    names = ("fake_quant_fwd", "fake_quant_bwd", "flash_attn_fwd",
             "slstm_scan")
    steps = []
    for i in range(MX_TRAIN_STEPS):
        batch = batch_of(i)
        for fn in train_counters(P):
            fn.launches = 0
        student, opt, metrics = step_fn(student, teacher, opt, batch, i)
        launches = [fn.launches for fn in train_counters(P)]
        steps.append({"step": i, "loss": float(metrics["loss"]),
                      "ms": metrics["ms"], "launches": launches})
        check(launches == [n_fwd, n_w, n_fa, 0],
              f"{arch} QAT step {i}: launches {dict(zip(names, launches))}, "
              f"want ({n_fwd}, {n_w}, {n_fa}, 0)")
        check(math.isfinite(steps[-1]["loss"]),
              f"{arch} QAT step {i}: loss {steps[-1]['loss']}")
    peak = torch.cuda.max_memory_allocated(dev)
    named = dict(_named_leaves(student))
    unmoved = [k for k, t in w0.items() if torch.equal(named[k], t)]
    check(len(w0) == n_w and not unmoved,
          f"{arch}: {len(w0)} s_w (want {n_w}), unmoved {unmoved[:5]}")
    check(all(bool(torch.isfinite(t).all()) for t in named.values()),
          f"{arch}: a parameter is not finite after QAT")
    del opt
    torch.cuda.empty_cache()
    per = {k: sum(s["ms"][k] for s in steps[1:]) / (len(steps) - 1)
           for k in ("teacher", "student", "optimizer")}
    step_ms = sum(per.values())
    S = T if encdec else T + cfg.vision_tokens
    flops = (encdec_train_flops(cfg, B, T) if encdec
             else train_flops(cfg, B, S))
    out = {"arch": arch, "layers": cfg.n_layers,
           "encoder_layers": cfg.encoder_layers, "batch": B, "seq": S,
           "loss_tokens": B * T, "remat": tcfg.remat, "setup_s": setup_s,
           "params_total": cfg.param_counts()["total"],
           "losses": [s["loss"] for s in steps], "ms_per_step": step_ms,
           "ms_split": per, "ms_first_step": sum(steps[0]["ms"].values()),
           "tokens_per_s": B * S / (step_ms / 1e3),
           "peak_memory_bytes": peak,
           "model_flops_per_step": flops,
           "model_flops_share": flops / (step_ms / 1e3) / BF16_PEAK_FLOPS,
           "launches_per_step": dict(zip(names, steps[-1]["launches"])),
           "weight_sites": n_w}
    report[key] = out
    print(f"{phase}: " + json.dumps(out), flush=True)
    del teacher, student, batch
    torch.cuda.empty_cache()
    return dict(zip(names, [n_fwd * MX_TRAIN_STEPS, n_w * MX_TRAIN_STEPS,
                            n_fa * MX_TRAIN_STEPS, 0]))


def time_wv(torch, P, dev, report):
    """Phase 4 at the two archs' shapes: flash without causality at the
    encoder's (4, 1500, H 20, D 64) and at the cross shape (Sq 128, Skv
    1500), beside SDPA; kvq_decode_attn over whisper's four full
    1500-row cross caches beside SDPA; w4a8_matmul per decode step of
    whisper (32 x 8 linears and the head at N 51866) and of qwen2-vl (28
    x 7 and the head at N 151936) beside bf16 ``torch.matmul``; flash at
    G 6 (8, 384) causal; at qwen2-vl's G 6 the paged decode launch, a
    tail-wave's gathers (28 launches) and a COW over its 28-layer pool;
    fake_quant_fwd and _bwd per student step of each arch (whisper's
    513 weight sites, qwen2-vl's 197), beside the plain versions and
    the library."""
    wh, vl = wv_cfgs(P)
    gen = torch.Generator(device=dev)
    gen.manual_seed(65)
    Te = wh.encoder_seq
    enc = time_flash_launch(torch, P, wh, dev, gen, SLOTS, Te, 3,
                            causal=False)
    cross = time_flash_launch(torch, P, wh, dev, gen, SLOTS, TRAIN_T, 5,
                              Skv=Te, causal=False)
    xdec = time_dense_launch(torch, P, wh, dev, gen, (Te,) * SLOTS, Te,
                             False)
    d, f, L = wh.d_model, wh.d_ff, wh.n_layers
    w4_wh = w4a8_step_times(torch, P, [
        ("self q/k/v/o", d, d, 4 * L), ("cross q/o", d, d, 2 * L),
        ("w1", d, f, L), ("w2", f, d, L), ("head", d, wh.vocab_size, 1)],
        dev, gen)
    w4_vl = w4a8_step_times(torch, P, linear_shapes(vl), dev, gen)
    g6 = time_flash_launch(torch, P, vl, dev, gen, TRAIN_B, VL_TRAIN_S, 5)

    def make():
        return paged_inputs(torch, gen, vl, PAGED_BS[0], PAGED_LENGTHS, dev)

    paged = time_paged_launch(torch, P, vl, "paged_decode", make(), make)
    gather = time_gather(torch, P, vl, dev, {})
    cow = time_copy(torch, P, vl, dev, {}, layers=vl.n_layers)
    Le = wh.encoder_layers
    fq_wh = time_fake_quant(torch, P, wh, dev, {}, shapes=[
        ("q/k/v/o", d, d, 1, 4, 4 * Le + 8 * L), ("w1", d, f, 1, 4, Le + L),
        ("w2", f, d, 1, 4, Le + L), ("head", wh.vocab_size, d, 2, 8, 1)])
    fq_vl = time_fake_quant(torch, P, vl, dev, {})
    out = {"flash_encoder_launch": enc, "flash_cross_launch": cross,
           "flash_encoder_forward": per_step(enc, wh.encoder_layers),
           "cross_decode_launch": xdec,
           "cross_decode_step": per_step(xdec, L),
           "w4a8_decode_step_whisper": w4_wh,
           "w4a8_decode_step_qwen2_vl": w4_vl, "flash_launch_g6": g6,
           "paged_decode_launch_g6": paged, "gather_tail_wave_vl": gather,
           "copy_per_cow_vl": cow, "fake_quant_step_whisper": fq_wh,
           "fake_quant_step_qwen2_vl": fq_vl}
    report["wv_times"] = out
    print(f"phase 4: whisper flash non-causal encoder launch "
          f"{enc['ms'] * 1e3:.2f} us (SDPA {enc['library_ms'] * 1e3:.2f} us,"
          f" bound {enc['bound_ms'] * 1e3:.2f} us), cross launch "
          f"{cross['ms'] * 1e3:.2f} us (SDPA "
          f"{cross['library_ms'] * 1e3:.2f} us); kvq_decode_attn over the "
          f"cross caches {xdec['ms'] * 1e3:.2f} us (SDPA "
          f"{xdec['library_ms'] * 1e3:.2f} us, bound "
          f"{xdec['bound_ms'] * 1e3:.2f} us); w4a8 per whisper decode step "
          f"{w4_wh}, per qwen2-vl decode step {w4_vl}; flash G 6 "
          f"{g6['ms'] * 1e3:.2f} us (SDPA {g6['library_ms'] * 1e3:.2f} us); "
          f"paged decode G 6 {paged['ms'] * 1e3:.2f} us; gather a tail-wave "
          f"{gather}; COW {cow}; fake-quant a whisper step {fq_wh}, a "
          f"qwen2-vl step {fq_vl}", flush=True)
    return out


# --------------------------------------------------------------------------
# phases 3t and 3u: tensor-parallel serving, ranks on the one card
# --------------------------------------------------------------------------

TP = 2
TP_W4A8_M = (1, SLOTS, 8, PREFILL_M)
TP_TIMEOUT_S = 600
# the passes, (key, phase, arch, layers kept (0: all), tp, scales
# LSQ-calibrated). The passes of one tp share one spawn: its ranks take
# them in turn, each building the pass's whole cut tree from the seed
# before its engine cuts a slice of it (both live while the engine is
# built), the tree freed after the pass: moonshot at 16 layers ~18.6 GB +
# 9.4 a rank after the export drops the packed linears' bf16 weights (its
# banks stay bf16), mixtral at 4 ~11.6 + 5.8, qwen2-7b at 2 ~1.7 + 0.7
# (3.3 while its bf16 linears live): ~60 GB of two moonshot ranks on the
# card. qwen2.5-3b's tree is phase 3's (scales not calibrated).
TP_PASSES = (("q3", "phase 3t", "qwen2.5-3b", 0, 2, False),
             ("ms", "phase 3u", MS, 16, 2, True),
             ("mx", "phase 3u", MX, 4, 2, True),
             ("rg", "phase 3v", RG, 0, 2, False),
             ("xl", "phase 3v", XLSTM, 0, 2, False),
             ("q3bf", "phase 3v", "qwen2.5-3b", 2, 2, True),
             ("q3bfd", "phase 3v", "qwen2.5-3b", 0, 2, True),
             ("fe", "phase 3o", "qwen2.5-3b", 0, 2, False),
             ("q7", "phase 3u", Q7, 2, 8, True))
# phase 3v: recurrentgemma-2b and xlstm-125m at full width and
# depth (w4a8, dense; rg's rings of 2048 at cache 4096: two 2030-token
# prompts wrap theirs in decode) and qwen2.5-3b under the bf16 layout
# at 2 of 36 layers (dense, scales LSQ-initialised: the bf16 layout
# fake-quantizes with them, where the w4a8 export replaces a placeholder
# scale; its row-parallel linears sum f32 partials; one decode step's
# logits within Q3BF_LOGIT_REL of tp=1's, the streams compared as weak
# evidence only), and at all 36 ("q3bfd": one decode step only, beside
# a witness, ``tp_witness``; its prefill may pick other decode tokens
# than tp=1's, which made the step's logits 0.46 apart, so every path
# takes tp=1's); phase 3o at tp=2 ("fe"): the frontend and
# HTTP on rank 0, the other rank following its engine (``fe_pass``)
TPV_RG_LENS = (RG_WRAP_PROMPT, RG_WRAP_PROMPT)    # the second sampled
TPV_RG_NEW = 24                # 2030 + 24 > 2048: the rings wrap in decode
TPV_XL_LENS = (64, 64, 96, 96)
# the dense passes' decode step: (prompt tokens, decode steps before it,
# the cache budget) of 2 prompts; rg's wrap their rings of 2048
TPV_STEP = {"rg": (RG_WINDOW - 8, 12, RG_CACHE_LEN),
            "xl": (96, 4, CACHE_LEN), "q3bf": (200, 0, CACHE_LEN),
            "q3bfd": (200, 0, CACHE_LEN)}
# the passes on dense caches, and those under the bf16 layout
TP_DENSE = ("mx", "rg", "xl", "q3bf", "q3bfd")
TP_BF16 = ("q3bf", "q3bfd")
# tests/test_torch_tp_recurrent.py:BF16_LOGIT_REL, the tolerance of the
# bf16 layout's decode-step logits at tp=2 against tp=1's
Q3BF_LOGIT_REL = 3.4e-2
# q3bfd: tp=2's logits gap at 36 layers at most this many times the
# witness's (tp=1 with its GEMMs' f32 sums rounded once, ``tp_witness``),
# every path fed tp=1's decode tokens: 0.05397 against 0.05890 on the
# card (0.92x; the tp=2 path against the witness 0.05795)
Q3BF_DEPTH_FACTOR = 2.0
FE_TP_POISSON = 4              # the tp=2 frontend's Poisson arrivals
FE_TP_RATE = 2.0               # their rate, requests a second
# a recurrent cache leaf's dim cut over the ranks (None: whole), by kind
TPV_STATE_DIM = {"rglru": {"state_q": -1, "s_state": None, "conv_buf": -1},
                 "mlstm": {"state_q": 1, "s_state": 1},
                 "slstm": {"state_q": None, "s_state": None, "c": None}}
# qwen2.5-3b's serves: phase 3b's 8 requests, 8 new tokens each (a tp=2
# decode step over gloo takes ~350 ms on the card), and phase 3c's config
# (k 4, the 18-layer draft) on the first SLOTS of them, 4 new tokens
# each. Two ranks on one card over gloo pay ~1-1.7 ms a collective
# (tools/tp_collective_times.py), ~440 a spec wave
TP_PAGED_NEW = 8
TP_SPEC_NEW = 4
TPM_NEW = 8                    # new tokens a request of the other passes
TPM_MS_DRAFT = 8               # moonshot's spec: k 4, an 8-layer draft
TPM_MX_LENS = (MX_WRAP_PROMPT, 1500, 700, 300)   # the first wraps in decode
TPM_MX_WRAP_ROWS = 2           # prompts of MX_WRAP_PROMPT for the logits,
TPM_MX_STEPS = 12              # after this many decode steps (wrapped)
# the ranks' local banks at tp=2: moonshot's 32 of 64 experts, mixtral's
# 4 of 8 (wg / wu, then wd)
TPM_BANKS = ((32, 2048, 1408), (32, 1408, 2048), (4, 4096, 14336),
             (4, 14336, 4096))
# a few leaves every rank checks against the parent's (same seed, same
# weights): (path, in the tree init_params returns)
TP_CHECKSUM_LEAVES = ("embed/w", "layers/mid/ln2/w",
                      "layers/last/attn/wo/w", "final_norm/w")
TP_CHECKSUM_CHUNK = 2 ** 24
# a serve's counters held to tp=1's
TP_COUNTERS = ("decode_steps", "tokens_out", "prefix_hit_blocks",
               "cow_copies", "tail_waves", "spec_waves", "spec_accepted")
TP_BYTES = ("per_device_pool_bytes", "per_device_weight_bytes",
            "per_device_bank_bytes", "per_device_state_bytes")


def tp_shard_cfg(cfg, tp=TP):
    """The config a rank's model code runs: its heads of the tp slices."""
    return cfg.replace(n_heads=cfg.n_heads // tp,
                       n_kv_heads=cfg.n_kv_heads // tp,
                       head_dim=cfg.resolved_head_dim)


def tp_row_shapes(cfg, tp=TP):
    """(name, K, N) of the row-parallel linears at a rank's K slice."""
    return [("o", cfg.q_dim // tp, cfg.d_model),
            ("down", cfg.d_ff // tp, cfg.d_model)]


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def leaf_checksums(torch, params, paths=TP_CHECKSUM_LEAVES):
    """(int sum of the bits, f64 sum of squares) of a few leaves, in
    chunks of TP_CHECKSUM_CHUNK elements (eight ranks of qwen2-7b on one
    card cannot each hold an f64 copy of a 1 GB embedding)."""
    out = {}
    for path in paths:
        t = params
        for k in path.split("/"):
            if isinstance(t, list):
                k = {"mid": len(t) // 2, "last": len(t) - 1}.get(k, k)
                t = t[int(k)]
            else:
                t = t[k]
        flat = t.reshape(-1)
        bits = flat.view(torch.int16) if t.element_size() == 2 else \
            flat.view(torch.int32)
        isum, sq = 0, 0.0
        for lo in range(0, flat.numel(), TP_CHECKSUM_CHUNK):
            isum += int(bits[lo:lo + TP_CHECKSUM_CHUNK].long().sum())
            sq += float(flat[lo:lo + TP_CHECKSUM_CHUNK].double().square()
                        .sum())
        out[path] = (isum, sq)
    return out


def check_w4a8_acc(torch, P, cfg, dev, report, shapes=None, seed=31,
                   phase="phase 3t"):
    """The w4a8 kernel's accumulator-out mode and its epilogue kernel at
    the row-parallel shard shapes (``shapes``, (name, K, N); by default
    ``cfg``'s wo K 1024, wd K 5504 at tp=2) and M in TP_W4A8_M: the int32
    sums bitwise the plain version's by the launcher's route and each
    route forced, the epilogue bitwise the plain epilogue's with and
    without bias, and the two kernels together bitwise the fused
    matmul."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ops = P["w4a8_ops"]
    n = 0
    shapes = shapes or tp_row_shapes(cfg)
    for name, K, N in shapes:
        w_p, s_w, b = w4a8_weights(torch, gen, K, N, True, dev)
        for M in TP_W4A8_M:
            x_q, s_x = w4a8_activations(torch, gen, M, K, dev)
            want = ops.w4a8_accumulate_ref(x_q, w_p)
            for route in ("auto",) + W4A8_ROUTES:
                got = ops.w4a8_accumulate(x_q, w_p, route=route)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise SmokeFailure(
                        f"w4a8_accumulate {name} M={M} K={K} route={route} "
                        f"differs from its plain version on "
                        f"{int((got != want).sum())} sums")
            for bias in (None, b):
                y = ops.w4a8_epilogue(want, s_x, s_w, bias)
                y_want = ops.w4a8_epilogue_ref(want, s_x, s_w, bias)
                torch.cuda.synchronize()
                check(torch.equal(y, y_want),
                      f"w4a8_epilogue {name} M={M} bias={bias is not None} "
                      f"differs from its plain version")
                check(torch.equal(y, ops.w4a8_matmul(x_q, w_p, s_x, s_w,
                                                     bias)),
                      f"w4a8 {name} M={M}: accumulate + epilogue differ "
                      f"from the fused kernel")
            n += 1
            del x_q, s_x, want
        del w_p, s_w, b
    report["w4a8_acc_cases"] = n
    print(f"{phase}: w4a8_accumulate bitwise equal to its plain version "
          f"(launcher's route and both forced) and w4a8_epilogue to its "
          f"plain epilogue, together bitwise the fused kernel, at "
          f"{[(K, N) for _, K, N in shapes]} (K, N), M in "
          f"{list(TP_W4A8_M)}", flush=True)
    return 0.0


def check_tp_kernels(torch, P, cfg, dev, report):
    """Phase 3t's kernels at qwen2.5-3b's shard shapes: the accumulator-
    out mode and epilogue at its row-parallel K slices, and phase 2's
    checks of the paged decode, gather, verify and COW kernels at one
    rank's heads (Hkv 1, G 8 at tp=2)."""
    scfg = tp_shard_cfg(cfg)
    sub = {}
    errs = {"w4a8_accumulate": check_w4a8_acc(torch, P, cfg, dev, sub),
            "kvq_paged_decode_attn": check_paged_decode(torch, P, scfg, dev,
                                                        sub),
            "gather_dequant_paged_kv": check_gather(torch, P, scfg, dev,
                                                    sub),
            "kvq_spec_verify_attn": check_spec_verify(torch, P, scfg, dev,
                                                      sub)}
    check_copy_multi(torch, P, scfg, dev, sub)
    errs["pool_block_copy"] = 0.0
    report["tp_kernels"] = {"shard": {"n_heads": scfg.n_heads,
                                      "n_kv_heads": scfg.n_kv_heads},
                            **sub}
    return errs


def time_w4a8_acc(torch, P, cfg, dev):
    """Per launch at the row-parallel shard shapes and M = slots and one
    admission wave: the accumulator-out mode, the epilogue, the fused
    kernel on the same shape, the plain versions and the bounds."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    ops = P["w4a8_ops"]
    rows = []
    for name, K, N in tp_row_shapes(cfg):
        nb = N * K // 2 + 8 * N
        sets = [w4a8_weights(torch, gen, K, N, False, dev)
                for _ in range(copies_for(nb))]
        for M in (SLOTS, PREFILL_M):
            x_q, s_x = w4a8_activations(torch, gen, M, K, dev)
            acc = ops.w4a8_accumulate_ref(x_q, sets[0][0])
            acc_sets = [(x_q, w_p) for w_p, _, _ in sets]
            epi_sets = [(acc.clone(), s_x, s_w) for _, s_w, _ in
                        sets[:copies_for(4 * M * N)]]
            fused = [(x_q, w_p, s_x, s_w) for w_p, s_w, _ in sets]
            a_bytes = M * K + N * K // 2 + 4 * M * N
            e_bytes = 4 * M * N + 4 * M + 4 * N + 2 * M * N
            ta, to = a_bytes / HBM_BYTES_PER_S, 2 * M * N * K / INT8_OPS_PER_S
            rows.append({
                "linear": name, "M": M, "K": K, "N": N,
                "accumulate_ms": time_ms(torch, ops.w4a8_accumulate,
                                         acc_sets),
                "accumulate_plain_ms": time_ms(
                    torch, ops.w4a8_accumulate_ref, acc_sets[:2],
                    min_calls=5),
                "accumulate_bound_ms": 1e3 * max(ta, to),
                "accumulate_bound_by": "bytes" if ta >= to else "operations",
                "epilogue_ms": time_ms(torch, ops.w4a8_epilogue, epi_sets),
                "epilogue_plain_ms": time_ms(torch, ops.w4a8_epilogue_ref,
                                             epi_sets[:2], min_calls=10),
                "epilogue_bound_ms": 1e3 * e_bytes / HBM_BYTES_PER_S,
                "fused_ms": time_ms(torch, ops.w4a8_matmul, fused)})
            del x_q, s_x, acc, acc_sets, epi_sets, fused
        del sets
        torch.cuda.empty_cache()
    return rows


def tp_counted(P):
    ops, w = P["kvq_ops"], P["w4a8_ops"]
    return {"w4a8_matmul": w.w4a8_matmul,
            "w4a8_accumulate": w.w4a8_accumulate,
            "w4a8_epilogue": w.w4a8_epilogue,
            "kvq_paged_decode_attn": ops.kvq_paged_decode_attn,
            "gather_dequant_paged_kv": ops.gather_dequant_paged_kv,
            "pool_block_copy": ops.copy_pool_blocks_multi,
            "kvq_spec_verify_attn": ops.kvq_spec_verify_attn,
            "kvq_decode_attn": ops.kvq_decode_attn,
            "fake_quant_fwd": P["fq_ops"].fake_quant_fwd}


def logit_state_requests(P, cfg):
    """The cold wave of the one-step logit and prefill checks: SLOTS
    prompts of 32 to 64 tokens (check_paged_logits' prompts)."""
    import numpy as np
    rng = np.random.default_rng(12)
    return [P["Request"](uid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(n)).astype(np.int32), max_new_tokens=MAX_NEW)
        for i, n in enumerate(rng.integers(32, 65, SLOTS))]


def cold_wave_state(torch, P, cfg, params, dev, mesh=None):
    """A paged engine (prefix cache off) after one cold admission wave:
    (one decode step's logits and the pool's K/V codes and scales of the
    blocks the wave wrote, both on the host; the engine; the step's
    wall ms and, on a mesh, its collectives by kind and whether a pool
    leaf was handed to one)."""
    models = P["models"]
    eng = paged_engine(P, cfg, params, dev, prefix_cache=False, mesh=mesh)
    comm = eng._comm
    if comm is None or comm.rank == 0:
        for r in logit_state_requests(P, cfg):
            eng.submit(r)
        eng.admit()
        eng.stop_followers()
    else:
        eng.follow()
    check(len(eng._slot_req) == SLOTS, "tp logit state: a wave short")
    eng._ensure_decode_blocks()
    cache = models.clone_cache(eng.state["cache"])
    if comm is not None:
        before = comm.counts()
        comm.watch = set()
    sync(torch, dev)
    t0 = time.perf_counter()
    logits, _ = models.decode_step(eng.mcfg, eng.params, eng.ctx,
                                   eng.state["tokens"], cache)
    sync(torch, dev)
    step = {"one_step_ms": 1e3 * (time.perf_counter() - t0)}
    if comm is not None:
        after = comm.counts()
        pools = {v.untyped_storage().data_ptr()
                 for v in list(cache["pool"].values())
                 + list(eng.state["cache"]["pool"].values())}
        step["census"] = {k: after[k] - before[k] for k in after}
        step["pool_in_collective"] = bool(pools & comm.watch)
        comm.watch = None
    used = sorted({int(b) for s in eng._slot_req
                   for b in eng.alloc.tables[s] if b < eng.num_blocks})
    idx = torch.tensor(used, device=dev)
    pool = {k: v[:, idx].cpu() for k, v in eng.state["cache"]["pool"].items()}
    return logits.float().cpu(), pool, eng, step


def tp_cfg(P, arch, layers, reduced=False):
    """A pass's config: ``arch`` at full width, its first ``layers``
    (all at 0); the reduced config where the harness is rehearsed on the
    CPU."""
    if reduced:
        cfg = P["get_reduced_config"](arch)
        # the reduced xLSTM's sLSTM up-projection (85) cannot pack int4
        return (cfg.replace(slstm_proj_factor=1.5) if arch == XLSTM
                else cfg)
    cfg = P["get_config"](arch)
    return cfg.replace(n_layers=layers) if layers else cfg


def tp_tree(torch, P, cfg, dev, calibrate, bf16=False):
    """A pass's tree from the seed, scales LSQ-initialised where
    ``calibrate`` (as phases 3i, 3j and 3l build theirs); (checksums of a
    few leaves, the tree with its packed exports attached and their bf16
    weights dropped, or as it is for the bf16 layout)."""
    qat = P["qat"]
    params = P["models"].init_params(cfg, seed=0, device=dev)
    pol = P["parse_policy"]("A8d-C8-W4")
    if calibrate:
        params = qat.calibrate_weight_scales(params, pol, method="lsq")
    kinds = cfg.layer_kinds()
    if "attn" in kinds:
        paths = TP_CHECKSUM_LEAVES + (
            (("layers/0/attn/wq/b",) if cfg.qkv_bias else ())
            + (("layers/last/moe/wd/w",) if cfg.is_moe else ()))
    else:           # the recurrent archs: their first layer's input
        paths = ("embed/w", "layers/mid/ln1/w", "final_norm/w",
                 "layers/0/rglru/w_in/w" if kinds[0] == "rglru"
                 else "layers/0/cell/w_up/w")
    sums = leaf_checksums(torch, params, paths)
    if bf16:
        return sums, params
    return sums, qat.drop_exported_weights(qat.attach_w4a8_exports(
        params, pol))


def tp_serves(P, key, cfg, reduced=False):
    """A pass's serves: (name, the engine's keywords, requests, counters
    its tp=1 run must show above 0, kernels every rank must launch).
    qwen2.5-3b: phase 3b's requests on the pool (prefix hits, COW,
    tail-waves), then phase 3c's spec config; moonshot: phase 3b's kind
    of requests on the pool with spec (k 4, an 8-layer draft); mixtral:
    4 prompts of TPM_MX_LENS on its dense rings of 4096, the first
    wrapping in decode, the last sampled; qwen2-7b: moonshot's requests
    on the pool without spec."""
    import numpy as np
    w4a8 = ("w4a8_matmul", "w4a8_accumulate", "w4a8_epilogue")
    fq = ("fake_quant_fwd",) if cfg.is_moe else ()
    pool = ("kvq_paged_decode_attn", "gather_dequant_paged_kv",
            "pool_block_copy")
    hits = ("prefix_hit_blocks", "cow_copies", "tail_waves")
    spec = P["SpecConfig"]
    if key == "q3":
        paged = shared_prefix_requests(P, cfg, 2 * SLOTS, 200, seed=14)
        for r in paged:
            r.max_new_tokens = TP_PAGED_NEW
        drafted = shared_prefix_requests(P, cfg, 2 * SLOTS, 200,
                                         seed=14)[:SLOTS]
        for r in drafted:
            r.max_new_tokens = TP_SPEC_NEW
        return [("paged", {}, paged, hits, w4a8 + pool),
                ("spec", {"spec": spec(k=SPEC_K)}, drafted,
                 ("spec_waves",), ("kvq_spec_verify_attn",
                                   "w4a8_accumulate", "w4a8_epilogue",
                                   "kvq_decode_attn"))]
    if key == "q3bfd":                  # the decode step only
        return []
    if key in ("rg", "xl", "q3bf"):
        rng = np.random.default_rng(17)
        if key == "q3bf":
            reqs = shared_prefix_requests(P, cfg, 2 * SLOTS, 400, seed=17)
            for r in reqs:
                r.max_new_tokens = TPM_NEW
            return [("serve", {}, reqs, (),
                     ("fake_quant_fwd", "kvq_decode_attn"))]
        lens = {"rg": (40, 40) if reduced else TPV_RG_LENS,
                "xl": TPV_XL_LENS}[key]
        last = len(lens) - 1
        reqs = [P["Request"](uid=500 + i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=TPV_RG_NEW if key == "rg" else TPM_NEW,
            temperature=0.8 if i == last else 0.0,
            top_k=8 if i == last else 0, seed=i)
            for i, n in enumerate(lens)]
        return [("serve", {}, reqs, (), w4a8 + (
            ("kvq_decode_attn",) if key == "rg" else ()))]
    if key == "mx":
        rng = np.random.default_rng(16)
        lens = (60, 40, 20, 10) if reduced else TPM_MX_LENS
        reqs = [P["Request"](uid=300 + i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=TPM_NEW,
            temperature=0.8 if i == 3 else 0.0, top_k=8 if i == 3 else 0,
            seed=i) for i, n in enumerate(lens)]
        return [("serve", {}, reqs, (), w4a8 + fq + ("kvq_decode_attn",))]
    reqs = shared_prefix_requests(P, cfg, 2 * SLOTS, 300, seed=15)
    for r in reqs:
        r.max_new_tokens = TPM_NEW
    if key == "ms":
        kw = {"spec": spec(k=SPEC_K, draft_layers=min(TPM_MS_DRAFT,
                                                      cfg.n_layers // 2))}
        return [("serve", kw, reqs, () if reduced else hits
                 + ("spec_waves",), w4a8 + fq + (
                     "kvq_spec_verify_attn", "kvq_decode_attn",
                     "gather_dequant_paged_kv", "pool_block_copy"))]
    return [("serve", {}, reqs, (), w4a8 + fq + pool)]


def tp_engine(P, key, cfg, params, dev, mesh=None, **kw):
    if key in ("rg", "xl") + TP_BF16:   # phases 3g's, 3f's, 3a's engines
        return P["ServeEngine"](
            cfg, params, policy="A8d-C8-W4", slots=SLOTS,
            cache_len=RG_CACHE_LEN if key == "rg" else CACHE_LEN,
            max_new_cap=MAX_NEW, decode_block=8,
            weights_layout="bf16" if key in TP_BF16 else "w4a8",
            device=dev, mesh=mesh, **kw)
    if key == "mx":     # phase 3i's dense engine: rings of 4096
        return P["ServeEngine"](cfg, params, policy="A8d-C8-W4",
                                slots=SLOTS, cache_len=MX_CACHE_LEN,
                                max_new_cap=MAX_NEW, decode_block=8,
                                weights_layout="w4a8", device=dev,
                                mesh=mesh, **kw)
    return paged_engine(P, cfg, params, dev, mesh=mesh, **kw)


def tp_serve(torch, P, key, cfg, params, dev, mesh, kw, reqs):
    """One serve of a pass. Returns (streams, counters, launches,
    collectives by kind)."""
    eng = tp_engine(P, key, cfg, params, dev, mesh, **kw)
    counted = tp_counted(P)
    comm = eng._comm
    lead = comm is None or comm.rank == 0
    before = comm.counts() if comm is not None else None
    if lead:
        for r in reqs:
            eng.submit(r)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    if lead:
        stats = eng.run_until_drained()
    else:               # this rank's copies of rank 0's requests
        reqs = eng.follow()
        stats = eng.stats()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counted.items()}
    coll = None
    if comm is not None:
        after = comm.counts()
        coll = {k: after[k] - before[k] for k in after}
    for n in sorted({r.max_new_tokens for r in reqs}):
        check_streams(cfg, [r for r in reqs if r.max_new_tokens == n],
                      f"tp {key} serve", n=n)
    check(stats["free_blocks"] == eng.num_blocks if "free_blocks" in stats
          else True, f"tp {key} serve: blocks leaked after the drain")
    counters = {k: stats[k] for k in TP_COUNTERS + TP_BYTES + (
        "decode_step_s", "spec_drafted") if k in stats}
    counters["wall_s"] = wall
    del eng
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return ({r.uid: list(r.generated) for r in reqs}, counters, launches,
            coll)


def tp_bank_ms(torch, P, eng, dev, reps=5):
    """The device ms of one decode step's bank fake-quants replayed alone
    on this rank's banks (3 a layer), between CUDA events; None off the
    card or without banks."""
    banks = [lay["moe"][b] for lay in eng.params["layers"]
             if "moe" in lay for b in ("wg", "wu", "wd")]
    if not banks or torch.device(dev).type != "cuda":
        return None
    quant = P["qat"].quantize_weight_p
    for p in banks:
        quant(eng.ctx, p)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for p in banks:
            quant(eng.ctx, p)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def tp_step(torch, P, key, cfg, params, dev, mesh=None, reduced=False,
            tok_in=None):
    """One decode step's logits at a pass's state, its collectives and
    launches: on the pool after a cold admission wave (prefix cache off;
    also the wave's K/V codes and scales, ``cold_wave_state``), mixtral
    after TPM_MX_WRAP_ROWS prompts of MX_WRAP_PROMPT tokens and
    TPM_MX_STEPS decode steps (its rings wrapped). The step is taken
    again with every launch count at 0; the bank fake-quants are timed
    alone (``tp_bank_ms``), one rank at a time. ``tok_in``: the decode
    step's tokens (the bf16 passes take tp=1's, which their own prefill
    logits may not pick; else the argmax of the last logits)."""
    import numpy as np
    models = P["models"]
    counted = tp_counted(P)
    pool = None
    if key not in TP_DENSE:                          # on the pool
        logits, pool, eng, step = cold_wave_state(torch, P, cfg, params,
                                                  dev, mesh=mesh)
        cache, tok = eng.state["cache"], eng.state["tokens"]
    else:
        eng = tp_engine(P, key, cfg, params, dev, mesh)
        rng = np.random.default_rng(8)
        if key == "mx":
            n, steps, budget = (60 if reduced else MX_WRAP_PROMPT,
                                TPM_MX_STEPS, MX_CACHE_LEN)
        else:
            n, steps, budget = ((20, 4, 64) if reduced else TPV_STEP[key])
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (TPM_MX_WRAP_ROWS, n)).astype(
                np.int32)).to(dev)
        logits, cache = models.prefill(eng.mcfg, eng.params, eng.ctx,
                                       {"tokens": toks},
                                       cache_budget=budget)
        tok = torch.argmax(logits[:, -1].float(), -1).to(
            torch.int32)[:, None]
        for _ in range(steps):
            logits, cache = models.decode_step(eng.mcfg, eng.params,
                                               eng.ctx, tok, cache)
            tok = torch.argmax(logits[:, -1].float(), -1).to(
                torch.int32)[:, None]
        if tok_in is not None:
            tok = tok_in.to(dev)
        kinds = cfg.layer_kinds()
        ring = (0 if key == "mx" else kinds.index("local_attn")
                if key == "rg" else None)
        length = (int(cache["layers"][ring]["length"][0])
                  if ring is not None else 0)
        if ring is not None:
            window = cfg.sliding_window if key == "mx" else cfg.local_window
            check(length > window,
                  f"tp {key}: the rings did not wrap ({length})")
        comm = eng._comm
        before = comm.counts() if comm is not None else None
        sync(torch, dev)
        t0 = time.perf_counter()
        logits, _ = models.decode_step(eng.mcfg, eng.params, eng.ctx, tok,
                                       models.clone_cache(cache))
        sync(torch, dev)
        step = {"one_step_ms": 1e3 * (time.perf_counter() - t0),
                "wrapped_length": length + 1}
        if comm is not None:
            after = comm.counts()
            step["census"] = {k: after[k] - before[k] for k in after}
        logits = logits.float().cpu()
        if key in ("rg", "xl"):
            # the recurrent states and the rings after the wrap steps
            step["cache"] = [{k: v.cpu() for k, v in lay.items()}
                             for lay in cache["layers"]]
    for fn in counted.values():
        fn.launches = 0
    with layer_outputs(key in TP_BF16) as outs:
        models.decode_step(eng.mcfg, eng.params, eng.ctx, tok,
                           models.clone_cache(cache))
    sync(torch, dev)
    step["launches"] = {n: fn.launches for n, fn in counted.items()}
    if outs:
        step["residual"], step["tok"] = outs, tok.cpu()
    step["local_experts"] = (eng.params["layers"][0]["moe"]["wg"]["w"]
                             .shape[0] if cfg.is_moe else 0)
    if mesh is not None and torch.device(dev).type == "cuda":
        # one rank at a time, so the other's work stays off the clock
        import torch.distributed as dist
        for r in range(int(mesh.shape["model"])):
            dist.barrier(group=mesh.group)
            if r == mesh.rank:
                step["bank_fq_ms"] = tp_bank_ms(torch, P, eng, dev)
        dist.barrier(group=mesh.group)
    else:
        step["bank_fq_ms"] = tp_bank_ms(torch, P, eng, dev)
    del eng, cache
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return logits, pool, step


@contextlib.contextmanager
def layer_outputs(on=True):
    """Each layer's residual output (f32, on the host) of the decode
    steps run inside, in order (none unless ``on``)."""
    import repro_torch.models.model as M
    outs, block = [], M._block_decode

    def rec(*a, **k):
        y = block(*a, **k)
        outs.append(y.float().cpu())
        return y
    if on:
        M._block_decode = rec
    try:
        yield outs
    finally:
        M._block_decode = block


class _F32Products:
    """``torch`` as ``repro_torch.core.qat`` sees it in ``tp_witness``:
    every matmul an f32 product of its inputs rounded once to the first
    one's dtype, else torch itself."""

    def __init__(self, torch):
        self._torch = torch

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def matmul(self, a, b):
        return self._torch.matmul(a.float(), b.float()).to(a.dtype)


def tp_witness(torch, P, key, cfg, params, dev, tok, reduced=False):
    """The bf16 layout's decode step at tp=1 with every GEMM of
    ``core.qat`` (its linears' ``torch.matmul``) an f32 product rounded
    once: the same sums as tp=1's bf16 GEMM, rounded after another
    order, as tp > 1's row-parallel linears round theirs. Returns
    (logits, each layer's residual output)."""
    qat = P["qat"]
    qat.torch = _F32Products(torch)
    try:
        logits, _, step = tp_step(torch, P, key, cfg, params, dev, None,
                                  reduced, tok)
    finally:
        qat.torch = torch
    return logits, step["residual"]


def rel_l2(torch, a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def tp_run_pass(torch, P, key, cfg, params, dev, mesh=None, reduced=False,
                tok_in=None):
    """A pass's serves and decode step on ``params`` (at tp=1 without a
    mesh): ({serve: (streams, counters, launches, collectives)}, logits,
    pool, step)."""
    serves = {name: tp_serve(torch, P, key, cfg, params, dev, mesh, kw, reqs)
              for name, kw, reqs, _, _ in tp_serves(P, key, cfg, reduced)}
    logits, pool, step = tp_step(torch, P, key, cfg, params, dev, mesh,
                                 reduced, tok_in)
    return serves, logits, pool, step


def tp_rank(mesh, tp_in):
    """One rank of a tensor-parallel spawn: each pass in turn, its tree
    from the seed (at tp > 2 the ranks building in turn, each returning
    what its allocator cached: eight qwen2-7b ranks packing their 1 GB
    heads at once, ~10 GB a rank at the peak, pass the card; two ranks
    build at once), its serves and its
    decode step at this rank's slice, the tree freed. Returns every
    rank's findings (gathered) and rank 0's streams."""
    import torch
    import torch.distributed as dist
    P = import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    cuda = dev.type == "cuda"
    reduced = tp_in["reduced"]
    found, streams = {}, {}
    for pin in tp_in["passes"]:
        key = pin["key"]
        cfg = tp_cfg(P, pin["arch"], pin["layers"], reduced)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        # two ranks build at once (two moonshot trees at 16 layers peak
        # near 58 GB together); more build in turn
        tp_n = int(mesh.shape["model"])
        turns = tp_n if tp_n > TP else 1
        for r in range(turns):
            if turns == 1 or r == mesh.rank:
                sums, params = tp_tree(torch, P, cfg, dev, pin["calibrate"],
                                       bf16=key in TP_BF16)
                if cuda:
                    torch.cuda.synchronize(dev)
                    torch.cuda.empty_cache()
            dist.barrier(group=mesh.group)
        mine = {"setup_s": time.perf_counter() - t0,
                "checksums_equal": sums == pin["checksums"]}
        if key == "fe":
            mine["fe"] = fe_pass(torch, P, cfg, params, dev, mesh)
            mine["peak_memory_bytes"] = (
                torch.cuda.max_memory_allocated(dev) if cuda else 0)
            del params
            found[key], streams[key] = mine, {}
            if cuda:
                torch.cuda.empty_cache()
            continue
        serves, logits, pool, step = tp_run_pass(torch, P, key, cfg, params,
                                                 dev, mesh, reduced,
                                                 pin["tok"])
        del params
        step["logits_equal"] = bool(torch.equal(logits, pin["logits"]))
        step["logits_finite"] = bool(torch.isfinite(logits).all())
        step["logits_rel"] = rel_l2(torch, logits, pin["logits"])
        if "residual" in step:
            res = step.pop("residual")
            step.pop("tok")
            step["residual_rel"] = [rel_l2(torch, a, b) for a, b in zip(
                res, pin["residual"])]
            w = pin["witness"]
            if w is not None:       # tp=2 against the witness
                step["witness_logits_rel"] = rel_l2(torch, logits,
                                                    w["logits"])
                step["witness_residual_rel"] = [
                    rel_l2(torch, a, b) for a, b in zip(res, w["residual"])]
        if "cache" in step:
            step["state_equal"] = tp_state_equal(
                torch, cfg, step.pop("cache"), pin["cache"], mesh.rank,
                int(mesh.shape["model"]))
        if pool is not None:
            want = pin["pool"]
            hkv = next(iter(pool.values())).shape[2]
            lo = 0 if hkv == cfg.n_kv_heads else mesh.rank * hkv
            step["prefill_pool_equal"] = {
                k: bool(torch.equal(v, want[k][:, :, lo:lo + hkv]))
                for k, v in pool.items()}
            step["kv_heads"] = hkv
        mine["step"] = step
        mine["serves"] = {n: {"counters": c, "launches": l,
                              "collectives": coll}
                          for n, (_, c, l, coll) in serves.items()}
        mine["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                     if cuda else 0)
        found[key] = mine
        streams[key] = {n: s for n, (s, _, _, _) in serves.items()}
        del serves
        if cuda:
            torch.cuda.empty_cache()
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, (mesh.rank, found, streams))
    return {"ranks": [(r, f) for r, f, _ in ranks], "streams": streams,
            "ranks_agree": all(s == streams for _, _, s in ranks)}


def tp_state_equal(torch, cfg, got, want, rank, tp):
    """{layer/leaf: bitwise} of a rank's dense cache after the wrap steps
    against tp=1's: a recurrent state its slice where the layouts cut it
    (``TPV_STATE_DIM``), else whole, and the rings whole (one whole KV
    head a rank)."""
    out = {}
    for i, (kind, g, w) in enumerate(zip(cfg.layer_kinds(), got, want)):
        for k, v in w.items():
            d = TPV_STATE_DIM.get(kind, {}).get(k)
            if d is not None:
                n = v.shape[d] // tp
                v = v.narrow(d, rank * n, n)
            out[f"{i}/{k}"] = bool(g[k].shape == v.shape
                                   and torch.equal(g[k], v))
    return out


def tp_reference(torch, P, key, cfg, calibrate, dev, reduced=False):
    """A pass at tp=1 in this process, its tree freed after: (checksums,
    serves, logits, pool, step, peak memory); the frontend pass's
    ``fe_pass`` instead of serves and a step."""
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sums, params = tp_tree(torch, P, cfg, dev, calibrate,
                           bf16=key in TP_BF16)
    if key == "fe":
        fe = fe_pass(torch, P, cfg, params, dev)
        del params
        if cuda:
            torch.cuda.empty_cache()
        return dict(checksums=sums, fe=fe, peak_memory_bytes=(
            torch.cuda.max_memory_allocated(dev) if cuda else 0))
    serves, logits, pool, step = tp_run_pass(torch, P, key, cfg, params, dev,
                                             None, reduced)
    witness = None
    if key == "q3bfd":
        wl, wres = tp_witness(torch, P, key, cfg, params, dev, step["tok"],
                              reduced)
        witness = {"logits": wl, "residual": wres,
                   "logits_rel": rel_l2(torch, wl, logits),
                   "residual_rel": [rel_l2(torch, a, b) for a, b in
                                    zip(wres, step["residual"])]}
    del params
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.empty_cache()
    return dict(checksums=sums, serves=serves, logits=logits, pool=pool,
                step=step, witness=witness, peak_memory_bytes=peak)


def tp_census(P, cfg, tp, bf16=False):
    """A decode step's collectives at ``tp``: per layer a MAX (the amax)
    and a SUM (int32 under w4a8, f32 under bf16) for each row-parallel
    linear (``wo`` unless every rank runs the whole attention, ``wd`` of a
    dense MLP, an RG-LRU's ``w_out``, an mLSTM's and an sLSTM's
    ``w_down``), one owned-slot sum for an MoE's combine, an RG-LRU's
    all-gather of its conv output and MAX of its state's scale, an
    mLSTM's MAX of ``s_state``'s; the embedding's int32 SUM and the
    logits' all-gather."""
    rows = maxes = gathers = 0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "local_attn"):
            n = (0 if P["attn_replicated"](cfg, tp) else 1) + (
                0 if cfg.is_moe else 1)
        elif kind == "rglru":
            n, maxes, gathers = 2, maxes + 1, gathers + 1
        elif kind == "mlstm":
            n, maxes = 1, maxes + 1
        else:
            n = 1
        rows += n
        maxes += n
    moe = cfg.n_layers if cfg.is_moe else 0
    return {"all_reduce_max": maxes,
            "all_reduce_sum": (0 if bf16 else rows) + 1,
            "all_reduce_sum_f32": rows if bf16 else 0,
            "all_reduce_owned": moe, "all_gather": 1 + gathers}


def tp_moe_row_shapes(P):
    """(fused (name, K, N, bias), accumulate (name, K, N)) of the linears
    whose shapes phase 3u's slices change: moonshot's and mixtral's q, k,
    v and head at tp=2 (their wo accumulates), qwen2-7b's MLP and head at
    tp=8 (its wd accumulates; its attention is whole, phase 2's
    shapes)."""
    fused, acc = [], []
    for key, _, arch, _, tp, _ in TP_PASSES:
        c = P["get_config"](arch)
        if key == "q3":
            continue
        if key == "q7":
            fused += [(f"{arch} gate/up tp{tp}", c.d_model, c.d_ff // tp,
                       False),
                      (f"{arch} head tp{tp}", c.d_model, c.vocab_size // tp,
                       False)]
            acc.append((f"{arch} down tp{tp}", c.d_ff // tp, c.d_model))
            continue
        fused += [(f"{arch} q tp{tp}", c.d_model, c.q_dim // tp, False),
                  (f"{arch} k/v tp{tp}", c.d_model, c.kv_dim // tp, False),
                  (f"{arch} head tp{tp}", c.d_model, c.vocab_size // tp,
                   False)]
        acc.append((f"{arch} o tp{tp}", c.q_dim // tp, c.d_model))
    seen, out = set(), []
    for f in fused:
        if f[1:] not in seen:
            seen.add(f[1:])
            out.append(f)
    return out, acc


def time_bank_fwd(torch, P, e, R, C, bits, dev, gen):
    """fake_quant_fwd on one bank (e, R, C) in mode 3 per launch, beside
    its plain version, ``fake_quantize_per_channel_affine`` on the bank
    permuted to (R, e C) (the permute outside the timed call) and the
    bound (bytes: the bank read and written once, its scales read)."""
    ops, ref = P["fq_ops"], P["fq_ref"]
    qn, qp = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    x, s, _ = bank_inputs(torch, gen, e, R, C, bits, dev)
    sets = [(x, s)]
    out = {"shape": [e, R, C], "bits": bits}
    out["ms"] = time_ms(torch, lambda x, s: ops.fake_quant_fwd(x, s, bits),
                        sets, min_calls=20)
    out["plain_ms"] = time_eager_ms(
        torch, lambda x, s: ref.fake_quant_fwd_ref(x, s, bits), sets,
        min_calls=3)
    xp = x.permute(1, 0, 2).reshape(R, e * C).contiguous()
    sp = s.reshape(-1).contiguous()
    zp = torch.zeros(e * C, dtype=torch.int32, device=dev)
    out["library_ms"] = time_eager_ms(
        torch, lambda x, s: torch.fake_quantize_per_channel_affine(
            x, s, zp, 1, qn, qp), [(xp, sp)], min_calls=5)
    n = e * R * C
    out["bound_ms"] = (4 * n + 4 * e * C) / HBM_BYTES_PER_S * 1e3
    out["bound_by"] = "bytes"
    del sets, x, s, xp, sp, zp
    torch.cuda.empty_cache()
    return out


def check_tp_moe_kernels(torch, P, dev, report):
    """Phase 3u's kernels at the ranks' shapes, against their plain
    versions: fake_quant_fwd in mode 3 bitwise on the local banks (bits
    4 and 8) and timed; w4a8 fused and accumulate + epilogue bitwise on
    the shard linears (``tp_moe_row_shapes``); at moonshot's rank (8
    query and 8 KV heads) and mixtral's (16 on 4, its 4096-row rings) the
    dense and paged decode, verify and the gather
    (``check_decode_case``), and the COW over moonshot's rank pool of 16
    layers. Returns the worst error per kernel."""
    ops, ref = P["fq_ops"], P["fq_ref"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(61)
    n_fq = 0
    for e, R, C in TPM_BANKS:
        for bits in (4, 8):
            x, s, _ = bank_inputs(torch, gen, e, R, C, bits, dev)
            check(ops.scale_mode(x, s) == 3, f"bank ({e}, {R}, {C}): not "
                                             f"mode 3")
            got = ops.fake_quant_fwd(x, s, bits)
            want = ref.fake_quant_fwd_ref(x, s, bits)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"phase 3u: fake_quant_fwd on the local bank ({e}, {R}, "
                  f"{C}) at {bits} bits differs from its plain version in "
                  f"{int((got != want).sum())} elements")
            n_fq += 1
            del x, s, got, want
        torch.cuda.empty_cache()
    banks = [time_bank_fwd(torch, P, e, R, C, 4, dev, gen)
             for e, R, C in TPM_BANKS]
    fused, acc = tp_moe_row_shapes(P)
    sub = {}
    n_w4 = check_w4a8_linears(torch, P, fused, dev, 62,
                              ms=(1, SLOTS, PREFILL_M))
    check_w4a8_acc(torch, P, None, dev, sub, shapes=acc, seed=63,
                   phase="phase 3u")
    errs, cases = {}, []
    for arch, tp, lengths, S in ((MS, 2, KVQ_LENGTHS, CACHE_LEN),
                                 (MX, 2, MX_LENGTHS, MX_WINDOW)):
        scfg = tp_shard_cfg(P["get_config"](arch), tp)
        what = (f"{arch} rank of tp={tp}: H {scfg.n_heads}, Hkv "
                f"{scfg.n_kv_heads}")
        got = check_decode_case(torch, P, gen, scfg, dev, lengths, S, False,
                                what)
        cases.append({"case": what, **got})
        for k, v in got.items():
            errs[k] = max(errs.get(k, 0.0), v)
        torch.cuda.empty_cache()
    ms_rank = tp_shard_cfg(P["get_config"](MS), 2)
    check_copy_multi(torch, P, ms_rank, dev, sub, layers=16,
                     report_key="tpm_copy_multi_bitwise")
    errs["pool_block_copy"] = 0.0
    errs["w4a8_matmul"] = 0.0
    errs["fake_quant_fwd"] = 0.0
    report["tp_moe_kernels"] = {"fake_quant_mode3_cases": n_fq,
                                "local_banks": banks, "w4a8_cases": n_w4,
                                "w4a8_accumulate": [a[1:] for a in acc],
                                "attention": cases}
    print(f"phase 3u: fake_quant_fwd mode 3 bitwise its plain version on "
          f"the ranks' local banks {list(TPM_BANKS)} (bits 4, 8); per "
          f"launch " + json.dumps(banks) + f"; w4a8 bitwise on {n_w4} shard "
          f"cases and the accumulate + epilogue at {[a[1:] for a in acc]}; "
          f"attention at the ranks' heads {cases}", flush=True)
    return errs


def tp_launches(tp_res, *names, serve=None):
    """{pass: {rank: launches}} of ``names`` (summed over the pass's
    serves, or in ``serve`` alone)."""
    return {key: {r: sum(l.get(n, 0) for s, l in v["launches"][r].items()
                         if serve in (None, s) for n in names)
                  for r in v["launches"]}
            for key, v in tp_res["passes"].items()}


def check_tp_pass(P, key, phase, cfg, tp, ref, out, cuda, reduced=False):
    """A pass's findings against its tp=1 reference: streams, counters,
    one decode step's logits and (on the pool) the cold wave's K/V codes
    at the rank's heads bitwise; the step's collectives ``tp_census``'s,
    no pool leaf in one; the bank fake-quants a step tp=1's count over
    E / tp experts; every serve's kernels launched on every rank (on the
    card); bytes a rank. Returns the pass's record."""
    what = f"{phase} {key} (tp={tp})"
    L = cfg.n_layers
    bf16 = key in TP_BF16
    streams_equal = {}
    for name, (want, _, _, _) in ref["serves"].items():
        got = out["streams"][key][name]
        differ = [u for u, s in got.items() if s != want[u]]
        streams_equal[name] = not differ
        # the bf16 layout's streams are weak evidence only: its f32
        # partial sums may flip a near-tie
        check(bf16 or not differ, f"{what} {name}: streams differ from "
                                  f"tp=1's for requests {differ}")
    serves = {n: (nz, names) for n, _, _, nz, names in
              tp_serves(P, key, cfg, reduced)}
    for name, (nz, _) in serves.items():
        c1 = ref["serves"][name][1]
        check(all(c1[k] > 0 for k in nz),
              f"{what} {name}: none of {nz} at tp=1: {c1}")
    want_census = tp_census(P, cfg, tp, bf16=bf16)
    ranks = [f[key] for _, f in out["ranks"]]
    for r, mine in zip((r for r, _ in out["ranks"]), ranks):
        who = f"{what} rank {r}"
        st = mine["step"]
        check(mine["checksums_equal"], f"{who}: its weights' checksums "
                                       f"differ from the parent's")
        bound = (Q3BF_DEPTH_FACTOR * ref["witness"]["logits_rel"]
                 if key == "q3bfd" else Q3BF_LOGIT_REL)
        check(st["logits_finite"] and (
            st["logits_rel"] <= bound if bf16 else st["logits_equal"]),
            f"{who}: one decode step's logits are not "
            + (f"within {bound} of tp=1's: {st['logits_rel']}"
               + (f" (the witness {ref['witness']['logits_rel']})"
                  if key == "q3bfd" else "") if bf16 else "bitwise tp=1's"))
        bad = [k for k, ok in st.get("state_equal", {}).items() if not ok]
        check(not bad, f"{who}: the recurrent states or rings {bad} "
                       f"differ from tp=1's after the wrap")
        check(key not in ("rg", "xl") or len(st["state_equal"]) > 0,
              f"{who}: no recurrent state compared")
        bad = [k for k, ok in st.get("prefill_pool_equal", {}).items()
               if not ok]
        check(not bad, f"{who}: the cold wave's {bad} differ from tp=1's "
                       f"at the rank's heads")
        check(not st.get("pool_in_collective"),
              f"{who}: a pool leaf was handed to a collective")
        census = {k: st["census"][k] for k in want_census}
        check(census == want_census, f"{who}: a decode step's collectives "
                                     f"{census}, want {want_census}")
        for name, s in mine["serves"].items():
            c, c1 = s["counters"], ref["serves"][name][1]
            for k in TP_COUNTERS:
                check(c.get(k) == c1.get(k),
                      f"{who} {name}: {k} {c.get(k)}, tp=1 {c1.get(k)}")
            if cuda:
                for n in serves[name][1]:
                    check(s["launches"][n] > 0,
                          f"{who} {name}: {n} never launched: "
                          f"{s['launches']}")
        fq, fq1 = (st["launches"]["fake_quant_fwd"],
                   ref["step"]["launches"]["fake_quant_fwd"])
        # the bf16 layout fake-quantizes every weight a forward (a rank
        # its slices): qwen2.5-3b's 7 a layer and the head
        want_fq = 3 * L if cfg.is_moe else (7 * L + 1 if bf16 else 0)
        check(fq == fq1 == (want_fq if cuda else 0),
              f"{who}: {fq} fake-quants a decode step, tp=1 {fq1}, "
              f"want {want_fq}")
        if cfg.is_moe:
            check(st["local_experts"] * tp == cfg.n_experts,
                  f"{who}: {st['local_experts']} local experts")
    # bytes a rank against tp=1's: the pool whole where every rank runs
    # the whole attention, else its heads; the packed planes at most
    # 1.1 / tp but for a whole attention; the expert banks E / tp experts
    share = {}
    for first in list(ref["serves"])[:1]:    # none at q3bfd
        c0 = ranks[0]["serves"][first]["counters"]
        c1 = ref["serves"][first][1]
        share = {k: c0[k] / c1[k] for k in TP_BYTES if c1.get(k)}
    whole = P["attn_replicated"](cfg, tp)
    if key in ("rg", "xl"):
        # the rings whole (one KV head), the sLSTM's recurrence and the
        # mLSTM's u whole: the states a half, the weights under a whole
        check(share["per_device_state_bytes"] <= (0.55 if reduced
                                                  else 0.51),
              f"{what}: a rank's recurrent state {share}")
        check(share["per_device_weight_bytes"] <= (1.1 / tp if key == "rg"
                                                   else 0.8),
              f"{what}: a rank's packed planes {share}")
    elif share:
        check(share["per_device_pool_bytes"] == 1.0 if whole
              else share["per_device_pool_bytes"] <= 1.1 / tp,
              f"{what}: a rank's pool {share}")
        check(share["per_device_weight_bytes"] < 1.0 if whole
              else share["per_device_weight_bytes"] <= 1.1 / tp,
              f"{what}: a rank's served weights {share}")
    if cfg.is_moe:
        check(share["per_device_bank_bytes"] * tp == 1.0,
              f"{what}: a rank's expert banks {share}")
    s0 = ranks[0]["step"]
    return {
        "arch": cfg.name, "layers": L, "tp": tp, "backend": "gloo",
        "streams": {n: len(s) for n, s in out["streams"][key].items()},
        "counters_tp1": {n: s[1] for n, s in ref["serves"].items()},
        "counters": [{n: s["counters"] for n, s in m["serves"].items()}
                     for m in ranks],
        "bytes_share_of_tp1": share, "census_per_decode_step": s0["census"],
        "collectives_serve": {n: s["collectives"]
                              for n, s in ranks[0]["serves"].items()},
        "launches": {r: {n: s["launches"] for n, s in m["serves"].items()}
                     for (r, _), m in zip(out["ranks"], ranks)},
        "step_launches": {r: m["step"]["launches"]
                          for (r, _), m in zip(out["ranks"], ranks)},
        "bank_fq_launches_per_step": s0["launches"]["fake_quant_fwd"],
        "local_experts": s0["local_experts"],
        "bank_fq_ms_per_step": [m["step"]["bank_fq_ms"] for m in ranks],
        "bank_fq_ms_per_step_tp1": ref["step"]["bank_fq_ms"],
        "peak_memory_bytes": [m["peak_memory_bytes"] for m in ranks],
        "peak_memory_bytes_tp1": ref["peak_memory_bytes"],
        "rank_setup_s": [m["setup_s"] for m in ranks],
        "one_step_ms": [m["step"].get("one_step_ms") for m in ranks],
        "one_step_ms_tp1": ref["step"].get("one_step_ms"),
        "streams_equal_tp1": streams_equal,
        "logits_rel_l2": [m["step"]["logits_rel"] for m in ranks],
        "residual_rel_l2_by_layer": s0.get("residual_rel"),
        "witness": ref["witness"] and {
            "logits_rel_l2": ref["witness"]["logits_rel"],
            "residual_rel_l2_by_layer": ref["witness"]["residual_rel"],
            "tp_logits_rel_l2": s0.get("witness_logits_rel"),
            "tp_residual_rel_l2_by_layer": s0.get("witness_residual_rel")},
        "states_compared": len(s0.get("state_equal", {}))}


async def fe_session(asyncio, P, cfg, eng):
    """The tp=2 frontend's session on its lead engine (rank 0's, or tp=1's
    for the reference): phase 3o's HTTP pass (a warm request, then
    FRONTEND_STREAMS SSE streams and one blocking completion on the
    shared prefix), a burst on the same engine (BURST_ONTIME requests
    without a deadline, BURST_HOPELESS whose 1 us deadline its measured
    rates already miss: shed), then FE_TP_POISSON Poisson arrivals at
    FE_TP_RATE a second (POISSON_DEADLINE_MS each), whose frontend's
    closing stops the followers. Returns the streams in submission
    order and the burst's shed flags."""
    import numpy as np
    reqs = shared_prefix_requests(P, cfg, FRONTEND_STREAMS + 2, 0, seed=21)
    for r in reqs:
        r.max_new_tokens = FRONTEND_NEW
    warm, streamed, blocking = reqs[0], reqs[1:-1], reqs[-1]
    burst = shared_prefix_requests(P, cfg, BURST_ONTIME + BURST_HOPELESS,
                                   100, seed=22)
    out = {}
    async with P["AsyncFrontend"](eng, stop_followers=False) as fe:
        async with P["ServeHTTP"](fe, port=0) as srv:
            port = srv.port
            code, _ = await http_request(asyncio, port, "POST",
                                         "/v1/completions",
                                         frontend_body(warm))
            check(code == 200, f"phase 3o tp: warm request HTTP {code}")
            tasks = [asyncio.create_task(sse_completion(
                asyncio, port, frontend_body(r))) for r in streamed]
            tasks.append(asyncio.create_task(http_request(
                asyncio, port, "POST", "/v1/completions",
                frontend_body(blocking))))
            outs = await asyncio.gather(*tasks)
        code, body = outs[-1]
        check(code == 200, f"phase 3o tp: blocking completion HTTP {code}")
        out["sse"] = [o["tokens"] for o in outs[:-1]]
        out["blocking"] = json.loads(body)["choices"][0]["token_ids"]
        hs = [await fe.submit(r.prompt, max_new_tokens=FRONTEND_NEW,
                              deadline_ms=None if i < BURST_ONTIME
                              else 1e-3)
              for i, r in enumerate(burst)]
        out["burst"] = [await h.tokens() for h in hs]
        out["burst_shed"] = [h.shed for h in hs]
    gaps = np.random.default_rng(23).exponential(1.0 / FE_TP_RATE,
                                                 FE_TP_POISSON)
    poisson = shared_prefix_requests(P, cfg, FE_TP_POISSON, 200, seed=24)
    async with P["AsyncFrontend"](eng) as fe:
        due = time.perf_counter() + np.cumsum(gaps)
        hs = []
        for r, at in zip(poisson, due):
            await asyncio.sleep(max(0.0, at - time.perf_counter()))
            hs.append(await fe.submit(r.prompt, max_new_tokens=FRONTEND_NEW,
                                      deadline_ms=POISSON_DEADLINE_MS))
        out["poisson"] = [await h.tokens() for h in hs]
    return out


def fe_pass(torch, P, cfg, params, dev, mesh=None):
    """Phase 3o at tp=2: qwen2.5-3b's paged engine (EDF, reject shedding)
    on ``params``; rank 0 (or tp=1, without a mesh) runs ``fe_session``
    through the frontend and HTTP, a rank > 0 runs ``engine.follow()``
    until rank 0's last frontend stops it. Every rank lists the requests
    its engine enqueued (rank 0's submissions, a follower's broadcast
    copies): its timeline, each request's prompt length, tokens and shed
    and done flags in order. Launches are counted over the pass."""
    import asyncio
    eng = paged_engine(P, cfg, params, dev, sched_policy="edf",
                       slo_shed="reject", mesh=mesh)
    lead = mesh is None or mesh.rank == 0
    seen = []
    if lead:
        submit = eng.submit

        def recorded_submit(req):
            submit(req)
            seen.append(req)
        eng.submit = recorded_submit
    counted = tp_counted(P)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    if lead:
        out = asyncio.run(fe_session(asyncio, P, cfg, eng))
    else:               # returns at rank 0's stop
        seen = eng.follow()
        out = {}
    sync(torch, dev)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = {n: fn.launches for n, fn in counted.items()}
    out["timeline"] = [(len(r.prompt), tuple(r.generated), r.shed, r.done)
                       for r in seen]
    st = eng.stats()
    out["stats"] = {k: st[k] for k in (
        "requests_finished", "requests_shed", "decode_steps",
        "prefix_hit_tokens", "cow_copies", "tail_waves")}
    if eng._comm is not None:
        out["collectives"] = eng._comm.counts()
    del eng
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return out


def check_fe_pass(P, tp, ref, out, cuda):
    """The tp=2 frontend against tp=1's: the SSE streams and the blocking
    completion bitwise, the burst's shed flags (every hopeless request
    shed, none on time); every rank's timeline rank 0's (the Poisson
    pass's too; a follower's ends at rank 0's stop, since its ``follow``
    returns only then); on the card each
    rank's w4a8 accumulate, epilogue and paged decode launched. Returns
    the pass's record."""
    what = f"phase 3o (tp={tp})"
    f1 = ref["fe"]
    ranks = [f["fe"]["fe"] for _, f in out["ranks"]]
    f0 = ranks[0]
    check(f0["sse"] == f1["sse"], f"{what}: SSE streams differ from tp=1's")
    check(f0["blocking"] == f1["blocking"],
          f"{what}: the blocking completion differs from tp=1's")
    want = [False] * BURST_ONTIME + [True] * BURST_HOPELESS
    check(f0["burst_shed"] == f1["burst_shed"] == want,
          f"{what}: burst shed {f0['burst_shed']}, tp=1 "
          f"{f1['burst_shed']}, want {want}")
    check(f0["burst"][:BURST_ONTIME] == f1["burst"][:BURST_ONTIME],
          f"{what}: the burst's on-time streams differ from tp=1's")
    for (r, _), f in zip(out["ranks"], ranks):
        check(f["timeline"] == f0["timeline"],
              f"{what}: rank {r}'s timeline differs from rank 0's")
        check(f["stats"] == f0["stats"],
              f"{what}: rank {r}'s counters {f['stats']}, rank 0's "
              f"{f0['stats']}")
        if cuda:
            for n in ("w4a8_accumulate", "w4a8_epilogue",
                      "kvq_paged_decode_attn"):
                check(f["launches"][n] > 0,
                      f"{what}: rank {r} never launched {n}")
    for f in (f0, f1):
        check(len(f["poisson"]) == FE_TP_POISSON, f"{what}: Poisson pass")
    return {"arch": "qwen2.5-3b", "tp": tp, "backend": "gloo",
            "sse_streams": len(f0["sse"]), "burst_shed": sum(f0[
                "burst_shed"]), "poisson": FE_TP_POISSON,
            "timeline_requests": len(f0["timeline"]),
            "counters": f0["stats"], "counters_tp1": f1["stats"],
            "collectives": f0.get("collectives"),
            "launches": {r: {"frontend": f["launches"]} for (r, _), f in
                         zip(out["ranks"], ranks)},
            "wall_s": [f["wall_s"] for f in ranks], "wall_s_tp1":
                f1["wall_s"],
            "peak_memory_bytes": [f["fe"]["peak_memory_bytes"]
                                  for _, f in out["ranks"]],
            "poisson_streams_equal_tp1": f0["poisson"] == f1["poisson"]}


def tpv_linear_shapes(P, tp=TP):
    """(fused (name, K, N, bias), accumulate (name, K, N)) of phase 3v's
    shard linears at tp=2: recurrentgemma-2b's column-parallel linears
    (the RG-LRU's w_in / w_gate over the width and its gates' w_ig / w_rg
    from the whole width, q, the whole KV head's k / v, gate / up, the
    tied head's vocabulary half) and row-parallel ones (w_out, o, down);
    xlstm-125m's (the mLSTM's w_up with u whole and its heads of z, q / k
    / v by heads, its gates' heads, the sLSTM's whole w_x and r_h, its
    up-projection half, the head's half; the mLSTM's and sLSTM's
    w_down)."""
    rg, xl = P["get_config"](RG), P["get_config"](XLSTM)
    W, d = rg.resolved_lru_width, rg.d_model
    fused = [("rg w_in/w_gate", d, W // tp, False),
             ("rg w_ig/w_rg", W, W // tp, False),
             ("rg q", d, rg.q_dim // tp, False),
             ("rg k/v", d, rg.kv_dim, False),
             ("rg gate/up", d, rg.d_ff // tp, False),
             ("rg head", d, rg.vocab_size // tp, False)]
    acc = [("rg w_out", W // tp, d), ("rg o", rg.q_dim // tp, d),
           ("rg down", rg.d_ff // tp, d)]
    xd = xl.d_model
    m = int(xl.mlstm_proj_factor * xd)
    s_in = int(xl.slstm_proj_factor * xd)
    fused += [("xl mlstm w_up", xd, m + m // tp, False),
              ("xl q/k/v", m, m // tp, False),
              ("xl gates", m, 2 * xl.n_heads // tp, True),
              ("xl w_x", xd, 4 * xd, True), ("xl r_h", xd, 4 * xd, False),
              ("xl slstm w_up", xd, s_in // tp, False),
              ("xl head", xd, xl.vocab_size // tp, False)]
    acc += [("xl mlstm w_down", m // tp, xd),
            ("xl slstm w_down", s_in // tp, xd)]
    return fused, acc


def q3bf_fq_shapes(P, tp=TP):
    """(name, full (R, C), the rank's slice (rows, cols), per-row scale,
    bits) of the bf16 layout's fake-quantized weights at tp=2 on
    qwen2.5-3b: column-parallel q, k, v, gate, up (their output
    channels' half, scales too), row-parallel o, down (their input rows'
    half, scales whole), the tied head (the embedding's vocabulary half,
    a scale a row, 8 bits)."""
    c = P["get_config"]("qwen2.5-3b")
    d, f = c.d_model, c.d_ff
    col = [("q", d, c.q_dim), ("k/v", d, c.kv_dim), ("gate/up", d, f)]
    row = [("o", c.q_dim, d), ("down", f, d)]
    return ([(n, (R, C), (R, C // tp), False, 4) for n, R, C in col]
            + [(n, (R, C), (R // tp, C), False, 4) for n, R, C in row]
            + [("head", (c.vocab_size, d), (c.vocab_size // tp, d), True,
                8)])


def check_tp_recurrent_kernels(torch, P, dev, report):
    """Phase 3v's kernels at the ranks' shapes, against their plain
    versions: w4a8 fused bitwise on the shard linears and the
    accumulate + epilogue on the row-parallel K slices
    (``tpv_linear_shapes``); at recurrentgemma-2b's rank (5 query heads
    over the whole KV head, D 256) the dense decode over rings of 2048
    rows (full, empty, ragged), the paged decode, verify and gather
    (``check_decode_case``); fake_quant_fwd at the bf16 pass's shard
    shapes (``q3bf_fq_shapes``) bitwise its plain version and the whole
    weight's result's slice, rank 0's and rank 1's slices. Returns the
    worst error per kernel."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(71)
    fused, acc = tpv_linear_shapes(P)
    sub = {}
    n_w4 = check_w4a8_linears(torch, P, fused, dev, 72,
                              ms=(1, SLOTS, PREFILL_M))
    check_w4a8_acc(torch, P, None, dev, sub, shapes=acc, seed=73,
                   phase="phase 3v")
    rg = P["get_config"](RG)
    scfg = rg.replace(n_heads=rg.n_heads // TP, n_kv_heads=1,
                      head_dim=rg.resolved_head_dim)
    what = (f"{RG} rank of tp={TP}: H {scfg.n_heads}, Hkv 1, D "
            f"{scfg.resolved_head_dim}")
    errs = check_decode_case(torch, P, gen, scfg, dev, RG_LENGTHS,
                             RG_WINDOW, False, what)
    torch.cuda.empty_cache()
    ops, ref = P["fq_ops"], P["fq_ref"]
    n_fq = 0
    for name, (R, C), (r, c), per_row, bits in q3bf_fq_shapes(P):
        w = (torch.randn((R, C), generator=gen, device=dev) * 0.05).to(
            torch.bfloat16)
        shape = (R, 1) if per_row else (1, C)
        sc = torch.rand(shape, generator=gen, device=dev) * 0.01 + 0.002
        whole = ops.fake_quant_fwd(w, sc, bits)
        for rank in range(TP):
            rows = slice(rank * r, (rank + 1) * r) if r < R else slice(None)
            cols = slice(rank * c, (rank + 1) * c) if c < C else slice(None)
            ws = w[rows, cols].contiguous()
            ss = (sc[rows] if per_row else sc[:, cols]).contiguous()
            got = ops.fake_quant_fwd(ws, ss, bits)
            torch.cuda.synchronize()
            check(torch.equal(got, ref.fake_quant_fwd_ref(ws, ss, bits))
                  and torch.equal(got, whole[rows, cols]),
                  f"phase 3v: fake_quant_fwd on the bf16 layout's {name} "
                  f"shard {tuple(ws.shape)} (rank {rank}) differs from "
                  f"its plain version or from the whole weight's slice")
            n_fq += 1
        del w, sc, whole
        torch.cuda.empty_cache()
    errs = {**errs, "w4a8_matmul": 0.0, "w4a8_accumulate": 0.0,
            "fake_quant_fwd": 0.0}
    report["tp_recurrent_kernels"] = {
        "w4a8_cases": n_w4, "w4a8_fused": [f[:3] for f in fused],
        "w4a8_accumulate": [a for a in acc], "attention": what,
        "fake_quant_cases": n_fq}
    print(f"phase 3v: w4a8 bitwise on {n_w4} shard cases "
          f"{[f[1:3] for f in fused]} and the accumulate + epilogue at "
          f"{[a[1:] for a in acc]}; {what}: decode within one ulp of "
          f"plain ({errs['kvq_decode_attn']:.3g}), paged, verify and "
          f"gather; fake_quant_fwd bitwise plain and the whole weight's "
          f"slice on {n_fq} bf16 shards", flush=True)
    return errs


def serve_tp(torch, P, dev, report, reduced=False):
    """Phases 3t and 3u: tensor-parallel serving, ranks in processes of
    their own on the one card over gloo (``launch.mesh.spawn_tp``,
    backend passed explicitly: NCCL refuses two ranks on one device), one
    spawn for the passes of one tp (``TP_PASSES``): qwen2.5-3b at full
    width and depth at tp=2 (3t: phase 3b's requests on the pool, phase
    3c's spec config); moonshot-v1-16b-a3b (16 of 48 layers, tp=2: 32 of
    64 experts and 8 of 16 heads a rank, the pool with prefix sharing
    and spec at k 4 with an 8-layer draft), mixtral-8x7b (4 of 32
    layers, tp=2: 4 of 8 experts, 16 of 32 query and 4 of 8 KV heads a
    rank, dense rings of 4096 that wrap) and qwen2-7b (2 of 28 layers,
    tp=8, which does not divide its 28 heads: the whole attention and
    pool on every rank, the MLP, embedding and head cut in eight), each
    at full width (3u). Every pass's tp=1 reference runs first in this
    process and is freed; then ``check_tp_pass``. The kernels at the
    ranks' shapes are checked against their plain versions first."""
    errs = {}
    if not reduced:
        for got in (check_tp_kernels(torch, P, P["get_config"]("qwen2.5-3b"),
                                     dev, report),
                    check_tp_moe_kernels(torch, P, dev, report),
                    check_tp_recurrent_kernels(torch, P, dev, report)):
            for k, v in got.items():
                errs[k] = max(errs.get(k, 0.0), v)
        torch.cuda.empty_cache()
    cuda = torch.device(dev).type == "cuda"
    passes = {}
    for tp in sorted({p[4] for p in TP_PASSES}):
        group = [p for p in TP_PASSES if p[4] == tp]
        refs, cfgs, pins = {}, {}, []
        t0 = time.perf_counter()
        for key, _, arch, layers, _, calibrate in group:
            cfgs[key] = tp_cfg(P, arch, layers, reduced)
            refs[key] = tp_reference(torch, P, key, cfgs[key], calibrate,
                                     dev, reduced)
            pins.append({"key": key, "arch": arch, "layers": layers,
                         "calibrate": calibrate,
                         "checksums": refs[key]["checksums"],
                         "logits": refs[key].get("logits"),
                         "pool": refs[key].get("pool"),
                         "cache": refs[key].get("step", {}).pop("cache",
                                                                None),
                         "residual": refs[key].get("step", {}).pop(
                             "residual", None),
                         "tok": refs[key].get("step", {}).pop("tok", None),
                         "witness": refs[key].get("witness")})
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = P["spawn_tp"](tp_rank, tp, {"passes": pins,
                                          "reduced": reduced},
                            device=torch.device(dev).type, backend="gloo",
                            timeout_s=TP_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        check(out["ranks_agree"], f"tp={tp}: the ranks' streams differ")
        for key, phase, *_ in group:
            if key == "fe":
                rec = check_fe_pass(P, tp, refs[key], out, cuda)
                rec.update(phase=phase, references_s=ref_s, spawn_s=spawn_s)
                passes[key] = rec
                print(f"{phase} at tp={tp} (gloo, ranks on "
                      f"{report.get('card')}): the frontend and HTTP on "
                      f"rank 0, the other rank following its engine: "
                      f"{rec['sse_streams']} SSE streams and the blocking "
                      f"completion bitwise tp=1's, {rec['burst_shed']} of "
                      f"the burst shed as at tp=1, {rec['poisson']} Poisson "
                      f"arrivals; every rank's timeline of "
                      f"{rec['timeline_requests']} requests rank 0's, the "
                      f"follower stopped by rank 0; wall {rec['wall_s']} s "
                      f"(tp=1 {rec['wall_s_tp1']:.1f}); collectives "
                      f"{rec['collectives']}", flush=True)
                continue
            rec = check_tp_pass(P, key, phase, cfgs[key], tp, refs[key],
                                out, cuda, reduced)
            rec.update(phase=phase, references_s=ref_s, spawn_s=spawn_s)
            passes[key] = rec
            print(f"{phase} {key} (tp={tp}, gloo, ranks on "
                  f"{report.get('card')}): {rec['arch']} at {rec['layers']}"
                  f" layers, streams ({rec['streams']}), counters, "
                  + (f"one decode step's logits within {Q3BF_LOGIT_REL} of "
                     f"tp=1's (relative L2 {rec['logits_rel_l2']}; streams "
                     f"equal tp=1's, weak evidence: "
                     f"{rec['streams_equal_tp1']}; each layer's residual "
                     f"{rec['residual_rel_l2_by_layer']})" if key == "q3bf"
                     else f"one decode step's logits within "
                     f"{Q3BF_DEPTH_FACTOR}x the witness's gap (tp=1 with "
                     f"its GEMMs' f32 sums rounded once; tp=1's decode "
                     f"tokens on every path): " + json.dumps(
                         {"tp2_vs_tp1": rec["logits_rel_l2"],
                          "tp2_vs_tp1_by_layer":
                              rec["residual_rel_l2_by_layer"],
                          **rec["witness"]})
                     if key == "q3bfd" else
                     f"one decode step's logits, K/V"
                     + (f" and {rec['states_compared']} state and ring "
                        f"leaves" if rec["states_compared"] else "")
                     + " bitwise tp=1's")
                  + f"; bytes a "
                  f"rank {rec['bytes_share_of_tp1']} of tp=1's; a decode "
                  f"step's collectives {rec['census_per_decode_step']}; "
                  f"bank fake-quants a step "
                  f"{rec['bank_fq_launches_per_step']} over "
                  f"{rec['local_experts']} experts, "
                  f"{rec['bank_fq_ms_per_step']} ms (tp=1 "
                  f"{rec['bank_fq_ms_per_step_tp1']}); one step "
                  f"{rec['one_step_ms']} ms (tp=1 {rec['one_step_ms_tp1']};"
                  f" gloo through host memory, not a speed); peak a rank "
                  f"{[round(b / 1e9, 2) for b in rec['peak_memory_bytes']]}"
                  f" GB; references {ref_s:.1f} s, spawn {spawn_s:.1f} s",
                  flush=True)
        del refs, out
    res = {"passes": passes, "kernel_errs": errs, "card": report.get("card"),
           "kernels": report.get("tp_moe_kernels", {}),
           "note": "ranks in processes of their own on one card over gloo "
                   "(tensors through host memory): a check of the path, "
                   "not a speed"}
    report["serve_tp"] = res
    return res


# --------------------------------------------------------------------------
# phase 5d: data-parallel QAT, qwen2.5-3b on two ranks of the one card
# --------------------------------------------------------------------------

DP = 2
DP_LAYERS = 4
DP_STEPS = 2
DP_TIMEOUT_S = 420
# the data-2 global loss against one process: the first step's within
# 1e-5; a later step's within 1e-4, since Adam's first step is
# lr * sign(g) and an element whose gradient sits at its rounding error
# moves the other way on one side (1.1e-5 at step 1, call 3 of PR 29)
DP_LOSS_RTOL, DP_LATER_LOSS_RTOL = 1e-5, 1e-4
# per leaf, L2: 2^-7 of the leaf (its bf16 shares summed in f32 and
# rounded once) plus 1e-6 of the whole gradient (tests/test_torch_train.py's
# absolute term). The attention's key bias is the exception: softmax is
# invariant to a shift of every key a query sees, so its true gradient is
# zero and the computed one is the residue of a cancelling sum, which the
# ranks' split moves (1.09e-2 relative, calls 1-2 of PR 29): it is held
# to 2e-2, the bound tests/test_torch_train.py holds a port gradient to
DP_GRAD_RTOL, DP_GRAD_ATOL_GLOBAL = 2.0 ** -7, 1e-6
DP_KEY_BIAS_RTOL = 2e-2
DIGEST_CHUNK = 2 ** 24         # elements a digest chunk


def dp_cfg(P, reduced=False):
    """Phase 5b's cut: qwen2.5-3b at full width and 4 layers (the reduced
    config as it is where the phase is rehearsed on the CPU)."""
    if reduced:
        return P["get_reduced_config"]("qwen2.5-3b")
    return P["get_config"]("qwen2.5-3b").replace(n_layers=DP_LAYERS)


def dp_tcfg(P, comp="none"):
    return P["TrainConfig"](precision="A8d-C8-W4", total_steps=DP_STEPS,
                            ref_steps=DP_STEPS, batch_size=TRAIN_B,
                            seq_len=TRAIN_T, grad_compression=comp)


def tree_digest(torch, tensors):
    """Per leaf, the bits summed as integers and weighted by position
    (mod 2^64): equal trees give equal digests, and a changed element
    changes its leaf's (two changes cancel only by chance)."""
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        flat = t.detach().reshape(-1)
        bits = flat.view(torch.int16 if t.element_size() == 2 else
                         torch.int32)
        acc = 0
        for lo in range(0, bits.numel(), DIGEST_CHUNK):
            b = bits[lo:lo + DIGEST_CHUNK].long()
            w = torch.arange(lo, lo + b.numel(), device=b.device) % 65521 + 1
            acc += int((b * w).sum()) + int(b.sum()) * 7919
        out.append(acc)
    return out


def dp_first_batch(P, cfg, dev, mesh=None):
    """run_qat's first global batch (this rank's rows on a mesh)."""
    tcfg = dp_tcfg(P)
    data = P["SyntheticConfig"](vocab_size=cfg.vocab_size, seq_len=TRAIN_T,
                                batch_size=TRAIN_B,
                                dclm_ratio=tcfg.dclm_ratio, seed=tcfg.seed)
    return next(P["ShardedLoader"](P["MixtureIterator"](data, start_step=1),
                                   mesh=mesh, device=dev))


def dp_rank(mesh, inp):
    """One rank of phase 5d: ``run_qat`` at data 2 from the seed (no
    teacher steps, as the one-process reference), MSE calibration. Before
    the first step (``on_start``): the synced gradient of the first batch
    against the one-process gradient (leaf by leaf), and the int8 sync
    against the exact one; each step's launches, split and a digest of
    the parameters and moments; after the run one data-parallel teacher
    pretraining step; on rank 0 one loss and backward through the kernels
    against the plain versions. Returns rank 0's report with every
    rank's launches and digests."""
    import torch
    import torch.distributed as dist
    P = import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    cuda = dev.type == "cuda"
    cfg, tcfg = dp_cfg(P, inp["reduced"]), dp_tcfg(P)
    steps_mod, models = P["steps"], P["models"]
    out = {"rank": mesh.data_rank, "steps": []}
    state = {}
    t_start = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    def grad_checks(student):
        teacher = models.init_params(cfg, seed=tcfg.seed, device=dev)
        batch = dp_first_batch(P, cfg, dev, mesh)
        step = steps_mod.make_train_step(cfg, tcfg, mesh=mesh)
        loss, grads = step.loss_and_grads(student, teacher, batch)
        out["loss0"] = float(loss)
        ref = torch.load(inp["ref_path"], mmap=True)
        leaves = list(P["named_leaves"](grads))
        gaps = {}                        # leaf: (|g - g_one|, |g_one|)
        for k, g in leaves:
            r = ref[k]
            if g is None or r is None:
                check(g is None and r is None,
                      f"5d: gradient {k} only on one side")
                continue
            r = r.to(dev).float()
            gaps[k] = (float(torch.linalg.vector_norm(g.float() - r)),
                       float(torch.linalg.vector_norm(r)))
        del ref
        total = math.sqrt(sum(n * n for _, n in gaps.values()))
        rel = {k: e / n for k, (e, n) in gaps.items() if n > 0}
        out["grad_leaves"] = len(gaps)
        out["grad_leaves_past_bound"] = [
            (k, e, n) for k, (e, n) in gaps.items()
            if e > (DP_KEY_BIAS_RTOL * n if k.endswith("attn/wk/b") else
                    DP_GRAD_RTOL * n + DP_GRAD_ATOL_GLOBAL * total)]
        out["grad_total_l2"] = total
        bias = {k: v for k, v in rel.items() if k.endswith("attn/wk/b")}
        out["key_bias_max_rel_l2"] = max(bias.values(), default=0.0)
        rest = {k: v for k, v in rel.items() if k not in bias}
        worst_key = max(rest, key=rest.get)
        out["grad_max_rel_l2"], out["grad_worst_leaf"] = (rest[worst_key],
                                                          worst_key)
        wire_f32 = step.dp.wire["f32"]
        # the int8 sync on the same local gradients
        step8 = steps_mod.make_train_step(cfg, dp_tcfg(P, "int8"), mesh=mesh)
        _, local = step8.local_loss_and_grads(student, teacher, batch)
        lv = P["tree_leaves"](local)
        amax = torch.stack([torch.max(torch.abs(g.float() * DP))
                            if g is not None else torch.zeros((), device=dev)
                            for g in lv])
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=mesh.data_group)
        synced = P["tree_leaves"](step8.sync(local))
        del local, lv
        err = step8.error_feedback()
        num = den = 0.0
        worst8, over_step, over_err = 0.0, [], []
        for (k, g), q, e, a in zip(leaves, synced, err, amax.tolist()):
            if g is None:
                continue
            d = (q.float() - g.float()).abs()
            # each side's cast to bf16: half an ulp, 2^-8 relative at most
            ulp = (torch.maximum(q.float().abs(), g.float().abs())
                   * 2.0 ** -7 if g.dtype == torch.bfloat16 else 0.0)
            if bool((d > a / 254.0 * (1 + 1e-6) + ulp).any()):
                over_step.append(k)
            if float(e.abs().max()) > a / 100.0:
                over_err.append(k)
            dn = float(torch.linalg.vector_norm(d))
            gn = float(torch.linalg.vector_norm(g.float()))
            num, den = num + dn * dn, den + gn * gn
            if gn > 0 and dn / gn > worst8:
                worst8 = dn / gn
        out["int8"] = {"rel_l2": math.sqrt(num / den),
                       "worst_leaf_rel_l2": worst8,
                       "leaves_past_half_step": over_step,
                       "leaves_residual_past_amax_100": over_err,
                       "wire_bytes_int8": step8.dp.wire["int8"],
                       "wire_bytes_f32": wire_f32}
        del step8, synced, err, grads, teacher, step
        if cuda:
            torch.cuda.empty_cache()

    def on_start(student, opt):
        t0 = time.perf_counter()
        grad_checks(student)
        out["grad_checks_s"] = time.perf_counter() - t0
        state["counts"] = [fn.launches for fn in train_counters(P)]

    def on_step(step, metrics, student, opt):
        counts = [fn.launches for fn in train_counters(P)]
        digest = tree_digest(torch, P["tree_leaves"](
            (student, opt.m, opt.v)))
        out["steps"].append({"step": step, "loss": float(metrics["loss"]),
                             "ms": metrics["ms"],
                             "launches": [a - b for a, b in
                                          zip(counts, state["counts"])],
                             "digest": digest})
        state["counts"] = counts

    teacher, student, _ = P["train"].run_qat(
        "qwen2.5-3b", tcfg, reduced=inp["reduced"], teacher_steps=0,
        n_layers=None if inp["reduced"] else DP_LAYERS, mesh=mesh,
        log_every=1, split_times=True, on_start=on_start, on_step=on_step)
    sync(torch, dev)
    out["run_s"] = time.perf_counter() - t_start
    # one data-parallel teacher pretraining step (the student freed)
    del student
    if cuda:
        torch.cuda.empty_cache()
    for p in P["tree_leaves"](teacher):
        p.requires_grad_(True)
    opt = P["adamw_init"](teacher)
    pre = P["train"].make_teacher_pretrain_step(cfg, mesh=mesh)
    teacher, opt, tloss = pre(teacher, opt, dp_first_batch(P, cfg, dev,
                                                           mesh))
    out["teacher_step"] = {"loss": float(tloss), "digest": tree_digest(
        torch, P["tree_leaves"]((teacher, opt.m, opt.v)))}
    del opt, pre
    for p in P["tree_leaves"](teacher):
        p.requires_grad_(False)
    if cuda:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    mine = {k: out[k] for k in ("rank", "loss0", "grad_max_rel_l2",
                                "grad_worst_leaf", "grad_leaves_past_bound",
                                "grad_total_l2", "key_bias_max_rel_l2",
                                "teacher_step")}
    mine["steps"] = [{k: s[k] for k in ("step", "loss", "launches",
                                        "digest")} for s in out["steps"]]
    mine["int8_ok"] = (not out["int8"]["leaves_past_half_step"]
                       and not out["int8"]["leaves_residual_past_amax_100"])
    mine["peak_memory_bytes"] = out.get("peak_memory_bytes")
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    out["ranks"] = ranks
    if mesh.data_rank == 0 and cuda:
        report = {}
        student = P["train"].calibrate(cfg, P["tree_map"](
            lambda t: t.detach().clone(), teacher), tcfg,
            P["SyntheticConfig"](vocab_size=cfg.vocab_size,
                                 seq_len=TRAIN_T, batch_size=TRAIN_B))
        for p in P["tree_leaves"](student):
            p.requires_grad_(True)
        grads_vs_plain(torch, P, cfg, tcfg, teacher, student, dev, report,
                       key="train_dp_vs_plain", phase="phase 5d")
        out["vs_plain"] = report["train_dp_vs_plain"]
    dist.barrier()
    return out


def train_dp(torch, P, dev, report, reduced=False, ref_dir=None):
    """Phase 5d: data-parallel QAT of qwen2.5-3b at full width and 4
    layers on two processes of the one card over gloo (NCCL refuses two
    ranks on one device), against this process's one-process run of the
    same global batches from the same seed. With ``ref_dir`` the
    one-process run's first gradient, its losses and its parameters
    after the last step stay there for phase 5t (the caller removes
    it)."""
    import tempfile
    import shutil
    t_phase = time.perf_counter()
    cfg, tcfg = dp_cfg(P, reduced), dp_tcfg(P)
    tmp = ref_dir or tempfile.mkdtemp(prefix="chip_smoke_dp_")
    ref_path = str(Path(tmp) / "grads.pt")
    one = {"losses": []}

    def on_start(student, opt):
        teacher = P["models"].init_params(cfg, seed=tcfg.seed, device=dev)
        step = P["steps"].make_train_step(cfg, tcfg)
        loss, grads = step.loss_and_grads(
            student, teacher, dp_first_batch(P, cfg, dev))
        one["loss0"] = float(loss)
        torch.save({k: None if g is None else g.detach().cpu()
                    for k, g in P["named_leaves"](grads)}, ref_path)
        del grads
        if ref_dir:
            # phase 5t's witness: this step with its row-parallel linears'
            # GEMMs as f32 products rounded once
            with row_f32_witness(P, [teacher, student]):
                loss, grads = step.loss_and_grads(
                    student, teacher, dp_first_batch(P, cfg, dev))
            one["loss0_witness"] = float(loss)
            torch.save({k: None if g is None else g.detach().cpu()
                        for k, g in P["named_leaves"](grads)},
                       str(Path(tmp) / "witness.pt"))
            del grads
        del teacher

    def on_step(step, metrics, student, opt):
        one["losses"].append(float(metrics["loss"]))

    try:
        t0 = time.perf_counter()
        _, student, _ = P["train"].run_qat(
            "qwen2.5-3b", tcfg, reduced=reduced, teacher_steps=0,
            n_layers=None if reduced else DP_LAYERS, device=dev,
            log_every=1, on_start=on_start, on_step=on_step)
        sync(torch, dev)
        one_s = time.perf_counter() - t0
        if ref_dir:
            torch.save({"loss0": one["loss0"], "losses": one["losses"],
                        "loss0_witness": one["loss0_witness"],
                        "params": {k: t.detach().cpu() for k, t in
                                   P["named_leaves"](student)}},
                       str(Path(tmp) / "one_process.pt"))
        del student
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        got = P["spawn"](dp_rank, DP, {"ref_path": ref_path,
                                       "reduced": reduced},
                         device=torch.device(dev).type, backend="gloo",
                         timeout_s=DP_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
    finally:
        if not ref_dir:
            shutil.rmtree(tmp, ignore_errors=True)
    ranks = got["ranks"]
    n_w = 7 * cfg.n_layers + 1
    for r in ranks:
        check(len(r["steps"]) == DP_STEPS,
              f"5d rank {r['rank']}: {len(r['steps'])} steps ran")
        for s in r["steps"]:
            if torch.device(dev).type == "cuda":
                check(s["launches"] == [n_w, n_w, cfg.n_layers, 0],
                      f"5d rank {r['rank']} step {s['step']}: launches "
                      f"(fake_quant_fwd, fake_quant_bwd, flash_attn_fwd, "
                      f"slstm_scan) = {s['launches']}, want ({n_w}, {n_w}, "
                      f"{cfg.n_layers}, 0)")
            check(math.isfinite(s["loss"]), f"5d: loss {s['loss']}")
        check(not r["grad_leaves_past_bound"],
              f"5d rank {r['rank']}: synced gradients "
              f"{r['grad_leaves_past_bound']} off the one-process gradient "
              f"past {DP_GRAD_RTOL} of the leaf + {DP_GRAD_ATOL_GLOBAL} of "
              f"the whole {r['grad_total_l2']} (L2; the key bias "
              f"{DP_KEY_BIAS_RTOL}): (leaf, gap, norm)")
        check(r["int8_ok"], f"5d rank {r['rank']}: the int8 sync passed "
                            f"half a quantization step, or its residual "
                            f"amax / 100: {got['int8']}")
    for i in range(DP_STEPS):
        digests = {repr(r["steps"][i]["digest"]) for r in ranks}
        check(len(digests) == 1, f"5d: the replicas' parameters and "
                                 f"moments differ after step {i}")
    check(len({repr(r["teacher_step"]["digest"]) for r in ranks}) == 1,
          "5d: the replicas differ after the teacher pretraining step")
    losses = [s["loss"] for s in got["steps"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, one["losses"])]
    check(len(rel) == DP_STEPS and rel[0] <= DP_LOSS_RTOL
          and max(rel) <= DP_LATER_LOSS_RTOL,
          f"5d: global losses {losses} vs one process {one['losses']}")
    rel0 = abs(got["loss0"] - one["loss0"]) / abs(one["loss0"])
    check(rel0 <= DP_LOSS_RTOL, f"5d: first-batch loss {got['loss0']} vs "
                                f"one process {one['loss0']}")
    per = {k: sum(s["ms"][k] for s in got["steps"][1:])
           / max(len(got["steps"]) - 1, 1)
           for k in ("teacher", "student", "sync", "optimizer")}
    launches = {"fake_quant_fwd": got["steps"][-1]["launches"][0],
                "fake_quant_bwd": got["steps"][-1]["launches"][1],
                "flash_attn_fwd": got["steps"][-1]["launches"][2]}
    res = {"data": DP, "backend": "gloo", "card": report.get("card"),
           "layers": cfg.n_layers, "global_batch": TRAIN_B,
           "rows_a_rank": TRAIN_B // DP, "seq": TRAIN_T,
           "losses": losses, "losses_one_process": one["losses"],
           "loss_rel_err": max(rel), "loss0_rel_err": rel0,
           "grad_max_rel_l2": max(r["grad_max_rel_l2"] for r in ranks),
           "grad_worst_leaf": got["grad_worst_leaf"],
           "key_bias_max_rel_l2": max(r["key_bias_max_rel_l2"]
                                      for r in ranks),
           "grad_leaves": got["grad_leaves"], "int8": got["int8"],
           "ms_split": per, "ms_first_step": got["steps"][0]["ms"],
           "launches_per_rank_step": launches,
           "peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
           "teacher_step_loss": got["teacher_step"]["loss"],
           "grad_checks_s": got["grad_checks_s"], "rank_run_s": got["run_s"],
           "one_process_s": one_s, "spawn_s": spawn_s,
           "phase_s": time.perf_counter() - t_phase,
           "vs_plain": got.get("vs_plain"),
           "note": "two processes on one card over gloo (tensors through "
                   "host memory): a check of the data-parallel path, not a "
                   "speed"}
    report["train_dp"] = res
    print(f"phase 5d: qwen2.5-3b data-parallel QAT at data={DP} "
          f"({cfg.n_layers} layers, global B {TRAIN_B} x T {TRAIN_T}, gloo, "
          f"two ranks on {report.get('card')}): global losses {losses} vs "
          f"one process {one['losses']} (rel {max(rel):.2e}); synced "
          f"gradients within {res['grad_max_rel_l2']:.2e} relative L2 of "
          f"one process ({res['grad_worst_leaf']}); replicas bitwise after "
          f"every step; int8 sync rel L2 {got['int8']['rel_l2']:.4f} of "
          f"the exact one, wire bytes a rank int8 "
          f"{got['int8']['wire_bytes_int8']} vs f32 "
          f"{got['int8']['wire_bytes_f32']}; step ms {per} (gloo, one "
          f"card: not a speed); launches a rank a step {launches}; peak "
          f"{res['peak_memory_bytes']} B a rank; phase "
          f"{res['phase_s']:.1f} s", flush=True)
    print("phase 5d: " + json.dumps(res), flush=True)
    return res


# --------------------------------------------------------------------------
# phase 5t: tensor-parallel QAT (model > 1) on four ranks of the card
# --------------------------------------------------------------------------

TPT_RANKS = 4
TPT_STEPS = DP_STEPS
TPT_TIMEOUT_S = 600
# (pass, model ranks, attention mode): data 1 x model 4 in the mode
# attn_shard_mode_for picks (kv_rep: 2 KV heads), the same mesh with seq
# forced, and data 2 x model 2 in "" with the data sync
TPT_PASSES = (("kv_rep", 4, None), ("seq", 4, "seq"), ("dp2", 2, None))
# against the one-process step of phase 5d (same config, seed, batches):
# the loss (the ranks' f32 partials of wo / wd summed in another order
# than cuBLAS's bf16 GEMM sums them; 0 on the CPU at the reduced width,
# at most 1.55e-5 on an H100 80GB HBM3 at 700 W)
TPT_LOSS_RTOL = 1e-4
# per gradient leaf (L2): within WITNESS_MULT times the witness's
# distance (``row_f32_witness``: one process with wo's and wd's GEMMs as
# f32 products rounded once, what the forward's sums do) plus the CPU
# tests' bound for the backward's own sums (the ranks' partial input
# gradients summed in f32 where one process accumulates them in bf16:
# tests/test_torch_tp_train.py, 2^-6 of the leaf plus 1e-6 of the whole;
# the key bias, whose true gradient is zero, 4e-2); the whole tree the
# same way (WITNESS_MULT times the witness's plus 2^-6; on the CPU at the
# reduced width, B 8 x T 128: 6.8e-3 against a witness of 2.3e-3; on an
# H100: 1.40e-2 to 1.60e-2 against the witness's 1.59e-2)
TPT_GRAD_RTOL, TPT_KEY_BIAS_RTOL = 2.0 ** -6, 4e-2
WITNESS_MULT = 2.0
# the flash kernel at seq's shapes: a rank's 32 query rows at their global
# positions over the 128 keys (TPT_ROWS rows a rank at model 4)
TPT_ROWS = TRAIN_T // TPT_RANKS
TPT_FLASH_WINDOW = 48


def tpt_shard_shapes(cfg, m):
    """(site, R, C, mode, bits, launches a rank's student step): every
    weight shard a rank fake-quantizes at model ``m`` (wq / wk / wv / wg /
    wu column-parallel, wo / wd row-parallel, the tied head per row of
    this rank's vocabulary rows) over TPT layers (phase 5d's 4)."""
    d, f, qd, kvd = cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.kv_dim
    L = DP_LAYERS
    return [(f"wq/{m}", d, qd // m, 1, 4, L), (f"wk/{m}", d, kvd // m, 1, 4, L),
            (f"wv/{m}", d, kvd // m, 1, 4, L), (f"wo/{m}", qd // m, d, 1, 4, L),
            (f"wg/{m}", d, f // m, 1, 4, L), (f"wu/{m}", d, f // m, 1, 4, L),
            (f"wd/{m}", f // m, d, 1, 4, L),
            (f"head/{m}", cfg.vocab_size // m, d, 2, 8, 1)]


@contextlib.contextmanager
def row_f32_witness(P, trees):
    """The one-process step as a witness of the row-parallel sums: while
    it is open, ``models.blocks.qlinear`` runs each layer's ``wo`` and
    ``wd`` of ``trees`` as the f32 product of the quantized input and
    weight rounded once (as model ranks sum their f32 partials and round
    once, ``core.qat._qlinear_row_bf16``), every other linear as it is.
    Its distance from the one-process step is the yardstick of phase 5t's
    (as ``tp_witness`` is of phase 3v's)."""
    B, qat = P["blocks"], P["qat"]
    rows = {id(layer[b][n]) for t in trees for layer in t["layers"]
            for b, n in (("attn", "wo"), ("mlp", "wd"))}
    orig = B.qlinear

    def qlinear(ctx, x, p, col=None, act_bits=None, weight_bits=None,
                row=False, shards=1):
        if id(p) not in rows:
            return orig(ctx, x, p, col, act_bits=act_bits,
                        weight_bits=weight_bits, row=row, shards=shards)
        xq = qat.quantize_act(ctx, x, p, "s_in", col, bits=act_bits)
        wq = qat.quantize_weight_p(ctx, p, bits=weight_bits)
        y = (xq.float() @ wq.float()).to(xq.dtype)
        if "b" in p:
            y = y + p["b"].to(y.dtype)
        return y

    B.qlinear = qlinear
    try:
        yield
    finally:
        B.qlinear = orig


def flash_offset_oracle(torch, q, k, v, q_offset, window):
    """:func:`flash_oracle` for query rows at positions ``q_offset + i``."""
    B, S, H, D = q.shape
    g = H // k.shape[2]
    kr = k.double().repeat_interleave(g, dim=2)
    vr = v.double().repeat_interleave(g, dim=2)
    s_ = torch.einsum("bqhd,bkhd->bhqk", q.double(), kr) * D ** -0.5
    i = q_offset + torch.arange(S, device=q.device)
    j = torch.arange(k.shape[1], device=q.device)
    mask = i[:, None] >= j[None, :]
    if window:
        mask &= i[:, None] - j[None, :] < window
    s_ = s_.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s_, -1), vr).float()


def check_tp_train_kernels(torch, P, cfg, dev, report):
    """Phase 2 at phase 5t's shapes: flash_attn_fwd at seq's shapes (a
    rank's TPT_ROWS query rows over all 128 keys) at q_offset 0, 32, 64
    and 96, causal and under a window, against its plain version and the
    f64 oracle at the same offsets (as ``check_flash`` holds it); flash at
    kv_rep's and ""'s per-rank head counts; the fake-quant kernels on
    every weight shard of model 4 and model 2 (dx bitwise, ds within
    FQ_DS_TOL). Returns the worst flash error."""
    fa, ref = P["fa_ops"].flash_attn_fwd, P["flash_attn_ref"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    rtol, atol = FLASH_TOL
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    cases, worst = [], 0.0
    for window in (0, TPT_FLASH_WINDOW):
        for off in range(0, TRAIN_T, TPT_ROWS):
            q = torch.randn((TRAIN_B, TPT_ROWS, H, D), generator=gen,
                            device=dev).to(torch.bfloat16)
            k, v = (torch.randn((TRAIN_B, TRAIN_T, Hkv, D), generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2))
            got = fa(q, k, v, causal=True, window=window,
                     q_offset=off).float()
            want = ref(q, k, v, causal=True, window=window,
                       q_offset=off).float()
            oracle = flash_offset_oracle(torch, q, k, v, off, window)
            err = (got - want).abs()
            beyond = float((err > KVQ_TOL[1] + KVQ_TOL[0] * want.abs())
                           .float().mean())
            e_k = float((got - oracle).abs().max())
            e_p = float((want - oracle).abs().max())
            case = {"q_offset": off, "window": window, "rows": TPT_ROWS,
                    "keys": TRAIN_T, "max_abs_err": float(err.max()),
                    "share_beyond_one_ulp": beyond, "kernel_vs_oracle": e_k,
                    "plain_vs_oracle": e_p}
            check(bool(torch.isfinite(got).all())
                  and torch.allclose(got, want, rtol=rtol, atol=atol)
                  and beyond <= FLASH_ULP_SHARE
                  and e_k <= FLASH_ORACLE_RATIO * e_p,
                  f"flash_attn_fwd at q_offset {off} differs from its plain "
                  f"version: {case}")
            cases.append(case)
            worst = max(worst, float(err.max()))
            del q, k, v, got, want, oracle, err
    heads = []
    for m, hq in ((4, H // 4), (2, H // 2)):    # kv_rep at 4, "" at 2
        c = check_flash_case(torch, P, gen, cfg.replace(
            n_heads=hq, n_kv_heads=1, head_dim=D), dev, TRAIN_B, TRAIN_T, 0)
        heads.append(dict(c, model=m))
        worst = max(worst, c["max_abs_err"])
    fq_cases = [(site, R, C, mode, 0) for m in (TPT_RANKS, 2)
                for site, R, C, mode, _, _ in tpt_shard_shapes(cfg, m)]
    n, worst_ds = fq_case_checks(torch, P, gen, fq_cases, dev)
    report["tp_train_kernels"] = {"flash_q_offset": cases,
                                  "flash_rank_heads": heads,
                                  "fake_quant_shards": n,
                                  "fake_quant_ds_rel_mass_err": worst_ds}
    print(f"phase 2: flash_attn_fwd at q_offset {list(range(0, TRAIN_T, TPT_ROWS))}"
          f" ({TPT_ROWS} rows over {TRAIN_T} keys, causal and window "
          f"{TPT_FLASH_WINDOW}) and at a rank's heads (kv_rep 4, \"\" 8 over "
          f"one KV head) within rtol {rtol} atol {atol} of its plain "
          f"version (worst {worst:.3g}); fake_quant on {n} model-4 and "
          f"model-2 weight shards bitwise (dx), ds within {worst_ds:.3g} of "
          f"its mass", flush=True)
    return worst


def time_tp_train_kernels(torch, P, cfg, dev, report):
    """Phase 4 at phase 5t's shapes: one flash launch at seq's last rank
    (q_offset 96: 32 rows over 128 keys) beside its plain version and
    SDPA with the offset causal mask as a boolean ``attn_mask`` (its
    ``is_causal`` cannot offset), and its bound; a rank's fake-quant
    forward and backward a student step at model 4 (29 weight shards)
    beside their plain versions and ``fake_quantize_per_channel_affine``
    (``time_fake_quant``)."""
    import torch.nn.functional as F
    fa, ref = P["fa_ops"].flash_attn_fwd, P["flash_attn_ref"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    off = TRAIN_T - TPT_ROWS

    def inputs():
        return (torch.randn((TRAIN_B, TPT_ROWS, H, D), generator=gen,
                            device=dev).to(torch.bfloat16),
                *(torch.randn((TRAIN_B, TRAIN_T, Hkv, D), generator=gen,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2)))

    base = inputs()
    sets = [base] + [inputs() for _ in range(copies_for(
        tensor_bytes(*base)) - 1)]
    t_k = time_ms(torch, lambda q, k, v: fa(q, k, v, causal=True,
                                            q_offset=off), sets)
    t_p = time_ms(torch, lambda q, k, v: ref(q, k, v, causal=True,
                                             q_offset=off), sets[:2],
                  min_calls=10)
    i = off + torch.arange(TPT_ROWS, device=dev)
    mask = i[:, None] >= torch.arange(TRAIN_T, device=dev)[None, :]
    lib = [tuple(t.transpose(1, 2) for t in st) for st in sets]
    t_l = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True), lib)
    pairs = sum(off + r + 1 for r in range(TPT_ROWS))
    flops = 4 * TRAIN_B * H * D * pairs
    nbytes = 2 * (2 * TRAIN_B * TPT_ROWS * H * D
                  + 2 * TRAIN_B * TRAIN_T * Hkv * D)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_PEAK_FLOPS
    flash = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
             "bound_ms": max(t_b, t_o) * 1e3,
             "bound_by": "bytes" if t_b >= t_o else "operations",
             "per": f"one launch at B={TRAIN_B}, {TPT_ROWS} query rows at "
                    f"q_offset {off} over {TRAIN_T} keys, H={H}, Hkv={Hkv}, "
                    f"D={D}, causal (phase 5t's seq pass, a rank's layer)"}
    del sets, lib
    torch.cuda.empty_cache()
    fwd, bwd = time_fake_quant(torch, P, cfg, dev, {},
                               shapes=tpt_shard_shapes(cfg, TPT_RANKS))
    per = (f"a rank's student step at model {TPT_RANKS}: "
           f"{7 * DP_LAYERS + 1} weight shards ({DP_LAYERS} layers x 7 + "
           f"the head's vocabulary rows)")
    out = {"flash_q_offset": flash, "fake_quant_fwd": dict(fwd, per=per),
           "fake_quant_bwd": dict(bwd, per=per), "card": report.get("card")}
    report["tp_train_times"] = out
    print(f"phase 4: 5t shapes: flash at q_offset {off}: {t_k * 1e3:.2f} us "
          f"(bound {flash['bound_ms'] * 1e3:.2f} us by {flash['bound_by']}), "
          f"plain {t_p * 1e3:.1f} us, SDPA with the mask {t_l * 1e3:.2f} us; "
          f"fake_quant a rank's step fwd {fwd['ms']:.4f} ms (bound "
          f"{fwd['bound_ms']:.4f}), bwd {bwd['ms']:.4f} ms (bound "
          f"{bwd['bound_ms']:.4f})", flush=True)
    return out


def tpt_digest(torch, tensors):
    """A digest of a list of tensors' bits (``tree_digest`` summed)."""
    return repr(tree_digest(torch, tensors))


def tpt_rank(mesh, inp):
    """One rank of phase 5t: ``run_qat`` at model > 1 from the seed (no
    teacher steps, MSE calibration, as phase 5d's one process) in each of
    TPT_PASSES on this spawn's four ranks. Before the first step
    (``on_start``): the first batch's loss and gradients through a step
    of the same mesh and mode, gathered and held (on global rank 0)
    against the one-process gradient, with that call's collective census;
    each step's launches, split, loss and digests (the leaves every rank
    holds whole; this rank's whole state); after the run the parameters
    gathered and held against the one-process run's. The calibration of
    the whole tree is the same computation in every pass, so a rank runs
    it once and hands each pass a copy."""
    import torch
    import torch.distributed as dist
    P = import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    cuda = dev.type == "cuda"
    gr = dist.get_rank()
    cfg, tcfg = dp_cfg(P, inp["reduced"]), dp_tcfg(P)
    SH = P["sharding"]
    meshes = {TPT_RANKS: mesh, 2: P["make_local_mesh"](2, device=dev)}
    ref = torch.load(inp["ref_path"], mmap=True)
    wit = torch.load(inp["witness_path"], mmap=True)
    one = torch.load(inp["one_path"], mmap=True)
    train = P["train"]
    calibrate, memo = train.calibrate, {}

    def calibrate_once(cfg_, params, tcfg_, data_cfg):
        if "tree" not in memo:
            memo["tree"] = P["tree_map"](lambda t: t.detach().clone(),
                                         calibrate(cfg_, params, tcfg_,
                                                   data_cfg))
        return P["tree_map"](lambda t: t.clone(), memo["tree"])

    train.calibrate = calibrate_once
    out = {"passes": {}}
    try:
        for key, m, mode in TPT_PASSES:
            msh = meshes[m]
            res = {"model": m, "data": TPT_RANKS // m, "steps": []}
            state = {}
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)

            def on_start(student, opt, msh=msh, mode=mode, res=res,
                         state=state):
                t0 = time.perf_counter()
                teacher = P["models"].init_params(cfg, seed=tcfg.seed,
                                                  device=dev)
                step = P["steps"].make_train_step(cfg, tcfg, mesh=msh,
                                                  attn_shard_mode=mode)
                amode = step.attn_mode
                dims = SH.cut_dims(teacher, cfg, msh, amode)
                state["dims"], res["mode"] = dims, amode
                teacher = SH.shard_params(teacher, cfg, msh, amode)
                loss, grads = step.loss_and_grads(
                    student, teacher, dp_first_batch(P, cfg, dev, msh))
                res["loss0"] = float(loss)
                res["census"] = dict(step.tp.counts())
                res["census_bytes"] = dict(step.tp.bytes)
                grads = P["tree_map"](
                    lambda g, p: torch.zeros_like(p) if g is None else g,
                    grads, student)
                whole = SH.gather_params(grads, dims, step.tp)
                del grads, teacher
                if gr == 0:
                    gaps = {}               # leaf: (gap, witness gap, norm)
                    for k, g in P["named_leaves"](whole):
                        r, w = ref[k], wit[k]
                        r = (torch.zeros_like(g) if r is None else
                             r.to(dev)).float()
                        w = (torch.zeros_like(g) if w is None else
                             w.to(dev)).float()
                        gaps[k] = tuple(float(torch.linalg.vector_norm(a))
                                        for a in (g.float() - r, w - r, r))
                    total = math.sqrt(sum(n * n for *_, n in gaps.values()))
                    rel = {k: e / n for k, (e, _, n) in gaps.items() if n > 0}
                    res["grad_leaves"] = len(gaps)
                    res["grad_tree_rel_l2"] = math.sqrt(sum(
                        e * e for e, _, _ in gaps.values())) / total
                    res["witness_tree_rel_l2"] = math.sqrt(sum(
                        w * w for _, w, _ in gaps.values())) / total
                    res["grad_past_bound"] = [
                        (k, e, w, n) for k, (e, w, n) in gaps.items()
                        if e > WITNESS_MULT * w + (
                            TPT_KEY_BIAS_RTOL if k.endswith("attn/wk/b")
                            else TPT_GRAD_RTOL) * n
                        + DP_GRAD_ATOL_GLOBAL * total]
                    rest = {k: v for k, v in rel.items()
                            if not k.endswith("attn/wk/b")}
                    worst = max(rest, key=rest.get)
                    res["grad_max_rel_l2"] = rest[worst]
                    res["grad_worst_leaf"] = worst
                    res["key_bias_max_rel_l2"] = max(
                        (v for k, v in rel.items()
                         if k.endswith("attn/wk/b")), default=0.0)
                del whole
                res["grad_checks_s"] = time.perf_counter() - t0
                state["counts"] = [fn.launches for fn in train_counters(P)]
                if cuda:
                    torch.cuda.empty_cache()

            def on_step(i, metrics, student, opt, res=res, state=state):
                counts = [fn.launches for fn in train_counters(P)]
                cut = {k for k, d in state["dims"].items() if d is not None}
                named = list(P["named_leaves"](student))
                whole = [t for k, t in named if k not in cut]
                res["steps"].append({
                    "loss": float(metrics["loss"]), "ms": metrics["ms"],
                    "launches": [a - b for a, b in
                                 zip(counts, state["counts"])],
                    "replicated": tpt_digest(torch, whole + [
                        t for k, t in P["named_leaves"](opt.m)
                        if k not in cut]),
                    "state": tpt_digest(torch, P["tree_leaves"](
                        (student, opt.m, opt.v)))})
                state["counts"] = counts

            t0 = time.perf_counter()
            _, student, _ = train.run_qat(
                "qwen2.5-3b", tcfg, reduced=inp["reduced"], teacher_steps=0,
                n_layers=None if inp["reduced"] else DP_LAYERS, mesh=msh,
                attn_shard_mode=mode, log_every=100, split_times=True,
                on_start=on_start, on_step=on_step)
            sync(torch, dev)
            res["run_s"] = time.perf_counter() - t0
            comm = P["TPComm"](msh)
            params = SH.gather_params(student, state["dims"], comm)
            del student
            if gr == 0:
                num = den = 0.0
                past = []
                for k, t in P["named_leaves"](params):
                    t = t.detach()
                    w = one["params"][k].to(dev).float()
                    # Adam moves an element by at most lr a step (50x on
                    # an activation scale): a gradient at its rounding
                    # error moves it either way; plus a bf16 ulp
                    mult = 50.0 if k.split("/")[-1] in P["qat"].ACT_SCALE_KEYS \
                        else 1.0
                    lim = 2 * inp["lr_sum"] * mult
                    d = (t.float() - w).abs()
                    ulp = (torch.maximum(t.float().abs(), w.abs()) * 2.0 ** -7
                           if t.dtype == torch.bfloat16 else 0.0)
                    if bool((d > lim + ulp).any()):
                        past.append(k)
                    num += float(torch.linalg.vector_norm(d)) ** 2
                    den += float(torch.linalg.vector_norm(w)) ** 2
                res["params_past_bound"] = past
                res["params_rel_l2"] = math.sqrt(num / den)
            del params
            if cuda:
                res["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
                torch.cuda.empty_cache()
            mine = {"rank": gr, "model_rank": msh.rank,
                    "data_rank": msh.data_rank,
                    "steps": [{k: s_[k] for k in ("replicated", "state",
                                                  "launches", "loss")}
                              for s_ in res["steps"]],
                    "peak_memory_bytes": res.get("peak_memory_bytes")}
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, mine)
            res["ranks"] = ranks
            out["passes"][key] = res
    finally:
        train.calibrate = calibrate
    dist.barrier()
    return out


def train_tp(torch, P, dev, report, ref_dir, reduced=False):
    """Phase 5t: tensor-parallel QAT of qwen2.5-3b at full width and 4
    layers on four processes of the one card over gloo, in the passes of
    TPT_PASSES, against phase 5d's one-process run (``ref_dir``: its
    first gradient, losses and final parameters)."""
    t_phase = time.perf_counter()
    cfg, tcfg = dp_cfg(P, reduced), dp_tcfg(P)
    one = torch.load(str(Path(ref_dir) / "one_process.pt"), mmap=True)
    lr_sum = sum(float(P["cosine_schedule"](
        i, base_lr=tcfg.scaled_lr(), total_steps=tcfg.total_steps,
        warmup_steps=tcfg.warmup_steps, min_lr_ratio=tcfg.min_lr_ratio))
        for i in range(TPT_STEPS))
    got = P["spawn"](tpt_rank, TPT_RANKS, {
        "ref_path": str(Path(ref_dir) / "grads.pt"),
        "witness_path": str(Path(ref_dir) / "witness.pt"),
        "one_path": str(Path(ref_dir) / "one_process.pt"),
        "reduced": reduced, "lr_sum": lr_sum},
        model_parallel=TPT_RANKS, device=torch.device(dev).type,
        backend="gloo", timeout_s=TPT_TIMEOUT_S)
    cuda = torch.device(dev).type == "cuda"
    n_w = 7 * cfg.n_layers + 1
    res = {"card": report.get("card"), "layers": cfg.n_layers,
           "global_batch": TRAIN_B, "seq": TRAIN_T, "backend": "gloo",
           "losses_one_process": one["losses"],
           "loss0_witness": one["loss0_witness"], "passes": {},
           "note": "four processes on one card over gloo (tensors through "
                   "host memory): a check of the tensor-parallel path, not "
                   "a speed"}
    for key, m, mode in TPT_PASSES:
        r = got["passes"][key]
        losses = [s_["loss"] for s_ in r["steps"]]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, one["losses"])]
        rel0 = abs(r["loss0"] - one["loss0"]) / abs(one["loss0"])
        per = {k: sum(s_["ms"][k] for s_ in r["steps"][1:])
               / max(len(r["steps"]) - 1, 1)
               for k in ("teacher", "student", "tp", "sync", "optimizer")}
        last = r["steps"][-1]["launches"]
        res["passes"][key] = {
            "mode": r["mode"], "model": m, "data": TPT_RANKS // m,
            "losses": losses, "loss0": r["loss0"],
            "loss_rel_err": max(rel + [rel0]),
            "grad_tree_rel_l2": r["grad_tree_rel_l2"],
            "witness_tree_rel_l2": r["witness_tree_rel_l2"],
            "grad_max_rel_l2": r["grad_max_rel_l2"],
            "grad_worst_leaf": r["grad_worst_leaf"],
            "key_bias_max_rel_l2": r["key_bias_max_rel_l2"],
            "grad_leaves": r["grad_leaves"],
            "grad_leaves_past_bound": r["grad_past_bound"],
            "params_rel_l2": r["params_rel_l2"],
            "params_past_bound": r["params_past_bound"],
            "ms_split": per, "ms_first_step": r["steps"][0]["ms"],
            "census_loss_and_grads": r["census"],
            "census_bytes": r["census_bytes"],
            "launches_per_rank_step": {"fake_quant_fwd": last[0],
                                       "fake_quant_bwd": last[1],
                                       "flash_attn_fwd": last[2]},
            "peak_memory_bytes": [rk["peak_memory_bytes"]
                                  for rk in r["ranks"]],
            "grad_checks_s": r["grad_checks_s"], "run_s": r["run_s"]}
    res["phase_s"] = time.perf_counter() - t_phase
    report["train_tp"] = res
    for key, v in res["passes"].items():
        print(f"phase 5t {key}: qwen2.5-3b QAT at data {v['data']} x model "
              f"{v['model']} ({v['mode']!r}; {cfg.n_layers} layers, B "
              f"{TRAIN_B} x T {TRAIN_T}, gloo, on {report.get('card')}): "
              f"losses {v['losses']} vs one process {one['losses']} (rel "
              f"{v['loss_rel_err']:.2e}); gradients {v['grad_tree_rel_l2']:.2e}"
              f" of the tree off one process (the witness "
              f"{v['witness_tree_rel_l2']:.2e}), worst leaf "
              f"{v['grad_max_rel_l2']:.2e} ({v['grad_worst_leaf']}), key "
              f"bias {v['key_bias_max_rel_l2']:.2e}; parameters within "
              f"{v['params_rel_l2']:.2e} (tree L2); step ms "
              f"{v['ms_split']}; census {v['census_loss_and_grads']}; "
              f"launches a rank a step {v['launches_per_rank_step']}; peak "
              f"{v['peak_memory_bytes']} B", flush=True)
    print(f"phase 5t: {res['phase_s']:.1f} s; " + json.dumps(res),
          flush=True)
    for key, m, mode in TPT_PASSES:
        r, v = got["passes"][key], res["passes"][key]
        for rk in r["ranks"]:
            check(len(rk["steps"]) == TPT_STEPS,
                  f"5t {key} rank {rk['rank']}: {len(rk['steps'])} steps")
            for s_ in rk["steps"]:
                if cuda:
                    check(s_["launches"] == [n_w, n_w, cfg.n_layers, 0],
                          f"5t {key} rank {rk['rank']}: launches "
                          f"(fake_quant_fwd, fake_quant_bwd, flash_attn_fwd, "
                          f"slstm_scan) = {s_['launches']}, want ({n_w}, "
                          f"{n_w}, {cfg.n_layers}, 0)")
                check(math.isfinite(s_["loss"]), f"5t {key}: loss "
                                                 f"{s_['loss']}")
        for i in range(TPT_STEPS):
            check(len({rk["steps"][i]["replicated"]
                       for rk in r["ranks"]}) == 1,
                  f"5t {key}: the leaves every rank holds whole differ "
                  f"across the ranks after step {i}")
            for mr in range(m):
                check(len({rk["steps"][i]["state"] for rk in r["ranks"]
                           if rk["model_rank"] == mr}) == 1,
                      f"5t {key}: the data replicas of model rank {mr} "
                      f"differ after step {i}")
        check(v["loss_rel_err"] <= TPT_LOSS_RTOL,
              f"5t {key}: global losses {v['losses']} (first batch "
              f"{v['loss0']}) vs one process {one['losses']} "
              f"({one['loss0']}) past {TPT_LOSS_RTOL}")
        tree_bound = WITNESS_MULT * v["witness_tree_rel_l2"] + TPT_GRAD_RTOL
        check(v["grad_tree_rel_l2"] <= tree_bound,
              f"5t {key}: the gathered gradient {v['grad_tree_rel_l2']} of "
              f"the tree off one process, past {tree_bound} "
              f"({WITNESS_MULT}x the witness's + {TPT_GRAD_RTOL})")
        check(not v["grad_leaves_past_bound"],
              f"5t {key}: gathered gradients {v['grad_leaves_past_bound']} "
              f"off the one-process gradient past {WITNESS_MULT}x the "
              f"witness's gap + {TPT_GRAD_RTOL} of the leaf + "
              f"{DP_GRAD_ATOL_GLOBAL} of the whole (the key bias "
              f"{TPT_KEY_BIAS_RTOL}): (leaf, gap, witness gap, norm)")
        check(not v["params_past_bound"],
              f"5t {key}: gathered parameters {v['params_past_bound']} "
              f"moved past 2 lr (50x on activation scales) + a bf16 ulp "
              f"from the one-process run's")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this check runs only "
              "on a GPU", file=sys.stderr)
        return 1
    try:
        P = import_port()
    except ImportError as e:
        print(f"chip_smoke: cannot import the port next to this script "
              f"({e}); run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # exact f32 plain matmul
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    report = {}
    t_start = time.perf_counter()
    laps = report["phase_times_s"] = {}
    t_lap = [t_start]

    def lap(name):
        """Seconds since the last lap, under the phases just run."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    report["card"] = card
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    libs = P["build"].build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"phase 1: built {sorted(libs)} in {report['build_s']:.1f} s",
          flush=True)
    lap("1")

    cfg = P["get_config"]("qwen2.5-3b")
    xcfg = P["get_config"](XLSTM)
    w4a8_err = check_w4a8(torch, P, cfg, xcfg, dev, report)
    kvq_err = check_kvq(torch, P, cfg, dev, report)
    check_kvq_bitwise(torch, P, cfg, dev, report)
    paged_err = check_paged_decode(torch, P, cfg, dev, report)
    check_paged_rows(torch, P, cfg, dev, report)
    check_paged_scratch(torch, P, cfg, dev)
    gather_err = check_gather(torch, P, cfg, dev, report)
    copy_err = check_copy(torch, P, cfg, dev, report)
    spec_err = check_spec_verify(torch, P, cfg, dev, report)
    check_norm_rows(torch, P, cfg, dev, report)
    fq_err = check_fake_quant(torch, P, cfg, dev, report)
    check_cut_fake_quant(torch, P, dev, report)
    flash_err = check_flash(torch, P, cfg, dev, report)
    tpt_flash_err = check_tp_train_kernels(torch, P, cfg, dev, report)
    rcfg = P["get_config"](RG)
    rg_err = check_rg_kernels(torch, P, cfg, rcfg, dev, report)
    mx_err = check_mx_kernels(torch, P, dev, report)
    torch.cuda.empty_cache()
    new_err = check_new_kernels(torch, P, dev, report)
    torch.cuda.empty_cache()
    wv_err = check_wv_kernels(torch, P, dev, report)
    torch.cuda.empty_cache()
    slstm_err = check_slstm(torch, P, xcfg, dev, report)
    lap("2")
    launches, eng = serve(torch, P, cfg, dev, report)
    profile_decode(torch, P, cfg, eng, report)
    params = eng.params                 # packed exports, bf16 linears gone
    del eng
    torch.cuda.empty_cache()
    prefill_rows(torch, P, cfg, dev, params, report)
    paged_launches, eng, plain_streams = serve_paged(torch, P, cfg, dev,
                                                     params, report)
    profile_decode(torch, P, cfg, eng, report, key="serve_paged")
    del eng
    check_paged_logits(torch, P, cfg, dev, params, report)
    spec_launches = serve_spec(torch, P, cfg, dev, params, report,
                               plain_streams)
    torch.cuda.empty_cache()
    lap("3-3c")
    tp = serve_tp(torch, P, dev, report)
    torch.cuda.empty_cache()
    lap("3t-3v")
    serve_self_draft(torch, P, cfg, dev, params, report)
    check_tail_rows(torch, P, cfg, dev, params, report)
    serve_optimistic(torch, P, cfg, dev, params, report)
    fe_launches = serve_frontend(torch, P, cfg, dev, params, report)
    del params
    torch.cuda.empty_cache()
    lap("3d-3o")
    train_launches, teacher, student = train_full(torch, P, cfg, dev, report)
    torch.cuda.empty_cache()
    lap("5")
    ptq_launches = ptq_full(torch, P, cfg, dev, teacher, student, report)
    del student
    torch.cuda.empty_cache()
    lap("7")
    c16_decode(torch, P, cfg, dev, teacher, report)
    del teacher
    torch.cuda.empty_cache()
    train_static(torch, P, cfg, dev, report)
    torch.cuda.empty_cache()
    lap("3h-5b")
    import tempfile
    import shutil
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        dp = train_dp(torch, P, dev, report, ref_dir=ref_dir)
        torch.cuda.empty_cache()
        lap("5d")
        tpt = train_tp(torch, P, dev, report, ref_dir)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    lap("5t")
    serve_xlstm(torch, P, xcfg, dev, report)
    xlstm_train_launches = train_xlstm(torch, P, xcfg, dev, report)
    torch.cuda.empty_cache()
    lap("3f-6")
    rg_launches = serve_rg(torch, P, rcfg, dev, report)
    rg_train_launches = train_rg(torch, P, rcfg, dev, report)
    torch.cuda.empty_cache()
    lap("3g-6b")
    mx_launches = serve_mx(torch, P, dev, report)
    torch.cuda.empty_cache()
    mx_train_launches = train_mx(torch, P, dev, report)
    torch.cuda.empty_cache()
    lap("3i-6c")
    ms_launches, ms_spec_launches = serve_ms(torch, P, dev, report)
    torch.cuda.empty_cache()
    ms_train_launches = train_cut(torch, P, dev, report, MS,
                                  MS_TRAIN_LAYERS, "train_ms", "phase 6d")
    torch.cuda.empty_cache()
    lap("3j-6d")
    q32 = serve_cut(torch, P, dev, report, Q32, Q32_SERVE_LAYERS,
                    "serve_q32", "phase 3k", paged=True)
    q7 = serve_cut(torch, P, dev, report, Q7, 0, "serve_q7", "phase 3l")
    q14_train_launches = train_cut(torch, P, dev, report, Q14,
                                   Q14_TRAIN_LAYERS, "train_q14",
                                   "phase 6e")
    torch.cuda.empty_cache()
    lap("3k-6e")
    wh = serve_wh(torch, P, dev, report)
    wh_train = train_direct(torch, P, dev, report, WH, WH_TRAIN_B, TRAIN_T,
                            "train_wh", "phase 6f")
    vl = serve_vl(torch, P, dev, report)
    vl_train = train_direct(torch, P, dev, report, VL, TRAIN_B, TRAIN_T,
                            "train_vl", "phase 6g")
    torch.cuda.empty_cache()
    lap("3m-6g")
    w4a8_t = time_w4a8(torch, P, cfg, dev, report)
    w4a8_tp_t = time_w4a8_acc(torch, P, cfg, dev)
    report["w4a8_tp_shard_times"] = w4a8_tp_t
    kvq_t = time_kvq(torch, P, cfg, dev, report)
    paged_t = time_paged_decode(torch, P, cfg, dev, report)
    gather_t = time_gather(torch, P, cfg, dev, report)
    copy_t = time_copy(torch, P, cfg, dev, report)
    spec_t = time_spec_verify(torch, P, cfg, dev, report)
    fq_fwd_t, fq_bwd_t = time_fake_quant(torch, P, cfg, dev, report)
    flash_t = time_flash(torch, P, cfg, dev, report)
    tpt_t = time_tp_train_kernels(torch, P, cfg, dev, report)
    slstm_t = time_slstm(torch, P, xcfg, dev, report)
    rg_t = time_rg(torch, P, rcfg, dev, report)
    mx_t = time_mx(torch, P, dev, report)
    new_t = time_new(torch, P, dev, report)
    wv_t = time_wv(torch, P, dev, report)
    lap("4")
    for name, t in (("kvq_paged_decode_attn", paged_t),
                    ("gather_dequant_paged_kv", gather_t),
                    ("pool_block_copy", copy_t),
                    ("kvq_spec_verify_attn", spec_t),
                    ("fake_quant_fwd", fq_fwd_t),
                    ("fake_quant_bwd", fq_bwd_t),
                    ("flash_attn_fwd", flash_t),
                    ("slstm_scan", slstm_t)):
        print(f"phase 4: {name}: {t['ms']:.4f} ms (bound {t['bound_ms']:.5f}"
              f" ms by {t['bound_by']}), plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms", flush=True)
    report["total_s"] = time.perf_counter() - t_start
    print("phase times (s): " + json.dumps(
        {k: round(v, 1) for k, v in laps.items()}), flush=True)

    def wh_launches(name):
        """A kernel's launches over phase 3m's two waves."""
        return sum(w["prefill_launches"][name] + round(
            w["decode_launches_per_step"][name] * (MAX_NEW - 1))
            for w in wh["waves"])

    def vl_launches(name):
        """A kernel's launches in phase 3n (a): one prefill, 31 steps."""
        return vl["prefill_launches"][name] + round(
            vl["decode_launches_per_step"][name] * (MAX_NEW - 1))

    vl_paged = vl["paged_shared_prefix"]["launches"]
    kernels = [
        {"name": "w4a8_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/w4a8_matmul.cu",
         "replaces": "src/repro/kernels/w4a8/kernel.py:62",
         "launches": launches["w4a8_matmul"], "max_abs_err": w4a8_err,
         "frontend_launches": fe_launches["w4a8_matmul"],
         **w4a8_t, "rg_launches": rg_launches["w4a8_matmul"],
         "mx_launches": mx_launches["w4a8_matmul"],
         "mixtral": {"per": f"one decode step at M={SLOTS}: "
                            f"{MX_SERVE_LAYERS} layers x (q, k, v, o, "
                            f"router) + the untied head",
                     **mx_t["w4a8_decode_step"]},
         "moonshot_launches": ms_launches["w4a8_matmul"],
         "moonshot_spec_launches": ms_spec_launches["w4a8_matmul"],
         "qwen3_32b_launches": {k: q32[k]["launches"]["w4a8_matmul"]
                                for k in ("dense", "paged")},
         "qwen2_7b_launches": q7["dense"]["launches"]["w4a8_matmul"],
         "qwen3_32b": {"per": f"one decode step at M={SLOTS}: "
                              f"{Q32_SERVE_LAYERS} layers x 7 linears + "
                              f"the untied head",
                       **new_t["w4a8_decode_step_qwen3_32b"]},
         "whisper_launches": wh_launches("w4a8_matmul"),
         "qwen2_vl_launches": vl_launches("w4a8_matmul"),
         "whisper": {"per": f"one whisper decode step at M={SLOTS}: 32 "
                            f"layers x 8 linears + the tied head (N 51866)",
                     **wv_t["w4a8_decode_step_whisper"]},
         "qwen2_vl": {"per": f"one qwen2-vl decode step at M={SLOTS}: 28 "
                             f"layers x 7 linears + the tied head",
                      **wv_t["w4a8_decode_step_qwen2_vl"]},
         "modes": {
             "fused": "int8 x int4 -> int32 sums -> scales (+ bias) -> "
                      "bf16, one launch (every linear at tp=1, the "
                      "column-parallel ones at tp=2)",
             "accumulate_epilogue": "w4a8_accumulate_launch (int32 sums, "
                                    "no epilogue) + w4a8_epilogue_launch: "
                                    "the row-parallel wo and wd at tp=2, "
                                    "the int32 sums all-reduced between"},
         "tp_launches": {m: tp_launches(tp, m) for m in (
             "w4a8_matmul", "w4a8_accumulate", "w4a8_epilogue")},
         "tp_max_abs_err": tp["kernel_errs"]["w4a8_accumulate"],
         "tp2_shard_times": {"per": "one launch at a rank's K slice "
                                    "(wo K 1024, wd K 5504; N 2048)",
                             "card": report["card"], "rows": w4a8_tp_t},
         "per": f"one decode step at M={SLOTS}: 36 layers x 7 linears + "
                "the tied head"},
        {"name": "kvq_decode_attn", "route": "cuda",
         "source": "src/repro_torch/csrc/kvq_decode_attn.cu",
         "replaces": "src/repro/kernels/kvq_attn/kernel.py:338",
         "launches": launches["kvq_decode_attn"],
         "tp_launches": tp_launches(tp, "kvq_decode_attn"),
         "max_abs_err": max(kvq_err, rg_err["kvq_decode_attn"],
                            mx_err["kvq_decode_attn"],
                            new_err["kvq_decode_attn"],
                            wv_err["kvq_decode_attn"],
                            tp["kernel_errs"]["kvq_decode_attn"]), **kvq_t,
         "whisper_launches": wh_launches("kvq_decode_attn"),
         "qwen2_vl_launches": vl_launches("kvq_decode_attn"),
         "whisper": {"per": f"one launch over the cross caches at "
                            f"B={SLOTS}, H=20, Hkv=20 (G 1), D=64, 1500 "
                            f"rows each (a decode step: 32 such and 32 "
                            f"self launches)",
                     **wv_t["cross_decode_launch"]},
         "qwen3_32b_launches": q32["dense"]["launches"]["kvq_decode_attn"],
         "qwen2_7b_launches": q7["dense"]["launches"]["kvq_decode_attn"],
         "moonshot_spec_launches": ms_spec_launches["kvq_decode_attn"],
         "qwen3_32b": {"per": f"one launch at B={SLOTS}, H=64, Hkv=8 (G 8), "
                              f"D=128, S={CACHE_LEN}, lengths "
                              f"{list(KVQ_LENGTHS)}",
                       **new_t["dense_decode_launch_g8"]},
         "rg_launches": rg_launches["kvq_decode_attn"],
         "mx_launches": mx_launches["kvq_decode_attn"],
         "mixtral": {
             "per": f"one decode step: {MX_SERVE_LAYERS} launches at "
                    f"B={SLOTS}, H=32, Hkv=8, D=128, Sc={MX_WINDOW} (full "
                    f"rings)", **mx_t["decode_attn_step"]},
         "recurrentgemma": {
             "per": f"one decode step: 8 launches at B={SLOTS}, H=10, "
                    f"Hkv=1, D=256, Sc={RG_WINDOW} (full rings)",
             "int8": rg_t["decode_step"], "bf16": rg_t["decode_step_bf16"]},
         "per": f"one decode step: 36 launches at B={SLOTS}, H=16, Hkv=2, "
                f"D=128, S={CACHE_LEN}, lengths {list(KVQ_LENGTHS)}"},
        {"name": "kvq_paged_decode_attn", "route": "cuda",
         "source": "src/repro_torch/csrc/kvq_paged_decode_attn.cu",
         "replaces": "src/repro/kernels/kvq_attn/kernel.py:109",
         "launches": paged_launches["kvq_paged_decode_attn"],
         "tp_launches": tp_launches(tp, "kvq_paged_decode_attn"),
         "tp_max_abs_err": tp["kernel_errs"]["kvq_paged_decode_attn"],
         "frontend_launches": fe_launches["kvq_paged_decode_attn"],
         "max_abs_err": max(paged_err, rg_err["kvq_paged_decode_attn"],
                            new_err["kvq_paged_decode_attn"],
                            wv_err["kvq_paged_decode_attn"]),
         **paged_t,
         "qwen2_vl_launches": vl_paged["kvq_paged_decode_attn"],
         "qwen2_vl": {"per": f"one launch at B={SLOTS}, H=12, Hkv=2 (G 6), "
                             f"D=128, block 64, lengths "
                             f"{list(PAGED_LENGTHS)} (a decode step: 28)",
                      **wv_t["paged_decode_launch_g6"]},
         "moonshot_launches": ms_launches["kvq_paged_decode_attn"],
         "qwen3_32b_launches": q32["paged"]["launches"][
             "kvq_paged_decode_attn"],
         "moonshot": {"per": f"one launch at B={SLOTS}, H=16, Hkv=16 (G 1), "
                             f"D=128, block 64, lengths "
                             f"{list(PAGED_LENGTHS)} (a decode step: "
                             f"48 launches)",
                      **new_t["paged_decode_launch_g1"]},
         "recurrentgemma": {
             "per": "one launch at B=4, H=10, Hkv=1, D=256, 2048 tokens a "
                    "slot in blocks of 64",
             "int8": rg_t["paged_decode_launch"],
             "bf16": rg_t["paged_decode_launch_bf16"]},
         "per": f"one paged decode step: 36 launches at B={SLOTS}, H=16, "
                f"Hkv=2, D=128, block 64, T=8, lengths "
                f"{list(PAGED_LENGTHS)}"},
        {"name": "gather_dequant_paged_kv", "route": "cuda",
         "source": "src/repro_torch/csrc/gather_dequant_paged_kv.cu",
         "replaces": "src/repro/kernels/kvq_attn/kernel.py:174",
         "launches": paged_launches["gather_dequant_paged_kv"],
         "tp_launches": tp_launches(tp, "gather_dequant_paged_kv"),
         "tp_max_abs_err": tp["kernel_errs"]["gather_dequant_paged_kv"],
         "frontend_launches": fe_launches["gather_dequant_paged_kv"],
         "max_abs_err": max(gather_err, rg_err["gather_dequant_paged_kv"],
                            new_err["gather_dequant_paged_kv"],
                            wv_err["gather_dequant_paged_kv"]),
         **gather_t,
         "qwen2_vl_launches": vl_paged["gather_dequant_paged_kv"],
         "qwen2_vl": {"per": "one qwen2-vl tail-wave: 28 launches (K and V "
                             "of a layer in one) at n, T, bs = %s, Hkv=2"
                             % (GATHER_SHAPE,),
                      **wv_t["gather_tail_wave_vl"]},
         "moonshot_launches": ms_launches["gather_dequant_paged_kv"],
         "recurrentgemma": {
             "per": "one K+V launch: 4 rows of 32 entries of 64 tokens, "
                    "Hkv=1, D=256",
             "int8": rg_t["gather_launch"],
             "bf16": rg_t["gather_launch_bf16"]},
         "per": "one tail-wave: 36 launches (K and V of a layer in one) "
                "at n, T, bs = %s" % (GATHER_SHAPE,)},
        {"name": "pool_block_copy", "route": "cuda",
         "source": "src/repro_torch/csrc/pool_block_copy.cu",
         "replaces": "src/repro/kernels/kvq_attn/kernel.py:308",
         "launches": paged_launches["pool_block_copy"],
         "tp_launches": tp_launches(tp, "pool_block_copy"),
         "tp_max_abs_err": tp["kernel_errs"]["pool_block_copy"],
         "frontend_launches": fe_launches["pool_block_copy"],
         "max_abs_err": copy_err, **copy_t,
         "qwen2_vl_launches": vl_paged["pool_block_copy"],
         "qwen2_vl": {"per": "one COW of one block over qwen2-vl's 28-layer "
                             "pool (Hkv=2): 1 launch",
                      **wv_t["copy_per_cow_vl"]},
         "moonshot_launches": ms_launches["pool_block_copy"],
         "per": "one COW of one block: 1 launch cloning the k_q, v_q, s_k "
                "and s_v leaves of 36 layers (one_leaf_ms: the 4 one-leaf "
                "launches it replaced)"},
        {"name": "kvq_spec_verify_attn", "route": "cuda",
         "source": "src/repro_torch/csrc/kvq_spec_verify_attn.cu",
         "replaces": "src/repro/kernels/kvq_attn/kernel.py:255",
         "launches": spec_launches["kvq_spec_verify_attn"],
         "tp_launches": tp_launches(tp, "kvq_spec_verify_attn"),
         "tp_max_abs_err": tp["kernel_errs"]["kvq_spec_verify_attn"],
         "max_abs_err": max(spec_err, rg_err["kvq_spec_verify_attn"],
                            new_err["kvq_spec_verify_attn"],
                            wv_err["kvq_spec_verify_attn"]),
         **spec_t,
         "moonshot_launches": ms_spec_launches["kvq_spec_verify_attn"],
         "recurrentgemma": {
             "per": f"one launch at B=4, C={SPEC_C}, H=10, Hkv=1, D=256, "
                    f"windows ending at 2048 tokens",
             "int8": rg_t["spec_verify_launch"],
             "bf16": rg_t["spec_verify_launch_bf16"]},
         "per": f"one verify-wave: 36 launches at B={SLOTS}, C={SPEC_C}, "
                f"H=16, Hkv=2, D=128, block 64, T={SPEC_T}, histories "
                f"{list(spec_histories(64))}"},
        {"name": "fake_quant_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/fake_quant.cu",
         "replaces": "src/repro/kernels/quant/kernel.py:55",
         "launches": train_launches["fake_quant_fwd"],
         "dp_launches_per_rank_step": dp["launches_per_rank_step"][
             "fake_quant_fwd"],
         "tp_train_launches_per_rank_step": {
             k: v["launches_per_rank_step"]["fake_quant_fwd"]
             for k, v in tpt["passes"].items()},
         "tp_train_shards": tpt_t["fake_quant_fwd"],
         "ptq_launches": ptq_launches["fake_quant_fwd"],
         "max_abs_err": fq_err, **fq_fwd_t,
         "tp_launches": tp_launches(tp, "fake_quant_fwd"),
         "tp_moe": {
             "per": "one launch on a rank's local bank at tp=2 (moonshot "
                    "32 of 64 experts, mixtral 4 of 8) at 4 bits; a decode "
                    "step's bank fake-quants a rank",
             "card": report["card"],
             "local_banks": tp["kernels"]["local_banks"],
             "per_step": {k: {"launches": v["bank_fq_launches_per_step"],
                              "local_experts": v["local_experts"],
                              "ms_per_rank": v["bank_fq_ms_per_step"],
                              "ms_tp1": v["bank_fq_ms_per_step_tp1"]}
                          for k, v in tp["passes"].items()
                          if v.get("local_experts")}},
         "rg_launches": rg_train_launches["fake_quant_fwd"],
         "mx_launches": mx_launches["fake_quant_fwd"],
         "mx_train_launches": mx_train_launches["fake_quant_fwd"],
         "moonshot_launches": ms_launches["fake_quant_fwd"],
         "moonshot_train_launches": ms_train_launches["fake_quant_fwd"],
         "qwen3_14b_train_launches": q14_train_launches["fake_quant_fwd"],
         "whisper_train_launches": wh_train["fake_quant_fwd"],
         "qwen2_vl_train_launches": vl_train["fake_quant_fwd"],
         "whisper": {"per": "one whisper student forward: 513 launches (32 "
                            "x 6 encoder and 32 x 10 decoder weights at 4 "
                            "bits, the tied head per row at 8)",
                     **wv_t["fake_quant_step_whisper"][0]},
         "qwen2_vl": {"per": "one qwen2-vl student forward: 197 launches",
                      **wv_t["fake_quant_step_qwen2_vl"][0]},
         "moonshot": {
             "per": "one moonshot decode step: 144 mode-3 launches, one an "
                    "expert bank (64, 2048, 1408) or (64, 1408, 2048) at 4 "
                    "bits",
             **new_t["fake_quant_fwd_decode_step"],
             "per_bank": [{k: b[k] for k in ("shape", "fwd_ms",
                                              "fwd_plain_ms",
                                              "fwd_library_ms",
                                              "fwd_bound_ms",
                                              "mode1_fwd_ms")}
                          for b in new_t["banks"]]},
         "mixtral": {
             "per": f"one mixtral decode step: {3 * MX_SERVE_LAYERS} mode-3 "
                    f"launches, one an expert bank (8, 4096, 14336) or "
                    f"(8, 14336, 4096) at 4 bits",
             **mx_t["fake_quant_fwd_decode_step"],
             "per_bank": [{k: b[k] for k in ("shape", "fwd_ms",
                                              "fwd_plain_ms",
                                              "fwd_library_ms",
                                              "fwd_bound_ms",
                                              "mode1_fwd_ms")}
                          for b in mx_t["banks"]]},
         "per": "one QAT student step: 253 launches (36 layers x 7 "
                "weights per output channel at 4 bits + the tied head per "
                "vocab row at 8 bits)"},
        {"name": "fake_quant_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/fake_quant.cu",
         "replaces": "src/repro/kernels/quant/kernel.py:74",
         "launches": train_launches["fake_quant_bwd"],
         "dp_launches_per_rank_step": dp["launches_per_rank_step"][
             "fake_quant_bwd"],
         "tp_train_launches_per_rank_step": {
             k: v["launches_per_rank_step"]["fake_quant_bwd"]
             for k, v in tpt["passes"].items()},
         "tp_train_shards": tpt_t["fake_quant_bwd"],
         "max_abs_err": fq_err, **fq_bwd_t,
         "rg_launches": rg_train_launches["fake_quant_bwd"],
         "mx_train_launches": mx_train_launches["fake_quant_bwd"],
         "moonshot_train_launches": ms_train_launches["fake_quant_bwd"],
         "qwen3_14b_train_launches": q14_train_launches["fake_quant_bwd"],
         "whisper_train_launches": wh_train["fake_quant_bwd"],
         "qwen2_vl_train_launches": vl_train["fake_quant_bwd"],
         "whisper": {"per": "one whisper student backward: 513 launches",
                     **wv_t["fake_quant_step_whisper"][1]},
         "qwen2_vl": {"per": "one qwen2-vl student backward: 197 launches",
                      **wv_t["fake_quant_step_qwen2_vl"][1]},
         "moonshot": {
             "per": "one mode-3 launch on a 64-expert bank at 4 bits",
             "per_bank": [{k: b[k] for k in ("shape", "bwd_ms",
                                              "bwd_plain_ms",
                                              "bwd_library_ms",
                                              "bwd_bound_ms",
                                              "mode1_bwd_ms")}
                          for b in new_t["banks"]]},
         "mixtral": {
             "per": "one mode-3 launch on an expert bank at 4 bits",
             "per_bank": [{k: b[k] for k in ("shape", "bwd_ms",
                                              "bwd_plain_ms",
                                              "bwd_library_ms",
                                              "bwd_bound_ms",
                                              "mode1_bwd_ms")}
                          for b in mx_t["banks"]]},
         "per": "one QAT student backward: 253 launches, the forward's "
                "sites"},
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attn_fwd.cu",
         "replaces": "src/repro/kernels/flash_attn/kernel.py:74",
         "launches": train_launches["flash_attn_fwd"],
         "dp_launches_per_rank_step": dp["launches_per_rank_step"][
             "flash_attn_fwd"],
         "tp_train_launches_per_rank_step": {
             k: v["launches_per_rank_step"]["flash_attn_fwd"]
             for k, v in tpt["passes"].items()},
         "q_offset": tpt_t["flash_q_offset"],
         "ptq_launches": ptq_launches["flash_attn_fwd"],
         "max_abs_err": max(flash_err, tpt_flash_err, rg_err["flash_attn_fwd"],
                            mx_err["flash_attn_fwd"],
                            new_err["flash_attn_fwd"],
                            wv_err["flash_attn_fwd"]),
         "whisper_launches": wh_launches("flash_attn_fwd"),
         "whisper_train_launches": wh_train["flash_attn_fwd"],
         "qwen2_vl_train_launches": vl_train["flash_attn_fwd"],
         "whisper": {"per": f"one encoder launch at B={SLOTS}, S=1500, "
                            f"H=20, Hkv=20, D=64, not causal (a prefill: "
                            f"32)", **wv_t["flash_encoder_launch"]},
         "whisper_cross": {"per": f"one cross-attention launch at "
                                  f"B={SLOTS}, Sq={TRAIN_T}, Skv=1500, "
                                  f"H=20, D=64, not causal",
                           **wv_t["flash_cross_launch"]},
         "qwen2_vl": {"per": f"one launch at B={TRAIN_B}, S={VL_TRAIN_S}, "
                             f"H=12, Hkv=2 (G 6), D=128, causal",
                      **wv_t["flash_launch_g6"]},
         "moonshot_train_launches": ms_train_launches["flash_attn_fwd"],
         "qwen3_14b_train_launches": q14_train_launches["flash_attn_fwd"],
         "moonshot": {"per": f"one launch at B={TRAIN_B}, S={TRAIN_T}, H=16, "
                             f"Hkv=16 (G 1), D=128, causal",
                      **new_t["flash_launch_g1"]},
         "qwen3_14b": {"per": f"one launch at B={TRAIN_B}, S={TRAIN_T}, "
                              f"H=40, Hkv=8 (G 5), D=128, causal",
                       **new_t["flash_launch_g5"]},
         **flash_t, "rg_launches": rg_train_launches["flash_attn_fwd"],
         "mx_train_launches": mx_train_launches["flash_attn_fwd"],
         "mixtral": {
             "per": f"one 2-layer teacher forward: 2 launches at "
                    f"B={TRAIN_B}, S={TRAIN_T}, H=32, Hkv=8, D=128",
             **mx_t["flash_teacher_forward"]},
         "recurrentgemma": {
             "per": f"one teacher forward: 8 launches at B={TRAIN_B}, "
                    f"S={TRAIN_T}, H=10, Hkv=1, D=256, window {RG_WINDOW}",
             **rg_t["flash_teacher_forward"],
             "window_launch": rg_t["flash_window_launch"]},
         "per": f"one teacher forward: 36 launches at B={TRAIN_B}, "
                f"S={TRAIN_T}, H=16, Hkv=2, D=128, causal"},
        {"name": "slstm_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/slstm_scan.cu",
         "replaces": "src/repro/kernels/slstm_scan/kernel.py:67",
         "launches": xlstm_train_launches["slstm_scan"],
         "max_abs_err": slstm_err, **slstm_t,
         "per": f"one xlstm-125m teacher forward: 2 calls (the sLSTM "
                f"layers) at B={TRAIN_B}, T={TRAIN_T}, d=768, bf16 gx and "
                f"r_h, carry gx (the reference's cell), one resident "
                f"launch each (f32_carry_*: the f32 carry)"},
    ]
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"done in {report['total_s']:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
