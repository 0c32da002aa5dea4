#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` per source, all at once, in the background: a library a group of
sources, kernels.build.GROUPS, so that the phases that reach B1-B4 only
-- the B1-B4 kernel phases and mamba2's -- run while the attention kernels
still compile) and checks what the compiler made of
B8's twelve instances (six (q, pool) type pairs, with and without 16-byte
loads: registers printed, no spills in ``ptxas -v``), of B9's twelve (six
type pairs, 64- and 256-column slices: the same), of the
tensor-core flash kernels (B5, B6 and B7 in the bf16 operand mode): no spills
in ``ptxas -v`` at DP 64, 128 and 256, of the int8 mode (the forward's and
the backward's pre-passes and B5, B6, B7 on the s8 tensor cores:
registers printed at each DP, no spills in B5, B6 or B7), of the f32
mode's FFMA kernels (registers printed, no spills at DP 256), of B2's instances
(registers printed, no spill in the train shape's), and, where
``cuobjdump`` is on the machine, tensor-core instructions in their SASS
(HMMA/HGMMA in the bf16 kernels; IMMA and no IDP.4A in B5, B6 and B7
int8), whose counts of HMMA, HGMMA, IMMA, IDP, LDSM, LDGSTS and UTMALDG it
prints for every flash kernel ("not available" without the tool).  Then it runs these phases, each of which raises on a failed
check:

- kernels: each kernel against its plain PyTorch version on the card, with
  its time, the plain version's, a PyTorch library call's and the bound.
  B1 RMSNorm (24 shapes, f32 atol 2e-5, bf16 2e-2; at the decode and the
  train shapes the call against F.rms_norm's (both host-bound, so timed
  in turns, medians of 5 rounds) and the card's time a launch
  beside F.rms_norm's, from the profiler, and at the decode shape the
  call's host time split into dispatch, the wrapper's checks and allocation
  and the C entry point); B2 RMSNorm backward (one cooperative launch) at
  the train shape x (8, 512, 1024) and ragged rows/widths (D 48, 1024 and
  1030, the last on the scalar path), f32 and bf16 (dx at atol 2e-4 / rtol
  1e-3, bf16 2e-2; dgain at the f32 gradient tier and bit-identical when
  repeated), one launch a call in the profiler, its card time beside the
  autograd backward of F.rms_norm's, and at gemma2-2b's train shapes x
  (2048, 2304) and (4096, 2304), f32 and bf16 (the scalar path), each
  held, timed and bounded, and at mixtral-8x22b's, x (4608, 6144) f32;
  B3/B4 chunked cross entropy at logits
  (4096, 2048) (the train shape), (4096, 49152) (smollm's vocab), (2048,
  256000) (gemma2-2b's train step) and (4608, 32768) (mixtral-8x22b's;
  both held and timed) and ragged V, with masked rows and a cotangent of
  order 1 on the others (loss and lse at atol 2e-5, dlogits at atol 2e-4
  / rtol 1e-3, bf16 2e-2, masked rows exactly zero); B5/B6/B7 flash
  attention forward, dq and dk/dv
  in the f32, bf16 and int8 operand modes at the train shape (8, 512, 16
  heads of 64, causal), smollm's 9/3 heads (GQA), a window of 48, softcap
  20 (logits up to ~20), ragged S (200, 190), bf16 storage, d_head 128,
  and the tensor-core kernels' edges (d_head 96 and 40, S = T = 1, S = 129,
  d_head 20 in bf16, whose rows the copy engine cannot move), and at DP
  256 (each kernel's grid in two column halves): gemma2-2b's 8/4 heads of
  256, a window of 48 with softcap 50, ragged S 200, bf16 storage, d_head
  196 in f32 and bf16, and gemma2's local layer (B 1, S 8,192, window
  4,096, softcap 50), and mixtral-8x22b's train step (B 1, S 4,608, 48/8
  heads of 128, window 4,096), with a
  cotangent of order 1: each kernel against its plain version at
  its own contract (kernels/ref.py flash_fwd_ref, flash_bwd_ref, which
  round or quantize where the kernels do, over the same tiles) on the same
  inputs, lse at atol 2e-5 / rtol 1e-5, o and dq/dk/dv at the f32 tiers
  where nothing rounds to bf16, else max abs err within the bf16 tiers (the
  int8 tier, 5e-2, in the int8 mode) and mean within 3e-5, which the
  f32-mode outputs must fail against the bf16 plain versions and the int8
  outputs against the int8 plain versions tiled 64 wide (where S > 64:
  shorter sequences have no other tiles); dk/dv
  bit-identical when repeated; in the int8 mode the forward's pre-pass
  (flash_attention.quantize_fwd: k per row over d, v per column over each
  128-key tile) and the backward's (quantize_bwd: q, k, v and do once a
  call, per row over d and per column over each 128-row tile) byte for
  byte against their plain versions (ref.flash_quant_fwd_ref,
  flash_quant_bwd_ref), and whether each int8 output equals its plain
  version bit for bit printed; then
  ops.attention's autograd Function in
  the f32 mode against the plain attention under autograd (the f32 tiers);
  each mode timed at the train shape, the bf16 and int8 kernels with their
  device time per launch, B5, B6, B7 and B6 + B7 in the bf16 mode against
  SDPA's bf16 forward and backward alone (printed ratios; the targets are
  <= 3x, <= 0.75x, <= 1x and <= 1.3x, not held); the int8 backward's
  pre-pass, B6 and B7 (each device time apart: B6's and B7's do not count
  the pre-pass their calls run) and the whole backward as ops.attention
  runs it (one pre-pass, B6, B7), each beside its bound and its share of
  it, and SDPA's bf16 backward on the card for scale (targets <= 40, 100,
  120 and 260 us, printed, not held); the int8 forward's pre-pass, B5 on
  its bytes and the whole int8 forward (flash_fwd: pre-pass + B5), each
  with its device time, its bound and its share of it, beside SDPA's bf16
  forward and the bf16 B5 on the card for scale (targets <= 20, 70 and 90
  us, printed, not held); B5, B6 and B7 at DP 256 in each mode
  (G2_FLASH_TIMED: gemma2-2b's train step, 4 x 512 tokens, and its local
  layer at S 8,192 under window 4,096, softcap 50) a call and on the card,
  beside the bound from the visible pairs, the plain attention's forward
  and backward and SDPA's bf16 forward and backward (causal, no window,
  no softcap) for scale, and the same at mixtral's train step
  (MX_FLASH_TIMED, kept under ``mixtral_shapes``); B8 paged flash decode,
  split over a cluster of decode_splits() blocks (DECODE_CASES, 19 cases:
  engine shape, MHA/MQA, window, softcap, all four f32/bf16 (q, pool)
  pairs, d_head 128, d_head 256 with gemma2-2b's 8/4 heads in f32 and
  bf16, one slot of 2048 tokens, 32 slots, C = 1, slots of one token, a
  slot whose pages hold nothing, d_head 20 in bf16, whose 40-byte rows
  are read byte by byte, and the speculative drafters' 9/3 heads of 16 and
  of 8 (``cfg.scaled(0.25)``, ``make_proxy(0.125)``); f32 atol 2e-5, bf16
  2e-2, inactive and
  fully masked slots exactly zero), timed at the decode shape a call and
  on the card, with its split count, its share of the bytes bound and
  SDPA's call and card time, and on the card at one slot of 2048 tokens and
  at 32 slots, and at the drafters' heads (the same four slots); B9 paged
  multi-query flash decode, many query rows a block and split over a
  cluster by its plan (MULTI_CASES, 21 cases: the engine's chunk of 64
  with the history partly resident, its last chunk with rows past the
  prompt at -1, T not a multiple of the row tile, the speculative-verify
  shape B = 4, T = 5, MHA/MQA, window, softcap, bf16 and f32-over-bf16
  pools, two slots whose tables map the same pages, d_head 128, d_head 256
  at gemma2-2b's 8/4 heads in f32 and bf16, a chunk of 256 over 2048
  tokens (a ring of two slots), 32 slots at T = 5, a tile whose splits
  hold no page, d_head 20 in bf16 (40-byte rows read byte by byte), the
  drafters' catch-up chunk T = 5 at d_head 16 and 8 (an inactive slot, a
  slot with its first rows below position 0); f32
  atol 2e-5, bf16 2e-2 of the f32 plain version, or of its float64 value
  where the f32 plain version is the farther from it (multi_held), rows at
  -1 exactly zero, one launch a call, the kernel's plan equal to its
  mirror) and at T = 1 against B8 on the
  same inputs, timed (a call and on the card, its plan, its share of the
  operations bound, SDPA over the gathered K/V) at the chunk shape, a
  chunk of 256 over a 2048-token history, 32 slots at T = 5 and the
  drafters' catch-up; the int8-pool
  modes of B8 (INT8_DECODE_CASES, 18 cases, most at the engine's decode
  shape q (4, 9, 64) over (83, 16, 3, 64) int8 pools with (83, 3) scales:
  an inactive slot, MHA, MQA (G = 9, also with bf16 q, window and
  softcap), window, softcap, bf16 q, d_head 128 and 256, one slot of 2048
  tokens, 32 slots, C = 1, slots of one token and a fully masked slot,
  d_head 40 (40-byte rows, read byte by byte), the drafters' heads of 16
  (16-byte rows) and of 8 (8-byte rows, byte by byte); timed as over f32
  pools) and of B9 (INT8_MULTI_CASES, 16 cases: the engine's chunk of 64 with
  history resident, its last chunk with rows at -1, the verify shape
  B = 4, T = 5, MHA/MQA, window + softcap, bf16 q, two slots sharing
  pages, d_head 128, d_head 256 at 8/4 heads, a chunk of 256 over 2048
  tokens, 32 slots at T = 5, a tile whose splits hold no page, d_head 40
  read byte by byte, the drafters' catch-up; and T = 1 against B8's int8
  mode), each against its
  plain version at atol 2e-5 (bf16 q 2e-2), rows at -1 exactly zero,
  timed as over f32 pools beside SDPA over the gathered dequantized K/V.
  Then B8 and B9 over gemma2-2b's rings (G2_RING_CASES: 8/4 heads of 256,
  window 4096, softcap 50, f32 and int8 pools): the decode steps of 4
  slots at positions 6,400-6,463 over ring tables of 257 and 273 pages
  (the static and the dynamic engine's) and over the 404-page global
  table, a chunk of 256 at 6,144-6,399 over the 273-page ring and the
  global table, and a window of 48 over rings of 4 and 5 pages that have
  wrapped many times; each table as an engine leaves it (a wrapped ring
  holds positions out of logical order: checked), held by multi_held at
  2e-5; each timed at its serve shape (a call, on the card, the plain
  version, SDPA over the slot's gathered pages with the visibility mask,
  the bound), kept under ``gemma2_shapes`` in the kernels' rows.  Then
  mixtral-8x22b's shapes (``mixtral_shapes`` in the rows): B1 at D 6144, x
  (4, 1, 6144) and (4608, 6144) in f32 and bf16, held as at gemma2's width
  and timed beside F.rms_norm and the bound; B8 and B9 over its rings
  (MX_RING_CASES: 48/8 heads of 128, a GQA group of 6, window 4096, no
  softcap, f32 and int8 pools): the decode steps of 4 slots at positions
  4,608-4,639 over the 257-page ring, a chunk of 256 at 4,352-4,607 over
  the 273-page ring and a verify of T = 5 over the 258-page ring, each
  held as gemma2's (B9's plan equal to its mirror at the card's SM count)
  and timed at its serve shape.
- serve: smollm-135m at its published full width, cut to 15 of its 30
  layers (SERVE_DEPTH: the cut holds the run's time), through the static
  engine (random weights from a seed, ``zero_init_query=False``), once
  through the
  kernels and once through the plain versions: the same greedy tokens and
  steps, the first decode steps' logits within atol = rtol = 1e-4, and exact
  launch counts (B1 per forward, B8 per decode step, no B2/B3/B4); then a
  bf16 serve.
- serve_dynamic: the same model through DynamicEngine (the serve CLI's
  default): 4 slots, page 16, prompts up to 256, 64 tokens each,
  prefill_chunk 64, prefix cache on, 16 requests made of 4 shared system
  prompts of 96-160 tokens and unique suffixes of 16-96, all present at
  t = 0.  (a) tokens and steps equal with the kernels and through the
  plain versions (the serve phase's rule for near-ties); (b) greedy tokens
  equal to the static engine's and (c) to the dynamic engine's without the
  prefix cache, which shares nothing where this one shares (a request past
  a near-tie, where a plain full-sequence forward's top-2 gap is below
  TIE_GAP, may differ after it); (d) a second serve on the same engine
  shares more prompt tokens (a warm cache); (e) exact launch counts: B9 15
  (one a layer) per chunk forward, B8 15 per decode step, B1 31 per
  forward, no B2-B7,
  with the chunk forwards counted from the model's calls and held against
  the chunk schedule recomputed from prefill_cached.
- serve_int8: the same model with int8 paged KV pools (``--kv-dtype
  int8``) through DynamicEngine on serve_dynamic's workload and through
  the static engine on 8 of its requests: (a) tokens and steps equal with
  the kernels and through the plain versions on both engines; (b) the
  dynamic engine's tokens equal with the prefix cache off and (c) on a
  warm cache that shares more; (d) exact launch counts: B8 int8 15 per
  decode step, B9 int8 15 per chunk forward, B1 31 per forward, no f32/bf16
  B8/B9, no B2-B7.  Prints tok/s, the pools' MiB against f32 pools and the
  greedy top-1 agreement with the f32 dynamic engine (not held).  Nothing
  is cut: the int8 static serve runs 8 requests where the dynamic one runs
  16, to keep the run short.
- serve_spec: speculative decoding, draft_k 4, on the same model (15 of
  its 30 layers, full width) (f32,
  seed 0).  Paths: serve_spec, the static engine with the serve CLI's
  drafter ``cfg.scaled(0.25, min_d_head=8)`` (15 layers, d_model 144, 9/3
  heads of 16, random weights from seed 7: near-chance acceptance, the
  rejection path) on 4 requests of 64-128 prompt tokens and 32 generated;
  serve_spec_dynamic and serve_spec_int8, DynamicEngine with the adaptive
  draft length over f32 and int8 pools on 8 requests of serve_dynamic's
  workload (16 tokens each, chunks of 64, prefix cache on).  Each path
  serves once through the kernels and once through the plain versions:
  (a) the same greedy token at every row either could sample from unless
  the plain top-2 gap there is below TIE_GAP (after such a tie the serves
  may part), and with no tie the same tokens, lengths, steps and accepted /
  proposed drafts; the first 4 verify chunks' logits within atol = rtol =
  1e-4 over f32 pools (measured over int8); (b) exact launch counts from
  the recorded forwards: B8 = drafter steps x drafter layers (draft_k steps
  an iteration), B9 = (verifies + chunks) x target layers + catch-ups x
  drafter layers, B1 = (2 L + 1) per forward of each model, nothing
  else; under speculation the target never decodes one token at a time;
  (c) greedy tokens equal to the non-speculative engine's on the same
  requests (the near-tie rule; over int8 pools printed, not held: a
  rejected draft's k/v grows its page's scale, so the pools' bytes
  differ).  Then (d) the copy task (data/copy_task.py, the reference's
  benchmarks/perf_serve.py recipe): the target trained 100 steps and
  ``make_proxy(cfg, 0.125, depth=1, min_d_head=8)`` (1 layer, d_model 72,
  9/3 heads of 8) 150 steps, batch 16 x seq 32, Adam at lr 1e-4 (COPY_LR; path
  spec_copy_train: exact B1/B2/B3/B4 launches), then 8 requests of 8
  prompt tokens and 48 generated on 4 slots with and without speculation
  at draft_k 6 (path serve_spec_copy, exact launches): greedy tokens equal
  (near-tie rule); acceptance, tok/s of each (best of 3), the speedup and
  each one's card busy share under the profiler printed, not held.
- serve_gemma2, serve_gemma2_dynamic, serve_gemma2_int8: gemma2-2b
  (configs/gemma2_2b.py: 26 layers alternating "local" (window 4096) and
  "attn", d_model 2304, 8/4 heads of 256, d_ff 9216, vocab 256000,
  softcaps 50/30, post-norms) at full width, f32 weights from seed 0
  with a random query projection, 4 slots, page 16, 8 requests of seed
  0: 2 prompts of 6,400 tokens and 6 of 64-512, 64 tokens each, greedy;
  the static engine (one-shot prefills of the 6,400-token buffer in
  query chunks of 2,048, the local layers' band cut), DynamicEngine with
  chunks of 256 and the prefix cache requested (sharing off on rings:
  nothing shared; (b) the static engine's tokens, near-tie rule), and
  int8 pools through DynamicEngine and through the static engine on 3
  requests (one of 6,400 tokens).  Each: the kernels' serve under the profiler (tok/s, the
  card's busy share, peak memory) and the plain versions' serve, with the
  same tokens and steps (near-tie rule), exact launches (B1 105 a
  forward, B8 26 a decode step, B9 26 a chunk forward, their int8 modes
  over int8 pools, nothing else), the highest position served minus the
  window and the ring's reach (the ring must wrap), the pools' MiB and
  the phase's seconds; the f32 serves' decode logits held at 1e-3, the
  static one's against a float64 forward too, the int8 ones measured,
  with control serves through the plain versions but B1 (gemma2_phases
  says why).
- serve_mixtral, serve_mixtral_dynamic, serve_mixtral_int8: mixtral-8x22b
  (configs/mixtral_8x22b.py, arXiv:2401.04088: every layer "local_moe",
  window 4096, d_model 6144, 48/8 heads of 128, 8 experts of d_ff 16384,
  silu GLU, top-2, capacity factor 1.25, vocab 32768, untied embeddings)
  at full width over 4 of its 56 layers (MX_DEPTH: 56 layers of f32
  weights are 564 GB, 4 are 41.7 GB), f32 weights from seed 0 with a
  random query projection and a random readout (under µP the untied
  readout starts at zero), 4 slots, page 16, 6 requests of seed 0: 2
  prompts of 4,608 tokens (the 257-page ring wraps) and 4 of 64-512, 32
  tokens each, greedy; the static engine (one-shot prefills of the
  4,608-token buffer), DynamicEngine with chunks of 256 and the prefix
  cache requested (nothing shared on a ring config), and int8 pools
  through DynamicEngine.  Each as the gemma2 serves: kernels against the
  plain versions (tokens and steps by the near-tie rule, and each layer's
  expert choices, request by request: a flip only where the plain
  probabilities of the k-th and (k+1)-th experts lie within the tie
  limit, ROUTE_TIE over f32 pools and over int8 ones twice what a
  control serve with the quantizer's inputs moved by one ulp makes, each
  flip printed with its margin and parting that request alone; the other
  rows' router probabilities held at ROUTE_PROB_TOL / _INT8), exact
  launches (B1 2 L + 1 a forward, B8 L a decode step, B9 L a chunk
  forward, their int8 modes over int8 pools), the ring's wrap, the first
  8 decode steps' logits of the requests not parted held at MX_LOGIT_TOL
  (int8: MX_LOGIT_TOL_INT8), the real slots
  each mode drops past its capacity, tok/s, the card's busy share, peak
  memory, pool MiB and the phase's seconds (mixtral_phases).
- train: mup-gpt at full width (8 layers, d_model 1024, vocab 2048), f32,
  batch 8 x seq 512.  The first step's loss (1e-5 relative) and every
  gradient (atol 2e-4 / rtol 1e-3) with the kernels against the plain
  versions, from weights with a random query projection (so attention is
  not uniform); then 10 steps of ``train_loop`` through the kernels and 10 from
  the same init and batches through the plain versions: finite losses that
  fall, step-0 losses within 1e-5 relative, and exact launch counts per step
  (17 B1, 17 B2 of one launch each, 1 B3, 1 B4, no B5-B8).  Its ms per step runs from the
  start of the batch's generation to the loss read back, as the
  reference's train loop times it; the batch's own share and the peak
  memory of both runs are printed beside it.
- train --amp bf16: the same at the same width, with the mixed-precision
  policy: attention through B5-B7 in the bf16 operand mode, the readout
  logit matmul in bf16 operands.  The plain side's attention rounds where
  the kernels do (ops.attention_plain_flash).  The first step's loss and
  step 0 of the loop within limits that a control in the f32 operand mode
  must fail, every first-step gradient within 3e-3 of its tensor's
  largest entry (AMP_* below); a third loop through the policy's own plain
  attention gives the plain time and memory; exact launch counts per step
  (8 B5, 8 B6, 8 B7, 17 B1, 17 B2, 1 B3, 1 B4, no B8).
- train --amp int8: the same with attention through B5-B7 in the int8
  operand mode and the readout's int8 straight-through matmul; the plain
  side's attention quantizes where the kernels do, tile by tile.  The first
  step with the kernels equals it (INT8_* below), where two controls, the
  bf16-mode kernels and the int8 plain versions tiled 64 wide, must fail
  the loss limit; step 0 of the loop within a limit the f32 run fails;
  exact launch counts per step (8 each of B5, B6 and B7 in the int8 mode
  and 8 each of the forward's and the backward's pre-passes, none in the
  others, 17 B1, 17 B2, 1 B3, 1 B4); the mean of the last 3
  losses against the f32 run's is printed (the reference's bar is 1%; not
  held on the card).
- train_gemma2, train_gemma2 --amp bf16, train_gemma2 --amp int8: the
  three train phases above on gemma2-2b at full width (26 layers
  alternating window 4,096 and global attention, d_model 2304, 8/4 heads
  of 256, vocab 256,000, softcaps, post-norms; f32 weights, AdamW), batch
  4 x 512 and loops of 5 steps (TRAIN_ARCHS: the weights, gradients and
  moments take 42 GB; nothing else is cut): the same first-step holds and
  controls (the f32 gemma2 run the amp loops' control), exact launches per
  step (105 B1 and 105 B2 -- four norms a layer and the final one -- 1
  B3, 1 B4, under amp 26 each of B5, B6 and B7 in its operand mode and
  under int8 26 of each pre-pass), ms per step, the host batch's share
  and peak memory.
- train_mixtral, train_mixtral --amp bf16, train_mixtral --amp int8:
  mixtral-8x22b (arXiv:2401.04088: d_model 6144, 48/8 heads of 128, 8
  experts of d_ff 16384 top-2, capacity factor 1.25, window 4,096, vocab
  32,768, untied) at full width over 1 of its 56 layers (one layer's f32
  weights, gradients and Adam moments take 46.5 GB, two layers' 86.6 GB),
  one sequence of 4,608 tokens (capacity 1,440 an expert), loops of 3
  steps at lr 1e-4 (TRAIN_ARCHS), from a random readout and query
  projection: the first step as above, plus each layer's expert choices
  kernels against plain (train_routing: a flip only at a near-tie,
  ROUTE_TIE; the slots dropped past capacity printed), the kernels' first
  step run twice and held bit-equal, and after a flip the gradients it
  moved printed and the rest held (hold_grads); the plain side's flash
  attention two kv heads a call (the same bits in less memory).  The
  loops' step 0 is the first step bit for bit; under --amp the loop runs
  through the kernels only (the first step holds B5-B7 against their plain
  versions and the controls); exact launches per step (3 B1, 3 B2, 1 B3, 1
  B4, under amp 1 of each B5-B7 mode and under int8 1 of each pre-pass),
  ms per step, the host batch's share and peak memory.
- serve_mamba2: mamba2-130m (arXiv:2405.21060: 24 ``ssd`` layers, d_model
  768, d_inner 1536 in 24 SSD heads of 64, state 128, chunk 256, vocab
  50,280, tied embeddings; 129.0 M parameters) at full width, f32 weights
  from seed 0, served through the dense-loop driver (launch/serve.py
  ``generate``, what the serve CLI falls back to for an ssd pattern): 8
  requests of 512 tokens (two SSD chunks), 256 generated each, greedy, no
  stop token.  Exact launches (B1 25 a forward, 256 forwards: 6,400;
  nothing else); the plain versions over the prefill and the 8 decode
  steps whose logits are held (M2_PLAIN_GEN forwards): the same tokens by
  the near-tie rule, logits within M2_LOGIT_TOL beside a B1-alone control;
  the logits that picked each token against one chunked forward over the
  768 tokens in float64: the same decode in float64 at the reference's
  1e-4 of max |logit| (the state h and the conv inputs carried right), the
  kernels' f32 decode at M2_F32_DECODE_BAR, the held steps of both f32
  serves within M2_LOGIT_TOL of the float64 decode's; tok/s, peak memory,
  the card's busy share and the state a request holds (h 18.9 MB, conv 0.5
  MB).
- serve_dense: smollm-135m at SERVE_DEPTH through the dense-loop driver
  against the static engine on the same 8 prompts of 256 tokens, 64
  generated: the same greedy tokens request by request (near-tie rule),
  exact launches (B1 31 a forward; no B8 or B9: the dense driver attends
  in plain PyTorch, as the reference's does), tok/s of both.
- train_mamba2, train_mamba2 --amp bf16, train_mamba2 --amp int8: the
  train phases on mamba2-130m at full width, batch 8 x 512, loops of 3
  steps (TRAIN_ARCHS): the first step kernels against plain (under amp
  the readout, the only matmul the policy changes in an attention-free
  model, in the policy on both sides; the control is the readout in the
  other operand mode), the loop's step 0 the first step bit for bit, exact
  launches per step (25 B1, 25 B2 -- one norm a layer and the final one
  -- 1 B3, 1 B4, no B5-B7), ms per step, the host batch's share and peak
  memory.  The kernel phase holds and times B1 at (8, 1, 768) and (8, 512,
  768), B2 at (4096, 768) and B3/B4 at (4096, 50280), mamba2's shapes.
- serve_recurrentgemma: recurrentgemma-9b (arXiv:2402.19427: 38 layers,
  (recurrent, recurrent, local) x 12 and a (recurrent, recurrent) tail,
  d_model 4096, RG-LRU width 4096, conv width 4, 16 query heads over one kv
  head of 256, window 2,048, d_ff 12,288, vocab 256,000, tied embeddings;
  9.396 B parameters by its metas, 37.6 GB in f32) whole, f32 weights from
  seed 0, through the dense-loop driver the serve CLI falls back to: 2
  requests of 1,920 tokens, 160 generated each (the local layers' ring of
  2,048 wraps at decode step 128), greedy, no stop token.  Exact launches
  (B1 77 a forward, 160 forwards: 12,320; nothing else); the plain
  versions over the prefill and the first 8 decode steps (RG_PLAIN_GEN):
  the same tokens by the near-tie rule, their logits within
  RG_CONTROL_FACTOR times a control's distance (the plain serve again with
  B1's plain version replaced by F.rms_norm, the same function rounded
  another way); the kernels' 160 picking rows against one f32 forward over
  the 2,080 tokens at the reference's 1e-4 of max |logit| (h, the conv
  inputs and the ring carried right across 38 layers); a float64 witness
  at 5 layers (the first group and the tail, 2.17 B parameters), one
  request: decode against forward at 1e-9, the same in f32 at 1e-4; tok/s,
  the prefill's and a decode step's time, the card's busy share over
  decode steps, peak memory and the parameter counts (metas against
  param_count()).
- train_recurrentgemma, train_recurrentgemma --amp bf16, train_recurrentgemma
  --amp int8: the train phases on recurrentgemma-9b at full width over 5
  of its 38 layers (one group and the tail: 2.17 B parameters, a 34.8 GB
  train state), one sequence of 2,560 tokens (the window of 2,048 binds
  inside B5-B7), loops of 2 steps at lr 1e-2 (TRAIN_ARCHS): the first step
  kernels against plain (under amp gemma2's controls at RG_AMP_LIMITS, the
  amp loops' plain side B1-B4's kernels), exact launches per step (11 B1, 11
  B2, 1 B3, 1 B4, under amp 1 of each B5-B7 mode -- 16 query heads over
  one kv head of 256 -- and under int8 1 of each pre-pass), ms per step,
  the host batch's share and peak memory.  The kernel phases hold and time
  B1 at (4, 1, 4096) and (7680, 4096), B2 at (2560, 4096), B3/B4 at (2560,
  256000) and B5-B7 at (1, 2560, 16/1 heads of 256) under window 2,048 in
  every operand mode, recurrentgemma's shapes.
- sweep: the batched HP sweep and Algorithm 1 (core/tuning.py, api.py) on
  one card.  B1 and B2 with a gain per group ((G, D) over G equal groups of
  rows, the candidates of a batched step) at G 1, 4 and 16, x (16, 8, 64,
  256), (4, 8, 512, 1024) and ragged D 48 and 1030, and at each (x shape,
  G) the phase's paths give them (the 4-candidate sweep, the coord check's
  3 lrs at 8 x 32 and Fig. 1's 8 lrs at 8 x 64, d_model 256/512/1024), f32
  and bf16, against their plain versions (B1 atol 2e-5 / bf16 2e-2 and
  bit-equal to G separate launches; B2's dx at the gradient tiers, dgain
  at the f32 gradient tier and bit-identical when repeated), one launch a
  call in the profiler, timed at x (16, 8, 64, 256), G 16, with the
  operands rotated through 3-4x the L2 (so that the time is the HBM's, as
  the bound is), beside the bound and G separate launches.  On the
  full-size proxy (mup-gpt 0.25x with d_head
  kept at 64: 8 layers, d_model 256, 4 heads of 64, its µP base shape) the
  reference's three test candidates and lr 1e25, 6 steps at 8 x 64,
  batched and serial: curves within rtol 2e-3, the lr-1e25 candidate pruned
  and frozen bit for bit, the others within 2e-3 of the run without it,
  exact launches (a batched step: 17 B1 and 17 B2 with a gain per group, 1
  B3, 1 B4, whatever N is).  16 candidates of ``sample_n(16, 0)`` x 30
  steps batched and serial: candidate-steps per second, the speedup, the
  card's busy share under the profiler, peak memory and whether the two
  rank the candidates alike (best, finite set, pairs swapped) printed.  Algorithm
  1 through ``Experiment``: ``coord_check(lrs=(1e-3, 1e-2, 1e-1))`` at
  d_model 256/512/1024 (lr 1e-2's ``logits.delta`` slope held below 0.1),
  ``tune(n_samples=16, steps=30)``, ``transfer`` and ``train(steps=10)`` of
  the d_model-1024 target (finite, falling losses), each with exact
  launches; Fig. 1, 8 lrs (5e-3 * 2^k) x 20 steps at d_model 256, 512 and
  1024, its best lr by width printed, not held.
- sweep_moe: the batched sweep over mixtral-8x22b's µP proxy (2 layers at
  1/24 width, d_head kept at 64: d_model 256, 4/4 heads of 64, d_ff 683, 8
  experts top-2, vocab 32,768, base d_model 6144), 8 candidates (4 lrs x 2
  output multipliers: 1e-5 to 8e-5, where training is stable) x 10 steps of
  8 x 64, batched and serial: falling losses, curves within rtol 2e-3,
  exact launches (a batched step: 5 grouped B1 and B2, 1 B3, 1 B4 for all
  8), candidate-steps/s of both printed.
- sweep_amp: the sweep and Algorithm 1 under a mixed-precision policy,
  B5-B7 over a candidate axis (ops.attention's vmap rule folds the
  candidates into B).  In the f32, bf16 and int8 operand modes
  (CAND_CASES: the proxy's batched attention, 16 candidates x (8, 64, 4
  heads of 64), and gemma2's 8/4 heads of 256 at N 4 with a window of 48
  and softcap 50, DP 256's column halves over a folded B), each with a
  power-of-two scale per candidate: ops.attention under torch.func.vmap
  makes exactly one launch of each of the mode's kernels (B5, B6, B7, and
  in the int8 mode both pre-passes) for the N candidates, candidate i's
  output and gradients equal ops.attention on candidate i alone bit for
  bit, the folded outputs hold against the plain versions under the same
  vmap at the mode's tiers (f32 atol 2e-5 / gradients 2e-4 + 1e-3
  relative; bf16 and int8 by check_rounded), and the folded pre-passes'
  bytes and scales equal their plain versions' and the candidates' own
  launches.  At the proxy's shape each kernel is timed: a call, its
  device time in one launch against 16 separate launches, the plain
  version's ms, SDPA bf16 over the folded batch (the f32 and bf16 modes;
  no PyTorch call is int8 attention) and the bound (kept under
  ``candidate_axis`` in the kernels' rows).  Then the full-size proxy under
  --amp bf16 and --amp int8 (paths sweep_amp_bf16, sweep_amp_int8 and
  their serial loops): the reference's three candidates and lr 1e25, 6
  steps at 8 x 64, batched and serial, each step within 4x the distance
  at that step of the serial loop from itself started one ulp away, or
  within rtol 1e-4 at step 0 and 2e-3 later (AMP_STEP0_RTOL,
  AMP_NOISE_FACTOR say why), lr 1e25 pruned and frozen bit for bit, the
  others within 2e-3 of the run without it, exact launches (a batched step: 17 grouped B1/B2, 1 B3, 1
  B4, 8 of each B5-B7 mode and under int8 8 of each pre-pass, whatever
  N); 16 candidates of ``sample_n(16, 0)`` x 10 steps batched and serial:
  candidate-steps/s, speedup, busy share and peak memory printed.  Last,
  algorithm1_amp: Experiment on mup-gpt under u-µP and --amp int8, the
  coord check over lrs 1e-2, 2e-2, 4e-2 at d_model 256/512/1024 (lr
  2e-2's logits.delta slope held below 0.1, the reference's bar), tune
  (16 x 10 steps) and the d_model-1024 target trained 5 steps (finite,
  falling losses), with exact launches.  The phase prints its seconds.
  The kernel phase also times both int8 pre-passes at DP 256, gemma2-2b's
  train step, with their bytes bound (``gemma2_shapes`` in their rows).
- obs: observability on the main paths (obs/: metrics, µP-health
  telemetry, phase tracing), each check raising.  train_obs: mup-gpt full
  width (8 layers, d_model 1024, batch 8 x 512), f32, 10 steps of
  train_loop with TrainObs(metrics, telemetry=True, every=1, tracer), then
  3 steps under --amp bf16, each against the same loop without obs: losses
  and grad norms bit-equal, launches equal and exact (17 B1, 17 B2, 1 B3,
  1 B4 a step; under bf16 8 of each B5-B7), the ring's records keyed as the
  reference's (MUP_GPT_OBS_KEYS), one train_step span a step no shorter
  than the CUDA-event time of its step's call, train_steps_total 10; step
  times (host clock, and the step call's CUDA-event time) with and without
  telemetry printed.  drift: µP, u-µP and SP at the
  proxy's 0.25x (d_model 256) and at 1x (1024), 3 AdamW steps of 8 x 32 at
  lr 1e-2 with telemetry, a DriftDetector (tol 0.25, activation keys) on
  the 0.25x run observing the 1x run: SP flagged with a max |slope| above
  0.5, µP and u-µP not.  serve_obs: smollm-135m (SERVE_DEPTH layers) over
  the serve_dynamic workload through DynamicEngine and the serve phase's
  through Engine, each with ServeObs(tracer=Tracer()) and without: tokens,
  steps and launches equal; serve_tokens_total, serve_steps_total and
  serve_requests_total equal the serve's; a step span a step with its
  phase; prefill_cached_tokens_total equal to serve_dynamic's shared
  prompt tokens; the TTFT histogram counts the requests; the static serve
  span no shorter than the CUDA-event time of the serve's loop; tok/s with
  and without obs (in turns, the best of 2 each) printed.  phase kernels: a region of decode,
  chunk_prefill, verify and train_step each traced with
  Tracer(profile_dir=build/obs_profiles).profile(); every name in
  PHASE_KERNELS[phase] among the Chrome trace's kernels.  sweep_tracer:
  run_sweep over the proxy, 4 candidates (one diverging) x 10 steps,
  prune_factor 3: one sweep span, a prune event naming the diverged
  candidate, sweep_done's best equal to the result's.  The phase prints its
  seconds, the script its total.
- profile: torch.profiler over a short serve through each engine, a short
  int8 dynamic serve (with the card's time in the quantized writes of
  serving/kv_cache.py) and one train step, f32, --amp bf16 and --amp int8:
  the device's busy share and the kernels that take it; a train step's
  profile must show no more launches of B2 (and, under --amp int8, of B5
  and each pre-pass) than calls.

Launch counts are set to 0 just before each main path (serve,
serve_dynamic, serve_int8 dynamic and static, serve_spec, serve_spec_dynamic,
serve_spec_int8, spec_copy_train, serve_spec_copy, serve_gemma2,
serve_gemma2_dynamic, serve_gemma2_int8 and its static serve, serve_mixtral,
serve_mixtral_dynamic, serve_mixtral_int8, train, train --amp bf16,
train --amp int8, train_gemma2 and its --amp bf16 and int8 runs,
train_mixtral and its --amp bf16 and int8 runs, serve_mamba2,
serve_dense, train_mamba2 and its --amp bf16 and int8 runs,
serve_recurrentgemma, train_recurrentgemma and its --amp bf16 and int8
runs, the sweep phase's
sweep, sweep_serial, sweep_16,
algorithm1_coord_check, algorithm1_tune, algorithm1_train and fig1,
sweep_moe and its serial loop, and the sweep_amp phase's sweep_amp_bf16, sweep_amp_int8, their serial loops and
algorithm1_amp) and
read just after; launches made to compare or time a kernel do not count.
It needs one card, imports nothing of JAX or of the reference package,
catches no failure (the exit code is non-zero on any) and prints, last, one
JSON line: ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``.

Bounds (``bound_ms``) use the H100 SXM data-sheet rates: 3.35 TB/s of
device memory, 67 TFLOP/s of float32 outside the tensor cores, 989 TFLOP/s
of dense bf16 on the tensor cores for B5-B7's bf16 operand mode and 1,979
TOP/s of dense int8 for their int8 mode.
"""
from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
INT8_TC_OP_PER_S = 1979e12
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # docs/kernels.md tiers
GRAD_TOL = {torch.float32: (2e-4, 1e-3), torch.bfloat16: (2e-2, 0.0)}  # (atol, rtol)
# B5-B7 against their plain versions at the kernels' contract
# (kernels/ref.py: flash_fwd_ref, flash_bwd_ref) where bf16 rounding enters
# (bf16 operands, or o stored in bf16).  The two sum in different orders, so
# an operand a few f32 ulps from its twin can round to the neighbouring bf16
# value: a few entries then differ by 2^-8 of one product (up to 0.019, dq
# of the softcap case, on an H100 at 700 W); the bf16 tiers bound the max.
# A rounding left out or put in the wrong place moves every entry instead:
# the mean error (at most 3.7e-6 there; the f32-mode outputs' at least
# 1.7e-4) is held at FLASH_MEAN_TOL.
FLASH_MAX_TOL = {"o": 2e-2, "dq": 5e-2, "dk": 5e-2, "dv": 5e-2}
FLASH_MEAN_TOL = 3e-5
# The int8 mode, against plain versions that quantize where the kernels do:
# an ulp of exp or tanh between the two could move a quantized p or ds
# across a half step, and a few entries would then differ by one step of
# their tile's scale (on an H100 at 700 W none does: every output equal);
# their max is held at the int8 tier against f32 (docs/kernels.md), the
# mean at FLASH_MEAN_TOL, which plain versions tiled 64 wide (the scales
# over other tiles; mean 9.0e-4 and more) must fail.
INT8_MAX_TOL = {"o": 5e-2, "dq": 5e-2, "dk": 5e-2, "dv": 5e-2}
FLASH_MODES = ("none", "bf16", "int8")
TRAIN_LOSS_RTOL = 1e-5
# --amp bf16, kernels against the plain side whose attention rounds where
# they do (an H100 at 700 W, B5 at 128-key tiles): the first step's loss
# 4.65e-7 relative apart, 1.64e-5 with attention's kernels in the f32
# operand mode (the control); step 0 of the loop 5.5e-7, 1.67e-5 for the
# f32 run.  The gradients cannot tell the modes apart: a few bf16 operands
# that round to the other neighbour after an f32 ulp of difference upstream
# move them by up to 1.1e-3 of a tensor's largest entry (wq), the f32 mode
# by 1.2e-4-1.7e-3; their limit bounds that noise.
AMP_LOSS_RTOL = 5e-6
AMP_GRAD_TOL = 3e-3        # times the tensor's largest plain gradient entry
AMP_LOOP_LOSS_RTOL = 3e-6
# --amp int8, the same checks: the plain side's attention quantizes where the
# kernels do, tile by tile.  The two give the same bits for the same inputs
# (B5's l summed in the kernel's order), so the first step is equal (an
# H100 at 700 W: loss and gradients 0 apart), where the bf16-mode control
# is 4.7e-6 / 7.8e-3 of a tensor's largest entry apart and the plain
# versions tiled 64 wide 4.2e-6 / 6.3e-3.  Step 0 of the loop runs B1-B4's
# plain versions on the plain side, whose ulps move int8 bytes: 4.4e-6,
# against 1.9e-5 for the f32 run.
INT8_LOSS_RTOL = 1e-6
INT8_GRAD_TOL = 1e-3
INT8_LOOP_LOSS_RTOL = 1e-5
# (first-step loss, first-step gradients, step 0 of the loop) by --amp, and the
# operand mode of the first step's control
AMP_LIMITS = {"bf16": (AMP_LOSS_RTOL, AMP_GRAD_TOL, AMP_LOOP_LOSS_RTOL, "none"),
              "int8": (INT8_LOSS_RTOL, INT8_GRAD_TOL, INT8_LOOP_LOSS_RTOL, "bf16")}
# the gemma2-2b train phases' paths (train_phase with arch "gemma2-2b")
G2_TRAIN = ("train_gemma2", "train_gemma2_amp_bf16", "train_gemma2_amp_int8")
# mixtral-8x22b's (train_phase with arch "mixtral-8x22b")
MX_TRAIN = ("train_mixtral", "train_mixtral_amp_bf16", "train_mixtral_amp_int8")
SERVE_LOGIT_TOL = 1e-4   # atol and rtol, as the CPU tests hold logits
TIE_GAP = 1e-5
N_TIMED = 200


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n=N_TIMED, warmup=10):
    """Mean milliseconds per call on the card's clock (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def cuda_ms_turns(fns, rounds=5, n=N_TIMED):
    """({name: median ms a call}, {name: every round's ms}) of the functions
    in ``fns``, each timed by cuda_ms in turns over ``rounds`` rounds (the
    order reversed every other round), so that calls bound by the host's
    time meet its drift alike."""
    names = list(fns)
    per = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            per[name].append(cuda_ms(fns[name], n))
    return {name: sorted(v)[len(v) // 2] for name, v in per.items()}, per


def device_us(fn, name, n=20, tries=6):
    """Microseconds on the card per launch of the port kernel ``name`` (see
    PORT_KERNELS), from torch.profiler over ``n`` calls of ``fn``; a profile
    that caught none of its launches (the tracer drops events now and then,
    once three profiles of the grouped B2 running: an H100 at 700 W) is
    taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(is_kernel(name, k, e.key) for k in PORT_KERNELS[name])]
        if hits:
            return sum(e.self_device_time_total for e in hits) / sum(e.count for e in hits)
        empty_profile(prof)
    raise AssertionError(f"the profiler saw no kernel of {name!r} in {tries} tries")


def library_device_us(fn, n=20, tries=3):
    """(microseconds on the card, kernel launches) per call of ``fn``, over
    every kernel it launches (a library call's own kernels), from
    torch.profiler over ``n`` calls; a profile that caught no kernel (the
    tracer drops events now and then) is taken again, up to ``tries``
    times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if hits:
            return (sum(e.self_device_time_total for e in hits) / n,
                    sum(e.count for e in hits) / n)
        empty_profile(prof)
    raise AssertionError(f"the profiler saw no kernel of the call in {tries} tries")


def empty_profile(prof):
    """After a profile that caught no kernel: print what it did catch and
    the allocator's state, and hand the allocator's cached blocks back to
    the driver before the next try."""
    log(f"[profiler] a profile caught no kernel: {len(prof.events())} events; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; retaken")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their rate (float32 unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def bf16_step(v):
    """The spacing of bfloat16 values at |v| (float64 v): 2**(e - 7) for
    2**e <= |v| < 2**(e + 1)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126))) - 7)


def rmsnorm_phase(ops, rn, F):
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for rows in (1, 8, 256, 8192):
        for D in (48, 576, 1024):
            for dt in (torch.float32, torch.bfloat16):
                x = (3 * torch.randn(rows, D, device="cuda")).to(dt)
                g = 0.5 * torch.randn(D, device="cuda")
                got = ops.fused_rmsnorm(x, g, impl="kernel")
                want = ops.fused_rmsnorm(x, g, impl="ref")
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                worst[dt] = max(worst[dt], err)
                if not err <= ATOL[dt]:
                    raise AssertionError(
                        f"rmsnorm rows={rows} D={D} {dt}: max err {err}")
    # gemma2-2b's width: a decode step's rows and a 6,400-token prefill's,
    # each path also measured against B1 in float64 on the same inputs
    g2 = {}
    for rows in (4, G2_LONG):
        for dt in (torch.float32, torch.bfloat16):
            x = (3 * torch.randn(rows, 2304, device="cuda")).to(dt)
            g = 0.5 * torch.randn(2304, device="cuda")
            got = ops.fused_rmsnorm(x, g, impl="kernel").double()
            want = ops.fused_rmsnorm(x, g, impl="ref").double()
            exact = ops.fused_rmsnorm(x.double(), g.double(), impl="ref")
            torch.cuda.synchronize()
            diff = (got - want).abs()
            err = diff.max().item()
            worst[dt] = max(worst[dt], err)
            # bf16 outputs: at |y| >= 4 one bf16 step (2**-5) exceeds the
            # tier, and two f32 values ulps apart may round to neighbouring
            # steps; each value is held within the tier or one step of the
            # plain one, whichever is larger
            lim = torch.full_like(want, ATOL[dt])
            if dt == torch.bfloat16:
                lim = torch.maximum(lim, bf16_step(want))
            g2[f"{rows}x2304 {str(dt)[6:]}"] = dict(
                err=err, kernel_from_f64=(got - exact).abs().max().item(),
                plain_from_f64=(want - exact).abs().max().item(),
                past_tier=int((diff > ATOL[dt]).sum()))
            if not bool((diff <= lim).all()):
                raise AssertionError(f"rmsnorm rows={rows} D=2304 {dt}: max err {err}, "
                                     f"{int((diff > lim).sum())} values past their limit")
    log(f"[kernels] rmsnorm: 28 cases agree; max err f32 {worst[torch.float32]:.3g}"
        f", bf16 {worst[torch.bfloat16]:.3g}; at gemma2-2b's D 2304, the kernel / the plain "
        f"version from float64 (values past the tier, within one bf16 step): " + "; ".join(
            f"{k} {e['kernel_from_f64']:.3g} / {e['plain_from_f64']:.3g} ({e['past_tier']})"
            for k, e in g2.items()))

    # timing at the main path's decode shape: 4 slots x 1 token x d_model 576
    x = torch.randn(4, 1, 576, device="cuda")
    g = 0.5 * torch.randn(576, device="cuda")
    err = (ops.fused_rmsnorm(x, g, impl="kernel")
           - ops.fused_rmsnorm(x, g, impl="ref")).abs().max().item()
    w = (1 + g).to(x.dtype)
    # B1's call and F.rms_norm's are both host-bound here: timed in turns
    med, rounds = cuda_ms_turns({
        "call": lambda: ops.fused_rmsnorm(x, g, impl="kernel"),
        "lib": lambda: F.rms_norm(x, (576,), weight=w, eps=1e-6)})
    ms, library_ms = med["call"], med["lib"]
    plain_ms = cuda_ms(lambda: ops.fused_rmsnorm(x, g, impl="ref"))
    # the card's own time a launch, to tell it from the host's time a call
    dev_us = device_us(lambda: ops.fused_rmsnorm(x, g, impl="kernel"), "rmsnorm")
    lib_dev_us, lib_launches = library_device_us(
        lambda: F.rms_norm(x, (576,), weight=w, eps=1e-6))
    log(f"[kernels] rmsnorm x (4, 1, 576) f32: {ms:.5f} ms a call, {dev_us:.2f} us on the "
        f"card a launch; F.rms_norm {library_ms:.5f} ms a call, {lib_dev_us:.2f} us on "
        f"the card in {lib_launches:.0f} launch(es) a call; B1's call {ms / library_ms:.2f}x "
        f"F.rms_norm's (target <= 1.3x, printed, not held; medians of 5 rounds in turns, "
        f"the rounds' ratios {min(rounds['call']) / max(rounds['lib']):.2f}-"
        f"{max(rounds['call']) / min(rounds['lib']):.2f}x)")
    nbytes = 2 * x.numel() * x.element_size() + g.numel() * g.element_size()
    bound_ms, bound_by = bound(nbytes, 4 * x.numel())
    host = rmsnorm_host_breakdown(ops, rn, F, x, g, w)

    # the prefill shape of the same path: one 256-token prompt
    xp = torch.randn(1, 256, 576, device="cuda")
    pre_ms = cuda_ms(lambda: ops.fused_rmsnorm(xp, g, impl="kernel"))
    pre_plain = cuda_ms(lambda: ops.fused_rmsnorm(xp, g, impl="ref"))
    pre_lib = cuda_ms(lambda: F.rms_norm(xp, (576,), weight=w, eps=1e-6))
    pre_bound, _ = bound(2 * xp.numel() * 4 + 576 * 4, 4 * xp.numel())
    log(f"[kernels] rmsnorm x (1, 256, 576) f32: {pre_ms:.5f} ms, plain "
        f"{pre_plain:.5f} ms, F.rms_norm {pre_lib:.5f} ms, bound {pre_bound:.6f} ms")

    # the train step's shape: batch 8 x seq 512 x d_model 1024
    xt = torch.randn(8, 512, 1024, device="cuda")
    gt = 0.5 * torch.randn(1024, device="cuda")
    wt = 1 + gt
    med_t, _ = cuda_ms_turns({
        "call": lambda: ops.fused_rmsnorm(xt, gt, impl="kernel"),
        "lib": lambda: F.rms_norm(xt, (1024,), weight=wt, eps=1e-6)})
    train = dict(
        ms=med_t["call"],
        plain_ms=cuda_ms(lambda: ops.fused_rmsnorm(xt, gt, impl="ref")),
        library_ms=med_t["lib"],
        bound_ms=bound(2 * xt.numel() * 4 + 1024 * 4, 4 * xt.numel())[0],
        device_us=device_us(lambda: ops.fused_rmsnorm(xt, gt, impl="kernel"), "rmsnorm"),
        library_device_us=library_device_us(
            lambda: F.rms_norm(xt, (1024,), weight=wt, eps=1e-6))[0],
    )
    train["ratio_to_library"] = train["ms"] / train["library_ms"]
    log(f"[kernels] rmsnorm x (8, 512, 1024) f32: {train['ms']:.5f} ms, plain "
        f"{train['plain_ms']:.5f} ms, F.rms_norm {train['library_ms']:.5f} ms, "
        f"bound {train['bound_ms']:.6f} ms; {train['device_us']:.2f} us on the card a launch, "
        f"F.rms_norm {train['library_device_us']:.2f} us; B1's call "
        f"{train['ratio_to_library']:.2f}x F.rms_norm's (target <= 1.1x, printed, not held)")
    return dict(
        name="rmsnorm", route="cuda",
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:28",
        shape="x (4, 1, 576) float32 (decode step)",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
        library="torch.nn.functional.rms_norm(weight=1+g)",
        ratio_to_library=ms / library_ms, host_us=host,
        device_us=dev_us, library_device_us=lib_dev_us, library_launches=lib_launches,
        at_train_shape=train, gemma2_width=g2,
    )


def host_us(fns, n=10_000, rounds=5):
    """{name: host microseconds a call} of each function in ``fns``: the
    median over ``rounds`` rounds, each timing every function over n /
    rounds calls in turn (perf_counter_ns; the card synchronised between
    them, not timed), so that the host's drift reaches all alike."""
    for fn in fns.values():
        for _ in range(50):
            fn()
    torch.cuda.synchronize()
    per = {name: [] for name in fns}
    m = max(1, n // rounds)
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter_ns()
            for _ in range(m):
                fn()
            per[name].append((time.perf_counter_ns() - t0) / m / 1e3)
            torch.cuda.synchronize()
    return {name: sorted(v)[len(v) // 2] for name, v in per.items()}


def rmsnorm_host_breakdown(ops, rn, F, x, g, w):
    """B1's call path at x's shape on the host's clock, step by step: the
    dispatch (ops.fused_rmsnorm around the wrapper), the wrapper's checks
    and allocation (rmsnorm.rmsnorm around its C entry point), the C entry
    point through ctypes with the kernel's launch; F.rms_norm beside it
    (scripts/torch_rmsnorm_host_probe.py splits it further)."""
    from repro_torch.kernels import build

    y = torch.empty_like(x)
    D = x.shape[-1]
    lib = build.library()
    args = (x.data_ptr(), g.data_ptr(), y.data_ptr(), x.numel() // D, D, 1e-6, 0,
            build.stream(x))
    t = host_us({"call": lambda: ops.fused_rmsnorm(x, g, impl="kernel"),
                 "wrapper": lambda: rn.rmsnorm(x, g),
                 "entry": lambda: lib.repro_rmsnorm(*args),
                 "F.rms_norm": lambda: F.rms_norm(x, (D,), weight=w, eps=1e-6)})
    out = {"call": t["call"], "dispatch": t["call"] - t["wrapper"],
           "checks_and_allocation": t["wrapper"] - t["entry"], "c_entry_point": t["entry"],
           "library": t["F.rms_norm"]}
    log(f"[kernels] rmsnorm x {tuple(x.shape)} f32, host us a call (medians of 5 rounds): "
        f"ops.fused_rmsnorm {out['call']:.3f} = dispatch {out['dispatch']:.3f} + the "
        f"wrapper's checks and allocation {out['checks_and_allocation']:.3f} + the C entry "
        f"point by ctypes with the launch {out['c_entry_point']:.3f}; F.rms_norm "
        f"{out['library']:.3f}")
    return out


def paged_case(B, K, G, d, P, C, lens, q_dtype, kv_dtype, seed):
    """A pool with slot b's first lens[b] tokens written through a permuted
    page table; stale random bytes elsewhere; lens 0 -> q_pos = -1."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    N = B * C + 3
    q = torch.randn(B, K * G, d, device="cuda", generator=gen).to(q_dtype)
    kp = torch.randn(N, P, K, d, device="cuda", generator=gen).to(kv_dtype)
    vp = torch.randn(N, P, K, d, device="cuda", generator=gen).to(kv_dtype)
    perm = torch.randperm(N, device="cuda", generator=gen)
    tab = perm[:B * C].reshape(B, C).to(torch.int32)
    pos = torch.full((N, P), -1, dtype=torch.int32, device="cuda")
    for b, T in enumerate(lens):
        t = torch.arange(T, device="cuda")
        pos[tab[b, t // P].long(), t % P] = t.to(torch.int32)
    q_pos = torch.tensor([T - 1 for T in lens], dtype=torch.int32, device="cuda")
    return q, kp, vp, pos, tab, q_pos


f32, bf16 = torch.float32, torch.bfloat16
# B8 over f32/bf16 pools: (label, B, K, G, d, P, C, lens, q_dtype, kv_dtype,
# window, softcap, masked); lens 0 -> an inactive slot (q_pos -1); the slots
# in ``masked`` get q_pos 40 over pages that hold nothing (every entry
# masked).  Each case's seed is its index.
DECODE_CASES = [
    ("engine shape", 8, 3, 3, 64, 16, 20, [320, 201, 64, 17, 256, 8, 140, 99],
     f32, f32, 0, 0.0, ()),
    ("engine shape bf16", 8, 3, 3, 64, 16, 20, [320, 201, 64, 17, 256, 8, 140, 99],
     bf16, bf16, 0, 0.0, ()),
    ("MHA, half page, inactive", 4, 9, 1, 64, 16, 20, [9, 0, 160, 300],
     f32, f32, 0, 0.0, ()),
    ("MQA, half page, inactive", 4, 1, 9, 64, 16, 20, [0, 41, 320, 72],
     f32, f32, 0, 0.0, ()),
    ("window", 4, 3, 3, 64, 16, 20, [300, 45, 0, 128], f32, f32, 100, 0.0, ()),
    ("softcap", 4, 3, 3, 64, 16, 20, [300, 45, 0, 128], f32, f32, 0, 30.0, ()),
    ("window + softcap bf16", 4, 3, 3, 64, 16, 20, [300, 45, 0, 128],
     bf16, bf16, 64, 20.0, ()),
    ("f32 q over bf16 pools", 4, 3, 3, 64, 16, 20, [57, 320, 1, 0], f32, bf16, 0, 0.0, ()),
    ("bf16 q over f32 pools", 4, 3, 3, 64, 16, 20, [57, 320, 1, 0], bf16, f32, 0, 0.0, ()),
    ("d_head 128", 4, 3, 3, 128, 16, 20, [300, 45, 0, 128], f32, f32, 0, 0.0, ()),
    ("d_head 256, gemma2-2b's 8/4 heads", 4, 4, 2, 256, 16, 20, [300, 45, 0, 128],
     f32, f32, 0, 0.0, ()),
    ("d_head 256, 8/4 heads, bf16", 4, 4, 2, 256, 16, 20, [300, 45, 0, 128],
     bf16, bf16, 0, 0.0, ()),
    ("one slot of 2048 tokens (128 pages)", 1, 3, 3, 64, 16, 128, [2048],
     f32, f32, 0, 0.0, ()),
    ("32 slots", 32, 3, 3, 64, 16, 20,
     [0 if i % 11 == 7 else (37 * i + 5) % 321 for i in range(32)], f32, f32, 0, 0.0, ()),
    ("C = 1 (one split)", 4, 3, 3, 64, 16, 1, [16, 5, 0, 1], f32, f32, 0, 0.0, ()),
    ("slots of one token, a fully masked slot", 4, 3, 3, 64, 16, 20, [1, 0, 300, 1],
     f32, f32, 0, 0.0, (1,)),
    ("d_head 20 bf16: 40-byte rows, read byte by byte", 3, 2, 2, 20, 8, 9, [50, 3, 72],
     bf16, bf16, 0, 0.0, ()),
    ("drafter scaled(0.25): 9/3 heads of 16", 4, 3, 3, 16, 16, 20, [120, 0, 75, 260],
     f32, f32, 0, 0.0, ()),
    ("drafter make_proxy(0.125): 9/3 heads of 8, 32-byte rows", 4, 3, 3, 8, 16, 20,
     [120, 33, 0, 260], f32, f32, 0, 0.0, ()),
]
# B8 over int8 pools (seed 200 + index): (label, B, K, G, d, C, lens,
# q_dtype, window, softcap, masked), page 16
INT8_DECODE_CASES = [
    ("engine shape", 4, 3, 3, 64, 20, [120, 200, 260, 310], f32, 0, 0.0, ()),
    ("engine shape, an inactive slot", 4, 3, 3, 64, 20, [57, 0, 320, 16], f32, 0, 0.0, ()),
    ("bf16 q", 4, 3, 3, 64, 20, [300, 45, 0, 128], bf16, 0, 0.0, ()),
    ("MHA, half page", 4, 9, 1, 64, 20, [9, 0, 160, 300], f32, 0, 0.0, ()),
    ("MQA (G = 9), half page", 4, 1, 9, 64, 20, [0, 41, 320, 72], f32, 0, 0.0, ()),
    ("window", 4, 3, 3, 64, 20, [300, 45, 0, 128], f32, 100, 0.0, ()),
    ("softcap", 4, 3, 3, 64, 20, [300, 45, 0, 128], f32, 0, 30.0, ()),
    ("window + softcap, bf16 q", 4, 3, 3, 64, 20, [300, 45, 0, 128], bf16, 64, 20.0, ()),
    ("d_head 128", 4, 3, 3, 128, 20, [300, 45, 0, 128], f32, 0, 0.0, ()),
    ("d_head 256, gemma2-2b's 8/4 heads", 4, 4, 2, 256, 20, [300, 45, 0, 128],
     f32, 0, 0.0, ()),
    ("one slot of 2048 tokens (128 pages)", 1, 3, 3, 64, 128, [2048], f32, 0, 0.0, ()),
    ("32 slots", 32, 3, 3, 64, 20,
     [0 if i % 11 == 7 else (37 * i + 5) % 321 for i in range(32)], f32, 0, 0.0, ()),
    ("C = 1 (one split)", 4, 3, 3, 64, 1, [16, 5, 0, 1], f32, 0, 0.0, ()),
    ("slots of one token, a fully masked slot", 4, 3, 3, 64, 20, [1, 0, 300, 1],
     bf16, 0, 0.0, (1,)),
    ("MQA (G = 9), bf16 q, window + softcap", 4, 1, 9, 64, 20, [0, 41, 320, 72],
     bf16, 64, 20.0, ()),
    ("d_head 40: 40-byte rows, read byte by byte", 3, 2, 2, 40, 9, [50, 3, 72], f32, 0,
     0.0, ()),
    ("drafter scaled(0.25): 9/3 heads of 16, 16-byte rows", 4, 3, 3, 16, 20,
     [120, 0, 75, 260], f32, 0, 0.0, ()),
    ("drafter make_proxy(0.125): 9/3 heads of 8, 8-byte rows read byte by byte", 4, 3, 3,
     8, 20, [120, 33, 0, 260], f32, 0, 0.0, ()),
]


def mask_slots(q_pos, masked):
    """q_pos 40 for the slots in ``masked``, whose pages hold nothing: every
    entry they see is masked.  Returns the rows that must be exact zeros
    (these and the inactive slots)."""
    for b in masked:
        q_pos[b] = 40
    zero = q_pos < 0
    zero[list(masked)] = True
    return zero


def check_decode(ops, label, args, kw, tol, zero):
    """B8 against its plain version on the same inputs: max abs err within
    ``tol`` and the rows ``zero`` exactly zero.  Returns the error."""
    from repro_torch.kernels.decode_attention import decode_splits

    got = ops.decode_attention(*args, impl="kernel", **kw)
    want = ops.decode_attention(*args, impl="ref", **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    nonzero = int(torch.count_nonzero(got[zero]))
    if not err <= tol or nonzero:
        raise AssertionError(f"flash_decode case {label!r}: max err {err}, "
                             f"{nonzero} nonzero entries in rows that see nothing")
    B, C, K = args[4].shape[0], args[4].shape[1], args[1].shape[2]
    log(f"[kernels] flash_decode {label}: max err {err:.3g} (atol {tol}), "
        f"{decode_splits(B, K, C)} splits, {int(zero.sum())} rows exactly zero")
    return err


def check_decode_cases(ops):
    """B8 over f32/bf16 pools on DECODE_CASES (atol 2e-5, 2e-2 where bf16
    enters).  Returns the worst error per tier."""
    worst = {f32: 0.0, bf16: 0.0}
    for i, case in enumerate(DECODE_CASES):
        label, B, K, G, d, P, C, lens, qdt, kvdt, window, cap, masked = case
        q, kp, vp, pos, tab, q_pos = paged_case(B, K, G, d, P, C, lens, qdt, kvdt, i)
        zero = mask_slots(q_pos, masked)
        tier = bf16 if bf16 in (qdt, kvdt) else f32
        err = check_decode(ops, label, (q, kp, vp, pos, tab, q_pos),
                           dict(scale=0.125, window=window, softcap=cap), ATOL[tier], zero)
        worst[tier] = max(worst[tier], err)
    return worst


def decode_phase(ops, da, F):
    worst = check_decode_cases(ops)
    # timing at the main path's decode shape: 4 slots, smollm-135m heads,
    # 20 pages of 16 per slot, slots part-way through their requests
    q, kp, vp, pos, tab, q_pos = paged_case(4, 3, 3, 64, 16, 20, DECODE_LENS,
                                            torch.float32, torch.float32, 99)
    row = dict(name="flash_decode",
               shape="q (4, 9, 64) f32, pools (83, 16, 3, 64) f32, live lens "
                     + ",".join(map(str, DECODE_LENS)),
               worst_err_f32=worst[f32], worst_err_bf16=worst[bf16],
               **decode_row(ops, F, "flash_decode", (q, kp, vp, pos, tab, q_pos)))
    row["scaling"] = decode_scaling(ops, "flash_decode")
    row["drafter_shapes"] = drafter_rows(ops, da, F, "flash_decode")
    return row


DECODE_LENS = [120, 200, 260, 310]   # the timed B8 shape's live lengths


def gathered_kv(kp, vp, scales, tab, b, L, P):
    """Slot b's first L entries as contiguous (1, K, L, d) f32 K and V,
    dequantized when ``scales`` are given (the library yardstick's inputs:
    the gather is not timed), and their page ids."""
    t = torch.arange(L, device="cuda")
    page = tab[b, t // P].long()
    k, v = kp[page, t % P].float(), vp[page, t % P].float()
    if scales is not None:
        k = k * scales["k_scale"][page][:, :, None]
        v = v * scales["v_scale"][page][:, :, None]
    return (k.permute(1, 0, 2)[None].contiguous(), v.permute(1, 0, 2)[None].contiguous(),
            page)


def pool_bytes_read(tokens, pages, K, d, itemsize, scales):
    """Bytes a paged decode must read of the pools: live K and V, their
    scales (int8 pools), positions and table entries."""
    return (2 * tokens * K * d * itemsize + (2 * pages * K * 4 if scales else 0)
            + tokens * 4 + pages * 4)


def decode_bytes_flops(q, kp, tab, lens, scales):
    """(bytes, flops) a B8 call must move and do for slots of live lengths
    ``lens``: live pages of K and V (scales, positions and table entries
    with them), q, out and q_pos read or written once; 4 H d flops a live
    token, plus the dequantization of int8 pools."""
    S, H = q.shape[:2]
    P, K, d = kp.shape[1:]
    pages = sum(min(tab.shape[1], (L - 1) // P + 1) for L in lens if L > 0)
    tokens = pages * P
    nbytes = (pool_bytes_read(tokens, pages, K, d, kp.element_size(), scales)
              + 2 * q.numel() * q.element_size() + S * 4)
    flops = 4 * H * d * tokens + (2 * K * d * tokens if scales else 0)
    return nbytes, flops


def decode_row(ops, F, name, args, scales=None, label="the decode shape"):
    """B8's time (over f32 pools, or int8 pools with ``scales``) at a
    decode shape of live lengths DECODE_LENS: a call (CUDA events, 200 calls) and on the
    card (torch.profiler), beside its plain version, SDPA over the
    pre-gathered (dequantized) K/V of the same live lengths (attention
    only; its call and its kernels' time on the card), the split count and
    the bound."""
    from repro_torch.kernels.decode_attention import decode_splits

    q, kp, vp, pos, tab, q_pos = args
    S, K, d, P = q.shape[0], kp.shape[2], kp.shape[3], kp.shape[1]
    kw = dict(scale=0.125, **(scales or {}))
    err = (ops.decode_attention(*args, impl="kernel", **kw)
           - ops.decode_attention(*args, impl="ref", **kw)).abs().max().item()
    ms = cuda_ms(lambda: ops.decode_attention(*args, impl="kernel", **kw))
    plain_ms = cuda_ms(lambda: ops.decode_attention(*args, impl="ref", **kw))
    dev_us = device_us(lambda: ops.decode_attention(*args, impl="kernel", **kw), name)
    T = max(DECODE_LENS)
    kk = torch.zeros(S, K, T, d, device="cuda")
    vv = torch.zeros(S, K, T, d, device="cuda")
    mask = torch.zeros(S, 1, 1, T, dtype=torch.bool, device="cuda")
    for b, L in enumerate(DECODE_LENS):
        kb, vb, _ = gathered_kv(kp, vp, scales, tab, b, L, P)
        kk[b, :, :L], vv[b, :, :L] = kb[0], vb[0]
        mask[b, ..., :L] = True
    qq = q[:, :, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, scale=0.125,
                                              enable_gqa=True)
    library_ms = cuda_ms(sdpa)
    lib_us, lib_n = library_device_us(sdpa)
    nbytes, flops = decode_bytes_flops(q, kp, tab, DECODE_LENS, scales)
    bound_ms, bound_by = bound(nbytes, flops)
    splits = decode_splits(S, K, tab.shape[1])
    share = bound_ms * 1e3 / dev_us
    log(f"[kernels] {name} at {label}: {ms:.5f} ms a call, {dev_us:.2f} us a "
        f"launch on the card ({share:.1%} of the {bound_by} bound), {splits} splits; "
        f"plain {plain_ms:.5f} ms, SDPA {library_ms:.5f} ms a call and {lib_us:.2f} us on "
        f"the card ({lib_n:g} kernels); bound {bound_ms:.6f} ms ({bound_by}: {nbytes} "
        f"bytes, {flops} flops)")
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:44",
        max_abs_err=err, ms=ms, device_us=dev_us, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, bound_share=share, splits=splits, library_ms=library_ms,
        library_device_us=lib_us,
        library="torch.nn.functional.scaled_dot_product_attention over pre-gathered "
                + ("dequantized " if scales else "") + "K/V (attention only)",
    )


# B8's time on the card beyond the decode shape: (label, B, C, lens)
DECODE_SCALING = [
    ("one slot of 2048 tokens (128 pages)", 1, 128, [2048]),
    ("32 slots, 8-20 live pages each", 32, 20, [120 + (190 * i) // 31 for i in range(32)]),
]


def decode_scaling(ops, name):
    """{label: (device us a launch, share of the bound)} of B8 (int8 pools
    for a name ending in _int8) at the DECODE_SCALING shapes, smollm-135m's
    heads."""
    out = {}
    for label, B, C, lens in DECODE_SCALING:
        q, kp, vp, pos, tab, q_pos = paged_case(B, 3, 3, 64, 16, C, lens, f32, f32, 98)
        scales = None
        if name.endswith("_int8"):
            kp, vp, scales = int8_pools(kp, vp, 98)
        args = (q, kp, vp, pos, tab, q_pos)
        kw = dict(scale=0.125, **(scales or {}))
        us = device_us(lambda: ops.decode_attention(*args, impl="kernel", **kw), name)
        bound_ms, bound_by = bound(*decode_bytes_flops(q, kp, tab, lens, scales))
        out[label] = (us, bound_ms * 1e3 / us)
        log(f"[kernels] {name} {label}: {us:.2f} us a launch on the card "
            f"({bound_ms * 1e3 / us:.1%} of the {bound_by} bound)")
    return out


def multi_case(B, T, K, G, d, P, C, hist, q_dtype, kv_dtype, seed, dead=(),
               share=False):
    """Slot b holds hist[b] tokens of history and a T-token chunk after them
    (positions hist[b] .. hist[b] + T - 1), written through a permuted page
    table; stale random bytes elsewhere.  ``dead`` (b, t) rows sit at
    q_pos -1 (their chunk entries are not written).  With ``share`` slot 1's
    first two table entries map slot 0's pages (a prefix shared through the
    cache: slot 1's first 2P tokens are slot 0's)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    N = B * C + 3
    q = torch.randn(B, T, K * G, d, device="cuda", generator=gen).to(q_dtype)
    kp = torch.randn(N, P, K, d, device="cuda", generator=gen).to(kv_dtype)
    vp = torch.randn(N, P, K, d, device="cuda", generator=gen).to(kv_dtype)
    perm = torch.randperm(N, device="cuda", generator=gen)
    tab = perm[:B * C].reshape(B, C).to(torch.int32)
    if share:
        tab[1, :2] = tab[0, :2]
    q_pos = torch.stack([torch.arange(h, h + T, device="cuda") for h in hist]).to(torch.int32)
    for b, t in dead:
        q_pos[b, t] = -1
    pos = torch.full((N, P), -1, dtype=torch.int32, device="cuda")
    for b, h in enumerate(hist):
        t = torch.arange(h, device="cuda")
        if share and b == 1:
            t = t[t >= 2 * P]             # slot 0 wrote the shared span
        t = torch.cat([t, q_pos[b][q_pos[b] >= 0].long()])
        pos[tab[b, t // P].long(), t % P] = t.to(torch.int32)
    return q, kp, vp, pos, tab, q_pos


# the speculative drafter's catch-up chunk (T = draft_k + 1 = 5) at its
# d_head: slot 1 inactive, slot 3 at the start of its request (positions
# pos - 4 .. pos with the first two below 0, at -1)
DRAFTER_MULTI_CASES = [
    (f"drafter catch-up T = 5, {label}", 4, 5, 3, 3, d, 16, 20, [70, 0, 250, 0], f32, f32,
     0, 0.0, (*((1, t) for t in range(5)), (3, 0), (3, 1)), False)
    for label, d in (("9/3 heads of 16", 16), ("9/3 heads of 8", 8))
]
# B9 over f32/bf16 pools: (label, B, T, K, G, d, P, C, hist, q_dtype, kv_dtype,
# window, softcap, dead, share); case i's seed is 100 + i
MULTI_CASES = [
    ("engine chunk", 1, 64, 3, 3, 64, 16, 20, [100], f32, f32, 0, 0.0, (), False),
    ("engine chunk bf16", 1, 64, 3, 3, 64, 16, 20, [192], bf16, bf16, 0, 0.0, (), False),
    ("last chunk of a 200-token prompt (rows past it at -1)", 1, 64, 3, 3, 64, 16, 20,
     [192], f32, f32, 0, 0.0, tuple((0, t) for t in range(8, 64)), False),
    ("T not a multiple of the row tile", 8, 37, 3, 3, 64, 16, 20,
     [0, 5, 16, 100, 200, 31, 64, 2], f32, f32, 0, 0.0, ((0, 36), (3, 0)), False),
    ("speculative-verify shape", 4, 5, 3, 3, 64, 16, 20, [70, 0, 250, 33], f32, f32, 0, 0.0,
     tuple((1, t) for t in range(5)), False),
    ("MHA", 2, 9, 9, 1, 64, 16, 20, [40, 3], f32, f32, 0, 0.0, ((1, 8),), False),
    ("MQA", 2, 9, 1, 9, 64, 16, 20, [40, 3], f32, f32, 0, 0.0, ((0, 0),), False),
    ("window", 2, 24, 3, 3, 64, 16, 20, [100, 3], f32, f32, 48, 0.0, (), False),
    ("softcap", 2, 24, 3, 3, 64, 16, 20, [100, 3], f32, f32, 0, 20.0, (), False),
    ("window + softcap bf16", 2, 24, 3, 3, 64, 16, 20, [100, 3], bf16, bf16, 48, 20.0, (),
     False),
    ("f32 q over bf16 pools", 2, 24, 3, 3, 64, 16, 20, [100, 3], f32, bf16, 0, 0.0, (), False),
    ("two slots share pages", 2, 12, 3, 3, 64, 16, 20, [80, 80], f32, f32, 0, 0.0, (), True),
    ("d_head 128", 2, 24, 3, 3, 128, 16, 20, [100, 3], f32, f32, 0, 0.0, ((1, 2),), False),
    ("d_head 256, gemma2-2b's 8/4 heads", 2, 24, 4, 2, 256, 16, 20, [100, 3], f32, f32, 0,
     0.0, (), False),
    ("d_head 256, 8/4 heads, bf16", 2, 24, 4, 2, 256, 16, 20, [100, 3], bf16, bf16, 0, 0.0,
     (), False),
    ("a chunk of 256 over 2048 tokens (128 pages)", 1, 256, 3, 3, 64, 16, 128, [1792], f32,
     f32, 0, 0.0, (), False),
    ("32 slots at T = 5", 32, 5, 3, 3, 64, 16, 20,
     [(37 * i + 5) % 300 for i in range(32)], f32, f32, 0, 0.0,
     tuple((i, t) for i in range(32) if i % 11 == 7 for t in range(5)), False),
    ("a tile whose splits hold no page (1 live page, 8 splits)", 2, 8, 3, 3, 64, 16, 20,
     [3, 9], f32, f32, 0, 0.0, ((0, 7),), False),
    ("d_head 20 bf16: 40-byte rows, read byte by byte", 3, 7, 2, 2, 20, 8, 9, [50, 3, 40],
     bf16, bf16, 0, 0.0, ((2, 6),), False),
    *DRAFTER_MULTI_CASES,
]
# B9 over int8 pools: the same fields (the pools are int8_pools of f32
# ones); case i's seed is 300 + i
INT8_MULTI_CASES = [
    ("engine chunk, history resident", 1, 64, 3, 3, 64, 16, 20, [128], f32, f32, 0, 0.0, (),
     False),
    ("engine chunk, bf16 q", 1, 64, 3, 3, 64, 16, 20, [192], bf16, f32, 0, 0.0, (), False),
    ("last chunk of a 200-token prompt (rows past it at -1)", 1, 64, 3, 3, 64, 16, 20,
     [192], f32, f32, 0, 0.0, tuple((0, t) for t in range(8, 64)), False),
    ("speculative-verify shape", 4, 5, 3, 3, 64, 16, 20, [70, 0, 250, 33], f32, f32, 0, 0.0,
     tuple((1, t) for t in range(5)), False),
    ("MHA", 2, 9, 9, 1, 64, 16, 20, [40, 3], f32, f32, 0, 0.0, ((1, 8),), False),
    ("MQA", 2, 9, 1, 9, 64, 16, 20, [40, 3], f32, f32, 0, 0.0, ((0, 0),), False),
    ("window + softcap", 2, 24, 3, 3, 64, 16, 20, [100, 3], f32, f32, 48, 20.0, (), False),
    ("two slots share pages", 2, 12, 3, 3, 64, 16, 20, [80, 80], f32, f32, 0, 0.0, (), True),
    ("d_head 128", 2, 24, 3, 3, 128, 16, 20, [100, 3], f32, f32, 0, 0.0, ((1, 2),), False),
    ("d_head 256, gemma2-2b's 8/4 heads", 2, 24, 4, 2, 256, 16, 20, [100, 3], f32, f32, 0,
     0.0, (), False),
    ("a chunk of 256 over 2048 tokens (128 pages)", 1, 256, 3, 3, 64, 16, 128, [1792], f32,
     f32, 0, 0.0, (), False),
    ("32 slots at T = 5", 32, 5, 3, 3, 64, 16, 20,
     [(37 * i + 5) % 300 for i in range(32)], f32, f32, 0, 0.0,
     tuple((i, t) for i in range(32) if i % 11 == 7 for t in range(5)), False),
    ("a tile whose splits hold no page (1 live page, 8 splits)", 2, 8, 3, 3, 64, 16, 20,
     [3, 9], bf16, f32, 0, 0.0, ((0, 7),), False),
    ("d_head 40: 40-byte rows, read byte by byte", 3, 7, 2, 2, 40, 8, 9, [50, 3, 40], f32,
     f32, 0, 0.0, ((2, 6),), False),
    *DRAFTER_MULTI_CASES,
]


def multi_plan_of(da, args):
    """B9's plan for these inputs, the kernel's own (the C entry point, on
    this card), held equal to the mirror the CPU tests hold
    (decode_multi_plan at this card's SM count)."""
    q, kp, tab = args[0], args[1], args[4]
    B, T, H, d = q.shape
    N, P, K, _ = kp.shape
    C = tab.shape[1]
    plan = da.kernel_multi_plan(B, K, T, H // K, d, P, C, kp.element_size())
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    mirror = da.decode_multi_plan(B, K, T, H // K, d, P, C, kp.element_size(), sms)
    if plan != mirror:
        raise AssertionError(f"B9's plan: the kernel's {plan}; decode_multi_plan's {mirror}")
    return plan


def multi_held(name, label, got, args, kw, tol):
    """B9's output ``got`` held against its plain version on the same inputs.
    It must come within ``tol`` of the f32 plain version (the one ops runs on
    CPU tensors).  Where it does not, the f32 plain version must be shown to
    be the one at fault: ``got`` within ``tol`` of the plain version with
    float64 products and sums (pages dequantized in f32 first, as the
    kernel does), and the f32 plain version at least as far from that value
    as ``got``.  Returns (the error held, what it was held against, and a
    note of the distances to the f32 plain version and to float64)."""
    from repro_torch.kernels import ref

    plain = ref.decode_attention_multi_ref(*args, **kw).float()
    exact = ref.decode_attention_multi_ref(*args, acc_dtype=torch.float64, **kw).float()
    got = got.float()
    err = (got - plain).abs().max().item()
    e64 = (got - exact).abs().max().item()
    p64 = (plain - exact).abs().max().item()
    note = (f"{err:.3g} from the f32 plain version; from float64: the kernel {e64:.3g}, "
            f"the f32 plain version {p64:.3g}")
    if err <= tol:
        return err, "the f32 plain version", note
    if e64 <= tol and e64 <= p64:
        return e64, "float64 (the f32 plain version is the farther)", note
    raise AssertionError(f"{name} {label}: max err {err} from the f32 plain version (atol "
                         f"{tol}); from float64 {e64}, the f32 plain version's {p64}")


def check_multi(ops, da, label, args, kw, tol, dead):
    """B9 against its plain version on the same inputs (multi_held), the
    rows ``dead`` (q_pos -1) exactly zero, one launch.  Returns (error,
    plan)."""
    name = "flash_decode_multi_int8" if "k_scale" in kw else "flash_decode_multi"
    n0 = ops.launch_counts()[name]
    got = ops.decode_attention_multi(*args, impl="kernel", **kw)
    torch.cuda.synchronize()
    launched = ops.launch_counts()[name] - n0
    err, against, note = multi_held(name, label, got, args, kw, tol)
    dead_nonzero = sum(int(torch.count_nonzero(got[b, t])) for b, t in dead)
    if dead_nonzero or launched != 1:
        raise AssertionError(f"{name} case {label!r}: {dead_nonzero} nonzero entries in rows "
                             f"at -1, {launched} launches")
    plan = multi_plan_of(da, args)
    log(f"[kernels] {name} {label}: max err {err:.3g} from {against} (atol {tol}; {note}), "
        f"plan tq {plan.tq} "
        f"({plan.tq * (args[0].shape[2] // args[1].shape[2])} rows), {plan.tiles} tiles, "
        f"{plan.splits} splits, {plan.slots} slot(s) of {plan.stage_pages} pages, "
        f"{plan.smem} bytes; {len(dead)} rows at -1 exactly zero")
    return err, plan


def check_multi_cases(ops, da):
    """B9 against its plain version on the card on MULTI_CASES (f32 atol
    2e-5, 2e-2 where bf16 enters), rows at q_pos -1 exactly zero; T = 1
    against B8 on the same inputs.  Returns the worst error per tier."""
    worst = {f32: 0.0, bf16: 0.0}
    for i, case in enumerate(MULTI_CASES):
        label, B, T, K, G, d, P, C, hist, qdt, kvdt, window, cap, dead, share = case
        args = multi_case(B, T, K, G, d, P, C, hist, qdt, kvdt, 100 + i, dead, share)
        tier = bf16 if bf16 in (qdt, kvdt) else f32
        err, plan = check_multi(ops, da, label, args, dict(scale=0.125, window=window,
                                                            softcap=cap), ATOL[tier], dead)
        worst[tier] = max(worst[tier], err)
        if label.startswith("T not a multiple") and T % plan.tq == 0:
            raise AssertionError(f"{label}: the row tile {plan.tq} divides T={T}")
        if label.startswith("a tile whose splits") and plan.splits <= (max(hist) + T) // P:
            raise AssertionError(f"{label}: {plan.splits} splits, every one with a page")

    # T = 1 against B8 on the same inputs
    q, kp, vp, pos, tab, q_pos = multi_case(4, 1, 3, 3, 64, 16, 20, [57, 0, 300, 16],
                                            f32, f32, 77, ((1, 0),))
    got = ops.decode_attention_multi(q, kp, vp, pos, tab, q_pos, scale=0.125,
                                     impl="kernel")[:, 0]
    b8 = ops.decode_attention(q[:, 0].contiguous(), kp, vp, pos, tab,
                              q_pos[:, 0].contiguous(), scale=0.125, impl="kernel")
    torch.cuda.synchronize()
    err = (got - b8).abs().max().item()
    if not err <= ATOL[f32] or torch.count_nonzero(got[1]) != 0:
        raise AssertionError(f"flash_decode_multi at T=1 against B8: max err {err}")
    log(f"[kernels] flash_decode_multi T=1 against flash_decode (B8): max err {err:.3g}")
    return worst


# B9's chunk shape (the dynamic serve's last chunk of a 256-token prompt) and
# the two scaling shapes: (label, B, T, C, hist)
MULTI_SHAPES = [
    ("chunk shape", 1, 64, 20, [192]),
    ("a chunk of 256 over a 2048-token history", 1, 256, 128, [1792]),
    ("32 slots at the verify T = 5", 32, 5, 20, [120 + (190 * i) // 31 for i in range(32)]),
]


def multi_phase(ops, da, F):
    """B9's checks, then its time at the dynamic serve's chunk shape: one
    slot, a 64-token chunk at positions 192..255 (the last chunk of a
    256-token prompt), smollm-135m's 9/3 heads of 64, 16 live pages of 16;
    then at the scaling shapes."""
    worst = check_multi_cases(ops, da)
    rows = multi_rows(ops, da, F, "flash_decode_multi")
    return dict(name="flash_decode_multi",
                shape="q (1, 64, 9, 64) f32 at positions 192..255, pools (23, 16, 3, "
                      "64) f32, 16 live pages",
                worst_err_f32=worst[f32], worst_err_bf16=worst[bf16], **rows,
                drafter_shapes=drafter_rows(ops, da, F, "flash_decode_multi"))


def multi_rows(ops, da, F, name):
    """multi_row at each MULTI_SHAPES shape (f32 pools, or int8 pools for a
    name ending in _int8): the chunk shape's numbers, the scaling shapes'
    under ``scaling``."""
    out = {}
    for label, B, T, C, hist in MULTI_SHAPES:
        args = multi_case(B, T, 3, 3, 64, 16, C, hist, f32, f32, 99)
        scales = None
        if name.endswith("_int8"):
            kq, vq, scales = int8_pools(args[1], args[2], 98)
            args = (args[0], kq, vq, *args[3:])
        row = multi_row(ops, da, F, name, label, args, scales)
        if not out:
            out = row
            out["scaling"] = {}
        else:
            out["scaling"][label] = {k: row[k] for k in (
                "ms", "device_us", "plain_ms", "bound_ms", "bound_by", "bound_share",
                "plan", "library_ms", "library_device_us")}
    return out


def multi_row(ops, da, F, name, label, args, scales=None):
    """B9's time (over f32 pools, or int8 pools with ``scales``): a call
    (CUDA events, 200 calls) and on the card (torch.profiler), beside its
    plain version, SDPA over each slot's pre-gathered (dequantized) live K/V
    with the boolean position mask (attention only; its call and its
    kernels' time on the card), the plan and the bound (the (row, token)
    pairs visible)."""
    q, kp, vp, pos, tab, q_pos = args
    B, T, H, d = q.shape
    K, P = kp.shape[2], kp.shape[1]
    kw = dict(scale=0.125, **(scales or {}))
    err, _, _ = multi_held(name, f"at the {label}",
                              ops.decode_attention_multi(*args, impl="kernel", **kw), args,
                              kw, ATOL[f32])
    ms = cuda_ms(lambda: ops.decode_attention_multi(*args, impl="kernel", **kw))
    plain_ms = cuda_ms(lambda: ops.decode_attention_multi(*args, impl="ref", **kw), n=20)
    dev_us = device_us(lambda: ops.decode_attention_multi(*args, impl="kernel", **kw),
                       name)
    lens = [int(q_pos[b].max()) + 1 for b in range(B)]
    Lmax = max(lens)
    kk = torch.zeros(B, K, Lmax, d, device="cuda")
    vv = torch.zeros(B, K, Lmax, d, device="cuda")
    mask = torch.zeros(B, 1, T, Lmax, dtype=torch.bool, device="cuda")
    pages = 0
    for b, L in enumerate(lens):
        kb, vb, page = gathered_kv(kp, vp, scales, tab, b, L, P)
        kk[b, :, :L], vv[b, :, :L] = kb[0], vb[0]
        kv_pos = pos[page, torch.arange(L, device="cuda") % P]
        mask[b, 0, :, :L] = (kv_pos[None, :] >= 0) & (kv_pos[None, :] <= q_pos[b][:, None])
        pages += (L - 1) // P + 1
    qq = q.permute(0, 2, 1, 3).contiguous()                          # (B, H, T, d)

    def sdpa():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, scale=0.125,
                                              enable_gqa=True)
    library_ms = cuda_ms(sdpa)
    lib_us, lib_n = library_device_us(sdpa)
    tokens = pages * P
    visible = int(mask.sum())                   # (query, token) pairs these inputs need
    nbytes = (pool_bytes_read(tokens, pages, K, d, kp.element_size(), scales)
              + 2 * q.numel() * q.element_size() + q_pos.numel() * 4)   # q, out, q_pos
    flops = 4 * H * d * visible + (2 * K * d * tokens if scales else 0)
    bound_ms, bound_by = bound(nbytes, flops)
    share = bound_ms * 1e3 / dev_us
    plan = multi_plan_of(da, args)
    log(f"[kernels] {name} at the {label}: {ms:.5f} ms a call, {dev_us:.2f} us a launch on "
        f"the card ({share:.1%} of the {bound_by} bound); plan tq {plan.tq}, {plan.tiles} "
        f"tiles, {plan.splits} splits, {plan.slots} slot(s) of {plan.stage_pages} pages; "
        f"plain {plain_ms:.5f} ms, SDPA {library_ms:.5f} ms a call and {lib_us:.2f} us on "
        f"the card ({lib_n:g} kernels); bound {bound_ms:.6f} ms ({bound_by}: {nbytes} "
        f"bytes, {flops} flops over {visible} visible pairs)")
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:113",
        max_abs_err=err, ms=ms, device_us=dev_us, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, bound_share=share, plan=plan._asdict(), library_ms=library_ms,
        library_device_us=lib_us,
        library="torch.nn.functional.scaled_dot_product_attention over pre-gathered "
                + ("dequantized " if scales else "")
                + "K/V with the boolean position mask (attention only)",
    )


# the speculative drafters' heads: (label, d_head); 9 query and 3 kv heads
DRAFTER_HEADS = [("scaled(0.25), 9/3 heads of 16", 16),
                 ("make_proxy(0.125), 9/3 heads of 8", 8)]


def drafter_rows(ops, da, F, name):
    """{label: timing} of B8 (decode_row, single drafter steps of 4 slots at
    DECODE_LENS) or B9 (multi_row, the catch-up chunk T = 5 of 4 slots
    ending at DECODE_LENS) at each drafter's d_head, over f32 pools, or
    int8 pools for a name ending in _int8."""
    out = {}
    for label, d in DRAFTER_HEADS:
        if name.startswith("flash_decode_multi"):
            args = multi_case(4, 5, 3, 3, d, 16, 20, [n - 5 for n in DECODE_LENS], f32, f32,
                              97)
        else:
            args = paged_case(4, 3, 3, d, 16, 20, DECODE_LENS, f32, f32, 97)
        scales = None
        if name.endswith("_int8"):
            kq, vq, scales = int8_pools(args[1], args[2], 97)
            args = (args[0], kq, vq, *args[3:])
        if name.startswith("flash_decode_multi"):
            row = multi_row(ops, da, F, name, f"drafter {label}, catch-up T = 5", args,
                            scales)
        else:
            row = decode_row(ops, F, name, args, scales, label=f"the drafter {label}")
        out[label] = {k: row[k] for k in ("max_abs_err", "ms", "device_us", "plain_ms",
                                          "bound_ms", "bound_by", "bound_share",
                                          "library_ms", "library_device_us")}
    return out


def int8_pools(kp, vp, seed):
    """int8 pools and their (N, K) scales from f32 pools, each page and kv
    head first scaled by its own factor in [0.1, 3.1) so that the scales
    differ (quant.pack_kv: absmax/127 over the page)."""
    from repro_torch import quant

    gen = torch.Generator(device="cuda").manual_seed(seed)
    N, _, K, _ = kp.shape
    f = 0.1 + 3 * torch.rand(2, N, 1, K, 1, device="cuda", generator=gen)
    kq, vq, ks, vs = quant.pack_kv(kp.float() * f[0], vp.float() * f[1])
    return kq, vq, dict(k_scale=ks, v_scale=vs)


def check_int8_decode_cases(ops):
    """B8's int8 mode against its plain version on the card on
    INT8_DECODE_CASES (f32 q at atol 2e-5, bf16 q at 2e-2), inactive and
    fully masked slots exactly zero.  Returns the worst error per q
    dtype."""
    worst = {f32: 0.0, bf16: 0.0}
    for i, (label, B, K, G, d, C, lens, qdt, window, cap, masked) in enumerate(
            INT8_DECODE_CASES):
        q, kp, vp, pos, tab, q_pos = paged_case(B, K, G, d, 16, C, lens, qdt,
                                                torch.float32, 200 + i)
        kq, vq, scales = int8_pools(kp, vp, 200 + i)
        zero = mask_slots(q_pos, masked)
        err = check_decode(ops, f"int8 {label}", (q, kq, vq, pos, tab, q_pos),
                           dict(scale=0.125, window=window, softcap=cap, **scales),
                           ATOL[qdt], zero)
        worst[qdt] = max(worst[qdt], err)
    return worst


def check_int8_multi_cases(ops, da):
    """B9's int8 mode against its plain version on the card on
    INT8_MULTI_CASES (f32 q at atol 2e-5, bf16 q at 2e-2), rows at q_pos -1
    exactly zero; at T = 1 against B8's int8 mode on the same inputs.
    Returns the worst error per q dtype."""
    worst = {f32: 0.0, bf16: 0.0}
    for i, case in enumerate(INT8_MULTI_CASES):
        label, B, T, K, G, d, P, C, hist, qdt, _, window, cap, dead, share = case
        q, kp, vp, pos, tab, q_pos = multi_case(B, T, K, G, d, P, C, hist, qdt, f32,
                                                300 + i, dead, share)
        kq, vq, scales = int8_pools(kp, vp, 300 + i)
        err, plan = check_multi(ops, da, f"int8 {label}", (q, kq, vq, pos, tab, q_pos),
                                dict(scale=0.125, window=window, softcap=cap, **scales),
                                ATOL[qdt], dead)
        worst[qdt] = max(worst[qdt], err)
        if label.startswith("a tile whose splits") and plan.splits <= (max(hist) + T) // P:
            raise AssertionError(f"{label}: {plan.splits} splits, every one with a page")

    # T = 1 against B8's int8 mode on the same inputs
    q, kp, vp, pos, tab, q_pos = multi_case(4, 1, 3, 3, 64, 16, 20, [57, 0, 300, 16],
                                            f32, f32, 377, ((1, 0),))
    kq, vq, scales = int8_pools(kp, vp, 377)
    got = ops.decode_attention_multi(q, kq, vq, pos, tab, q_pos, scale=0.125,
                                     impl="kernel", **scales)[:, 0]
    b8 = ops.decode_attention(q[:, 0].contiguous(), kq, vq, pos, tab,
                              q_pos[:, 0].contiguous(), scale=0.125, impl="kernel",
                              **scales)
    torch.cuda.synchronize()
    err = (got - b8).abs().max().item()
    if not err <= ATOL[f32] or torch.count_nonzero(got[1]) != 0:
        raise AssertionError(f"flash_decode_multi int8 at T=1 against B8 int8: max err {err}")
    log(f"[kernels] flash_decode_multi int8 T=1 against flash_decode int8 (B8): "
        f"max err {err:.3g}")
    worst["t1_vs_b8"] = err
    return worst


def int8_decode_phase(ops, da, F):
    """B8's int8 checks, then its time at the decode shape (decode_row) and
    at the drafters' shapes."""
    worst = check_int8_decode_cases(ops)
    q, kp, vp, pos, tab, q_pos = paged_case(4, 3, 3, 64, 16, 20, DECODE_LENS,
                                            torch.float32, torch.float32, 99)
    kq, vq, scales = int8_pools(kp, vp, 99)
    row = dict(name="flash_decode_int8",
               shape="q (4, 9, 64) f32, pools (83, 16, 3, 64) int8 + (83, 3) f32 "
                     "scales, live lens " + ",".join(map(str, DECODE_LENS)),
               worst_err_f32=worst[torch.float32], worst_err_bf16=worst[torch.bfloat16],
               **decode_row(ops, F, "flash_decode_int8", (q, kq, vq, pos, tab, q_pos),
                            scales))
    row["scaling"] = decode_scaling(ops, "flash_decode_int8")
    row["drafter_shapes"] = drafter_rows(ops, da, F, "flash_decode_int8")
    return row


def int8_multi_phase(ops, da, F):
    """B9's int8 checks, then its time at the chunk shape and the scaling
    shapes (multi_rows)."""
    worst = check_int8_multi_cases(ops, da)
    rows = multi_rows(ops, da, F, "flash_decode_multi_int8")
    return dict(name="flash_decode_multi_int8",
                shape="q (1, 64, 9, 64) f32 at positions 192..255, pools (23, 16, 3, "
                      "64) int8 + (23, 3) f32 scales, 16 live pages",
                worst_err_f32=worst[f32], worst_err_bf16=worst[bf16],
                t1_vs_b8_err=worst["t1_vs_b8"], **rows,
                drafter_shapes=drafter_rows(ops, da, F, "flash_decode_multi_int8"))


# ---------------------------------------------------------------------------
# B8 and B9 over gemma2-2b's rings (its sliding-window layers' tables)
# ---------------------------------------------------------------------------

G2_HEADS = (4, 2, 256)           # gemma2-2b: 4 kv heads, 2 queries each, d_head 256
G2_WINDOW, G2_SOFTCAP = 4096, 50.0


def ring_case(B, T, K, G, d, P, C, ends, seed, ring=True, q_dtype=f32):
    """Slot b's pages as an engine leaves them once it has written
    positions up to ends[b] (f32 pools, stale random bytes elsewhere).  With
    ``ring`` (a windowed layer's table of C columns) the last C * P
    positions, position t at column (t // P) % C: once a slot has wrapped
    its pages hold positions out of logical order, and the page being
    written holds the newest positions beside ones C * P older.  Without it
    (a global table) positions 0 .. ends[b] in order.  T None: one query a
    slot at ends[b] (B8's q (B, H, d), q_pos (B,)); else T queries at
    ends[b] - T + 1 .. ends[b], already written (B9's chunk)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    N, TT = B * C + 3, T or 1
    q = torch.randn(B, TT, K * G, d, device="cuda", generator=gen).to(q_dtype)
    kp = torch.randn(N, P, K, d, device="cuda", generator=gen)
    vp = torch.randn(N, P, K, d, device="cuda", generator=gen)
    perm = torch.randperm(N, device="cuda", generator=gen)
    tab = perm[:B * C].reshape(B, C).to(torch.int32)
    pos = torch.full((N, P), -1, dtype=torch.int32, device="cuda")
    for b, e in enumerate(ends):
        if not ring and e >= C * P:
            raise ValueError(f"a global table of {C} pages cannot hold position {e}")
        t = torch.arange(max(0, e - C * P + 1) if ring else 0, e + 1, device="cuda")
        col = (t // P) % C if ring else t // P
        pos[tab[b, col].long(), t % P] = t.to(torch.int32)
    q_pos = torch.stack([torch.arange(e - TT + 1, e + 1, device="cuda")
                         for e in ends]).to(torch.int32)
    if T is None:
        return q[:, 0].contiguous(), kp, vp, pos, tab, q_pos[:, 0].contiguous()
    return q, kp, vp, pos, tab, q_pos


def ring_wrapped(pos, tab, P):
    """Whether some column j of the tables holds an entry of another logical
    page than j: positions out of logical order (a wrapped ring)."""
    rows = pos[tab.long()]                                          # (B, C, P)
    col = torch.arange(tab.shape[1], device=rows.device)[None, :, None]
    return bool(((rows // P != col) & (rows >= 0)).any())


# (label, B, T, C, ends, window, ring): gemma2-2b's heads, page 16, softcap 50.
# T None is B8 (a decode step), else B9.  The decode steps of the serve
# phases' two long requests (positions 6,400-6,463) over the static engine's
# ring (257 pages: window 4096 + 1), the dynamic engine's (273: chunks of 256
# write 255 ahead) and the global table (404 pages: 6,464 positions); a
# chunk of 256 at positions 6,144-6,399 over the dynamic engine's ring and
# the global table; a small window (48) whose ring of 4 (B8) or 5 (B9, 7
# written ahead) pages has wrapped many times
G2_RING_CASES = [
    ("decode over the 257-page ring", 4, None, 257, [6400, 6421, 6442, 6463], G2_WINDOW,
     True),
    ("decode over the 273-page ring", 4, None, 273, [6400, 6421, 6442, 6463], G2_WINDOW,
     True),
    ("decode over the 404-page global table", 4, None, 404, [6400, 6421, 6442, 6463], 0,
     False),
    ("decode, window 48 over a 4-page ring", 4, None, 4, [100, 37, 64, 250], 48, True),
    ("a chunk of 256 over the 273-page ring", 1, 256, 273, [6399], G2_WINDOW, True),
    ("a chunk of 256 over the 404-page global table", 1, 256, 404, [6399], 0, False),
    ("a chunk of 8, window 48 over a 5-page ring", 2, 8, 5, [100, 250], 48, True),
]


def g2_args(case, seed, int8, heads=G2_HEADS, softcap=G2_SOFTCAP):
    """(args, kw) of a G2_RING_CASES case (or MX_RING_CASES' with mixtral's
    ``heads`` and no softcap): f32 pools, or int8 ones with their scales."""
    label, B, T, C, ends, window, ring = case
    args = ring_case(B, T, *heads, 16, C, ends, seed, ring=ring)
    kw = dict(scale=heads[2] ** -0.5, window=window, softcap=softcap)
    if int8:
        kq, vq, scales = int8_pools(args[1], args[2], seed)
        args = (args[0], kq, vq, *args[3:])
        kw.update(scales)
    return args, kw


def as_multi(args):
    """B8's inputs as B9's at T = 1 (q (B, 1, H, d), q_pos (B, 1))."""
    q, kp, vp, pos, tab, q_pos = args
    return (q[:, None], kp, vp, pos, tab, q_pos[:, None])


def check_g2_cases(ops, da, cases=G2_RING_CASES, heads=G2_HEADS, softcap=G2_SOFTCAP,
                   tag="gemma2", seed=400):
    """B8 and B9 against their plain versions over gemma2-2b's rings and
    global tables (G2_RING_CASES; or mixtral's, MX_RING_CASES, with its
    ``heads`` and no softcap), f32 and int8 pools, held by multi_held (B8 as
    B9 at T = 1) at the f32 tier; the wrapped tables must hold pages out of
    logical order.  Returns {name: worst error}."""
    worst = {}
    for int8 in (False, True):
        for i, case in enumerate(cases):
            label, B, T, C, ends, window, ring = case
            args, kw = g2_args(case, seed + i, int8, heads, softcap)
            if ring and not ring_wrapped(args[3], args[4], 16):
                raise AssertionError(f"{label}: the ring holds its positions in order")
            if T is None:
                name = "flash_decode_int8" if int8 else "flash_decode"
                got = ops.decode_attention(*args, impl="kernel", **kw)
                err, against, note = multi_held(name, label, got[:, None], as_multi(args),
                                                kw, ATOL[f32])
                log(f"[kernels] {name} {tag} {label}: max err {err:.3g} from {against} "
                    f"(atol {ATOL[f32]}; {note}), {da.decode_splits(B, heads[0], C)} splits")
            else:
                name = "flash_decode_multi_int8" if int8 else "flash_decode_multi"
                err, _ = check_multi(ops, da, f"{tag} {label}", args, kw, ATOL[f32], ())
            worst[name] = max(worst.get(name, 0.0), err)
    return worst


# the timed gemma2 shapes: (label, index into G2_RING_CASES) for B8 / B9
G2_TIMED = {"flash_decode": [("decode over the 257-page ring", 0),
                             ("decode over the 404-page global table", 2)],
            "flash_decode_multi": [("a chunk of 256 over the 273-page ring", 4),
                                   ("a chunk of 256 over the 404-page global table", 5)]}


def g2_row(ops, da, F, name, label, args, kw, model="gemma2-2b"):
    """B8's or B9's time at a gemma2 shape: a call (CUDA events) and on the
    card, beside its plain version, SDPA over each slot's pre-gathered
    (dequantized) pages with the visibility mask (position, causality,
    window; attention only) and the bound: the pages holding an entry some
    row sees, read once, and 4 H d flops a visible (row, entry) pair."""
    q, kp, vp, pos, tab, q_pos = args
    multi = q.ndim == 4
    margs = args if multi else as_multi(args)
    call = ops.decode_attention_multi if multi else ops.decode_attention
    kern = lambda: call(*args, impl="kernel", **kw)             # noqa: E731
    err, _, _ = multi_held(name, f"at {label}", kern() if multi else kern()[:, None],
                           margs, kw, ATOL[f32])
    ms = cuda_ms(kern)
    plain_ms = cuda_ms(lambda: call(*args, impl="ref", **kw), n=20)
    dev_us = device_us(kern, name)
    qq, _, _, _, _, qp = margs
    B, T, H, d = qq.shape
    N, P, K, _ = kp.shape
    C = tab.shape[1]
    scales = {n: kw[n] for n in ("k_scale", "v_scale") if n in kw} or None
    page = tab.long()                                               # (B, C)
    kk, vv = kp[page].float(), vp[page].float()                     # (B, C, P, K, d)
    if scales:
        kk = kk * scales["k_scale"][page][:, :, None, :, None]
        vv = vv * scales["v_scale"][page][:, :, None, :, None]
    kk = kk.reshape(B, C * P, K, d).permute(0, 2, 1, 3).contiguous()
    vv = vv.reshape(B, C * P, K, d).permute(0, 2, 1, 3).contiguous()
    kv_pos = pos[page].reshape(B, 1, C * P)
    qpos = qp[:, :, None]
    vis = (kv_pos >= 0) & (kv_pos <= qpos) & (qpos >= 0)
    if kw["window"]:
        vis &= (qpos - kv_pos) < kw["window"]
    mask = vis[:, None]                                             # (B, 1, T, C * P)
    q4 = qq.permute(0, 2, 1, 3).contiguous()

    def sdpa():
        # logits softcapped as the kernels do need a custom score: SDPA has
        # no softcap, so the yardstick is attention without it
        return F.scaled_dot_product_attention(q4, kk, vv, attn_mask=mask, scale=kw["scale"],
                                              enable_gqa=True)
    library_ms = cuda_ms(sdpa, n=50)
    lib_us, lib_n = library_device_us(sdpa)
    pages = int(vis.any(dim=1).reshape(B, C, P).any(dim=2).sum())
    visible = int(vis.sum())
    nbytes = (pool_bytes_read(pages * P, pages, K, d, kp.element_size(), scales)
              + 2 * q.numel() * q.element_size() + q_pos.numel() * 4)
    flops = 4 * H * d * visible + (2 * K * d * pages * P if scales else 0)
    bound_ms, bound_by = bound(nbytes, flops)
    share = bound_ms * 1e3 / dev_us
    extra = ""
    if multi:
        plan = multi_plan_of(da, args)
        extra = (f"; plan tq {plan.tq}, {plan.tiles} tiles, {plan.splits} splits, "
                 f"{plan.slots} slot(s) of {plan.stage_pages} pages")
    else:
        extra = f"; {da.decode_splits(B, K, C)} splits"
    log(f"[kernels] {name} at {model}'s {label}: {ms:.5f} ms a call, {dev_us:.2f} us a "
        f"launch on the card ({share:.1%} of the {bound_by} bound){extra}; plain "
        f"{plain_ms:.5f} ms; SDPA {library_ms:.5f} ms a call and {lib_us:.2f} us on the "
        f"card ({lib_n:g} kernels); bound {bound_ms:.6f} ms ({bound_by}: {nbytes} bytes, "
        f"{flops} flops, {pages} pages, {visible} visible pairs)")
    return dict(max_abs_err=err, ms=ms, device_us=dev_us, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, bound_share=share,
                library_ms=library_ms, library_device_us=lib_us,
                library="torch.nn.functional.scaled_dot_product_attention over each "
                        "slot's pre-gathered " + ("dequantized " if scales else "")
                        + "pages with the visibility mask (attention only, no softcap)",
                shape=f"q {tuple(q.shape)}, pools {tuple(kp.shape)} "
                      f"{'int8 + scales' if scales else str(kp.dtype)[6:]}, {C}-page table")


def gemma2_kernel_phase(ops, da, F, rows):
    """B8 and B9 over gemma2-2b's rings (check_g2_cases), then their times
    at the serve phases' shapes (g2_row), kept under ``gemma2_shapes`` in
    the rows of ``rows`` (the kernel line's rows by name)."""
    worst = check_g2_cases(ops, da)
    for name in ("flash_decode", "flash_decode_multi", "flash_decode_int8",
                 "flash_decode_multi_int8"):
        out = {"worst_err": worst[name]}
        for label, i in G2_TIMED[name.replace("_int8", "")]:
            args, kw = g2_args(G2_RING_CASES[i], 450 + i, name.endswith("_int8"))
            out[label] = g2_row(ops, da, F, name, label, args, kw)
        rows[name]["gemma2_shapes"] = out


# mixtral-8x22b's attention: 8 kv heads, 6 queries each (48 heads), d_head
# 128, every layer windowed (4,096), no softcap; d_model 6144
MX_HEADS = (8, 6, 128)
MX_WINDOW, MX_D = 4096, 6144
# (label, B, T, C, ends, window, ring), page 16, as in G2_RING_CASES: the
# static engine's decode steps of 4 slots at positions 4,608-4,639 over
# its 257-page ring (window + 1 page); the dynamic engine's chunk of 256 at
# 4,352-4,607 over its 273-page ring (255 written ahead); a speculative
# verify of draft_k + 1 = 5 over the static engine's 258-page ring (4 ahead)
MX_RING_CASES = [
    ("decode over the 257-page ring", 4, None, 257, [4608, 4618, 4629, 4639], MX_WINDOW,
     True),
    ("a chunk of 256 over the 273-page ring", 1, 256, 273, [4607], MX_WINDOW, True),
    ("a verify of T = 5 over the 258-page ring", 4, 5, 258, [4612, 4620, 4631, 4639],
     MX_WINDOW, True),
]
MX_TIMED = {"flash_decode": [0], "flash_decode_multi": [1, 2]}


def rmsnorm_rows(ops, F, model, shapes, dtypes=(torch.float32, torch.bfloat16)):
    """B1 at a model's shapes (``shapes``, each x's shape, the last dim D),
    in each of ``dtypes``, against the plain version (f32 atol 2e-5; bf16
    within the tier or one bf16 step, rmsnorm_phase's rule) and F.rms_norm,
    each timed: a call (CUDA events), the card's time a launch, the plain
    version's and F.rms_norm's, and the bytes bound."""
    out = {}
    for shape in shapes:
        D = shape[-1]
        for dt in dtypes:
            x = (3 * torch.randn(*shape, device="cuda")).to(dt)
            g = 0.5 * torch.randn(D, device="cuda")
            w = (1 + g).to(dt)
            got = ops.fused_rmsnorm(x, g, impl="kernel").double()
            want = ops.fused_rmsnorm(x, g, impl="ref").double()
            lib = F.rms_norm(x, (D,), weight=w, eps=1e-6).double()
            torch.cuda.synchronize()
            diff = (got - want).abs()
            lim = torch.full_like(want, ATOL[dt])
            if dt == torch.bfloat16:
                lim = torch.maximum(lim, bf16_step(want))
            if not bool((diff <= lim).all()):
                raise AssertionError(f"rmsnorm {shape} {dt}: max err {diff.max().item()}, "
                                     f"{int((diff > lim).sum())} values past their limit")
            ms = cuda_ms(lambda: ops.fused_rmsnorm(x, g, impl="kernel"))
            plain_ms = cuda_ms(lambda: ops.fused_rmsnorm(x, g, impl="ref"), n=50)
            library_ms = cuda_ms(lambda: F.rms_norm(x, (D,), weight=w, eps=1e-6))
            dev_us = device_us(lambda: ops.fused_rmsnorm(x, g, impl="kernel"), "rmsnorm")
            lib_us, _ = library_device_us(lambda: F.rms_norm(x, (D,), weight=w, eps=1e-6))
            nbytes = 2 * x.numel() * x.element_size() + g.numel() * g.element_size()
            bound_ms, bound_by = bound(nbytes, 4 * x.numel())
            key = f"{'x'.join(map(str, shape))} {str(dt)[6:]}"
            out[key] = dict(max_abs_err=diff.max().item(),
                            from_f_rms_norm=(got - lib).abs().max().item(), ms=ms,
                            device_us=dev_us, plain_ms=plain_ms, library_ms=library_ms,
                            library_device_us=lib_us, bound_ms=bound_ms, bound_by=bound_by,
                            bound_share=bound_ms * 1e3 / dev_us)
            log(f"[kernels] rmsnorm at {model}'s x {shape} {str(dt)[6:]}: max err "
                f"{diff.max().item():.3g} from the plain version, "
                f"{out[key]['from_f_rms_norm']:.3g} from F.rms_norm; {ms:.5f} ms a call, "
                f"{dev_us:.2f} us a launch on the card ({out[key]['bound_share']:.1%} of the "
                f"{bound_by} bound {bound_ms:.6f} ms); plain {plain_ms:.5f} ms; F.rms_norm "
                f"{library_ms:.5f} ms a call, {lib_us:.2f} us on the card")
    return out


def mixtral_kernel_phase(ops, da, F, rows):
    """B1 at D 6144 (rmsnorm_rows), then B8 and B9 over mixtral-8x22b's
    rings (MX_RING_CASES: 48/8 heads of 128, a GQA group of 6; f32 and int8
    pools; check_g2_cases, whose B9 checks hold the kernel's plan equal to
    decode_multi_plan at this card's SM count), each timed at its serve
    shape (g2_row), kept under ``mixtral_shapes`` in the rows of ``rows``."""
    rows["rmsnorm"]["mixtral_shapes"] = rmsnorm_rows(
        ops, F, "mixtral", ((4, 1, MX_D), (4608, MX_D)))
    worst = check_g2_cases(ops, da, MX_RING_CASES, MX_HEADS, 0.0, "mixtral", seed=600)
    for name in ("flash_decode", "flash_decode_multi", "flash_decode_int8",
                 "flash_decode_multi_int8"):
        out = {"worst_err": worst[name]}
        for i in MX_TIMED[name.replace("_int8", "")]:
            label = MX_RING_CASES[i][0]
            args, kw = g2_args(MX_RING_CASES[i], 650 + i, name.endswith("_int8"), MX_HEADS, 0.0)
            out[label] = g2_row(ops, da, F, name, label, args, kw, model="mixtral-8x22b")
        rows[name]["mixtral_shapes"] = out


def check_close(what, got, want, atol, rtol=0.0):
    """Raise unless |got - want| <= atol + rtol |want| everywhere; return the
    max abs error."""
    diff = (got.float() - want.float()).abs()
    excess = (diff - atol - rtol * want.float().abs()).max().item()
    err = diff.max().item()
    if not excess <= 0:
        raise AssertionError(f"{what}: max abs err {err} (atol {atol}, rtol {rtol})")
    return err


def check_rounded(what, name, got, want, limits=FLASH_MAX_TOL):
    """Raise unless output ``name``'s max |got - want| <= limits[name] and
    its mean <= FLASH_MEAN_TOL; return (max, mean)."""
    err = rounded_err(got, want)
    if not rounds_like(name, err, limits):
        raise AssertionError(f"{what} {name}: max abs err {err[0]} (limit "
                             f"{limits[name]}), mean {err[1]} (limit "
                             f"{FLASH_MEAN_TOL})")
    return err


def rounds_like(name, err, limits=FLASH_MAX_TOL):
    return err[0] <= limits[name] and err[1] <= FLASH_MEAN_TOL


def rounded_err(got, want):
    """(max, mean) of |got - want|."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), diff.mean().item()


# B2 at gemma2-2b's train step: rows of 4 x 512 tokens (2,048) and twice
# that, D 2304, past the widths whose 16-byte pieces stay in registers (up
# to 1024): the scalar path
G2_NORM_SHAPES = [(2048, 2304), (4096, 2304)]
# and at mixtral-8x22b's (train_mixtral: 4,608 tokens of D 6144, f32; the
# scalar path)
MX_NORM_SHAPES = [(4608, 6144)]
# mamba2-130m's train step: 8 x 512 rows of d_model 768 (the register path)
M2_NORM_SHAPES = [(4096, 768)]


def rmsnorm_bwd_phase(rn, ref, F):
    """B2 against its plain version; timed at the train shape, a call and
    on the card a launch (one launch a call), beside the autograd backward
    of F.rms_norm; then at gemma2-2b's, mixtral-8x22b's and mamba2-130m's
    train shapes (G2_NORM_SHAPES, MX_NORM_SHAPES, M2_NORM_SHAPES)."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    # 16-byte pieces held in registers (D 48, 1024), and the scalar path (D
    # 1030, not a multiple of 4 or 8; D 2304, gemma2's)
    shapes = ([(8, 512, 1024)] + [(r, D) for r in (1, 7, 4097) for D in (48, 1024, 1030)]
              + G2_NORM_SHAPES + MX_NORM_SHAPES + M2_NORM_SHAPES)
    for shape in shapes:
        for dt in (torch.float32, torch.bfloat16):
            x = (3 * torch.randn(*shape, device="cuda")).to(dt)
            g = 0.5 * torch.randn(shape[-1], device="cuda")
            dy = torch.randn(*shape, device="cuda").to(dt)
            dx, dg = rn.rmsnorm_bwd(x, g, dy)
            want_dx, want_dg = ref.rmsnorm_bwd_ref(x, g, dy)
            torch.cuda.synchronize()
            what = f"rmsnorm_bwd {shape} {dt}"
            err = check_close(what + " dx", dx, want_dx, *GRAD_TOL[dt])
            check_close(what + " dgain", dg, want_dg, *GRAD_TOL[torch.float32])
            if not torch.equal(rn.rmsnorm_bwd(x, g, dy)[1], dg):
                raise AssertionError(f"{what}: dgain differs between two calls")
            worst[dt] = max(worst[dt], err)
    log(f"[kernels] rmsnorm_bwd: {2 * len(shapes)} cases agree, dgain "
        f"deterministic; max dx err f32 {worst[torch.float32]:.3g}, bf16 "
        f"{worst[torch.bfloat16]:.3g}")

    x = torch.randn(8, 512, 1024, device="cuda")
    g = 0.5 * torch.randn(1024, device="cuda")
    dy = torch.randn_like(x)
    dx, _ = rn.rmsnorm_bwd(x, g, dy)
    err = (dx - ref.rmsnorm_bwd_ref(x, g, dy)[0]).abs().max().item()
    ms = cuda_ms(lambda: rn.rmsnorm_bwd(x, g, dy))
    plain_ms = cuda_ms(lambda: ref.rmsnorm_bwd_ref(x, g, dy))
    xl = x.clone().requires_grad_(True)
    wl = (1 + g).requires_grad_(True)
    yl = F.rms_norm(xl, (1024,), weight=wl, eps=1e-6)
    library = lambda: torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True)  # noqa: E731
    library_ms = cuda_ms(library)
    dev = device_us(lambda: rn.rmsnorm_bwd(x, g, dy), "rmsnorm_bwd")
    lib_dev, lib_launches = library_device_us(library)
    for _ in range(3):   # a profile may drop an event: fewer is retaken, more fails
        _, launches = library_device_us(lambda: rn.rmsnorm_bwd(x, g, dy))
        if launches >= 1:
            break
    if launches != 1:
        raise AssertionError(f"rmsnorm_bwd: {launches} launches a call, not one")
    nbytes = 3 * x.numel() * 4 + 2 * 1024 * 4
    bound_ms, bound_by = bound(nbytes, 12 * x.numel())
    log(f"[kernels] rmsnorm_bwd at x (8, 512, 1024) f32: {ms:.4f} ms a call, {dev:.2f} us on "
        f"the card in one launch (bound {bound_ms * 1e3:.2f} us by {bound_by}, "
        f"{bound_ms * 1e3 / dev:.1%} of it; target <= 20 us, not held); the autograd backward "
        f"of F.rms_norm {library_ms:.4f} ms a call, {lib_dev:.2f} us on the card in "
        f"{lib_launches:.0f} launches")
    g2, mx, m2 = {}, {}, {}
    for shape, dt in itertools.chain(
            itertools.product(G2_NORM_SHAPES, (torch.float32, torch.bfloat16)),
            itertools.product(MX_NORM_SHAPES, (torch.float32,)),
            itertools.product(M2_NORM_SHAPES, (torch.float32,))):
        model, into, path = (("gemma2-2b", g2, "the scalar path") if shape in G2_NORM_SHAPES
                             else ("mixtral-8x22b", mx, "the scalar path")
                             if shape in MX_NORM_SHAPES
                             else ("mamba2-130m", m2, "the register path"))
        into[f"{shape} {str(dt)[6:]}"] = b2_timing(rn, ref, F, shape, dt, model, path)
    return dict(
        name="rmsnorm_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:36",
        shape="x, dy (8, 512, 1024) float32 (train step)",
        max_abs_err=err, ms=ms, device_us=dev, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms, library_device_us=lib_dev,
        library="autograd backward of torch.nn.functional.rms_norm",
        share_of_bound=bound_ms * 1e3 / dev, gemma2_shapes=g2, mixtral_shapes=mx,
        mamba2_shapes=m2,
    )


def b2_timing(rn, ref, F, shape, dt, model, path):
    """B2 at a model's train-step shape: its largest dx error from the plain
    version, a call (CUDA events), the card's time a launch, the plain
    version's and the autograd backward of F.rms_norm's, and the bytes
    bound."""
    x = (3 * torch.randn(*shape, device="cuda")).to(dt)
    g = 0.5 * torch.randn(shape[-1], device="cuda")
    dy = torch.randn(*shape, device="cuda").to(dt)
    dx, _ = rn.rmsnorm_bwd(x, g, dy)
    e = (dx.float() - ref.rmsnorm_bwd_ref(x, g, dy)[0].float()).abs().max().item()
    xl = x.clone().requires_grad_(True)
    wl = (1 + g).requires_grad_(True)
    yl = F.rms_norm(xl, shape[-1:], weight=wl, eps=1e-6)
    lib = lambda: torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True)  # noqa: E731
    b = bound(3 * x.numel() * x.element_size() + 2 * shape[-1] * 4, 12 * x.numel())
    t = dict(ms=cuda_ms(lambda: rn.rmsnorm_bwd(x, g, dy)),
             device_us=device_us(lambda: rn.rmsnorm_bwd(x, g, dy), "rmsnorm_bwd"),
             plain_ms=cuda_ms(lambda: ref.rmsnorm_bwd_ref(x, g, dy), n=20),
             library_ms=cuda_ms(lib), library_device_us=library_device_us(lib)[0],
             bound_ms=b[0], bound_by=b[1], max_abs_err=e)
    log(f"[kernels] rmsnorm_bwd at x {shape} {str(dt)[6:]} ({model}'s train step, "
        f"{path}): {t['ms']:.4f} ms a call, {t['device_us']:.2f} us on the "
        f"card (bound {b[0] * 1e3:.2f} us by {b[1]}, {b[0] * 1e3 / t['device_us']:.1%}"
        f" of it); plain {t['plain_ms']:.4f} ms; the autograd backward of F.rms_norm "
        f"{t['library_ms']:.4f} ms, {t['library_device_us']:.2f} us on the card")
    return t


def ce_case(N, V, dt, seed):
    """Logits with a wide range, labels with every third row from the second
    masked (-100) and the loss cotangent zero on those rows, as
    Model.loss_fn makes it.  On the other rows g ~ U(0.5, 1.5), not the
    loss's 1/n_rows, so dlogits stay of the order of the softmax itself and
    the check at GRAD_TOL sees an error in either of its terms."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (4 * torch.randn(N, V, device="cuda", generator=gen)).to(dt)
    labels = torch.randint(0, V, (N,), device="cuda", generator=gen,
                           dtype=torch.int32)
    labels[1::3] = -100
    mask = labels >= 0
    g = (0.5 + torch.rand(N, device="cuda", generator=gen)) * mask
    return x, labels.clamp(0, V - 1), g.float(), mask


def ce_timing(ce, ref, F, N, V):
    """B3 and B4 at (N, V) f32: (timings, B3's bound, B4's bound, B3's and
    B4's largest error from their plain versions); each timed a call (CUDA
    events) beside its plain version and F.cross_entropy (its autograd
    backward for B4)."""
    x, lab, g, _ = ce_case(N, V, torch.float32, 100 + V)
    loss, lse = ce.ce_fwd(x, lab)
    want_loss, want_lse = ref.softmax_cross_entropy_ref(x, lab)
    fwd_err = (loss - want_loss).abs().max().item()
    bwd_err = (ce.ce_bwd(x, lab, lse, g)
               - ref.softmax_cross_entropy_bwd_ref(x, lab, lse, g)).abs().max().item()
    t = {
        "ce_fwd": cuda_ms(lambda: ce.ce_fwd(x, lab)),
        "ce_fwd_plain": cuda_ms(lambda: ref.softmax_cross_entropy_ref(x, lab)),
        "ce_bwd": cuda_ms(lambda: ce.ce_bwd(x, lab, lse, g)),
        "ce_bwd_plain": cuda_ms(
            lambda: ref.softmax_cross_entropy_bwd_ref(x, lab, lse, g)),
    }
    lab64 = lab.long()
    t["ce_fwd_library"] = cuda_ms(
        lambda: F.cross_entropy(x, lab64, reduction="none"))
    xl = x.clone().requires_grad_(True)
    yl = F.cross_entropy(xl, lab64, reduction="none")
    t["ce_bwd_library"] = cuda_ms(
        lambda: torch.autograd.grad(yl, xl, g, retain_graph=True))
    del xl, yl
    b3 = bound(N * V * 4 + N * 4 + 2 * N * 4, 5 * N * V)
    b4 = bound(2 * N * V * 4 + 3 * N * 4, 4 * N * V)
    log(f"[kernels] cross entropy ({N}, {V}) f32: ce_fwd {t['ce_fwd']:.4f} ms "
        f"(plain {t['ce_fwd_plain']:.4f}, F.cross_entropy {t['ce_fwd_library']:.4f},"
        f" bound {b3[0]:.4f}); ce_bwd {t['ce_bwd']:.4f} ms (plain "
        f"{t['ce_bwd_plain']:.4f}, its autograd backward {t['ce_bwd_library']:.4f},"
        f" bound {b4[0]:.4f})")
    del x, g, lse, loss, want_loss, want_lse
    torch.cuda.empty_cache()
    return t, b3, b4, fwd_err, bwd_err


# recurrentgemma-9b's shapes: B1 at a decode step of 4 requests and at the
# 4 x 1,920-token prefill (D 4096), B2 at the train step's 2,560 rows (the
# scalar path: D > 1024), B3/B4 at 2,560 rows over vocab 256,000
RG_NORM_ROWS = ((4, 1, 4096), (7680, 4096))
RG_NORM_SHAPES = [(2560, 4096)]
RG_CE = (2560, 256000)


def recurrentgemma_kernel_rows(ops, rn, ce, ref, F, rows):
    """B1, B2, B3 and B4 at recurrentgemma-9b's shapes (RG_NORM_ROWS,
    RG_NORM_SHAPES, RG_CE), held against their plain versions and timed
    beside their bounds and the PyTorch calls; kept under each row's
    ``recurrentgemma_shapes``.  (B3/B4 at RG_CE are held among ce_phase's
    cases.)"""
    by = {row["name"]: row for row in rows}
    by["rmsnorm"]["recurrentgemma_shapes"] = rmsnorm_rows(ops, F, "recurrentgemma",
                                                          RG_NORM_ROWS, (torch.float32,))
    b2 = by["rmsnorm_bwd"].setdefault("recurrentgemma_shapes", {})
    for shape in RG_NORM_SHAPES:
        x = 3 * torch.randn(*shape, device="cuda")
        g = 0.5 * torch.randn(shape[-1], device="cuda")
        dy = torch.randn(*shape, device="cuda")
        dx, dg = rn.rmsnorm_bwd(x, g, dy)
        want_dx, want_dg = ref.rmsnorm_bwd_ref(x, g, dy)
        what = f"rmsnorm_bwd {shape} float32"
        check_close(what + " dx", dx, want_dx, *GRAD_TOL[torch.float32])
        check_close(what + " dgain", dg, want_dg, *GRAD_TOL[torch.float32])
        if not torch.equal(rn.rmsnorm_bwd(x, g, dy)[1], dg):
            raise AssertionError(f"{what}: dgain differs between two calls")
        del x, g, dy, dx, dg, want_dx, want_dg
        b2[f"{shape} float32"] = b2_timing(rn, ref, F, shape, torch.float32,
                                           "recurrentgemma-9b", "the scalar path")
    t, b3, b4, fwd_err, bwd_err = ce_timing(ce, ref, F, *RG_CE)
    key = f"at_recurrentgemma_{RG_CE[0]}_x_{RG_CE[1]}"
    by["ce_fwd"][key] = dict(ce_fwd=t["ce_fwd"], ce_fwd_plain=t["ce_fwd_plain"],
                             ce_fwd_library=t["ce_fwd_library"], ce_fwd_bound=b3[0],
                             ce_fwd_max_abs_err=fwd_err)
    by["ce_bwd"][key] = dict(ce_bwd=t["ce_bwd"], ce_bwd_plain=t["ce_bwd_plain"],
                             ce_bwd_library=t["ce_bwd_library"], ce_bwd_bound=b4[0],
                             ce_bwd_max_abs_err=bwd_err)


def ce_phase(ce, ref, F):
    """B3 and B4 against their plain versions; timed at the train shape
    (4096 rows x vocab 2048) and at smollm's vocab (49152)."""
    cases = [(4096, 2048, torch.float32), (4096, 49152, torch.float32),
             (1, 7, torch.float32), (37, 1000, torch.float32),
             (64, 50257, torch.float32), (256, 2048, torch.bfloat16),
             (33, 3001, torch.bfloat16),
             (2048, 256000, torch.float32), (4608, 32768, torch.float32),
             (4096, 50280, torch.float32), (2560, 256000, torch.float32)]
    worst = [0.0, 0.0]
    for i, (N, V, dt) in enumerate(cases):
        x, lab, g, mask = ce_case(N, V, dt, i)
        loss, lse = ce.ce_fwd(x, lab)
        dx = ce.ce_bwd(x, lab, lse, g)
        want_loss, want_lse = ref.softmax_cross_entropy_ref(x, lab)
        want_dx = ref.softmax_cross_entropy_bwd_ref(x, lab, want_lse, g)
        torch.cuda.synchronize()
        what = f"cross entropy ({N}, {V}) {dt}"
        atol = ATOL[dt]
        worst[0] = max(worst[0], check_close(what + " loss", loss, want_loss, atol))
        check_close(what + " lse", lse, want_lse, atol)
        worst[1] = max(worst[1], check_close(what + " dlogits", dx, want_dx,
                                             *GRAD_TOL[dt]))
        if torch.count_nonzero(dx[~mask]) != 0:
            raise AssertionError(f"{what}: masked rows have non-zero dlogits")
    log(f"[kernels] ce_fwd/ce_bwd: {len(cases)} cases agree, masked rows zero; "
        f"max loss err {worst[0]:.3g}, max dlogits err {worst[1]:.3g}")

    rows = {}
    # the train shape, smollm's vocab, gemma2-2b's train step (4 x 512
    # tokens over vocab 256,000: logits of 2.1 GB), mixtral-8x22b's (one
    # sequence of 4,608 over vocab 32,768) and mamba2-130m's (8 x 512 over
    # vocab 50,280, ragged to the vocab chunks)
    for N, V in ((4096, 2048), (4096, 49152), (2048, 256000), (4608, 32768),
                 (4096, 50280)):
        rows[V] = ce_timing(ce, ref, F, N, V)

    t, b3, b4, fwd_err, bwd_err = rows[2048]
    big = dict(rows[49152][0], ce_fwd_bound=rows[49152][1][0],
               ce_bwd_bound=rows[49152][2][0])
    g2, mx, m2 = (dict(rows[V][0], ce_fwd_bound=rows[V][1][0], ce_bwd_bound=rows[V][2][0],
                       ce_fwd_max_abs_err=rows[V][3], ce_bwd_max_abs_err=rows[V][4])
                  for V in (256000, 32768, 50280))
    common = dict(route="cuda", source="src/repro_torch/kernels/csrc/cross_entropy.cu",
                  shape="logits (4096, 2048) float32 (train step), 1/3 rows masked")
    return [
        dict(name="ce_fwd", replaces="src/repro/kernels/cross_entropy.py:38",
             max_abs_err=fwd_err, ms=t["ce_fwd"], plain_ms=t["ce_fwd_plain"],
             bound_ms=b3[0], bound_by=b3[1], library_ms=t["ce_fwd_library"],
             library="torch.nn.functional.cross_entropy(reduction='none')",
             at_vocab_49152={k: big[k] for k in ("ce_fwd", "ce_fwd_plain",
                                                 "ce_fwd_library", "ce_fwd_bound")},
             at_gemma2_2048_x_256000={k: g2[k] for k in (
                 "ce_fwd", "ce_fwd_plain", "ce_fwd_library", "ce_fwd_bound",
                 "ce_fwd_max_abs_err")},
             at_mixtral_4608_x_32768={k: mx[k] for k in (
                 "ce_fwd", "ce_fwd_plain", "ce_fwd_library", "ce_fwd_bound",
                 "ce_fwd_max_abs_err")},
             at_mamba2_4096_x_50280={k: m2[k] for k in (
                 "ce_fwd", "ce_fwd_plain", "ce_fwd_library", "ce_fwd_bound",
                 "ce_fwd_max_abs_err")},
             **common),
        dict(name="ce_bwd", replaces="src/repro/kernels/cross_entropy.py:74",
             max_abs_err=bwd_err, ms=t["ce_bwd"], plain_ms=t["ce_bwd_plain"],
             bound_ms=b4[0], bound_by=b4[1], library_ms=t["ce_bwd_library"],
             library="autograd backward of torch.nn.functional.cross_entropy",
             at_vocab_49152={k: big[k] for k in ("ce_bwd", "ce_bwd_plain",
                                                 "ce_bwd_library", "ce_bwd_bound")},
             at_gemma2_2048_x_256000={k: g2[k] for k in (
                 "ce_bwd", "ce_bwd_plain", "ce_bwd_library", "ce_bwd_bound",
                 "ce_bwd_max_abs_err")},
             at_mixtral_4608_x_32768={k: mx[k] for k in (
                 "ce_bwd", "ce_bwd_plain", "ce_bwd_library", "ce_bwd_bound",
                 "ce_bwd_max_abs_err")},
             at_mamba2_4096_x_50280={k: m2[k] for k in (
                 "ce_bwd", "ce_bwd_plain", "ce_bwd_library", "ce_bwd_bound",
                 "ce_bwd_max_abs_err")},
             **common),
    ]

# B5-B7: label, B, S, H, K, d, window, softcap, scale, storage dtype
FLASH_CASES = [
    ("train shape", 8, 512, 16, 16, 64, 0, 0.0, 0.125, torch.float32),
    ("smollm heads 9/3 (GQA)", 4, 256, 9, 3, 64, 0, 0.0, 0.125, torch.float32),
    ("window 48", 2, 384, 4, 2, 64, 48, 0.0, 0.125, torch.float32),
    # scale 0.5: logits of std 4, up to ~20, which the cap bends hard
    ("softcap 20", 2, 256, 4, 2, 64, 0, 20.0, 0.5, torch.float32),
    ("ragged S 200", 3, 200, 6, 2, 64, 0, 0.0, 0.125, torch.float32),
    ("bf16 storage", 2, 256, 8, 4, 64, 0, 0.0, 0.125, torch.bfloat16),
    ("d_head 128, ragged S 190", 1, 190, 4, 4, 128, 0, 0.0, 0.125, torch.float32),
    # the tensor-core kernels' edges: d_head zero-padded inside a 16-wide MMA
    # step (at DP 128 and 64), one row and key, one row past a tile, and rows
    # whose bf16 bytes are not 16-byte aligned (element-wise staging)
    ("d_head 96", 2, 256, 4, 2, 96, 0, 0.0, 0.125, torch.float32),
    ("d_head 40", 2, 256, 4, 2, 40, 0, 0.0, 0.125, torch.float32),
    ("S = T = 1", 4, 1, 4, 2, 64, 0, 0.0, 0.125, torch.float32),
    ("S 129", 2, 129, 4, 2, 64, 0, 0.0, 0.125, torch.float32),
    ("d_head 20, bf16 storage", 2, 160, 4, 2, 20, 0, 0.0, 0.125, torch.bfloat16),
    # DP 256, where each kernel's grid splits the output's d columns in two
    # halves: gemma2-2b's heads (8/4 of 256), a window of 48 with its
    # softcap 50 (scale 0.5: logits up to ~40), ragged S, bf16 storage,
    # d_head 196 (f32 rows with a ragged last 8-value piece; bf16 rows read
    # element by element), and gemma2's local layer at its published width:
    # one sequence of 8,192 tokens under window 4,096, the one case where
    # the window cuts the key range as it does in gemma2 (G2_FLASH_TIMED)
    ("gemma2 heads 8/4 of 256", 2, 512, 8, 4, 256, 0, 0.0, 0.0625, torch.float32),
    ("d_head 256, window 48, softcap 50", 2, 384, 4, 2, 256, 48, 50.0, 0.5, torch.float32),
    ("d_head 256, ragged S 200", 2, 200, 8, 4, 256, 0, 0.0, 0.0625, torch.float32),
    ("d_head 256, bf16 storage", 2, 256, 8, 4, 256, 0, 0.0, 0.0625, torch.bfloat16),
    ("d_head 196", 1, 160, 4, 2, 196, 0, 0.0, 0.0625, torch.float32),
    ("d_head 196, bf16 storage", 1, 160, 4, 2, 196, 0, 0.0, 0.0625, torch.bfloat16),
    ("gemma2 local layer, S 8192, window 4096", 1, 8192, 8, 4, 256, 4096, 50.0, 0.0625,
     torch.float32),
    # mixtral-8x22b's train step (train_mixtral): one sequence of 4,608
    # under window 4,096, 48/8 heads of 128 (a GQA group of 6), µP's scale
    # at the base width, 128^-0.5
    ("mixtral train step, S 4608, window 4096", 1, 4608, 48, 8, 128, 4096, 0.0, 128 ** -0.5,
     torch.float32),
    # recurrentgemma-9b's train step (train_recurrentgemma): one sequence of
    # 2,560 under window 2,048, 16 query heads over one kv head of 256 (MQA:
    # a GQA group of 16, B7 summing 16 heads into each dk, dv)
    ("recurrentgemma train step, S 2560, window 2048", 1, 2560, 16, 1, 256, 2048, 0.0,
     0.0625, torch.float32),
]
# the bf16 operand mode of B5, B6 and B7 runs these kernels (flash_attention.cu),
# the f32 mode these, each at every padded d_head
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel")
FFMA_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
PADDED_D = (64, 128, 256)
FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_OUTS = ("o", "lse", "dq", "dk", "dv")


def flash_inputs(B, S, H, K, d, dt, seed):
    """q, k, v and a cotangent do of order 1 (standard normal)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(B, S, H, d, device="cuda", generator=gen).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, S, K, d, device="cuda", generator=gen).to(dt)
            for _ in range(2))
    return q, k, v, do


def flash_pair(fa, ref, qs, k, v, do, **kw):
    """(o, lse, dq, dk, dv) of B5, B6 and B7, and of their plain versions
    (kernels/ref.py: flash_fwd_ref, flash_bwd_ref) on the same inputs: the
    backward pair both take the kernel forward's lse and delta = rowsum(do
    * o), as ops.attention's Function forms it."""
    o, lse = fa.flash_fwd(qs, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(qs, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(qs, k, v, do, lse, delta, **kw)
    plain = (*ref.flash_fwd_ref(qs, k, v, **kw),
             *ref.flash_bwd_ref(qs, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    return (o, lse, dq, dk, dv), plain, delta


@contextlib.contextmanager
def int8_tiles(ref, width):
    """While open, the plain versions tile ``width`` wide in the int8 mode
    (ref.FLASH_TILES): the control with the wrong tiles."""
    saved = {k: dict(v) for k, v in ref.FLASH_TILES.items()}
    for kernel in ref.FLASH_TILES:
        ref.FLASH_TILES[kernel]["int8"] = (width, width)
    try:
        yield
    finally:
        for kernel, modes in saved.items():
            ref.FLASH_TILES[kernel].update(modes)


def flash_case(ops, fa, ref, quant, case, seed):
    """One FLASH_CASES row.  Per operand mode, each kernel against its plain
    version: lse at the f32 tier always; o and dq/dk/dv at the f32 tiers
    where nothing rounds to bf16, else by check_rounded (the bf16 tiers, or
    the int8 one, for the max).  The controls: the f32-mode kernel outputs
    must fail the bf16 mode's check, and the int8-mode kernel outputs must
    fail the int8 check against the plain versions tiled 64 wide.  Then the
    autograd Function (scale fold, delta, casts) in the f32 mode against the
    plain attention under autograd, and the bf16 and int8 modes' distance
    from the policy's plain attention (printed, not held: that one rounds or
    quantizes the normalized p over whole rows, and forms delta from the
    rounded do and v)."""
    label, B, S, H, K, d, window, cap, scale, dt = case
    q, k, v, do = flash_inputs(B, S, H, K, d, dt, seed)
    qs = (q.float() * scale).to(dt)
    kw = dict(causal=True, window=window, softcap=cap)
    f32 = dt == torch.float32
    got, out = {}, {}
    for mode in FLASH_MODES:
        policy = quant.QuantPolicy(mode)
        limits = INT8_MAX_TOL if mode == "int8" else FLASH_MAX_TOL
        got[mode], want, delta = flash_pair(fa, ref, qs, k, v, do, policy=policy, **kw)
        what = f"flash attention {label}, {mode} operands"
        e = {"lse": check_close(what + " lse", got[mode][1], want[1], 2e-5, 1e-5)}
        if mode == "none" and f32:
            e["o"] = check_close(what + " o", got[mode][0], want[0], ATOL[dt])
        else:
            e["o"], e["o_mean"] = check_rounded(what, "o", got[mode][0], want[0], limits)
        for name, g, w in zip(("dq", "dk", "dv"), got[mode][2:], want[2:]):
            if mode == "none":
                e[name] = check_close(f"{what} {name}", g, w, *GRAD_TOL[torch.float32])
            else:
                e[name], e[name + "_mean"] = check_rounded(what, name, g, w, limits)
        if mode == "int8":   # the forward's and the backward's pre-passes, byte for byte
            for name, got_ops, want_ops, fields in (
                    ("forward", fa.quantize_fwd(k, v), ref.flash_quant_fwd_ref(k, v),
                     fa.FWD_I8_FIELDS),
                    ("backward", fa.quantize_bwd(qs, k, v, do),
                     ref.flash_quant_bwd_ref(qs, k, v, do), fa.I8_FIELDS)):
                differ = [n for n in fields if not torch.equal(got_ops[n], want_ops[n])]
                if differ:
                    raise AssertionError(f"{what}: the {name} pre-pass differs from its plain "
                                         f"version in {differ}")
                del got_ops, want_ops
            e["bit_equal"] = {n: torch.equal(g, w) for n, g, w in
                              zip(FLASH_OUTS, got[mode], want)}
        again = fa.flash_bwd_dkv(qs, k, v, do, got[mode][1], delta, policy=policy, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got[mode][3:], again)):
            raise AssertionError(f"{what}: dk/dv differ between two calls")
        control = None
        if mode == "bf16":
            control = {n: rounded_err(g, w) for n, g, w in
                       zip(FLASH_OUTS, got["none"], want) if n != "lse"}
        elif mode == "int8" and S > 64:   # else 64-wide tiles are the same tiles
            with int8_tiles(ref, 64):
                _, lse, _, _, _ = got[mode]
                wrong = (ref.flash_fwd_ref(qs, k, v, policy=policy, **kw)[0],
                         *ref.flash_bwd_ref(qs, k, v, do, lse, delta, policy=policy, **kw))
            control = {n: rounded_err(g, w) for n, g, w in
                       zip(("o", "dq", "dk", "dv"), got[mode][:1] + got[mode][2:], wrong)}
            del wrong
        if control is not None:
            passed = [n for n, c in control.items() if rounds_like(n, c, limits)]
            if passed:
                raise AssertionError(f"{what}: the control's outputs {passed} pass the "
                                     f"{mode} check: {control}")
            e["control_mean"] = {n: c[1] for n, c in control.items()}
        out[mode] = e
        del want, delta, again

    # the autograd Function, kernels against the plain attention under autograd
    for mode in FLASH_MODES:
        policy = quant.QuantPolicy(mode)
        res = {}
        for impl in ("kernel", "ref"):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = ops.attention(*leaves, impl=impl, scale=scale, policy=policy, **kw)
            res[impl] = [o.detach(), *torch.autograd.grad(o, leaves, do)]
        for g in res["kernel"][1:]:
            if g.dtype != dt:
                raise AssertionError(f"flash attention {label}: a gradient is {g.dtype}")
        what = f"flash attention {label} through ops.attention, {mode} operands"
        if mode == "none":
            tier = torch.float32 if f32 else torch.bfloat16
            check_close(what + " o", res["kernel"][0], res["ref"][0], ATOL[tier])
            for name, g, w in zip(("dq", "dk", "dv"), res["kernel"][1:], res["ref"][1:]):
                check_close(f"{what} {name}", g, w, *GRAD_TOL[tier])
        else:
            out[mode]["vs_policy_plain"] = [rounded_err(g, w)[0] for g, w in
                                            zip(res["kernel"], res["ref"])]
        del res
    e0 = out["none"]
    text = (f"[kernels] flash attention {label}, {str(dt)[6:]} storage: f32 operands max "
            f"err o {e0['o']:.3g}, lse {e0['lse']:.3g}, dq {e0['dq']:.3g}, dk "
            f"{e0['dk']:.3g}, dv {e0['dv']:.3g}")
    controls = {"bf16": "f32-mode outputs against the bf16 plain version",
                "int8": "int8 outputs against the plain version tiled 64 wide"}
    for mode in FLASH_MODES[1:]:
        e1 = out[mode]
        text += (f"; {mode} operands max / mean err o {e1['o']:.3g} / {e1['o_mean']:.3g}, "
                 f"lse {e1['lse']:.3g}, "
                 + ", ".join(f"{n} {e1[n]:.3g} / {e1[n + '_mean']:.3g}"
                             for n in ("dq", "dk", "dv"))
                 + f"; control ({controls[mode]}) mean err "
                 + (", ".join(f"{n} {c:.3g}" for n, c in e1["control_mean"].items())
                    if "control_mean" in e1 else "not applicable (no tile wider than 64)")
                 + f"; {mode} through ops.attention against the policy's plain attention, "
                 "max " + ", ".join(f"{n} {c:.3g}" for n, c in
                                    zip(("o", "dq", "dk", "dv"), e1["vs_policy_plain"])))
        if "bit_equal" in e1:
            text += ("; int8 pre-passes' bytes and scales (forward and backward) equal to "
                     "their plain versions; outputs bit-equal to the plain versions: "
                     + ", ".join(f"{n} {'yes' if b else 'no'}" for n, b in e1["bit_equal"].items()))
    log(text)
    return out


# B5-B7 timed at DP 256 (label, B, S, H, K, d, window, softcap, scale):
# gemma2-2b's train step (its local layer's window 4096 is past S there)
# and its local layer at the published width, S 8,192 under window 4,096
G2_FLASH_TIMED = [
    ("gemma2 train step", 4, 512, 8, 4, 256, 4096, 50.0, 0.0625),
    ("gemma2 local layer, S 8192", 1, 8192, 8, 4, 256, 4096, 50.0, 0.0625),
]
# and at DP 128, mixtral-8x22b's train step (train_mixtral)
MX_FLASH_TIMED = [("mixtral train step", 1, 4608, 48, 8, 128, 4096, 0.0, 128 ** -0.5)]
# and at DP 256, recurrentgemma-9b's (train_recurrentgemma): MQA, window 2,048
RG_FLASH_TIMED = [("recurrentgemma train step", 1, 2560, 16, 1, 256, 2048, 0.0, 0.0625)]


def visible_pairs(S, window):
    """(query, key) pairs a causal row set of S rows sees under ``window``
    (0: none): what the kernels' work depends on."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def g2_flash_timing(ops, fa, quant, F, timed=G2_FLASH_TIMED):
    """B5, B6 and B7 at the shapes of ``timed`` (G2_FLASH_TIMED: DP 256;
    MX_FLASH_TIMED: mixtral's train step), in each operand mode: a
    call (CUDA events), the card's time a launch (the int8 mode's B5 and B6
    / B7 without their pre-passes, which are timed apart), the plain
    attention's forward and backward under autograd, and the bound from
    this run's visible pairs and bytes; SDPA's bf16 forward and backward
    (causal, without the window and the softcap, which it does not take)
    for scale.  Returns {label: {mode: {kernel: timing}}, "sdpa": ...}."""
    rates = {"none": F32_FLOP_PER_S, "bf16": BF16_TC_FLOP_PER_S, "int8": INT8_TC_OP_PER_S}
    out = {}
    for label, B, S, H, K, d, window, cap, scale in timed:
        q, k, v, do = flash_inputs(B, S, H, K, d, torch.float32, 200)
        qs = (q * scale).contiguous()
        pairs = B * H * visible_pairs(S, window)
        ioq, iok, rows = q.numel() * 4, k.numel() * 4, B * H * S * 4
        work = {"flash_fwd": (ioq + 2 * iok + ioq + rows, 4 * d * pairs),
                "flash_bwd_dq": (2 * ioq + 2 * iok + 2 * rows + ioq, 6 * d * pairs),
                "flash_bwd_dkv": (2 * ioq + 2 * iok + 2 * rows + 2 * iok, 8 * d * pairs)}
        n = 20 if S > 1024 else N_TIMED
        res = {}
        for mode in FLASH_MODES:
            policy = quant.QuantPolicy(mode)
            kw = dict(causal=True, window=window, softcap=cap,
                      policy=policy if policy.active else None)
            o, lse = fa.flash_fwd(qs, k, v, **kw)
            delta = (do * o).sum(-1).transpose(1, 2).contiguous()
            calls = {"flash_fwd": lambda: fa.flash_fwd(qs, k, v, **kw),
                     "flash_bwd_dq": lambda: fa.flash_bwd_dq(qs, k, v, do, lse, delta, **kw),
                     "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(qs, k, v, do, lse, delta, **kw)}
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            plain = lambda: ops.attention(  # noqa: E731
                *leaves, scale=scale, causal=True, window=window, softcap=cap, policy=policy,
                impl="ref")
            with torch.no_grad():
                p_fwd = cuda_ms(plain, n=5, warmup=1)
            op = plain()
            p_bwd = cuda_ms(lambda: torch.autograd.grad(op, leaves, do, retain_graph=True), n=5,
                            warmup=1)
            sfx = "_int8" if mode == "int8" else ""
            res[mode] = {nm: dict(ms=cuda_ms(fn, n=n), device_us=device_us(fn, nm + sfx),
                                  bound=bound(*work[nm], rates[mode]))
                         for nm, fn in calls.items()}
            res[mode]["plain_fwd_ms"], res[mode]["plain_fwd_bwd_ms"] = p_fwd, p_bwd
            del o, lse, delta, leaves, op
            torch.cuda.empty_cache()
            dp = next(p for p in PADDED_D if d <= p)
            log(f"[kernels] flash attention at DP {dp}, {label} ({B}, {S}, {H}/{K} heads "
                f"of {d},"
                f" window {window}, softcap {cap:g}), {mode} operands: "
                + "; ".join(f"{nm} {r['ms']:.4f} ms, {r['device_us']:.1f} us on the card "
                            f"(bound {r['bound'][0] * 1e3:.1f} us by {r['bound'][1]}, "
                            f"{r['bound'][0] * 1e3 / r['device_us']:.1%})"
                            for nm, r in res[mode].items() if nm in work)
                + f"; plain attention forward {p_fwd:.3f} ms, its backward {p_bwd:.3f} ms")
        qb, kb, vb, dob = (t.transpose(1, 2).bfloat16().contiguous().requires_grad_(t is not do)
                           for t in (qs, k, v, do))
        sdpa = lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=True,  # noqa: E731
                                                      enable_gqa=True)
        ob = sdpa()
        fwd_ms = cuda_ms(sdpa, n=n)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(ob, (qb, kb, vb), dob, retain_graph=True),
                         n=n)
        fwd_us = library_device_us(sdpa)[0]
        bwd_us = library_device_us(
            lambda: torch.autograd.grad(ob, (qb, kb, vb), dob, retain_graph=True))[0]
        res["sdpa_bf16"] = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, fwd_device_us=fwd_us,
                                bwd_device_us=bwd_us)
        bt = {n: r["device_us"] for n, r in res["bf16"].items() if n in work}
        log(f"[kernels] SDPA bf16 at {label} (causal, no window, no softcap): forward "
            f"{fwd_ms:.4f} ms, {fwd_us:.1f} us on the card; backward {bwd_ms:.4f} ms, "
            f"{bwd_us:.1f} us on the card; the bf16 B5 {bt['flash_fwd'] / fwd_us:.2f}x its "
            f"forward, B6 + B7 {(bt['flash_bwd_dq'] + bt['flash_bwd_dkv']) / bwd_us:.2f}x its "
            f"backward (for scale, not held)")
        out[label] = res
        del q, k, v, do, qs, qb, kb, vb, dob, ob
        torch.cuda.empty_cache()
    return out


def flash_phase(ops, fa, ref, quant, F):
    """B5-B7 against their plain versions in the three operand modes (see
    flash_case); timed at the train shape, with the card's time per launch
    of the int8 kernels."""
    errs = {}
    for i, case in enumerate(FLASH_CASES):
        errs[case[0]] = flash_case(ops, fa, ref, quant, case, i)
        torch.cuda.empty_cache()
    worst = {m: max(max(e[m][n] for n in ("o", "dq", "dk", "dv")) for e in errs.values())
             for m in FLASH_MODES}
    worst_mean = {m: max(e[m][n + "_mean"] for e in errs.values()
                         for n in ("o", "dq", "dk", "dv")) for m in FLASH_MODES[1:]}
    least_control = {m: min(c for e in errs.values()
                            for c in e[m].get("control_mean", {}).values())
                     for m in FLASH_MODES[1:]}
    log(f"[kernels] flash attention: {len(FLASH_CASES)} cases x {len(FLASH_MODES)} operand "
        f"modes agree, dk/dv deterministic; worst max err f32 operands "
        f"{worst['none']:.3g}, bf16 operands {worst['bf16']:.3g} (limits {FLASH_MAX_TOL}), "
        f"int8 operands {worst['int8']:.3g} (limits {INT8_MAX_TOL}); worst mean err "
        + ", ".join(f"{m} {v:.3g}" for m, v in worst_mean.items())
        + f" (limit {FLASH_MEAN_TOL}); least control mean err "
        + ", ".join(f"{m} {v:.3g}" for m, v in least_control.items()))

    # timing at the train shape: B 8, S 512, 16 heads of 64, causal, f32
    _, B, S, H, K, d, _, _, scale, dt = FLASH_CASES[0]
    q, k, v, do = flash_inputs(B, S, H, K, d, dt, 100)
    qs = (q * scale).contiguous()
    pairs = B * H * S * (S + 1) // 2          # visible (query, key) pairs
    io = q.numel() * 4                        # one (B, S, H, d) f32 tensor
    rows = B * H * S * 4                      # one (B, H, S) f32 tensor
    work = {  # bytes each kernel must move, and its tile-matmul operations
        "flash_fwd": (3 * io + io + rows, 4 * d * pairs),
        "flash_bwd_dq": (4 * io + 2 * rows + io, 6 * d * pairs),
        "flash_bwd_dkv": (4 * io + 2 * rows + 2 * io, 8 * d * pairs),
    }
    # the library yardstick: SDPA on bf16 q/k/v in its (B, H, S, d) layout
    qb, kb, vb, dob = (t.transpose(1, 2).bfloat16().contiguous().requires_grad_(t is not do)
                       for t in (q, k, v, do))
    sdpa = lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=True, scale=scale)
    ob = sdpa()
    with torch.no_grad():
        lib_fwd = cuda_ms(sdpa)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(ob, (qb, kb, vb), dob, retain_graph=True))
    lib_fwd_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qb, kb, vb), dob))
    rates = {"none": F32_FLOP_PER_S, "bf16": BF16_TC_FLOP_PER_S, "int8": INT8_TC_OP_PER_S}
    timed = {}
    for mode in ("bf16", "int8", "none"):
        policy = quant.QuantPolicy(mode)
        pol = policy if policy.active else None
        fkw = dict(causal=True, policy=pol)
        o, lse = fa.flash_fwd(qs, k, v, **fkw)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        plain = lambda: ops.attention(*leaves, scale=scale, policy=policy, impl="ref")
        op = plain()
        calls = {
            "flash_fwd": lambda: fa.flash_fwd(qs, k, v, **fkw),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(qs, k, v, do, lse, delta, **fkw),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(qs, k, v, do, lse, delta, **fkw),
        }
        t = {n: cuda_ms(fn) for n, fn in calls.items()}
        dev = ({n: device_us(fn, n + ("_int8" if mode == "int8" else ""))
                for n, fn in calls.items()} if mode != "none" else {})
        with torch.no_grad():
            p_fwd = cuda_ms(lambda: plain(), n=20)
        p_dq = cuda_ms(lambda: torch.autograd.grad(op, leaves[0], do, retain_graph=True), n=20)
        p_dkv = cuda_ms(lambda: torch.autograd.grad(op, leaves[1:], do, retain_graph=True), n=20)
        b = {n: bound(*work[n], rates[mode]) for n in FLASH_NAMES}
        timed[mode] = dict(ms=t, device_us=dev, plain={"flash_fwd": p_fwd, "flash_bwd_dq": p_dq,
                                                      "flash_bwd_dkv": p_dkv}, bound=b)
        log(f"[kernels] flash attention (8, 512, 16, 64) causal f32, {mode} operands: "
            + "; ".join(f"{n} {t[n]:.4f} ms (plain {timed[mode]['plain'][n]:.4f}, "
                        f"bound {b[n][0]:.4f} by {b[n][1]}"
                        + (f", {dev[n]:.2f} us on the card" if dev else "") + ")"
                        for n in FLASH_NAMES))
        del o, lse, delta, leaves, op
        torch.cuda.empty_cache()
    log(f"[kernels] SDPA bf16 causal (8, 16, 512, 64): forward {lib_fwd:.4f} ms, "
        f"backward {lib_bwd:.4f} ms, forward + backward {lib_fwd_bwd:.4f} ms")
    prepass = int8_backward_timing(fa, ref, quant, qs, k, v, do, errs, timed["int8"],
                                   (qb, kb, vb, dob, ob))
    fwd_prepass = int8_forward_timing(fa, ref, quant, qs, k, v, timed["int8"], lib_fwd)
    bt = timed["bf16"]["ms"]
    ratios = {"flash_fwd": bt["flash_fwd"] / lib_fwd, "flash_bwd_dq": bt["flash_bwd_dq"] / lib_bwd,
              "flash_bwd_dkv": bt["flash_bwd_dkv"] / lib_bwd}
    # SDPA's backward computes dq, dk and dv: B6 + B7 is its fair pair
    b6_b7 = (bt["flash_bwd_dq"] + bt["flash_bwd_dkv"]) / lib_bwd
    log(f"[kernels] bf16 operands against SDPA in this call: flash_fwd "
        f"{ratios['flash_fwd']:.2f}x SDPA's forward (target <= 3x), flash_bwd_dq "
        f"{ratios['flash_bwd_dq']:.2f}x SDPA's backward alone (target <= 0.75x; "
        f"{timed['bf16']['device_us']['flash_bwd_dq']:.2f} us on the card), flash_bwd_dkv "
        f"{ratios['flash_bwd_dkv']:.2f}x SDPA's backward alone (target <= 1x), flash_bwd_dq + "
        f"flash_bwd_dkv {b6_b7:.2f}x SDPA's backward alone, which computes dq, dk and dv "
        f"(target <= 1.3x); targets printed, not held")

    common = dict(route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
                  shape="q, k, v, do (8, 512, 16, 64) f32, causal; bf16 operands "
                        "(the --amp bf16 path)")
    lines = {"flash_fwd": ("src/repro/kernels/flash_attention.py:77", lib_fwd,
                           "torch.nn.functional.scaled_dot_product_attention(is_causal"
                           "=True), bf16 q/k/v, forward"),
             "flash_bwd_dq": ("src/repro/kernels/flash_attention.py:158", lib_fwd_bwd,
                              "SDPA bf16 forward + backward (dq, dk, dv together)"),
             "flash_bwd_dkv": ("src/repro/kernels/flash_attention.py:194", lib_fwd_bwd,
                               "SDPA bf16 forward + backward (dq, dk, dv together)")}
    err_at = {"flash_fwd": ["o", "lse"], "flash_bwd_dq": ["dq"], "flash_bwd_dkv": ["dk", "dv"]}
    out = []
    for n in FLASH_NAMES:
        replaces, lib_ms, lib_name = lines[n]
        bf, f32, i8 = timed["bf16"], timed["none"], timed["int8"]
        out.append(dict(
            name=n, replaces=replaces,
            max_abs_err=max(errs["train shape"]["bf16"][j] for j in err_at[n]),
            ms=bf["ms"][n], plain_ms=bf["plain"][n], bound_ms=bf["bound"][n][0],
            bound_by=bf["bound"][n][1], library_ms=lib_ms, library=lib_name,
            library_bwd_ms=None if n == "flash_fwd" else lib_bwd,
            device_us=bf["device_us"][n],
            **({"ratio_to_sdpa_fwd": ratios[n]} if n == "flash_fwd"
               else {"ratio_to_sdpa_bwd": ratios[n], "b6_b7_ratio_to_sdpa_bwd": b6_b7}),
            f32_operands=dict(
                ms=f32["ms"][n], plain_ms=f32["plain"][n], bound_ms=f32["bound"][n][0],
                bound_by=f32["bound"][n][1],
                max_abs_err=max(errs["train shape"]["none"][j] for j in err_at[n])),
            **common))
        out.append(dict(
            name=n + "_int8", replaces=f"{replaces} (int8 operands: kernel_dot, "
                                      "src/repro/quant/core.py:63-67)",
            max_abs_err=max(errs["train shape"]["int8"][j] for j in err_at[n]),
            ms=i8["ms"][n], device_us=i8["device_us"][n], plain_ms=i8["plain"][n],
            bound_ms=i8["bound"][n][0], bound_by=i8["bound"][n][1], library_ms=None,
            library="none: no PyTorch call computes int8-operand attention",
            sdpa_bf16_ms_for_scale=lib_ms,
            share_of_bound=(i8["bound"][n][0] * 1e3 / i8["device_us"][n]),
            **dict(common, shape="q, k, v, do (8, 512, 16, 64) f32, causal; int8 operands "
                                 "(the --amp int8 path)")))
    out += [prepass, fwd_prepass]
    for key, timed in (("gemma2_shapes", G2_FLASH_TIMED), ("mixtral_shapes", MX_FLASH_TIMED),
                       ("recurrentgemma_shapes", RG_FLASH_TIMED)):
        at = g2_flash_timing(ops, fa, quant, F, timed)
        for row in out:
            name = row["name"]
            base, mode = (name[:-5], "int8") if name.endswith("_int8") else (name, "bf16")
            if base in FLASH_NAMES:
                row[key] = {
                    label: dict({m: r[m][base] for m in FLASH_MODES} if mode == "bf16"
                                else {"int8": r["int8"][base]}, sdpa_bf16=r["sdpa_bf16"],
                                plain={m: (r[m]["plain_fwd_ms"], r[m]["plain_fwd_bwd_ms"])
                                       for m in FLASH_MODES})
                    for label, r in at.items()}
    pre = g2_prepass_timing(fa, ref)
    for row in out:
        if row["name"] in pre:
            row["gemma2_shapes"] = {G2_FLASH_TIMED[0][0]: pre[row["name"]]}
    return out


def g2_prepass_timing(fa, ref):
    """Both int8 pre-passes at DP 256, gemma2-2b's train step (G2_FLASH_TIMED's
    first shape): bytes and scales equal to their plain versions', a call's
    ms, the card's time a launch, the plain version's ms and the bound (the
    bytes read and written; ~4 f32 operations a value quantized).  Returns
    {row name: timing}."""
    label, B, S, H, K, d, _, _, scale = G2_FLASH_TIMED[0]
    q, k, v, do = flash_inputs(B, S, H, K, d, torch.float32, 210)
    qs = (q * scale).contiguous()
    out = {}
    for name, call, plain, fields, n_in, n_ops in (
            ("flash_fwd_quant_int8", lambda: fa.quantize_fwd(k, v),
             lambda: ref.flash_quant_fwd_ref(k, v), fa.FWD_I8_FIELDS,
             2 * k.numel(), 4 * 2 * k.numel()),
            ("flash_bwd_quant_int8", lambda: fa.quantize_bwd(qs, k, v, do),
             lambda: ref.flash_quant_bwd_ref(qs, k, v, do), fa.I8_FIELDS,
             2 * q.numel() + 2 * k.numel(), 4 * (4 * q.numel() + 3 * q.numel()))):
        got, want = call(), plain()
        differ = [n for n in fields if not torch.equal(got[n], want[n])]
        if differ:
            raise AssertionError(f"{name} at {label}: {differ} differ from the plain version")
        moved = n_in * 4 + sum(t.numel() * t.element_size() for t in got.values())
        b = bound(moved, n_ops)
        dev = device_us(call, name)
        out[name] = dict(ms=cuda_ms(call), device_us=dev, plain_ms=cuda_ms(plain, n=5, warmup=1),
                         bound_ms=b[0], bound_by=b[1], share_of_bound=b[0] * 1e3 / dev,
                         mb_moved=moved / 1e6, max_abs_err=0.0)
        del got, want
        log(f"[kernels] {name} at DP 256, {label} (q, do ({B}, {S}, {H}, {d}), k, v ({B}, {S}, "
            f"{K}, {d}) f32): bytes and scales equal to the plain version's; "
            f"{out[name]['ms']:.4f} ms a call, {dev:.2f} us on the card (bound "
            f"{b[0] * 1e3:.2f} us by {b[1]}, {b[0] * 1e3 / dev:.1%}; {moved / 1e6:.1f} MB "
            f"moved); plain {out[name]['plain_ms']:.4f} ms")
    del q, k, v, do, qs
    torch.cuda.empty_cache()
    return out


def int8_forward_timing(fa, ref, quant, qs, k, v, i8, sdpa_fwd_ms):
    """The int8 forward at the train shape: the forward pre-pass (its call,
    its device time, its plain version's, its bytes bound), B5 on its bytes
    (device us from i8, which counts no pre-pass) and the whole as
    flash_fwd runs it (pre-pass + B5), each beside its bound and its share
    of it, with SDPA's bf16 forward and the bf16 B5 on the card for scale.
    Returns the forward pre-pass's kernel row."""
    got, want = fa.quantize_fwd(k, v), ref.flash_quant_fwd_ref(k, v)
    err = max(float((got[n].float() - want[n].float()).abs().max()) for n in fa.FWD_I8_FIELDS)
    out_bytes = sum(t.numel() * t.element_size() for t in got.values())
    in_bytes = 2 * k.numel() * k.element_size()
    # ~4 operations (abs-max, divide, round, clamp) a value of k and of v
    pre_bound = bound(in_bytes + out_bytes, 4 * 2 * k.numel())
    pre_ms = cuda_ms(lambda: fa.quantize_fwd(k, v))
    pre_dev = device_us(lambda: fa.quantize_fwd(k, v), "flash_fwd_quant_int8")
    pre_plain = cuda_ms(lambda: ref.flash_quant_fwd_ref(k, v), n=20)
    kw = dict(causal=True, policy=quant.QuantPolicy("int8"))
    fwd = lambda: fa.flash_fwd(qs, k, v, **kw)   # noqa: E731
    fwd_dev, fwd_launches = library_device_us(fwd)
    bf16_dev = device_us(lambda: fa.flash_fwd(qs, k, v, causal=True,
                                              policy=quant.QuantPolicy("bf16")), "flash_fwd")
    qb, kb, vb = (t.transpose(1, 2).bfloat16().contiguous() for t in (qs, k, v))
    sdpa_dev, _ = library_device_us(lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, kb, vb, is_causal=True))
    B, S, H, d = qs.shape
    # B5 alone: q read, the pre-pass's bytes read, o and lse written
    b5_bound = bound(2 * qs.numel() * qs.element_size() + out_bytes + B * H * S * 4,
                     4 * d * (B * H * S * (S + 1) // 2), INT8_TC_OP_PER_S)
    fn_bound = i8["bound"]["flash_fwd"]
    b5 = i8["device_us"]["flash_fwd"]
    del got, want
    log(f"[kernels] int8 forward at (8, 512, 16, 64) causal f32: forward pre-pass "
        f"{pre_ms:.4f} ms a call, {pre_dev:.2f} us on the card (bound {pre_bound[0] * 1e3:.2f} "
        f"us by {pre_bound[1]}, {pre_bound[0] * 1e3 / pre_dev:.1%} of it; plain "
        f"{pre_plain:.4f} ms; {(in_bytes + out_bytes) / 1e6:.1f} MB moved; target <= 20 us); "
        f"B5-int8 {b5:.2f} us on the card (bound on its own bytes {b5_bound[0] * 1e3:.2f} us, "
        f"{b5_bound[0] * 1e3 / b5:.1%}; the function's {fn_bound[0] * 1e3:.2f}, "
        f"{fn_bound[0] * 1e3 / b5:.1%}; target <= 70); the whole (flash_fwd: pre-pass + B5) "
        f"{i8['ms']['flash_fwd']:.4f} ms a call, {fwd_dev:.2f} us on the card in "
        f"{fwd_launches:.0f} launches (the function's bound {fn_bound[0] * 1e3:.2f} us by "
        f"{fn_bound[1]}, {fn_bound[0] * 1e3 / fwd_dev:.1%}; target <= 90); for scale (not "
        f"int8): SDPA's bf16 forward {sdpa_dev:.2f} us, {sdpa_fwd_ms:.4f} ms a call; the bf16 B5 "
        f"{bf16_dev:.2f} us on the card; targets printed, not held")
    i8["fwd_whole"] = dict(device_us=fwd_dev, launches=fwd_launches, bound_ms=fn_bound[0],
                           bound_by=fn_bound[1], b5_own_bound_ms=b5_bound[0],
                           sdpa_bf16_forward_device_us=sdpa_dev, bf16_b5_device_us=bf16_dev)
    return dict(
        name="flash_fwd_quant_int8", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/quant/core.py:31 quantize_int8 inside kernel_dot (:63-67), "
                 "hoisted out of B5's tile loop (src/repro/kernels/flash_attention.py:77); "
                 "no TPU kernel of its own",
        max_abs_err=err, ms=pre_ms, device_us=pre_dev, plain_ms=pre_plain,
        bound_ms=pre_bound[0], bound_by=pre_bound[1], library_ms=None,
        library="none: no PyTorch call quantizes per column over a tile",
        share_of_bound=pre_bound[0] * 1e3 / pre_dev,
        shape="k, v (8, 512, 16, 64) f32 -> k8, vT8 and their scales",
        int8_forward=i8["fwd_whole"])


def int8_backward_timing(fa, ref, quant, qs, k, v, do, errs, i8, sdpa):
    """The int8 backward at the train shape: the pre-pass (its call, its
    device time, its plain version's, its bytes bound), B6 and B7 on its
    bytes (device us from i8, which counts neither's pre-pass), and the
    whole as ops.attention runs it (one pre-pass, B6, B7), beside SDPA's
    bf16 backward on the card for scale.  Returns the pre-pass's kernel
    row."""
    pol = quant.QuantPolicy("int8")
    kw = dict(causal=True, policy=pol)
    o, lse = fa.flash_fwd(qs, k, v, **kw)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    got, want = fa.quantize_bwd(qs, k, v, do), ref.flash_quant_bwd_ref(qs, k, v, do)
    err = max(float((got[n].float() - want[n].float()).abs().max()) for n in fa.I8_FIELDS)
    out_bytes = sum(t.numel() * t.element_size() for t in got.values())
    in_bytes = 4 * qs.numel() * qs.element_size()
    # f32 work: ~4 operations (abs-max, divide, round, clamp) a value and
    # quantization, per row for q, do, k, v and per column for q, do, k
    pre_bound = bound(in_bytes + out_bytes, 4 * (4 * qs.numel() + 3 * qs.numel()))
    pre_ms = cuda_ms(lambda: fa.quantize_bwd(qs, k, v, do))
    pre_dev = device_us(lambda: fa.quantize_bwd(qs, k, v, do), "flash_bwd_quant_int8")
    pre_plain = cuda_ms(lambda: ref.flash_quant_bwd_ref(qs, k, v, do), n=20)
    del got, want
    bwd = lambda: fa.flash_bwd(qs, k, v, do, lse, delta, **kw)   # noqa: E731
    bwd_ms = cuda_ms(bwd)
    bwd_dev, bwd_launches = library_device_us(bwd)
    B, S, H, d = qs.shape
    pairs = B * H * S * (S + 1) // 2
    io, rows = qs.numel() * 4, B * H * S * 4
    bwd_bound = bound(4 * io + 2 * rows + 3 * io, 14 * d * pairs, INT8_TC_OP_PER_S)
    qb, kb, vb, dob, ob = sdpa
    sdpa_dev, _ = library_device_us(
        lambda: torch.autograd.grad(ob, (qb, kb, vb), dob, retain_graph=True))
    dev = i8["device_us"]
    log(f"[kernels] int8 backward at (8, 512, 16, 64) causal f32: pre-pass {pre_ms:.4f} ms a "
        f"call, {pre_dev:.2f} us on the card (bound {pre_bound[0] * 1e3:.2f} us by "
        f"{pre_bound[1]}, {pre_bound[0] * 1e3 / pre_dev:.1%} of it; plain {pre_plain:.4f} ms; "
        f"{(in_bytes + out_bytes) / 1e6:.1f} MB moved; target <= 40 us); B6-int8 "
        f"{dev['flash_bwd_dq']:.2f} us on the card (bound "
        f"{i8['bound']['flash_bwd_dq'][0] * 1e3:.2f}, "
        f"{i8['bound']['flash_bwd_dq'][0] * 1e3 / dev['flash_bwd_dq']:.1%}; target <= 100); "
        f"B7-int8 {dev['flash_bwd_dkv']:.2f} us (bound "
        f"{i8['bound']['flash_bwd_dkv'][0] * 1e3:.2f}, "
        f"{i8['bound']['flash_bwd_dkv'][0] * 1e3 / dev['flash_bwd_dkv']:.1%}; target <= 120); "
        f"the whole (flash_bwd: pre-pass + B6 + B7) {bwd_ms:.4f} ms a call, {bwd_dev:.2f} us on "
        f"the card in {bwd_launches:.0f} launches (bound {bwd_bound[0] * 1e3:.2f} us by "
        f"{bwd_bound[1]}, {bwd_bound[0] * 1e3 / bwd_dev:.1%}; target <= 260); SDPA's bf16 "
        f"backward {sdpa_dev:.2f} us on the card, for scale (not int8); targets printed, "
        f"not held")
    return dict(
        name="flash_bwd_quant_int8", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/quant/core.py:31 quantize_int8 inside kernel_dot (:63-67), "
                 "hoisted out of B6/B7's tile loops (src/repro/kernels/flash_attention.py"
                 ":158, :194); no TPU kernel of its own",
        max_abs_err=err, ms=pre_ms, device_us=pre_dev, plain_ms=pre_plain,
        bound_ms=pre_bound[0], bound_by=pre_bound[1], library_ms=None,
        library="none: no PyTorch call quantizes along both axes",
        share_of_bound=pre_bound[0] * 1e3 / pre_dev,
        shape="q, k, v, do (8, 512, 16, 64) f32 -> 7 int8 tensors and their scales",
        int8_backward=dict(ms=bwd_ms, device_us=bwd_dev, launches=bwd_launches,
                           bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
                           sdpa_bf16_backward_device_us=sdpa_dev),
        bit_equal_at_train_shape=errs["train shape"]["int8"]["bit_equal"])


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def make_recording_model(Model):
    class RecordingModel(Model):
        """Keeps, for every forward the engine runs, its mode and width, the
        top-2 logits of the rows it samples from (a prefill's last prompt
        row, a chunk's last real row: the one row the engine reads out),
        and the full rows and the slots' positions of the first 8
        single-token decodes.  Forwards
        without positions (the tie oracle's) are not recorded, but for the
        dense-loop driver's prefill (its last row: every prompt at full
        width).  With ``keep_all`` set, every recorded forward's sampled
        rows are kept too (``all_rows``)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = []
            self.n_decode = 0
            self.keep_all = False
            self.all_rows = []

        def forward(self, params, tokens, positions=None, mode="train", **kw):
            logits, cache = super().forward(params, tokens, positions=positions,
                                            mode=mode, **kw)
            if positions is None and mode != "prefill":
                return logits, cache
            T = tokens.shape[1]
            if positions is None:
                # the dense-loop driver's prefill: it samples the last row
                rows = logits[:, -1]
                active = torch.ones(1, dtype=torch.bool, device=rows.device)
            elif kw.get("readout") is not None:
                # the engine read out only the row it samples from (a
                # prefill's last prompt row, a chunk's last real row)
                rows = logits[:, -1]
                active = torch.ones(1, dtype=torch.bool, device=rows.device)
            elif mode == "prefill":
                plen = int((positions[0] < positions.shape[1]).sum())
                rows = logits[:, plen - 1]
                active = torch.ones(1, dtype=torch.bool, device=rows.device)
            elif T > 1:
                last = int((positions[0] >= 0).sum()) - 1
                rows = logits[:, max(last, 0)]
                active = torch.ones(1, dtype=torch.bool, device=rows.device)
            else:
                rows = logits[:, 0]
                active = positions[:, 0] >= 0
            top2 = rows.float().topk(2, dim=-1)
            single = mode == "decode" and T == 1
            keep = single and self.n_decode < 8
            self.n_decode += single
            self.calls.append(dict(mode=mode, T=T, top2=top2.values,
                                   arg=top2.indices[:, 0], active=active,
                                   rows=rows.clone() if keep else None,
                                   pos=positions[:, 0].tolist() if keep else None))
            if self.keep_all:
                self.all_rows.append(rows.clone())
            return logits, cache

    return RecordingModel


def compare_calls(what, kern, plain, out_k, out_r, logit_tol=SERVE_LOGIT_TOL):
    """Two serves of one schedule, with the kernels and through the plain
    versions: the same steps and forwards, the same greedy token at every
    sampled row unless the plain top-2 gap there is below TIE_GAP (after
    which that request may differ), and the first 8 decode steps' logits
    within atol = rtol = ``logit_tol`` (None: measured, not held).  Returns
    (tie_at, worst, scale)."""
    if out_k["steps"] != out_r["steps"] or len(kern.calls) != len(plain.calls):
        raise AssertionError(f"{what}: steps differ: {out_k['steps']} vs "
                             f"{out_r['steps']}")
    tie_at = None
    for i, (ck, cr) in enumerate(zip(kern.calls, plain.calls)):
        differ = (ck["arg"] != cr["arg"]) & cr["active"]
        if bool(differ.any()):
            j = int(differ.nonzero()[0, 0])
            gap = float(cr["top2"][j, 0] - cr["top2"][j, 1])
            if gap >= TIE_GAP:
                raise AssertionError(
                    f"{what}: greedy token differs at forward {i} ({cr['mode']}, "
                    f"T={cr['T']}) row {j}, plain top-2 gap {gap}")
            log(f"[{what}] tie: forward {i} ({cr['mode']}) row {j}, plain top-2 gap "
                f"{gap:.3g} < {TIE_GAP}; later tokens of that request may differ")
            tie_at = i
            break
    if tie_at is None and not torch.equal(out_k["tokens"], out_r["tokens"]):
        raise AssertionError(f"{what}: greedy tokens differ with and without the kernels")
    worst = excess = scale = 0.0
    for ck, cr in zip(kern.calls[:tie_at], plain.calls[:tie_at]):
        if ck["rows"] is not None:
            diff = (ck["rows"] - cr["rows"]).abs()
            worst = max(worst, diff.max().item())
            scale = max(scale, cr["rows"].abs().max().item())
            # allclose: |a - b| <= atol + rtol * |b|
            if logit_tol is not None:
                excess = max(excess, (diff - logit_tol * (1 + cr["rows"].abs()))
                             .max().item())
    if not excess <= 0:
        raise AssertionError(f"{what}: decode logits differ by {worst} "
                             f"(|logit| <= {scale})")
    return tie_at, worst, scale


def compare_requests(what, kern, plain, out_k, out_r, logit_tol, parted):
    """compare_calls request by request, for calls that carry each row's
    request (``req``, -1 for an idle slot; make_routing_recorder): a
    request's rows are left out from the forward where it parted
    (``parted``, {request: forward}, mx_routing's: an MoE routing near-tie,
    or a sampled token that differs), the other requests' rows compared
    through the whole serve.  Every sampled row still compared gives the
    same greedy token unless the plain top-2 gap there is below TIE_GAP
    (mx_routing has parted that request from the next forward on); the
    first 8 decode steps' logits of the served rows still compared lie
    within atol = rtol = ``logit_tol`` (None: measured, not held); the
    requests that never parted end with the same tokens.  Returns (the
    first forward where a request parted or None, worst, scale)."""
    if out_k["steps"] != out_r["steps"] or len(kern.calls) != len(plain.calls):
        raise AssertionError(f"{what}: steps differ: {out_k['steps']} vs "
                             f"{out_r['steps']}")
    worst = excess = scale = 0.0
    for i, (ck, cr) in enumerate(zip(kern.calls, plain.calls)):
        live = torch.tensor([r >= 0 and parted.get(r, i + 1) > i for r in cr["req"]],
                            device=cr["arg"].device)
        differ = (ck["arg"] != cr["arg"]) & cr["active"] & live
        for j in differ.nonzero()[:, 0].tolist():
            gap = float(cr["top2"][j, 0] - cr["top2"][j, 1])
            if gap >= TIE_GAP:
                raise AssertionError(
                    f"{what}: greedy token differs at forward {i} ({cr['mode']}, "
                    f"T={cr['T']}) row {j} (request {cr['req'][j]}), plain top-2 gap {gap}")
            log(f"[{what}] tie: forward {i} ({cr['mode']}) row {j} (request "
                f"{cr['req'][j]}), plain top-2 gap {gap:.3g} < {TIE_GAP}; that request's "
                f"later rows are left out")
        if ck["rows"] is not None and bool(live.any()):
            diff = (ck["rows"] - cr["rows"]).abs()[live]
            worst = max(worst, diff.max().item())
            scale = max(scale, cr["rows"][live].abs().max().item())
            if logit_tol is not None:
                excess = max(excess, (diff - logit_tol * (1 + cr["rows"][live].abs()))
                             .max().item())
    if not excess <= 0:
        raise AssertionError(f"{what}: decode logits differ by {worst} "
                             f"(|logit| <= {scale})")
    same = [r for r in range(len(out_r["tokens"])) if r not in parted]
    if not torch.equal(out_k["tokens"][same], out_r["tokens"][same]):
        raise AssertionError(f"{what}: greedy tokens of requests {same} differ with and "
                             f"without the kernels")
    return (min(parted.values()) if parted else None), worst, scale


def serve_phase(cfg_f32, Model, Engine, EngineConfig, ops):
    R, S, Pmax, Gmax, P = 8, 4, 256, 64, 16
    rng = np.random.default_rng(0)
    lens = rng.integers(64, Pmax + 1, R)
    prompts = rng.integers(0, cfg_f32.vocab_size, (R, Pmax))
    ecfg = EngineConfig(n_slots=S, page_size=P, max_prompt_len=Pmax, max_gen_len=Gmax)
    Rec = make_recording_model(Model)

    kern = Rec(cfg_f32, device="cuda", impl="auto")
    plain = Rec(cfg_f32, device="cuda", impl="ref")
    params = kern.init(seed=0)
    n_params = sum(p.numel() for p in params.values())
    log(f"[serve] {cfg_f32.name}: {cfg_f32.n_layers} layers, d_model {cfg_f32.d_model}, "
        f"{cfg_f32.n_heads}/{cfg_f32.n_kv_heads} heads, vocab {cfg_f32.vocab_size}, "
        f"{n_params / 1e6:.1f}M params; {R} requests, prompt lens {lens.tolist()}, "
        f"{Gmax} tokens each, {S} slots, page {P}")

    # warm-up (cuBLAS handles, allocator) outside the counted run
    Engine(kern, EngineConfig(n_slots=2, page_size=P, max_prompt_len=Pmax,
                              max_gen_len=2)).serve(params, prompts[:1], lens[:1])
    kern.calls.clear()
    kern.n_decode = 0

    engine = Engine(kern, ecfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_k = engine.serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = out_k["steps"]
    # one decode attention per layer per step; two norms per layer plus the
    # final norm per forward (a decode step or an admission's prefill); no
    # backward and no loss
    L = cfg_f32.n_layers
    want = {"flash_decode": L * steps, "flash_decode_multi": 0,
            "flash_decode_int8": 0, "flash_decode_multi_int8": 0,
            "rmsnorm": (2 * L + 1) * (steps + R), "rmsnorm_bwd": 0, "ce_fwd": 0, "ce_bwd": 0, "flash_fwd": 0,
            "rmsnorm_grouped": 0, "rmsnorm_bwd_grouped": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_fwd_int8": 0, "flash_bwd_dq_int8": 0, "flash_bwd_dkv_int8": 0,
                "flash_bwd_quant_int8": 0, "flash_fwd_quant_int8": 0}
    log(f"[serve] kernels: {steps} steps, launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    t0 = time.perf_counter()
    out_r = Engine(plain, ecfg).serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    n_tok = int(out_k["lengths"].sum())
    log(f"[serve] kernels: {n_tok} tokens in {wall_k:.3f} s ({n_tok / wall_k:.1f} tok/s); "
        f"plain: {int(out_r['lengths'].sum())} tokens in {wall_r:.3f} s "
        f"({int(out_r['lengths'].sum()) / wall_r:.1f} tok/s)")

    tie_at, worst, scale = compare_calls("serve", kern, plain, out_k, out_r)
    log(f"[serve] greedy tokens identical: {tie_at is None}; steps identical; "
        f"first 8 decode steps' logits max abs diff {worst:.3g} at |logit| <= "
        f"{scale:.3g} (atol = rtol = {SERVE_LOGIT_TOL})")

    # bfloat16 activations and pools, the same float32 master weights
    bf = Rec(cfg_f32.replace(dtype="bfloat16"), device="cuda", impl="auto")
    t0 = time.perf_counter()
    out_b = Engine(bf, ecfg).serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    if not all(bool(torch.isfinite(c["top2"]).all()) for c in bf.calls):
        raise AssertionError("bf16 serve produced non-finite logits")
    agree = float((out_b["tokens"] == out_k["tokens"]).float().mean())
    log(f"[serve] bf16: {int(out_b['lengths'].sum())} tokens in {wall_b:.3f} s, "
        f"finite logits, {agree:.1%} of tokens equal to the f32 run")
    return launches, dict(steps=steps, tokens=n_tok, wall_s=wall_k,
                          plain_wall_s=wall_r, bf16_wall_s=wall_b,
                          bf16_token_agreement=agree)


def shared_prefix_workload(V, R, Pmax, seed):
    """R requests, each one of 4 system prompts of 96-160 tokens plus a
    unique suffix of 16-96 tokens, drawn from a seeded generator; all
    present at t = 0."""
    rng = np.random.default_rng(seed)
    systems = [rng.integers(0, V, int(rng.integers(96, 161))) for _ in range(4)]
    prompts = np.zeros((R, Pmax), np.int64)
    lens = np.zeros(R, np.int64)
    for r in range(R):
        p = np.concatenate([systems[int(rng.integers(0, 4))],
                            rng.integers(0, V, int(rng.integers(16, 97)))])
        prompts[r, :len(p)] = p
        lens[r] = len(p)
    return prompts, lens


def greedy_agree(what, oracle, params, prompts, lens, got, want):
    """Greedy tokens of two serves equal request by request, or the first
    difference in a request is a near-tie: there, a plain full-sequence
    forward over the prompt and ``want``'s tokens so far (the oracle, with
    no engine and no cache) has a top-2 gap below TIE_GAP.  Returns the
    number of requests that diverged at a tie."""
    ties = 0
    for r in range(len(lens)):
        la, lb = int(got["lengths"][r]), int(want["lengths"][r])
        a, b = got["tokens"][r, :la], want["tokens"][r, :lb]
        n = min(la, lb)
        diff = (a[:n] != b[:n]).nonzero()
        if len(diff) == 0:
            if la != lb:
                raise AssertionError(f"{what}: request {r} lengths {la} != {lb}")
            continue
        j = int(diff[0, 0])
        seq = np.concatenate([prompts[r, :lens[r]], b[:j].numpy()])
        with torch.no_grad():
            logits, _ = oracle.forward(params, torch.as_tensor(seq[None], device="cuda"),
                                       readout=torch.tensor([len(seq) - 1], device="cuda"))
        top2 = logits[0, -1].float().topk(2).values
        gap = float(top2[0] - top2[1])
        if gap >= TIE_GAP:
            raise AssertionError(f"{what}: request {r} differs at token {j} "
                                 f"({int(a[j])} vs {int(b[j])}), oracle top-2 gap {gap}")
        log(f"[{what}] tie: request {r} token {j}, oracle top-2 gap {gap:.3g} < "
            f"{TIE_GAP}; later tokens of that request may differ")
        ties += 1
    return ties


def dynamic_serve_phase(cfg, Model, Engine, DynamicEngine, EngineConfig, ops):
    """smollm-135m at full width through DynamicEngine: 4 slots, page 16,
    prompts up to 256, 64 tokens each, chunks of 64, prefix cache on, 16
    requests over 4 shared system prompts, all present at t = 0 (no
    arrivals: the schedule, and so the step count, does not depend on host
    speed).  Checks (a)-(e) of the module docstring."""
    R, S, Pmax, Gmax, P, CH = 16, 4, 256, 64, 16, 64
    prompts, lens = shared_prefix_workload(cfg.vocab_size, R, Pmax, seed=2)
    kw = dict(n_slots=S, page_size=P, max_prompt_len=Pmax, max_gen_len=Gmax)
    ecfg = EngineConfig(prefill_chunk=CH, prefix_cache=True, **kw)
    Rec = make_recording_model(Model)
    kern = Rec(cfg, device="cuda", impl="auto")
    plain = Rec(cfg, device="cuda", impl="ref")
    params = kern.init(seed=0)
    log(f"[serve_dynamic] {R} requests, prompt lens {lens.tolist()}, {Gmax} tokens "
        f"each, {S} slots, page {P}, prefill_chunk {CH}, prefix cache on")

    # warm-up outside the counted run
    DynamicEngine(kern, EngineConfig(prefill_chunk=CH, prefix_cache=True, n_slots=2,
                                     page_size=P, max_prompt_len=Pmax, max_gen_len=2)
                  ).serve(params, prompts[:1], lens[:1])
    kern.calls.clear()
    kern.n_decode = 0

    engine = DynamicEngine(kern, ecfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_k = engine.serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = ops.launch_counts()

    # (e) exact launch counts, from forwards counted apart from the engine
    L = cfg.n_layers
    n_chunk = sum(c["mode"] == "decode" and c["T"] > 1 for c in kern.calls)
    n_dec = sum(c["mode"] == "decode" and c["T"] == 1 for c in kern.calls)
    n_prefill = sum(c["mode"] == "prefill" for c in kern.calls)
    cached = out_k["prefill_cached"]
    # shared spans are whole chunks (floored to prefill_chunk), so request r
    # runs ceil(plen / CH) - cached_r / CH chunk forwards
    want_chunks = int(sum(-(-int(n) // CH) for n in lens)) - cached // CH
    if cached % CH or n_chunk != want_chunks or n_prefill:
        raise AssertionError(
            f"chunk forwards {n_chunk} (prefill {n_prefill}) against the schedule "
            f"{want_chunks} from prefill_cached {cached}")
    if any(c["T"] != CH for c in kern.calls if c["mode"] == "decode" and c["T"] > 1):
        raise AssertionError("a chunk forward is not prefill_chunk wide")
    want = {"flash_decode": L * n_dec, "flash_decode_multi": L * n_chunk,
            "flash_decode_int8": 0, "flash_decode_multi_int8": 0,
            "rmsnorm": (2 * L + 1) * (n_chunk + n_dec), "rmsnorm_bwd": 0,
            "rmsnorm_grouped": 0, "rmsnorm_bwd_grouped": 0,
            "ce_fwd": 0, "ce_bwd": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0,
            "flash_fwd_int8": 0, "flash_bwd_dq_int8": 0, "flash_bwd_dkv_int8": 0,
                "flash_bwd_quant_int8": 0, "flash_fwd_quant_int8": 0}
    log(f"[serve_dynamic] kernels: {out_k['steps']} steps, {n_chunk} chunk forwards, "
        f"{n_dec} decode steps; launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    # (a) the same serve through the plain versions
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_r = DynamicEngine(plain, ecfg).serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    if set(ops.launch_counts().values()) != {0}:
        raise AssertionError(f"the plain serve launched kernels: {ops.launch_counts()}")
    tie_at, worst, scale = compare_calls("serve_dynamic", kern, plain, out_k, out_r)
    n_tok = int(out_k["lengths"].sum())
    log(f"[serve_dynamic] (a) kernels: {n_tok} tokens in {wall_k:.3f} s "
        f"({n_tok / wall_k:.1f} tok/s); plain: {int(out_r['lengths'].sum())} tokens in "
        f"{wall_r:.3f} s ({int(out_r['lengths'].sum()) / wall_r:.1f} tok/s); greedy "
        f"tokens identical: {tie_at is None}; steps identical ({out_k['steps']}); first 8 "
        f"decode steps' logits max abs diff {worst:.3g} at |logit| <= {scale:.3g}")

    # (b) the static engine on the same requests
    t0 = time.perf_counter()
    out_s = Engine(kern, EngineConfig(**kw)).serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ties_b = greedy_agree("serve_dynamic (b)", plain, params, prompts, lens, out_k, out_s)
    log(f"[serve_dynamic] (b) static engine: {int(out_s['lengths'].sum())} tokens in "
        f"{wall_s:.3f} s ({int(out_s['lengths'].sum()) / wall_s:.1f} tok/s), "
        f"{out_s['steps']} steps; greedy tokens equal, {ties_b} requests past a tie")

    # (c) prefix cache off
    t0 = time.perf_counter()
    out_c = DynamicEngine(kern, EngineConfig(prefill_chunk=CH, **kw)).serve(
        params, prompts, lens)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    ties_c = greedy_agree("serve_dynamic (c)", plain, params, prompts, lens, out_k, out_c)
    if not (cached > 0 and out_c["prefill_cached"] == 0):
        raise AssertionError(f"prefill_cached {cached} with the cache, "
                             f"{out_c['prefill_cached']} without")
    log(f"[serve_dynamic] (c) prefix cache off: {int(out_c['lengths'].sum())} tokens in "
        f"{wall_c:.3f} s ({int(out_c['lengths'].sum()) / wall_c:.1f} tok/s), "
        f"{out_c['steps']} steps; greedy tokens equal, {ties_c} requests past a tie; "
        f"with the cache {cached}/{out_k['prefill_total']} prompt tokens from shared pages")

    # (d) the same requests again on the same engine: a warm cache
    t0 = time.perf_counter()
    out_w = engine.serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    ties_d = greedy_agree("serve_dynamic (d)", plain, params, prompts, lens, out_k, out_w)
    if not out_w["prefill_cached"] > cached:
        raise AssertionError(f"warm serve shared {out_w['prefill_cached']} prompt "
                             f"tokens, the cold one {cached}")
    engine.blocks.check_invariants()
    log(f"[serve_dynamic] (d) warm cache: {out_w['prefill_cached']}/"
        f"{out_w['prefill_total']} prompt tokens from shared pages (cold {cached}); "
        f"{int(out_w['lengths'].sum())} tokens in {wall_w:.3f} s "
        f"({int(out_w['lengths'].sum()) / wall_w:.1f} tok/s), {out_w['steps']} steps; "
        f"greedy tokens equal, "
        f"{ties_d} requests past a tie")
    return launches, out_k["tokens"], dict(
        requests=R, steps=out_k["steps"], chunk_forwards=n_chunk, decode_steps=n_dec,
        tokens=n_tok, wall_s=wall_k, tok_per_s=n_tok / wall_k, plain_wall_s=wall_r,
        plain_tok_per_s=int(out_r["lengths"].sum()) / wall_r,
        prefill_cached=cached, prefill_total=out_k["prefill_total"],
        warm_prefill_cached=out_w["prefill_cached"], warm_wall_s=wall_w,
        warm_steps=out_w["steps"],
        static_wall_s=wall_s, static_steps=out_s["steps"], no_cache_wall_s=wall_c,
        no_cache_steps=out_c["steps"], ties=dict(b=ties_b, c=ties_c, d=ties_d),
    )


def pool_diff(a, b):
    """Two int8 pool trees of one schedule: positions must be equal; returns
    how many int8 bytes differ and by how much, and the scales' largest
    relative difference."""
    out = dict(bytes=0, bytes_differ=0, max_byte_diff=0, scale_rel=0.0)
    for key, pa in a["groups"].items():
        pa, pb = pa["attn"], b["groups"][key]["attn"]
        if not torch.equal(pa["pos"], pb["pos"]):
            raise AssertionError(f"int8 pools {key}: positions differ")
        for n in ("k", "v"):
            d = (pa[n].int() - pb[n].int()).abs()
            out["bytes"] += d.numel()
            out["bytes_differ"] += int(torch.count_nonzero(d))
            out["max_byte_diff"] = max(out["max_byte_diff"], int(d.max()))
            sa, sb = pa[n + "_scale"], pb[n + "_scale"]
            rel = ((sa - sb).abs() / sb.abs().clamp(min=1e-30)).max().item()
            out["scale_rel"] = max(out["scale_rel"], rel)
    return out


def serve_int8_phase(cfg, Model, Engine, DynamicEngine, EngineConfig, ops, f32_dyn):
    """smollm-135m at full width with int8 paged KV pools (``--kv-dtype
    int8``): through DynamicEngine on the serve_dynamic workload (16
    requests over 4 shared system prompts, chunks of 64, prefix cache on)
    and through the static engine on 8 of its requests.  (a) tokens and
    steps equal with the kernels and through the plain versions, on both
    engines (the serve phase's near-tie rule); (b) the dynamic engine's
    tokens equal with the prefix cache off; (c) a warm second serve shares
    more; (d) exact launch counts: B8 int8 and B9 int8 one a layer per
    decode step and chunk forward, B1 2 L + 1 per forward, no f32/bf16
    B8/B9 and no B2-B7.
    Prints tok/s, the pools' MiB against f32 pools, and the top-1 agreement
    with the f32 dynamic engine on the same requests (``f32_dyn``: its
    tokens and tok/s in this run), which is printed, not held: at full width
    with random weights the f32 top-2 gaps are small.  The static engine's
    int8 tokens need not equal the dynamic engine's: a one-shot prefill
    attends in f32, a chunk forward over the int8 pages it has just
    written."""
    from repro_torch.serving.kv_cache import pool_bytes

    R, S, Pmax, Gmax, P, CH, R_STATIC = 16, 4, 256, 64, 16, 64, 8
    cfg8 = cfg.replace(kv_dtype="int8")
    prompts, lens = shared_prefix_workload(cfg.vocab_size, R, Pmax, seed=2)
    kw = dict(n_slots=S, page_size=P, max_prompt_len=Pmax, max_gen_len=Gmax)
    ecfg = EngineConfig(prefill_chunk=CH, prefix_cache=True, **kw)
    Rec = make_recording_model(Model)
    kern = Rec(cfg8, device="cuda", impl="auto")
    plain = Rec(cfg8, device="cuda", impl="ref")
    params = kern.init(seed=0)
    L = cfg.n_layers

    def expect(n_dec, n_chunk, n_fwd):
        return {"rmsnorm": (2 * L + 1) * n_fwd, "rmsnorm_bwd": 0, "ce_fwd": 0,
                "rmsnorm_grouped": 0, "rmsnorm_bwd_grouped": 0,
                "ce_bwd": 0, "flash_decode": 0, "flash_decode_multi": 0,
                "flash_decode_int8": L * n_dec, "flash_decode_multi_int8": L * n_chunk,
                "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "flash_fwd_int8": 0, "flash_bwd_dq_int8": 0, "flash_bwd_dkv_int8": 0,
                "flash_bwd_quant_int8": 0, "flash_fwd_quant_int8": 0}

    # warm-up outside the counted runs
    DynamicEngine(kern, EngineConfig(prefill_chunk=CH, prefix_cache=True, n_slots=2,
                                     page_size=P, max_prompt_len=Pmax, max_gen_len=2)
                  ).serve(params, prompts[:1], lens[:1])
    kern.calls.clear()
    kern.n_decode = 0

    engine = DynamicEngine(kern, ecfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_k = engine.serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = ops.launch_counts()
    n_chunk = sum(c["mode"] == "decode" and c["T"] > 1 for c in kern.calls)
    n_dec = sum(c["mode"] == "decode" and c["T"] == 1 for c in kern.calls)
    n_prefill = sum(c["mode"] == "prefill" for c in kern.calls)
    want = expect(n_dec, n_chunk, n_chunk + n_dec)
    log(f"[serve_int8] dynamic, kernels: {out_k['steps']} steps, {n_chunk} chunk "
        f"forwards, {n_dec} decode steps; launches {launches}, expected {want}")
    if launches != want or n_prefill:
        raise AssertionError(f"int8 dynamic launch counts {launches} != {want} "
                             f"({n_prefill} one-shot prefills)")

    # (a) the same serve through the plain versions.  The two paths' f32 k/v
    # differ by ulps (B1 sums in another order than its plain version), so
    # a value within an ulp of a half step rounds to the neighbouring byte
    # on one side: the pools' positions must be equal, their bytes differ
    # by at most one step where they differ, and the logits, which such a
    # byte moves by up to ~1e-1, are measured, not held at SERVE_LOGIT_TOL
    # (the kernels themselves are held at 2e-5 on the same bytes above)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    engine_r = DynamicEngine(plain, ecfg)
    out_r = engine_r.serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    if set(ops.launch_counts().values()) != {0}:
        raise AssertionError(f"the plain serve launched kernels: {ops.launch_counts()}")
    tie_at, worst, scale = compare_calls("serve_int8", kern, plain, out_k, out_r,
                                         logit_tol=None)
    pools = pool_diff(engine._pools, engine_r._pools)
    log(f"[serve_int8] pools with the kernels against through the plain versions: "
        f"positions equal; {pools['bytes_differ']} of {pools['bytes']} int8 bytes "
        f"differ ({pools['bytes_differ'] / pools['bytes']:.2e}), by at most "
        f"{pools['max_byte_diff']} steps; scales max rel diff {pools['scale_rel']:.3g}")
    n_tok = int(out_k["lengths"].sum())
    cached = out_k["prefill_cached"]
    log(f"[serve_int8] (a) dynamic, kernels: {n_tok} tokens in {wall_k:.3f} s "
        f"({n_tok / wall_k:.1f} tok/s); plain: {int(out_r['lengths'].sum())} tokens in "
        f"{wall_r:.3f} s ({int(out_r['lengths'].sum()) / wall_r:.1f} tok/s); greedy "
        f"tokens identical: {tie_at is None}; steps identical ({out_k['steps']}); first 8 "
        f"decode steps' logits max abs diff {worst:.3g} at |logit| <= {scale:.3g}; "
        f"{cached}/{out_k['prefill_total']} prompt tokens from shared pages")

    # (b) prefix cache off
    t0 = time.perf_counter()
    out_c = DynamicEngine(kern, EngineConfig(prefill_chunk=CH, **kw)).serve(
        params, prompts, lens)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    ties_b = greedy_agree("serve_int8 (b)", plain, params, prompts, lens, out_k, out_c)
    if not (cached > 0 and out_c["prefill_cached"] == 0):
        raise AssertionError(f"prefill_cached {cached} with the cache, "
                             f"{out_c['prefill_cached']} without")
    log(f"[serve_int8] (b) prefix cache off: {int(out_c['lengths'].sum())} tokens in "
        f"{wall_c:.3f} s ({int(out_c['lengths'].sum()) / wall_c:.1f} tok/s), "
        f"{out_c['steps']} steps; greedy tokens equal, {ties_b} requests past a tie")

    # (c) a warm second serve on the same engine
    t0 = time.perf_counter()
    out_w = engine.serve(params, prompts, lens)
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    ties_c = greedy_agree("serve_int8 (c)", plain, params, prompts, lens, out_k, out_w)
    if not out_w["prefill_cached"] > cached:
        raise AssertionError(f"warm int8 serve shared {out_w['prefill_cached']} prompt "
                             f"tokens, the cold one {cached}")
    engine.blocks.check_invariants()
    log(f"[serve_int8] (c) warm cache: {out_w['prefill_cached']}/"
        f"{out_w['prefill_total']} prompt tokens from shared pages (cold {cached}); "
        f"{int(out_w['lengths'].sum())} tokens in {wall_w:.3f} s, {out_w['steps']} "
        f"steps; greedy tokens equal, {ties_c} requests past a tie")

    # the static engine on the first R_STATIC requests, kernels and plain
    sp, sl = prompts[:R_STATIC], lens[:R_STATIC]
    kern.calls.clear()
    kern.n_decode = 0
    plain.calls.clear()
    plain.n_decode = 0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_s = Engine(kern, EngineConfig(**kw)).serve(params, sp, sl)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    static_launches = ops.launch_counts()
    steps_s = out_s["steps"]
    want_s = expect(steps_s, 0, steps_s + R_STATIC)
    log(f"[serve_int8] static, kernels: {steps_s} steps; launches {static_launches}, "
        f"expected {want_s}")
    if static_launches != want_s:
        raise AssertionError(f"int8 static launch counts {static_launches} != {want_s}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_sr = Engine(plain, EngineConfig(**kw)).serve(params, sp, sl)
    torch.cuda.synchronize()
    wall_sr = time.perf_counter() - t0
    tie_s, worst_s, scale_s = compare_calls("serve_int8 static", kern, plain, out_s,
                                            out_sr, logit_tol=None)
    n_tok_s = int(out_s["lengths"].sum())
    log(f"[serve_int8] (a) static, kernels: {n_tok_s} tokens in {wall_s:.3f} s "
        f"({n_tok_s / wall_s:.1f} tok/s); plain {wall_sr:.3f} s "
        f"({int(out_sr['lengths'].sum()) / wall_sr:.1f} tok/s); greedy tokens "
        f"identical: {tie_s is None}; steps identical ({steps_s}); first 8 decode steps' "
        f"logits max abs diff {worst_s:.3g} at |logit| <= {scale_s:.3g} (measured, not "
        f"held: see (a))")

    # what int8 buys and costs against the f32 dynamic engine in this run
    f32_tokens, f32_tok_per_s = f32_dyn
    mib8 = pool_bytes(cfg8, engine.spec) / 2**20
    mib32 = pool_bytes(cfg, engine.spec) / 2**20
    valid = torch.arange(Gmax)[None] < out_k["lengths"][:, None]
    agree = float((out_k["tokens"][valid] == f32_tokens[valid]).float().mean())
    log(f"[serve_int8] pools {mib8:.2f} MiB int8 against {mib32:.2f} MiB f32 "
        f"({mib32 / mib8:.2f}x); {n_tok / wall_k:.1f} tok/s against the f32 dynamic "
        f"engine's {f32_tok_per_s:.1f} in this run ({n_tok / wall_k / f32_tok_per_s:.1%});"
        f" greedy top-1 agreement with it {agree:.1%} (printed, not held)")
    return launches, static_launches, dict(
        requests=R, steps=out_k["steps"], chunk_forwards=n_chunk, decode_steps=n_dec,
        tokens=n_tok, wall_s=wall_k, tok_per_s=n_tok / wall_k, plain_wall_s=wall_r,
        plain_tok_per_s=int(out_r["lengths"].sum()) / wall_r,
        logit_max_abs_diff=worst, pools_vs_plain=pools,
        prefill_cached=cached, prefill_total=out_k["prefill_total"],
        warm_prefill_cached=out_w["prefill_cached"], warm_wall_s=wall_w,
        no_cache_wall_s=wall_c, no_cache_steps=out_c["steps"],
        ties=dict(b=ties_b, c=ties_c), pool_mib_int8=mib8, pool_mib_f32=mib32,
        f32_tok_per_s=f32_tok_per_s, top1_agreement_with_f32=agree,
        static=dict(requests=R_STATIC, steps=steps_s, tokens=n_tok_s, wall_s=wall_s,
                    tok_per_s=n_tok_s / wall_s, plain_wall_s=wall_sr),
    )


# ---------------------------------------------------------------------------
# gemma2-2b served at full width: local/global alternation over rings
# ---------------------------------------------------------------------------

G2_R, G2_S, G2_GMAX, G2_P, G2_CH, G2_LONG = 8, 4, 64, 16, 256, 6400
G2_SHORT = (64, 512)  # the other prompts' lengths
G2_R_STATIC8 = 3      # requests of the static engine's int8 serve (one of 6,400)


def gemma2_workload(V):
    """8 requests from seed 0: 2 prompts of 6,400 tokens (past window 4,096
    + attn_chunk 2,048: a static prefill cuts the local layers' band, and
    the ring wraps) and 6 of 64-512 tokens, in a shuffled order."""
    rng = np.random.default_rng(0)
    lens = np.concatenate([[G2_LONG, G2_LONG],
                           rng.integers(G2_SHORT[0], G2_SHORT[1] + 1, G2_R - 2)])
    lens = lens[rng.permutation(G2_R)]
    prompts = rng.integers(0, V, (G2_R, G2_LONG))
    return prompts, lens


def g2_expect(L, n_dec, n_chunk, n_fwd, int8=False, norms=4):
    """Exact launches of a gemma2 serve: B8 once a layer a decode step, B9
    once a layer a chunk forward (the ring layers' and the global ones'
    alike), B1 four times a layer (pre- and post-norms; ``norms`` 2 for
    mixtral, which has no post-norms) and once more a forward, nothing
    else."""
    sfx = "_int8" if int8 else ""
    want = dict.fromkeys((*PORT_KERNELS, *GROUPED), 0)
    want["flash_decode" + sfx] = L * n_dec
    want["flash_decode_multi" + sfx] = L * n_chunk
    want["rmsnorm"] = (norms * L + 1) * n_fwd
    return want


def g2_wrap(what, cfg, spec, lens, out):
    """The highest position served, minus the window: past the ring's reach
    (wp_cols pages) it shows that the ring wrapped."""
    top = int(max(int(n) + int(g) - 1 for n, g in zip(lens, out["lengths"])))
    reach = spec.wp_cols * spec.page_size
    log(f"[{what}] highest position served {top}; minus the window {cfg.window_size}: "
        f"{top - cfg.window_size}; the ring holds {reach} positions ({spec.wp_cols} pages "
        f"of {spec.page_size}), so it wrapped {top // reach} time(s)")
    if top < reach:
        raise AssertionError(f"{what}: the ring never wrapped ({top} < {reach})")
    return dict(top_position=top, top_minus_window=top - cfg.window_size,
                ring_positions=reach, ring_pages=spec.wp_cols, global_pages=spec.gp_cols)


G2_PROFILED = 16      # tokens a request in the profiled serve (the busy share)
# the f32 serves' first 8 decode steps' logits, kernels against the plain
# versions and each against a float64 forward: atol = rtol = 1e-3, three
# times the largest gap read between the f32 paths (3.28e-4 at |logit| <= 30,
# H100 at 700 W); B1 alone makes 3.10e-4 of it over 26 layers of 4 norms
G2_LOGIT_TOL = 1e-3


def g2_float64(what, cfg, params, prompts, lens, kern, plain, out, tie_at):
    """The static engine's first 8 decode steps' logits against a float64
    forward of the same tokens (plain versions, every op in f64): slot j
    holds request j in those steps (the first four admitted in turn, none
    retired), its row at position p is the logits after prompt + the first
    p - len + 1 generated tokens.  Holds both f32 paths within G2_LOGIT_TOL
    (allclose) of it; returns their largest distances."""
    need = {}
    for cr in plain.calls[:tie_at]:
        for j, p in enumerate(cr["pos"] or ()):
            if p < 0:
                continue
            if not 0 <= p - int(lens[j]) < int(out["lengths"][j]):
                raise AssertionError(f"{what}: slot {j} at position {p} is not request {j}")
            need.setdefault(j, set()).add(p)
    m64 = type(plain)(cfg.replace(dtype="float64"), device="cuda", impl="ref")
    p64 = {k: v.double() for k, v in params.items()}
    exact = {}
    with torch.no_grad():
        for j, ps in need.items():
            ps = sorted(ps)
            seq = np.concatenate([prompts[j, :int(lens[j])],
                                  out["tokens"][j, :ps[-1] - int(lens[j]) + 1].numpy()])
            logits, _ = m64.forward(p64, torch.as_tensor(seq[None], device="cuda"),
                                    readout=torch.tensor(ps, device="cuda"))
            exact.update({(j, p): row for p, row in zip(ps, logits[0])})
    del p64, m64
    torch.cuda.empty_cache()
    res = dict(kernel_from_f64=0.0, plain_from_f64=0.0, rows=len(exact), excess=0.0)
    for ck, cr in zip(kern.calls[:tie_at], plain.calls[:tie_at]):
        for j, p in enumerate(cr["pos"] or ()):
            if p < 0:
                continue
            ex = exact[(j, p)]
            for key, got in (("kernel_from_f64", ck["rows"][j]), ("plain_from_f64", cr["rows"][j])):
                d = (got.double() - ex).abs()
                res[key] = max(res[key], d.max().item())
                res["excess"] = max(res["excess"],
                                    (d - G2_LOGIT_TOL * (1 + ex.abs())).max().item())
    log(f"[{what}] against a float64 forward of the same tokens ({len(need)} requests, "
        f"{res['rows']} positions): first 8 decode steps' logits max abs diff, the kernels "
        f"{res['kernel_from_f64']:.3g}, the plain versions {res['plain_from_f64']:.3g} "
        f"(held at atol = rtol = {G2_LOGIT_TOL})")
    if not res["excess"] <= 0:
        raise AssertionError(f"{what}: decode logits off the float64 forward by "
                             f"{res['kernel_from_f64']} / {res['plain_from_f64']}")
    return res


def g2_serve(what, ops, kern, plain, make, params, prompts, lens, want_fn, int8=False,
             b1_control=False, profile=True, logit_tol=None, float64=False, gmax=G2_GMAX,
             routing=None):
    """One gemma2 serve through the kernels (launches counted, peak memory,
    tok/s) and one through the plain versions (no launch), compared by
    compare_calls: the same steps and the same greedy token at every
    sampled row (near-tie rule); the first 8 decode steps' logits held at
    ``logit_tol`` (None: measured, not held; see gemma2_phases), and with
    ``float64`` both against a float64 forward (g2_float64, the static
    engine only).  ``b1_control``: a serve
    through the plain versions but for B1, on the card, gives the logits'
    difference that B1 alone makes.  Then, with ``profile``, the card's busy share under the
    profiler over a shorter serve through the kernels, the first long
    request and the two shortest, G2_PROFILED tokens each (the profiler's
    post-processing takes ~0.2 ms an event, and a whole serve launches
    170,000-500,000 kernels).  ``make(model, gen_len)`` builds the engine;
    ``want_fn(calls)`` gives the exact launches from the recorded
    forwards.  ``gmax`` is the serve's generation budget; ``routing(kern,
    plain, plain serve)`` (mixtral: mx_routing) compares the recorded MoE routings and
    returns the requests it parted, which compare_requests leaves out from
    there on in place of compare_calls.  Returns (launches, kernel serve,
    summary)."""
    for m in (kern, plain):
        m.calls.clear()
        m.n_decode = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = make(kern, gmax)
    ops.reset_launch_counts()
    out_k, wall_k = timed_serve(engine, params, prompts, lens)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = want_fn(kern.calls)
    n_chunk = sum(c["mode"] == "decode" and c["T"] > 1 for c in kern.calls)
    n_dec = sum(c["mode"] == "decode" and c["T"] == 1 for c in kern.calls)
    n_pre = sum(c["mode"] == "prefill" for c in kern.calls)
    log(f"[{what}] kernels: {out_k['steps']} steps, {n_pre} prefills, {n_chunk} chunk "
        f"forwards, {n_dec} decode steps; launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"{what}: launch counts {launches} != {want}")
    ops.reset_launch_counts()
    out_r, wall_r = timed_serve(make(plain, gmax), params, prompts, lens)
    if set(ops.launch_counts().values()) != {0}:
        raise AssertionError(f"{what}: the plain serve launched kernels: "
                             f"{ops.launch_counts()}")
    route = routing(kern, plain, out_r) if routing is not None else None
    if route is None:
        tie_at, worst, scale = compare_calls(what, kern, plain, out_k, out_r,
                                             logit_tol=logit_tol)
    else:
        tie_at, worst, scale = compare_requests(what, kern, plain, out_k, out_r, logit_tol,
                                                route["parted"])
    n_tok = int(out_k["lengths"].sum())
    log(f"[{what}] kernels: {n_tok} tokens in {wall_k:.3f} s ({n_tok / wall_k:.1f} tok/s), "
        f"peak memory {peak:.2f} GiB; plain: {int(out_r['lengths'].sum())} tokens in "
        f"{wall_r:.3f} s ({int(out_r['lengths'].sum()) / wall_r:.1f} tok/s); greedy tokens "
        f"identical: {tie_at is None}; steps identical ({out_k['steps']}); first 8 decode "
        f"steps' logits max abs diff {worst:.3g} at |logit| <= {scale:.3g} "
        f"({'measured' if logit_tol is None else f'held at atol = rtol = {logit_tol}'})")
    summary = dict(requests=len(lens), steps=out_k["steps"], prefills=n_pre,
                   chunk_forwards=n_chunk, decode_steps=n_dec, tokens=n_tok, wall_s=wall_k,
                   tok_per_s=n_tok / wall_k, plain_wall_s=wall_r,
                   plain_tok_per_s=int(out_r["lengths"].sum()) / wall_r,
                   logit_max_abs_diff=worst, logit_scale=scale, logit_tol=logit_tol,
                   tie=tie_at, peak_gib=peak)
    if route is not None:
        summary["routing"] = route
    if float64:
        summary["float64"] = g2_float64(what, kern.cfg, params, prompts, lens, kern, plain,
                                        out_r, tie_at)
    if b1_control:
        ctrl = type(plain)(plain.cfg, device="cuda", impl="ref")
        plain_rms = ops.fused_rmsnorm
        ops.fused_rmsnorm = lambda x, gain, *, eps=1e-6, impl="auto": plain_rms(
            x, gain, eps=eps, impl="kernel")
        try:
            out_c, _ = timed_serve(make(ctrl, gmax), params, prompts, lens)
        finally:
            ops.fused_rmsnorm = plain_rms
        try:
            _, worst_c, _ = compare_calls(f"{what} B1 alone", ctrl, plain, out_c, out_r,
                                          logit_tol=None)
        except AssertionError as e:
            # a measurement, not a check of the port: the control's tokens
            # may part from the plain serve's where the kernels' did not
            summary["b1_alone_parted"] = str(e)
            log(f"[{what}] control, the plain versions but B1 on the card: {e}")
        else:
            summary["logit_max_abs_diff_b1_alone"] = worst_c
            log(f"[{what}] control, the plain versions but B1 on the card: the same tokens "
                f"and steps; first 8 decode steps' logits max abs diff {worst_c:.3g} from "
                f"the plain serve (all kernels: {worst:.3g})")
    if not profile:
        return launches, out_k, summary
    order = np.argsort(lens, kind="stable")
    pick = [int(np.argmax(lens)), *[int(i) for i in order[:2]]]
    wall_ms, busy, n_launch, top = busy_profile(
        lambda: make(kern, G2_PROFILED).serve(params, prompts[pick], lens[pick]))
    summary.update(profiled_requests=[int(lens[i]) for i in pick], profile_wall_ms=wall_ms,
                   busy_ms=busy, busy_share=busy / wall_ms, profile_launches=n_launch,
                   top_kernels=top)
    log(f"[{what}] under the profiler, prompts {summary['profiled_requests']} x "
        f"{G2_PROFILED} tokens: {wall_ms:.0f} ms, card busy {busy:.1f} ms "
        f"({busy / wall_ms:.1%}), {n_launch} launches; top {top}")
    return launches, out_k, summary


def gemma2_phases(Model, Engine, DynamicEngine, EngineConfig, ops, t0):
    """gemma2-2b (configs/gemma2_2b.py) at full width, f32 weights from seed
    0 with a random query projection, 4 slots, page 16, on the
    gemma2_workload requests, 64 tokens each, greedy.

    - serve_gemma2: the static engine (one-shot prefills of the 6,400-token
      buffer in query chunks of 2,048, the local layers' band cut).
    - serve_gemma2_dynamic: DynamicEngine, chunks of 256, the prefix cache
      requested (sharing off on a ring config: nothing shared); (b) its
      greedy tokens equal to the static engine's (near-tie rule).
    - serve_gemma2_int8: int8 pools through DynamicEngine on the same
      requests and through the static engine on the first 3; the pools'
      MiB against f32 and the top-1 agreement with the f32 dynamic serve
      printed.

    Each: kernels against plain versions (compare_calls: tokens and steps,
    the near-tie rule), exact B1/B8/B9 launches (g2_expect), the wrap shown
    (g2_wrap), pool MiB, tok/s, the card's busy share, peak memory and the
    phase's seconds.  The f32 serves' decode logits are held at
    G2_LOGIT_TOL, not the smollm phases' 1e-4: over 26 layers of four norms
    each, f32 sums in another order move logits capped at 30 by ~3e-4 (an
    H100 at 700 W).  The static serve holds both paths against a float64
    forward of the same tokens (g2_float64), and its control serve shows
    how much of the gap B1 alone makes; B1 is held at 2e-5 at D 2304
    (rmsnorm_phase) and B8/B9 on these shapes (check_g2_cases).  The int8
    serve's logits are measured: a flipped int8 step moves a k or v by
    1/127 of its page's absmax, so the control serve (B1 alone) and the
    pools' flipped bytes show what f32 differences upstream of the
    quantizer make of it.  Returns ({path: launches}, {path: summary})."""
    from repro_torch.configs import get_config
    from repro_torch.serving.kv_cache import pool_bytes

    cfg = get_config("gemma2-2b").replace(dtype="float32", zero_init_query=False)
    cfg8 = cfg.replace(kv_dtype="int8")
    L = cfg.n_layers
    prompts, lens = gemma2_workload(cfg.vocab_size)
    kw = dict(n_slots=G2_S, page_size=G2_P, max_prompt_len=G2_LONG, max_gen_len=G2_GMAX)
    dyn_kw = dict(prefill_chunk=G2_CH, prefix_cache=True, **kw)
    Rec = make_recording_model(Model)
    kern, plain = Rec(cfg, device="cuda", impl="auto"), Rec(cfg, device="cuda", impl="ref")
    params = kern.init(seed=0)
    n_params = sum(p.numel() for p in params.values())
    log(f"[serve_gemma2] {cfg.name}: {L} layers {cfg.pattern} x {cfg.n_groups}, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, window {cfg.window_size}, softcaps "
        f"{cfg.attn_softcap}/{cfg.final_softcap}, {n_params / 1e9:.3f}B params "
        f"({4 * n_params / 2**30:.2f} GiB f32); {G2_R} requests, prompt lens "
        f"{lens.tolist()}, {G2_GMAX} tokens each, {G2_S} slots, page {G2_P}")
    # warm-up outside the counted runs: a one-shot prefill of the buffer and
    # chunk forwards, so cuBLAS has met these shapes
    short = int(np.argmin(lens))
    Engine(kern, EngineConfig(**{**kw, "n_slots": 1, "max_gen_len": 2})).serve(
        params, prompts[short:short + 1], lens[short:short + 1])
    DynamicEngine(kern, EngineConfig(**{**dyn_kw, "n_slots": 1, "max_gen_len": 2})).serve(
        params, prompts[short:short + 1], lens[short:short + 1])
    launches, summary = {}, {}

    def chunks_of(calls):
        return sum(c["mode"] == "decode" and c["T"] > 1 for c in calls)

    def decodes_of(calls):
        return sum(c["mode"] == "decode" and c["T"] == 1 for c in calls)

    def make_static(m, gen_len):
        return Engine(m, EngineConfig(**{**kw, "max_gen_len": gen_len}))

    # ---- the static engine ----
    t_ph = time.perf_counter()
    spec = make_static(kern, G2_GMAX).spec
    launches["serve_gemma2"], out_s, summary["serve_gemma2"] = g2_serve(
        "serve_gemma2", ops, kern, plain, make_static, params, prompts, lens,
        lambda calls: g2_expect(L, decodes_of(calls), 0, len(calls)), b1_control=True,
        logit_tol=G2_LOGIT_TOL, float64=True)
    summary["serve_gemma2"].update(
        wrap=g2_wrap("serve_gemma2", cfg, spec, lens, out_s),
        pool_mib=pool_bytes(cfg, spec) / 2**20, seconds=time.perf_counter() - t_ph)
    log(f"[serve_gemma2] pools {summary['serve_gemma2']['pool_mib']:.1f} MiB f32 "
        f"({spec.n_slots} slots x ({spec.gp_cols} global + {spec.wp_cols} ring pages)); "
        f"phase {summary['serve_gemma2']['seconds']:.1f} s")
    t_done = time.perf_counter() - t0
    log(f"[time] serve_gemma2 done at {t_done:.0f} s")

    # ---- the dynamic engine, chunks of 256, the prefix cache requested ----
    t_ph = time.perf_counter()
    made = []

    def make_dyn(m, gen_len):
        e = DynamicEngine(m, EngineConfig(**{**dyn_kw, "max_gen_len": gen_len}))
        if e.blocks.cache is not None:
            raise AssertionError("a prefix cache on a ring config")
        made.append(e)
        return e

    def want_dyn(calls, int8=False):
        n_chunk, n_dec = chunks_of(calls), decodes_of(calls)
        want_chunks = int(sum(-(-int(n) // G2_CH) for n in lens))
        if n_chunk != want_chunks or any(c["mode"] == "prefill" for c in calls) or any(
                c["T"] != G2_CH for c in calls if c["mode"] == "decode" and c["T"] > 1):
            raise AssertionError(f"chunk forwards {n_chunk} against the schedule "
                                 f"{want_chunks} (none shared)")
        return g2_expect(L, n_dec, n_chunk, n_chunk + n_dec, int8)

    launches["serve_gemma2_dynamic"], out_d, summary["serve_gemma2_dynamic"] = g2_serve(
        "serve_gemma2_dynamic", ops, kern, plain, make_dyn, params, prompts, lens, want_dyn,
        logit_tol=G2_LOGIT_TOL)
    dspec = made[0].spec
    if out_d["prefill_cached"] != 0:
        raise AssertionError(f"{out_d['prefill_cached']} prompt tokens shared on a ring "
                             f"config")
    ring_pos = made[0]._pools["groups"]["0_local"]["attn"]["pos"]
    if int(ring_pos.max()) < dspec.wp_cols * dspec.page_size:
        raise AssertionError("the dynamic engine's ring pools never wrapped")
    ties = greedy_agree("serve_gemma2_dynamic (b)", plain, params, prompts, lens, out_d,
                        out_s)
    summary["serve_gemma2_dynamic"].update(
        wrap=g2_wrap("serve_gemma2_dynamic", cfg, dspec, lens, out_d),
        ring_pool_top_position=int(ring_pos.max()), prefill_cached=out_d["prefill_cached"],
        prefill_total=out_d["prefill_total"], ties_vs_static=ties,
        pool_mib=pool_bytes(cfg, dspec) / 2**20, seconds=time.perf_counter() - t_ph)
    log(f"[serve_gemma2_dynamic] (b) greedy tokens equal to the static engine's, {ties} "
        f"requests past a tie; prefix cache requested: {out_d['prefill_cached']}/"
        f"{out_d['prefill_total']} prompt tokens shared (sharing off on rings); ring pools "
        f"hold positions up to {int(ring_pos.max())}; pools "
        f"{summary['serve_gemma2_dynamic']['pool_mib']:.1f} MiB ({dspec.wp_cols} ring "
        f"pages a slot); phase {summary['serve_gemma2_dynamic']['seconds']:.1f} s")
    log(f"[time] serve_gemma2_dynamic done at {time.perf_counter() - t0:.0f} s")

    # ---- int8 pools: the dynamic engine, then the static one on 3 requests ----
    t_ph = time.perf_counter()
    kern8, plain8 = Rec(cfg8, device="cuda", impl="auto"), Rec(cfg8, device="cuda", impl="ref")
    made.clear()
    launches["serve_gemma2_int8"], out_8, summary["serve_gemma2_int8"] = g2_serve(
        "serve_gemma2_int8", ops, kern8, plain8, make_dyn, params, prompts, lens,
        lambda calls: want_dyn(calls, int8=True), int8=True, b1_control=True)
    # the pools the kernel serve, the plain one and the B1-alone control left
    # (made: kernels, plain, control): the int8 steps that f32 differences
    # upstream of the quantizer flipped
    flips = dict(kernels=pool_diff(made[0]._pools, made[1]._pools))
    if "b1_alone_parted" not in summary["serve_gemma2_int8"]:
        flips["b1_alone"] = pool_diff(made[2]._pools, made[1]._pools)
    summary["serve_gemma2_int8"]["pools_vs_plain"] = flips
    log("[serve_gemma2_int8] int8 pools against the plain serve's: " + "; ".join(
        f"{k}: {d['bytes_differ']} of {d['bytes']} bytes differ "
        f"({d['bytes_differ'] / d['bytes']:.3%}), by at most {d['max_byte_diff']} step(s), "
        f"scales' largest relative difference {d['scale_rel']:.3g}" for k, d in flips.items()))
    valid = torch.arange(G2_GMAX)[None] < out_8["lengths"][:, None]
    agree = float((out_8["tokens"][valid] == out_d["tokens"][valid]).float().mean())
    mib8, mib32 = pool_bytes(cfg8, dspec) / 2**20, pool_bytes(cfg, dspec) / 2**20
    sp, sl = prompts[:G2_R_STATIC8], lens[:G2_R_STATIC8]
    launches["serve_gemma2_int8_static"], out_8s, static8 = g2_serve(
        "serve_gemma2_int8 static", ops, kern8, plain8, make_static, params, sp, sl,
        lambda calls: g2_expect(L, decodes_of(calls), 0, len(calls), int8=True), int8=True,
        profile=False)
    summary["serve_gemma2_int8"].update(
        wrap=g2_wrap("serve_gemma2_int8", cfg, dspec, lens, out_8), pool_mib=mib8,
        pool_mib_f32=mib32, top1_agreement_with_f32=agree, static=static8,
        seconds=time.perf_counter() - t_ph)
    log(f"[serve_gemma2_int8] pools {mib8:.1f} MiB int8 against {mib32:.1f} MiB f32 "
        f"({mib32 / mib8:.2f}x); greedy top-1 agreement with the f32 dynamic serve "
        f"{agree:.1%} (printed, not held); phase {time.perf_counter() - t_ph:.1f} s")
    del kern, plain, kern8, plain8, params, made
    torch.cuda.empty_cache()
    return launches, summary


# mixtral-8x22b's serve phases: 4 of its 56 layers (MX_DEPTH; f32 weights
# of 4 layers are 41.7 GB, of 56 layers 564 GB), 6 requests of seed 0: 2
# prompts of 4,608 tokens (past the 257-page ring's 4,112 positions: it
# wraps) and 4 of 64-512, 32 tokens each, 4 slots, page 16; the dynamic
# engine's chunks of 256
MX_DEPTH, MX_R, MX_S, MX_GMAX, MX_P, MX_CH, MX_LONG = 4, 6, 4, 32, 16, 256, 4608
MX_SHORT = (64, 512)
# the first 8 decode steps' logits of the rows still compared, kernels
# against the plain versions: three times the largest gap read (H100 at
# 700 W, |logit| <= 4.84), f32 pools 9.54e-6 (static) and 8.88e-6
# (dynamic), int8 pools 3.13e-3 (the one-ulp control's: 2.22e-3)
MX_LOGIT_TOL = 3e-5
MX_LOGIT_TOL_INT8 = 1e-2
# an expert choice may flip between two serves only where the plain
# probabilities of the k-th and (k+1)-th experts lie within the tie limit:
# over f32 pools ROUTE_TIE (B1's and B8/B9's last bits move the router's
# input); over int8 pools an f32 ulp upstream of the quantizer flips a
# byte and a k or v moves by 1/127 of its page's absmax, so the limit is
# twice the largest probability difference that a control makes, a plain
# serve whose quantizer inputs are moved by one ulp (moved_quantizer_inputs),
# and never below ROUTE_TIE
ROUTE_TIE = 1e-5
# the router probabilities of the rows that did not flip, kernels against
# the plain versions, held at a fixed ceiling: three times the largest
# difference read (H100 at 700 W), f32 pools 1.61e-6, int8 pools 9.72e-4
# (the one-ulp control's: 9.40e-4)
ROUTE_PROB_TOL = 5e-6
ROUTE_PROB_TOL_INT8 = 3e-3


def make_routing_recorder(Model):
    """make_recording_model's recorder that also keeps, for every recorded
    forward, each MoE layer's router logits and expert choices (the
    models/moe.py ``route`` of that forward, in layer order), which rows
    are real tokens (not a prefill's padding at position Pmax, not a row at
    -1) and the request each row serves (``row_req``, set by
    tag_requests)."""
    from repro_torch.models import moe as moe_lib

    Rec = make_recording_model(Model)

    class RoutingRecorder(Rec):
        row_req = None

        def forward(self, params, tokens, positions=None, mode="train", **kw):
            sink, real = [], moe_lib.route

            def route(*a, **k):
                out = real(*a, **k)
                sink.append((out[0], out[2]))
                return out

            moe_lib.route = route
            try:
                out = super().forward(params, tokens, positions=positions, mode=mode, **kw)
            finally:
                moe_lib.route = real
            if positions is not None:
                valid = positions >= 0
                if mode == "prefill":
                    valid = valid & (positions < tokens.shape[1])
                self.calls[-1].update(routes=sink, valid=valid, req=self.row_req)
            return out

    return RoutingRecorder


def tag_requests(engine):
    """``engine`` with its forwards wrapped so that its model (a
    make_routing_recorder model) knows the request each row serves: a
    decode step's slots (-1 where idle), a prefill's or a chunk's one
    request.  Returns the engine."""
    m = engine.model
    decode, prefill, chunk = engine._decode, engine._prefill, getattr(
        engine, "_admit_chunk", None)

    def _decode(params, q, st, *a, **kw):
        m.row_req = np.where(st.active, st.req, -1).tolist()
        return decode(params, q, st, *a, **kw)

    def _prefill(model, params, q, req):
        model.row_req = [int(req)]
        return prefill(model, params, q, req)

    def _admit_chunk(params, q, st, cur, *a, **kw):
        m.row_req = [int(cur["req"])]
        return chunk(params, q, st, cur, *a, **kw)

    engine._decode, engine._prefill = _decode, _prefill
    if chunk is not None:
        engine._admit_chunk = _admit_chunk
    return engine


@contextlib.contextmanager
def moved_quantizer_inputs():
    """serving/kv_cache.py's _quantized_write with every value it quantizes
    moved by one f32 ulp, up at even flat indices and down at odd ones:
    the int8 routing control (mixtral_phases), a plain serve whose pools
    part from the plain serve's as an f32 difference in the last bit makes
    them part."""
    from repro_torch.serving import kv_cache

    real = kv_cache._quantized_write

    def moved(store, scale, x_new, pg, off):
        xf = x_new.float()
        toward = torch.full_like(xf, math.inf)
        toward.view(-1)[1::2] = -math.inf
        return real(store, scale, torch.nextafter(xf, toward), pg, off)

    kv_cache._quantized_write = moved
    try:
        yield
    finally:
        kv_cache._quantized_write = real


def route_diff(k, lk, ik, lr, ir, valid):
    """One MoE layer's routing, a run's (router logits ``lk``, expert ids
    ``ik``) against the plain run's (``lr``, ``ir``), over the rows of
    ``valid``: (the rows whose set of k experts differs, the plain
    probability margin of the k-th over the (k+1)-th expert, the largest
    router probability difference on valid rows that did not flip (0.0 if
    none))."""
    pr = torch.softmax(lr, dim=-1)
    p = pr.sort(dim=-1, descending=True).values
    margin = p[..., k - 1] - p[..., k]
    differ = (ik.sort(-1).values != ir.sort(-1).values).any(-1) & valid
    same = valid & ~differ
    noise = 0.0
    if bool(same.any()):
        noise = (torch.softmax(lk, dim=-1) - pr).abs().amax(-1)[same].max().item()
    return differ, margin, noise


def dropped_slots(ik, valid, E, C):
    """The slots of the rows of ``valid`` that expert ids ``ik`` (B, S, k)
    rank at or past the capacity C of their expert (models/moe.py's
    dispatch: a cumsum over the flattened slots of each sequence)."""
    flat = ik.reshape(ik.shape[0], -1)
    rank = (torch.nn.functional.one_hot(flat, E).cumsum(1)
            .gather(-1, flat[..., None])[..., 0] - 1)
    return int(((rank >= C).reshape(ik.shape) & valid[..., None]).sum())


def mx_routing(what, cfg, tie=ROUTE_TIE, prob_tol=ROUTE_PROB_TOL):
    """routing(a, b, b's serve) for g2_serve: the expert choices of a serve ``a`` (the
    kernels', or a control's) against the plain serve ``b``'s, forward by
    forward and layer by layer over the real rows of each request until
    it parts.  A request parts where one of its rows takes another set of
    k experts, which must be a near-tie: the plain probabilities of the
    k-th and (k+1)-th experts within ``tie`` (each flip printed with its
    margin; that sequence's capacity ranks shift, so its later rows may
    differ); and after a forward whose sampled token differs for it
    (compare_requests judges that token).  The other requests are compared
    through the whole serve: the largest difference between the two
    router probabilities on rows that did not flip must stay within
    ``prob_tol`` (None: measured, not held).  Also counts, from ``a``'s
    routings, the real slots each kind of forward dropped past its
    capacity.  Returns {parted: {request: forward}, flips, rows compared,
    the smallest margin, the largest probability difference, drops}."""
    from repro_torch.models import moe as moe_lib

    k, E = cfg.top_k, cfg.n_experts

    def check(kern, plain, out_r):
        flips, compared, min_margin, noise = [], 0, float("inf"), 0.0
        parted, drops = {}, {}
        for i, (ck, cr) in enumerate(zip(kern.calls, plain.calls)):
            kind = ("prefill" if cr["mode"] == "prefill" else
                    "chunk" if cr["T"] > 1 else "decode")
            S = cr["valid"].shape[1]
            C = moe_lib._capacity(cfg, S)
            for layer, ((lk, ik), (lr, ir)) in enumerate(zip(ck["routes"], cr["routes"])):
                live = torch.tensor([parted.get(r, i + 1) > i for r in cr["req"]],
                                    device=lr.device)
                valid = cr["valid"] & live[:, None]
                differ, margin, dp = route_diff(k, lk, ik, lr, ir, valid)
                if bool(valid.any()):
                    compared += int(valid.sum())
                    min_margin = min(min_margin, margin[valid].min().item())
                    noise = max(noise, dp)
                d = drops.setdefault(kind, [0, 0])
                d[0] += dropped_slots(ik, cr["valid"], E, C)
                d[1] += int(cr["valid"].sum()) * k
                for b, t in differ.nonzero().tolist():
                    m, r = margin[b, t].item(), cr["req"][b]
                    flips.append(dict(forward=i, mode=kind, layer=layer, row=[b, t],
                                      request=r, margin=m))
                    log(f"[{what}] routing flip: forward {i} ({kind}), layer {layer}, row "
                        f"({b}, {t}) of request {r}: experts {ik[b, t].tolist()} against "
                        f"{ir[b, t].tolist()} plain, plain top-{k} margin {m:.3g} (the near-tie "
                        f"limit {tie:.3g}); that request's later rows are left out")
                    if not m < tie:
                        raise AssertionError(f"{what}: expert choice differs at forward {i} "
                                             f"layer {layer} row ({b}, {t}), margin {m} >= "
                                             f"{tie}")
                    parted.setdefault(r, i)
            for b in ((ck["arg"] != cr["arg"]) & cr["active"]).nonzero()[:, 0].tolist():
                parted.setdefault(cr["req"][b], i + 1)
        log(f"[{what}] routing: {compared} real rows x layers compared, {len(flips)} flip(s)"
            + (f" (near-ties below {tie:.3g}, margins {[f['margin'] for f in flips]})"
               if flips else "") + f"; requests parted (request: forward) {parted}; "
            f"smallest plain top-{k} margin {min_margin:.3g}; largest probability difference "
            f"on rows that did not flip {noise:.3g} ("
            + ("measured" if prob_tol is None else f"held at {prob_tol:.3g}")
            + "); real slots dropped past capacity (dropped / slots): "
            + ", ".join(f"{kd} {a} / {b}" for kd, (a, b) in drops.items()))
        if prob_tol is not None and not noise <= prob_tol:
            raise AssertionError(f"{what}: router probabilities differ by {noise} > "
                                 f"{prob_tol} on rows that did not flip")
        return dict(parted=parted, flips=flips, rows_compared=compared, min_margin=min_margin,
                    prob_noise=noise, prob_tol=prob_tol,
                    tie=tie if math.isfinite(tie) else None, dropped_slots=drops)

    return check


def mixtral_workload(V):
    """6 requests from seed 0: 2 prompts of 4,608 tokens and 4 of 64-512,
    in a shuffled order."""
    rng = np.random.default_rng(0)
    lens = np.concatenate([[MX_LONG, MX_LONG],
                           rng.integers(MX_SHORT[0], MX_SHORT[1] + 1, MX_R - 2)])
    lens = lens[rng.permutation(MX_R)]
    prompts = rng.integers(0, V, (MX_R, MX_LONG))
    return prompts, lens


def mixtral_phases(Model, Engine, DynamicEngine, EngineConfig, ops, t0):
    """mixtral-8x22b (configs/mixtral_8x22b.py, arXiv:2401.04088: every
    layer ``local_moe``, window 4,096; d_model 6144, 48/8 heads of 128, 8
    experts of d_ff 16384 (silu GLU), top-2, capacity factor 1.25; vocab
    32768, untied embeddings) at full width over MX_DEPTH = 4 of its 56
    layers, f32 weights from seed 0 with a random query projection and a
    random readout (``zero_init_query=False``, ``zero_init_readout=False``:
    under µP the readout starts at zero and every logit would be 0), on the
    mixtral_workload requests, greedy, 4 slots, page 16.

    - serve_mixtral: the static engine (one-shot prefills of the 4,608-token
      buffer: the MoE's capacity over S 4,608, 1,440 places an expert).
    - serve_mixtral_dynamic: DynamicEngine, chunks of 256 (capacity 80),
      the prefix cache requested (sharing off on a ring config: nothing
      shared; no global pool on the card, the config having no global
      layer).
    - serve_mixtral_int8: int8 pools through DynamicEngine, chunks of 256;
      the pools' MiB against f32 and the top-1 agreement with the f32
      dynamic serve printed.

    Each: kernels against the plain versions request by request
    (tag_requests; mx_routing: expert choices, flips only at near-ties,
    counted with their margins, each parting its request, the other rows'
    router probabilities held at ROUTE_PROB_TOL / _INT8; compare_requests:
    tokens and steps by the near-tie rule, the first 8 decode steps'
    logits of the requests not parted held at MX_LOGIT_TOL / _INT8).  Over
    int8 pools the tie limit is twice the largest probability difference
    of a control, the plain versions with the quantizer's inputs moved by
    one ulp (moved_quantizer_inputs), against the plain serve: a measure of
    how far int8 pools part two serves that differ in f32's last bit,
    taken apart from the kernels.  Exact launches (B1 2L + 1 a forward, B8
    L a decode step, B9 L a chunk forward, their int8 modes over int8
    pools, nothing else), the ring's wrap shown (g2_wrap), tok/s, the
    card's busy share, peak memory, pool MiB and the phase's seconds.  One-shot and chunked prefill drop different slots
    (capacity over another S), in the reference too: a mode is compared
    only with itself.  Returns ({path: launches}, {path: summary})."""
    from repro_torch.configs import get_config
    from repro_torch.serving.kv_cache import pool_bytes

    cfg = get_config("mixtral-8x22b").replace(
        dtype="float32", zero_init_query=False, zero_init_readout=False, n_layers=MX_DEPTH)
    cfg8 = cfg.replace(kv_dtype="int8")
    L = cfg.n_layers
    prompts, lens = mixtral_workload(cfg.vocab_size)
    kw = dict(n_slots=MX_S, page_size=MX_P, max_prompt_len=MX_LONG, max_gen_len=MX_GMAX)
    dyn_kw = dict(prefill_chunk=MX_CH, prefix_cache=True, **kw)
    Rec = make_routing_recorder(Model)
    kern, plain = Rec(cfg, device="cuda", impl="auto"), Rec(cfg, device="cuda", impl="ref")
    params = kern.init(seed=0)
    n_params = sum(p.numel() for p in params.values())
    log(f"[serve_mixtral] {cfg.name}: {L} of its 56 layers (the cut: 56 layers of f32 "
        f"weights are 564 GB) {cfg.pattern} x {cfg.n_groups}, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, {cfg.n_experts} experts of "
        f"d_ff {cfg.d_ff} ({cfg.act}), top-{cfg.top_k}, capacity factor "
        f"{cfg.capacity_factor}, vocab {cfg.vocab_size} untied, window {cfg.window_size}, "
        f"{n_params / 1e9:.3f}B params ({4 * n_params / 1e9:.2f} GB f32); {MX_R} requests, "
        f"prompt lens {lens.tolist()}, {MX_GMAX} tokens each, {MX_S} slots, page {MX_P}")
    short = int(np.argmin(lens))
    Engine(kern, EngineConfig(**{**kw, "n_slots": 1, "max_gen_len": 2})).serve(
        params, prompts[short:short + 1], lens[short:short + 1])
    DynamicEngine(kern, EngineConfig(**{**dyn_kw, "n_slots": 1, "max_gen_len": 2})).serve(
        params, prompts[short:short + 1], lens[short:short + 1])
    launches, summary = {}, {}

    def chunks_of(calls):
        return sum(c["mode"] == "decode" and c["T"] > 1 for c in calls)

    def decodes_of(calls):
        return sum(c["mode"] == "decode" and c["T"] == 1 for c in calls)

    def make_static(m, gen_len):
        return tag_requests(Engine(m, EngineConfig(**{**kw, "max_gen_len": gen_len})))

    made = []

    def make_dyn(m, gen_len):
        e = tag_requests(DynamicEngine(m, EngineConfig(**{**dyn_kw, "max_gen_len": gen_len})))
        if e.blocks.cache is not None:
            raise AssertionError("a prefix cache on a ring config")
        if any("0_local_moe" != k for k in e._pools["groups"]):
            raise AssertionError(f"pools {list(e._pools['groups'])} beside the ring's")
        made.append(e)
        return e

    def want_dyn(calls, int8=False):
        n_chunk, n_dec = chunks_of(calls), decodes_of(calls)
        want_chunks = int(sum(-(-int(n) // MX_CH) for n in lens))
        if n_chunk != want_chunks or any(c["mode"] == "prefill" for c in calls) or any(
                c["T"] != MX_CH for c in calls if c["mode"] == "decode" and c["T"] > 1):
            raise AssertionError(f"chunk forwards {n_chunk} against the schedule "
                                 f"{want_chunks} (none shared)")
        return g2_expect(L, n_dec, n_chunk, n_chunk + n_dec, int8, norms=2)

    serve = dict(ops=ops, kern=kern, plain=plain, params=params, prompts=prompts, lens=lens,
                 gmax=MX_GMAX)

    # ---- the static engine ----
    t_ph = time.perf_counter()
    spec = make_static(kern, MX_GMAX).spec
    launches["serve_mixtral"], out_s, summary["serve_mixtral"] = g2_serve(
        "serve_mixtral", make=make_static, logit_tol=MX_LOGIT_TOL,
        want_fn=lambda calls: g2_expect(L, decodes_of(calls), 0, len(calls), norms=2),
        routing=mx_routing("serve_mixtral", cfg), **serve)
    summary["serve_mixtral"].update(
        wrap=g2_wrap("serve_mixtral", cfg, spec, lens, out_s),
        pool_mib=pool_bytes(cfg, spec) / 2**20, seconds=time.perf_counter() - t_ph)
    log(f"[serve_mixtral] pools {summary['serve_mixtral']['pool_mib']:.1f} MiB f32 "
        f"({spec.n_slots} slots x {spec.wp_cols} ring pages; the {spec.gp_cols}-page global "
        f"table has no pool: no global layer); phase "
        f"{summary['serve_mixtral']['seconds']:.1f} s")
    log(f"[time] serve_mixtral done at {time.perf_counter() - t0:.0f} s")

    # ---- the dynamic engine, chunks of 256, the prefix cache requested ----
    t_ph = time.perf_counter()
    launches["serve_mixtral_dynamic"], out_d, summary["serve_mixtral_dynamic"] = g2_serve(
        "serve_mixtral_dynamic", make=make_dyn, want_fn=want_dyn, logit_tol=MX_LOGIT_TOL,
        routing=mx_routing("serve_mixtral_dynamic", cfg), **serve)
    dspec = made[0].spec
    if out_d["prefill_cached"] != 0:
        raise AssertionError(f"{out_d['prefill_cached']} prompt tokens shared on a ring "
                             f"config")
    ring_pos = made[0]._pools["groups"]["0_local_moe"]["attn"]["pos"]
    if int(ring_pos.max()) < dspec.wp_cols * dspec.page_size:
        raise AssertionError("the dynamic engine's ring pools never wrapped")
    summary["serve_mixtral_dynamic"].update(
        wrap=g2_wrap("serve_mixtral_dynamic", cfg, dspec, lens, out_d),
        ring_pool_top_position=int(ring_pos.max()), prefill_cached=out_d["prefill_cached"],
        prefill_total=out_d["prefill_total"], host_global_pages=made[0].n_pages,
        pool_mib=pool_bytes(cfg, dspec) / 2**20, seconds=time.perf_counter() - t_ph)
    log(f"[serve_mixtral_dynamic] prefix cache requested: {out_d['prefill_cached']}/"
        f"{out_d['prefill_total']} prompt tokens shared (sharing off on rings); ring pools "
        f"hold positions up to {int(ring_pos.max())}; pools "
        f"{summary['serve_mixtral_dynamic']['pool_mib']:.1f} MiB ({dspec.wp_cols} ring pages "
        f"a slot; {made[0].n_pages} global pages on the host allocator only); phase "
        f"{summary['serve_mixtral_dynamic']['seconds']:.1f} s")
    log(f"[time] serve_mixtral_dynamic done at {time.perf_counter() - t0:.0f} s")

    # ---- int8 pools through the dynamic engine ----
    t_ph = time.perf_counter()
    kern8, plain8 = Rec(cfg8, device="cuda", impl="auto"), Rec(cfg8, device="cuda", impl="ref")
    made.clear()
    control = {}

    def route8(kern, plain, out_r):
        # the control first: a plain serve with the quantizer's inputs
        # moved by one ulp, against the plain serve; its largest
        # probability difference sets the int8 tie limit
        ctrl = Rec(cfg8, device="cuda", impl="ref")
        with moved_quantizer_inputs():
            out_c, _ = timed_serve(make_dyn(ctrl, MX_GMAX), params, prompts, lens)
        c = mx_routing("serve_mixtral_int8 control", cfg8, tie=math.inf,
                       prob_tol=None)(ctrl, plain, out_r)
        try:
            _, c["logit_max_abs_diff"], _ = compare_requests(
                "serve_mixtral_int8 control", ctrl, plain, out_c, out_r, None, c["parted"])
        except AssertionError as e:
            # a measurement, not a check of the port
            c["parted_tokens"] = str(e)
            log(f"[serve_mixtral_int8] control: {e}")
        control.update(c)
        tie = max(ROUTE_TIE, 2 * c["prob_noise"])
        log(f"[serve_mixtral_int8] control, the plain versions with the quantizer's inputs "
            f"moved by one ulp: largest probability difference {c['prob_noise']:.3g}, "
            f"{len(c['flips'])} flip(s), first 8 decode steps' logits max abs diff "
            f"{c.get('logit_max_abs_diff', math.nan):.3g}; the kernels' tie limit "
            f"{tie:.3g}")
        del ctrl
        return mx_routing("serve_mixtral_int8", cfg8, tie=tie,
                          prob_tol=ROUTE_PROB_TOL_INT8)(kern, plain, out_r)

    launches["serve_mixtral_int8"], out_8, summary["serve_mixtral_int8"] = g2_serve(
        "serve_mixtral_int8", make=make_dyn, want_fn=lambda calls: want_dyn(calls, int8=True),
        int8=True, logit_tol=MX_LOGIT_TOL_INT8, routing=route8,
        **dict(serve, kern=kern8, plain=plain8))
    flips = pool_diff(made[0]._pools, made[1]._pools)
    moved = pool_diff(made[2]._pools, made[1]._pools)
    control["pools_vs_plain"] = moved
    summary["serve_mixtral_int8"]["routing"]["control"] = control
    valid = torch.arange(MX_GMAX)[None] < out_8["lengths"][:, None]
    agree = float((out_8["tokens"][valid] == out_d["tokens"][valid]).float().mean())
    mib8, mib32 = pool_bytes(cfg8, dspec) / 2**20, pool_bytes(cfg, dspec) / 2**20
    summary["serve_mixtral_int8"].update(
        wrap=g2_wrap("serve_mixtral_int8", cfg, dspec, lens, out_8), pool_mib=mib8,
        pool_mib_f32=mib32, top1_agreement_with_f32=agree, pools_vs_plain=flips,
        seconds=time.perf_counter() - t_ph)
    log(f"[serve_mixtral_int8] int8 pools against the plain serve's: {flips['bytes_differ']} "
        f"of {flips['bytes']} bytes differ, by at most {flips['max_byte_diff']} step(s) (the "
        f"control's: {moved['bytes_differ']}, by at most {moved['max_byte_diff']}); "
        f"pools {mib8:.1f} MiB int8 against {mib32:.1f} MiB f32 ({mib32 / mib8:.2f}x); greedy "
        f"top-1 agreement with the f32 dynamic serve {agree:.1%} (printed, not held); phase "
        f"{time.perf_counter() - t_ph:.1f} s")
    del kern, plain, kern8, plain8, params, made
    torch.cuda.empty_cache()
    return launches, summary


# ---------------------------------------------------------------------------
# the dense-loop driver: mamba2-130m served, and smollm's dense serve
# ---------------------------------------------------------------------------

# serve_mamba2: requests, prompt tokens (two SSD chunks of 256) and tokens
# generated each (prompt plus output is then 768, three whole chunks: a
# forward over any other length past one chunk raises, as the reference's
# assertion does)
M2_R, M2_PROMPT, M2_GEN = 8, 512, 256
# decode against the chunked forward, the largest gap over max |logit|: the
# reference's bar (tests/test_smoke_archs.py), held in float64, where it
# tests that h and the conv inputs are carried right.  The kernels' f32
# decode is held against the float64 forward at three times the 2.02e-4
# read (H100 at 700 W).  The f32 chunked forward's own distance from
# float64, 1.01e-3 there, is printed, not held: on the CPU, at 12 of the
# 24 layers on a served row, the reference's f32 forward and the port's lie
# as far from float64 as each other (1.54e-5, 1.39e-5:
# tests/test_torch_ssd.py::test_f32_forward_drifts_from_float64_as_the_references)
M2_DECODE_BAR = 1e-4
M2_F32_DECODE_BAR = 6e-4
# the first 8 decode steps' logits, kernels against the plain versions and
# each against the same steps in float64, as an absolute distance: three
# times the largest read of an f32 path from float64 (6.49e-3 at |logit|
# <= 209, the kernels' 5.67e-3; kernels against plain 5.17e-3, all of it
# B1's, the B1-alone control's the same; H100 at 700 W): f32 rounding over
# 24 layers of logits this large
M2_LOGIT_TOL = 2e-2
# the plain serve: the prefill and the 8 decode steps whose logits are held
M2_PLAIN_GEN = 9
# serve_dense: smollm-135m at SERVE_DEPTH, full-width prompts
DENSE_R, DENSE_PROMPT, DENSE_GEN = 8, 256, 64


class DenseServe:
    """The dense-loop driver (launch/serve.py ``generate``, what the serve
    CLI falls back to) behind an engine's ``serve(params, prompts, lens)``:
    every prompt at full width, no stop token; returns the engine's keys
    (``tokens`` on the host, ``lengths``, ``steps``: one a token)."""

    def __init__(self, model, gen_len):
        self.model, self.gen_len = model, gen_len

    def serve(self, params, prompts, lens):
        from repro_torch.launch.serve import generate

        if not (np.asarray(lens) == prompts.shape[1]).all():
            raise ValueError("the dense-loop driver serves full-width prompts only")
        toks = generate(self.model, params, torch.as_tensor(prompts, device="cuda"),
                        self.gen_len, eos_token_id=-1)
        return dict(tokens=toks.cpu(), lengths=torch.full((len(lens),), self.gen_len),
                    steps=self.gen_len)


def dense_expect(cfg, n_fwd):
    """Exact launches of a dense-loop serve: B1 once a norm a forward (one
    an ssd layer, two an attention or recurrent one, the tail's too, and
    the final norm), nothing else: the dense driver attends in plain
    PyTorch, as the reference's does."""
    kinds = list(cfg.pattern) * cfg.n_groups + list(cfg.tail)
    want = dict.fromkeys((*PORT_KERNELS, *GROUPED), 0)
    want["rmsnorm"] = (sum(1 if k == "ssd" else 2 for k in kinds) + 1) * n_fwd
    return want



def mamba2_serve_phase(Model, ops):
    """serve_mamba2: mamba2-130m (configs/mamba2_130m.py, arXiv:2405.21060:
    24 ``ssd`` layers, d_model 768, d_inner 1536 in 24 SSD heads of 64,
    state 128, chunk 256, conv width 4, vocab 50,280, tied embeddings) at
    full width, f32 weights from seed 0, through the dense-loop driver the
    serve CLI falls back to: M2_R requests of M2_PROMPT tokens, M2_GEN
    generated each, greedy, no stop token.

    - The kernels' serve: exact launches (B1 25 a forward, 256 forwards:
      6,400; nothing else), tok/s, peak memory.
    - The plain versions' serve over its first M2_PLAIN_GEN forwards (the
      prefill and the 8 decode steps whose logits are held): the same
      greedy tokens by the near-tie rule (compare_calls), the logits within
      M2_LOGIT_TOL of the kernels', beside a B1-alone control over the same
      forwards.
    - Against one chunked forward over the 768 tokens of prompt and output
      in float64, at the rows of the logits that picked each generated
      token (511-766): the same decode in float64 within M2_DECODE_BAR of
      max |logit| (the SSD state h and the conv inputs carried right), the
      kernels' f32 decode within M2_F32_DECODE_BAR; the 8 held steps of
      both f32 serves within M2_LOGIT_TOL of the float64 decode's; the f32
      forward's distance and the kernels' tokens that are not the float64
      argmax printed.
    - The card's busy share under the profiler.

    Returns (launches, summary)."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config

    cfg = get_config("mamba2-130m").replace(dtype="float32", eos_token_id=-1)
    Rec = make_recording_model(Model)
    kern = Rec(cfg, device="cuda", impl="auto")
    plain = Rec(cfg, device="cuda", impl="ref")
    params = kern.init(seed=0)
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (M2_R, M2_PROMPT))
    lens = np.full(M2_R, M2_PROMPT)
    state = {k: math.prod(s) * torch.tensor([], dtype=d).element_size()
             for k, (s, d) in kern.cache_shapes(1, M2_PROMPT + M2_GEN)["groups"]["0_ssd"]
             .items()}
    log(f"[serve_mamba2] {cfg.name}: {cfg.n_layers} ssd layers, d_model {cfg.d_model}, "
        f"d_inner {cfg.d_inner}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e6:.1f}M params, f32; {M2_R} requests of "
        f"{M2_PROMPT} tokens, {M2_GEN} generated each, through the dense-loop driver; a "
        f"request's state: h {state['h'] / 1e6:.1f} MB, conv {state['conv'] / 1e6:.2f} MB "
        f"over the {cfg.n_layers} layers")
    want = dense_expect(cfg, M2_GEN)   # one prefill, then M2_GEN - 1 decode steps
    kern.keep_all = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out_k, wall_k = timed_serve(DenseServe(kern, M2_GEN), params, prompts, lens)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    kern.keep_all = False
    n_pre = sum(c["mode"] == "prefill" for c in kern.calls)
    log(f"[serve_mamba2] kernels: {len(kern.calls)} forwards, {n_pre} prefills; launches "
        f"{launches}, expected {want}")
    if launches != want or (n_pre, len(kern.calls)) != (1, M2_GEN):
        raise AssertionError(f"serve_mamba2: launch counts {launches} != {want}, or "
                             f"{n_pre} prefills and {len(kern.calls)} forwards, not 1 and "
                             f"{M2_GEN}")

    ops.reset_launch_counts()
    out_r, wall_r = timed_serve(DenseServe(plain, M2_PLAIN_GEN), params, prompts, lens)
    if set(ops.launch_counts().values()) != {0}:
        raise AssertionError(f"serve_mamba2: the plain serve launched kernels: "
                             f"{ops.launch_counts()}")
    head = SimpleNamespace(calls=kern.calls[:M2_PLAIN_GEN])
    out_head = dict(out_k, tokens=out_k["tokens"][:, :M2_PLAIN_GEN], steps=M2_PLAIN_GEN)
    tie_at, worst, scale8 = compare_calls("serve_mamba2", head, plain, out_head, out_r,
                                          logit_tol=None)
    if not worst <= M2_LOGIT_TOL:
        raise AssertionError(f"serve_mamba2: decode logits differ by {worst} "
                             f"(|logit| <= {scale8}), past {M2_LOGIT_TOL}")
    # the B1-alone control over the same forwards
    ctrl = Rec(cfg, device="cuda", impl="ref")
    plain_rms = ops.fused_rmsnorm
    ops.fused_rmsnorm = lambda x, gain, *, eps=1e-6, impl="auto": plain_rms(
        x, gain, eps=eps, impl="kernel")
    try:
        DenseServe(ctrl, M2_PLAIN_GEN).serve(params, prompts, lens)
    finally:
        ops.fused_rmsnorm = plain_rms
    worst_c = 0.0
    for ck, cr in zip(ctrl.calls, plain.calls):
        if ck["rows"] is not None:
            worst_c = max(worst_c, (ck["rows"] - cr["rows"]).abs().max().item())
        if not torch.equal(ck["arg"], cr["arg"]):
            break   # later rows would see other tokens
    del ctrl
    n_tok = M2_R * M2_GEN
    log(f"[serve_mamba2] kernels: {n_tok} tokens in {wall_k:.3f} s ({n_tok / wall_k:.1f} "
        f"tok/s), peak memory {peak:.2f} GiB; plain, the first {M2_PLAIN_GEN} forwards: "
        f"{M2_R * M2_PLAIN_GEN} tokens in {wall_r:.3f} s; greedy tokens identical: "
        f"{tie_at is None}; first 8 decode steps' logits max abs diff {worst:.3g} at "
        f"|logit| <= {scale8:.3g} (held at {M2_LOGIT_TOL}); control, the plain versions but "
        f"B1 on the card: {worst_c:.3g}")

    got = torch.stack(kern.all_rows[:M2_GEN], dim=1)           # (R, 256, V)
    kern.all_rows.clear()
    seq = torch.as_tensor(np.concatenate([prompts, out_k["tokens"].numpy()], axis=1),
                          device="cuda")
    rows = torch.arange(M2_PROMPT - 1, M2_PROMPT + M2_GEN - 1, device="cuda")
    m64 = Model(cfg.replace(dtype="float64"), device="cuda", impl="ref")
    p64 = {k: v.double() for k, v in params.items()}
    with torch.no_grad():
        full, _ = kern.forward(params, seq, readout=rows)
        exact, _ = m64.forward(p64, seq, readout=rows)
        # the same decode in float64 over the served tokens (a step's time
        # is the host's, ~40 ms)
        last, cache = m64.prefill(p64, seq[:, :M2_PROMPT], cache_len=M2_PROMPT + M2_GEN)
        dec64 = [last]
        for p in range(M2_PROMPT, M2_PROMPT + M2_GEN - 1):
            pos = torch.full((M2_R, 1), p, dtype=torch.int32, device="cuda")
            logits, cache = m64.decode_step(p64, seq[:, p:p + 1], pos, cache)
            dec64.append(logits[:, 0])
    dec64 = torch.stack(dec64, dim=1)
    del cache, m64, p64
    # the 8 held steps of both f32 serves against the float64 decode's (the
    # plain serve's up to a tie: past it its tokens are others)
    held = dict(kernel_from_f64=0.0, plain_from_f64=0.0)
    for i, (ck, cr) in enumerate(zip(kern.calls[:M2_PLAIN_GEN], plain.calls)):
        for key, c in (("kernel_from_f64", ck), ("plain_from_f64", cr)):
            if c["rows"] is not None and (key == "kernel_from_f64" or tie_at is None
                                          or i < tie_at):
                held[key] = max(held[key],
                                (c["rows"].double() - dec64[:, i]).abs().max().item())
    scale = exact.abs().max().item()
    err = dict(f64_decode=(dec64 - exact).abs().max().item(),
               f32_decode=(got.double() - exact).abs().max().item(),
               f32_decode_vs_f32_forward=(got - full).abs().max().item(),
               f32_forward=(full.double() - exact).abs().max().item())
    off_argmax = int((got.argmax(-1) != exact.argmax(-1)).sum())
    del got, full, exact, dec64
    torch.cuda.empty_cache()
    log(f"[serve_mamba2] against the same decode in float64: the first 8 decode steps' "
        f"logits max abs diff, the kernels {held['kernel_from_f64']:.3g}, the plain "
        f"versions {held['plain_from_f64']:.3g} (held at {M2_LOGIT_TOL})")
    log(f"[serve_mamba2] decode against one chunked forward in float64 over the "
        f"{seq.shape[1]} tokens of prompt and output ({M2_R} x {M2_GEN} rows, |logit| <= "
        f"{scale:.3g}), max abs diff over max |logit|: the same decode in float64 "
        f"{err['f64_decode'] / scale:.3g} (held at {M2_DECODE_BAR}), the kernels' f32 "
        f"decode {err['f32_decode'] / scale:.3g} (held at {M2_F32_DECODE_BAR}); not held: "
        f"the kernels' decode against the f32 forward "
        f"{err['f32_decode_vs_f32_forward'] / scale:.3g}, the f32 forward "
        f"{err['f32_forward'] / scale:.3g}; {off_argmax} of the kernels' "
        f"{M2_R * M2_GEN} tokens are not the float64 forward's argmax (printed)")
    if not (err["f64_decode"] <= M2_DECODE_BAR * scale
            and err["f32_decode"] <= M2_F32_DECODE_BAR * scale
            and max(held.values()) <= M2_LOGIT_TOL):
        raise AssertionError(f"serve_mamba2: decode logits off the float64 ones: {err}, "
                             f"the held steps {held} (|logit| <= {scale})")

    wall_ms, busy, n_launch, top = busy_profile(
        lambda: DenseServe(kern, G2_PROFILED).serve(params, prompts[:3], lens[:3]))
    log(f"[serve_mamba2] under the profiler, 3 requests x {G2_PROFILED} tokens: "
        f"{wall_ms:.0f} ms, card busy {busy:.1f} ms ({busy / wall_ms:.1%}), {n_launch} "
        f"launches; top {top}")
    summary = dict(requests=M2_R, steps=M2_GEN, prefills=n_pre, decode_steps=M2_GEN - 1,
                   tokens=n_tok, wall_s=wall_k, tok_per_s=n_tok / wall_k, peak_gib=peak,
                   plain_forwards=M2_PLAIN_GEN, plain_wall_s=wall_r,
                   logit_max_abs_diff=worst, logit_scale=scale8, logit_tol=M2_LOGIT_TOL,
                   tie=tie_at, logit_max_abs_diff_b1_alone=worst_c, float64=held,
                   decode_vs_forward_scale=scale,
                   decode_vs_forward_rel={k: v / scale for k, v in err.items()},
                   tokens_off_float64_argmax=off_argmax, profile_wall_ms=wall_ms,
                   busy_ms=busy, busy_share=busy / wall_ms, profile_launches=n_launch,
                   top_kernels=top, forwards=M2_GEN, state_h_bytes=state["h"],
                   state_conv_bytes=state["conv"], params_m=n_params / 1e6)
    return launches, summary


# serve_recurrentgemma: requests, prompt tokens and tokens generated each:
# prompt plus output is 2,080, so the local layers' ring of 2,048 wraps at
# decode step 128.  Cut from 4 requests and 256 tokens (and the train
# phases' loops from 3 steps to 2) for the script's time: 945 s with them on
# an H100 80GB HBM3 at 700.00 W whose nvcc built the sources in 59.3 s
RG_R, RG_PROMPT, RG_GEN = 2, 1920, 160
# the plain serve: the prefill and the 8 decode steps whose logits are held
RG_PLAIN_GEN = 9
# the kernels' first 8 decode steps' logits against the plain versions', as
# an absolute distance, within this factor of a control's: the plain serve
# with B1's plain version replaced by F.rms_norm (the same function rounded
# another way; B1 is the only kernel on this path, so a B1-alone control
# would be the path itself)
RG_CONTROL_FACTOR = 3.0
# decode against one f32 forward over the same tokens at full depth, the
# largest gap over max |logit|: the reference's bar (tests/test_smoke_archs.py)
RG_DECODE_BAR = 1e-4
# the float64 witness at 5 layers (the first group and the tail): decode
# against forward in float64, and the same in f32 at the reference's bar
RG_WITNESS_LAYERS = 5
RG_F64_BAR = 1e-9
# decode steps under the profiler (the card's busy share while decoding)
RG_PROFILED = 16


def rg_forward_rows(model, params, seq, P):
    """One forward over the token rows ``seq`` (B, T), read out at rows
    P-1..T-2: the logits that pick tokens P..T-1."""
    rows = torch.arange(P - 1, seq.shape[1] - 1, device=seq.device)
    with torch.no_grad():
        return model.forward(params, seq, readout=rows)[0]


def rg_decode_vs_forward(model, params, seq, P):
    """(decode rows, forward rows) of ``model`` on the token rows ``seq``
    (B, T): a prefill of the first P tokens, then decode_step at positions
    P..T-2 with the given tokens (teacher-forced), against rg_forward_rows."""
    B, T = seq.shape
    full = rg_forward_rows(model, params, seq, P)
    with torch.no_grad():
        last, cache = model.prefill(params, seq[:, :P], cache_len=T)
        dec = [last]
        for p in range(P, T - 1):
            pos = torch.full((B, 1), p, dtype=torch.int32, device=seq.device)
            logits, cache = model.decode_step(params, seq[:, p:p + 1], pos, cache)
            dec.append(logits[:, 0])
    return torch.stack(dec, dim=1), full


def recurrentgemma_serve_phase(Model, ops):
    """serve_recurrentgemma: recurrentgemma-9b (configs/recurrentgemma_9b.py,
    arXiv:2402.19427) whole, all 38 layers at full width, f32 weights from
    seed 0 and a random query projection, through the dense-loop driver the
    serve CLI falls back to: RG_R requests of RG_PROMPT tokens, RG_GEN
    generated each, greedy, no stop token.

    - The kernels' serve: exact launches (B1 77 a forward, 160 forwards:
      12,320; nothing else), tok/s, the prefill's time and a decode step's,
      peak memory.
    - The plain versions' serve over its first RG_PLAIN_GEN forwards: the
      same greedy tokens by the near-tie rule (compare_calls), the 8 held
      decode steps' logits within RG_CONTROL_FACTOR times the control's
      distance (the plain serve with B1's plain version replaced by
      F.rms_norm).
    - Decode against forward at full depth: the kernels' RG_GEN picking rows
      (the prefill's last row, then the decode steps) against one f32
      forward over the 2,080 tokens of prompt and output, within
      RG_DECODE_BAR of max |logit|.
    - The float64 witness at RG_WITNESS_LAYERS layers (the same weights'
      first group and tail), request 0's tokens: the plain decode against
      the plain forward in float64 within RG_F64_BAR, the kernels' f32
      decode against their f32 forward within RG_DECODE_BAR, and the f32
      decode's distance from the float64 forward printed.
    - The card's busy share over RG_PROFILED decode steps.

    Returns (launches, summary)."""
    from types import SimpleNamespace

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.meta import flatten_tree

    cfg = get_config("recurrentgemma-9b").replace(dtype="float32", eos_token_id=-1,
                                                  zero_init_query=False)
    Rec = make_recording_model(Model)
    kern = Rec(cfg, device="cuda", impl="auto")
    plain = Rec(cfg, device="cuda", impl="ref")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = kern.init(seed=0)
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (RG_R, RG_PROMPT))
    lens = np.full(RG_R, RG_PROMPT)
    T = RG_PROMPT + RG_GEN
    # a request's dense cache, leaf by leaf: {dotted name: (shape, dtype)}
    spec = flatten_tree(kern.cache_shapes(1, T),
                        lambda x: isinstance(x, tuple) and isinstance(x[0], tuple))
    state = {what: sum(math.prod(shape) * torch.tensor([], dtype=dt).element_size()
                       for name, (shape, dt) in spec.items() if part in name)
             for what, part in (("h", ".mixer.h"), ("conv", ".mixer.conv"),
                                ("rings", ".attn."))}
    log(f"[serve_recurrentgemma] {cfg.name}: {cfg.n_layers} layers ({cfg.pattern} x "
        f"{cfg.n_groups} + tail {cfg.tail}), d_model {cfg.d_model}, RG-LRU width "
        f"{cfg.lru_width}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, window "
        f"{cfg.window_size}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B "
        f"params by the metas ({4 * n_params / 1e9:.1f} GB f32), param_count() "
        f"{cfg.param_count() / 1e9:.3f} B (the reference's formula leaves out w_a and w_x); "
        f"{RG_R} requests of {RG_PROMPT} tokens, {RG_GEN} generated each, through the "
        f"dense-loop driver; a request's state: h {state['h'] / 1e3:.0f} KB, conv "
        f"{state['conv'] / 1e6:.2f} MB, rings {state['rings'] / 1e6:.1f} MB")
    want = dense_expect(cfg, RG_GEN)   # one prefill, then RG_GEN - 1 decode steps
    timing = {}
    real_prefill = kern.prefill

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_prefill(*a, **kw)
        torch.cuda.synchronize()
        timing["prefill_s"] = time.perf_counter() - t
        return out

    kern.prefill = timed_prefill
    kern.keep_all = True
    ops.reset_launch_counts()
    out_k, wall_k = timed_serve(DenseServe(kern, RG_GEN), params, prompts, lens)
    launches = ops.launch_counts()
    del kern.prefill
    peak = torch.cuda.max_memory_allocated() / 2**30
    kern.keep_all = False
    n_pre = sum(c["mode"] == "prefill" for c in kern.calls)
    log(f"[serve_recurrentgemma] kernels: {len(kern.calls)} forwards, {n_pre} prefills; "
        f"launches {launches}, expected {want}")
    if launches != want or (n_pre, len(kern.calls)) != (1, RG_GEN):
        raise AssertionError(f"serve_recurrentgemma: launch counts {launches} != {want}, "
                             f"or {n_pre} prefills and {len(kern.calls)} forwards, not 1 "
                             f"and {RG_GEN}")
    n_tok = RG_R * RG_GEN
    step_ms = 1e3 * (wall_k - timing["prefill_s"]) / (RG_GEN - 1)

    ops.reset_launch_counts()
    out_r, wall_r = timed_serve(DenseServe(plain, RG_PLAIN_GEN), params, prompts, lens)
    if set(ops.launch_counts().values()) != {0}:
        raise AssertionError(f"serve_recurrentgemma: the plain serve launched kernels: "
                             f"{ops.launch_counts()}")
    head = SimpleNamespace(calls=kern.calls[:RG_PLAIN_GEN])
    out_head = dict(out_k, tokens=out_k["tokens"][:, :RG_PLAIN_GEN], steps=RG_PLAIN_GEN)
    tie_at, worst, scale8 = compare_calls("serve_recurrentgemma", head, plain, out_head,
                                          out_r, logit_tol=None)
    # the control: the plain serve again, B1's plain version replaced by
    # F.rms_norm over the same (1 + gain)
    ctrl = Rec(cfg, device="cuda", impl="ref")
    plain_rms = ops.fused_rmsnorm
    ops.fused_rmsnorm = lambda x, gain, *, eps=1e-6, impl="auto": F.rms_norm(
        x, (x.shape[-1],), weight=(1 + gain).to(x.dtype), eps=eps)
    try:
        DenseServe(ctrl, RG_PLAIN_GEN).serve(params, prompts, lens)
    finally:
        ops.fused_rmsnorm = plain_rms
    worst_c = 0.0
    for ck, cr in zip(ctrl.calls, plain.calls):
        if ck["rows"] is not None:
            worst_c = max(worst_c, (ck["rows"] - cr["rows"]).abs().max().item())
        if not torch.equal(ck["arg"], cr["arg"]):
            break   # later rows would see other tokens
    del ctrl
    log(f"[serve_recurrentgemma] kernels: {n_tok} tokens in {wall_k:.3f} s "
        f"({n_tok / wall_k:.1f} tok/s); the prefill {timing['prefill_s']:.3f} s, a decode "
        f"step {step_ms:.2f} ms; peak memory {peak:.2f} GiB; plain, the first "
        f"{RG_PLAIN_GEN} forwards: {RG_R * RG_PLAIN_GEN} tokens in {wall_r:.3f} s; greedy "
        f"tokens identical: {tie_at is None}; the first 8 decode steps' logits, kernels "
        f"against plain, max abs diff {worst:.3g} at |logit| <= {scale8:.3g}; the control "
        f"(F.rms_norm for B1's plain version) {worst_c:.3g} (held at "
        f"{RG_CONTROL_FACTOR:g}x: {RG_CONTROL_FACTOR * worst_c:.3g})")
    if not worst <= RG_CONTROL_FACTOR * worst_c:
        raise AssertionError(f"serve_recurrentgemma: decode logits differ by {worst} "
                             f"(|logit| <= {scale8}), past {RG_CONTROL_FACTOR} x the "
                             f"control's {worst_c}")

    got = torch.stack(kern.all_rows[:RG_GEN], dim=1)            # (R, RG_GEN, V)
    kern.all_rows.clear()
    seq = torch.as_tensor(np.concatenate([prompts, out_k["tokens"].numpy()], axis=1),
                          device="cuda")
    full = rg_forward_rows(kern, params, seq, RG_PROMPT)
    scale = full.abs().max().item()
    err_full = (got - full).abs().max().item()
    off_argmax = int((got.argmax(-1) != full.argmax(-1)).sum())
    del got, full
    torch.cuda.empty_cache()
    log(f"[serve_recurrentgemma] decode against one f32 forward over the {T} tokens of "
        f"prompt and output, all {cfg.n_layers} layers ({RG_R} x {RG_GEN} rows, |logit| <= "
        f"{scale:.3g}): max abs diff over max |logit| {err_full / scale:.3g} (held at "
        f"{RG_DECODE_BAR}); {off_argmax} picked tokens not the forward's argmax")
    if not err_full <= RG_DECODE_BAR * scale:
        raise AssertionError(f"serve_recurrentgemma: decode off the forward by "
                             f"{err_full / scale} of max |logit| {scale}")

    # the card's busy share over decode steps (a short prompt's prefill
    # outside the profiler)
    dec_model = Model(cfg, device="cuda", impl="auto")
    pt = torch.as_tensor(prompts[:, :64], device="cuda")
    with torch.no_grad():
        last, cache = dec_model.prefill(params, pt, cache_len=64 + RG_PROFILED)
        tok = last.argmax(-1).to(torch.int32)[:, None]

        def steps():
            nonlocal tok, cache
            for i in range(RG_PROFILED):
                pos = torch.full((RG_R, 1), 64 + i, dtype=torch.int32, device="cuda")
                logits, cache = dec_model.decode_step(params, tok, pos, cache)
                tok = logits[:, 0].argmax(-1).to(torch.int32)[:, None]

        wall_ms, busy, n_launch, top = busy_profile(steps)
    del cache, dec_model
    log(f"[serve_recurrentgemma] under the profiler, {RG_PROFILED} decode steps of "
        f"{RG_R} requests: {wall_ms:.0f} ms, card busy {busy:.1f} ms ({busy / wall_ms:.1%}), "
        f"{n_launch} launches; top {top}")

    # the witness at RG_WITNESS_LAYERS layers: the first group and the tail
    # of the same weights, request 0
    cfg5 = cfg.replace(n_layers=RG_WITNESS_LAYERS)
    p5 = {k: (v[:cfg5.n_groups].clone() if k.startswith("groups.") else v)
          for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    n5 = sum(v.numel() for v in p5.values())
    seq0 = seq[:1]
    k5 = Model(cfg5, device="cuda", impl="auto")
    dec32, full32 = rg_decode_vs_forward(k5, p5, seq0, RG_PROMPT)
    p64 = {k: v.double() for k, v in p5.items()}
    del p5
    m64 = Model(cfg5.replace(dtype="float64"), device="cuda", impl="ref")
    dec64, full64 = rg_decode_vs_forward(m64, p64, seq0, RG_PROMPT)
    del p64
    s5 = full64.abs().max().item()
    err5 = dict(f64_decode=(dec64 - full64).abs().max().item() / s5,
                f32_decode=(dec32 - full32).abs().max().item() / s5,
                f32_decode_from_f64=(dec32.double() - full64).abs().max().item() / s5,
                f32_forward_from_f64=(full32.double() - full64).abs().max().item() / s5)
    del dec32, full32, dec64, full64
    torch.cuda.empty_cache()
    log(f"[serve_recurrentgemma] the witness at {RG_WITNESS_LAYERS} layers ({n5 / 1e9:.2f} B "
        f"params), request 0, decode against forward over max |logit| {s5:.3g}: float64 "
        f"{err5['f64_decode']:.3g} (held at {RG_F64_BAR}), the kernels' f32 "
        f"{err5['f32_decode']:.3g} (held at {RG_DECODE_BAR}); not held: the f32 decode "
        f"from the float64 forward {err5['f32_decode_from_f64']:.3g}, the f32 forward "
        f"{err5['f32_forward_from_f64']:.3g}")
    if not (err5["f64_decode"] <= RG_F64_BAR and err5["f32_decode"] <= RG_DECODE_BAR):
        raise AssertionError(f"serve_recurrentgemma: the {RG_WITNESS_LAYERS}-layer "
                             f"witness off: {err5}")
    summary = dict(requests=RG_R, prompt=RG_PROMPT, steps=RG_GEN, prefills=n_pre,
                   decode_steps=RG_GEN - 1, tokens=n_tok, wall_s=wall_k,
                   tok_per_s=n_tok / wall_k, prefill_s=timing["prefill_s"],
                   decode_step_ms=step_ms, peak_gib=peak, plain_forwards=RG_PLAIN_GEN,
                   plain_wall_s=wall_r, logit_max_abs_diff=worst, logit_scale=scale8,
                   control_max_abs_diff=worst_c, control_factor=RG_CONTROL_FACTOR,
                   tie=tie_at, decode_vs_forward_rel=err_full / scale,
                   decode_vs_forward_scale=scale, tokens_off_forward_argmax=off_argmax,
                   witness_layers=RG_WITNESS_LAYERS, witness=err5, witness_scale=s5,
                   profile_wall_ms=wall_ms, busy_ms=busy, busy_share=busy / wall_ms,
                   profile_launches=n_launch, top_kernels=top, forwards=RG_GEN,
                   params_b=n_params / 1e9, param_count_b=cfg.param_count() / 1e9,
                   state_h_bytes=state["h"], state_conv_bytes=state["conv"],
                   state_ring_bytes=state["rings"])
    return launches, summary


def dense_serve_phase(cfg, Model, Engine, EngineConfig, ops):
    """serve_dense: smollm-135m at SERVE_DEPTH through the dense-loop driver
    (``generate``) against the static engine on the same full-width prompts
    and weights: the same greedy tokens request by request under the
    near-tie rule (greedy_agree) -- the port's version of the reference's
    engine-against-the-dense-oracle test, at full width on the card.  Exact
    launches (B1 2L + 1 a forward; no B8 or B9: the dense driver attends in
    plain PyTorch); tok/s of both.  Returns (launches, summary)."""
    Rec = make_recording_model(Model)
    kern = Rec(cfg, device="cuda", impl="auto")
    params = kern.init(seed=0)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (DENSE_R, DENSE_PROMPT))
    lens = np.full(DENSE_R, DENSE_PROMPT)
    ops.reset_launch_counts()
    out_d, wall_d = timed_serve(DenseServe(kern, DENSE_GEN), params, prompts, lens)
    launches = ops.launch_counts()
    want = dense_expect(cfg, DENSE_GEN)
    log(f"[serve_dense] {cfg.name} at {cfg.n_layers} layers: {DENSE_R} requests of "
        f"{DENSE_PROMPT} tokens, {DENSE_GEN} generated each; {len(kern.calls)} forwards; "
        f"launches {launches}, expected {want}")
    if launches != want or len(kern.calls) != DENSE_GEN:
        raise AssertionError(f"serve_dense: launch counts {launches} != {want} "
                             f"({len(kern.calls)} forwards)")
    ecfg = EngineConfig(n_slots=4, page_size=16, max_prompt_len=DENSE_PROMPT,
                        max_gen_len=DENSE_GEN)
    out_e, wall_e = timed_serve(Engine(Model(cfg, device="cuda"), ecfg), params, prompts,
                                lens)
    oracle = Model(cfg, device="cuda", impl="ref")
    ties = greedy_agree("serve_dense", oracle, params, prompts, lens, out_d, out_e)
    n_tok = DENSE_R * DENSE_GEN
    log(f"[serve_dense] the dense driver: {n_tok} tokens in {wall_d:.3f} s "
        f"({n_tok / wall_d:.1f} tok/s); the static engine: {int(out_e['lengths'].sum())} "
        f"tokens in {wall_e:.3f} s ({int(out_e['lengths'].sum()) / wall_e:.1f} tok/s); "
        f"greedy tokens equal request by request, {ties} parted at a near-tie")
    return launches, dict(requests=DENSE_R, prompt=DENSE_PROMPT, gen=DENSE_GEN,
                          tokens=n_tok, wall_s=wall_d, tok_per_s=n_tok / wall_d,
                          engine_wall_s=wall_e,
                          engine_tok_per_s=int(out_e["lengths"].sum()) / wall_e,
                          ties=ties)


SPEC_K = 4                 # the serve CLI's --draft-k default
# smollm's serve paths run 15 of its 30 layers at full width: a cut of
# depth that holds the run's time (the speculative paths' since the gemma2
# phases came, the others' since the sweep_amp phase came)
SERVE_DEPTH = 15
# Adam's lr on the copy task: the reference's 1e-2 diverges at smollm-135m's
# full width and vocabulary; 1e-4 trains both models best of 1e-2 .. 3e-5
# (scripts/torch_copy_lr_probe.py)
COPY_LR = 1e-4
SPEC_VERIFY_ROWS = 4       # verify forwards whose full logits are held


def make_spec_recorder(Model):
    class SpecRecording(Model):
        """Keeps, for every forward an engine runs, its mode and width and
        the top-2 logits of every row it may sample from (a prefill's or a
        chunk's one row read out; every row of another decode forward at a
        position >= 0), and
        the full logits of those rows in the first SPEC_VERIFY_ROWS forwards
        of width SPEC_K + 1 (the target's verify chunks).  Forwards without
        positions (the tie oracle's) are not recorded."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.calls = []
            self.n_wide = 0

        def forward(self, params, tokens, positions=None, mode="train", **kw):
            logits, cache = super().forward(params, tokens, positions=positions,
                                            mode=mode, **kw)
            if positions is None:
                return logits, cache
            T = tokens.shape[1]
            if kw.get("readout") is not None:
                rows = logits[:, -1]       # the one row the engine read out
            elif mode == "prefill":
                rows = logits[:, int((positions[0] < positions.shape[1]).sum()) - 1]
            else:
                rows = logits[positions >= 0]
            top2 = rows.float().topk(2, dim=-1)
            keep = mode == "decode" and T == SPEC_K + 1 and self.n_wide < SPEC_VERIFY_ROWS
            self.n_wide += keep
            self.calls.append(dict(mode=mode, T=T, top2=top2.values, arg=top2.indices[:, 0],
                                   rows=rows.clone() if keep else None))
            return logits, cache

        def clear(self):
            self.calls.clear()
            self.n_wide = 0

    return SpecRecording


def spec_forwards(target, drafter, CH=0):
    """Forward counts of one speculative serve from the recorders:
    (target prefills, target chunks of CH, verifies, drafter prefills,
    catch-ups, drafter steps).  Raises unless every iteration ran one
    catch-up and SPEC_K steps per verify and the target never decoded one
    token at a time."""
    count = lambda m, mode, T=None: sum(c["mode"] == mode and (T is None or c["T"] == T)
                                        for c in m.calls)
    n = (count(target, "prefill"), count(target, "decode", CH) if CH else 0,
         count(target, "decode", SPEC_K + 1), count(drafter, "prefill"),
         count(drafter, "decode", SPEC_K + 1), count(drafter, "decode", 1))
    other = count(target, "decode") - n[1] - n[2] + count(drafter, "decode") - n[4] - n[5]
    if other or n[4] != n[2] or n[5] != SPEC_K * n[2]:
        raise AssertionError(f"speculative forwards {n}, {other} of another width: not "
                             f"one catch-up and {SPEC_K} drafter steps per verify")
    return n


def spec_expect(Lt, Ld, n, int8=False):
    """Exact launch counts of a speculative serve of forward counts ``n``
    (spec_forwards): B8 for each drafter step's layers, B9 for each verify's
    and chunk's target layers and each catch-up's drafter layers, B1 twice a
    layer and once more per forward of each model, nothing else."""
    n_pre, n_chunk, n_ver, n_dpre, n_catch, n_step = n
    sfx = "_int8" if int8 else ""
    want = dict.fromkeys((*PORT_KERNELS, *GROUPED), 0)
    want["flash_decode" + sfx] = Ld * n_step
    want["flash_decode_multi" + sfx] = Lt * (n_ver + n_chunk) + Ld * n_catch
    want["rmsnorm"] = (2 * Lt + 1) * (n_pre + n_chunk + n_ver) + \
        (2 * Ld + 1) * (n_dpre + n_catch + n_step)
    return want


def compare_spec(what, kern, plain, out_k, out_r, logit_tol=SERVE_LOGIT_TOL):
    """Two speculative serves of one schedule, with the kernels and through
    the plain versions (each a (target, drafter) pair of recorders).  Every
    recorded row must give the same greedy token, unless the plain top-2 gap
    there is below TIE_GAP: a tie, after which the serves may part (a target
    tie moves tokens, a drafter tie acceptance and so steps).  With no tie,
    tokens, lengths, steps, accepted and proposed must be equal.  The first
    verify chunks' logits within atol = rtol = ``logit_tol`` (None:
    measured, not held).  Returns (tie, worst logit diff, |logit| scale)."""
    tie = None
    for who, mk, mr in (("target", kern[0], plain[0]), ("drafter", kern[1], plain[1])):
        for i, (ck, cr) in enumerate(zip(mk.calls, mr.calls)):
            if (ck["mode"], ck["T"]) != (cr["mode"], cr["T"]) or \
                    ck["arg"].shape != cr["arg"].shape:
                raise AssertionError(f"{what}: {who} forward {i} differs in shape before "
                                     f"any tie")
            differ = (ck["arg"] != cr["arg"]).nonzero()
            if len(differ):
                j = int(differ[0, 0])
                gap = float(cr["top2"][j, 0] - cr["top2"][j, 1])
                if gap >= TIE_GAP:
                    raise AssertionError(f"{what}: {who} forward {i} ({cr['mode']}, "
                                         f"T={cr['T']}) row {j}: greedy token differs, "
                                         f"plain top-2 gap {gap}")
                log(f"[{what}] tie: {who} forward {i} ({cr['mode']}, T={cr['T']}) row {j}, "
                    f"plain top-2 gap {gap:.3g} < {TIE_GAP}; later tokens and steps may "
                    f"differ")
                tie = (who, i)
                break
        if tie:
            break
    if tie is None:
        for key in ("tokens", "lengths"):
            if not torch.equal(out_k[key], out_r[key]):
                raise AssertionError(f"{what}: {key} differ with and without the kernels")
        same = [(out_k[k], out_r[k]) for k in ("steps", "accepted", "proposed")]
        if any(a != b for a, b in same) or len(kern[0].calls) != len(plain[0].calls) \
                or len(kern[1].calls) != len(plain[1].calls):
            raise AssertionError(f"{what}: steps / accepted / proposed / forwards differ: "
                                 f"{same}")
    worst = excess = scale = 0.0
    for ck, cr in zip(kern[0].calls, plain[0].calls):
        if tie is not None or ck["rows"] is None:
            continue
        diff = (ck["rows"] - cr["rows"]).abs()
        worst = max(worst, diff.max().item())
        scale = max(scale, cr["rows"].abs().max().item())
        if logit_tol is not None:
            excess = max(excess, (diff - logit_tol * (1 + cr["rows"].abs())).max().item())
    if not excess <= 0:
        raise AssertionError(f"{what}: verify logits differ by {worst} (|logit| <= {scale})")
    return tie, worst, scale


def spec_pair(Rec, cfg, dcfg, impl):
    """(target, drafter) recorders of ``cfg`` and its drafter ``dcfg``."""
    return (Rec(cfg, device="cuda", impl=impl), Rec(dcfg, device="cuda", impl=impl))


def timed_serve(engine, *args, **kw):
    """(out, wall seconds) of one serve, the card synchronised after it."""
    t0 = time.perf_counter()
    out = engine.serve(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def spec_serve_run(what, Rec, cfg, dcfg, params, dparams, prompts, lens, make, ops, CH=0,
                   int8=False):
    """One speculative serve through the kernels and one through the plain
    versions (``make(target, drafter)`` builds the engine): exact launch
    counts from the recorded forwards, then compare_spec (verify logits held
    at SERVE_LOGIT_TOL over f32 pools, measured over int8 ones).  No
    warm-up: the serve phases before this one ran the same kernels and
    cuBLAS calls.  Returns (launches, kernel serve, plain serve, walls,
    forward counts)."""
    kern, plain = spec_pair(Rec, cfg, dcfg, "auto"), spec_pair(Rec, cfg, dcfg, "ref")
    ops.reset_launch_counts()
    out_k, wall_k = timed_serve(make(*kern), params, prompts, lens, draft_params=dparams)
    launches = ops.launch_counts()
    n = spec_forwards(*kern, CH)
    want = spec_expect(cfg.n_layers, dcfg.n_layers, n, int8)
    log(f"[{what}] kernels: {out_k['steps']} steps, forwards (target prefill, chunk, "
        f"verify; drafter prefill, catch-up, step) {n}; launches {launches}, expected "
        f"{want}")
    if launches != want:
        raise AssertionError(f"{what}: launch counts {launches} != {want}")
    ops.reset_launch_counts()
    out_r, wall_r = timed_serve(make(*plain), params, prompts, lens, draft_params=dparams)
    if set(ops.launch_counts().values()) != {0}:
        raise AssertionError(f"{what}: the plain serve launched kernels")
    tie, worst, scale = compare_spec(what, kern, plain, out_k, out_r,
                                     None if int8 else SERVE_LOGIT_TOL)
    n_tok = int(out_k["lengths"].sum())
    log(f"[{what}] (a) kernels: {n_tok} tokens in {wall_k:.3f} s ({n_tok / wall_k:.1f} "
        f"tok/s), {out_k['accepted']}/{out_k['proposed']} drafts accepted; plain "
        f"{wall_r:.3f} s ({int(out_r['lengths'].sum()) / wall_r:.1f} tok/s); tie: {tie}; "
        f"first {SPEC_VERIFY_ROWS} verify chunks' logits max abs diff {worst:.3g} at "
        f"|logit| <= {scale:.3g} ({'measured' if int8 else 'atol = rtol = 1e-4'})")
    return launches, out_k, out_r, (wall_k, wall_r), n


def busy_profile(fn):
    """(wall ms, card busy ms, kernel launches, top 5 kernels) of ``fn``
    under torch.profiler, the card's events only (host events would
    multiply its post-processing, ~58 s against ~10 s for one copy-task
    serve)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return wall, busy, sum(e.count for e in kernels), [
        (e.key[:60], e.self_device_time_total / 1e3, e.count) for e in top]


def serve_spec_phase(cfg, Model, Engine, DynamicEngine, EngineConfig, ops):
    """Speculative decoding on smollm-135m at full width (f32 weights from
    seed 0, ``zero_init_query=False``), checks (a)-(e) of the module
    docstring.  Returns ({path: launches}, summary)."""
    from repro_torch.core.transfer import make_proxy
    from repro_torch.data.copy_task import copy_batch, train_copy

    Rec = make_spec_recorder(Model)
    Lt = cfg.n_layers
    params = Model(cfg, device="cuda").init(seed=0)
    oracle = Model(cfg, device="cuda", impl="ref")
    paths, summary = {}, {}

    # (1) the static engine, the serve CLI's --draft-width 0.25 drafter
    dcfg = cfg.scaled(0.25, min_d_head=8)
    dparams = Model(dcfg, device="cuda").init(seed=7)
    R, S, Pmax, Gmax, P = 4, 4, 128, 32, 16
    rng = np.random.default_rng(0)
    lens = rng.integers(64, Pmax + 1, R)
    prompts = rng.integers(0, cfg.vocab_size, (R, Pmax))
    kw = dict(n_slots=S, page_size=P, max_prompt_len=Pmax, max_gen_len=Gmax)
    log(f"[serve_spec] drafter {dcfg.name}: {dcfg.n_layers} layers, d_model {dcfg.d_model}, "
        f"{dcfg.n_heads}/{dcfg.n_kv_heads} heads of {dcfg.d_head}, random weights (seed 7); "
        f"static engine, {R} requests, prompt lens {lens.tolist()}, {Gmax} tokens each, "
        f"{S} slots, draft_k {SPEC_K}")
    make = lambda t, d: Engine(t, EngineConfig(**kw, draft_k=SPEC_K), draft_model=d)
    launches, out_k, out_r, walls, n = spec_serve_run(
        "serve_spec", Rec, cfg, dcfg, params, dparams, prompts, lens, make, ops)
    if n[2] != out_k["steps"] or n[0] != R or n[3] != R:
        raise AssertionError(f"serve_spec: forwards {n} against {out_k['steps']} steps")
    paths["serve_spec"] = launches
    base_model = Model(cfg, device="cuda")
    base, wall_b = timed_serve(Engine(base_model, EngineConfig(**kw)), params, prompts, lens)
    ties = greedy_agree("serve_spec (c)", oracle, params, prompts, lens, out_k, base)
    n_tok = int(out_k["lengths"].sum())
    log(f"[serve_spec] (c) greedy tokens equal to the non-speculative static engine's "
        f"({ties} requests past a tie); it served {int(base['lengths'].sum())} tokens in "
        f"{wall_b:.3f} s ({int(base['lengths'].sum()) / wall_b:.1f} tok/s), {base['steps']} "
        f"steps; speculative {n_tok / walls[0]:.1f} tok/s, {out_k['steps']} steps")
    summary["static"] = dict(requests=R, steps=out_k["steps"], tokens=n_tok,
                             accepted=out_k["accepted"], proposed=out_k["proposed"],
                             wall_s=walls[0], plain_wall_s=walls[1], base_wall_s=wall_b,
                             base_steps=base["steps"], forwards=n, ties=ties)

    # (2) DynamicEngine with the adaptive draft length on serve_dynamic's
    # workload, over f32 and int8 pools
    R, Pmax, Gmax, CH = 8, 256, 16, 64
    prompts, lens = shared_prefix_workload(cfg.vocab_size, R, Pmax, seed=2)
    kw = dict(n_slots=S, page_size=P, max_prompt_len=Pmax, max_gen_len=Gmax)
    for name, kv in (("serve_spec_dynamic", ""), ("serve_spec_int8", "int8")):
        c, dc = cfg.replace(kv_dtype=kv), dcfg.replace(kv_dtype=kv)
        log(f"[{name}] DynamicEngine, {kv or 'f32'} pools, adaptive draft length from "
            f"{SPEC_K}: {R} requests of serve_dynamic's workload, prompt lens "
            f"{lens.tolist()}, {Gmax} tokens each, chunks of {CH}, prefix cache on")
        ecfg = EngineConfig(**kw, draft_k=SPEC_K, prefill_chunk=CH, prefix_cache=True,
                            adaptive_draft=True)
        make = lambda t, d: DynamicEngine(t, ecfg, draft_model=d)
        launches, out_k, out_r, walls, n = spec_serve_run(
            name, Rec, c, dc, params, dparams, prompts, lens, make, ops, CH=CH,
            int8=bool(kv))
        cached = out_k["prefill_cached"]
        want_chunks = int(sum(-(-int(x) // CH) for x in lens)) - cached // CH
        if n[0] or n[1] != want_chunks or n[3] != R or not cached:
            raise AssertionError(f"{name}: forwards {n}, chunk schedule {want_chunks} from "
                                 f"prefill_cached {cached}")
        paths[name] = launches
        base, wall_b = timed_serve(DynamicEngine(Model(c, device="cuda"), EngineConfig(
            **kw, prefill_chunk=CH, prefix_cache=True)), params, prompts, lens)
        if kv:
            # printed, not held: a rejected draft's k/v grows its page's
            # int8 scale, so the pools' bytes differ from the plain engine's
            ties = int(sum(not torch.equal(out_k["tokens"][r], base["tokens"][r])
                           for r in range(R)))
            agree = f"{R - ties} of {R} requests' greedy tokens equal (printed, not held)"
        else:
            ties = greedy_agree(f"{name} (c)", oracle, params, prompts, lens, out_k, base)
            agree = f"greedy tokens equal ({ties} requests past a tie)"
        n_tok = int(out_k["lengths"].sum())
        log(f"[{name}] (c) against the non-speculative dynamic engine: {agree}; "
            f"{n_tok / walls[0]:.1f} tok/s, {out_k['steps']} "
            f"steps against {int(base['lengths'].sum()) / wall_b:.1f} tok/s, "
            f"{base['steps']} steps; {out_k['accepted']}/{out_k['proposed']} drafts "
            f"accepted; {cached}/{out_k['prefill_total']} prompt tokens from shared pages")
        summary[name] = dict(requests=R, steps=out_k["steps"], tokens=n_tok,
                             accepted=out_k["accepted"], proposed=out_k["proposed"],
                             wall_s=walls[0], plain_wall_s=walls[1], base_wall_s=wall_b,
                             base_steps=base["steps"], forwards=n,
                             **{"requests_differ" if kv else "ties": ties},
                             prefill_cached=cached)

    # (3) acceptance on the copy task: the target and its depth-1 µP proxy
    # trained as the reference's benchmarks/perf_serve.py trains them
    pcfg = make_proxy(cfg, 0.125, depth=1, min_d_head=8)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    model, tparams, losses = train_copy(cfg, steps=100, batch=16, seq=32, seed=0,
                                        lr=COPY_LR)
    dmodel, pparams, dlosses = train_copy(pcfg, steps=150, batch=16, seq=32, seed=1,
                                          lr=COPY_LR)
    loss, dloss = losses[-1], dlosses[-1]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    want = dict.fromkeys((*PORT_KERNELS, *GROUPED), 0)
    want["rmsnorm"] = want["rmsnorm_bwd"] = (2 * Lt + 1) * 100 + (2 * pcfg.n_layers + 1) * 150
    want["ce_fwd"] = want["ce_bwd"] = 250
    log(f"[serve_spec_copy] trained the target 100 steps (loss {loss:.3g}) and "
        f"{pcfg.name} ({pcfg.n_layers} layer, d_model {pcfg.d_model}, {pcfg.n_heads}/"
        f"{pcfg.n_kv_heads} heads of {pcfg.d_head}) 150 steps (loss {dloss:.3g}) at batch "
        f"16 x seq 32 in {train_s:.1f} s; launches {launches}, expected {want}")
    if launches != want or not np.isfinite([loss, dloss]).all():
        raise AssertionError(f"copy-task training: launches {launches} != {want} or "
                             f"losses {loss}, {dloss}")
    paths["spec_copy_train"] = launches
    R, Pmax, Gmax, K6 = 8, 8, 48, 6
    prompts = copy_batch(np.random.RandomState(2), cfg.vocab_size, R, Pmax)
    lens = np.full(R, Pmax)
    kw = dict(n_slots=S, page_size=P, max_prompt_len=Pmax, max_gen_len=Gmax)
    base_eng = Engine(model, EngineConfig(**kw))
    spec_eng = Engine(model, EngineConfig(**kw, draft_k=K6), draft_model=dmodel)
    base_eng.serve(tparams, prompts, lens)                       # warm-up
    spec_eng.serve(tparams, prompts, lens, draft_params=pparams)
    ops.reset_launch_counts()
    out_s, _ = timed_serve(spec_eng, tparams, prompts, lens, draft_params=pparams)
    launches = ops.launch_counts()
    st = out_s["steps"]
    Lp = pcfg.n_layers
    want = dict.fromkeys((*PORT_KERNELS, *GROUPED), 0)
    want["flash_decode"] = Lp * K6 * st
    want["flash_decode_multi"] = (Lt + Lp) * st
    want["rmsnorm"] = (2 * Lt + 1) * (R + st) + (2 * Lp + 1) * (R + st * (1 + K6))
    log(f"[serve_spec_copy] kernels: {st} steps; launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"serve_spec_copy: launch counts {launches} != {want}")
    paths["serve_spec_copy"] = launches
    walls = {"base": [], "spec": []}
    for _ in range(3):
        out_b, w = timed_serve(base_eng, tparams, prompts, lens)
        walls["base"].append(w)
        out_s, w = timed_serve(spec_eng, tparams, prompts, lens, draft_params=pparams)
        walls["spec"].append(w)
    copy_oracle = Model(cfg, device="cuda", impl="ref")
    ties = greedy_agree("serve_spec_copy", copy_oracle, tparams, prompts, lens, out_s, out_b)
    n_tok = int(out_s["lengths"].sum())
    tb, ts = min(walls["base"]), min(walls["spec"])
    acc = out_s["accepted"] / max(out_s["proposed"], 1)
    # one wave of S requests under the profiler (its post-processing grows
    # with the launches)
    prof_b = busy_profile(lambda: base_eng.serve(tparams, prompts[:S], lens[:S]))
    prof_s = busy_profile(lambda: spec_eng.serve(tparams, prompts[:S], lens[:S],
                                                 draft_params=pparams))
    log(f"[serve_spec_copy] {R} requests, prompt {Pmax}, {Gmax} tokens each, {S} slots, "
        f"draft_k {K6}: acceptance {out_s['accepted']}/{out_s['proposed']} ({acc:.1%}); "
        f"speculative {n_tok / ts:.1f} tok/s ({out_s['steps']} steps) against "
        f"{n_tok / tb:.1f} tok/s ({out_b['steps']} steps): {tb / ts:.2f}x (best of 3 each); "
        f"greedy tokens equal ({ties} requests past a tie)")
    for label, (wall, busy, n_launch, top) in (("non-speculative", prof_b),
                                               ("speculative", prof_s)):
        log(f"[serve_spec_copy] {label}, {S} requests under the profiler: {wall:.1f} ms, "
            f"card busy "
            f"{busy:.2f} ms ({busy / wall:.1%}), {n_launch} kernel launches; top: "
            + "; ".join(f"{k} {ms:.2f} ms x{c}" for k, ms, c in top))
    summary["copy"] = dict(
        target_loss=loss, drafter_loss=dloss, drafter=pcfg.name, train_s=train_s,
        accepted=out_s["accepted"], proposed=out_s["proposed"], acceptance=acc,
        steps=out_s["steps"], base_steps=out_b["steps"], tokens=n_tok,
        tok_per_s=n_tok / ts, base_tok_per_s=n_tok / tb, speedup=tb / ts, walls_s=walls,
        ties=ties, profile=dict(base=prof_b[:3], spec=prof_s[:3]))
    return paths, summary


# the port's kernels, by the name of their __global__ function(s)
PORT_KERNELS = {
    "rmsnorm": ("rmsnorm_kernel<",),
    "rmsnorm_bwd": ("rmsnorm_bwd_kernel<",),
    "ce_fwd": ("ce_fwd_kernel<",),
    "ce_bwd": ("ce_bwd_kernel<",),
    "flash_decode": ("flash_decode_kernel<",),
    "flash_decode_multi": ("flash_decode_multi_kernel<",),
    "flash_decode_int8": ("flash_decode_kernel<",),
    "flash_decode_multi_int8": ("flash_decode_multi_kernel<",),
    "flash_fwd": ("flash_fwd_kernel<", "flash_fwd_tc_kernel<"),
    "flash_bwd_dq": ("flash_bwd_dq_kernel<", "flash_bwd_dq_tc_kernel<"),
    "flash_bwd_dkv": ("flash_bwd_dkv_kernel<", "flash_bwd_dkv_tc_kernel<"),
    "flash_fwd_int8": ("flash_fwd_i8_kernel<",),
    "flash_bwd_dq_int8": ("flash_bwd_dq_i8_kernel<",),
    "flash_bwd_dkv_int8": ("flash_bwd_dkv_i8_kernel<",),
    "flash_bwd_quant_int8": ("flash_quant_i8_kernel<",),
    "flash_fwd_quant_int8": ("flash_quant_fwd_i8_kernel<",),
}


# the int8-pool instantiations of B8 and B9 (TKV = int8_t) carry this in
# their demangled names (B8's as <TQ, signed char, WIDE>, B9's as <TQ,
# signed char, CV>); the B8/B9 rows named *_int8 are those, the others not
# (B5-B7's int8 mode has kernels of its own names)
INT8_KV = "signed char"


def is_kernel(name, key, event_key):
    """Whether a profiler event named ``event_key`` is a launch of the port
    kernel ``name`` through its key ``key``."""
    if not name.startswith("flash_decode"):
        return key in event_key
    return key in event_key and (INT8_KV in event_key) == name.endswith("_int8")


def port_kernel_times(kernels):
    """{kernel: (device ms in total, launches)} of the port's kernels among
    the profiler's CUDA events."""
    out = {}
    for name, keys in PORT_KERNELS.items():
        parts = {k: [e for e in kernels if is_kernel(name, k, e.key)] for k in keys}
        hits = [e for es in parts.values() for e in es]
        if not hits:
            continue
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        n = sum(e.count for e in hits)
        out[name] = (ms, n)
        split = "" if len(keys) == 1 else " = " + " + ".join(
            f"{k.rstrip('<(')} {sum(e.self_device_time_total for e in es) / 1e3:.3f} ms"
            for k, es in parts.items())
        log(f"[profile]   port kernel {name}: {ms:.3f} ms in {n} launches "
            f"({ms / n * 1e3:.2f} us each){split}")
    return out



@contextlib.contextmanager
def labelled(module, names):
    """While open, the functions ``names`` of ``module`` run inside a
    torch.profiler range of the same name (for the kernels they launch)."""
    from torch.profiler import record_function

    real = {n: getattr(module, n) for n in names}

    def wrap(n, fn):
        def run(*a, **kw):
            with record_function(n):
                return fn(*a, **kw)
        return run

    for n, fn in real.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(module, n, fn)


def profile_phase(cfg, Model, Engine, EngineConfig, dynamic=None, ranges=()):
    """Where a decode-heavy serve spends the card's time: torch.profiler over
    a short serve (4 requests x 16 tokens), device busy share and the
    kernels that take it.  ``dynamic`` = (DynamicEngine, prefill_chunk):
    the dynamic engine with chunked prefill and the prefix cache over 4
    requests that share a 128-token system prompt.  ``ranges``: functions
    of serving/kv_cache.py whose launches are summed under their own name
    (the int8 pools' quantized writes).  The profiler's own overhead
    inflates the wall; it traces the card's events only (as busy_profile)
    unless ``ranges`` need the host's, whose post-processing costs tens of
    seconds."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import kv_cache

    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (4, 128))
    lens = np.full(4, 128)
    kw = dict(n_slots=4, page_size=16, max_prompt_len=128, max_gen_len=16)
    if dynamic is None:
        make = lambda: Engine(model, EngineConfig(**kw))
    else:
        cls, chunk = dynamic
        prompts = np.concatenate([np.repeat(prompts[:1, :96], 4, 0), prompts[:, 96:]], 1)
        make = lambda: cls(model, EngineConfig(prefill_chunk=chunk, prefix_cache=True, **kw))
    make().serve(params, prompts, lens)          # warm-up
    engine = make()
    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU] if ranges else []) + [ProfilerActivity.CUDA]
    with labelled(kv_cache, ranges), profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = engine.serve(params, prompts, lens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    # a labelled range also shows on the device as an annotation spanning its
    # first to its last kernel, gaps included: not a kernel, left out
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and e.key not in ranges]
    busy_us = sum(e.self_device_time_total for e in kernels)
    tag = "" if dynamic is None else " (dynamic engine)"
    tag += f" ({cfg.kv_dtype} pools)" if cfg.kv_dtype else ""
    log(f"[profile] {out['steps']} steps{tag} in {wall_us / 1e3:.1f} ms under the "
        f"profiler; device busy {busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}), "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")
    extra = {} if dynamic is None else dict(prefill_cached=out["prefill_cached"],
                                            prefill_total=out["prefill_total"])
    for name in ranges:
        # the kernels launched by the range's ops (its own annotation aside)
        hits = [e for e in prof.events() if e.name == name and e.device_type != cuda]
        dev_ms = sum(c.device_time_total for e in hits for c in e.cpu_children) / 1e3
        calls = len(hits)
        host_ms = sum(e.cpu_time_total for e in hits) / 1e3
        log(f"[profile]   {name}: {calls} calls, {dev_ms:.3f} ms on the card "
            f"({dev_ms / max(busy_us / 1e3, 1e-9):.1%} of busy), {host_ms:.1f} ms "
            f"on the host under the profiler")
        extra[name] = dict(calls=calls, device_ms=dev_ms, host_ms=host_ms)
    return dict(steps=out["steps"], wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                launches=sum(e.count for e in kernels),
                port_kernels=port_kernel_times(kernels), **extra)



# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def models_attend_with(ops, attention):
    """While open, models call ``attention`` where they call ops.attention
    (None leaves it as it is)."""
    real = ops.attention
    if attention is not None:
        ops.attention = attention
    yield
    ops.attention = real


def plain_flash(ops, kv_heads=0):
    """Attention's kernel path over B5-B7's plain versions, which round where
    the kernels round (ops.attention_plain_flash); launches nothing.  With
    ``kv_heads``, a call takes that many kv heads and their query heads at
    a time: every rounding and quantization group lies within a head, so
    the outputs are the same, and a call's (S, S) tensors a fraction of
    the whole's (mixtral's 48 heads at S 4,608: 3.8 GiB a tensor)."""
    def attend(q, k, v, *, impl="auto", **kw):
        K = k.shape[2]
        if not kv_heads or kv_heads >= K:
            return ops.attention_plain_flash(q, k, v, **kw)
        G = q.shape[2] // K
        return torch.cat([ops.attention_plain_flash(
            q[:, :, i * G:(i + kv_heads) * G], k[:, :, i:i + kv_heads],
            v[:, :, i:i + kv_heads], **kw) for i in range(0, K, kv_heads)], dim=2)

    return attend


def mode_kernels(ops, policy):
    """B5-B7 in ``policy``'s operand mode whatever the model's: a control."""
    real = ops.attention
    return lambda q, k, v, *, impl="auto", policy=None, _p=policy, **kw: real(
        q, k, v, impl="kernel", policy=_p, **kw)


@contextlib.contextmanager
def recorded_routes():
    """While open, every models/moe.py ``route`` call appends (router
    logits, expert ids), detached, to the list it yields: one entry a MoE
    layer a forward, in layer order."""
    from repro_torch.models import moe as moe_lib

    sink, real = [], moe_lib.route

    def route(*a, **kw):
        out = real(*a, **kw)
        sink.append((out[0].detach(), out[2]))
        return out

    moe_lib.route = route
    try:
        yield sink
    finally:
        moe_lib.route = real


def train_routing(tag, cfg, routes_k, routes_p, tie=ROUTE_TIE):
    """A train step's expert choices, the kernels' (``routes_k``) against
    the plain side's, layer by layer over every token (a train batch has no
    padding): a row may take another set of k experts only where the plain
    probabilities of the k-th and (k+1)-th experts lie within ``tie``
    (mx_routing's near-tie rule), each flip printed with its margin.
    Returns the flips, the experts they touch by layer (both sides'
    choices at a flipped row: their capacity ranks shift, so their dropped
    slots may too), the smallest margin, the largest router probability
    difference on rows that did not flip, and the kernels' slots dropped
    past capacity."""
    from repro_torch.models import moe as moe_lib

    k, E = cfg.top_k, cfg.n_experts
    flips, touched, min_margin, noise, dropped, slots = [], {}, math.inf, 0.0, 0, 0
    if len(routes_k) != cfg.n_layers or len(routes_p) != cfg.n_layers:
        raise AssertionError(f"{tag} routed {len(routes_k)} / {len(routes_p)} layers, "
                             f"not {cfg.n_layers}")
    for layer, ((lk, ik), (lr, ir)) in enumerate(zip(routes_k, routes_p)):
        Bq, Sq = ik.shape[:2]
        valid = torch.ones(Bq, Sq, dtype=torch.bool, device=ik.device)
        differ, margin, dp = route_diff(k, lk, ik, lr, ir, valid)
        min_margin = min(min_margin, margin.min().item())
        noise = max(noise, dp)
        dropped += dropped_slots(ik, valid, E, moe_lib._capacity(cfg, Sq))
        slots += Bq * Sq * k
        for b, t in differ.nonzero().tolist():
            m = margin[b, t].item()
            flips.append(dict(layer=layer, row=[b, t], margin=m,
                              experts=ik[b, t].tolist(), plain=ir[b, t].tolist()))
            touched.setdefault(layer, set()).update(ik[b, t].tolist() + ir[b, t].tolist())
            log(f"{tag} routing flip: layer {layer}, token ({b}, {t}): experts "
                f"{ik[b, t].tolist()} against {ir[b, t].tolist()} plain, plain top-{k} "
                f"margin {m:.3g} (the near-tie limit {tie:.3g})")
            if not m < tie:
                raise AssertionError(f"{tag} expert choice differs at layer {layer} token "
                                     f"({b}, {t}), margin {m} >= {tie}")
    log(f"{tag} routing: {slots // k} tokens x {len(routes_k)} layer(s) compared, "
        f"{len(flips)} flip(s); smallest plain top-{k} margin {min_margin:.3g}; largest "
        f"router probability difference on rows that did not flip {noise:.3g}; slots "
        f"dropped past capacity (C {moe_lib._capacity(cfg, routes_k[0][1].shape[1])}) "
        f"{dropped} of {slots} ({dropped / slots:.2%})")
    return dict(flips=flips, touched={lay: sorted(e) for lay, e in touched.items()},
                min_margin=min_margin, prob_noise=noise, dropped_slots=dropped, slots=slots)


def hold_grads(tag, grads_k, grads_p, touched, within):
    """The first step's gradients after a routing flip (``touched``: the
    experts a flip touched, by layer).  An expert tensor (an MoE ``wi`` /
    ``wo``: the layer axis, then the expert axis) is held, by ``within(got,
    want)``, on the slices of the experts no flip touched, which only
    their own tokens' unchanged cotangents feed; any other tensor past its
    limit is printed as moved by the flip.  Returns ({held name: max rel
    err} past the limit, [moved names])."""
    bad, moved = {}, []
    for n, w in grads_p.items():
        g = grads_k[n]
        if n.endswith((".mlp.wi", ".mlp.wo")) and w.ndim == 4:
            for layer in range(w.shape[0]):
                for e in range(w.shape[1]):
                    if e in touched.get(layer, ()):
                        continue
                    if not within(g[layer, e], w[layer, e]):
                        bad[f"{n}[{layer}, {e}]"] = max_rel(g[layer, e], w[layer, e])
        elif not within(g, w):
            moved.append(n)
    log(f"{tag} after the routing flip(s): gradients moved past their limit {moved}; "
        f"held: the rest, and the expert slices no flip touched (touched by layer "
        f"{ {lay: sorted(e) for lay, e in touched.items()} })")
    return bad, moved


def max_rel(a, b):
    """max |a - b| / max |b| (0 for an all-zero b that a matches)."""
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    return err / scale if scale else err


# gemma2-2b's --amp limits.  bf16: mup-gpt's (AMP_LIMITS) are missed at 26
# layers of heads of 256, where the kernels' f32 summation order (each B5-B7
# output within the bf16 tiers of its plain version, mean error 1e-7 to
# 7e-7 at DP 256) flips bf16 roundings in the layers after: the first step's
# loss 6.0e-6 relative apart and gradients up to 6.3e-3 of a tensor's
# largest entry (an H100 at 700 W), where the f32-operand control is 4.2e-5
# (gradients 3.8e-3 to 1.1e-2: as on mup-gpt they cannot tell the modes
# apart); the loss limit sits between the two.  int8: mup-gpt's, the
# kernels equal their plain versions bit for bit.
G2_AMP_LIMITS = {"bf16": (2e-5, 1.5e-2, 2e-5, "none"), "int8": AMP_LIMITS["int8"]}
# mixtral-8x22b's --amp limits.  Its loops' step 0 is the first step (the
# same weights and batch), so the loop's limit is the first step's.  bf16:
# the kernels 1.75e-7 from the plain side, the f32-operand control 1.16e-5,
# the f32 run at the loop's step 0 6.04e-6 (an H100 at 700 W); gradients
# within 1.2e-4 of a tensor's largest entry (the control up to 9.3e-3).
# int8: the kernels equal their plain versions (0 apart), the controls
# 2.74e-5 and 2.02e-5, the f32 run 1.15e-5.
MX_AMP_LIMITS = {"bf16": (2e-6, AMP_GRAD_TOL, 2e-6, "none"),
                 "int8": (INT8_LOSS_RTOL, INT8_GRAD_TOL, INT8_LOSS_RTOL, "bf16")}
# the train phases' architectures (the tuple's fields below).  gemma2-2b at
# full width (26 layers, d_model 2304, vocab
# 256,000, f32 weights): its weights, gradients and two Adam moments take 42
# GB, so the batch is 4 x 512 (activations and the readout's logits near 20
# GB more) and the loops 5 steps; nothing else is cut.  Its amp loops hold
# B5-B7 as the first step does, against their plain versions with B1-B4's
# kernels on both sides: at 26 layers B1-B4's plain versions' f32 ulps flip
# int8 bytes downstream and move the step-0 loss 1.29e-4 (an H100 at 700
# W), farther than the f32 run is (4.8e-5), so no limit could tell the modes
# apart; the f32 phase holds B1-B4 in the loop.
#
# mixtral-8x22b (arXiv:2401.04088) at full width over 1 of its 56 layers:
# one layer's f32 weights, gradients and two Adam moments take 46.5 GB,
# two layers' 86.6 GB (train_state_bytes), more than the card holds.  One
# sequence of 4,608 tokens, so that the window of 4,096 masks keys for the
# last 512 queries (the serve phases' prompts); the MoE capacity is then
# 1,440 places an expert.  Loops of 3 steps (the run's time); nothing else
# cut.  Its loops start from the first step's weights (a random query
# projection too), so that their step 0 is the first step, bit for bit;
# under --amp they run through the kernels only (None: the first step
# holds B5-B7 against their plain versions), for the run's time.  AdamW at
# lr 1e-4, a fine-tuning rate: at the default 1e-2 (µP's base width is
# mixtral's own) the loss rose from 10.88 to 40.5 in one step on an H100 at
# 700 W.
#
#
# mamba2-130m (arXiv:2405.21060) at full width, all 24 layers, f32: 8 x 512
# tokens (two SSD chunks of 256 a sequence, so the inter-chunk recurrence
# runs), loops of 3 steps (the run's time); nothing else cut.  It has no
# attention, so --amp changes only its readout (the tied embedding's logit
# matmul): the first step holds B1-B4 against their plain versions under the
# same readout policy, and the control is the readout in the other operand
# mode (f32 for bf16, bf16 for int8).  Its loops run through the kernels
# only under --amp (None), the first step being the loop's step 0 bit for
# bit (zero_init_query changes nothing in an attention-free model and turns
# that check on).  Measured (H100 at 700 W): bf16, kernels against plain
# 1.49e-6 (gradients up to 1.1e-3 of a tensor's largest entry), the f32
# readout control 2.75e-5, the f32 run's step 0 2.9e-5; int8 3.18e-6 (up to
# 2.6e-3), the bf16 readout control 7.59e-5 (2.3e-2 to 3.5e-2), the f32 run
# 5.02e-5: B1-B4's f32 ulps move a few readout roundings.
M2_AMP_LIMITS = {"bf16": (5e-6, AMP_GRAD_TOL, 5e-6, "none"),
                 "int8": (1e-5, 1e-2, 1e-5, "bf16")}
M2_TRAIN = ("train_mamba2", "train_mamba2_amp_bf16", "train_mamba2_amp_int8")
#
# recurrentgemma-9b (arXiv:2402.19427) at full width over 5 of its 38 layers:
# the first (recurrent, recurrent, local) group and the (recurrent,
# recurrent) tail, 2.17 B parameters, whose f32 weights, gradients and two
# Adam moments take 34.8 GB (the 38 layers' 150 GB, which the train CLI
# refuses on one card).  One sequence of 2,560 tokens, so that the local
# layer's window of 2,048 binds inside B5-B7; loops of 2 steps (the run's
# time: RG_R above); nothing else cut.  Its amp loops' plain side keeps B1-B4's
# kernels, as gemma2-2b's does, at RG_AMP_LIMITS below; the loops' step 0 is
# the first step bit for bit (a random query projection in both).
RG_TRAIN = ("train_recurrentgemma", "train_recurrentgemma_amp_bf16",
            "train_recurrentgemma_amp_int8")
# recurrentgemma-9b's --amp limits.  gemma2's are missed the other way: the
# step-0 loss is ~2,134 (tied embeddings at vocab 256,000), and the one
# local layer's attention moves it little, so the bf16 control (attention's
# kernels in the f32 operand mode) lands 6.86e-7 from the plain side, inside
# gemma2's 2e-5, and under int8 the f32 run's step 0 lands 8.9e-6 from the
# int8 run's, inside 1e-5 (an H100 80GB HBM3, this PR's first probe).  The
# kernels are 0 from their plain versions in both modes (B1-B4's kernels on
# both sides), the int8 controls 2.52e-6 (bf16 operand mode) and 1.6e-6
# (tiles 64 wide): the loss limits sit between.  Gradients: bf16 kernels
# within 1.3e-4 of a tensor's largest entry (the control up to 1.2e-3),
# int8 bit-equal.
RG_AMP_LIMITS = {"bf16": (2e-7, AMP_GRAD_TOL, 2e-7, "none"),
                 "int8": (5e-7, INT8_GRAD_TOL, 5e-7, "bf16")}
#
# (batch, sequence, loop steps, the phase's path name, the --amp limits,
# the amp loops' plain side (False: B1-B7's plain versions; True: B1-B4's
# kernels; None: no plain loop), config overrides, the loops' lr)
TRAIN_ARCHS = {"mup-gpt": (8, 512, 10, "train", AMP_LIMITS, False, {}, 1e-2),
               "gemma2-2b": (4, 512, 5, "train_gemma2", G2_AMP_LIMITS, True, {}, 1e-2),
               "mixtral-8x22b": (1, 4608, 3, "train_mixtral", MX_AMP_LIMITS, None,
                                 {"n_layers": 1, "zero_init_query": False,
                                  "zero_init_readout": False}, 1e-4),
               "mamba2-130m": (8, 512, 3, "train_mamba2", M2_AMP_LIMITS, None,
                               {"zero_init_query": False}, 1e-2),
               "recurrentgemma-9b": (1, 2560, 2, "train_recurrentgemma", RG_AMP_LIMITS, True,
                                     {"n_layers": 5, "zero_init_query": False}, 1e-2)}


def train_phase(ops, quant, amp="", control_losses=None, arch="mup-gpt"):
    """``arch`` (TRAIN_ARCHS) at full width (``amp`` its mixed-precision
    policy, as ``--amp`` sets it): the first step's loss and gradients with
    and without the kernels, then train_loop steps each way from the same
    init and batches; launch counts of the kernel run, peak memory of both.

    Under amp the plain side's attention rounds (bf16) or quantizes (int8)
    where the kernels do (plain_flash): the policy's own plain attention
    rounds or quantizes the normalized p over whole rows and forms delta
    from the rounded do and v, which moves the numbers about as far as the
    policy itself (its distance is printed, not held).  The loss limits
    (AMP_LIMITS) must reject a control: attention's kernels in another
    operand mode on the first step (f32 for bf16, bf16 for int8),
    ``control_losses`` (the f32 phase's) at step 0 of the loop.  A third
    loop, through the policy's plain attention, gives the plain time and
    peak memory; the gap of its last losses to the f32 run's is printed.
    Where TRAIN_ARCHS says so (gemma2-2b, mixtral-8x22b), the amp loops'
    plain side keeps B1-B4's kernels, as the first step does.

    An untied readout (mixtral-8x22b) starts random here, in the first step
    and the loops: under µP's zero readout every gradient but the readout's
    is exactly 0 at step 0 and every step-0 loss is ln V whatever the
    kernels do.  On an MoE arch the first step also records each layer's
    expert choices on both sides (train_routing: a flip only at a near-tie,
    ROUTE_TIE; the slots dropped past capacity printed), holds the kernels'
    first step bit-equal when run again (the expert dispatch's
    index_put/index_add give each row at most k = 2 adds, to an exact
    zero), and, where a flip occurs, prints the gradients it moved and
    holds the rest (hold_grads)."""
    from repro_torch.configs import get_config
    from repro_torch.core.transfer import HParams, transfer
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.train import train_loop, train_state_bytes
    from repro_torch.models.model import Model
    from repro_torch.optim.grad import value_and_grad

    B, S, STEPS, path, limits, isolate, over, lr = TRAIN_ARCHS[arch]
    isolate = isolate if amp else False
    cfg = get_config(arch).replace(dtype="float32", amp=amp, **over)
    moe = bool(cfg.n_experts)
    kinds = list(cfg.pattern) * cfg.n_groups + list(cfg.tail)
    # ssd and recurrent layers: no attention
    n_att_layers = sum(k not in ("ssd", "recurrent") for k in kinds)
    tag = f"[{path} --amp {amp}]" if amp else f"[{path}]"
    if amp:
        loss_rtol, grad_tol, loop_rtol, control_mode = limits[amp]
    else:
        loss_rtol = loop_rtol = TRAIN_LOSS_RTOL
    hps = HParams(lr=lr)
    # the first-step check starts from a random query projection, so that
    # attention is not uniform (zero-init q makes it so at step 0)
    model_cfg = cfg.replace(**transfer(hps, cfg)["model"], zero_init_query=False,
                            zero_init_readout=False)
    kern = Model(model_cfg, device="cuda", impl="auto")
    plain = Model(model_cfg, device="cuda", impl="ref")
    params = kern.init(seed=0)
    n_params = sum(p.numel() for p in params.values())
    batch0 = {k: torch.from_numpy(v).cuda() for k, v in
              make_pipeline(cfg.vocab_size, S, B, seed=0).batch(0).items()}
    if arch == "gemma2-2b":
        cut = ("the batch cut from 8 x 512, which does not fit beside 42 GB of weights, "
               "gradients and moments; nothing else cut")
    elif "n_layers" in over:
        full = get_config(arch)
        # one pattern group more
        more = cfg.n_layers + len(cfg.pattern)
        two = train_state_bytes(Model(cfg.replace(n_layers=more), device="cuda"))
        cut = (f"the depth cut to {cfg.n_layers} of {full.n_layers} layers: f32 weights, "
               f"gradients and two Adam moments take {4 * n_params * 4 / 1e9:.1f} GB at "
               f"{cfg.n_layers}, {two / 1e9:.1f} GB at {more}; "
               + ("a random readout; " if "zero_init_readout" in over else "")
               + "nothing else cut")
    else:
        cut = "nothing cut"
    mixer = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff {cfg.d_ff}"
             + (f", RG-LRU width {cfg.lru_width}, pattern {cfg.pattern} x {cfg.n_groups} "
                f"+ tail {cfg.tail}" if "recurrent" in kinds else "")
             if n_att_layers else
             f"SSD d_inner {cfg.d_inner}, {cfg.d_inner // cfg.ssm_head_dim} heads of "
             f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {mixer}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e6:.1f}M params; batch {B} x seq {S}, f32"
        + (f", --amp {amp}" if amp else "") + f"; loops of {STEPS} steps; " + cut)

    with recorded_routes() as routes_k:
        loss_k, grads_k = value_and_grad(kern.loss_fn, params, batch0)
    first = {}
    if moe:
        # the same step again: its gradients bit for bit; freed before the
        # plain side runs
        loss_a, grads_a = value_and_grad(kern.loss_fn, params, batch0)
        differ = [n for n in grads_k if not same_bits(grads_a[n], grads_k[n])]
        if differ or not same_bits(loss_a, loss_k):
            raise AssertionError(f"{tag} the kernels' first step run twice: loss "
                                 f"{float(loss_k)} / {float(loss_a)}, gradients differ "
                                 f"in {differ}")
        del grads_a
        torch.cuda.empty_cache()
        log(f"{tag} the kernels' first step run twice: loss and all {len(grads_k)} "
            f"gradients bit-equal")
        first["repeat_bit_equal"] = True
    # under amp the first step isolates B5-B7: B1-B4 run on both sides, so
    # that attention's inputs are the same bits (an arch with no attention
    # holds B1-B4 against their plain versions instead)
    # the plain flash versions over as many kv heads a call as keep a call's
    # f32 (S, S) scores near 1 GiB (mixtral: 2 of its 8; the others: all)
    group = cfg.n_heads // cfg.n_kv_heads
    pf = plain_flash(ops, kv_heads=max(1, 2**30 // (S * S * 4 * group)))
    first_plain = kern if amp and n_att_layers else plain
    with models_attend_with(ops, pf if amp else None), recorded_routes() as routes_p:
        loss_p, grads_p = value_and_grad(first_plain.loss_fn, params, batch0)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_rel = {n: max_rel(grads_k[n], grads_p[n]) for n in grads_p}
    touched = {}
    if moe:
        first["routing"] = train_routing(tag, cfg, routes_k, routes_p)
        touched = first["routing"]["touched"]
    if amp:
        # the controls: attention's kernels in another operand mode and, under
        # int8, its plain versions tiled 64 wide (scales over other tiles)
        from repro_torch.kernels import ref

        other = quant.QuantPolicy(control_mode)
        if n_att_layers:
            controls = {f"attention's kernels in the {control_mode} operand mode":
                        (contextlib.nullcontext(),
                         mode_kernels(ops, other if other.active else None), kern)}
            if amp == "int8":
                controls["the plain versions tiled 64 wide"] = (int8_tiles(ref, 64), pf,
                                                                kern)
        else:
            # no attention: the readout is all that the policy changes
            ctrl_model = Model(model_cfg.replace(amp=control_mode if other.active else ""),
                               device="cuda", impl="auto")
            controls = {f"the readout in the {control_mode.replace('none', 'f32')} "
                        f"operand mode":
                        (contextlib.nullcontext(), None, ctrl_model)}
        ctrl = {}
        for what, (tiles, attention, model) in controls.items():
            with tiles, models_attend_with(ops, attention):
                loss_c, grads_c = value_and_grad(model.loss_fn, params, batch0)
            ctrl[what] = (abs(float(loss_c) - float(loss_p)) / abs(float(loss_p)),
                          {n: max_rel(grads_c[n], grads_p[n]) for n in grads_p})
            del grads_c
        rel_q = policy_rel = None
        if isolate is not None:
            # the policy's own plain attention (not held; mixtral's S 4,608
            # x 48 heads would hold whole (S, S) tensors: left out)
            loss_q, grads_q = value_and_grad(plain.loss_fn, params, batch0)
            rel_q = abs(float(loss_k) - float(loss_q)) / abs(float(loss_q))
            policy_rel = {n: max_rel(grads_k[n], grads_q[n]) for n in grads_q}
            del grads_q
        log(f"{tag} first step, max abs err over each tensor's largest plain entry: "
            f"kernels loss rel {rel:.3g}, "
            + ", ".join(f"{n} {e:.2g}" for n, e in grad_rel.items())
            + "".join(f"; control, {what}: loss rel {c[0]:.3g}, "
                      + ", ".join(f"{n} {e:.2g}" for n, e in c[1].items())
                      for what, c in ctrl.items())
            + ("" if rel_q is None else
               f"; kernels against the policy's plain attention (not held): loss "
               f"rel {rel_q:.3g}, "
               + ", ".join(f"{n} {e:.2g}" for n, e in policy_rel.items())))
        for what, (rel_c, _) in ctrl.items():
            if not rel_c > loss_rtol:
                raise AssertionError(f"the control, {what}, passes the loss limit: "
                                     f"rel {rel_c}")
        if touched:
            bad, first["moved_by_flips"] = hold_grads(
                tag, grads_k, grads_p, touched, lambda g, w: max_rel(g, w) <= grad_tol)
        else:
            bad = {n: e for n, e in grad_rel.items() if not e <= grad_tol}
    elif touched:
        atol, rtol = GRAD_TOL[torch.float32]
        bad, first["moved_by_flips"] = hold_grads(
            tag, grads_k, grads_p, touched,
            lambda g, w: bool(((g - w).abs() <= atol + rtol * w.abs()).all()))
    else:
        for n in grads_p:
            check_close(f"first-step grad {n}", grads_k[n], grads_p[n],
                        *GRAD_TOL[torch.float32])
        bad = {}
    if not rel <= loss_rtol or bad:
        raise AssertionError(f"first step: loss {float(loss_k)} vs plain {float(loss_p)} "
                             f"(rel {rel}); gradients beyond the limit: {bad}")
    grad_err = {n: (grads_k[n] - grads_p[n]).abs().max().item() for n in grads_p}
    log(f"{tag} first step: loss {float(loss_k):.6f} vs plain {float(loss_p):.6f} "
        f"(rel {rel:.3g}); gradients agree, max abs err per tensor "
        + ", ".join(f"{n} {e:.2g}" for n, e in grad_err.items()))
    first.update(first_step_loss_rel_diff=rel, first_step_grad_max_abs_err=grad_err,
                 first_step_grad_rel_err=grad_rel)
    if amp:
        first.update(controls={what: dict(loss_rel_diff=c[0], grad_rel_err=c[1])
                               for what, c in ctrl.items()},
                     policy_plain_loss_rel_diff=rel_q, policy_plain_grad_rel_err=policy_rel)
    # the loops make their own weights: nothing of this step stays on the card
    first_loss = float(loss_k)
    del grads_k, grads_p, params, batch0

    def loop(impl, log_every=0):
        """The run's losses and step times (its weights are dropped, so that
        they do not count in the next run's peak memory) and peak GiB."""
        torch.cuda.reset_peak_memory_stats()
        out = train_loop(cfg, STEPS, hps, batch_size=B, seq_len=S, seed=0,
                         log_every=log_every, device="cuda", impl=impl)
        torch.cuda.synchronize()
        keep = ("losses", "step_seconds", "batch_seconds")
        return {k: out[k] for k in keep}, torch.cuda.max_memory_allocated() / 2**30

    ops.reset_launch_counts()
    out_k, peak_gib = loop("auto", log_every=1)
    launches = ops.launch_counts()
    n_attn = n_att_layers if amp == "bf16" else 0   # B5-B7 only under --amp,
    n_int8 = n_att_layers if amp == "int8" else 0   # in its operand mode
    # two norms a layer (an attention or recurrent one, the tail's too), four
    # with gemma2's post-norms, one an ssd layer, and the final one
    n_norm = sum(1 if k == "ssd" else 4 if cfg.post_attn_norm else 2 for k in kinds) + 1
    per_step = {"rmsnorm": n_norm, "rmsnorm_bwd": n_norm,
                "rmsnorm_grouped": 0, "rmsnorm_bwd_grouped": 0,
                "ce_fwd": 1, "ce_bwd": 1, "flash_decode": 0,
                "flash_decode_multi": 0, "flash_decode_int8": 0,
                "flash_decode_multi_int8": 0, "flash_fwd": n_attn,
                "flash_bwd_dq": n_attn, "flash_bwd_dkv": n_attn,
                "flash_fwd_int8": n_int8, "flash_bwd_dq_int8": n_int8,
                "flash_bwd_dkv_int8": n_int8, "flash_bwd_quant_int8": n_int8,
                "flash_fwd_quant_int8": n_int8}
    want = {k: v * STEPS for k, v in per_step.items()}
    log(f"{tag} kernels: launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")

    torch.cuda.empty_cache()
    out_p = out_y = plain_peak_gib = None
    if not (amp and isolate is None):
        ops.reset_launch_counts()
        with models_attend_with(ops, plain_flash(ops) if amp else None):
            out_p, peak_p = loop("auto" if isolate else "ref")
        plain_launches = ops.launch_counts()
        want_plain = {k: v if isolate and not k.startswith("flash") else 0
                      for k, v in want.items()}
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        out_y, plain_peak_gib = loop("ref") if amp else (out_p, peak_p)
        torch.cuda.empty_cache()
        if plain_launches != want_plain or set(ops.launch_counts().values()) != {0}:
            raise AssertionError(f"plain runs launched {plain_launches}, then "
                                 f"{ops.launch_counts()}; expected {want_plain}, then none")

    lk = out_k["losses"]
    lp, ly = (None, None) if out_p is None else (out_p["losses"], out_y["losses"])
    runs = [r for r in (lk, lp, ly) if r is not None]
    if not all(np.isfinite(sum(runs, []))):
        raise AssertionError(f"non-finite losses: {lk} / {lp} / {ly}")
    if not all(r[-1] < r[0] for r in runs):
        raise AssertionError(f"loss did not fall: {lk} / {lp} / {ly}")
    if not cfg.zero_init_query and lk[0] != first_loss:
        # the loop starts from the first step's weights and batch
        raise AssertionError(f"the loop's step-0 loss {lk[0]} is not the first step's "
                             f"{first_loss}")
    rel0 = rel_all = None
    if lp is not None:
        rel0 = abs(lk[0] - lp[0]) / abs(lp[0])
        if not rel0 <= loop_rtol:
            raise AssertionError(f"step-0 loss {lk[0]} vs plain {lp[0]} (rel {rel0})")
        rel_all = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    extra = {}
    if amp:
        base0 = lk[0] if lp is None else lp[0]
        ctrl0 = abs(control_losses[0] - base0) / abs(base0)
        if not ctrl0 > loop_rtol:
            raise AssertionError(f"the f32 run's step-0 loss {control_losses[0]} passes "
                                 f"the amp loop's limit (rel {ctrl0})")
        # the reference's amp bar (tests/test_quant.py): the mean of the last 3
        # losses against the f32 run's; printed, not held on the card
        f32_last = float(np.mean(control_losses[-3:]))
        extra = dict(control_step0_rel_diff=ctrl0,
                     last3_gap_to_f32=(float(np.mean(lk[-3:])) - f32_last) / f32_last)
        if ly is not None:
            extra.update(policy_plain_losses=ly,
                         policy_plain_step0_rel_diff=abs(lk[0] - ly[0]) / abs(ly[0]))
    # steady state: the first step builds cuBLAS handles and the allocator
    ms_k = 1e3 * float(np.median(out_k["step_seconds"][1:]))
    # the part of a step spent making the batch on the host and copying it
    batch_k = 1e3 * float(np.median(out_k["batch_seconds"][1:]))
    ms_p = batch_p = None
    if out_y is not None:
        ms_p = 1e3 * float(np.median(out_y["step_seconds"][1:]))
        batch_p = 1e3 * float(np.median(out_y["batch_seconds"][1:]))
    log(f"{tag} losses with kernels {[round(v, 4) for v in lk]}")
    if lp is None:
        log(f"{tag} no plain loop under --amp (the first step holds "
            f"{'B5-B7' if n_att_layers else 'B1-B4'} against their plain versions; the "
            f"loop's step 0 is that step, bit for bit)")
    else:
        log(f"{tag} losses plain        {[round(v, 4) for v in lp]}"
            + (" (B5-B7's plain versions, B1-B4's kernels)" if isolate else ""))
    if amp:
        log(f"{tag} "
            + ("" if ly is None else
               f"losses through the policy's plain attention {[round(v, 4) for v in ly]}; ")
            + f"step 0 of the f32 run {control_losses[0]:.4f} (rel "
            f"{extra['control_step0_rel_diff']:.3g} from the "
            f"{'kernels' if lp is None else 'plain'} amp run); mean of the "
            f"last {min(3, STEPS)} losses {extra['last3_gap_to_f32']:+.3%} from the f32 "
            f"run's (not held)")
    plain_text = ("not run" if ms_p is None else
                  f"{ms_p:.2f} ({B * S / ms_p * 1e3:.0f} tok/s, batch {batch_p:.2f} ms)")
    log(f"{tag} step-0 loss rel diff "
        + ("-" if rel0 is None else f"{rel0:.3g}, max over steps {rel_all:.3g}")
        + f"; ms/step (median of steps 1-{STEPS - 1}, batch generation included) "
        f"kernels {ms_k:.2f} ({B * S / ms_k * 1e3:.0f} tok/s, of which batch "
        f"{batch_k:.2f} ms), plain {plain_text}; peak memory {peak_gib:.2f} GiB with the "
        f"kernels, " + ("plain not run" if plain_peak_gib is None
                        else f"{plain_peak_gib:.2f} GiB plain"))
    return launches, dict(
        steps=STEPS, batch=B, seq=S, tokens_per_step=B * S,
        losses=lk, plain_losses=lp, step0_rel_diff=rel0, max_rel_diff=rel_all,
        ms_per_step=ms_k, plain_ms_per_step=ms_p,
        batch_ms=batch_k, plain_batch_ms=batch_p,
        tok_per_s=B * S / ms_k * 1e3,
        plain_tok_per_s=None if ms_p is None else B * S / ms_p * 1e3,
        step_seconds=out_k["step_seconds"],
        plain_step_seconds=None if out_y is None else out_y["step_seconds"],
        batch_seconds=out_k["batch_seconds"],
        peak_memory_gib=peak_gib, plain_peak_memory_gib=plain_peak_gib,
        **first, **extra,
    )


def train_profile_phase(amp=""):
    """torch.profiler over one steady train step (after a warm-up step),
    ``amp`` the mixed-precision policy."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizer import Optimizer
    from repro_torch.optim.schedules import linear_decay

    cfg = get_config("mup-gpt").replace(dtype="float32", amp=amp)
    model = Model(cfg, device="cuda")
    opt = Optimizer.create("adamw", 1e-2, model.p13n, model.meta,
                           schedule=linear_decay(10))
    step = make_train_step(model, opt)
    params = model.init(seed=0)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             make_pipeline(cfg.vocab_size, 512, 8, seed=0).batch(0).items()}
    params, state, _ = step(params, state, batch)     # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        float(metrics["loss"])
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"[profile] one train step{' --amp ' + amp if amp else ''}: "
        f"{wall_us / 1e3:.1f} ms under the profiler; "
        f"device busy {busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}), "
        f"{sum(e.count for e in kernels)} kernel launches")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")
    port = port_kernel_times(kernels)
    L = cfg.n_layers
    want = {"rmsnorm_bwd": 2 * L + 1, **({"flash_fwd_quant_int8": L, "flash_fwd_int8": L,
                                          "flash_bwd_quant_int8": L} if amp == "int8" else {})}
    seen = {k: port.get(k, (0.0, 0))[1] for k in want}
    # one launch a call: the profile shows no more launches than calls (a
    # profile may drop an event, so fewer is printed, not held)
    if any(seen[k] > want[k] for k in want):
        raise AssertionError(f"profiled train step: launches {seen}, expected {want}")
    log(f"[profile]   launches of one step {seen} (calls {want})")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                launches=sum(e.count for e in kernels),
                port_kernels=port,
                top=[(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in top])

# ---------------------------------------------------------------------------
# sweep phase: the batched HP sweep and Algorithm 1 through Experiment
# ---------------------------------------------------------------------------

GROUPED = ("rmsnorm_grouped", "rmsnorm_bwd_grouped")   # B1/B2 with a gain per group
# (x shape, groups): the batched proxy step (16 candidates x 8 x 64 tokens
# x d 256), 4 candidates at the train shape, and ragged D on both B2 paths
# (48: 16-byte pieces in registers; 1030: the scalar path)
GROUPED_SHAPES = [(16, 8, 64, 256), (4, 8, 512, 1024), (16, 8, 8, 48), (4, 8, 16, 1030)]
GROUPS = (1, 4, 16)
# (x shape, groups) as the sweep phase's main paths hand them to B1/B2:
# (candidates, batch, seq, d_model) -- the 4-candidate sweep, the coord
# check's 3 lrs at 8 x 32 and Fig. 1's 8 lrs at 8 x 64, each at d_model
# 256, 512 and 1024 (16 candidates at d 256, tune's, is above)
PATH_GROUPED = ([((4, 8, 64, 256), 4)]
                + [((3, 8, 32, d), 3) for d in (256, 512, 1024)]
                + [((8, 8, 64, d), 8) for d in (256, 512, 1024)])
GROUPED_CASES = [(s, G) for s in GROUPED_SHAPES for G in GROUPS] + PATH_GROUPED
L2_BYTES = 50 * 2**20       # the H100's L2; timed operands rotate over 3-4x it
# the reference's test_transformer_equivalence_and_hp_threading candidates,
# and one that diverges
SWEEP_CANDIDATES = [dict(lr=5e-3), dict(lr=1e-2, sigma=0.5, alpha_output=2.0),
                    dict(lr=2e-2, sigma=2.0, alpha_attn=2.0, alpha_embed=0.5),
                    dict(lr=1e25)]
SWEEP_RTOL = 2e-3           # batched against serial (the reference's tolerance)
# the sweep phase's main paths, and those that run the batched step
SWEEP_PATHS = ("sweep", "sweep_serial", "sweep_16", "algorithm1_coord_check",
               "algorithm1_tune", "algorithm1_train", "fig1")
GROUPED_PATHS = ("sweep", "sweep_16", "algorithm1_coord_check", "algorithm1_tune", "fig1")
SWEEP_STEPS, SWEEP_BATCH, SWEEP_SEQ = 6, 8, 64
COORD_SLOPE_MAX = 0.1       # tests/test_torch_coord_check.py's bound on logits.delta
# A bf16 output whose f32 value lies an ulp from a rounding boundary rounds
# to the other neighbour when the row's rsqrt is summed in another order:
# one bf16 ulp, 0.03125 at |y| in [4, 8) (x (4, 8, 512, 1024), an H100 at
# 700 W).  The grouped B1's bf16 check adds that relative half-ulp to the
# bf16 tier; its bits are held against G separate launches anyway.
BF16_OUT_RTOL = 2.0 ** -8


def rotating(fn, sets):
    """A call of ``fn`` on the next of ``sets`` (argument tuples) in turn,
    each result kept until its set comes round again, so that the inputs
    read and the outputs written move through memory and not through L2."""
    outs = [None] * len(sets)
    turn = [0]

    def call():
        i = turn[0] % len(sets)
        turn[0] += 1
        outs[i] = fn(*sets[i])
        return outs[i]
    return call


def grouped_kernel_phase(rn, ref):
    """B1 and B2 with a (G, D) gain against their plain versions (B1
    bit-equal to G separate launches, B2's dgain bit-identical when
    repeated) at the checked shapes and at each (shape, G) the sweep's
    paths give them, then timed at the batched proxy step's shape beside
    G separate launches, the operands rotated through 3-4x the L2 so that
    the time is the HBM's, as the bound is."""
    worst = {"y": 0.0, "dx": 0.0, "dgain": 0.0}
    n = 0
    for (shape, G), dt in itertools.product(GROUPED_CASES, (torch.float32, torch.bfloat16)):
        D = shape[-1]
        x = (3 * torch.randn(*shape, device="cuda")).to(dt)
        g = 0.5 * torch.randn(G, D, device="cuda")
        dy = torch.randn(*shape, device="cuda").to(dt)
        what = f"grouped rmsnorm {shape} G={G} {dt}"
        y = rn.rmsnorm(x, g)
        worst["y"] = max(worst["y"], check_close(
            what, y, ref.rmsnorm_ref(x, g), ATOL[dt],
            BF16_OUT_RTOL if dt == torch.bfloat16 else 0.0))
        xs = x.reshape(G, -1, D)
        apart = torch.stack([rn.rmsnorm(xs[i], g[i]) for i in range(G)])
        if not torch.equal(y, apart.reshape(shape)):
            raise AssertionError(f"{what}: differs from {G} separate launches")
        dx, dg = rn.rmsnorm_bwd(x, g, dy)
        want_dx, want_dg = ref.rmsnorm_bwd_ref(x, g, dy)
        worst["dx"] = max(worst["dx"], check_close(what + " dx", dx, want_dx, *GRAD_TOL[dt]))
        worst["dgain"] = max(worst["dgain"], check_close(
            what + " dgain", dg, want_dg, *GRAD_TOL[torch.float32]))
        if not torch.equal(rn.rmsnorm_bwd(x, g, dy)[1], dg):
            raise AssertionError(f"{what}: dgain differs between two calls")
        n += 1
    log(f"[sweep] grouped B1/B2: {n} cases ({len(PATH_GROUPED)} (shape, G) pairs of the "
        f"sweep's paths among them) agree with the plain versions, B1 bit-equal to G "
        f"separate launches, dgain deterministic; max err y {worst['y']:.3g}, dx "
        f"{worst['dx']:.3g}, dgain {worst['dgain']:.3g}")

    G, shape = 16, GROUPED_SHAPES[0]
    D = shape[-1]
    x_bytes = math.prod(shape) * 4
    # B2 moves the most a set (x, dy, dx): enough sets that 4x the L2
    # passes between two uses of one
    n_sets = math.ceil(4 * L2_BYTES / (3 * x_bytes))
    sets = [(torch.randn(*shape, device="cuda"), 0.5 * torch.randn(G, D, device="cuda"),
             torch.randn(*shape, device="cuda")) for _ in range(n_sets)]
    x, g, dy = sets[0]
    fwd = rotating(rn.rmsnorm, [s[:2] for s in sets])
    bwd = rotating(rn.rmsnorm_bwd, sets)
    fwd_apart = rotating(lambda a, b: [rn.rmsnorm(a.reshape(G, -1, D)[i], b[i])
                                       for i in range(G)], [s[:2] for s in sets])
    bwd_apart = rotating(lambda a, b, c: [rn.rmsnorm_bwd(a.reshape(G, -1, D)[i], b[i],
                                                         c.reshape(G, -1, D)[i])
                                          for i in range(G)], sets)
    rows = []
    for name, call, apart, plain, check, nbytes, flops, replaces in (
            ("rmsnorm_grouped", fwd, fwd_apart, rotating(ref.rmsnorm_ref, [s[:2] for s in sets]),
             lambda: (rn.rmsnorm(x, g), ref.rmsnorm_ref(x, g)),
             2 * x.numel() * 4 + g.numel() * 4, 4 * x.numel(), ":28"),
            ("rmsnorm_bwd_grouped", bwd, bwd_apart, rotating(ref.rmsnorm_bwd_ref, sets),
             lambda: (rn.rmsnorm_bwd(x, g, dy), ref.rmsnorm_bwd_ref(x, g, dy)),
             3 * x.numel() * 4 + 2 * g.numel() * 4, 12 * x.numel(), ":36")):
        kernel = name.replace("_grouped", "")
        for _ in range(3):   # a profile may drop an event: fewer is retaken, more fails
            _, launches = library_device_us(call)
            if launches >= 1:
                break
        if launches != 1:
            raise AssertionError(f"{name}: {launches} launches a call, not one")
        got, want = check()
        err = (max((a - b).abs().max().item() for a, b in zip(got, want))
               if isinstance(got, tuple) else (got - want).abs().max().item())
        ms, plain_ms = cuda_ms(call), cuda_ms(plain)
        dev = device_us(call, kernel)
        # the profiler drops an event now and then: the G launches at the
        # mean time of those it saw
        seen_us, seen_launches = library_device_us(apart)
        apart_us = seen_us / seen_launches * G
        bound_ms, bound_by = bound(nbytes, flops)
        log(f"[sweep] {name} at x {shape} f32, G = {G}, operands rotated over {n_sets} sets "
            f"({n_sets * nbytes / 2**20:.0f} MiB between two uses of one; L2 "
            f"{L2_BYTES / 2**20:.0f} MiB): {ms:.4f} ms a call, "
            f"{dev:.2f} us on the card in one launch (bound {bound_ms * 1e3:.2f} us by "
            f"{bound_by} at the HBM rate, {bound_ms * 1e3 / dev:.1%} of it); {G} separate "
            f"launches {apart_us:.2f} us on the card ({seen_launches:.1f} launches a call "
            f"seen by the profiler); plain {plain_ms:.4f} ms; no PyTorch call applies a gain "
            f"per group")
        rows.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/rmsnorm.cu",
            replaces=f"src/repro/kernels/rmsnorm.py{replaces}",
            shape=f"x {shape} float32, gain ({G}, {D}) (a batched proxy step), operands "
                  f"rotated over {n_sets} sets ({n_sets * nbytes / 2**20:.0f} MiB)",
            max_abs_err=err, ms=ms, device_us=dev, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None,
            library="none: no single PyTorch call applies a gain per group of rows",
            apart_device_us=apart_us,
            share_of_bound=bound_ms * 1e3 / dev))
    return rows


def sweep_counts(ops, what, fn, want):
    """Run ``fn`` with the launch counts set to 0 just before it and read
    just after; raise unless they equal ``want`` (zeros elsewhere; a
    callable is given ``fn``'s result)."""
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    full = dict.fromkeys(launches, 0)
    full.update(want(out) if callable(want) else want)
    log(f"[sweep] {what}: launches {({k: v for k, v in launches.items() if v})}")
    if launches != full:
        raise AssertionError(f"{what}: launch counts {launches} != {full}")
    return out, launches


def step_launches(cfg, steps, grouped):
    """Launches of ``steps`` train steps of ``cfg``: B1 and B2 per norm (two
    a layer and the final one), B3 and B4 once; grouped in a batched step."""
    norms = (2 * cfg.n_layers + 1) * steps
    b1, b2 = GROUPED if grouped else ("rmsnorm", "rmsnorm_bwd")
    return {b1: norms, b2: norms, "ce_fwd": steps, "ce_bwd": steps}


def same_bits(a, b):
    """Bit for bit (NaN equal to the same NaN) for float32 tensors."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def frozen_check(cfg, cands):
    """A few batched steps by hand: once the diverging candidate is pruned,
    its params and Adam moments keep their bits from step to step."""
    from repro_torch.core import tuning
    from repro_torch.core.hp import stack_hparams
    from repro_torch.core.init import init_candidates
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizer import Optimizer
    from repro_torch.optim.schedules import constant

    model = Model(cfg.replace(dtype="float32"), device="cuda")
    hp = stack_hparams(cands, device="cuda")
    opt = Optimizer.create("adamw", 0.0, model.p13n, model.meta, schedule=constant())
    params = init_candidates(tuning.candidate_generators(0, len(cands)), model.meta,
                             model.p13n, [c.sigma for c in cands])
    state = opt.init(params)
    active = torch.ones(len(cands), dtype=torch.bool, device="cuda")
    step = tuning.make_batched_step(lambda p, b, h: model.loss_fn(p, b, hp=h), opt)
    batches = tuning._proxy_batches(cfg, 4, SWEEP_BATCH, SWEEP_SEQ, 0, "cuda")
    frozen_steps = 0
    for batch in batches:
        before = {k: v[-1].clone() for k, v in params.items()}
        moments = {k: (state["mu"][k][-1].clone(), state["nu"][k][-1].clone()) for k in params}
        was_active = bool(active[-1])
        params, state, loss, active = step(params, state, active, hp, batch)
        if not was_active:
            frozen_steps += 1
            for k in params:
                if not (same_bits(params[k][-1], before[k])
                        and same_bits(state["mu"][k][-1], moments[k][0])
                        and same_bits(state["nu"][k][-1], moments[k][1])):
                    raise AssertionError(f"the pruned candidate's {k} moved")
            if not math.isinf(float(loss[-1])):
                raise AssertionError("the pruned candidate's loss is not +inf")
    if not frozen_steps:
        raise AssertionError("the lr 1e25 candidate was never pruned")
    return frozen_steps


def sweep_phase(ops, rn, ref):
    """The batched HP sweep and Algorithm 1 on the card (see the module
    note).  Returns (kernel rows, {path: launches}, summary)."""
    from repro_torch.api import Experiment
    from repro_torch.configs import get_config
    from repro_torch.core import tuning
    from repro_torch.core.hpspace import mup_space
    from repro_torch.core.transfer import HParams

    rows = grouped_kernel_phase(rn, ref)
    paths, info = {}, {}
    # the proxy: mup-gpt at 0.25x with its d_head kept at 64 -- 8 layers,
    # d_model 256, 4 heads of 64, d_ff 1024, vocab 2048: its µP base shape
    cfg = get_config("mup-gpt").proxy(0.25, min_d_head=64)
    if (cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff) != (
            cfg.base_d_model, cfg.base_n_heads, cfg.base_d_head, cfg.base_d_ff):
        raise AssertionError(f"the proxy {cfg} is not mup-gpt's base shape")
    cands = [HParams(**c) for c in SWEEP_CANDIDATES]
    kw = dict(steps=SWEEP_STEPS, batch_size=SWEEP_BATCH, seq_len=SWEEP_SEQ, device="cuda")

    # (2) batched against serial, with a diverging candidate
    tuning.train_proxy_batched(cfg, cands[:1], steps=1, batch_size=2, seq_len=8)  # warm-up
    bat, paths["sweep"] = sweep_counts(
        ops, f"batched sweep, {len(cands)} candidates x {SWEEP_STEPS} steps",
        lambda: tuning.train_proxy_batched(cfg, cands, **kw),
        step_launches(cfg, SWEEP_STEPS, grouped=True))
    # the serial loop stops a candidate at its first non-finite loss
    ser, paths["sweep_serial"] = sweep_counts(
        ops, "the serial loop", lambda: tuning.train_proxy_serial(cfg, cands, **kw),
        lambda res: step_launches(cfg, int(np.isfinite(res.curves).sum() + (~res.active).sum()),
                                  grouped=False))
    alone = tuning.train_proxy_batched(cfg, cands[:3], **kw)
    fin = np.isfinite(ser.losses)
    if not (np.array_equal(np.isfinite(bat.losses), fin) and fin[:3].all() and not fin[3]):
        raise AssertionError(f"finite scores batched {bat.losses}, serial {ser.losses}")
    rel = np.abs(bat.curves[:, fin] / ser.curves[:, fin] - 1).max()
    moved = np.abs(bat.curves[:, :3] / alone.curves - 1).max()
    if not (rel <= SWEEP_RTOL and moved <= SWEEP_RTOL):
        raise AssertionError(f"batched curves {rel:.3g} from serial, {moved:.3g} from the run "
                             f"without the diverging candidate (rtol {SWEEP_RTOL})")
    diverged = int(np.argmax(np.isinf(bat.curves[:, 3])))
    if bat.active[3] or not np.isinf(bat.curves[diverged:, 3]).all():
        raise AssertionError("the lr 1e25 candidate was not pruned for good")
    frozen = frozen_check(cfg, cands)
    log(f"[sweep] full-size proxy (8 layers, d_model 256, 4 heads of 64): batched curves "
        f"within {rel:.3g} of the serial loop's (rtol {SWEEP_RTOL}); lr 1e25 pruned at step "
        f"{diverged}, frozen bit for bit over {frozen} steps; the others {moved:.3g} from "
        f"the run without it; scores {np.round(bat.losses, 4).tolist()}")
    info.update(batched_vs_serial_rel=float(rel), moved_by_diverged=float(moved),
                frozen_steps=frozen)

    # (3) 16 candidates x 30 steps, batched and serial
    c16 = mup_space().sample_n(16, seed=0)
    kw16 = dict(kw, steps=30)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b16, paths["sweep_16"] = sweep_counts(
        ops, "batched sweep, 16 candidates x 30 steps",
        lambda: tuning.train_proxy_batched(cfg, c16, **kw16),
        step_launches(cfg, 30, grouped=True))
    t_bat = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    s16 = tuning.train_proxy_serial(cfg, c16, **kw16)
    torch.cuda.synchronize()
    t_ser = time.perf_counter() - t0
    both = np.isfinite(b16.curves) & np.isfinite(s16.curves)
    rate_b, rate_s = 16 * b16.steps_run / t_bat, 16 * 30 / t_ser
    wall, busy, n_launch, top = busy_profile(
        lambda: tuning.train_proxy_batched(cfg, c16, **dict(kw16, steps=5)))
    swall, sbusy, _, _ = busy_profile(
        lambda: tuning.train_proxy_serial(cfg, c16[:4], **dict(kw16, steps=5)))
    log(f"[sweep] 16 candidates x 30 steps (sample_n(16, 0)): batched {t_bat:.2f} s "
        f"({rate_b:.1f} candidate-steps/s), serial {t_ser:.2f} s ({rate_s:.1f}); speedup "
        f"{rate_b / rate_s:.2f}x (the reference's bar speedup>=4x, printed, not held); "
        f"{int(both.sum())} step losses finite in both, max rel diff "
        f"{np.abs(b16.curves[both] / s16.curves[both] - 1).max():.3g}; peak memory "
        f"{peak:.2f} GiB; card busy {busy / wall:.1%} of 5 batched steps under the "
        f"profiler ({busy:.1f} of {wall:.1f} ms, {n_launch} launches), {sbusy / swall:.1%} "
        f"of the serial loop's")
    for k, ms, cnt in top:
        log(f"[sweep]   {ms:9.3f} ms  x{cnt:<5d} {k}")
    per = [float(np.abs(b16.curves[both[:, i], i] / s16.curves[both[:, i], i] - 1).max())
           if both[:, i].any() else float("nan") for i in range(16)]
    log(f"[sweep]   by candidate, max rel diff batched/serial {np.round(per, 6).tolist()}; "
        f"last losses {np.round(b16.curves[-1], 3).tolist()}")
    # does the gap move the ranking that tune() reads? (printed, not held)
    fin16 = np.isfinite(b16.losses) & np.isfinite(s16.losses)
    idx = np.flatnonzero(fin16)
    order_b = idx[np.argsort(b16.losses[fin16], kind="stable")].tolist()
    order_s = idx[np.argsort(s16.losses[fin16], kind="stable")].tolist()
    rank_b = {c: r for r, c in enumerate(order_b)}
    rank_s = {c: r for r, c in enumerate(order_s)}
    pairs = list(itertools.combinations(order_b, 2))
    discordant = sum((rank_b[a] - rank_b[c]) * (rank_s[a] - rank_s[c]) < 0 for a, c in pairs)
    ranking = dict(best_batched=b16.best_index, best_serial=s16.best_index,
                   same_finite=bool(np.array_equal(np.isfinite(b16.losses),
                                                   np.isfinite(s16.losses))),
                   order_batched=order_b, order_serial=order_s,
                   discordant_pairs=int(discordant), pairs=len(pairs))
    log(f"[sweep]   ranking of sample_n(16, 0) by score: best batched {b16.best_index}, "
        f"serial {s16.best_index} ({'same' if b16.best_index == s16.best_index else 'DIFFER'}); "
        f"finite scores {'the same set' if ranking['same_finite'] else 'DIFFER'} "
        f"({len(idx)} in both); order batched {order_b}, serial {order_s}: "
        f"{discordant} of {len(pairs)} pairs swapped (printed, not held)")
    info.update(candidate_steps_per_s=rate_b, serial_candidate_steps_per_s=rate_s,
                rel_by_candidate=per, ranking=ranking,
                speedup=rate_b / rate_s, peak_gib=peak, busy_share=busy / wall,
                serial_busy_share=sbusy / swall, batched_s=t_bat, serial_s=t_ser)

    # (4) Algorithm 1 through Experiment, target at full width
    exp = Experiment.from_config("mup-gpt", smoke=False)
    proxy = exp.proxy(0.25, min_d_head=64)
    lrs = (1e-3, 1e-2, 1e-1)
    cc, paths["algorithm1_coord_check"] = sweep_counts(
        ops, "coord_check over 3 lrs at widths 256/512/1024",
        lambda: proxy.coord_check(lrs=lrs, widths=(1.0, 2.0, 4.0)),
        # per width and step: the batched step's launches, and B1 and B3 once
        # more for the initial params' activations (ungrouped, no backward)
        {GROUPED[0]: 9 * 17, GROUPED[1]: 9 * 17, "rmsnorm": 9 * 17, "ce_fwd": 18,
         "ce_bwd": 9})
    slopes = {lr: cc.growth("logits.delta", candidate=i) for i, lr in enumerate(lrs)}
    log(f"[sweep] coord check at d_model {sorted(cc.records)}: logits.delta slope by lr "
        f"{ {lr: round(s, 4) for lr, s in slopes.items()} } (lr 1e-2 held < "
        f"{COORD_SLOPE_MAX})")
    if not slopes[1e-2] < COORD_SLOPE_MAX:
        raise AssertionError(f"coord check: logits.delta slope {slopes[1e-2]} at lr 1e-2")
    t0 = time.perf_counter()
    tuned, paths["algorithm1_tune"] = sweep_counts(
        ops, "tune(n_samples=16, steps=30)", lambda: proxy.tune(n_samples=16, steps=30),
        step_launches(cfg, 30, grouped=True))
    t_tune = time.perf_counter() - t0
    target = proxy.transfer(exp)
    out, paths["algorithm1_train"] = sweep_counts(
        ops, "the target trained 10 steps", lambda: target.train(steps=10, log_every=0),
        step_launches(exp.cfg, 10, grouped=False))
    losses = out["losses"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the target's losses {losses} are not finite and falling")
    h = tuned.best
    log(f"[sweep] tune: {tuned.steps_run} steps in {t_tune:.2f} s, best lr={h.lr:.3e} "
        f"sigma={h.sigma:g} alpha_output={h.alpha_output:g} alpha_attn={h.alpha_attn:g} "
        f"alpha_embed={h.alpha_embed:g} (score {tuned.best_loss:.4f}); transferred to d_model "
        f"{exp.cfg.d_model}: losses {np.round(losses, 4).tolist()}")
    info.update(coord_slopes={str(k): v for k, v in slopes.items()},
                tuned={k: float(getattr(h, k)) for k in ("lr", "sigma", "alpha_output",
                                                         "alpha_attn", "alpha_embed")},
                target_losses=losses, tune_s=t_tune)

    # (5) Fig. 1: the best lr by width under µP (printed, not held)
    grid = [5e-3 * 2 ** k for k in range(8)]
    fig1 = {}
    paths["fig1"] = dict.fromkeys(ops.launch_counts(), 0)
    for f in (0.25, 0.5, 1.0):
        wcfg = get_config("mup-gpt").scaled(f, min_d_head=64)
        res, counts = sweep_counts(
            ops, f"Fig. 1 sweep at d_model {wcfg.d_model}",
            lambda: tuning.train_proxy_batched(wcfg, tuning.grid_candidates(lr=grid),
                                               **dict(kw, steps=20)),
            step_launches(wcfg, 20, grouped=True))
        for k, v in counts.items():
            paths["fig1"][k] += v
        fig1[wcfg.d_model] = res.losses.tolist()
        log(f"[sweep] Fig. 1, d_model {wcfg.d_model}: scores by lr "
            f"{ {f'{lr:.3g}': round(s, 4) for lr, s in zip(grid, res.losses)} }; best lr "
            f"{grid[res.best_index]:.3g}")
    info["fig1"] = {str(w): v for w, v in fig1.items()}
    return rows, paths, info

# the MoE sweep: mixtral-8x22b's µP proxy (2 layers at 1/24 width with
# d_head kept at 64: d_model 256, 4/4 heads of 64, d_ff 683, 8 experts
# top-2, vocab 32768, µP base d_model 6144), 8 candidates (4 lrs x 2
# output multipliers) x 10 steps of 8 x 64 tokens.  At 1/24 of the base
# width µP's hidden Adam rates are 24x the master lr, so the lrs sit below
# the full model's fine-tuning rate (TRAIN_ARCHS): the loss falls at each.
# Batched and serial steps differ in the f32 GEMMs' summation order
# (cuBLAS batched against single GEMMs; one candidate batched equals the
# serial loop bit for bit), and on the edge of stability training grows
# that: at lr 2e-4 (the loss rising 8.56 -> 9.43 in a step) the two stood
# 3.37e-2 apart at step 9, at 1e-4 2.9e-4, at these lrs 6.9e-5 at most
# (an H100 at 700 W), as PR 24's candidates that blow up part
MOE_SWEEP_LRS, MOE_SWEEP_ALPHAS, MOE_SWEEP_STEPS = (1e-5, 2e-5, 4e-5, 8e-5), (1.0, 2.0), 10
MOE_SWEEP_PATHS = ("sweep_moe", "sweep_moe_serial")


def moe_sweep_phase(ops):
    """The batched HP sweep (core/tuning.py) over an MoE proxy: under
    torch.func.vmap models/moe.py's dispatch and combine run out of place.
    8 candidates x 10 steps batched and serial: falling losses, every
    curve within SWEEP_RTOL of the serial loop's (MOE_SWEEP_LRS says where
    training parts the two), exact launches (a batched step: one grouped B1
    and B2 a norm and one B3 and B4 for all 8 candidates),
    candidate-steps/s of both printed.  Returns ({path: launches},
    summary)."""
    from repro_torch.configs import get_config
    from repro_torch.core import tuning

    cfg = get_config("mixtral-8x22b").replace(n_layers=2).scaled(1 / 24, min_d_head=64)
    cands = tuning.grid_candidates(lr=MOE_SWEEP_LRS, alpha_output=MOE_SWEEP_ALPHAS)
    n, steps = len(cands), MOE_SWEEP_STEPS
    kw = dict(steps=steps, batch_size=SWEEP_BATCH, seq_len=SWEEP_SEQ, device="cuda")
    log(f"[sweep_moe] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff {cfg.d_ff}, "
        f"{cfg.n_experts} experts top-{cfg.top_k}, vocab {cfg.vocab_size}, µP base d_model "
        f"{cfg.base_d_model}; {n} candidates x {steps} steps of {SWEEP_BATCH} x {SWEEP_SEQ}")
    tuning.train_proxy_batched(cfg, cands[:1], steps=1, batch_size=2, seq_len=8)  # warm-up
    paths = {}
    t0 = time.perf_counter()
    bat, paths["sweep_moe"] = sweep_counts(
        ops, f"MoE batched sweep, {n} candidates x {steps} steps",
        lambda: tuning.train_proxy_batched(cfg, cands, **kw),
        step_launches(cfg, steps, grouped=True))
    t_bat = time.perf_counter() - t0
    t0 = time.perf_counter()
    ser, paths["sweep_moe_serial"] = sweep_counts(
        ops, "the MoE serial loop", lambda: tuning.train_proxy_serial(cfg, cands, **kw),
        step_launches(cfg, n * steps, grouped=False))
    t_ser = time.perf_counter() - t0
    if not (np.isfinite(bat.curves).all() and np.isfinite(ser.curves).all()):
        raise AssertionError(f"non-finite MoE sweep curves: {bat.curves} / {ser.curves}")
    if not (bat.curves[-1] < bat.curves[0]).all():
        raise AssertionError(f"a candidate's loss did not fall: {bat.curves}")
    rel_by_step = np.abs(bat.curves / ser.curves - 1).max(axis=1)
    if not rel_by_step.max() <= SWEEP_RTOL:
        raise AssertionError(f"MoE batched curves {rel_by_step.tolist()} from serial by "
                             f"step (rtol {SWEEP_RTOL})")
    rate_b, rate_s = n * steps / t_bat, n * steps / t_ser
    log(f"[sweep_moe] batched curves from the serial loop's by step "
        f"{np.round(rel_by_step, 8).tolist()} (rtol {SWEEP_RTOL}); best batched "
        f"{bat.best_index}, serial {ser.best_index}; batched {t_bat:.2f} s "
        f"({rate_b:.1f} candidate-steps/s), serial {t_ser:.2f} s ({rate_s:.1f}): "
        f"{rate_b / rate_s:.2f}x; scores {np.round(bat.losses, 4).tolist()}")
    return paths, dict(batched_vs_serial_rel_by_step=rel_by_step.tolist(),
                       best_batched=bat.best_index, best_serial=ser.best_index,
                       candidate_steps_per_s=rate_b, serial_candidate_steps_per_s=rate_s,
                       batched_s=t_bat, serial_s=t_ser, scores=bat.losses.tolist())

# ---------------------------------------------------------------------------
# sweep_amp: the HP sweep and Algorithm 1 under --amp, B5-B7 over a
# candidate axis
# ---------------------------------------------------------------------------

# (label, candidates N, B, S, H, K, d, window, softcap): the proxy's batched
# attention (16 candidates x 8 x 64 tokens, 4 heads of 64: mup-gpt 0.25x),
# timed; and gemma2's heads at DP 256 (8/4 of 256, two key tiles a row, a
# window and softcap), where each kernel's grid splits the output's columns
# in halves, with the candidates folded into B
CAND_CASES = [("the proxy's batched step", 16, 8, 64, 4, 4, 64, 0, 0.0),
              ("gemma2 heads 8/4 of 256", 4, 1, 256, 8, 4, 256, 48, 50.0)]
# the kernels' launch-count names by operand mode (int8: the pre-passes too)
MODE_LAUNCHES = {"none": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                 "bf16": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                 "int8": ("flash_fwd_int8", "flash_bwd_dq_int8", "flash_bwd_dkv_int8",
                          "flash_fwd_quant_int8", "flash_bwd_quant_int8")}
AMPS = ("bf16", "int8")
AMP_SWEEP_STEPS = 10        # the 16-candidate amp sweeps (30 in the f32 sweep)
AMP_SWEEP_PATHS = ("sweep_amp_bf16", "sweep_amp_bf16_serial", "sweep_amp_int8",
                   "sweep_amp_int8_serial", "algorithm1_amp")
AMP_GROUPED_PATHS = ("sweep_amp_bf16", "sweep_amp_int8", "algorithm1_amp")
CC_AMP_LRS = (1e-2, 2e-2, 4e-2)   # the u-µP int8 coord check's; 2e-2 is the reference's
CC_AMP_LR = 2e-2
# Under amp, batched and serial steps differ only in the f32 GEMMs' summation
# order (cuBLAS batched against single GEMMs); a bf16 or int8 rounding on a
# boundary then flips, and Adam (eps 1e-8) grows the flip step by step: the
# bf16 curves stood 5.2e-6 apart at step 0 and 3.45e-3 at step 5, the
# int8 ones 8.0e-5 and 1.05e-2 (an H100 at 700 W).  Each step is held
# within AMP_NOISE_FACTOR times the distance, at that step, of the serial
# loop from itself started 1 ulp away (every weight moved to a neighbouring
# float32: the policy's own rounding noise, 7.3e-5 at int8's step 0), or
# within a floor: at step 0, on equal weights, the CPU tests' bar for one
# amp loss (1e-4), later SWEEP_RTOL.
AMP_STEP0_RTOL = 1e-4
AMP_NOISE_FACTOR = 4.0


def cand_scales(n):
    """A power-of-two scale per candidate (a swept alpha_attn times 1/d)."""
    return torch.tensor([2.0 ** -(3 + i % 3) for i in range(n)], device="cuda")


def fold(t):
    """(N, B, ...) -> (N * B, ...), contiguous."""
    return t.reshape(-1, *t.shape[2:]).contiguous()


def candidate_case(ops, fa, ref, quant, case, mode, seed):
    """One CAND_CASES row in one operand mode, through ops.attention under
    torch.func.vmap (what the sweep runs): exactly one launch of each of the
    mode's kernels for the N candidates; candidate i's output and gradients
    equal ops.attention on candidate i alone, bit for bit; the folded
    outputs against the plain versions (ops.attention_plain_flash under the
    same vmap) at the mode's tiers; in the int8 mode both pre-passes of the
    folded batch byte for byte against their plain versions and against
    each candidate's own launch.  Returns (max errors, folded inputs)."""
    label, N, B, S, H, K, d, window, cap = case
    policy = quant.QuantPolicy(mode)
    kw = dict(causal=True, window=window, softcap=cap, policy=policy)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(N, B, S, H, d, device="cuda", generator=gen) for _ in range(2))
    k, v = (torch.randn(N, B, S, K, d, device="cuda", generator=gen) for _ in range(2))
    scales = cand_scales(N)
    what = f"flash attention over {N} candidates, {label}, {mode} operands"

    def vmapped(attend):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = torch.func.vmap(lambda a, b, c, s: attend(a, b, c, scale=s, **kw))(*leaves, scales)
        return [o.detach(), *torch.autograd.grad(o, leaves, do)]

    ops.reset_launch_counts()
    got = vmapped(ops.attention)
    torch.cuda.synchronize()
    counts = {n: c for n, c in ops.launch_counts().items() if c}
    if counts != dict.fromkeys(MODE_LAUNCHES[mode], 1):
        raise AssertionError(f"{what}: launches {counts}, not one of each of "
                             f"{MODE_LAUNCHES[mode]}")
    for i in range(N):
        leaves = [t[i].clone().requires_grad_(True) for t in (q, k, v)]
        oi = ops.attention(*leaves, scale=float(scales[i]), **kw)
        alone = [oi.detach(), *torch.autograd.grad(oi, leaves, do[i])]
        differ = [n for n, g, a in zip(("o", "dq", "dk", "dv"), got, alone)
                  if not torch.equal(g[i], a)]
        if differ:
            raise AssertionError(f"{what}: candidate {i}'s {differ} differ from its own launch")
    want = vmapped(ops.attention_plain_flash)
    errs = {}
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        if mode == "none":
            errs[name] = check_close(f"{what} {name}", g, w,
                                     *((ATOL[torch.float32],) if name == "o"
                                       else GRAD_TOL[torch.float32]))
        else:
            errs[name] = check_rounded(what, name, g, w,
                                       INT8_MAX_TOL if mode == "int8" else FLASH_MAX_TOL)[0]
    qf = fold((q * scales.view(-1, 1, 1, 1, 1)))
    kf, vf, dof = fold(k), fold(v), fold(do)
    if mode == "int8":   # the pre-passes of the folded batch, byte for byte
        for name, folded, plain, alone, fields in (
                ("forward", fa.quantize_fwd(kf, vf), ref.flash_quant_fwd_ref(kf, vf),
                 [fa.quantize_fwd(kf[i * B:(i + 1) * B], vf[i * B:(i + 1) * B])
                  for i in range(N)], fa.FWD_I8_FIELDS),
                ("backward", fa.quantize_bwd(qf, kf, vf, dof),
                 ref.flash_quant_bwd_ref(qf, kf, vf, dof),
                 [fa.quantize_bwd(*(t[i * B:(i + 1) * B] for t in (qf, kf, vf, dof)))
                  for i in range(N)], fa.I8_FIELDS)):
            differ = [n for n in fields if not torch.equal(folded[n], plain[n])
                      or not torch.equal(folded[n], torch.cat([a[n] for a in alone]))]
            if differ:
                raise AssertionError(f"{what}: the {name} pre-pass's {differ} differ from "
                                     f"the plain version or the candidates' own launches")
    return errs, (qf, kf, vf, dof)


def candidate_timing(ops, fa, ref, quant, F, case, mode, folded):
    """The folded launch of each of the mode's kernels against N separate
    launches (device us from the profiler: the folded launch's time and N
    times a separate launch's), a call's ms on the card's clock, the plain
    version over the folded batch, SDPA bf16 over the folded batch (the
    f32 and bf16 modes' library call; none is int8) and the bound from this
    run's bytes and visible pairs."""
    label, N, B, S, H, K, d, window, cap = case
    qf, kf, vf, dof = folded
    kw = dict(causal=True, window=window, softcap=cap,
              policy=quant.QuantPolicy(mode) if mode != "none" else None)
    o, lse = fa.flash_fwd(qf, kf, vf, **kw)
    delta = (dof * o).sum(-1).transpose(1, 2).contiguous()

    def sl(t, i):
        return t[i * B:(i + 1) * B]

    calls = {"flash_fwd": lambda t: fa.flash_fwd(*t[:3], **kw),
             "flash_bwd_dq": lambda t: fa.flash_bwd_dq(*t, **kw),
             "flash_bwd_dkv": lambda t: fa.flash_bwd_dkv(*t, **kw)}
    plain = {"flash_fwd": lambda t: ref.flash_fwd_ref(*t[:3], **kw),
             "flash_bwd_dq": lambda t: ref.flash_bwd_ref(*t, **kw),
             "flash_bwd_dkv": lambda t: ref.flash_bwd_ref(*t, **kw)}
    args = (qf, kf, vf, dof, lse, delta)
    if mode == "int8":
        calls["flash_fwd_quant"] = lambda t: fa.quantize_fwd(t[1], t[2])
        calls["flash_bwd_quant"] = lambda t: fa.quantize_bwd(*t[:4])
        plain["flash_fwd_quant"] = lambda t: ref.flash_quant_fwd_ref(t[1], t[2])
        plain["flash_bwd_quant"] = lambda t: ref.flash_quant_bwd_ref(*t[:4])
    pairs = N * B * H * visible_pairs(S, window)
    io, iok, rows = qf.numel() * 4, kf.numel() * 4, N * B * H * S * 4
    rate = {"none": F32_FLOP_PER_S, "bf16": BF16_TC_FLOP_PER_S, "int8": INT8_TC_OP_PER_S}[mode]
    i8_out = {"flash_fwd_quant": sum(math.prod(s) * (1 if dt == torch.int8 else 4) for s, dt in
                                     fa.fwd_i8_shapes(N * B, S, K, d).values()),
              "flash_bwd_quant": sum(math.prod(s) * (1 if dt == torch.int8 else 4) for s, dt in
                                     fa.i8_shapes(N * B, S, S, H, K, d).values())}
    work = {"flash_fwd": (io + 2 * iok + io + rows, 4 * d * pairs, rate),
            "flash_bwd_dq": (2 * io + 2 * iok + 2 * rows + io, 6 * d * pairs, rate),
            "flash_bwd_dkv": (2 * io + 2 * iok + 2 * rows + 2 * iok, 8 * d * pairs, rate),
            # ~4 f32 operations (abs-max, divide, round, clamp) a value quantized
            "flash_fwd_quant": (2 * iok + i8_out["flash_fwd_quant"], 8 * kf.numel(),
                                F32_FLOP_PER_S),
            "flash_bwd_quant": (2 * io + 2 * iok + i8_out["flash_bwd_quant"],
                                4 * (4 * qf.numel() + 3 * qf.numel()), F32_FLOP_PER_S)}
    sfx = "_int8" if mode == "int8" else ""
    out = {}
    for name, call in calls.items():
        key = name + sfx
        one = lambda c=call: c(args)                                       # noqa: E731
        apart = lambda c=call: [c(tuple(sl(t, i) for t in args)) for i in range(N)]  # noqa: E731
        dev = device_us(one, key)
        dev_apart = device_us(apart, key) * N
        b = bound(*work[name])
        out[key] = dict(ms=cuda_ms(one), device_us=dev, apart_device_us=dev_apart,
                        apart_ms=cuda_ms(apart, n=20), plain_ms=cuda_ms(lambda p=plain[name]:
                                                                          p(args), n=5, warmup=1),
                        bound_ms=b[0], bound_by=b[1], share_of_bound=b[0] * 1e3 / dev)
    if mode != "int8":   # SDPA over the folded batch, bf16, causal (no window, no softcap)
        qb, kb, vb, dob = (t.transpose(1, 2).bfloat16().contiguous().requires_grad_(t is not dof)
                           for t in (qf, kf, vf, dof))
        sdpa = lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=True,  # noqa: E731
                                                      enable_gqa=True)
        with torch.no_grad():
            lib_fwd = cuda_ms(sdpa)
        lib_fwd_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qb, kb, vb), dob))
        for key in out:
            out[key]["library_ms"] = lib_fwd if key == "flash_fwd" else lib_fwd_bwd
    log(f"[sweep_amp] {mode} operands over {N} candidates folded into B ({label}: "
        f"({N} x {B}, {S}, {H}/{K} heads of {d}), causal"
        + (f", window {window}, softcap {cap:g}" if window or cap else "") + "): "
        + "; ".join(f"{k} {r['ms']:.4f} ms a call, {r['device_us']:.2f} us on the card in one "
                    f"launch ({N} separate launches {r['apart_device_us']:.2f} us, "
                    f"{r['apart_device_us'] / r['device_us']:.2f}x; {r['apart_ms']:.4f} ms "
                    f"a call), bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} "
                    f"({r['share_of_bound']:.1%}), plain {r['plain_ms']:.4f} ms"
                    + (f", SDPA bf16 {r['library_ms']:.4f} ms" if "library_ms" in r else "")
                    for k, r in out.items()))
    del o, lse, delta
    return out


def candidate_kernel_phase(ops, fa, ref, quant, F):
    """B5, B6, B7 and the int8 pre-passes over a candidate axis in every
    operand mode (CAND_CASES), checked by candidate_case; the proxy's shape
    timed by candidate_timing.  Returns {mode: {kernel: timing}} and the
    worst errors."""
    timing, worst = {}, {}
    for c, case in enumerate(CAND_CASES):
        for mode in FLASH_MODES:
            errs, folded = candidate_case(ops, fa, ref, quant, case, mode, 300 + c)
            worst[(case[0], mode)] = errs
            if c == 0:
                timing[mode] = candidate_timing(ops, fa, ref, quant, F, case, mode, folded)
                timing[mode]["max_abs_err"] = errs
            del folded
            torch.cuda.empty_cache()
    log("[sweep_amp] B5-B7 over a candidate axis: one launch of each kernel (and pre-pass) "
        "for N candidates through ops.attention under torch.func.vmap, each candidate's "
        "slice bit-equal to its own launch, pre-passes byte for byte; max err against the "
        "plain versions " + "; ".join(f"{label} {mode}: " + ", ".join(
            f"{n} {e:.3g}" for n, e in errs.items()) for (label, mode), errs in worst.items()))
    return timing


def amp_step_launches(cfg, steps, grouped, forwards=1):
    """step_launches plus B5-B7 (and under int8 both pre-passes), one a
    layer a step, B5 ``forwards`` times a step."""
    n = cfg.n_layers * steps
    out = step_launches(cfg, steps, grouped)
    for name in MODE_LAUNCHES[cfg.amp]:
        out[name] = n * (forwards if name.startswith("flash_fwd") else 1)
    return out


def ulp_jittered_init(cfg):
    """The engine's default init with every weight moved to a neighbouring
    float32 (up or down, from a seeded draw): an init_fn one ulp away."""
    from repro_torch.core import tuning
    from repro_torch.models.model import Model

    init = tuning._default_init(Model(cfg.replace(dtype="float32"), device="cuda"))

    def jittered(gens, hp):
        gen = torch.Generator(device="cuda").manual_seed(1)
        return {k: torch.nextafter(v, torch.where(
            torch.rand(v.shape, device="cuda", generator=gen) < 0.5, -math.inf, math.inf))
            for k, v in init(gens, hp).items()}
    return jittered


def sweep_amp_policy(ops, cfg, amp, paths):
    """The proxy's sweep under one policy: the reference's three candidates
    and lr 1e25 batched against serial (within the bar AMP_NOISE_FACTOR
    sets, the diverging one pruned and frozen bit for bit, the others
    unmoved by it), then 16
    candidates batched and serial: candidate-steps/s, busy share, peak
    memory; exact launches throughout."""
    from repro_torch.core import tuning
    from repro_torch.core.hpspace import mup_space
    from repro_torch.core.transfer import HParams

    acfg = cfg.replace(amp=amp)
    cands = [HParams(**c) for c in SWEEP_CANDIDATES]
    kw = dict(steps=SWEEP_STEPS, batch_size=SWEEP_BATCH, seq_len=SWEEP_SEQ, device="cuda")
    tuning.train_proxy_batched(acfg, cands[:1], steps=1, batch_size=2, seq_len=8)  # warm-up
    path = f"sweep_amp_{amp}"
    bat, paths[path] = sweep_counts(
        ops, f"batched sweep --amp {amp}, {len(cands)} candidates x {SWEEP_STEPS} steps",
        lambda: tuning.train_proxy_batched(acfg, cands, **kw),
        amp_step_launches(acfg, SWEEP_STEPS, grouped=True))
    ser, paths[path + "_serial"] = sweep_counts(
        ops, f"the serial loop --amp {amp}", lambda: tuning.train_proxy_serial(acfg, cands, **kw),
        lambda res: amp_step_launches(
            acfg, int(np.isfinite(res.curves).sum() + (~res.active).sum()), grouped=False))
    alone = tuning.train_proxy_batched(acfg, cands[:3], **kw)
    noisy = tuning.train_proxy_serial(acfg, cands[:3], init_fn=ulp_jittered_init(acfg), **kw)
    fin = np.isfinite(ser.losses)
    if not (np.array_equal(np.isfinite(bat.losses), fin) and fin[:3].all() and not fin[3]):
        raise AssertionError(f"--amp {amp}: finite scores batched {bat.losses}, serial "
                             f"{ser.losses}")
    rel_by_step = np.abs(bat.curves[:, :3] / ser.curves[:, :3] - 1).max(axis=1)
    noise_by_step = np.abs(noisy.curves / ser.curves[:, :3] - 1).max(axis=1)
    floor = np.full_like(noise_by_step, SWEEP_RTOL)
    floor[0] = AMP_STEP0_RTOL
    bar = np.maximum(floor, AMP_NOISE_FACTOR * noise_by_step)
    rel = float(rel_by_step.max())
    moved = float(np.abs(bat.curves[:, :3] / alone.curves - 1).max())
    if not ((rel_by_step <= bar).all() and moved <= SWEEP_RTOL):
        raise AssertionError(
            f"--amp {amp}: batched curves from serial by step {rel_by_step.tolist()} (limits "
            f"{bar.tolist()}: the serial loop 1 ulp away by step {noise_by_step.tolist()}), "
            f"{moved:.3g} from the run without the diverging candidate (rtol {SWEEP_RTOL})")
    diverged = int(np.argmax(np.isinf(bat.curves[:, 3])))
    if bat.active[3] or not np.isinf(bat.curves[diverged:, 3]).all():
        raise AssertionError(f"--amp {amp}: the lr 1e25 candidate was not pruned for good")
    frozen = frozen_check(acfg, cands)
    log(f"[sweep_amp] --amp {amp}, the full-size proxy: batched curves within {rel:.3g} of "
        f"the serial loop's (by step {np.round(rel_by_step, 7).tolist()}; limits "
        f"{np.round(bar, 7).tolist()}: the serial loop started 1 ulp away moved by step "
        f"{np.round(noise_by_step, 7).tolist()}); "
        f"lr 1e25 pruned at step {diverged}, frozen bit for bit over {frozen} steps; the "
        f"others {moved:.3g} from the run without it")

    c16 = mup_space().sample_n(16, seed=0)
    kw16 = dict(kw, steps=AMP_SWEEP_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    b16, launches = sweep_counts(
        ops, f"batched sweep --amp {amp}, 16 candidates x {AMP_SWEEP_STEPS} steps",
        lambda: tuning.train_proxy_batched(acfg, c16, **kw16),
        amp_step_launches(acfg, AMP_SWEEP_STEPS, grouped=True))
    t_bat = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k, v in launches.items():
        paths[path][k] += v
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s16, launches = sweep_counts(
        ops, f"the serial loop --amp {amp}, 16 candidates",
        lambda: tuning.train_proxy_serial(acfg, c16, **kw16),
        lambda res: amp_step_launches(
            acfg, int(np.isfinite(res.curves).sum() + (~res.active).sum()), grouped=False))
    t_ser = time.perf_counter() - t0
    speak = torch.cuda.max_memory_allocated() / 2**30
    for k, v in launches.items():
        paths[path + "_serial"][k] += v
    both = np.isfinite(b16.curves) & np.isfinite(s16.curves)
    rate_b = 16 * b16.steps_run / t_bat
    rate_s = float(np.isfinite(s16.curves).sum() + (~s16.active).sum()) / t_ser
    wall, busy, n_launch, top = busy_profile(
        lambda: tuning.train_proxy_batched(acfg, c16, **dict(kw16, steps=5)))
    swall, sbusy, _, _ = busy_profile(
        lambda: tuning.train_proxy_serial(acfg, c16[:4], **dict(kw16, steps=5)))
    log(f"[sweep_amp] --amp {amp}, 16 candidates x {AMP_SWEEP_STEPS} steps (sample_n(16, 0)): "
        f"batched {t_bat:.2f} s ({rate_b:.1f} candidate-steps/s), serial {t_ser:.2f} s "
        f"({rate_s:.1f}); speedup {rate_b / rate_s:.2f}x; {int(both.sum())} step losses "
        f"finite in both, max rel diff {np.abs(b16.curves[both] / s16.curves[both] - 1).max():.3g}; "
        f"peak memory batched {peak:.2f} GiB, serial {speak:.2f} GiB; card busy "
        f"{busy / wall:.1%} of 5 batched steps under the profiler ({busy:.1f} of {wall:.1f} ms, "
        f"{n_launch} launches), {sbusy / swall:.1%} of the serial loop's (4 candidates)")
    for k, ms, cnt in top:
        log(f"[sweep_amp]   {ms:9.3f} ms  x{cnt:<5d} {k}")
    return dict(batched_vs_serial_rel=rel, rel_by_step=rel_by_step.tolist(),
                ulp_noise_by_step=noise_by_step.tolist(),
                moved_by_diverged=moved, frozen_steps=frozen, candidate_steps_per_s=rate_b,
                serial_candidate_steps_per_s=rate_s, speedup=rate_b / rate_s, peak_gib=peak,
                serial_peak_gib=speak, busy_share=busy / wall,
                serial_busy_share=sbusy / swall, batched_s=t_bat, serial_s=t_ser,
                best_batched=b16.best_index, best_serial=s16.best_index)


def algorithm1_amp(ops, paths):
    """Algorithm 1 under int8 u-µP through Experiment: the coord check
    batched over CC_AMP_LRS at d_model 256/512/1024 (lr CC_AMP_LR's
    logits.delta slope held below COORD_SLOPE_MAX), tune(n_samples=16,
    steps=10) and the d_model-1024 target trained 5 steps (finite, falling
    losses), with exact launches."""
    from repro_torch.api import Experiment

    exp = Experiment.from_config("mup-gpt", smoke=False, parametrization="umup", amp="int8")
    proxy = exp.proxy(0.25, min_d_head=64)
    cfg = proxy.cfg
    L, norms = cfg.n_layers, 2 * cfg.n_layers + 1
    # per width and step (9): the batched step, and B1, B3 and B5 once more
    # for the initial params' activations (ungrouped, no backward)
    want = amp_step_launches(cfg, 9, grouped=True, forwards=2)
    want.update({"rmsnorm": 9 * norms, "ce_fwd": 18})
    ops.reset_launch_counts()
    cc = proxy.coord_check(lrs=CC_AMP_LRS, widths=(1.0, 2.0, 4.0))
    tuned = proxy.tune(n_samples=16, steps=AMP_SWEEP_STEPS)
    target = proxy.transfer(exp)
    out = target.train(steps=5, log_every=0)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    for k, v in amp_step_launches(cfg, AMP_SWEEP_STEPS, grouped=True).items():
        want[k] = want.get(k, 0) + v
    for k, v in amp_step_launches(exp.cfg, 5, grouped=False).items():
        want[k] = want.get(k, 0) + v
    full = dict.fromkeys(launches, 0)
    full.update(want)
    log(f"[sweep_amp] algorithm1_amp: launches {({k: v for k, v in launches.items() if v})}")
    if launches != full:
        raise AssertionError(f"algorithm1_amp: launch counts {launches} != {full}")
    paths["algorithm1_amp"] = launches
    slopes = {lr: cc.growth("logits.delta", candidate=i) for i, lr in enumerate(CC_AMP_LRS)}
    losses = out["losses"]
    h = tuned.best
    log(f"[sweep_amp] u-µP coord check --amp int8 at d_model {sorted(cc.records)}: "
        f"logits.delta slope by lr { {lr: round(s, 4) for lr, s in slopes.items()} } (lr "
        f"{CC_AMP_LR} held < {COORD_SLOPE_MAX}); tune: best lr={h.lr:.3e} "
        f"alpha_output={h.alpha_output:g} alpha_attn={h.alpha_attn:g} (score "
        f"{tuned.best_loss:.4f}); the target (d_model {exp.cfg.d_model}) 5 steps: losses "
        f"{np.round(losses, 4).tolist()}")
    if not slopes[CC_AMP_LR] < COORD_SLOPE_MAX:
        raise AssertionError(f"u-µP int8 coord check: logits.delta slope {slopes[CC_AMP_LR]}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the int8 u-µP target's losses {losses} are not finite and falling")
    return dict(coord_slopes={str(k): v for k, v in slopes.items()},
                tuned_score=tuned.best_loss, target_losses=losses)


def attach_candidate_axis(rows, timing):
    """The candidate-axis timings under the rows of B5-B7 (f32 and bf16
    modes), their int8 rows and the pre-passes' rows, as
    ``candidate_axis``."""
    label, N, B, S, H, K, d = CAND_CASES[0][:7]
    shape = f"q, k, v, do ({N} candidates x {B}, {S}, {H}/{K} heads of {d}) f32, causal"
    for row in rows:
        name = row["name"]
        if name in FLASH_NAMES:
            row["candidate_axis"] = dict(shape=shape, bf16=timing["bf16"][name],
                                         f32_operands=timing["none"][name])
        elif name in timing["int8"]:
            row["candidate_axis"] = dict(shape=shape, int8=timing["int8"][name])


def sweep_amp_phase(ops, fa, ref, quant, F):
    """B5-B7 over a candidate axis, the proxy's sweep under --amp bf16 and
    --amp int8, and Algorithm 1 under int8 u-µP (see the module note).
    Returns ({mode: {kernel: timing}}, {path: launches}, summary)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    timing = candidate_kernel_phase(ops, fa, ref, quant, F)
    cfg = get_config("mup-gpt").proxy(0.25, min_d_head=64)
    paths, info = {}, {}
    for amp in AMPS:
        info[amp] = sweep_amp_policy(ops, cfg, amp, paths)
    info["algorithm1_amp"] = algorithm1_amp(ops, paths)
    info["seconds"] = time.perf_counter() - t0
    log(f"[sweep_amp] the phase took {info['seconds']:.1f} s")
    return timing, paths, info

# ---------------------------------------------------------------------------
# obs phase: metrics, µP-health telemetry and phase tracing on the main paths
# ---------------------------------------------------------------------------

# the flattened record of the reference's make_train_step(telemetry=True) for
# mup-gpt (8 layers of "attn"), as the reference emits it on the CPU (its keys
# do not depend on width; tests/test_torch_obs.py holds the port's keys to
# the reference's live)
MUP_GPT_OBS_KEYS = (
    *(f"block/0_attn/{i}" for i in range(8)), "embed", "final_norm", "logits",
    "u2w/embed", "u2w/final_norm",
    *(f"u2w/groups/0_attn/{p}" for p in ("attn/wk", "attn/wo", "attn/wq", "attn/wv", "ln1",
                                          "ln2", "mlp/wi", "mlp/wo")),
)
OBS_STEPS, OBS_AMP_STEPS = 10, 3
# the reference's drift test (tests/test_obs.py) at mup-gpt's published
# widths: the proxy's 0.25x (d_model 256, the base shape) against 1x (1024),
# 3 Adam(W) steps of 8 x 32 at lr 1e-2, activation keys, tol 0.25; SP must
# be flagged with a max |slope| above 0.5, µP and u-µP must not
DRIFT_STEPS, DRIFT_BATCH, DRIFT_SEQ, DRIFT_LR, DRIFT_TOL, DRIFT_MIN_SLOPE = 3, 8, 32, 1e-2, 0.25, 0.5


@contextlib.contextmanager
def recorded_train_steps():
    """While open, each train step that ``launch.steps.make_train_step``
    builds keeps its grad norm (the 0-d tensor, no sync) and a CUDA-event
    pair recorded inside the step's call (its device window: inside the
    train loop's ``train_step`` span)."""
    from repro_torch.launch import steps as steps_lib

    real = steps_lib.make_train_step
    rec = []

    def make(*a, **kw):
        step = real(*a, **kw)

        def run(params, opt_state, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(params, opt_state, batch)
            end.record()
            rec.append((out[2]["grad_norm"], start, end))
            return out
        return run

    steps_lib.make_train_step = make
    try:
        yield rec
    finally:
        steps_lib.make_train_step = real


def obs_train_run(ops, cfg, steps, obs):
    """train_loop over mup-gpt's full width with ``obs`` (or none): losses,
    grad norms, step windows' device ms, launches, host seconds a step and
    the loop's wall."""
    from repro_torch.core.transfer import HParams
    from repro_torch.launch.train import train_loop

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with recorded_train_steps() as rec:
        t0 = time.perf_counter()
        out = train_loop(cfg, steps, HParams(), batch_size=8, seq_len=512, seed=0,
                         log_every=0, device="cuda", obs=obs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    del out["params"]
    return dict(losses=out["losses"], grad_norms=torch.stack([g for g, _, _ in rec]).cpu(),
                device_ms=[s.elapsed_time(e) for _, s, e in rec], launches=launches,
                step_seconds=out["step_seconds"], wall_s=wall)


def obs_train(ops, amp, steps):
    """train_obs (amp "") or its --amp bf16 run: the loop with
    TrainObs(metrics, telemetry=True, every=1, tracer) against the same loop
    without obs."""
    from repro_torch.configs import get_config
    from repro_torch.obs import MetricsRegistry, Tracer, TrainObs, parse_prometheus

    cfg = get_config("mup-gpt").replace(dtype="float32", amp=amp)
    tag = f"[obs train --amp {amp}]" if amp else "[obs train]"
    plain = obs_train_run(ops, cfg, steps, None)
    torch.cuda.empty_cache()
    obs = TrainObs(metrics=MetricsRegistry(), telemetry=True, every=1, tracer=Tracer(),
                   verbose=False)
    got = obs_train_run(ops, cfg, steps, obs)
    torch.cuda.empty_cache()
    if got["losses"] != plain["losses"] or not torch.equal(got["grad_norms"],
                                                           plain["grad_norms"]):
        raise AssertionError(f"{tag} obs moved the run: losses {got['losses']} vs "
                             f"{plain['losses']}, grad norms {got['grad_norms'].tolist()} vs "
                             f"{plain['grad_norms'].tolist()}")
    n_norm, n_attn = 2 * cfg.n_layers + 1, cfg.n_layers if amp == "bf16" else 0
    per_step = {"rmsnorm": n_norm, "rmsnorm_bwd": n_norm, "ce_fwd": 1, "ce_bwd": 1,
                "flash_fwd": n_attn, "flash_bwd_dq": n_attn, "flash_bwd_dkv": n_attn}
    want = {k: per_step.get(k, 0) * steps for k in plain["launches"]}
    if got["launches"] != want or plain["launches"] != want:
        raise AssertionError(f"{tag} launches with obs {got['launches']}, without "
                             f"{plain['launches']}, expected {want}")
    recs = obs.ring.records
    if len(recs) != steps or any(tuple(r) != MUP_GPT_OBS_KEYS for r in recs):
        raise AssertionError(f"{tag} ring: {len(recs)} records, keys "
                             f"{[list(r) for r in recs[:1]]}, expected {MUP_GPT_OBS_KEYS}")
    if not all(math.isfinite(v) for r in recs for v in r.values()):
        raise AssertionError(f"{tag} non-finite telemetry: {recs[-1]}")
    spans = [e for e in obs.tracer.events if e["name"] == "train_step"]
    short = [(e["dur"] / 1e3, ms) for e, ms in zip(spans, got["device_ms"])
             if not e["dur"] / 1e3 >= ms]
    if len(spans) != steps or short:
        raise AssertionError(f"{tag} {len(spans)} train_step spans; spans shorter than "
                             f"their step's CUDA-event time (ms): {short}")
    fams = parse_prometheus(obs.metrics.to_prometheus())
    if fams["train_steps_total"] != steps or fams["train_tokens_total"] != steps * 8 * 512:
        raise AssertionError(f"{tag} train_steps_total {fams['train_steps_total']}, "
                             f"train_tokens_total {fams['train_tokens_total']}")
    ms = lambda r: 1e3 * float(np.median(r["step_seconds"][1:]))  # noqa: E731
    dev_ms = lambda r: float(np.median(r["device_ms"][1:]))  # noqa: E731
    log(f"{tag} mup-gpt {cfg.n_layers} layers, d_model {cfg.d_model}, batch 8 x 512, "
        f"{steps} steps: losses and grad norms bit-equal with and without obs; launches "
        f"{ {k: v for k, v in got['launches'].items() if v} } both; {len(recs)} records of "
        f"{len(MUP_GPT_OBS_KEYS)} keys; {len(spans)} train_step spans >= their step's "
        f"CUDA-event time (min margin "
        f"{min(e['dur'] / 1e3 - m for e, m in zip(spans, got['device_ms'])):.3f} ms); "
        f"ms/step (median of steps 1-{steps - 1}) with telemetry {ms(got):.2f}, without "
        f"{ms(plain):.2f} ({ms(got) / ms(plain) - 1:+.2%}), the step call's CUDA-event time "
        f"{dev_ms(got):.2f} vs {dev_ms(plain):.2f} ({dev_ms(got) / dev_ms(plain) - 1:+.2%}); "
        f"loop wall {got['wall_s']:.3f} s "
        f"vs {plain['wall_s']:.3f} s (not held); last record: "
        + ", ".join(f"{k} {v:.4g}" for k, v in recs[-1].items() if not k.startswith("u2w/g")))
    return dict(steps=steps, losses=got["losses"], ms_per_step=ms(got),
                plain_ms_per_step=ms(plain), overhead=ms(got) / ms(plain) - 1,
                step_device_ms_median=dev_ms(got), plain_step_device_ms_median=dev_ms(plain),
                wall_s=got["wall_s"], plain_wall_s=plain["wall_s"],
                step_seconds=got["step_seconds"], plain_step_seconds=plain["step_seconds"],
                span_ms=[e["dur"] / 1e3 for e in spans], step_device_ms=got["device_ms"],
                plain_step_device_ms=plain["device_ms"],
                last_record=recs[-1])


def drift_run(cfg, p13n):
    """The reference drift test's run at ``cfg``'s width: telemetry on, the
    last record."""
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.obs import RingBuffer
    from repro_torch.obs.telemetry import to_host
    from repro_torch.optim.optimizer import Optimizer

    cfg = cfg.replace(dtype="float32", parametrization=p13n)
    model = Model(cfg, device="cuda")
    params = model.init(seed=0)
    opt = Optimizer.create("adamw", DRIFT_LR, model.p13n, model.meta)
    state = opt.init(params)
    step = make_train_step(model, opt, telemetry=True)
    pipe = make_pipeline(cfg.vocab_size, DRIFT_SEQ, DRIFT_BATCH, seed=0)
    ring = RingBuffer()
    for t in range(DRIFT_STEPS):
        batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch(t).items()}
        params, state, metrics = step(params, state, batch)
        ring.append(to_host(metrics["obs"]))
    return cfg.d_model, ring


def obs_drift():
    """The drift detector at mup-gpt's published widths: built on the
    proxy's 0.25x run, observing the 1x run, for µP, u-µP and SP."""
    from repro_torch.configs import get_config
    from repro_torch.obs import DriftDetector

    full = get_config("mup-gpt")
    out = {}
    for p13n in ("mup", "umup", "sp"):
        base_w, base_ring = drift_run(full.proxy(0.25, min_d_head=64), p13n)
        keys = [k for k in base_ring.last()[0]
                if k.startswith(("block/", "embed", "final_norm"))]
        det = DriftDetector.from_ring(base_w, base_ring, last_n=1, keys=keys, tol=DRIFT_TOL)
        wide_w, wide_ring = drift_run(full, p13n)
        rep = det.observe(wide_w, wide_ring.last()[0])
        worst = max(abs(s) for s in rep.slopes.values())
        log(f"[obs drift] {p13n}: d_model {base_w} -> {wide_w}, {len(keys)} activation keys, "
            f"max |slope| {worst:.3f}: {rep}")
        if p13n == "sp" and (rep.ok or not max(abs(s) for s in rep.flagged.values())
                             > DRIFT_MIN_SLOPE):
            raise AssertionError(f"SP at {wide_w} escaped the drift detector: {rep.slopes}")
        if p13n != "sp" and not rep.ok:
            raise AssertionError(f"false positive on {p13n}: {rep.flagged}")
        out[p13n] = dict(ok=rep.ok, slopes=rep.slopes, max_abs_slope=worst)
    return out


def obs_serve(ops, cfg, Model, Engine, DynamicEngine, EngineConfig, dyn_cached):
    """serve_obs: smollm-135m through DynamicEngine (the serve_dynamic
    workload) and Engine (the serve phase's), each with and without
    ServeObs(tracer=Tracer())."""
    from repro_torch.obs import ServeObs, Tracer, parse_prometheus

    R, S, Pmax, Gmax, P, CH = 16, 4, 256, 64, 16, 64
    kern = Model(cfg, device="cuda")
    params = kern.init(seed=0)
    kw = dict(n_slots=S, page_size=P, max_prompt_len=Pmax, max_gen_len=Gmax)
    prompts, lens = shared_prefix_workload(cfg.vocab_size, R, Pmax, seed=2)
    rng = np.random.default_rng(0)
    slens = rng.integers(64, Pmax + 1, 8)
    sprompts = rng.integers(0, cfg.vocab_size, (8, Pmax))
    # warm-up outside the compared serves
    DynamicEngine(kern, EngineConfig(prefill_chunk=CH, prefix_cache=True, **kw)).serve(
        params, prompts[:2], lens[:2])

    def run(make, prompts, lens, obs):
        engine = make(obs)
        window = []
        if obs is not None and isinstance(engine, Engine) and not isinstance(
                engine, DynamicEngine):
            inner = engine._serve

            def timed(*a):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = inner(*a)
                end.record()
                window.append((start, end))
                return out
            engine._serve = timed
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = engine.serve(params, prompts, lens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, ops.launch_counts(), wall, [s.elapsed_time(e) for s, e in window]

    summary = {}
    for what, make, P_, L_ in (
            ("dynamic", lambda o: DynamicEngine(kern, EngineConfig(
                prefill_chunk=CH, prefix_cache=True, **kw), obs=o), prompts, lens),
            ("static", lambda o: Engine(kern, EngineConfig(**kw), obs=o), sprompts, slens)):
        tag = f"[obs serve {what}]"
        # in turns, without, with, with, without: each a fresh engine (a cold
        # prefix cache); the tok/s compared are each side's best
        base, base_l, base_wall, _ = run(make, P_, L_, None)
        walls, base_walls = [], [base_wall]
        for turn in ("obs", "obs", None):
            obs_t = ServeObs(tracer=Tracer()) if turn else None
            out_t, l_t, wall_t, win_t = run(make, P_, L_, obs_t)
            if not torch.equal(out_t["tokens"], base["tokens"]) or out_t["steps"] != base["steps"]:
                raise AssertionError(f"{tag} obs changed the tokens or the steps")
            if l_t != base_l:
                raise AssertionError(f"{tag} launches {'with' if turn else 'without'} obs "
                                     f"{l_t}, without {base_l}")
            if turn and not walls:
                obs, got, window = obs_t, out_t, win_t
            (walls if turn else base_walls).append(wall_t)
        got_l, wall, base_wall = base_l, min(walls), min(base_walls)
        n_tok = int(got["lengths"].sum())
        fams = parse_prometheus(obs.metrics.to_prometheus())
        if fams["serve_tokens_total"] != n_tok or fams["serve_steps_total"] != got["steps"] \
                or fams["serve_requests_total"] != len(L_):
            raise AssertionError(f"{tag} serve_tokens_total {fams['serve_tokens_total']} "
                                 f"({n_tok}), serve_steps_total {fams['serve_steps_total']} "
                                 f"({got['steps']})")
        ev = obs.tracer.events
        info = dict(tokens=n_tok, steps=got["steps"], tok_per_s=n_tok / wall,
                    plain_tok_per_s=n_tok / base_wall, walls_s=walls, plain_walls_s=base_walls,
                    launches={k: v for k, v in got_l.items() if v})
        if what == "dynamic":
            steps = [e for e in ev if e["name"] == "step"]
            phases = {}
            for e in steps:
                phases[e["args"]["phase"]] = phases.get(e["args"]["phase"], 0) + 1
            if len(steps) != got["steps"] or set(phases) - {"prefill", "chunk_prefill",
                                                            "decode"}:
                raise AssertionError(f"{tag} {len(steps)} step spans for {got['steps']} "
                                     f"steps, phases {phases}")
            if fams["prefill_cached_tokens_total"] != dyn_cached \
                    or got["prefill_cached"] != dyn_cached:
                raise AssertionError(
                    f"{tag} prefill_cached_tokens_total {fams['prefill_cached_tokens_total']}, "
                    f"the serve's {got['prefill_cached']}, serve_dynamic's {dyn_cached}")
            if fams["serve_ttft_seconds"]["count"] != R:
                raise AssertionError(f"{tag} TTFT count {fams['serve_ttft_seconds']['count']}")
            n_adm = sum(e["name"] == "admission" for e in ev)
            n_ret = sum(e["name"] == "retire" for e in ev)
            if n_adm != R or n_ret != R:
                raise AssertionError(f"{tag} {n_adm} admission, {n_ret} retire events")
            info.update(phases=phases, prefill_cached=dyn_cached,
                        ttft_ms=obs.metrics.get("serve_ttft_seconds").summary(
                            unit=1e3, suffix="_ms"),
                        kv_pages_free=fams["kv_pages_free"],
                        prefix_cache_pages=fams["prefix_cache_pages"])
            log(f"{tag} {R} requests: tokens, {got['steps']} steps and launches "
                f"{info['launches']} equal without obs; {len(steps)} step spans {phases}; "
                f"prefill_cached_tokens_total {dyn_cached} (serve_dynamic's); TTFT count {R}, "
                f"p50/p95/p99 {info['ttft_ms']}; tok/s (best of 2 in turns) with obs "
                f"{n_tok / wall:.1f}, without {n_tok / base_wall:.1f} "
                f"({base_wall / wall - 1:+.2%}, not held)")
        else:
            spans = [e for e in ev if e["name"] == "serve"]
            if len(spans) != 1 or len(window) != 1 or not spans[0]["dur"] / 1e3 >= window[0]:
                raise AssertionError(f"{tag} serve spans {spans}, CUDA-event ms {window}")
            info.update(span_ms=spans[0]["dur"] / 1e3, device_window_ms=window[0])
            log(f"{tag} 8 requests: tokens, {got['steps']} steps and launches "
                f"{info['launches']} equal without obs; serve span {info['span_ms']:.3f} ms >= "
                f"its CUDA-event time {window[0]:.3f} ms; tok/s (best of 2 in turns) with obs "
                f"{n_tok / wall:.1f}, without {n_tok / base_wall:.1f} "
                f"({base_wall / wall - 1:+.2%}, not held)")
        summary[what] = info
    return summary


def trace_kernels(path):
    """The names of the device kernels (``"kernel"`` events) in a Chrome
    trace that Tracer.profile wrote."""
    with open(path) as f:
        return [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]


def obs_phase_kernels(cfg, Model, Engine, DynamicEngine, EngineConfig, out_dir):
    """For decode, chunk_prefill, verify and train_step: one region of the
    phase traced with Tracer(profile_dir=...).profile(); every name in
    PHASE_KERNELS[phase] must be among the region's kernels in the Chrome
    trace it writes."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.obs import PHASE_KERNELS, Tracer
    from repro_torch.optim.optimizer import Optimizer

    kern = Model(cfg, device="cuda")
    params = kern.init(seed=0)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (2, 128))
    lens = np.array([128, 96])
    drafter = Model(cfg.scaled(0.25, min_d_head=8), device="cuda")   # the CLI's
    dparams = drafter.init(seed=7)
    kw = dict(n_slots=2, page_size=16, max_prompt_len=128)
    tcfg = get_config("mup-gpt").replace(dtype="float32")
    tmodel = Model(tcfg, device="cuda")
    tparams = tmodel.init(seed=0)
    opt = Optimizer.create("adamw", 1e-2, tmodel.p13n, tmodel.meta)
    tstate = opt.init(tparams)
    step = make_train_step(tmodel, opt)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             make_pipeline(tcfg.vocab_size, 512, 8, seed=0).batch(0).items()}
    regions = {
        # the static engine's decode steps (its prefills launch B1 alone)
        "decode": lambda: Engine(kern, EngineConfig(max_gen_len=8, **kw)).serve(
            params, prompts, lens),
        # chunks alone: one token a request, sampled from the last chunk
        "chunk_prefill": lambda: DynamicEngine(kern, EngineConfig(
            max_gen_len=1, prefill_chunk=32, **kw)).serve(params, prompts, lens),
        # speculative iterations after one-shot prefills (B1 alone)
        "verify": lambda: DynamicEngine(kern, EngineConfig(max_gen_len=8, draft_k=SPEC_K, **kw),
                                        draft_model=drafter).serve(
            params, prompts, lens, draft_params=dparams),
        "train_step": lambda: float(step(tparams, tstate, batch)[2]["loss"]),
    }
    out = {}
    for phase, region in regions.items():
        region()                                         # warm-up
        torch.cuda.synchronize()
        tracer = Tracer(profile_dir=str(out_dir))
        with tracer.profile(phase):
            region()
            torch.cuda.synchronize()
        path = tracer.events[-1]["args"]["path"]
        names = trace_kernels(path)
        want = PHASE_KERNELS[phase].split("+")
        missing = [n for n in want if not any(re.search(rf"\b{n}\b", k) for k in names)]
        if missing:
            raise AssertionError(f"[obs phase kernels] {phase}: {missing} not among the "
                                 f"region's {len(names)} kernels in {path}")
        counts = {n: sum(bool(re.search(rf"\b{n}\b", k)) for k in names) for n in want}
        log(f"[obs phase kernels] {phase}: {PHASE_KERNELS[phase]} all among the region's "
            f"{len(names)} kernel launches (by name {counts}); {path}, "
            f"{Path(path).stat().st_size / 2**20:.1f} MiB")
        out[phase] = counts
    return out


def obs_sweep_tracer():
    """sweep_tracer: run_sweep over the proxy with 4 candidates, one
    diverging, prune_factor set."""
    from repro_torch.configs import get_config
    from repro_torch.core.hpspace import mup_space
    from repro_torch.launch.sweep import run_sweep
    from repro_torch.obs import Tracer

    space = mup_space()
    cands = [space.hparams(lr=5e-3), space.hparams(lr=1e25), space.hparams(lr=1e-2),
             space.hparams(lr=2e-2)]
    tracer = Tracer()
    res = run_sweep(get_config("mup-gpt").proxy(0.25, min_d_head=64), cands, steps=10,
                    batch_size=8, seq_len=64, prune_factor=3.0, prune_every=5,
                    verbose=False, tracer=tracer, device="cuda")
    ev = tracer.events
    sweeps = [e for e in ev if e["name"] == "sweep"]
    prunes = [e["args"] for e in ev if e["name"] == "prune"]
    done = [e["args"] for e in ev if e["name"] == "sweep_done"]
    if len(sweeps) != 1 or not any(1 in p["candidates"] for p in prunes) \
            or len(done) != 1 or done[0]["best"] != res.best_index:
        raise AssertionError(f"[obs sweep_tracer] events {ev}, best {res.best_index}")
    log(f"[obs sweep_tracer] 4 candidates x 10 steps: one sweep span "
        f"({sweeps[0]['dur'] / 1e3:.1f} ms), prune events {prunes}, sweep_done {done[0]}")
    return dict(prunes=prunes, done=done[0], sweep_ms=sweeps[0]["dur"] / 1e3)


def obs_phase(ops, cfg, Model, Engine, DynamicEngine, EngineConfig, dyn_cached):
    """The obs phase (see the module note): train_obs (f32, then --amp
    bf16), drift, serve_obs, phase kernels, sweep_tracer.  Returns its
    summary."""
    t0 = time.perf_counter()
    out = {"train_obs": obs_train(ops, "", OBS_STEPS)}
    out["train_obs_amp_bf16"] = obs_train(ops, "bf16", OBS_AMP_STEPS)
    out["drift"] = obs_drift()
    torch.cuda.empty_cache()
    out["serve_obs"] = obs_serve(ops, cfg, Model, Engine, DynamicEngine, EngineConfig,
                                 dyn_cached)
    out["phase_kernels"] = obs_phase_kernels(cfg, Model, Engine, DynamicEngine, EngineConfig,
                                             ROOT / "build" / "obs_profiles")
    out["sweep_tracer"] = obs_sweep_tracer()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"[obs] the phase took {out['seconds']:.1f} s")
    return out

# ---------------------------------------------------------------------------
# what the compiler made of the flash kernels
# ---------------------------------------------------------------------------

FLASH_KERNEL_IDS = ("flash_fwd_kernel", "flash_fwd_tc_kernel", "flash_fwd_i8_kernel",
                    "flash_bwd_dq_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dq_i8_kernel",
                    "flash_bwd_dkv_kernel", "flash_bwd_dkv_tc_kernel",
                    "flash_bwd_dkv_i8_kernel", "flash_quant_i8_kernel",
                    "flash_quant_fwd_i8_kernel")
# the int8 mode's kernels: B5 (templated on storage and DP), B6 and B7 (on
# DP alone: they read the pre-pass's bytes), on the s8 tensor cores, and
# the backward's and the forward's pre-passes
I8_KERNELS = ("flash_fwd_i8_kernel", "flash_bwd_dq_i8_kernel", "flash_bwd_dkv_i8_kernel",
              "flash_quant_i8_kernel", "flash_quant_fwd_i8_kernel")
I8_MMA = I8_KERNELS[:3]   # must show IMMA and no IDP.4A, and must not spill
# the kernel rows of the int8 mode, by the kernel they launch
I8_ROWS = {"flash_fwd_int8": "flash_fwd_i8_kernel", "flash_bwd_dq_int8": "flash_bwd_dq_i8_kernel",
           "flash_bwd_dkv_int8": "flash_bwd_dkv_i8_kernel",
           "flash_bwd_quant_int8": "flash_quant_i8_kernel",
           "flash_fwd_quant_int8": "flash_quant_fwd_i8_kernel"}
SASS_OPS = ("HMMA", "HGMMA", "IMMA", "IDP", "LDSM", "LDGSTS", "UTMALDG")


def flash_instance(mangled):
    """'kernel<storage, DP>' (or 'kernel<DP>') for a mangled flash kernel
    name, else None (the identifier is length-prefixed in the mangled
    name)."""
    kern = next((k for k in FLASH_KERNEL_IDS if f"{len(k)}{k}I" in mangled), None)
    dp = re.search(r"Li(\d+)E", mangled)
    if kern is None or dp is None:
        return None
    if f"{len(kern)}{kern}ILi" in mangled:
        return f"{kern}<{dp.group(1)}>"
    return f"{kern}<{'float' if f'{kern}If' in mangled else 'bf16'}, {dp.group(1)}>"


def ptxas_entries(build_log):
    """{mangled entry: (registers, spill bytes)} from ``ptxas -v``."""
    regs, spills, entry, props = {}, {}, None, None
    for line in build_log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry = m.group(1)
        elif m := re.search(r"Function properties for (\S+)", line):
            props = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills[props] = int(m.group(1)) + int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            regs[entry] = int(m.group(1))
    return {name: (n, spills.get(name, 0)) for name, n in regs.items()}


def tc_resources(build_log):
    """{instance: (registers, spill bytes)} of the tensor-core flash kernels
    from ``ptxas -v``; raise if one spills."""
    out = {}
    for name, rs in ptxas_entries(build_log).items():
        inst = flash_instance(name)
        if inst and inst.split("<")[0] in TC_KERNELS:
            out[inst] = rs
    log("[build] tensor-core flash kernels (registers, spill bytes): "
        + ", ".join(f"{k} {v}" for k, v in sorted(out.items())))
    if len(out) != 2 * len(PADDED_D) * len(TC_KERNELS):
        raise AssertionError(f"ptxas -v reported {sorted(out)}, not every tensor-core kernel")
    spilled = {k: v for k, v in out.items() if v[1]}
    if spilled:
        raise AssertionError(f"tensor-core flash kernels spill: {spilled}")
    return out


def i8_resources(build_log):
    """{instance: (registers, spill bytes)} of the int8 mode's kernels (B5
    in f32 and bf16 storage at DP 64, 128 and 256, B6 and B7 at each DP,
    each pre-pass in f32 and bf16 at each) from ``ptxas -v``; raise if one
    is missing or B5, B6 or B7 spills."""
    out = {}
    for name, rs in ptxas_entries(build_log).items():
        inst = flash_instance(name)
        if inst and inst.split("<")[0] in I8_KERNELS:
            out[inst] = rs
    log("[build] int8 kernels (registers, spill bytes): "
        + ", ".join(f"{k} {v}" for k, v in sorted(out.items())))
    if len(out) != len(PADDED_D) * (2 + 2 + 2 * 2):
        raise AssertionError(f"ptxas -v reported {sorted(out)}, not every int8 kernel")
    spilled = {k: v for k, v in out.items() if v[1] and k.split("<")[0] in I8_MMA}
    if spilled:
        raise AssertionError(f"B5/B6/B7 int8 kernels spill: {spilled}")
    return out


def ffma_resources(build_log):
    """{instance: (registers, spill bytes)} of the f32 mode's FFMA kernels
    (B5, B6, B7 in f32 and bf16 storage at each DP) from ``ptxas -v``; raise
    if one is missing or a DP 256 instance spills."""
    out = {}
    for name, rs in ptxas_entries(build_log).items():
        inst = flash_instance(name)
        if inst and inst.split("<")[0] in FFMA_KERNELS:
            out[inst] = rs
    log("[build] FFMA flash kernels (registers, spill bytes): "
        + ", ".join(f"{k} {v}" for k, v in sorted(out.items())))
    if len(out) != 2 * len(PADDED_D) * len(FFMA_KERNELS):
        raise AssertionError(f"ptxas -v reported {sorted(out)}, not every FFMA kernel")
    spilled = {k: v for k, v in out.items() if v[1] and k.endswith(" 256>")}
    if spilled:
        raise AssertionError(f"FFMA flash kernels spill at DP 256: {spilled}")
    return out


def b2_resources(build_log):
    """{instance: (registers, spill bytes)} of B2's instances (f32 and bf16
    storage; NV 16-byte pieces a lane in registers, 0 the scalar path) from
    ``ptxas -v``, printed; raise if the f32 instance of the train shape (NV
    8) is missing or spills."""
    out = {}
    for name, rs in ptxas_entries(build_log).items():
        if m := re.search(r"18rmsnorm_bwd_kernelI(f|13__nv_bfloat16)Li(\d+)E", name):
            out[f"rmsnorm_bwd_kernel<{'float' if m[1] == 'f' else 'bf16'}, {m[2]}>"] = rs
    log("[build] B2 rmsnorm_bwd_kernel (registers, spill bytes): "
        + ", ".join(f"{k} {v}" for k, v in sorted(out.items())))
    if out.get("rmsnorm_bwd_kernel<float, 8>", (0, 1))[1]:
        raise AssertionError(f"B2's train-shape instance is missing or spills: {out}")
    return out


B8_TYPES = {"f": "float", "a": "int8", "13__nv_bfloat16": "bf16"}


def decode_instance(mangled):
    """'flash_decode_kernel<TQ, TKV, WIDE>' for a mangled B8 instance, else
    None (a repeated bf16 argument is the substitution S<n>_, the bool is
    Lb<0|1>E)."""
    m = re.search(r"19flash_decode_kernelI(.+?)EEv", mangled)
    if m is None:
        return None
    names = []
    for tok in re.findall(r"13__nv_bfloat16|S\d*_|[fa]", m.group(1).split("Lb")[0]):
        names.append(names[-1] if tok.startswith("S") else B8_TYPES[tok])
    wide = re.search(r"Lb([01])E", m.group(1))
    return f"flash_decode_kernel<{', '.join(names)}, {'true' if wide[1] == '1' else 'false'}>"


def decode_resources(build_log):
    """{instance: (registers, spill bytes)} of B8's six (q, pool) type pairs,
    each with 16-byte loads (WIDE) and without, from ``ptxas -v``; raise if
    one is missing or spills."""
    out = {}
    for name, rs in ptxas_entries(build_log).items():
        if inst := decode_instance(name):
            out[inst] = rs
    log("[build] B8 flash_decode_kernel (registers, spill bytes): "
        + ", ".join(f"{k} {v}" for k, v in sorted(out.items())))
    if len(out) != 12:
        raise AssertionError(f"ptxas -v reported {sorted(out)}, not B8's twelve instances")
    spilled = {k: v for k, v in out.items() if v[1]}
    if spilled:
        raise AssertionError(f"B8 spills: {spilled}")
    return out


def decode_multi_instance(mangled):
    """'flash_decode_multi_kernel<TQ, TKV, CV>' for a mangled B9 instance,
    else None."""
    m = re.search(r"25flash_decode_multi_kernelI(.+?)Li(\d+)EEEv", mangled)
    if m is None:
        return None
    names = []
    for tok in re.findall(r"13__nv_bfloat16|S\d*_|[fa]", m.group(1)):
        names.append(names[-1] if tok.startswith("S") else B8_TYPES[tok])
    return f"flash_decode_multi_kernel<{', '.join(names)}, {m.group(2)}>"


def multi_resources(build_log):
    """{instance: (registers, spill bytes)} of B9's six (q, pool) type pairs,
    each with 64-column (CV 1) and 256-column (CV 4) slices, from ``ptxas
    -v``; raise if one is missing or spills."""
    out = {}
    for name, rs in ptxas_entries(build_log).items():
        if inst := decode_multi_instance(name):
            out[inst] = rs
    log("[build] B9 flash_decode_multi_kernel (registers, spill bytes): "
        + ", ".join(f"{k} {v}" for k, v in sorted(out.items())))
    if len(out) != 12:
        raise AssertionError(f"ptxas -v reported {sorted(out)}, not B9's twelve instances")
    spilled = {k: v for k, v in out.items() if v[1]}
    if spilled:
        raise AssertionError(f"B9 spills: {spilled}")
    return out


def find_cuobjdump():
    """cuobjdump's path (the CUDA toolkit's, or the copy in Triton's
    package), or None."""
    cands = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton
        cands.append(str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin"
                         / "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if c and Path(c).exists()), None)


def sass_dump(lib_path):
    """``cuobjdump -sass`` of a built library, started in the background
    (it takes tens of seconds) with its output to a temporary file, and
    killed if the script ends first; sass_check reads it.  None where
    cuobjdump is not."""
    tool = find_cuobjdump()
    if tool is None:
        return None
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([tool, "-sass", str(lib_path)], stdout=out,
                            stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    t0 = time.perf_counter()
    took = []

    def watch():
        proc.wait()
        took.append(time.perf_counter() - t0)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    return tool, proc, out, watcher, took


def sass_check(job):
    """Per flash kernel instance (``job``: sass_dump's of the flash
    library), its count of tensor-core (HMMA, HGMMA), ldmatrix (LDSM) and
    asynchronous-copy (LDGSTS, UTMALDG) instructions.  Raise if cuobjdump
    is there and a tensor-core kernel has no tensor-core instruction; None
    where cuobjdump is not."""
    if job is None:
        log("[sass] flash kernels' instructions: not available (no cuobjdump)")
        return None
    tool, proc, out, watcher, took = job
    watcher.join(timeout=600)
    failed = proc.wait(timeout=1)
    out.seek(0)
    dump = out.read()
    out.close()
    if failed:
        raise RuntimeError(f"{tool} -sass exited with {failed}: {dump[-2000:]}")
    log(f"[sass] cuobjdump -sass took {took[0]:.1f} s, beside the phases")
    counts = {}
    for chunk in re.split(r"\n\s*Function : ", dump)[1:]:
        inst = flash_instance(chunk.split("\n", 1)[0].strip())
        if inst:
            counts[inst] = {op: len(re.findall(rf"\b{op}\b", chunk)) for op in SASS_OPS}
    for inst, c in sorted(counts.items()):
        log(f"[sass] {inst}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
    tc = {k: c for k, c in counts.items() if k.split("<")[0] in TC_KERNELS}
    if len(tc) != 2 * len(PADDED_D) * len(TC_KERNELS):
        raise AssertionError(f"cuobjdump ({tool}) shows {sorted(tc)}, not every "
                             "tensor-core kernel")
    none = [k for k, c in tc.items() if c["HMMA"] + c["HGMMA"] == 0]
    if none:
        raise AssertionError(f"no tensor-core instruction in {none}")
    i8 = {k: c for k, c in counts.items() if k.split("<")[0] in I8_MMA}
    if len(i8) != len(PADDED_D) * (2 + 2):
        raise AssertionError(f"cuobjdump ({tool}) shows {sorted(i8)}, not every int8 B5/B6/B7")
    wrong = [k for k, c in i8.items() if c["IMMA"] == 0 or c["IDP"]]
    if wrong:
        raise AssertionError(f"int8 B5/B6/B7 not on the s8 tensor cores (IMMA, no IDP.4A): "
                             f"{ {k: i8[k] for k in wrong} }")
    return counts


# ---------------------------------------------------------------------------

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cross_entropy as ce
    from repro_torch import quant
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import DynamicEngine, Engine, EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

    # nvcc builds every kernel in the background, one process a source; the
    # phases that reach B1-B4 only run as soon as their libraries are
    # linked, beside the attention kernels' builds, and the rest waits for
    # all
    t0 = time.perf_counter()
    build.start()

    def done(phase):
        log(f"[time] {phase} done at {time.perf_counter() - t0:.0f} s")

    torch.manual_seed(0)
    rows = [rmsnorm_phase(ops, rn, F), rmsnorm_bwd_phase(rn, ref, F),
            *ce_phase(ce, ref, F)]
    done("B1-B4 kernel phases")
    # mamba2-130m has no attention: its phases reach B1-B4 only and run
    # beside the attention kernels' builds too (the random state the later
    # phases draw from is kept as it was)
    rng_state = torch.get_rng_state(), torch.cuda.get_rng_state_all()
    # B1 at mamba2-130m's decode step and train step (D 768); its B2 and
    # B3/B4 shapes are in their phases above
    rows[0]["mamba2_shapes"] = rmsnorm_rows(ops, F, "mamba2", ((8, 1, 768), (8, 512, 768)),
                                            (torch.float32,))
    done("B1 at mamba2's shapes")
    recurrentgemma_kernel_rows(ops, rn, ce, ref, F, rows)
    done("B1-B4 at recurrentgemma's shapes")
    m2s_launches, m2s = mamba2_serve_phase(Model, ops)
    done("serve_mamba2")
    m2t, m2t_launches = {}, {}
    for amp_mode, path in zip(("", "bf16", "int8"), M2_TRAIN):
        m2t_launches[path], m2t[path] = train_phase(
            ops, quant, amp=amp_mode, arch="mamba2-130m",
            control_losses=m2t["train_mamba2"]["losses"] if amp_mode else None)
        torch.cuda.empty_cache()
        done(f"train_mamba2{' --amp ' + amp_mode if amp_mode else ''}")
    # recurrentgemma-9b's serve and f32 train reach B1-B4 only too
    rgs_launches, rgs = recurrentgemma_serve_phase(Model, ops)
    torch.cuda.empty_cache()
    done("serve_recurrentgemma")
    rgt, rgt_launches = {}, {}
    rgt_launches[RG_TRAIN[0]], rgt[RG_TRAIN[0]] = train_phase(ops, quant,
                                                              arch="recurrentgemma-9b")
    torch.cuda.empty_cache()
    done("train_recurrentgemma")
    torch.set_rng_state(rng_state[0])
    torch.cuda.set_rng_state_all(rng_state[1])
    build.wait()
    log(f"[build] kernels ready at {time.perf_counter() - t0:.1f} s (nvcc: "
        f"{build.build_seconds if build.build_seconds is not None else 'cached'}; "
        f"a library a group of sources, ready after "
        f"{ {g: s if s is None else round(s, 1) for g, s in build.group_seconds.items()} } "
        f"s: the B1-B4 kernel phases, mamba2's phases, serve_recurrentgemma and "
        f"train_recurrentgemma ran beside the attention kernels' builds)")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    tc_regs = tc_resources(build.build_log)
    i8_regs = i8_resources(build.build_log)
    ffma_regs = ffma_resources(build.build_log)
    b8_regs = decode_resources(build.build_log)
    b9_regs = multi_resources(build.build_log)
    b2_regs = b2_resources(build.build_log)
    sass_job = sass_dump(build.library_path("flash_attention"))
    rows += flash_phase(ops, fa, ref, quant, F)
    done("B5-B7 kernel phase")
    rows.append(decode_phase(ops, da, F))
    rows.append(multi_phase(ops, da, F))
    rows.append(int8_decode_phase(ops, da, F))
    rows.append(int8_multi_phase(ops, da, F))
    gemma2_kernel_phase(ops, da, F, {row["name"]: row for row in rows})
    mixtral_kernel_phase(ops, da, F, {row["name"]: row for row in rows})
    done("B8-B9 kernel phases (f32/bf16 and int8 pools, gemma2's and mixtral's rings)")
    cfg = get_config("smollm-135m").replace(dtype="float32", zero_init_query=False,
                                            n_layers=SERVE_DEPTH)
    serve_launches, serve = serve_phase(cfg, Model, Engine, EngineConfig, ops)
    done("serve")
    dyn_launches, dyn_tokens, dyn = dynamic_serve_phase(cfg, Model, Engine, DynamicEngine,
                                                        EngineConfig, ops)
    done("serve_dynamic")
    int8_launches, int8_static_launches, srv8 = serve_int8_phase(
        cfg, Model, Engine, DynamicEngine, EngineConfig, ops,
        (dyn_tokens, dyn["tok_per_s"]))
    done("serve_int8")
    spec_launches, spec = serve_spec_phase(cfg, Model, Engine,
                                           DynamicEngine, EngineConfig, ops)
    done("serve_spec")
    g2_launches, g2 = gemma2_phases(Model, Engine, DynamicEngine, EngineConfig, ops, t0)
    done("serve_gemma2, serve_gemma2_dynamic, serve_gemma2_int8")
    mx_launches, mx = mixtral_phases(Model, Engine, DynamicEngine, EngineConfig, ops, t0)
    done("serve_mixtral, serve_mixtral_dynamic, serve_mixtral_int8")
    train_launches, train = train_phase(ops, quant)
    done("train")
    amp_launches, amp = train_phase(ops, quant, amp="bf16", control_losses=train["losses"])
    done("train --amp bf16")
    amp8_launches, amp8 = train_phase(ops, quant, amp="int8", control_losses=train["losses"])
    done("train --amp int8")
    g2t_launches, g2t = train_phase(ops, quant, arch="gemma2-2b")
    done("train_gemma2")
    g2t_amp_launches, g2t_amp = train_phase(ops, quant, amp="bf16",
                                            control_losses=g2t["losses"], arch="gemma2-2b")
    done("train_gemma2 --amp bf16")
    g2t_amp8_launches, g2t_amp8 = train_phase(ops, quant, amp="int8",
                                              control_losses=g2t["losses"], arch="gemma2-2b")
    done("train_gemma2 --amp int8")
    torch.cuda.empty_cache()
    mxt, mxt_launches = {}, {}
    for amp_mode, path in zip(("", "bf16", "int8"), MX_TRAIN):
        mxt_launches[path], mxt[path] = train_phase(
            ops, quant, amp=amp_mode, arch="mixtral-8x22b",
            control_losses=mxt["train_mixtral"]["losses"] if amp_mode else None)
        torch.cuda.empty_cache()
        done(f"train_mixtral{' --amp ' + amp_mode if amp_mode else ''}")
    for amp_mode, path in zip(("bf16", "int8"), RG_TRAIN[1:]):
        rgt_launches[path], rgt[path] = train_phase(
            ops, quant, amp=amp_mode, arch="recurrentgemma-9b",
            control_losses=rgt[RG_TRAIN[0]]["losses"])
        torch.cuda.empty_cache()
        done(f"train_recurrentgemma --amp {amp_mode}")
    dense_launches, dense = dense_serve_phase(cfg, Model, Engine, EngineConfig, ops)
    done("serve_dense")
    sweep_rows, sweep_launches, sweep = sweep_phase(ops, rn, ref)
    rows += sweep_rows
    done("sweep")
    moe_sweep_launches, moe_sweep = moe_sweep_phase(ops)
    sweep_launches.update(moe_sweep_launches)
    done("sweep_moe")
    cand_timing, amp_launches_by_path, sweep_amp = sweep_amp_phase(ops, fa, ref, quant, F)
    sweep_launches.update(amp_launches_by_path)
    attach_candidate_axis(rows, cand_timing)
    done("sweep_amp")
    obs = obs_phase(ops, cfg, Model, Engine, DynamicEngine, EngineConfig,
                    dyn["prefill_cached"])
    done("obs")
    serve["profile"] = profile_phase(cfg, Model, Engine, EngineConfig)
    dyn["profile"] = profile_phase(cfg, Model, Engine, EngineConfig,
                                   dynamic=(DynamicEngine, 64))
    srv8["profile"] = profile_phase(cfg.replace(kv_dtype="int8"), Model, Engine,
                                    EngineConfig, dynamic=(DynamicEngine, 64),
                                    ranges=("_quantized_write",))
    train["profile"] = train_profile_phase()
    amp["profile"] = train_profile_phase(amp="bf16")
    amp8["profile"] = train_profile_phase(amp="int8")
    done("profiles")
    sass = sass_check(sass_job)
    for row in rows:
        by_path = {"serve": serve_launches[row["name"]],
                   "serve_dynamic": dyn_launches[row["name"]],
                   "serve_int8": int8_launches[row["name"]],
                   "serve_int8_static": int8_static_launches[row["name"]],
                   **{path: launches[row["name"]] for path, launches in spec_launches.items()},
                   **{path: launches[row["name"]] for path, launches in g2_launches.items()},
                   **{path: launches[row["name"]] for path, launches in mx_launches.items()},
                   "train": train_launches[row["name"]],
                   "train_amp_bf16": amp_launches[row["name"]],
                   "train_amp_int8": amp8_launches[row["name"]],
                   "train_gemma2": g2t_launches[row["name"]],
                   "train_gemma2_amp_bf16": g2t_amp_launches[row["name"]],
                   "train_gemma2_amp_int8": g2t_amp8_launches[row["name"]],
                   **{path: launches[row["name"]] for path, launches in mxt_launches.items()},
                   "serve_mamba2": m2s_launches[row["name"]],
                   "serve_dense": dense_launches[row["name"]],
                   **{path: launches[row["name"]] for path, launches in m2t_launches.items()},
                   "serve_recurrentgemma": rgs_launches[row["name"]],
                   **{path: launches[row["name"]] for path, launches in rgt_launches.items()},
                   **{path: launches[row["name"]] for path, launches in sweep_launches.items()}}
        if not sum(by_path.values()):
            raise AssertionError(f"{row['name']} was launched on no main path")
        only = {"flash_decode_multi": ("serve_dynamic", "serve_spec", "serve_spec_dynamic",
                                       "serve_spec_copy", "serve_gemma2_dynamic",
                                       "serve_mixtral_dynamic"),
                "flash_decode_int8": ("serve_int8", "serve_int8_static", "serve_spec_int8",
                                      "serve_gemma2_int8", "serve_gemma2_int8_static",
                                      "serve_mixtral_int8"),
                "flash_decode_multi_int8": ("serve_int8", "serve_spec_int8",
                                            "serve_gemma2_int8", "serve_mixtral_int8"),
                "rmsnorm_bwd": ("train", "train_amp_bf16", "train_amp_int8", *G2_TRAIN,
                                *MX_TRAIN, *M2_TRAIN, *RG_TRAIN, "spec_copy_train",
                                "sweep_serial",
                                "algorithm1_train", "sweep_moe_serial",
                                "sweep_amp_bf16_serial", "sweep_amp_int8_serial",
                                "algorithm1_amp"),
                "ce_fwd": ("train", "train_amp_bf16", "train_amp_int8", *G2_TRAIN, *MX_TRAIN,
                           *M2_TRAIN, *RG_TRAIN, "spec_copy_train", *SWEEP_PATHS,
                           *MOE_SWEEP_PATHS, *AMP_SWEEP_PATHS),
                "ce_bwd": ("train", "train_amp_bf16", "train_amp_int8", *G2_TRAIN, *MX_TRAIN,
                           *M2_TRAIN, *RG_TRAIN, "spec_copy_train", *SWEEP_PATHS,
                           *MOE_SWEEP_PATHS, *AMP_SWEEP_PATHS),
                "rmsnorm_grouped": GROUPED_PATHS + AMP_GROUPED_PATHS + ("sweep_moe",),
                "rmsnorm_bwd_grouped": GROUPED_PATHS + AMP_GROUPED_PATHS + ("sweep_moe",),
                **{n: ("train_amp_int8", "train_gemma2_amp_int8", "train_mixtral_amp_int8",
                       "train_recurrentgemma_amp_int8", "sweep_amp_int8",
                       "sweep_amp_int8_serial", "algorithm1_amp")
                   for n in I8_ROWS}
                }.get(row["name"])
        if only and sum(by_path.values()) != sum(by_path[p] for p in only):
            raise AssertionError(f"{row['name']} launched off the {only} paths: {by_path}")
        if row["name"] in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            tc = f"{row['name']}_tc_kernel"
            row["registers_spills"] = {k: v for k, v in tc_regs.items() if k.startswith(tc)}
            row["ffma_registers_spills"] = {k: v for k, v in ffma_regs.items()
                                            if k.startswith(f"{row['name']}_kernel<")}
            row["sass"] = (None if sass is None else
                           {k: v for k, v in sass.items() if k.startswith(tc)})
        if row["name"] in I8_ROWS:
            kern = I8_ROWS[row["name"]]
            row["registers_spills"] = {k: v for k, v in i8_regs.items() if k.startswith(kern)}
            row["sass"] = (None if sass is None else
                           {k: v for k, v in sass.items() if k.startswith(kern)})
        if row["name"] == "rmsnorm_bwd":
            row["registers_spills"] = b2_regs
        if row["name"] in ("flash_decode", "flash_decode_int8"):
            row["registers_spills"] = b8_regs
        if row["name"] in ("flash_decode_multi", "flash_decode_multi_int8"):
            row["registers_spills"] = b9_regs
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        log(json.dumps(row))
    log(json.dumps({"serve": serve}))
    log(json.dumps({"serve_dynamic": dyn}))
    log(json.dumps({"serve_int8": srv8}))
    log(json.dumps({"serve_spec": spec}))
    for path, summary in (*g2.items(), *mx.items()):
        log(json.dumps({path: summary}, default=str))
    log(json.dumps({"train": train}))
    log(json.dumps({"train_amp_bf16": amp}))
    log(json.dumps({"train_amp_int8": amp8}))
    log(json.dumps({"train_gemma2": g2t}))
    log(json.dumps({"train_gemma2_amp_bf16": g2t_amp}))
    log(json.dumps({"train_gemma2_amp_int8": g2t_amp8}))
    for path, summary in mxt.items():
        log(json.dumps({path: summary}))
    log(json.dumps({"serve_mamba2": m2s}, default=str))
    log(json.dumps({"serve_dense": dense}))
    for path, summary in m2t.items():
        log(json.dumps({path: summary}))
    log(json.dumps({"serve_recurrentgemma": rgs}, default=str))
    for path, summary in rgt.items():
        log(json.dumps({path: summary}))
    log(json.dumps({"sweep": sweep}))
    log(json.dumps({"sweep_moe": moe_sweep}))
    log(json.dumps({"sweep_amp": sweep_amp}, default=str))
    log(json.dumps({"obs": obs}, default=str))
    log(f"[time] the whole script took {time.perf_counter() - t0:.0f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
