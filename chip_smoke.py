#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`madeleine_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase (what CI runs)
    python3 chip_smoke.py --phases device,build,kernels
    python3 chip_smoke.py --phases device,build,train_kernels,train
    python3 chip_smoke.py --phases device,build,got_kernels,train_got
    python3 chip_smoke.py --phases device,build,glue_kernels,train_got,pretrain
    python3 chip_smoke.py --phases device,build,pool_kernels,golden,eval_forward
    python3 chip_smoke.py --phases device,build,perop_kernels,train_sigmoid
    python3 chip_smoke.py --phases device,build,train_kernels,train_views
    python3 chip_smoke.py --phases device,build,train_kernels,train_ragged,pretrain_ragged
    python3 chip_smoke.py --phases device,build,train_kernels_f32,train_f32,pretrain_f32
    python3 chip_smoke.py --phases device,build,perop_kernels_f32,train_perop_f32
    python3 chip_smoke.py --phases device,build,perop_kernels,train_sigmoid,train_ragged_nofused
    python3 chip_smoke.py --phases device,build,pool_train_kernels,dropout_kernel,train_nofused,heads
    python3 chip_smoke.py --phases device,build,downstream,probe,vit
    python3 chip_smoke.py --phases device,build,pool_kernels,eval_forward,slide

Phases, one JSON line each; any failure raises and the exit code is non-zero:
  device   card name and the nvidia-smi name/power-limit line
  build    nvcc build of every kernel under madeleine_torch/csrc, and beside
           them the g++ build of the native loader's host library
           (csrc/bagio.cpp, -march=native), timed
  kernels  K1 (encode_fused, bf16) and K2 (gated_pool, f32) at the published
           widths, b=8, t=4096, ragged lengths (one bag empty), plus a
           t=4057 call whose last tile is partial: each held against its
           plain PyTorch version on the card, and timed with CUDA events.
           K2 (its split-TF32 wgmma design) and its first design (FP32 FMA,
           check-only) at rtol 1e-4 / atol 1e-5, with the flagship weights
           and peaked (wc scaled), against a uniform-pool control, each
           twice bitwise equal, the route from the counters; both timed per
           call, back to back and with every token valid, beside the bound
           of three TF32 products and the FP32 FMA one, with K2's device
           time by kernel.
           K1 (its live-tile route on the wgmma GEMM) is checked with the
           flagship weights and again with peaked attention (wc scaled),
           against a uniform-pool control, also at d_in 544 (b=2, t=1000);
           the empty bag pools to 0; its first design (check-only) at the
           timing shape at the same bars; the route of each shape from the
           counters; both designs timed at the timing shape, with every
           token valid and at a small serving shape (b=1, t=512), the new
           one also back to back; the operands' build and cached lookup
  pool_kernels
           K3 (attn_pool) in bf16 and f32 at the eval forward's call shape
           [65, 2048, 2048] (4 heads of 512) and at t = 2000 (a partial last
           tile), 32 bags full, 32 ragged and one empty, logits of the
           flagship's spread and peaked (x 16), each against its plain
           version (bf16: rtol 2e-2 plus 1% of each bag's largest output),
           with a uniform-pool control that must break the bar in every full
           bag; two launches bitwise equal; timed at [65, 2048, 2048] beside
           the library's call for the same function (scaled_dot_product_attention
           with zero q and k and the logits as its mask)
  pool_train_kernels
           rows 4 (attn_pool_ms: K3's pool plus each head's max m and
           clamped denominator s) and 5 (attn_pool_bwd: dx and dlogits) of
           the softmax per-op lane in bf16 and f32 at [65, 2048, 2048], at
           b=8 t=4096 and at t=2000 (a partial last tile), half the bags
           full, the rest ragged, one empty, logits spread by several units:
           row 4 against its plain version (pooled at K3's bars, m equal, s
           rtol 1e-5, the weights exp(l - m) / s summing to 1 over each live
           bag to 1e-5), row 5 on row 4's stats (dx, dl at 1e-2 relative
           Frobenius), two launches of each bitwise equal, the empty bag's
           outputs 0; timed at [65, 2048, 2048] beside their plain versions
           and scaled_dot_product_attention's forward and backward
  dropout_kernel
           row 21 (standalone dropout), bf16 and f32, at [4096, 512],
           [133120, 2048], [37, 21] (row offset 3, site 1) and a head's
           [65, 512] (also row 0, sites 0 and 1, as the heads phase calls
           it), rates 0.1, 0.2, 0.25: bit for bit
           against its plain version, two launches equal, the backward's
           mask the forward's, the keep share within 0.01 (the large shapes);
           timed at [133120, 2048] bf16 beside torch.nn.functional.dropout,
           and at a head's [65, 512] f32 three ways (the wrapper, the heads'
           autograd route forward and backward, F.dropout) on cuda_ms's
           clock and in host microseconds per call over 1000 calls, the
           wrapper against F.dropout also in 10 alternating pairs; with the
           host microseconds of one call_ptrs launch of row 19 and one K3
           call at [1, 64, 2048]
  perop_kernels
           kernels 15-20 of the per-op lane, bf16: preattn (15/16),
           gated_logits (17/18) and linear_tok (19/20), each against its plain
           version at dropout rates 0 and (0.1, 0.25), row offset 3, at the
           train step's call shape [65, 2048], at b=8, t=4096 and at b=2,
           t=4057 (partial last tiles), and preattn's dx at [65, 2048, 544]:
           outputs at atol 3e-2, gradients at 1e-2 relative Frobenius (16
           and 18's dx / dy also measured elementwise against atol 3e-2, or
           one bf16 rounding step where larger), two launches of each
           bitwise equal (20's dy also held elementwise to atol 3e-2 or
           one bf16 step); 15-18 and 20 (on the wgmma GEMM) also against
           their first designs (preattn_fwd_rowblock_cuda,
           preattn_bwd_rowblock_cuda, gated_logits_fwd_rowblock_cuda,
           gated_logits_bwd_rowblock_cuda, linear_tok_bwd_mmasync_cuda) at
           the same bars, each twice bitwise equal; then at (0.1, 0.25) the chain
           preattn -> gated_logits -> plain softmax pool -> linear_tok through
           autograd against K6/K7 on the same x, seed and rows (pooled 2e-3,
           tokens 3e-2, every weight gradient 1e-2, bc 1e-4 absolute): the
           masks line up. Kernels 19 and 20 (the TMA + wgmma GEMM) also at
           a ragged M (b=3, t=1000), d_out 136 and 256, and E 544, 20 also
           against its first design there, two launches bitwise equal, and
           a misaligned y (and for 20 g) must raise. Timed at [65, 2048]
           beside their plain versions and, for linear_tok's forward,
           torch.nn.functional.linear, with kernel 19's TB/s and TFLOP/s and
           both calls' device time launched back to back; 15-18 and 20
           beside their first designs, per call and back to back, with TFLOP/s.
           Rows 4-5 and 15-20 (bf16 and f32 entry points) given the dims of
           a call past their 32-bit limits (b t past MAX_TRAIN_ROWS, a
           global bag past 2**31 - 1, rows 4-5 past 65535 bags) and null
           buffers must return cudaErrorInvalidValue, the launch path raising
  perop_kernels_f32
           rows 15-18 with f32 operands (the per-op lane at --precision
           float32; csrc/preattn.cu and csrc/gated_logits.cu on the FFMA
           tiles of csrc/gemm_ffma.cuh) against their plain versions at
           [65, 2048] and at a ragged M (2 x 4057), rates 0 and (0.1,
           0.25), row 16 also with dx at d_in 544: outputs within rtol 1e-4
           / atol 1e-5, every gradient, dx and dy within 1e-4 relative
           Frobenius, bc within 1e-4, two launches bitwise equal; the f32
           per-op chain (15 -> 17 -> softmax pool; 18 -> 16) against K6/K7
           f32 on the same operands and seed at the same bars, beside a
           shifted-mask control that must miss them; each row timed at [65,
           2048] beside its FFMA bound (67 TFLOP/s), its plain version and
           back to back
  perop_bwd_digest
           a sha256 of every output of kernels 16 and 18 at [65, 2048] on
           seeded inputs and the flagship weights, rates 0 and (0.1, 0.25):
           run in another checkout (this script copied there), it shows
           whether two packages' backward kernels agree bit for bit
  golden   flagship weights saved as model.pt + model_config.json, loaded by
           create_model_from_pretrained; encode_he against
           tests/golden/golden_flagship.npz in f32 (through K2) and bf16 (K1);
           the eval forward forward_train(train=False) in f32 (K3) against
           fs/train/* and, with stain encodings, se/train/*; encode with stain
           codes 3 and 1 against se/eval/* through K2 (f32) and K1 at d_in 544
           (bf16)
  serve    EmbeddingService at bf16 behind the HTTP front: 16 ragged requests
           (300-9000 tokens), each equal to a direct encode; K1 must launch
  extract  the extraction CLI in-process over 16 .npz bags, with an f32 model
           (K2 must launch) and a bf16 one (K1 must launch)
  downstream
           the downstream CLIs in-process over the extract phase's cohort
           (its bags carry coords on a 256-px grid): the extraction CLI with
           the bf16 model (K1 must launch), extract_mean_embs (each slide's
           f32 mean on the card against numpy's at 1e-6), and
           extract_attention_maps with the bf16 and the f32 model (each
           PNG's header read back, its size the coords' grid of 8-px cells;
           the bf16 logits against the f32 model's at 2e-2 relative
           Frobenius); seconds per slide
  probe    first which of sklearn, PIL, cv2, h5py and openslide import (a
           line of its own), then the linear-probing CLI's main at BCNB's
           scale: the 1058 slides and er/pr/her2 labels of
           dataset_csv/BCNB/BCNB.csv, synthetic 512-d embeddings from SEED
           shifted along one direction per positive label, the full
           protocol (3 k x 3 tasks x 10 folds = 90 fits) on the card, then
           the same code on the CPU: the splits equal, probabilities and
           metric stores within 1e-9; wall seconds, ms per fit by k
  eval_forward
           forward_train(train=False) at [65, 5, 2048, 512] bf16 with the
           flagship weights: K3 must launch once per modality; its slide and
           token embeddings of 4 cases against the f32 model's (relative
           Frobenius 2e-2); timed; then with n_views=3 (the half-bag views
           of half_split(0, 2048)): K3 must launch three times per modality,
           the whole-bag view equal to n_views=1's bit for bit, the views
           of 4 cases against the f32 model's at 2e-2; timed beside n_views=1
  vit      the ViT-B/16 tile tower (the JAX package's default ViTConfig:
           224 px, patch 16, width 768, 12 layers, 12 heads, out 512) with
           random weights from SEED through TorchViTEncoder: 256 uint8 tiles
           of 256 x 256 a batch, end to end from the host (H2D, resize,
           normalise, tower) in f32 (no TF32) and bf16: ms per batch, tiles/s,
           the tower's ms and share, peak GB; f32 on the card against f32
           on the CPU on 4 tiles at 1e-4 relative Frobenius, bf16 against
           f32 at 2e-2
  slide    a synthetic slide of 32768 x 24576 px at 0.5 um/px (2.4 GB of
           RGB, made on the card from SEED in row bands: stained blobs over
           about half of it) through TissueSegmenter (Otsu) and TileEmbedder
           at 10x, 256-px tiles from 512-px regions: with the handcrafted
           encoder (.bag), and the ViT-B/16 tower from SEED in bf16 (.npz)
           and f32 (.bag); seconds by part (thumbnail, Otsu and contours,
           plan, region reads, H2D, resize, encoder, write), tiles kept and
           tiles/s, peak device and host GB. Checks: the first batch's
           handcrafted pool and features on the card against the same code
           on the CPU (pooled uint8 equal, features rtol 1e-5 / atol 1e-6),
           its tiles resized on the card within one level of cv2's
           INTER_LINEAR on the host, each bag read back equal to what its
           encoder returned, the coords the plan's. Then an 8192 x 6144 PNG
           (eval/heatmap.py's write_png) through the patch-extraction CLI's
           main with --encoder vit --bag_format bag and with the default
           handcrafted encoder --bag_format npz, and the slide-embedding
           CLI over the handcrafted bags with the bf16 model (K1 must
           launch); seconds a slide
  train_kernels
           K6 (encoder_train_fwd) and K7 (encoder_train_bwd), bf16: each
           against its plain version at dropout rates 0 and (0.1, 0.25) with
           identical masks, a random pooled cotangent and dtok, flagship and
           peaked weights (with the uniform-pool control), at b=8, t=4096
           ragged and at t=4057 with a bag valid only around its partial last
           tile (with a dropped-tile control); then at the train step's call
           shape [65, 2048] at the real rates, and at the stain-encoded
           step's [65, 2048, 544] with K7's input gradient dx (need_dx), whose
           stain columns summed in bf16 (the table's gradient) are held to
           their f32 sum. With n_views = 3 (a half-bag split of the step's
           own draw, three pools over the same logits): at b=8, t=4096
           ragged, at the odd t=4057 and at [65, 2048], rates 0 and real, at
           the same bars. Both kernels run twice and must agree bitwise.
           Timed at b=8, t=4096, at [65, 2048] (one view and three) and at
           [65, 2048, 544] with dx. The recompute route (B1c, save_acts
           off): at [65, 2048] with a ragged mask (two bags empty), and at
           [65, 2048, 544] with dx, K6 without saves equal to the save route
           bit for bit and K7 rebuilding the residuals (K6's own code)
           equal to the save route's gradients and dx bit for bit, twice,
           and to the plain recompute at the bars above; at [65, 16384]
           (1,064,960 rows: K6's f32 scratch past 2**31 elements) the same
           equalities, the last bag's K6 outputs and its K7 gradients
           (cotangents on that bag alone) against the plain versions of
           that bag; K7's ms on both routes, its recompute's own peak.
           Blocks of whole bags (A10): at [65, 16384] the call in forced
           blocks of 22, 22 and 21 bags against the unblocked one (pooled,
           m, s, tokens, logits and dx bit for bit; every weight gradient
           at least as close as the unblocked call's to the per-bag float64
           sum of the same kernel's gradients, and within 1e-2 relative
           Frobenius of the unblocked call's, 1e-4 with f32 operands; bc
           1e-4), then [65, 32768] (a
           bag past 16384 tokens) in the blocks encoder_blocks gives it: the
           last bag's K6 outputs and K7 gradients against the plain
           versions of that bag alone; K6's and K7's ms in blocks, K7's own
           peak. The save_acts gate's HBM guard, unmocked: ballast that leaves
           the free plus reserved-but-unallocated bytes under a [8, 2048]
           call's threshold sends the gate and the call to the recompute
           route; the ballast freed but still reserved sends them back to
           the save route, with bit-equal gradients. ROADMAP C1: one call at
           [65, 8192] (recompute route) as it runs and with mem_get_info
           patched so that the free-memory guard (`_device_hbm_limit`)
           sees 15 GB left, where a rule reading it gives two blocks: one
           block both times, the weight gradients bit for bit
  train_kernels_f32
           K6 and K7 with f32 operands (--precision float32, the JAX
           package's parity route; every product on csrc/gemm_ffma.cuh's
           FFMA tiles) against their plain versions at the step's call shape
           [65, 2048] with the flagship weights in f32 at the real rates:
           every token valid, n_views = 3, a ragged mask (two bags empty),
           and the stain-encoded [65, 2048, 544] with dx; each on the save
           route (outputs rtol 1e-4 / atol 1e-5, every gradient and dx 1e-4
           relative Frobenius, bc 1e-4 absolutely, two launches bitwise
           equal) and the recompute route (bit for bit the save route, and
           against the plain recompute). Timed (K6, K7 on both routes, the
           plain versions) beside the FP32 FMA bound; the weight gradients'
           piece lengths, the library's against the Python mirror's; the
           two block checks of train_kernels at [65, 8192] (forced blocks)
           and [65, 16384] (the rule's blocks) at f32's bars
  got_kernels
           K8 (ipot_fwd), K9 (ipot_bwd) and K10 (gw_gamma), f32, on costs
           built as the GOT path builds them (random d=128 tokens ->
           cosine cost -> threshold-ReLU), at the train step's [260, 256,
           256] and at an odd (7, 256, 192), both on each kernel's cluster
           route (its fast path, m <= 256), at (5, 100, 320) on the cluster
           route's general path (ragged row slices), and at (3, 512, 512),
           beyond a cluster's shared memory, on their global route (the
           one-block kernels): K8 at (beta, iters) (0.5, 30)
           and (0.1, 20), K9 with the loss's cotangent C, K10 at 5 x 20, each
           against its plain version (relative Frobenius bars below), with a
           control that must miss the bar: the plain version one iteration
           short (K10: the largest outer count below 5 that misses it); two
           launches of each bitwise equal; the route each shape took, read
           from the launch counters; K8's cluster route (c = 4) bit for bit
           equal to its global route. Timed at [260, 256, 256], per call and
           back to back, with both routes of K8, K9 and K10, K8's cluster
           route at c = 4 and c = 8, and K10 at iters=0 (its products alone)
           on each; K9's history floor, each cluster route's
           cudaOccupancyMaxActiveClusters and shared memory (Python's
           formula against the library's)
  glue_kernels
           K11 (threshold_build forward), K12 (its backward), K13 (gw_trace
           forward) and K14 (its backward), f32, on cosine costs of random
           d=128 tokens with per-problem thresholds and the GW plan of K10, at
           [260, 256, 256], (7, 256, 192) and (5, 100, 320), each against its
           plain version (relative Frobenius per output: 1e-6 for K11/K12,
           1e-5 for K12's dthr and K13/K14), with a control that must miss the
           bar: the plain version fed the neighbouring problem's thresholds
           (K11/K12) or plan (K13/K14); two launches of each bitwise equal;
           K14 (the tiled product) bit for bit equal to its first design
           (gw_trace_backward_rowblock); K13 (the tiled route, read from the
           counters) against its first design (gw_trace_forward_rowblock) at
           1e-5; timed at [260, 256, 256], with K13's and K14's TFLOP/s,
           back-to-back times and their first designs' times
  train    5 steps of make_train_step at full width (65 cases x 5 stains x
           2048 tokens, bf16, InfoNCE, dropout on) on one fixed synthetic
           batch: no step skipped, finite losses, the last below the first;
           K6/K7 must launch on every step. Every train phase then takes, on
           the same model, one step under torch.cuda.set_sync_debug_mode
           ("error") (no host read of the card inside a step), 10 steps
           launched back to back between two events (ms per step beside the
           single-call time), and a skipped step on an H&E-only batch and on
           a NaN one, each leaving the parameters, AdamW's moments and its
           count bit for bit
  train_got
           the same 5 steps with the published objective, InfoNCE + GOT
           (local_loss got, weight 1, 256 tokens subsampled per stain pair:
           260 transport problems of 256 x 256 per step): K6-K14 must launch
           on every step, and no global route of K8-K10 nor K13's or K14's
           first design on any; step ms, peak memory, a sha256 of the
           parameters after the steps (name order), the GOT share of the
           step and the GOT loss's device time split into glue kernels,
           transport kernels and the rest
  train_se the same 5 steps with stain encodings (--add_stain_encoding:
           d_in 544, K7's dx route): K6-K14 on every step, losses fall, no
           step skipped, the stain table moves; step ms and peak memory
  train_sigmoid
           the same 5 steps with --activation sigmoid (the per-op lane):
           kernels 15-20 and K8-K14 must launch on every step, K6/K7 on none;
           step ms and peak memory against train_got's; one step under
           cfg.remat (the default: each stain's body recomputed in its
           backward, the forward kernels twice a step) against one under
           --no_remat, the loss and every gradient bit for bit, each peak;
           the plain sigmoid pool's own peak, and one profiled step (device
           idle share)
  train_nofused
           the same 5 steps with softmax and MADELEINE_NO_FUSED_ENCODER=1
           (the softmax per-op lane): rows 4-5 and kernels 15-20 five times
           each per step (the forward ones ten: cfg.remat), K6/K7 never,
           K8-K14 as in train_got; step ms and
           peak memory; then the chain preattn -> gated_logits -> training
           pool -> linear_tok against K6/K7 on one modality at (0.1, 0.25)
           (pooled 2e-3 or one bf16 step, tokens 3e-2, gate and projector
           gradients 1e-2 but ba 5e-2, pre-attention ones 3e-2, bc within
           1e-3 of its predicted bf16 rounding term; K7 given the lane's
           bf16 cotangent and an inner from K6's pooled output), ba again
           with row 5 given K7's inner and the f32 y at 1e-2 (the causes of
           its looser bar), a rate-0 run beside it,
           and a shifted-mask control that must miss
  train_views
           the published objective plus the intra-modality InfoNCE
           (--intra_modality_loss info-nce, n_views=3) at full width, 5
           steps on the fused route (K6/K7's view route once per modality a
           step) and 5 under MADELEINE_NO_FUSED_ENCODER (rows 4-5 three times
           per modality a step, kernels 15-20 once); the loss falls, no step
           skipped; step ms, peak memory and launches
  train_f32
           the published step at --precision float32: 5 InfoNCE + GOT steps
           at 65 x 5 x 2048 f32 (the loss falls, none skipped, K6/K7 with f32
           operands and K8-K14 on every step, no bf16 K6/K7; one step under
           sync debug "error", 3 back to back); then one step from the
           trained weights against the same step with K6/K7's plain versions
           on the card: the loss within 1e-5 relative, every gradient within
           1e-4 relative Frobenius (bc 1e-4 absolutely); step ms, host ms a
           step, peak, the weights' digest, the plain step's ms. Then full
           bags in f32: a ragged batch at bucket 16384 (lengths in [1024,
           16384]), 2 steps with every K6/K7 call in blocks of whole bags
           (none skipped, one back to back), and a batch of lengths up to
           8192 padded to 16384 (in blocks) against its own step (one
           block): the loss within 1e-5 relative, every gradient 1e-4
           relative Frobenius, bc 1e-4
  train_perop_f32
           the per-op lane at --precision float32: 5 published f32 steps
           (InfoNCE + GOT, 65 x 5 x 2048) with --activation sigmoid, then 3
           with softmax under MADELEINE_NO_FUSED_ENCODER: the loss falls,
           none skipped, rows 15-18 f32 once per modality on every step
           (15 and 17 twice: cfg.remat's recompute), no bf16 row 15-18, no
           K6/K7; then one sigmoid step against the same
           step with rows 15-18's plain versions on the card: the loss within
           1e-5 relative, every gradient within 1e-4 relative Frobenius (each
           head's bc within 1e-4 absolutely, as in train_f32); then full bags:
           a ragged sigmoid f32 batch at bucket 16384, one step with every
           per-op call in two blocks of whole bags (rows 15-18 f32 once a
           block, 15 and 17 twice), step ms and peak, and a batch of bucket
           8192 against it padded to 16384 (loss 1e-5, gradients 1e-4, bc
           1e-4)
  train_ragged
           the published step on full-bag batches (the CLI's default
           --n_subsamples -1): (a) bag lengths log-uniform in [1024, 16384],
           bucket 16384, where every K6/K7 call must take the recompute
           route (15.3 GB of saves a call, past the 10 GiB budget); (b) in
           [1024, 8192], bucket 8192, the save route; (c) in [1024, 32768],
           bucket 32768, every K6/K7 call on the recompute route in blocks
           of whole bags; three IHC bags empty in each; 5 steps each for (a)
           and (b), 2 for (c) (loss falls in (a) and (b), none skipped,
           K6-K14 every step, the route and the blocks from the counters,
           one step under sync debug "error", 3 back to back), peak and
           reserved GB, one profiled step's idle share for (a) and (b);
           then batch (a) padded to 32768 (in blocks) and batch (b) padded
           to 16384 (the recompute route), one step each from the same
           weights and seed against the unpadded step (losses 1e-4,
           gradients 1e-2)
  train_ragged_nofused
           the per-op chain's own peaks at [16, 16384] (bf16 softmax and
           sigmoid, f32 sigmoid) beside their reckoning; the softmax per-op
           lane (MADELEINE_NO_FUSED_ENCODER, bf16, cfg.remat) on a ragged
           [65, 5] batch at bucket 32768, 2 steps with every per-op call in
           blocks of whole bags: finite, none skipped, rows 4-5 and 15-20
           once a block every step (the forward ones twice), K6/K7 never,
           the peak under 80 GB, one step under sync debug "error", one
           back to back (the host's ms a step); a batch of bucket 16384
           against it padded to 32768 (losses 1e-4, gradients 1e-2)
  heads    65 bags of 2048 tokens embedded by encode_he (bf16, K1), then 5
           AdamW steps of an MLP head and of a ProjHead (f32, dropout 0.2:
           row 21 in every forward and backward); the loss falls
  pretrain the pretrain CLI's main (in this process, as every CLI run but
           data_parallel's torchrun one) with the flags of
           scripts/launch_pretrain_withoutStainEncodings.sh (65 cases x 5
           stains x 2048 tokens, bf16, InfoNCE + GOT) on a synthetic cohort
           of 70 cases (about 0.9 GB of f32 .bag files of 512-2560 tokens,
           written by the port's writer, 20% of IHC bags missing) in a temp
           dir. First the native loader's first batch of epoch 0 (pinned
           ring, bf16, and once in f32) against its plain version bit for
           bit, its draw and assembly ms, bytes and GB/s, and the H2D ms of
           the bf16 batch. Then, through --native_loader auto (the native
           loader, asserted from metrics.jsonl: native-bf16): A 2 epochs with
           --checkpoint_every 1, B A resumed to 3 epochs, C 3 epochs
           straight, each with a 16-bag --downstream_dir. Every step finite
           and applied, K6-K14 on every step, K1 in each downstream pass, the
           artifacts written, B's model.pt equal to C's bit for bit; the
           loader's host ms per batch and parts, the CLI's step ms against
           train_got's, epoch time, stream busy share and peak memory; then
           the flags of scripts/launch_pretrain_withStainEncodings.sh: A' 1
           epoch, B' A' resumed to 2, C' 2 straight, B' equal to C' bit for
           bit; then the first script's flags with --activation sigmoid and
           --native_loader off (the Python loader, whose host ms, parts and
           f32 H2D ms are reported beside the native one's), 1 epoch
           (kernels 15-20 and K8-K14 on every step), with
           MADELEINE_NO_FUSED_ENCODER=1, 1 epoch (rows 4-5, 15-20, K8-K14),
           and with --intra_modality_loss info-nce, 1 epoch (K6-K14); then
           1 epoch with --profile_dir, its trace.json summarised by
           madeleine_torch.tools.profile_summary: one step_fn range a step,
           the wgmma GEMM and K6's and K7's row kernels among the top 20,
           the kernels inside the ranges at or below the ranges' ms. Before
           them, a pinned batch freed while its copy waits behind device
           work must reach the card intact (the Python loader's batches
           outlive their copies through PyTorch's caching host allocator)
  pretrain_ragged
           the pretrain CLI with its default --n_subsamples (-1, full bags)
           on 70 cases of bf16 .bag bags of 300-8000 tokens (bucket 8192),
           some stains absent: native loader A 1 epoch, B A resumed to 2, C
           2 straight (B's model.pt equal to C's bit for bit), and 1 epoch
           on the Python RaggedTrainLoader (--native_loader off); the host
           ms per batch, H2D ms, pinned bytes, CLI step ms, busy share; then
           (a) the CLI's main at the published batch of 65 on links to the
           same 70 cases where case 0's H&E bag has 20000 tokens (bucket
           32768), 2 epochs of 2 steps and the downstream pass with a
           20000-token slide (K1 at the inference loader's bucket 32768):
           nothing truncated, 2 steps at 32768, the native ring 2 slots
           deep (21.81 GB pinned), its construction s, MemAvailable before
           and during, host ms, guard wait and step ms by bucket, the peak;
           (b) that ring under a Prefetcher of depth 2 for 2 epochs, each
           copy (into a buffer made beforehand) behind about 1 s of device
           sleep: the third batch waits
           on its guard, padded rows zero on the card, the last task of a
           32768 batch (past 2**31 elements) and the long bag bit for bit
           their .bag files' rows; (c) the CSV tool
           (madeleine_torch.tools.build_dataset_csvs --scan_features) over
           .npz stand-ins of the 70 cases' bags: the cohort's CSV byte for
           byte; then the CLI at --batch_size 8 with --activation sigmoid
           on 16 cases with a 20000-token bag (the per-op lane at bucket
           32768: kernels 15-20 every step)
  pretrain_f32
           the pretrain CLI at --precision float32 with its default full bags
           on pretrain_ragged's cohort (bucket 8192: every K6/K7 call on the
           recompute route, the native loader assembling f32): A 1 epoch, B A
           resumed to 2, C 2 straight, B's model.pt equal to C's bit for bit,
           K6/K7 f32 and K8-K14 on every step, K2 downstream; step ms, peak;
           then one epoch with --activation sigmoid (rows 15-18 f32 on every
           step, no bf16 row 15-18, no K6/K7; its peak under cfg.remat
           beside the 70.88 GB measured without it, PERF.md §5)
  data_parallel
           (a) world size 1 on NCCL: the published steps' weights bit for
           bit the steps' without a group; (b) two Gloo ranks on the card
           against one process on the same rows, in bf16 (gradients within
           one bf16 step of the norms summed) and in f32 (every gradient
           within 1e-4 relative Frobenius), both in the ranks' one pair of
           processes; (c) bag parallelism against K1; (d) the CLI under
           torchrun, model.pt bit for bit the plain CLI's, on the pretrain
           phase's cohort
  profile  torch.profiler device time by kernel of one K6 and one K7 call at
           [65, 2048] and of kernels 15-18 and 20 alone at that shape, of
           one full-width train step of each objective and of the no-fused
           GOT step, the sigmoid step and the intra-modality step, each
           also over 3 steps launched back to back in one window (the device
           idle share per step): none may launch the mma.sync GEMM, and that counts only
           in a window that shows every wgmma product and row kernel of the
           wrapper calls it ran (WINDOW_KERNELS, the step's calls read from
           the launch counters; a short window is taken again, up to ten,
           then the phase fails); and of one full-width eval forward, with
           their device idle share; each read from a second
           profiled window after a warm-up window (a first window can lose
           its kernels), the K6/K7 single windows reported beside them
Then the main path's launches of each kernel, and K6/K7's and the per-op
lane's calls in blocks of whole bags and their blocks, split into the
published runs, the side lanes,
the ragged runs and the f32 runs (train_f32, pretrain_f32), a
{"kernels": [...]} summary line (K6's and K7's rows, bf16 and f32, also with
their save-off and recompute routes), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Needs CUDA and the repo checkout around it.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import gc
import hashlib
import importlib.util
import io
import itertools
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "pool_kernels", "pool_train_kernels", "dropout_kernel",
          "train_kernels", "train_kernels_f32", "got_kernels", "glue_kernels", "perop_kernels",
          "perop_kernels_f32", "perop_bwd_digest", "golden", "serve", "extract", "downstream",
          "probe", "eval_forward", "vit", "slide",
          "train", "train_got", "train_se", "train_sigmoid", "train_nofused", "train_views",
          "train_f32",
          "train_perop_f32", "train_ragged", "train_ragged_nofused", "heads", "pretrain",
          "pretrain_ragged", "pretrain_f32", "data_parallel", "profile")
# the runs of the port's main paths whose kernel launches the summary counts
MAIN_PATHS = ("serve", "extract", "downstream", "eval_forward", "slide", "train", "train_got",
              "train_se",
              "train_sigmoid", "train_nofused", "train_views", "train_views_nofused",
              "train_f32", "train_f32_ragged", "train_perop_f32", "train_perop_f32_nofused",
              "train_perop_f32_ragged", "train_ragged",
              "train_ragged_nofused", "heads", "pretrain", "pretrain_ragged", "pretrain_f32",
              "data_parallel")
# the main-path runs of the side lanes (a non-softmax activation, or softmax
# under MADELEINE_NO_FUSED_ENCODER); the pretrain phase splits its own
SIDE_PATHS = ("train_sigmoid", "train_nofused", "train_views_nofused")
# the full-bag (ragged) runs, a lane of their own (its no-fused run included)
RAGGED_PATHS = ("train_ragged", "train_ragged_nofused", "pretrain_ragged")
# the f32 runs (--precision float32: K6/K7, or on the per-op lane rows 15-18,
# with f32 operands), a lane of their own (the CLI's on full bags included)
F32_PATHS = ("train_f32", "train_f32_ragged", "train_perop_f32", "train_perop_f32_nofused",
             "train_perop_f32_ragged", "pretrain_f32")
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# K1 is also checked with wc scaled by this: the flagship init's attention
# logits spread by well under one unit, this spreads them by several
PEAK_WC_SCALE = 16.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median time of one call in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_back_to_back(fn, warmup: int = 3, calls: int = 50) -> float:
    """Device ms per call over `calls` calls launched back to back between
    two CUDA events: the device's time, without the host's launch gaps
    that the per-call clock of cuda_ms includes."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call over `calls` calls with no synchronize:
    what a launch costs the host while the device keeps up."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def flagship_state_dict(stain_encoding: bool = False):
    """tests/golden/generate.py::flagship_state_dict, loaded by file path
    (pure numpy); sys.path and sys.modules are restored afterwards."""
    path = os.path.join(HERE, "tests", "golden", "generate.py")
    saved_path, saved_mods = list(sys.path), set(sys.modules)
    spec = importlib.util.spec_from_file_location("_golden_generate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.path[:] = saved_path
    for name in set(sys.modules) - saved_mods:
        del sys.modules[name]
    return mod.flagship_state_dict(stain_encoding=stain_encoding)


def flagship_config(precision: str, stain_encoding: bool = False) -> dict:
    return {"wsi_encoder": "abmil", "patch_embedding_dim": 512,
            "wsi_encoder_hidden_dim": 512, "attention_hidden_dim": 512, "n_heads": 4,
            "activation": "softmax", "precision": precision, "dataset": "ACROBAT",
            "add_stain_encoding": stain_encoding}


def flagship_model(torch, precision: str, stain_encoding: bool = False):
    """The port model with the flagship weights, on the card, in eval mode."""
    from madeleine_torch.config import MadeleineConfig
    from madeleine_torch.models.madeleine import MADELEINE

    model = MADELEINE(MadeleineConfig.from_dict(flagship_config(precision, stain_encoding)))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in flagship_state_dict(stain_encoding).items()})
    return model.cuda().eval()


def write_model_dir(root: str, precision: str, stain_encoding: bool = False) -> str:
    """<root>/MADELEINE/{model.pt, model_config.json} with the flagship weights."""
    import torch

    d = os.path.join(root, "MADELEINE")
    os.makedirs(d, exist_ok=True)
    torch.save({k: torch.from_numpy(v) for k, v in flagship_state_dict(stain_encoding).items()},
               os.path.join(d, "model.pt"))
    with open(os.path.join(d, "model_config.json"), "w") as f:
        json.dump(flagship_config(precision, stain_encoding), f)
    return d


def reset_counts():
    from madeleine_torch.ops import launches

    launches.reset()


# kernels no path of the port launches: K8-K10's global routes (problems
# beyond a cluster's shared memory, never on a path's 256 x 256 problems)
# and the first designs of K1, K2, K13, K14 and rows 15-18 and 20, kept as checks
OFF_PATH = ("ipot_fwd_global", "ipot_bwd_global", "gw_gamma_global", "gw_trace_bwd_rowblock",
            "gw_trace_fwd_rowblock", "encode_fused_rowtile", "gated_pool_ffma",
            "preattn_fwd_rowblock", "preattn_bwd_rowblock", "gated_logits_fwd_rowblock",
            "gated_logits_bwd_rowblock", "linear_tok_bwd_mmasync")


def _check_off_path(counts, where):
    """Raise if a path's launch counts include an OFF_PATH kernel (a
    counter this tree's package lacks counts 0)."""
    hit = {k: counts.get(k, 0) for k in OFF_PATH if counts.get(k, 0)}
    if hit:
        raise AssertionError(f"{where}: launched kernels that no path takes: {hit}")


def read_counts() -> dict:
    from madeleine_torch.ops import launches

    return launches.read()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(state):
    import torch

    state["kind"] = torch.cuda.get_device_name(0)
    state["smi"] = nvidia_smi_line()
    emit({"phase": "device", "kind": state["kind"], "count": torch.cuda.device_count(),
          "nvidia_smi": state["smi"], "torch": torch.__version__,
          "cuda": torch.version.cuda})


def phase_build(state):
    from madeleine_torch.ops import _build

    t0 = time.perf_counter()
    host = {}

    def build_host():   # g++ (the native loader's library) beside the nvcc builds
        try:
            if os.path.exists(_build.lib_path("bagio")):
                os.unlink(_build.lib_path("bagio"))
            _build.build_host("bagio")
            host["seconds"] = time.perf_counter() - t0
        except BaseException as e:
            host["error"] = e

    thread = threading.Thread(target=build_host)
    thread.start()
    reports = _build.build(force=True)
    thread.join()
    if "error" in host:
        raise host["error"]
    secs = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in r.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
             for n, r in reports.items()}
    emit({"phase": "build", "seconds": secs, "built": sorted(reports), "ptxas": ptxas,
          "host_library": {"bagio": _build.lib_path("bagio"), "seconds": host["seconds"],
                           "flags": " ".join([_build.HOST_CXX, *_build.HOST_FLAGS])},
          "wgmma_kernel_spills": _spills(reports, ("gemm_kernel", "gate_logits_sum")),
          "tf32_kernel_spills": _spills(reports, ("tf32_gemm_kernel",
                                                  "split_weights_kernel")),
          "k8_k14_kernel_spills": _spills(reports, ("ipot_fwd_cluster_kernel",
                                                    "gwt_bwd_tiles_kernel")),
          "k1_k13_kernel_spills": _spills(reports, ("gwt_fwd_tiles_kernel", "tile_flags",
                                                    "live_scan", "gather_tiles", "pool_tiles",
                                                    "ln_gelu_rows"))})


def _spills(reports, names):
    """{library: {kernel: [spill store bytes, spill load bytes]}} of the
    kernels whose mangled names contain one of `names`, from ptxas -v."""
    out = {}
    for lib, rep in reports.items():
        kernel = None
        for ln in rep.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                kernel = m.group(1) if any(n in m.group(1) for n in names) else None
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m and kernel:
                out.setdefault(lib, {})[kernel] = [int(m.group(1)), int(m.group(2))]
                kernel = None
    return out


def _kernel_inputs(torch, b, t, lengths, gen):
    from madeleine_torch.models.abmil import encoder_weights, pre_attn_mlp
    from madeleine_torch.models.madeleine import MADELEINE
    from madeleine_torch.config import MadeleineConfig
    from madeleine_torch.ops.attn_pool import mask_bias

    cfg = MadeleineConfig.from_dict(flagship_config("bfloat16"))
    model = MADELEINE(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flagship_state_dict().items()})
    model = model.cuda().eval()
    with torch.no_grad():
        w = encoder_weights(model.wsi_embedders)
        x = torch.from_numpy(gen.standard_normal((b, t, 512)).astype(np.float32)).cuda()
        mask = torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]
        bias = mask_bias(mask, b, t, cfg.n_heads, torch.device("cuda"))
        y = pre_attn_mlp(w, x)  # f32 MLP, head-major: K2's input
    return model, mask.cuda(), w, x, bias, y


def _check_k1(torch, w, x, bias, y, n_valid, atol=3e-2, kernel=None):
    """K1 (the live-tile route, or `kernel`: the first design) against its
    plain version twice: with the flagship weights, whose
    attention logits spread by well under one unit (a nearly uniform pool),
    and with wc scaled by PEAK_WC_SCALE, whose logits spread by several units.
    The control: with wc = 0 (a uniform pool) the plain output must differ
    from the peaked one by more than atol, or the check could not see a K1
    whose gates or logits were wrong. y is the f32 MLP output; the logit
    spread is read over the first bag's n_valid tokens."""
    from madeleine_torch.models.abmil import gated_attention_logits
    from madeleine_torch.ops.encode_fused import (encode_fused_cuda,
                                                  encode_pool_fused_plain, kernel_weights)

    kernel = kernel or encode_fused_cuda
    wk = kernel_weights(w, torch.bfloat16)
    xb = x.to(torch.bfloat16).contiguous()
    nh, _, e = w["wa"].shape
    report = {}
    for name, scale in (("flagship", 1.0), ("peaked", PEAK_WC_SCALE)):
        wks = dict(wk, wc=wk["wc"] * scale)
        got = kernel(xb, bias, wks)
        want = encode_pool_fused_plain(xb, bias, wks)
        uniform = encode_pool_fused_plain(xb, bias, dict(wks, wc=torch.zeros_like(wks["wc"])))
        logits = gated_attention_logits(dict(w, wc=w["wc"] * scale),
                                        y[0, :n_valid].reshape(n_valid, nh, e))
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"encode_fused ({name}): non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        if not err <= atol:
            raise AssertionError(f"encode_fused ({name}): max |kernel - plain| {err} > {atol}")
        report[name] = {
            "wc_scale": scale, "max_abs_err": err,
            "uniform_pool_vs_plain": (uniform.float() - want.float()).abs().max().item(),
            "logit_std_min_head": logits.std(dim=0).min().item(),
            "logit_range_min_head": (logits.max(0).values - logits.min(0).values).min().item()}
    if not report["peaked"]["uniform_pool_vs_plain"] > atol:
        raise AssertionError(f"encode_fused: control failed, a uniform pool is within "
                             f"{atol} of the peaked plain output: {report['peaked']}")
    return report, xb, wk


K2_KERNELS = ("gated_pool", "gated_pool_ffma")


def _check_k2(torch, w, y, bias, rtol=1e-4, atol=1e-5):
    """K2 (the split-TF32 wgmma design) and its first design (FP32 FMA)
    against the plain version at rtol / atol, with the flagship weights and
    with wc scaled by PEAK_WC_SCALE; the controls: with wc = 0 (a uniform
    pool), and on TF32-rounded y, Wa and Wb (the hi . hi term alone, as a
    kernel that lost the split's lo terms would compute), the plain output
    must miss the bar against the peaked one. Each design twice, bitwise
    equal; the route from the counters. Returns (report, gate weights,
    the kernel's split operands of them)."""
    from madeleine_torch.ops.gated_pool import (gated_attention_pool_plain, gated_pool_cuda,
                                                gated_pool_ffma_cuda, round_tf32, split_operands)

    gw = {k: w[k].float().contiguous() for k in ("wa", "ba", "wb", "bb", "wc", "bc")}
    split = split_operands(**gw)
    y_hi = round_tf32(y)

    def over(a, b):   # the largest error as a share of the bar
        return ((a - b).abs() / (atol + rtol * b.abs())).max().item()

    report = {}
    for name, scale in (("flagship", 1.0), ("peaked", PEAK_WC_SCALE)):
        ws = dict(gw, wc=gw["wc"] * scale)
        ops = dict(split, wc=ws["wc"])
        before = read_counts()
        got = gated_pool_cuda(y, bias, **ops)
        torch.cuda.synchronize()
        after = read_counts()
        route = {k: after[k] - before[k] for k in K2_KERNELS}
        again = gated_pool_cuda(y, bias, **ops)
        first, first_again = gated_pool_ffma_cuda(y, bias, **ws), gated_pool_ffma_cuda(y, bias, **ws)
        want = gated_attention_pool_plain(y, bias, **ws)
        uniform = gated_attention_pool_plain(y, bias, **dict(ws, wc=torch.zeros_like(ws["wc"])))
        hi_only = gated_attention_pool_plain(y_hi, bias, **dict(ws, wa=round_tf32(ws["wa"]),
                                                               wb=round_tf32(ws["wb"])))
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.isfinite(first).all()):
            raise AssertionError(f"gated_pool ({name}): non-finite output")
        rep = {"wc_scale": scale, "max_abs_err": (got - want).abs().max().item(),
               "max_err_over_bar": over(got, want),
               "first_design_max_abs_err": (first - want).abs().max().item(),
               "first_design_max_err_over_bar": over(first, want),
               "vs_first_design_max_abs": (got - first).abs().max().item(),
               "uniform_pool_over_bar": over(uniform, want),
               "tf32_hi_only_over_bar": over(hi_only, want), "route": route}
        report[name] = rep
        if route != {"gated_pool": 1, "gated_pool_ffma": 0}:
            raise AssertionError(f"gated_pool ({name}): left the split-TF32 route: {route}")
        if not (torch.equal(got, again) and torch.equal(first, first_again)):
            raise AssertionError(f"gated_pool ({name}): two launches differ")
        if not (rep["max_err_over_bar"] <= 1.0 and rep["first_design_max_err_over_bar"] <= 1.0):
            raise AssertionError(f"gated_pool ({name}): missed rtol {rtol} / atol {atol}: {rep}")
    for control in ("uniform_pool_over_bar", "tf32_hi_only_over_bar"):
        if not report["peaked"][control] > 1.0:
            raise AssertionError(f"gated_pool: control {control} failed, it is within the bar "
                                 f"of the peaked plain output: {report['peaked']}")
    return report, gw, split


K1_SMALL_SHAPE = (1, 512)   # serving's smallest bucket, one request
K1_D544_SHAPE = (2, 1000, 544)   # stain-encoded bags: d_in 544, a partial last tile


def _k1_route(torch, fn):
    """Run fn once; {counter: launches} of K1's two designs during it."""
    before = read_counts()
    out = fn()
    torch.cuda.synchronize()
    after = read_counts()
    return out, {k: after[k] - before[k] for k in ("encode_fused", "encode_fused_rowtile")}


def _check_k1_d544(torch, wk, gen, atol=3e-2):
    """K1's live-tile route at d_in 544 (the stain-encoded input; the TMA
    operand's k tail is no multiple of 64) against its plain version: a
    random layer-1 weight, one bag full and one ragged."""
    from madeleine_torch.ops.attn_pool import mask_bias
    from madeleine_torch.ops.encode_fused import encode_fused_cuda, encode_pool_fused_plain

    b, t, d_in = K1_D544_SHAPE
    w1 = gen.standard_normal((wk["w1"].shape[0], d_in)).astype(np.float32) / d_in ** 0.5
    w = dict(wk, w1=torch.from_numpy(w1).cuda().to(torch.bfloat16))
    x = torch.from_numpy(gen.standard_normal((b, t, d_in)).astype(np.float32)).cuda()
    x = x.to(torch.bfloat16)
    mask = (torch.arange(t)[None, :] < torch.tensor([[t], [613]])).cuda()
    bias = mask_bias(mask, b, t, w["wa"].shape[0], torch.device("cuda"))
    got, route = _k1_route(torch, lambda: encode_fused_cuda(x, bias, w))
    err = (got.float() - encode_pool_fused_plain(x, bias, w).float()).abs().max().item()
    if not (torch.isfinite(got.float()).all() and err <= atol):
        raise AssertionError(f"encode_fused d_in {d_in}: max |kernel - plain| {err} > {atol}")
    return {"shape": [b, t, d_in], "max_abs_err": err, "route": route}


# extraction's calls (eval/inference.py, 262,144 tokens per batch): bucket
# 8192 at its batch of 32 (4096 tile slots, 8 chunks) and bucket 1024 at its
# batch of 64 (1024 slots, 2 chunks); each with ragged bags of the bucket
# and the tail batch's empty padding bags
# (b, t, ragged bags, their least length, whether a chunk holds no live tile)
K1_EXTRACT_CASES = {"b32_t8192": (32, 8192, 24, 4097, True),
                    "b64_t1024": (64, 1024, 60, 513, False)}


def _check_k1_chunks(torch, wk, gen, atol=3e-2):
    """K1's live-tile route at extraction's call shapes, which run several
    chunks (the chunk loop, the list offset, a chunk with no live rows),
    against its plain version and its first design, flagship and peaked
    logits; the empty bags pool to 0; the route from the counters."""
    from madeleine_torch.ops.attn_pool import mask_bias
    from madeleine_torch.ops.encode_fused import (chunk_plan, encode_fused_cuda,
                                                  encode_fused_rowtile_cuda,
                                                  encode_pool_fused_plain, live_tiles_plain)

    nh, d_in = wk["wa"].shape[0], wk["w1"].shape[1]
    report = {}
    for name, (b, t, n_bags, lo, empty_chunk) in K1_EXTRACT_CASES.items():
        lengths = gen.integers(lo, t + 1, n_bags).tolist() + [0] * (b - n_bags)
        mask = (torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]).cuda()
        bias = mask_bias(mask, b, t, nh, torch.device("cuda"))
        g = torch.Generator("cuda").manual_seed(SEED)
        x = torch.randn(b, t, d_in, generator=g, device="cuda").to(torch.bfloat16)
        nchunks = chunk_plan(b, t)[2]
        rows = live_tiles_plain(bias)[2].tolist()
        if sum(r > 0 for r in rows) < 2 or (empty_chunk and min(rows) > 0):
            raise AssertionError(f"encode_fused {name}: the shape does not run several "
                                 f"chunks with an empty one: {rows}")
        case = {"shape": [b, t], "lengths": lengths, "chunks": nchunks, "chunk_rows": rows}
        for scale_name, scale in (("flagship", 1.0), ("peaked", PEAK_WC_SCALE)):
            w = dict(wk, wc=wk["wc"] * scale)
            got, route = _k1_route(torch, lambda: encode_fused_cuda(x, bias, w))
            want = encode_pool_fused_plain(x, bias, w)
            first = encode_fused_rowtile_cuda(x, bias, w)
            err = (got.float() - want.float()).abs().max().item()
            err_first = (got.float() - first.float()).abs().max().item()
            if not (torch.isfinite(got.float()).all() and err <= atol and err_first <= atol):
                raise AssertionError(f"encode_fused {name} ({scale_name}): max |kernel - "
                                     f"plain| {err}, |kernel - first design| {err_first} > {atol}")
            if not (got[n_bags:] == 0).all():
                raise AssertionError(f"encode_fused {name}: an empty bag does not pool to 0")
            if route != {"encode_fused": 1, "encode_fused_rowtile": 0}:
                raise AssertionError(f"encode_fused {name}: left the live-tile route: {route}")
            case[scale_name] = {"max_abs_err": err, "vs_first_design": err_first}
        case["ms"] = cuda_ms(lambda: encode_fused_cuda(x, bias, wk), iters=10)
        case["rowtile_ms"] = cuda_ms(lambda: encode_fused_rowtile_cuda(x, bias, wk), iters=10)
        report[name] = case
        del x, bias, want, first
    return report


def phase_kernels(state):
    import torch
    from madeleine_torch.models.abmil import abmil_embed, encoder_weights, kernel_operands
    from madeleine_torch.ops.encode_fused import (chunk_plan, encode_fused_cuda,
                                                  encode_fused_rowtile_cuda,
                                                  encode_pool_fused_plain, kernel_weights)
    from madeleine_torch.ops.gated_pool import (gated_attention_pool_plain, gated_pool_cuda,
                                                gated_pool_ffma_cuda)

    gen = np.random.default_rng(SEED)
    b, t = 8, 4096
    lengths = [4096, 4000, 3001, 2048, 1500, 777, 65, 0]   # one empty bag: pools to 0
    model, mask, w, x, bias, y = _kernel_inputs(torch, b, t, lengths, gen)
    k1_report, xb, wk = _check_k1(torch, w, x, bias, y, lengths[0])
    # the first design (check-only) at the same shape and bars
    k1_rowtile_report, _, _ = _check_k1(torch, w, x, bias, y, lengths[0],
                                        kernel=encode_fused_rowtile_cuda)
    k2_report, gw, split = _check_k2(torch, w, y, bias)
    # partial last tile: t = 4057 (63 tiles of 64 + 25 rows)
    t2, lengths2 = 4057, [4057, 4033]
    _, _, w_, x_, bias_, y_ = _kernel_inputs(torch, 2, t2, lengths2, gen)
    k1p_report, _, _ = _check_k1(torch, w_, x_, bias_, y_, lengths2[0])
    k2p_report, _, _ = _check_k2(torch, w_, y_, bias_)
    del w_, x_, bias_, y_
    k1_d544 = _check_k1_d544(torch, wk, gen)
    k1_chunks = _check_k1_chunks(torch, wk, gen)
    err1 = max(r["max_abs_err"] for r in k1_report.values())
    err1p = max(r["max_abs_err"] for r in k1p_report.values())
    err2 = max(r["max_abs_err"] for r in k2_report.values())
    err2p = max(r["max_abs_err"] for r in k2p_report.values())

    # the route each shape takes, from the counters; the empty bag pools to 0
    dense = torch.zeros_like(bias)
    bs, ts = K1_SMALL_SHAPE
    xs = xb[:bs, :ts].contiguous()
    small = torch.zeros(bs, ts, bias.shape[-1], device="cuda")
    routes = {"d_in_544": k1_d544["route"]}
    for name, (xx, bb) in {"timing": (xb, bias), "all_valid": (xb, dense),
                           "small": (xs, small)}.items():
        got, routes[name] = _k1_route(torch, lambda: encode_fused_cuda(xx, bb, wk))
        if name == "timing" and not (got[lengths.index(0)] == 0).all():
            raise AssertionError("encode_fused: the empty bag does not pool to 0")
    want_route = {"encode_fused": 1, "encode_fused_rowtile": 0}
    if any(r != want_route for r in routes.values()):
        raise AssertionError(f"encode_fused: a shape left the live-tile route: {routes}")

    tokens = int(sum(lengths))
    nh, f, e = w["wa"].shape
    E, d_in = nh * e, x.shape[-1]
    per_token = 2.0 * (d_in * e + e * e + e * E + 2 * E * f + E)
    wbytes = sum(wk[k].numel() * wk[k].element_size() for k in
                 ("w1", "b1", "s1", "t1", "w2", "b2", "s2", "t2", "w3", "b3", "s3", "t3",
                  "wa", "ba", "wb", "bb", "wc", "bc"))

    def k1_bound(bags, n_tok):
        """(bound ms, whether the operations bound it) for n_tok valid tokens."""
        ops = n_tok * per_token / PEAK_BF16
        mem = (n_tok * (d_in * 2 + nh * 4) + bags * E * 2 + wbytes) / PEAK_BYTES
        return max(ops, mem) * 1e3, ops >= mem

    k2_flops = tokens * 2.0 * (2 * E * f + E)
    k2_bytes = (tokens * (E * 4 + nh * 4) + b * E * 4
                + sum(v.numel() * v.element_size() for v in gw.values()))
    k1_ms = cuda_ms(lambda: encode_fused_cuda(xb, bias, wk))
    k1_b2b = cuda_ms_back_to_back(lambda: encode_fused_cuda(xb, bias, wk), 3, 20)
    k1_rowtile_ms = cuda_ms(lambda: encode_fused_rowtile_cuda(xb, bias, wk))
    k1_plain = cuda_ms(lambda: encode_pool_fused_plain(xb, bias, wk), iters=10)
    k2_ms = cuda_ms(lambda: gated_pool_cuda(y, bias, **split))
    k2_b2b = cuda_ms_back_to_back(lambda: gated_pool_cuda(y, bias, **split), 3, 20)
    k2_ffma_ms = cuda_ms(lambda: gated_pool_ffma_cuda(y, bias, **gw))
    k2_ffma_b2b = cuda_ms_back_to_back(lambda: gated_pool_ffma_cuda(y, bias, **gw), 3, 20)
    k2_plain = cuda_ms(lambda: gated_attention_pool_plain(y, bias, **gw), iters=10)
    k1_bound_ms, k1_by_ops = k1_bound(b, tokens)
    # K2's f32-accurate products are three TF32 products on this card (the
    # split-TF32 design); the FP32 FMA figure, the first design's own
    # bound, stays beside it
    k2_bound = max(3 * k2_flops / PEAK_TF32, k2_bytes / PEAK_BYTES) * 1e3
    k2_bound_ffma = max(k2_flops / PEAK_FP32, k2_bytes / PEAK_BYTES) * 1e3
    # the same inputs with every token valid: the kernels' per-token rate
    k1_dense = cuda_ms(lambda: encode_fused_cuda(xb, dense, wk))
    k1_rowtile_dense = cuda_ms(lambda: encode_fused_rowtile_cuda(xb, dense, wk))
    k2_dense = cuda_ms(lambda: gated_pool_cuda(y, dense, **split))
    k2_ffma_dense = cuda_ms(lambda: gated_pool_ffma_cuda(y, dense, **gw))
    k1_dense_bound = k1_bound(b, b * t)[0]
    k2_dense_bound = k2_bound * b * t / tokens
    # a small serving call (one bag of the smallest bucket): both designs
    k1_small = cuda_ms(lambda: encode_fused_cuda(xs, small, wk), iters=30)
    k1_small_b2b = cuda_ms_back_to_back(lambda: encode_fused_cuda(xs, small, wk), 3, 50)
    k1_rowtile_small = cuda_ms(lambda: encode_fused_rowtile_cuda(xs, small, wk), iters=30)
    # K1's and K2's device time by kernel at the timing shape (torch.profiler)
    k1_rows = [[_kernel_base(k), c, ms]
               for k, c, ms in _profiled(torch, lambda: encode_fused_cuda(xb, bias, wk))]
    k2_rows = [[_kernel_base(k), c, ms] for k, c, ms in
               _profiled(torch, lambda: gated_pool_cuda(y, bias, **split))]
    # what the model layer adds around K1: the operands' build (once per
    # weight state; kernel_operands' lookup is what a call pays), mask bias
    emb = model.wsi_embedders
    operands_ms = cuda_ms(lambda: kernel_weights(encoder_weights(emb), torch.bfloat16))
    operands_cached_ms = cuda_ms(lambda: kernel_operands(emb, torch.bfloat16))
    embed_ms = cuda_ms(lambda: abmil_embed(emb, xb, mask=mask))
    state.setdefault("kernels", {}).update({
        "encode_fused": {
            "name": "encode_fused", "route": "cuda",
            "source": "madeleine_torch/csrc/encode_fused.cu",
            "replaces": "madeleine_tpu/ops/encode_fused.py:126",
            "max_abs_err": max(err1, err1p, k1_d544["max_abs_err"],
                               *(c[k]["max_abs_err"] for c in k1_chunks.values()
                                 for k in ("flagship", "peaked"))), "ms": k1_ms,
            "plain_ms": k1_plain, "bound_ms": k1_bound_ms,
            "bound_by": "operations" if k1_by_ops else "bytes", "library_ms": None},
        "gated_pool": {
            "name": "gated_pool", "route": "cuda",
            "source": "madeleine_torch/csrc/gated_pool.cu",
            "replaces": "madeleine_tpu/ops/gated_pool.py:40",
            "max_abs_err": max(err2, err2p), "ms": k2_ms, "plain_ms": k2_plain,
            "bound_ms": k2_bound,
            "bound_by": ("operations" if 3 * k2_flops / PEAK_TF32 >= k2_bytes / PEAK_BYTES
                         else "bytes"),
            "library_ms": None},
    })
    slots, cap, nchunks, rows = chunk_plan(b, t)
    emit({"phase": "kernels", "names": ["encode_fused", "gated_pool"], "b": b, "t": t,
          "lengths": lengths, "valid_tokens": tokens, "partial_tile_t": t2,
          "encode_fused": {"max_abs_err": err1, "max_abs_err_partial": err1p, "atol": 3e-2,
                           "checks": k1_report, "checks_partial": k1p_report,
                           "checks_d_in_544": k1_d544, "checks_extract_chunks": k1_chunks,
                           "routes": routes,
                           "rowtile_checks": k1_rowtile_report,
                           "chunks": {"slots": slots, "cap_tiles": cap, "chunks": nchunks,
                                      "scratch_rows": rows},
                           "ms": k1_ms, "ms_back_to_back": k1_b2b, "rowtile_ms": k1_rowtile_ms,
                           "plain_ms": k1_plain, "bound_ms": k1_bound_ms,
                           "share_of_bound": k1_bound_ms / k1_ms, "gflop": tokens * per_token / 1e9,
                           "ms_all_valid": k1_dense, "rowtile_ms_all_valid": k1_rowtile_dense,
                           "bound_ms_all_valid": k1_dense_bound,
                           "small_shape": list(K1_SMALL_SHAPE), "ms_small": k1_small,
                           "ms_small_back_to_back": k1_small_b2b,
                           "rowtile_ms_small": k1_rowtile_small,
                           "bound_ms_small": k1_bound(bs, bs * ts)[0],
                           "device_ms_by_kernel": k1_rows,
                           "device_ms": sum(r[2] for r in k1_rows),
                           "operands_ms": operands_ms, "operands_cached_ms": operands_cached_ms,
                           "abmil_embed_ms": embed_ms},
          "gated_pool": {"max_abs_err": err2, "max_abs_err_partial": err2p, "rtol": 1e-4,
                         "atol": 1e-5, "checks": k2_report, "checks_partial": k2p_report,
                         "ms": k2_ms, "ms_back_to_back": k2_b2b, "first_design_ms": k2_ffma_ms,
                         "first_design_ms_back_to_back": k2_ffma_b2b, "plain_ms": k2_plain,
                         "bound_ms": k2_bound, "bound_by": "operations, 3 x TF32",
                         "bound_ms_ffma": k2_bound_ffma, "share_of_bound": k2_bound / k2_ms,
                         "first_design_share_of_bound": k2_bound / k2_ffma_ms,
                         "first_design_share_of_ffma_bound": k2_bound_ffma / k2_ffma_ms,
                         "gflop": k2_flops / 1e9, "tf32_tflop_per_s": 3 * k2_flops / k2_ms / 1e9,
                         "ms_all_valid": k2_dense, "first_design_ms_all_valid": k2_ffma_dense,
                         "bound_ms_all_valid": k2_dense_bound,
                         "device_ms_by_kernel": k2_rows,
                         "device_ms": sum(r[2] for r in k2_rows)}})


# K3: the eval forward's call (one modality of the canonical batch), bars against its plain version
POOL_SHAPE = (65, 2048, 4, 512)      # b, t, heads, head width
POOL_TAIL_T = 2000                   # 31 tiles of 64 + 16 rows
# (rtol, atol, atol as a share of the bag's max|plain output|): bf16 is one output rounding
POOL_TOL = {"bf16": (2e-2, 0.0, 1e-2), "f32": (1e-4, 1e-5, 0.0)}
POOL_LOGIT_STD = 0.3   # the flagship weights' attention logits spread by well under one unit


def _pool_lengths(b, t):
    """32 full bags, 32 ragged ones from 1 to t - 1 tokens, one empty."""
    return [t] * 32 + [int(n) for n in np.linspace(1, t - 1, b - 33)] + [0]


def _k3_plain(y, l):
    """K3's plain version on its operands: y [b, t, nh*e], pre-masked f32
    logits [b, t, nh] -> [b, nh*e] in y's dtype."""
    from madeleine_torch.ops import attn_pool as ap

    return ap.softmax_pool_plain(l, y.view(*y.shape[:2], l.shape[-1], -1)).to(y.dtype)


def _check_k3(torch, y, logits, mask, tol):
    """K3 against its plain version with the logits as given and peaked
    (x PEAK_WC_SCALE), each within |got - want| <= atol + rtol |want| with
    atol scaled to each bag's largest output; two launches bitwise equal;
    the empty bag 0. The control of each case: a uniform pool (logits 0)
    must break that bar in every full bag (`uniform_miss_full_bags`, the
    least over the full bags of the largest |uniform - want| over the
    allowed error, must exceed 1), or the case could not fail a wrong
    weight where the pool is nearest uniform."""
    from madeleine_torch.ops import attn_pool as ap

    rtol, atol0, atol_share = tol
    l0 = torch.zeros_like(logits).masked_fill(~mask[..., None], ap.NEG_INF)
    uniform = _k3_plain(y, l0).float()
    rep = {}
    for name, scale in (("spread", 1.0), ("peaked", PEAK_WC_SCALE)):
        l = (logits * scale).masked_fill(~mask[..., None], ap.NEG_INF).contiguous()
        got, again = ap.attn_pool_cuda(y, l), ap.attn_pool_cuda(y, l)
        want = _k3_plain(y, l).float()
        torch.cuda.synchronize()
        atol = atol0 + atol_share * want.abs().amax(1, keepdim=True)
        allowed = (atol + rtol * want.abs()).clamp_min(1e-12)   # the empty bag's is 0
        over = (got.float() - want).abs() / allowed
        empty, full = ~mask.any(1), mask.all(1)
        rep[name] = {"max_abs_err": (got.float() - want).abs().max().item(),
                     "atol_range": [atol.min().item(), atol.max().item()],
                     "max_err_over_allowed": over.max().item(),
                     "uniform_miss_full_bags":
                         ((uniform - want).abs() / allowed)[full].amax(1).min().item(),
                     "bitwise_equal": torch.equal(got, again),
                     "finite": bool(torch.isfinite(got.float()).all()),
                     "empty_bags_zero": bool((got[empty] == 0).all())}
        if not (rep[name]["bitwise_equal"] and rep[name]["finite"]
                and rep[name]["empty_bags_zero"]):
            raise AssertionError(f"attn_pool {list(y.shape)} {y.dtype} ({name}): {rep[name]}")
        if not rep[name]["max_err_over_allowed"] <= 1.0:
            raise AssertionError(f"attn_pool {list(y.shape)} {y.dtype} ({name}): outside "
                                 f"atol + rtol |want|: {rep[name]}")
        if not rep[name]["uniform_miss_full_bags"] > 1.0:
            raise AssertionError(f"attn_pool ({name}): control failed, a uniform pool is within "
                                 f"the bar of the plain output: {rep[name]}")
    return rep


def _sdpa_pool(torch, y, l):
    """The library's call for K3's function, timed and checked only:
    scaled_dot_product_attention with zero q and k (so q.k = 0) and the
    logits as an additive mask gives softmax(l) . y per head. The mask is
    laid out head-major [b, nh, 1, t] in y's dtype before the call."""
    import torch.nn.functional as F

    b, t, nh = l.shape
    e = y.shape[-1] // nh
    v = y.view(b, t, nh, e).transpose(1, 2)
    q = torch.zeros(b, nh, 1, e, dtype=y.dtype, device=y.device)
    k = torch.zeros(b, nh, t, e, dtype=y.dtype, device=y.device)
    mask = l.permute(0, 2, 1).contiguous().to(y.dtype)[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask).reshape(b, nh * e)


def phase_pool_kernels(state):
    import torch
    from madeleine_torch.ops import attn_pool as ap

    b, t, nh, e = POOL_SHAPE
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    checks, times = {}, {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for tt in (t, POOL_TAIL_T):
            y = torch.randn(b, tt, nh * e, generator=g, device="cuda").to(dtype)
            logits = POOL_LOGIT_STD * torch.randn(b, tt, nh, generator=g, device="cuda")
            mask = (torch.arange(tt, device="cuda")[None, :]
                    < torch.tensor(_pool_lengths(b, tt), device="cuda")[:, None])
            checks[f"{label}_t{tt}"] = _check_k3(torch, y, logits, mask, POOL_TOL[label])
        # the eval forward's call: every token valid, t = 2048 (y is the tail's; remake)
        y = torch.randn(b, t, nh * e, generator=g, device="cuda").to(dtype)
        l = POOL_LOGIT_STD * torch.randn(b, t, nh, generator=g, device="cuda")
        ms = cuda_ms(lambda: ap.attn_pool_cuda(y, l), warmup=3, iters=20)
        plain_ms = cuda_ms(lambda: _k3_plain(y, l), warmup=1, iters=5)
        sdpa = _sdpa_pool(torch, y, l)
        library_ms = cuda_ms(sdpa, warmup=3, iters=20)
        library_err = (sdpa().float() - _k3_plain(y, l).float()).abs().max().item()
        nbytes = y.numel() * y.element_size() + l.numel() * 4 + b * nh * e * y.element_size()
        flops = 2.0 * b * t * nh * e + 3.0 * b * t * nh     # a multiply-add per element; exp
        bound, by = _bound(flops, nbytes, PEAK_FP32)
        times[label] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                        "library_max_abs_err": library_err, "bound_ms": bound, "bound_by": by,
                        "share_of_bound": bound / ms, "gb": nbytes / 1e9,
                        "achieved_tb_per_s": nbytes / ms / 1e9}
        del y, l, sdpa
    err = max(r["max_abs_err"] for c in checks.values() for k, r in c.items()
              if isinstance(r, dict))
    st = times["bf16"]
    state.setdefault("kernels", {})["attn_pool"] = {
        "name": "attn_pool", "route": "cuda", "source": "madeleine_torch/csrc/attn_pool.cu",
        "replaces": "madeleine_tpu/ops/attn_pool.py:107", "max_abs_err": err, "ms": st["ms"],
        "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": st["library_ms"]}
    emit({"phase": "pool_kernels", "shape": POOL_SHAPE, "tail_t": POOL_TAIL_T,
          "lengths": "32 full, 32 from 1 to t-1, 1 empty", "logit_std": POOL_LOGIT_STD,
          "peak_scale": PEAK_WC_SCALE, "tol": POOL_TOL, "checks": checks, "times": times})


# Rows 4-5, the training pool of the softmax per-op lane: the no-fused step's
# call shape (one modality), a long bag, and a partial last tile
POOL_TRAIN_SHAPES = ((65, 2048), (8, 4096), (65, POOL_TAIL_T))
POOL_TRAIN_GRAD_RTOL = 1e-2   # dx and dl, relative Frobenius
POOL_STATS_RTOL = 1e-5        # s against the plain sum; sum_t a = 1 per live bag


def _pool_train_lengths(b, t):
    """Half the bags full, the rest ragged from 1 to t - 1 tokens, one empty."""
    full = b // 2
    return [t] * full + [int(n) for n in np.linspace(1, t - 1, b - full - 1)] + [0]


def _check_pool_train(torch, y, logits, mask, tol, gen):
    """Row 4 against pool_ms_plain (pooled within K3's bar, m equal, s at
    POOL_STATS_RTOL, the weights exp(l - m) / s summing to 1 over each live
    bag), then row 5 against pool_bwd_plain on row 4's stats with a random
    cotangent (dx and dl at POOL_TRAIN_GRAD_RTOL relative Frobenius); each
    launched twice, bitwise equal; the empty bag's pooled output, dx and dl
    exactly 0."""
    from madeleine_torch.ops import attn_pool as ap

    b, t, E = y.shape
    nh = logits.shape[-1]
    rtol, atol0, atol_share = tol
    l = logits.masked_fill(~mask[..., None], ap.NEG_INF).contiguous()
    got, again = ap.pool_ms_cuda(y, l), ap.pool_ms_cuda(y, l)
    pooled, m, s = got
    wp, wm, ws = ap.pool_ms_plain(y, l)
    live, empty = mask.any(1), ~mask.any(1)
    want = wp.float()
    atol = atol0 + atol_share * want.abs().amax(1, keepdim=True)
    over = ((pooled.float() - want).abs() / (atol + rtol * want.abs()).clamp_min(1e-12)).max()
    a_sum = ap.pool_weights(l, m, s).sum(1)
    g = torch.from_numpy(gen.standard_normal((b, E)).astype(np.float32)).cuda()
    inner = (g * pooled.float()).reshape(b, nh, -1).sum(-1)
    dx, dl = ap.pool_bwd_cuda(y, l, m, s, g, inner)
    dx2, dl2 = ap.pool_bwd_cuda(y, l, m, s, g, inner)
    wdx, wdl = ap.pool_bwd_plain(y, l, m, s, g, inner)
    torch.cuda.synchronize()
    rep = {"pooled_max_abs_err": (pooled.float() - want).abs().max().item(),
           "pooled_max_err_over_allowed": over.item(),
           "m_equal": torch.equal(m, wm),
           "s_max_rel_err": ((s - ws).abs() / ws).max().item(),
           "weights_sum_max_abs_dev": (a_sum[live] - 1).abs().max().item(),
           "dx_rel_fro": _rel_fro(dx.float(), wdx.float()), "dl_rel_fro": _rel_fro(dl, wdl),
           "dx_max_abs_err": (dx.float() - wdx.float()).abs().max().item(),
           "dl_max_abs_err": (dl - wdl).abs().max().item(),
           "bitwise_equal": all(torch.equal(u, v) for u, v in zip(got, again))
           and torch.equal(dx, dx2) and torch.equal(dl, dl2),
           "finite": bool(torch.isfinite(pooled.float()).all() and torch.isfinite(dl).all()
                          and torch.isfinite(dx.float()).all()),
           "empty_bags_zero": bool((pooled[empty] == 0).all() and (dx[empty] == 0).all()
                                   and (dl[empty] == 0).all())}
    ok = (rep["pooled_max_err_over_allowed"] <= 1.0 and rep["m_equal"]
          and rep["s_max_rel_err"] <= POOL_STATS_RTOL
          and rep["weights_sum_max_abs_dev"] <= POOL_STATS_RTOL
          and max(rep["dx_rel_fro"], rep["dl_rel_fro"]) <= POOL_TRAIN_GRAD_RTOL
          and rep["bitwise_equal"] and rep["finite"] and rep["empty_bags_zero"])
    if not ok:
        raise AssertionError(f"attn_pool_ms/bwd {list(y.shape)} {y.dtype}: {rep}")
    return rep


def phase_pool_train_kernels(state):
    """Rows 4 and 5 against their plain versions, bf16 and f32, at the
    no-fused step's call shape [65, 2048, 2048], at b=8 t=4096 and at
    t = 2000 (a partial last tile), ragged bags and one empty; timed at
    [65, 2048] beside their plain versions and the library's calls."""
    import torch
    import torch.nn.functional as F
    from madeleine_torch.ops import attn_pool as ap

    _, _, nh, e = POOL_SHAPE
    gen = np.random.default_rng(SEED + 10)
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    checks, times = {}, {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for b, t in POOL_TRAIN_SHAPES:
            y = torch.randn(b, t, nh * e, generator=g, device="cuda").to(dtype)
            logits = POOL_LOGIT_STD * PEAK_WC_SCALE * torch.randn(b, t, nh, generator=g,
                                                                  device="cuda")
            mask = (torch.arange(t, device="cuda")[None, :]
                    < torch.tensor(_pool_train_lengths(b, t), device="cuda")[:, None])
            checks[f"{label}_{b}x{t}"] = _check_pool_train(torch, y, logits, mask,
                                                           POOL_TOL[label], gen)
            del y, logits, mask
        # timed at the step's call: every token valid
        b, t = POOL_TRAIN_SHAPES[0]
        y = torch.randn(b, t, nh * e, generator=g, device="cuda").to(dtype)
        l = POOL_LOGIT_STD * torch.randn(b, t, nh, generator=g, device="cuda")
        pooled, m, s = ap.pool_ms_cuda(y, l)
        gp = torch.randn(b, nh * e, generator=g, device="cuda")
        inner = (gp * pooled.float()).reshape(b, nh, e).sum(-1)
        fwd_ms = cuda_ms(lambda: ap.pool_ms_cuda(y, l), warmup=3, iters=20)
        bwd_ms = cuda_ms(lambda: ap.pool_bwd_cuda(y, l, m, s, gp, inner), warmup=3, iters=20)
        fwd_plain = cuda_ms(lambda: ap.pool_ms_plain(y, l), warmup=1, iters=5)
        bwd_plain = cuda_ms(lambda: ap.pool_bwd_plain(y, l, m, s, gp, inner), warmup=1, iters=5)
        sdpa = _sdpa_pool(torch, y, l)
        fwd_lib = cuda_ms(sdpa, warmup=3, iters=20)
        # the library's backward: SDPA's through autograd, for v (= y) and the
        # additive mask (= the logits), timed alone on a retained graph
        v = y.view(b, t, nh, e).transpose(1, 2).detach().requires_grad_(True)
        q = torch.zeros(b, nh, 1, e, dtype=dtype, device="cuda")
        k = torch.zeros(b, nh, t, e, dtype=dtype, device="cuda")
        bias = l.permute(0, 2, 1).contiguous().to(dtype)[:, :, None, :].requires_grad_(True)
        try:
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            go = gp.view(b, nh, 1, e).to(dtype)
            bwd_lib = cuda_ms(lambda: torch.autograd.grad(out, (v, bias), go, retain_graph=True),
                              warmup=2, iters=10)
            bwd_lib_note = "scaled_dot_product_attention backward (dv and the mask's gradient)"
        except RuntimeError as exc:   # no backend takes a mask that needs a gradient
            bwd_lib, bwd_lib_note = None, f"none: {str(exc)[:160]}"
        del v, q, k, bias
        nb = y.element_size()
        fwd_bytes = y.numel() * nb + l.numel() * 4 + b * nh * e * nb + 2 * b * nh * 4
        bwd_bytes = 2 * y.numel() * nb + 2 * l.numel() * 4 + b * nh * e * 4 + 3 * b * nh * 4
        fwd_bound = _bound(2.0 * b * t * nh * e + 3.0 * b * t * nh, fwd_bytes, PEAK_FP32)
        bwd_bound = _bound(3.0 * b * t * nh * e + 5.0 * b * t * nh, bwd_bytes, PEAK_FP32)
        times[label] = {
            "attn_pool_ms": {"ms": fwd_ms, "plain_ms": fwd_plain, "library_ms": fwd_lib,
                             "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                             "share_of_bound": fwd_bound[0] / fwd_ms},
            "attn_pool_bwd": {"ms": bwd_ms, "plain_ms": bwd_plain, "library_ms": bwd_lib,
                              "library": bwd_lib_note, "bound_ms": bwd_bound[0],
                              "bound_by": bwd_bound[1], "share_of_bound": bwd_bound[0] / bwd_ms}}
        del y, l, pooled, m, s, gp, inner, sdpa
    for name, (src, replaces, err_keys) in {
            "attn_pool_ms": ("madeleine_torch/csrc/attn_pool.cu",
                             "madeleine_tpu/ops/attn_pool.py:144", ("pooled_max_abs_err",)),
            "attn_pool_bwd": ("madeleine_torch/csrc/attn_pool.cu",
                              "madeleine_tpu/ops/attn_pool.py:157",
                              ("dx_max_abs_err", "dl_max_abs_err"))}.items():
        tm = times["bf16"][name]
        state.setdefault("kernels", {})[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "max_abs_err": max(c[k] for c in checks.values() for k in err_keys),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm["library_ms"]}
    emit({"phase": "pool_train_kernels", "shapes": POOL_TRAIN_SHAPES, "tol": POOL_TOL,
          "grad_rtol_fro": POOL_TRAIN_GRAD_RTOL, "stats_rtol": POOL_STATS_RTOL,
          "logit_std": POOL_LOGIT_STD * PEAK_WC_SCALE, "checks": checks, "times": times})


DROPOUT_HEAD_SHAPE = (65, 512)   # a head's activations in the heads phase
DROPOUT_SHAPES = ((4096, 512), (133120, 2048), (37, 21), DROPOUT_HEAD_SHAPE)   # JAX's
# verify shape, one modality's y [65 x 2048, 2048], an odd shape (element
# loads) and a head's (a partial last block of the vector path)
DROPOUT_KEEP_TOL = 0.01
DROPOUT_HEAD_PAIRS = 10   # alternating (wrapper, F.dropout) timings at a head's shape
LAUNCH_SHAPE = (1, 64, 2048)   # b, t, E of the row 19 and K3 launches timed on the host


def _dropout_cases(shape):
    """(row_offset, site) pairs checked at a shape: a shifted row offset on
    site 1, and at a head's shape the heads' own calls (row 0, sites 0 and 1)."""
    return ((3, 1),) + (((0, 0), (0, 1)) if shape == DROPOUT_HEAD_SHAPE else ())


def phase_dropout_kernel(state):
    """Row 21 against dropout_plain bit for bit, bf16 and f32, at rates 0.1,
    0.2 and 0.25, at each shape of DROPOUT_SHAPES and (row offset, site) of
    _dropout_cases; the keep share within DROPOUT_KEEP_TOL of 1 - rate (at
    the two large shapes); the backward's mask equal to the forward's; two
    launches equal; timed at [133120, 2048] bf16 beside the plain version
    and F.dropout, and at a head's [65, 512] f32 (the wrapper, the heads'
    autograd route forward and backward, and F.dropout, on cuda_ms's clock
    as before and in host microseconds per call; the wrapper against
    F.dropout in DROPOUT_HEAD_PAIRS alternating pairs), with the host
    microseconds of a row 19 and a K3 launch at LAUNCH_SHAPE."""
    import torch
    import torch.nn.functional as F
    from madeleine_torch.ops import _build
    from madeleine_torch.ops import attn_pool as ap
    from madeleine_torch.ops import dropout as dp

    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    checks, err = {}, 0.0
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for shape in DROPOUT_SHAPES:
            x = torch.randn(*shape, generator=g, device="cuda").to(dtype)
            for (ro, site), rate in itertools.product(_dropout_cases(shape), (0.1, 0.2, 0.25)):
                got = dp.dropout_cuda(x, 17, rate, ro, site)
                again = dp.dropout_cuda(x, 17, rate, ro, site)
                want = dp.dropout_plain(x, 17, rate, ro, site)
                xr = x.clone().requires_grad_(True)
                out = dp.dropout(xr, rate, 17, row_offset=ro, site=site)
                out.backward(torch.ones_like(out))
                keep = xr.grad != 0
                torch.cuda.synchronize()
                rep = {"bitwise_equal_plain": torch.equal(got, want),
                       "two_launches_equal": torch.equal(got, again),
                       "backward_mask_is_forward": torch.equal(
                           keep, dp.dropout_plain(torch.ones_like(x), 17, rate, ro, site) != 0)
                       and torch.equal(out, got),
                       "keep_share": keep.float().mean().item()}
                err = max(err, (got.float() - want.float()).abs().max().item())
                checks[f"{label}_{shape[0]}x{shape[1]}_row{ro}_site{site}_rate{rate}"] = rep
                keep_ok = (x.numel() < 10 ** 6   # a small shape's share: too few sites
                           or abs(rep["keep_share"] - (1 - rate)) <= DROPOUT_KEEP_TOL)
                if not (rep["bitwise_equal_plain"] and rep["two_launches_equal"]
                        and rep["backward_mask_is_forward"] and keep_ok):
                    raise AssertionError(f"dropout {shape} {dtype} row {ro} site {site} "
                                         f"rate {rate}: {rep}")
                del got, again, want, xr, out, keep
            del x
    x = torch.randn(*DROPOUT_SHAPES[1], generator=g, device="cuda").to(torch.bfloat16)
    ms = cuda_ms(lambda: dp.dropout_cuda(x, 17, 0.1), warmup=3, iters=20)
    plain_ms = cuda_ms(lambda: dp.dropout_plain(x, 17, 0.1), warmup=1, iters=3)
    lib_ms = cuda_ms(lambda: F.dropout(x, 0.1, training=True), warmup=3, iters=20)
    bound, by = _bound(0.0, 2 * x.numel() * x.element_size())
    del x
    # a head's call, where the host's launch path sets the time
    h = torch.randn(*DROPOUT_HEAD_SHAPE, generator=g, device="cuda")
    hr, ones = h.clone().requires_grad_(True), torch.ones_like(h)
    calls = {"dropout_cuda": lambda: dp.dropout_cuda(h, 17, 0.2),
             "autograd_fwd_bwd": lambda: dp.dropout(hr, 0.2, 17).backward(ones),
             "F.dropout": lambda: F.dropout(h, 0.2, training=True)}
    head = {"ms": cuda_ms(calls["dropout_cuda"], warmup=3, iters=20),
            "autograd_fwd_bwd_ms": cuda_ms(calls["autograd_fwd_bwd"], warmup=3, iters=20),
            "library_ms": cuda_ms(calls["F.dropout"], warmup=3, iters=20),
            "bound_ms": _bound(0.0, 2 * h.numel() * 4)[0]}
    pairs = []
    for i in range(DROPOUT_HEAD_PAIRS):
        order = ("dropout_cuda", "F.dropout")[::1 if i % 2 == 0 else -1]
        t = {k: cuda_ms(calls[k], warmup=3, iters=20) for k in order}
        pairs.append([t["dropout_cuda"], t["F.dropout"]])
    head["pairs_ms"] = pairs
    head["pairs_won"] = sum(a <= b for a, b in pairs)
    # the host's cost of a launch: row 21 three ways, one bare call_ptrs
    # launch of row 19's entry point and one K3 call at LAUNCH_SHAPE
    b, t, E = LAUNCH_SHAPE
    y = torch.randn(b, t, E, generator=g, device="cuda").to(torch.bfloat16)
    wt = (torch.randn(128, E, generator=g, device="cuda") / E ** 0.5).to(torch.bfloat16)
    bt, tok = torch.zeros(128, device="cuda"), torch.empty(b, t, 128, dtype=y.dtype,
                                                           device="cuda")
    logits = torch.randn(b, t, 4, generator=g, device="cuda")
    calls["linear_tok_call_ptrs"] = lambda: _build.call_ptrs(
        "linear_tok", "linear_tok_forward", [y, wt, bt, tok], [b * t, E, 128], [], y.device)
    calls["attn_pool_cuda"] = lambda: ap.attn_pool_cuda(y, logits)
    head["host_us"] = {k: host_us(fn) for k, fn in calls.items()}
    del h, hr, ones, y, wt, bt, tok, logits, calls
    state.setdefault("kernels", {})["dropout"] = {
        "name": "dropout", "route": "cuda", "source": "madeleine_torch/csrc/dropout.cu",
        "replaces": "madeleine_tpu/ops/dropout.py:31", "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
    emit({"phase": "dropout_kernel", "shapes": DROPOUT_SHAPES, "keep_tol": DROPOUT_KEEP_TOL,
          "checks": checks, "times_shape": DROPOUT_SHAPES[1],
          "times": {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
                    "bound_by": by, "share_of_bound": bound / ms},
          "head_shape": DROPOUT_HEAD_SHAPE, "head_f32": head, "launch_shape": LAUNCH_SHAPE})


def _encoder_train_work(b, t, w, need_dx=False, n_views=1, recompute=False):
    """(flops, bytes) of one K6 and one K7 call: every row of [b, t] is
    computed (masked tokens still get token outputs and residuals); with
    need_dx K7 also computes and writes dx [b, t, d_in] in x's type (bf16
    or f32, the type of w's matrices, as x, tokens and residuals). Each view past
    the first adds a pool (E multiply-adds a token; its adjoint two) and
    its pooled output (K6) or cotangent (K7), [b, E] f32. On the recompute
    route K6 writes no residuals and K7 reads none, but re-runs K6's
    layer and gate products."""
    nh, f, _ = w["wa"].shape
    hd, d_in = w["w1"].shape
    dout, E = w["wt"].shape
    n = b * t
    macs = d_in * hd + hd * hd + hd * E + 2 * E * f + E * dout
    views = n_views - 1
    fwd_flops = n * 2.0 * (macs + views * E)
    # dW for all, dX for all but layer 1 (and layer 1 too with need_dx)
    bwd_flops = n * 2.0 * (2 * macs - (0 if need_dx else d_in * hd) + 2 * views * E)
    q = w["w1"].element_size()                           # 2 (bf16) or 4 (f32)
    saved = q * (2 * hd + E + 2 * nh * f) + 12          # u1 u2 u3 a_pre b_pre, rstd f32
    wbytes = sum(v.numel() * v.element_size() for v in w.values())
    fwd_bytes = n * (d_in * q + dout * q + nh * 4 + saved) + wbytes + n_views * b * E * 4
    bwd_bytes = n * (d_in * q + nh * 4 + dout * q + saved) + wbytes + n_views * b * E * 4 + 4 * sum(
        v.numel() for v in w.values()) + (n * d_in * q if need_dx else 0)
    if recompute:
        fwd_bytes -= n * saved
        bwd_bytes -= n * saved
        bwd_flops += n * 2.0 * (d_in * hd + hd * hd + hd * E + 2 * E * f)
    return fwd_flops, fwd_bytes, bwd_flops, bwd_bytes


def _bound(flops, nbytes, peak_flops=PEAK_BF16):
    """(least ms, "operations" or "bytes") of work at the card's peaks."""
    ops, mem = flops / peak_flops, nbytes / PEAK_BYTES
    return max(ops, mem) * 1e3, ("operations" if ops >= mem else "bytes")


GRAD_RTOL = 1e-2   # relative Frobenius bar of each K7 gradient (bf16 operands, f32 sums)
# bc's exact gradient is 0 (softmax shift invariance): absolute bar. What the
# kernel and the plain version give is the f32 rounding of a sum of
# cancelling terms over every token, on either operand type
BC_ATOL = 1e-4
F32_RTOL, F32_ATOL = 1e-4, 1e-5   # K6's outputs with f32 operands, elementwise
F32_GRAD_RTOL = 1e-4              # each K7 gradient and dx with f32 operands
POOLED_ATOL = 2e-3  # K6's f32 pooled output (largest error seen: 8.3e-4, peaked weights)
OUT_ATOL = 3e-2    # K6's bf16 tokens and f32 valid logits, as K1
TILE = 64          # K6's pool tile (csrc/encoder_train_fwd.cu POOL_TM)


def _f32_excess(torch, got, want):
    """max(|got - want| - (F32_ATOL + F32_RTOL |want|)): <= 0 within the bar."""
    return ((got - want).abs() - (F32_ATOL + F32_RTOL * want.abs())).max().item()


def _check_train_kernels(torch, w, x, bias, rates, gen, need_dx=False, vb=None):
    """K6 against its plain version, then K7 against its plain version on the
    same residuals, with a random pooled cotangent and a random dtok (and
    with need_dx its input gradient dx, as the other gradients); with a view
    bias vb [t, 2] (n_views=3) the three views' pooled outputs and
    cotangents. K6 and K7 each run twice and must give bitwise-equal
    results. bf16 operands: pooled within POOLED_ATOL, tokens and valid
    logits OUT_ATOL, gradients GRAD_RTOL; f32 operands (x in f32): every
    output within rtol F32_RTOL / atol F32_ATOL, gradients F32_GRAD_RTOL;
    bc within BC_ATOL on both. Returns (report, K6's outputs, K6's
    arguments, K7's arguments; with need_dx also K7's gradients); the
    arguments end with the keywords to pass (need_dx, vb)."""
    from madeleine_torch.ops import encoder_train as et

    b, t, _ = x.shape
    nh, _, e = w["wa"].shape
    views = () if vb is None else (3,)
    f32 = x.dtype == torch.float32
    fwd_args = (x, bias, w, 1234, 0, *rates)
    got = et.encoder_train_fwd_cuda(*fwd_args, vb=vb)
    again = et.encoder_train_fwd_cuda(*fwd_args, vb=vb)
    with torch.no_grad():
        want = et.encoder_train_fwd_plain(*fwd_args, vb=vb)
    torch.cuda.synchronize()
    rep = {}
    valid = bias == 0
    for name, i in (("pooled", 0), ("tok", 3)):
        if not torch.isfinite(got[i].float()).all():
            raise AssertionError(f"encoder_train_fwd: non-finite {name}")
        rep[f"{name}_err"] = (got[i].float() - want[i].float()).abs().max().item()
    rep["logits_err"] = (got[4] - want[4]).abs()[valid].max().item()
    if f32:
        rep["excess_over_f32_bar"] = {
            "pooled": _f32_excess(torch, got[0], want[0]),
            "tok": _f32_excess(torch, got[3], want[3]),
            "logits": _f32_excess(torch, got[4][valid], want[4][valid])}
        bad = {k: v for k, v in rep["excess_over_f32_bar"].items() if not v <= 0}
        if bad:
            raise AssertionError(f"encoder_train_fwd f32 {list(x.shape)} {rates}: past rtol "
                                 f"{F32_RTOL} / atol {F32_ATOL} by {bad}")
    for k, bar in (() if f32 else (("pooled_err", POOLED_ATOL), ("tok_err", OUT_ATOL),
                                    ("logits_err", OUT_ATOL))):
        if not rep[k] <= bar:
            raise AssertionError(f"encoder_train_fwd {list(x.shape)} {rates}: {k} {rep[k]} "
                                 f"> {bar}")
    if not all(torch.equal(a, c) for a, c in zip(got[:5], again[:5])):
        raise AssertionError("encoder_train_fwd: two launches differ")
    del again, want
    pooled32, m, s, _, l, saved = got
    g = torch.from_numpy(gen.standard_normal((b, *views, nh * e)).astype(np.float32)).cuda()
    dtok = torch.from_numpy(gen.standard_normal((b, t, w["wt"].shape[0])).astype(np.float32)
                            ).cuda().to(x.dtype)
    inner = (g * pooled32).reshape(b, *views, nh, e).sum(-1)
    bwd_args = (x, l, m, s, g, inner, dtok, saved, w, 1234, 0, *rates)
    grad_rtol = F32_GRAD_RTOL if f32 else GRAD_RTOL
    gk = et.encoder_train_bwd_cuda(*bwd_args, need_dx=need_dx, vb=vb)
    gk2 = et.encoder_train_bwd_cuda(*bwd_args, need_dx=need_dx, vb=vb)
    with torch.no_grad():
        gp = et.encoder_train_bwd_plain(*bwd_args, need_dx=need_dx, vb=vb)
    torch.cuda.synchronize()
    keys = et.W_KEYS + (("x",) if need_dx else ())
    if set(gk) != set(keys) or not all(torch.equal(gk[k], gk2[k]) for k in keys):
        raise AssertionError("encoder_train_bwd: two launches gave different gradients "
                             f"or outputs {sorted(gk)}")
    del gk2
    errs, abs_errs = {}, {}
    for k in keys:
        if not torch.isfinite(gk[k]).all():
            raise AssertionError(f"encoder_train_bwd: non-finite d{k}")
        diff = (gk[k] - gp[k]).float()
        abs_errs[k] = diff.abs().max().item()
        if k == "bc":
            errs[k] = diff.abs().max().item()
            ok = errs[k] <= BC_ATOL
        else:
            errs[k] = (diff.norm() / gp[k].float().norm().clamp_min(1e-30)).item()
            ok = errs[k] <= grad_rtol
        if not ok:
            raise AssertionError(f"encoder_train_bwd {list(x.shape)} {rates}: d{k} error "
                                 f"{errs[k]}")
    rep["grad_rel_fro"] = errs
    rep["grad_max_rel_fro"] = max(v for k, v in errs.items() if k != "bc")
    rep["grad_max_abs_err"] = max(abs_errs.values())
    rep["deterministic"] = True
    if need_dx:
        return rep, got, fwd_args, bwd_args, gk
    return rep, got, fwd_args, bwd_args


def _k7_keys(et, need_dx):
    return et.W_KEYS + (("x",) if need_dx else ())


def _grad_errs(torch, got, want, keys, where, rtol=GRAD_RTOL):
    """Relative Frobenius error of each gradient (bc: absolute) against the
    plain version's; raises past rtol (BC_ATOL) or on a non-finite one."""
    errs = {}
    for k in keys:
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f"{where}: non-finite d{k}")
        diff = (got[k] - want[k]).float()
        errs[k] = (diff.abs().max().item() if k == "bc"
                   else (diff.norm() / want[k].float().norm().clamp_min(1e-30)).item())
        if not errs[k] <= (BC_ATOL if k == "bc" else rtol):
            raise AssertionError(f"{where}: d{k} error {errs[k]}")
    return errs


def _check_recompute(torch, w, x, bias, rates, gen, need_dx=False, vb=None, timed=True):
    """The recompute route (B1c) against the save route on one call: K6 with
    save off gives the save route's pooled, m, s, tokens and logits bit for
    bit and no residuals; K7 with saved None (the residuals rebuilt on the
    card by K6's own code) gives the save route's gradients, and dx, bit
    for bit, twice; both routes held to the plain versions (save route: the
    usual checks) at the usual bars, the recompute route also against the
    plain recompute from x (every gradient but bc, whose exact value is 0,
    at GRAD_RTOL, F32_GRAD_RTOL with f32 operands; bc reported). K7's ms on
    both routes and K6's without saves (unless not `timed`)."""
    from madeleine_torch.ops import encoder_train as et

    rtol = F32_GRAD_RTOL if x.dtype == torch.float32 else GRAD_RTOL
    rep, got, fa, ba = _check_train_kernels(torch, w, x, bias, rates, gen, need_dx=need_dx,
                                            vb=vb)[:4]
    nosave = et.encoder_train_fwd_cuda(*fa, save=False, vb=vb)
    if nosave[5] is not None or not all(torch.equal(a, c) for a, c in zip(got[:5], nosave[:5])):
        raise AssertionError("encoder_train_fwd: the save-off launch differs from the save route")
    br = list(ba)
    br[7] = None
    keys = _k7_keys(et, need_dx)
    gs = et.encoder_train_bwd_cuda(*ba, need_dx=need_dx, vb=vb)
    gr = et.encoder_train_bwd_cuda(*br, need_dx=need_dx, vb=vb)
    gr2 = et.encoder_train_bwd_cuda(*br, need_dx=need_dx, vb=vb)
    unequal = [k for k in keys if not (torch.equal(gs[k], gr[k]) and torch.equal(gr[k], gr2[k]))]
    if unequal:
        raise AssertionError(f"encoder_train_bwd: the recompute route differs from the save "
                             f"route (or from itself) in {unequal}")
    with torch.no_grad():
        gp = et.encoder_train_bwd_plain(*ba, need_dx=need_dx, vb=vb)   # on K6's residuals
        gpr = et.encoder_train_bwd_plain(*br, need_dx=need_dx, vb=vb)   # plain recompute from x
    errs = _grad_errs(torch, gr, gp, keys, f"encoder_train_bwd recompute {list(x.shape)}", rtol)
    # against the plain recompute: its residuals are the plain forward's, not
    # K6's, so the exact-zero bc gradient holds other rounding noise there
    # (reported); every other gradient at GRAD_RTOL
    errs_pr = _grad_errs(torch, gr, gpr, [k for k in keys if k != "bc"],
                         f"encoder_train_bwd recompute vs plain recompute {list(x.shape)}", rtol)
    bc_pr = (gr["bc"] - gpr["bc"]).abs().max().item()
    del gs, gr2, gp, gpr
    times = {} if not timed else dict(
        k7_save_ms=cuda_ms(lambda: et.encoder_train_bwd_cuda(*ba, need_dx=need_dx, vb=vb)),
        k7_recompute_ms=cuda_ms(lambda: et.encoder_train_bwd_cuda(*br, need_dx=need_dx,
                                                                  vb=vb)),
        k6_nosave_ms=cuda_ms(lambda: et.encoder_train_fwd_cuda(*fa, save=False, vb=vb)))
    return dict(rep, **times, recompute_bitwise_equal_save=True, nosave_fwd_bitwise_equal=True,
                recompute_grad_max_rel_fro=max(v for k, v in errs.items() if k != "bc"),
                recompute_vs_plain_recompute_max_rel_fro=max(errs_pr.values()),
                recompute_vs_plain_recompute_bc_abs=bc_pr)


def _check_recompute_long(torch, w, lengths, rates, gen):
    """K6/K7 at the longest bucket's call shape [65, 16384], M = 1,064,960
    rows (K6's f32 scratch [M, 2048] past 2**31 elements): K6 with and
    without saves bit for bit equal; K6's outputs for the last bag (whose
    rows sit past 2**31 elements of that scratch) against the plain
    version on that bag alone (its global row kept); K7 with cotangents on
    the last bag only (every other gradient term exactly 0), the recompute
    route bit for bit equal to the save route and the save route's
    gradients against the plain backward of that bag alone; K7's ms on both
    routes and the recompute call's own peak (GB above its inputs)."""
    from madeleine_torch.ops import encoder_train as et

    b, t = len(lengths), 16384
    mask = torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]
    tg = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x = torch.randn(b, t, w["w1"].shape[1], generator=tg, device="cuda", dtype=torch.bfloat16)
    bias = et.token_mask_bias(mask.cuda(), b, t, "cuda")
    fa = (x, bias, w, 1234, 0, *rates)
    got = et.encoder_train_fwd_cuda(*fa)
    nosave = et.encoder_train_fwd_cuda(*fa, save=False)
    if not all(torch.equal(a, c) for a, c in zip(got[:5], nosave[:5])):
        raise AssertionError("encoder_train_fwd [65, 16384]: the save-off launch differs")
    del nosave
    last = b - 1
    with torch.no_grad():
        want = et.encoder_train_fwd_plain(x[last:], bias[last:], w, 1234, last, *rates,
                                          save=False)
    valid = bias[last:] == 0
    rep = {"pooled_err_last_bag": (got[0][last:] - want[0]).abs().max().item(),
           "tok_err_last_bag": (got[3][last:].float() - want[3].float()).abs().max().item(),
           "logits_err_last_bag": (got[4][last:] - want[4]).abs()[valid].max().item()}
    for k, bar in (("pooled_err_last_bag", POOLED_ATOL), ("tok_err_last_bag", OUT_ATOL),
                   ("logits_err_last_bag", OUT_ATOL)):
        if not rep[k] <= bar:
            raise AssertionError(f"encoder_train_fwd [65, 16384]: {k} {rep[k]} > {bar}")
    pooled32, m, s, _, l, saved = got
    nh, _, e = w["wa"].shape
    g = torch.zeros_like(pooled32)
    g[last] = torch.from_numpy(gen.standard_normal(nh * e).astype(np.float32)).cuda()
    dtok = torch.zeros(b, t, w["wt"].shape[0], dtype=torch.bfloat16, device="cuda")
    dtok[last] = torch.randn(t, w["wt"].shape[0], generator=tg, device="cuda",
                             dtype=torch.bfloat16)
    inner = (g * pooled32).reshape(b, nh, e).sum(-1)
    ba = (x, l, m, s, g, inner, dtok, saved, w, 1234, 0, *rates)
    br = list(ba)
    br[7] = None
    gs = et.encoder_train_bwd_cuda(*ba)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gr = et.encoder_train_bwd_cuda(*br)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    keys = et.W_KEYS
    unequal = [k for k in keys if not torch.equal(gs[k], gr[k])]
    if unequal:
        raise AssertionError(f"encoder_train_bwd [65, 16384]: recompute differs in {unequal}")
    with torch.no_grad():
        gp = et.encoder_train_bwd_plain(x[last:], l[last:], m[last:], s[last:], g[last:],
                                        inner[last:], dtok[last:],
                                        {k: v[last:] for k, v in saved.items()}, w, 1234, last,
                                        *rates)
    errs = _grad_errs(torch, gs, gp, keys, "encoder_train_bwd [65, 16384]")
    del gr, gp
    k7_save = cuda_ms(lambda: et.encoder_train_bwd_cuda(*ba), warmup=1, iters=3)
    k7_rec = cuda_ms(lambda: et.encoder_train_bwd_cuda(*br), warmup=1, iters=3)
    k6_save = cuda_ms(lambda: et.encoder_train_fwd_cuda(*fa), warmup=1, iters=3)
    k6_nosave = cuda_ms(lambda: et.encoder_train_fwd_cuda(*fa, save=False), warmup=1, iters=3)
    ff, fb, bf, bb_ = _encoder_train_work(b, t, w, recompute=True)
    (k6b, k6by), (k7b, k7by) = _bound(ff, fb), _bound(bf, bb_)
    return dict(rep, b=b, t=t, rows=b * t, valid_tokens=int(sum(lengths)),
                recompute_bitwise_equal_save=True,
                grad_max_rel_fro_last_bag=max(v for k, v in errs.items() if k != "bc"),
                k7_save_ms=k7_save, k7_recompute_ms=k7_rec, k6_save_ms=k6_save,
                k6_nosave_ms=k6_nosave, k7_recompute_own_peak_gb=peak,
                k7_recompute_bound_ms=k7b, k7_recompute_bound_by=k7by,
                k6_nosave_bound_ms=k6b, k6_nosave_bound_by=k6by)


BLOCKED_BAGS = 22   # _check_blocked's forced blocks: 22, 22 and 21 bags of 65
WIDTHS = (512, 512, 4, 512, 512, 128)   # published: d_in, hidden, heads, e, f, d_out


def _long_inputs(torch, w, t, lengths, seed, dtype):
    """x [b, t, 512] in `dtype` on the card from `seed` and the logit bias of
    prefix `lengths`."""
    from madeleine_torch.ops import encoder_train as et

    b = len(lengths)
    mask = torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]
    tg = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, t, w["w1"].shape[1], generator=tg, device="cuda", dtype=dtype)
    return x, et.token_mask_bias(mask.cuda(), b, t, "cuda"), tg


def _check_blocked(torch, w, t, lengths, rates, gen):
    """K6/K7 in forced blocks of whole bags (BLOCKED_BAGS: 22, 22 and 21)
    against the unblocked call at [65, t] on the recompute route (the route
    the save_acts gate gives both shapes checked: [65, 16384] bf16 and
    [65, 8192] f32), at the real rates, with dx: pooled, m, s, tokens,
    logits and dx bit for bit (each block's rows keep their global row, so
    their dropout masks). The weight gradients (blocks add their f32 sums in
    block order): each at least as close as the unblocked call's to the
    same kernel's gradients summed per bag in float64 (65 one-bag calls,
    short token sums), and within F32_GRAD_RTOL (1e-4) relative Frobenius
    of the unblocked call's with f32 operands, GRAD_RTOL with bf16 ones,
    whose tensor-core sums over a whole call's tokens lie about 3e-4 from
    the per-bag float64 sum (PERF §2); bc within BC_ATOL (its exact gradient
    is 0)."""
    from madeleine_torch.ops import encoder_train as et

    b = len(lengths)
    f32 = w["w1"].dtype == torch.float32
    x, bias, tg = _long_inputs(torch, w, t, lengths, SEED + 31, w["w1"].dtype)
    one, blocks = [(0, b)], [(b0, min(b0 + BLOCKED_BAGS, b)) for b0 in range(0, b, BLOCKED_BAGS)]
    fa = (x, bias, w, 1234, 0, *rates, None, False)
    got1 = et.encoder_train_fwd_blocks(*fa, one)
    gotb = et.encoder_train_fwd_blocks(*fa, blocks)
    unequal = [n for n, p, q in zip(("pooled", "m", "s", "tok", "l"), got1, gotb)
               if not torch.equal(p, q)]
    if unequal:
        raise AssertionError(f"encoder_train_fwd blocked [{b}, {t}]: differs in {unequal}")
    del gotb
    pooled32, m, s, _, l, _ = got1
    nh, _, e = w["wa"].shape
    g = torch.from_numpy(gen.standard_normal((b, nh * e)).astype(np.float32)).cuda()
    dtok = torch.randn(b, t, w["wt"].shape[0], generator=tg, device="cuda", dtype=x.dtype)
    inner = (g * pooled32).reshape(b, nh, e).sum(-1)
    ba = (x, l, m, s, g, inner, dtok, None, w, 1234, 0, *rates, True, None)
    g1 = et.encoder_train_bwd_blocks(*ba, one)
    gb = et.encoder_train_bwd_blocks(*ba, blocks)
    if not torch.equal(g1.pop("x"), gb.pop("x")):
        raise AssertionError(f"encoder_train_bwd blocked [{b}, {t}]: dx differs")
    # the same kernel's gradients summed per bag (one-bag calls, short token
    # sums) in float64: how far each order lies from a near-exact sum
    ref = {}
    for i in range(b):
        gi = et.encoder_train_bwd_cuda(*(v[i:i + 1] for v in ba[:7]), None, w, 1234, i,
                                       *rates)
        for k in et.W_KEYS:
            ref[k] = gi[k].double() + ref[k] if k in ref else gi[k].double()
        del gi
    vs_ref = {k: {"unblocked": _rel_fro(g1[k].double(), ref[k]),
                  "blocked": _rel_fro(gb[k].double(), ref[k])} for k in et.W_KEYS if k != "bc"}
    worse = {k: v for k, v in vs_ref.items() if not v["blocked"] <= v["unblocked"]}
    if worse:
        raise AssertionError(f"encoder_train_bwd blocked [{b}, {t}]: farther than the unblocked "
                             f"call from the per-bag float64 sum in {worse}")
    errs = _grad_errs(torch, gb, g1, et.W_KEYS, f"encoder_train_bwd blocked [{b}, {t}]",
                      F32_GRAD_RTOL if f32 else GRAD_RTOL)
    return {"b": b, "t": t, "dtype": "float32" if f32 else "bfloat16", "blocks": blocks,
            "fwd_and_dx_bitwise_equal": True,
            "grad_max_rel_fro": max(v for k, v in errs.items() if k != "bc"),
            "bc_abs": errs["bc"], "grad_rel_fro": errs, "vs_per_bag_f64": vs_ref}


C1_SHAPE = (65, 8192)        # _check_c1's call: bf16, the recompute route
C1_LEFT = 15 * 10 ** 9       # the memory the free-memory guard sees left under the patch


def _check_c1(torch, w, gen):
    """ROADMAP C1 on the card: one K6/K7 call through `encoder_train` at
    C1_SHAPE (ragged, the real rates, the recompute route, a fixed
    cotangent), once as it runs and once with torch.cuda.mem_get_info
    patched to report as free C1_LEFT bytes less what the caching allocator
    holds unallocated, so that the free-memory guard (`_device_hbm_limit`:
    the free bytes plus those) sees C1_LEFT left, where a rule reading it
    (`encoder_blocks` with that limit) gives two blocks. The rule reads the card's total
    memory: both calls must take the same blocks (the blocked-call
    counters) and leave the same weight gradients bit for bit."""
    from madeleine_torch.ops import encoder_train as et

    b, t = C1_SHAPE
    lengths = np.exp(gen.uniform(np.log(1024), np.log(t), b)).astype(np.int64)
    lengths[0] = t
    mask = (torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]).cuda()
    tg = torch.Generator(device="cuda").manual_seed(SEED + 43)
    x = torch.randn(b, t, w["w1"].shape[1], generator=tg, device="cuda").to(torch.bfloat16)
    nh, f, e = w["wa"].shape
    widths = (x.shape[2], w["w1"].shape[0], nh, e, f, w["wt"].shape[0])
    gp = torch.randn(b, nh, e, generator=tg, device="cuda")
    gt = torch.randn(b, t, w["wt"].shape[0], generator=tg, device="cuda").to(torch.bfloat16)
    total = torch.cuda.get_device_properties(0).total_memory
    out, grads = {}, {}

    def reported(*_a, **_k):   # C1_LEFT for the guard, whatever the allocator caches
        return C1_LEFT - (torch.cuda.memory_reserved() - torch.cuda.memory_allocated()), total

    for name, left in (("as_is", None), ("reported_free", C1_LEFT)):
        ws = {k: v.detach().clone().requires_grad_() for k, v in w.items()}
        patch = (mock.patch.object(torch.cuda, "mem_get_info", reported) if left
                 else contextlib.nullcontext())
        before = read_counts()
        with patch:
            free_rule = et.encoder_blocks(b, t, widths, torch.bfloat16, True,
                                          et._device_hbm_limit(x.device))
            pooled, tok = et.encoder_train(x, mask, ws, 1234, save_acts=False)
            loss = (pooled.float() * gp).sum() + (tok * gt).float().sum()
            grads[name] = dict(zip(ws, torch.autograd.grad(loss, list(ws.values()))))
        after = read_counts()
        n = {k: after[k] - before[k] for k in BLOCK_COUNTERS}
        out[name] = {"memory_left_reported": left, "free_memory_rule_blocks": len(free_rule),
                     "blocks_fwd": n["encoder_train_fwd_blocks"] or 1,
                     "blocks_bwd": n["encoder_train_bwd_blocks"] or 1}
        del pooled, tok, loss, ws
    unequal = [k for k in grads["as_is"] if not torch.equal(grads["as_is"][k],
                                                            grads["reported_free"][k])]
    rep = {"shape": list(C1_SHAPE), "total_memory": total, **out,
           "grads_bitwise_equal": not unequal, "unequal": unequal}
    if (unequal or out["as_is"]["blocks_fwd"] != out["reported_free"]["blocks_fwd"]
            or out["as_is"]["blocks_bwd"] != out["reported_free"]["blocks_bwd"]
            or out["reported_free"]["free_memory_rule_blocks"]
            == out["reported_free"]["blocks_fwd"]):
        raise AssertionError(f"C1: the blocks or the weight gradients moved with the free "
                             f"memory reported, or a free-memory rule would not have moved: "
                             f"{rep}")
    return rep


def _check_grown(torch, w, t, lengths, rates, gen, peak_flops):
    """One call at [65, t] past what one block holds ([65, 32768] bf16,
    [65, 16384] f32) in the blocks `encoder_blocks` gives it on the
    recompute route, with the card's memory left: K6's outputs for the last
    bag (the longest, at the highest rows) against the plain version on that
    bag alone at its global row; K7 with cotangents on the last bag only
    (every other term exactly 0) against the plain backward of that bag
    alone (bf16: pooled POOLED_ATOL, tokens and valid logits OUT_ATOL,
    gradients GRAD_RTOL; f32: outputs rtol F32_RTOL / atol F32_ATOL,
    gradients F32_GRAD_RTOL; bc BC_ATOL). K6's and K7's ms in blocks, the
    backward's own peak (GB above its inputs) and the bounds of the call."""
    from madeleine_torch.ops import encoder_train as et

    b = len(lengths)
    dt = w["w1"].dtype
    f32 = dt == torch.float32
    x, bias, tg = _long_inputs(torch, w, t, lengths, SEED + 32, dt)
    torch.cuda.synchronize()
    blocks = et.encoder_blocks(b, t, WIDTHS, dt, True, et._device_hbm_limit())
    if len(blocks) < 2:
        raise AssertionError(f"encoder_blocks [{b}, {t}] {dt}: one block {blocks}")
    fa = (x, bias, w, 1234, 0, *rates, None, False, blocks)
    got = et.encoder_train_fwd_blocks(*fa)
    last = b - 1
    with torch.no_grad():
        want = et.encoder_train_fwd_plain(x[last:], bias[last:], w, 1234, last, *rates,
                                          save=False)
    valid = bias[last:] == 0
    pairs = {"pooled": (got[0][last:], want[0]), "tok": (got[3][last:].float(), want[3].float()),
             "logits": (got[4][last:][valid], want[4][valid])}
    rep = {f"{k}_err_last_bag": (p - q).abs().max().item() for k, (p, q) in pairs.items()}
    if f32:
        bad = {k: v for k, v in ((k, _f32_excess(torch, p, q)) for k, (p, q) in pairs.items())
               if not v <= 0}
    else:
        bad = {k: rep[f"{k}_err_last_bag"] for k, bar in (("pooled", POOLED_ATOL),
                                                          ("tok", OUT_ATOL),
                                                          ("logits", OUT_ATOL))
               if not rep[f"{k}_err_last_bag"] <= bar}
    if bad:
        raise AssertionError(f"encoder_train_fwd blocked [{b}, {t}] {dt}: last bag {bad}")
    del want
    pooled32, m, s, _, l, _ = got
    nh, _, e = w["wa"].shape
    g = torch.zeros_like(pooled32)
    g[last] = torch.from_numpy(gen.standard_normal(nh * e).astype(np.float32)).cuda()
    dtok = torch.zeros(b, t, w["wt"].shape[0], dtype=dt, device="cuda")
    dtok[last] = torch.randn(t, w["wt"].shape[0], generator=tg, device="cuda", dtype=dt)
    inner = (g * pooled32).reshape(b, nh, e).sum(-1)
    ba = (x, l, m, s, g, inner, dtok, None, w, 1234, 0, *rates, False, None, blocks)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gk = et.encoder_train_bwd_blocks(*ba)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    with torch.no_grad():
        gp = et.encoder_train_bwd_plain(x[last:], l[last:], m[last:], s[last:], g[last:],
                                        inner[last:], dtok[last:], None, w, 1234, last, *rates)
    errs = _grad_errs(torch, gk, gp, et.W_KEYS, f"encoder_train_bwd blocked [{b}, {t}] {dt}",
                      F32_GRAD_RTOL if f32 else GRAD_RTOL)
    del gk, gp
    k6 = cuda_ms(lambda: et.encoder_train_fwd_blocks(*fa), warmup=1, iters=3)
    k7 = cuda_ms(lambda: et.encoder_train_bwd_blocks(*ba), warmup=1, iters=3)
    ff, fb, bf, bb_ = _encoder_train_work(b, t, w, recompute=True)
    (k6b, k6by), (k7b, k7by) = _bound(ff, fb, peak_flops), _bound(bf, bb_, peak_flops)
    # f32 operands: also the split-TF32 route's bound, three TF32 terms a product
    tf32 = {} if not f32 else dict(k6_bound_ms_tf32=_bound(3 * ff, fb, PEAK_TF32)[0],
                                   k7_bound_ms_tf32=_bound(3 * bf, bb_, PEAK_TF32)[0])
    return dict(rep, b=b, t=t, dtype="float32" if f32 else "bfloat16", rows=b * t,
                valid_tokens=int(sum(lengths)), blocks=blocks, n_blocks=len(blocks),
                grad_max_rel_fro_last_bag=max(v for k, v in errs.items() if k != "bc"),
                bc_abs_last_bag=errs["bc"], k6_ms=k6, k7_ms=k7, k7_own_peak_gb=peak,
                k6_bound_ms=k6b, k6_bound_by=k6by, k7_bound_ms=k7b, k7_bound_by=k7by, **tf32)


GUARD_SHAPE = (8, 2048)        # the HBM guard's call: saves of 235 MB
GUARD_BELOW = 256 * 1024 ** 2  # the ballast leaves the guard this far under its threshold
GUARD_SLACK = 64 * 1024 ** 2   # a limit's drift from the ballast arithmetic (block rounding)


def _check_hbm_guard(torch, w, gen):
    """The save_acts gate's HBM guard on the card, `_device_hbm_limit` as the
    path calls it: ballast allocated so that the free plus reserved but
    unallocated bytes fall GUARD_BELOW under a call's saves + 4 x_bytes +
    2 GiB sends `resolve_save_acts(None, ...)` and an `encoder_train` call
    (forward and backward through autograd, ragged mask) to the recompute
    route (K6's save-off and K7's recompute counters); the ballast freed
    but still reserved by the caching allocator (no empty_cache, so the
    card's free bytes stay low) is counted again, and the same call takes
    the save route, its gradients bit for bit the recompute call's. Each
    limit is held to free + reserved - allocated and to the one before
    less, then plus, the ballast (GUARD_SLACK)."""
    from madeleine_torch.ops import encoder_train as et

    if os.environ.get(et.NO_SAVE_VAR):
        raise AssertionError(f"hbm guard: {et.NO_SAVE_VAR} is set, the gate would not ask it")
    b, t = GUARD_SHAPE
    nh, f, e = w["wa"].shape
    h, d_in = w["w1"].shape
    x = torch.from_numpy(gen.standard_normal((b, t, d_in)).astype(np.float32)).cuda()
    x = x.to(torch.bfloat16).contiguous()
    lengths = torch.as_tensor(np.exp(gen.uniform(0.0, np.log(t), b)).astype(np.int64))
    mask = (torch.arange(t)[None, :] < lengths[:, None]).cuda()
    x_bytes = x.numel() * x.element_size()
    gate = (b, t, h, nh * e, 2 * nh * f, x.element_size(), x_bytes, x.device)
    need = b * t * ((2 * h + nh * e + 2 * nh * f) * 2 + 12) + 4 * x_bytes + et.GUARD_MARGIN

    def read(where):
        torch.cuda.synchronize()
        free, _ = torch.cuda.mem_get_info()
        lim = et._device_hbm_limit(x.device)
        want = free + torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
        if abs(lim - want) > GUARD_SLACK:
            raise AssertionError(f"hbm guard ({where}): limit {lim} != free + reserved - "
                                 f"allocated {want}")
        return free, lim

    def call():
        wg = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
        before = (et.fwd_launches, et.bwd_launches, et.fwd_nosave_launches,
                  et.bwd_recompute_launches)
        p, tok = et.encoder_train(x, mask, wg, 1234, row_offset=3)
        (p.float().square().sum() + tok.float().sum()).backward()
        after = (et.fwd_launches, et.bwd_launches, et.fwd_nosave_launches,
                 et.bwd_recompute_launches)
        grads = {k: v.grad for k, v in wg.items()}
        del wg, p, tok
        return [a - c for a, c in zip(after, before)], grads

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0, lim0 = read("before")
    ballast_bytes = (lim0 - need + GUARD_BELOW) // (2 << 20) * (2 << 20)
    ballast = torch.empty(ballast_bytes, dtype=torch.uint8, device="cuda")
    free1, lim1 = read("ballast held")
    if abs(lim0 - ballast_bytes - lim1) > GUARD_SLACK or not lim1 < need:
        raise AssertionError(f"hbm guard: with {ballast_bytes} B of ballast the limit is {lim1}, "
                             f"from {lim0}; the threshold is {need}")
    if et.resolve_save_acts(None, *gate):
        raise AssertionError(f"hbm guard: limit {lim1} under the threshold {need}, and the gate "
                             f"still answers save")
    rec_counts, rec_grads = call()
    if rec_counts != [1, 1, 1, 1]:
        raise AssertionError(f"hbm guard: under ballast the call's launches (K6, K7, K6 save-off, "
                             f"K7 recompute) are {rec_counts}, not [1, 1, 1, 1]")
    del ballast, rec_counts
    free2, lim2 = read("ballast freed, still reserved")
    if abs(lim2 - lim0) > GUARD_SLACK + sum(g.numel() * g.element_size()
                                             for g in rec_grads.values()):
        raise AssertionError(f"hbm guard: with the ballast freed the limit is {lim2}, not {lim0}")
    if not free2 < need:
        raise AssertionError(f"hbm guard: the card's free bytes {free2} reach the threshold "
                             f"{need}; the check would not show the reserved bytes counted")
    if not et.resolve_save_acts(None, *gate):
        raise AssertionError(f"hbm guard: limit {lim2} over the threshold {need}, and the gate "
                             f"answers recompute")
    save_counts, save_grads = call()
    if save_counts != [1, 1, 0, 0]:
        raise AssertionError(f"hbm guard: with the ballast freed the call's launches are "
                             f"{save_counts}, not [1, 1, 0, 0]")
    unequal = [k for k in save_grads if not torch.equal(save_grads[k], rec_grads[k])]
    if unequal:
        raise AssertionError(f"hbm guard: the two routes' gradients differ in {unequal}")
    del rec_grads, save_grads
    torch.cuda.empty_cache()
    return {"shape": [b, t], "threshold_bytes": need, "limit_before": lim0,
            "ballast_bytes": ballast_bytes, "limit_ballast_held": lim1,
            "free_ballast_held": free1, "route_ballast_held": "recompute",
            "limit_ballast_freed": lim2, "free_ballast_freed": free2,
            "route_ballast_freed": "save", "grads_bitwise_equal": True}


def _product_rates(torch, w, gen, b=65, t=2048):
    """Device ms (back to back) and TFLOP/s of each product K6 and K7 run at
    their call shape [b, t], through the GEMM's own entry point
    (ops/gemm.py) on random operands of the same shapes and layouts: K6's
    three layers (f32 + bias), batched gates (the logit epilogue, real gate
    rate) and token projector (bf16); K7's input gradients (MN-major
    weights, f32 accumulate, dx bf16 when d_in > 512) and weight gradients
    (both MN-major, split over the tokens); kernel 20's dy, the token
    projector's input gradient with a bf16 output (its weight gradient is
    K7's)."""
    from madeleine_torch.ops import encoder_train as et
    from madeleine_torch.ops import gemm as G

    hd, d_in = w["w1"].shape
    nh, f, e = w["wa"].shape
    dout, E = w["wt"].shape
    M = b * t
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(*shape):
        return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).cuda().to(bf)

    x, h, y = rnd(M, d_in), rnd(M, hd), rnd(M, E)
    dz3, dzg, dtok = rnd(M, E), rnd(M, 2 * nh * f), rnd(M, dout)
    wab, bab = et.permute_gates(w)
    wab = wab.reshape(2 * nh * f, e)
    wab_bwd = torch.cat([w["wa"], w["wb"]], dim=1).reshape(2 * nh * f, e).contiguous()
    zf = torch.empty(M, max(hd, E), dtype=f32, device="cuda")
    zb = torch.empty(M, dout, dtype=bf, device="cuda")
    dy = torch.zeros(M, E, dtype=f32, device="cuda")
    dxo = torch.empty(M, d_in, dtype=bf, device="cuda")
    dyb = torch.empty(M, E, dtype=bf, device="cuda")
    gates = {"ap": torch.empty(M, nh * f, dtype=bf, device="cuda"),
             "bp": torch.empty(M, nh * f, dtype=bf, device="cuda"),
             "lpart": torch.empty(M, nh, f // 64, dtype=f32, device="cuda"), "wc": w["wc"],
             "t": t, "row_offset": 0, "seed": 1, "rate": et.GATE_RATE}
    kk = dict(a_mn=False, b_mn=False)
    kmn = dict(a_mn=False, b_mn=True)
    mnmn = dict(a_mn=True, b_mn=True)
    calls = {
        "fwd_layer1": ((x, w["w1"], zf), dict(kk, M=M, N=hd, K=d_in, bias=w["b1"]), 1),
        "fwd_layer2": ((h, w["w2"], zf), dict(kk, M=M, N=hd, K=hd, bias=w["b2"]), 1),
        "fwd_layer3": ((h, w["w3"], zf), dict(kk, M=M, N=E, K=hd, bias=w["b3"]), 1),
        "fwd_gates": ((y, wab, gates["lpart"]),
                      dict(kk, M=M, N=2 * f, K=e, batches=nh, a_off=(0, e), b_off=(2 * f, 0),
                           bias=bab, stride_bias=2 * f, gates=gates), nh),
        "fwd_tok": ((y, w["wt"], zb), dict(kk, M=M, N=dout, K=E, bias=w["bt"]), 1),
        "bwd_dgrad_tok": ((dtok, w["wt"], dy), dict(kmn, M=M, N=E, K=dout, beta=True), 1),
        "bwd_dgrad_tok_bf16": ((dtok, w["wt"], dyb), dict(kmn, M=M, N=E, K=dout), 1),
        "bwd_dgrad_gates": ((dzg, wab_bwd, dy),
                            dict(kmn, M=M, N=e, K=2 * f, batches=nh, a_off=(0, 2 * f),
                                 b_off=(0, 2 * f), ldc=E, stride_c=e, beta=True), nh),
        "bwd_dgrad_layer3": ((dz3, w["w3"], zf), dict(kmn, M=M, N=hd, K=E), 1),
        "bwd_dgrad_layer2": ((h, w["w2"], zf), dict(kmn, M=M, N=hd, K=hd), 1),
        "bwd_wgrad_tok": ((dtok, y, torch.empty(1, dout, E, device="cuda")),
                          dict(mnmn, M=dout, N=E, K=M, wgrad=True), 1),
        "bwd_wgrad_gates": ((dzg, y, torch.empty(nh, 2 * f, e, device="cuda")),
                            dict(mnmn, M=2 * f, N=e, K=M, batches=nh, a_off=(2 * f, 0),
                                 b_off=(e, 0), wgrad=True), nh),
        "bwd_wgrad_layer3": ((dz3, h, torch.empty(1, E, hd, device="cuda")),
                             dict(mnmn, M=E, N=hd, K=M, wgrad=True), 1),
        "bwd_wgrad_layer2": ((h, h, torch.empty(1, hd, hd, device="cuda")),
                             dict(mnmn, M=hd, N=hd, K=M, wgrad=True), 1),
        "bwd_wgrad_layer1": ((h, x, torch.empty(1, hd, d_in, device="cuda")),
                             dict(mnmn, M=hd, N=d_in, K=M, wgrad=True), 1),
    }
    if d_in > hd:   # the stain-encoded call's dx
        calls["bwd_dgrad_dx"] = ((h, w["w1"], dxo), dict(kmn, M=M, N=d_in, K=hd), 1)
    out = {}
    for name, (args, kw, nb) in calls.items():
        ms = cuda_ms_back_to_back(lambda: G.wgmma_gemm(*args, **kw), calls=20)
        flops = 2.0 * kw["M"] * kw["N"] * kw["K"] * nb
        out[name] = {"ms": ms, "tflops": flops / ms / 1e9, "gflop": flops / 1e9,
                     "mnk_batches": [kw["M"], kw["N"], kw["K"], nb]}
    return out


def phase_train_kernels(state):
    import torch
    from madeleine_torch.models.madeleine import MADELEINE, train_weights
    from madeleine_torch.config import MadeleineConfig
    from madeleine_torch.ops import encoder_train as et

    gen = np.random.default_rng(SEED + 3)
    cfg = MadeleineConfig.from_dict(flagship_config("bfloat16"))
    model = MADELEINE(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flagship_state_dict().items()})
    model = model.cuda()
    with torch.no_grad():
        w = {k: v.detach().contiguous() for k, v in train_weights(model, torch.bfloat16).items()}
    weights = {"flagship": w, "peaked": dict(w, wc=(w["wc"] * PEAK_WC_SCALE).contiguous())}
    real = (et.PRE_RATE, et.GATE_RATE)

    def inputs(mask):
        b, t = mask.shape
        x = torch.from_numpy(gen.standard_normal((b, t, 512)).astype(np.float32)).cuda()
        return x.to(torch.bfloat16).contiguous(), et.token_mask_bias(mask.cuda(), b, t, "cuda")

    def prefix_mask(t, lengths):
        return torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]

    b, t = 8, 4096
    lengths = [4096, 4000, 3001, 2048, 1500, 777, 65, 0]
    x, bias = inputs(prefix_mask(t, lengths))
    checks, timed = {}, {}
    for wname, ws in weights.items():
        for rates in ((0.0, 0.0), real):
            rep, fwd, fa, ba = _check_train_kernels(torch, ws, x, bias, rates, gen)
            checks[f"{wname}_{rates[0]}_{rates[1]}"] = rep
            if wname == "flagship" and rates == real:
                timed["smoke"] = (fa, ba)
        # control: a uniform pool (wc = 0) must miss the pooled bar
        with torch.no_grad():
            uni = et.encoder_train_fwd_plain(x, bias, dict(ws, wc=torch.zeros_like(ws["wc"])),
                                             1234, 0, *rates)[0]
        checks[f"{wname}_uniform_pool_vs_plain"] = (uni - fwd[0]).abs().max().item()
        if not checks[f"{wname}_uniform_pool_vs_plain"] > POOLED_ATOL:
            raise AssertionError(f"train_kernels ({wname}): control failed, a uniform pool is "
                                 f"within {POOLED_ATOL} of the kernel's output")
    # partial last tile: t = 4057 = 63 tiles of 64 + 25 rows. Bag 0 is valid on
    # its last 57 tokens only (the end of tile 62 and all of tile 63), bag 1 on
    # every token, so a pool that dropped the partial tile, or read past t into
    # bag 1, would move bag 0's pooled output by far more than the bar
    t2, tail_from = 4057, 4000
    mask2 = torch.ones(2, t2, dtype=torch.bool)
    mask2[0, :tail_from] = False
    x2, bias2 = inputs(mask2)
    mask_cut = mask2.clone()
    mask_cut[:, (t2 // TILE) * TILE:] = False
    bias_cut = et.token_mask_bias(mask_cut.cuda(), 2, t2, "cuda")
    for wname, ws in weights.items():
        for rates in ((0.0, 0.0), real):
            checks[f"partial_t_{wname}_{rates[0]}_{rates[1]}"], fwd, _, _ = \
                _check_train_kernels(torch, ws, x2, bias2, rates, gen)
        # control: the plain pool without the partial tile must miss the pooled bar
        with torch.no_grad():
            cut = et.encoder_train_fwd_plain(x2, bias_cut, ws, 1234, 0, *rates)[0]
        checks[f"partial_t_{wname}_tail_dropped_vs_plain"] = (cut - fwd[0]).abs().max().item()
        if not checks[f"partial_t_{wname}_tail_dropped_vs_plain"] > POOLED_ATOL:
            raise AssertionError(f"train_kernels ({wname}): control failed, dropping the "
                                 f"partial tile stays within {POOLED_ATOL}")
    # n_views = 3 (the intra-modality loss): three pools over one half-bag
    # split (the step's own draw), at the ragged b=8 t=4096 bags (one of
    # them empty) and at the odd t = 4057, rates 0 and the real ones
    from madeleine_torch.models.madeleine import half_split

    for name, (xv, bv) in (("ragged", (x, bias)), ("odd_t", (x2, bias2))):
        tv = xv.shape[1]
        vb = et.view_bias(half_split(SEED, tv, "cuda"), tv, "cuda")
        for rates in ((0.0, 0.0), real):
            checks[f"views_{name}_{rates[0]}_{rates[1]}"] = _check_train_kernels(
                torch, w, xv, bv, rates, gen, vb=vb)[0]
    del x2, bias2, bias_cut, fwd

    # the train step's call shape [65, 2048], every token valid, real rates:
    # checked as above, then timed with the smoke shape
    xs, bs_ = inputs(torch.ones(65, 2048, dtype=torch.bool))
    checks[f"step_call_{real[0]}_{real[1]}"], _, fa, ba = _check_train_kernels(
        torch, w, xs, bs_, real, gen)
    timed["step_call"] = (fa, ba)
    # ... and with the three views of one half-bag split
    vb_step = et.view_bias(half_split(SEED, 2048, "cuda"), 2048, "cuda")
    for rates in ((0.0, 0.0), real):
        checks[f"step_call_views_{rates[0]}_{rates[1]}"], _, fa, ba = _check_train_kernels(
            torch, w, xs, bs_, rates, gen, vb=vb_step)
    timed["step_call_views"] = (fa, ba)
    del xs, bs_, fa, ba

    # the stain-encoded step's call: d_in 544 (the last 32 columns the stain
    # code), K7 with dx. The table's gradient is dx's stain columns summed
    # over the call's rows; autograd sums them in bf16, held here to the f32 sum
    model_se = flagship_model(torch, "bfloat16", stain_encoding=True)
    with torch.no_grad():
        w_se = {k: v.detach().contiguous()
                for k, v in train_weights(model_se, torch.bfloat16).items()}
        code = model_se.embedding.weight[1].to(torch.bfloat16)
    xs, bs_ = inputs(torch.ones(65, 2048, dtype=torch.bool))
    xs = torch.cat([xs, code.expand(65, 2048, -1)], dim=-1).contiguous()
    checks[f"step_call_se_{real[0]}_{real[1]}"], _, fa, ba, gk = _check_train_kernels(
        torch, w_se, xs, bs_, real, gen, need_dx=True)
    d = cfg.patch_embedding_dim
    with torch.no_grad():
        tab_bf16 = gk["x"][..., d:].sum((0, 1)).float()
        tab_f32 = gk["x"][..., d:].float().sum((0, 1))
    checks["table_grad_bf16_sum_vs_f32_rel"] = _rel_fro(tab_bf16, tab_f32)
    if not checks["table_grad_bf16_sum_vs_f32_rel"] <= GRAD_RTOL:
        raise AssertionError(f"train_kernels: the bf16 sum of dx's stain columns misses the "
                             f"f32 sum: {checks['table_grad_bf16_sum_vs_f32_rel']}")
    timed["step_call_se"] = (fa, ba)
    del xs, bs_, fa, ba, gk

    # the recompute route (B1c): at the step's call shape [65, 2048] with a
    # ragged mask (log-uniform lengths, two bags empty), bit for bit against
    # the save route, with dx at d_in 544; then at [65, 16384]
    lengths_r = np.exp(gen.uniform(0.0, np.log(2048), 65)).astype(np.int64)
    lengths_r[:2] = 0
    xr, br_ = inputs(prefix_mask(2048, lengths_r))
    recompute = {"step_call_ragged": _check_recompute(torch, w, xr, br_, real, gen)}
    xr = torch.cat([xr, code.expand(65, 2048, -1)], dim=-1).contiguous()
    recompute["step_call_ragged_se"] = _check_recompute(torch, w_se, xr, br_, real, gen,
                                                        need_dx=True)
    del xr, br_

    times = {}
    for shape_name, (fa, ba) in timed.items():
        bb, tt, d_in = fa[0].shape
        dx = shape_name == "step_call_se"
        vb = vb_step if shape_name == "step_call_views" else None
        nv = 1 if vb is None else 3
        k6 = cuda_ms(lambda: et.encoder_train_fwd_cuda(*fa, vb=vb))
        k7 = cuda_ms(lambda: et.encoder_train_bwd_cuda(*ba, need_dx=dx, vb=vb))
        k6_b2b = cuda_ms_back_to_back(lambda: et.encoder_train_fwd_cuda(*fa, vb=vb), calls=20)
        k7_b2b = cuda_ms_back_to_back(lambda: et.encoder_train_bwd_cuda(*ba, need_dx=dx, vb=vb),
                                      calls=20)
        with torch.no_grad():   # the plain versions (about 0.5 s a call): two timed calls
            k6p = cuda_ms(lambda: et.encoder_train_fwd_plain(*fa, vb=vb), warmup=1, iters=2)
            k7p = cuda_ms(lambda: et.encoder_train_bwd_plain(*ba, need_dx=dx, vb=vb), warmup=1,
                          iters=2)
        ff, fb, bf, bb_ = _encoder_train_work(bb, tt, fa[2], need_dx=dx, n_views=nv)
        (k6b, k6by), (k7b, k7by) = _bound(ff, fb), _bound(bf, bb_)
        times[shape_name] = {"b": bb, "t": tt, "d_in": d_in, "need_dx": dx, "n_views": nv,
                             "fwd_ms": k6, "fwd_ms_back_to_back": k6_b2b,
                             "bwd_ms_back_to_back": k7_b2b, "fwd_plain_ms": k6p,
                             "fwd_bound_ms": k6b, "fwd_bound_by": k6by,
                             "fwd_share_of_bound": k6b / k6, "bwd_ms": k7,
                             "bwd_plain_ms": k7p, "bwd_bound_ms": k7b, "bwd_bound_by": k7by,
                             "bwd_share_of_bound": k7b / k7, "fwd_gflop": ff / 1e9,
                             "bwd_gflop": bf / 1e9, "fwd_gb": fb / 1e9, "bwd_gb": bb_ / 1e9}
    del timed, fa, ba, vb_step
    products = {name: _product_rates(torch, w_, gen)
                for name, w_ in (("step_call", w), ("step_call_se", w_se))}
    torch.cuda.empty_cache()
    lengths_l = np.exp(gen.uniform(np.log(1024), np.log(16384), 65)).astype(np.int64)
    lengths_l[-1] = 16384 - 5            # the last bag, past 2**31 elements of K6's scratch
    recompute["bucket_16384"] = _check_recompute_long(torch, w, lengths_l.tolist(), real, gen)
    torch.cuda.empty_cache()
    # blocks of whole bags (A10): forced blocks against the unblocked call at
    # [65, 16384], then [65, 32768] in the rule's blocks, its last bag alone
    blocked = {"bucket_16384": _check_blocked(torch, w, 16384, lengths_l.tolist(), real, gen)}
    torch.cuda.empty_cache()
    lengths_g = np.exp(gen.uniform(np.log(1024), np.log(32768), 65)).astype(np.int64)
    lengths_g[-1] = 32768 - 5            # the last bag, the longest, at the highest rows
    blocked["bucket_32768"] = _check_grown(torch, w, 32768, lengths_g.tolist(), real, gen,
                                           PEAK_BF16)
    torch.cuda.empty_cache()
    blocked["c1_free_memory"] = _check_c1(torch, w, gen)
    emit({"phase": "train_kernels", "blocked": blocked})
    torch.cuda.empty_cache()
    hbm_guard = _check_hbm_guard(torch, w, gen)
    for name in products:
        times[name]["products"] = products[name]
        times[name]["products_fwd_ms"] = sum(v["ms"] for k, v in products[name].items()
                                             if k.startswith("fwd"))
        times[name]["products_bwd_ms"] = sum(v["ms"] for k, v in products[name].items()
                                             if k.startswith("bwd"))
    st = times["step_call"]
    times["step_call_views"]["fwd_ms_over_one_view"] = (times["step_call_views"]["fwd_ms"]
                                                        / st["fwd_ms"])
    times["step_call_views"]["bwd_ms_over_one_view"] = (times["step_call_views"]["bwd_ms"]
                                                        / st["bwd_ms"])
    reps = [r for r in checks.values() if isinstance(r, dict)]
    reps += [r for k, r in recompute.items() if k != "bucket_16384"]
    err_f = max(max(r["pooled_err"], r["tok_err"], r["logits_err"]) for r in reps)
    err_b = max(r["grad_max_abs_err"] for r in reps)
    rc, long_ = recompute["step_call_ragged"], recompute["bucket_16384"]
    ff, fb, bf, bb_ = _encoder_train_work(65, 2048, w, recompute=True)
    (k6nb, k6nby), (k7rb, k7rby) = _bound(ff, fb), _bound(bf, bb_)
    state.setdefault("kernels", {}).update({
        "encoder_train_fwd": {
            "name": "encoder_train_fwd", "route": "cuda",
            "source": "madeleine_torch/csrc/encoder_train_fwd.cu",
            "replaces": "madeleine_tpu/ops/encoder_train.py:168",
            "max_abs_err": err_f, "ms": st["fwd_ms"], "plain_ms": st["fwd_plain_ms"],
            "bound_ms": st["fwd_bound_ms"], "bound_by": st["fwd_bound_by"],
            "library_ms": None,
            # the save-off route (the recompute route's forward) at [65, 2048] ragged
            "nosave_ms": rc["k6_nosave_ms"], "nosave_bound_ms": k6nb, "nosave_bound_by": k6nby,
            "nosave_ms_16384": long_["k6_nosave_ms"],
            "nosave_bound_ms_16384": long_["k6_nosave_bound_ms"]},
        "encoder_train_bwd": {
            "name": "encoder_train_bwd", "route": "cuda",
            "source": "madeleine_torch/csrc/encoder_train_bwd.cu",
            "replaces": "madeleine_tpu/ops/encoder_train.py:262",
            "max_abs_err": err_b, "ms": st["bwd_ms"], "plain_ms": st["bwd_plain_ms"],
            "bound_ms": st["bwd_bound_ms"], "bound_by": st["bwd_bound_by"],
            "library_ms": None,
            # the recompute route (B1c) at [65, 2048] ragged and at [65, 16384]
            "recompute_ms": rc["k7_recompute_ms"], "recompute_save_route_ms": rc["k7_save_ms"],
            "recompute_bound_ms": k7rb, "recompute_bound_by": k7rby,
            "recompute_ms_16384": long_["k7_recompute_ms"],
            "recompute_bound_ms_16384": long_["k7_recompute_bound_ms"],
            "recompute_own_peak_gb_16384": long_["k7_recompute_own_peak_gb"]},
    })
    grown = blocked["bucket_32768"]
    for kernel, k in (("encoder_train_fwd", "k6"), ("encoder_train_bwd", "k7")):
        # the recompute route in the rule's blocks at [65, 32768]
        state["kernels"][kernel].update({"blocked_ms_32768": grown[f"{k}_ms"],
                                         "blocked_bound_ms_32768": grown[f"{k}_bound_ms"],
                                         "blocks_32768": grown["n_blocks"]})
    state["kernels"]["encoder_train_bwd"]["blocked_own_peak_gb_32768"] = grown["k7_own_peak_gb"]
    emit({"phase": "train_kernels", "b": b, "t": t, "lengths": lengths, "partial_tile_t": t2,
          "partial_tile_bag0_valid_from": tail_from, "pooled_atol": POOLED_ATOL,
          "atol_tok_logits": OUT_ATOL, "grad_rtol_fro": GRAD_RTOL, "bc_atol": BC_ATOL,
          "blocked_grad_rtol_fro": F32_GRAD_RTOL,
          "checks": checks, "times": times, "recompute": recompute, "blocked": blocked,
          "hbm_guard": hbm_guard,
          "recompute_bound_ms_step_call": k7rb, "nosave_bound_ms_step_call": k6nb})


F32_STEP_SHAPE = (65, 2048)   # the f32 step's call shape: one modality of 65 cases


def _wgrad_chunks(et, M, dims):
    """The f32 weight-gradient piece lengths for each product at M tokens, the
    library's against the Python mirror's, which the CPU tests' mirrors use:
    K6 / K7's (csrc/gemm_tf32.cuh::wgrad_chunk, ops/encoder_train.py::
    tf32_wgrad_chunk) and the per-op kernels 15-18's (csrc/gemm_ffma.cuh::
    wgrad_chunk, ffma_wgrad_chunk)."""
    import ctypes

    from madeleine_torch.ops import _build

    lib = _build.load("encoder_train_fwd")
    d_in, hd, E, nh, f, e, dout = dims
    out = {}
    for route, fn, mirror in (("tf32", lib.encoder_train_tf32_wgrad_chunk, et.tf32_wgrad_chunk),
                              ("ffma", lib.encoder_train_ffma_wgrad_chunk, et.ffma_wgrad_chunk)):
        fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
        for name, (mo, no, nb) in {"w1": (hd, d_in, 1), "w2": (hd, hd, 1), "w3": (E, hd, 1),
                                   "wab": (2 * f, e, nh), "wt": (dout, E, 1)}.items():
            lib_c, py_c = fn(mo, no, M, nb), mirror(mo, no, M, nb)
            if lib_c != py_c:
                raise AssertionError(f"train_kernels_f32: {route} piece length of d{name} at "
                                     f"M={M}: library {lib_c}, Python {py_c}")
            out.setdefault(route, {})[name] = {"chunk": lib_c, "pieces": -(-M // lib_c)}
    return out


# What one K6 and one K7 call with f32 operands must launch, and must not:
# the split-TF32 GEMM (csrc/gemm_tf32.cuh), no FFMA tile (csrc/gemm_ffma.cuh)
TF32_ENGINE, FFMA_ENGINE = "tf32_gemm_kernel", "ff::tile_kernel"


def _f32_engine(torch, fa, ba):
    """Device ms by kernel of one K6 and one K7 call with f32 operands (the
    save route; a profiled window of `_profiled`, another while one shows
    no split-TF32 product, up to three): fails if any FFMA tile of
    gemm_ffma.cuh runs, or no split-TF32 product shows."""
    from madeleine_torch.ops import encoder_train as et

    for window in range(3):
        rows = _profiled(torch, lambda: (et.encoder_train_fwd_cuda(*fa),
                                         et.encoder_train_bwd_cuda(*ba)))
        if any(FFMA_ENGINE in k for k, _, _ in rows):
            raise AssertionError(f"train_kernels_f32: K6/K7 f32 ran an FFMA tile: {rows[:12]}")
        tf32 = [r for r in rows if TF32_ENGINE in r[0]]
        if tf32:
            total = sum(ms for _, _, ms in rows)
            return {"windows": window + 1, "device_ms": total,
                    "tf32_gemm_ms": sum(ms for _, _, ms in tf32),
                    "tf32_gemm_launches": sum(c for _, c, _ in tf32),
                    "split_weights_ms": sum(ms for k, _, ms in rows if "split_weights" in k),
                    "top": [[k, c, ms] for k, c, ms in rows[:12]]}
    raise AssertionError(f"train_kernels_f32: no split-TF32 product in 3 windows: {rows[:12]}")


def phase_train_kernels_f32(state):
    """K6 and K7 with f32 operands (the JAX package's parity route,
    --precision float32) against their plain versions at the step's call
    shape [65, 2048] with the flagship weights in f32 at the real rates:
    every token valid; a ragged mask (log-uniform lengths, two bags empty);
    the stain-encoded call [65, 2048, 544] with dx (need_dx); and n_views =
    3 (one half-bag split). Each on the save route (K6's outputs within
    rtol 1e-4 / atol 1e-5, every K7 gradient and dx within 1e-4 relative
    Frobenius, bc within BC_ATOL, two launches bitwise equal) and the
    recompute route (K6 without saves and K7 rebuilding the residuals, bit
    for bit the save route, and against the plain recompute at the same
    bars). Timed at [65, 2048] (K6, K7 on both routes, each plain version),
    beside two bounds: the split-TF32 route's (three TF32 terms a product
    at 495 TFLOP/s, the route K6/K7 run: `bound_ms`) and the FP32 FMA
    peak's (67 TFLOP/s, the first design's: `bound_ms_ffma`), or the
    bytes; the engine from a profiled call pair (`_f32_engine`: split-TF32
    products, no FFMA tile); the weight gradients' piece lengths, the
    library's against the Python mirror's, at 133,120 and 532,480 rows
    (buckets 2048 and 8192)."""
    import torch
    from madeleine_torch.models.madeleine import half_split, train_weights
    from madeleine_torch.ops import encoder_train as et

    gen = np.random.default_rng(SEED + 13)
    real = (et.PRE_RATE, et.GATE_RATE)
    b, t = F32_STEP_SHAPE
    model = flagship_model(torch, "float32")
    with torch.no_grad():
        w = {k: v.detach().contiguous() for k, v in train_weights(model, torch.float32).items()}

    def inputs(lengths, d=512):
        x = torch.from_numpy(gen.standard_normal((b, t, d)).astype(np.float32)).cuda()
        mask = torch.arange(t)[None, :] < torch.as_tensor(lengths)[:, None]
        return x.contiguous(), et.token_mask_bias(mask.cuda(), b, t, "cuda")

    full = [t] * b
    lengths_r = np.exp(gen.uniform(0.0, np.log(t), b)).astype(np.int64)
    lengths_r[:2] = 0
    checks = {}
    x, bias = inputs(full)
    checks["step_call"] = _check_recompute(torch, w, x, bias, real, gen)
    # K6's save route and both plain versions, timed on the dense call
    rep, _, fa, ba = _check_train_kernels(torch, w, x, bias, real, gen)
    engine = _f32_engine(torch, fa, ba)
    k6 = cuda_ms(lambda: et.encoder_train_fwd_cuda(*fa))
    with torch.no_grad():
        k6p = cuda_ms(lambda: et.encoder_train_fwd_plain(*fa), warmup=1, iters=3)
        k7p = cuda_ms(lambda: et.encoder_train_bwd_plain(*ba), warmup=1, iters=3)
    del fa, ba
    vb = et.view_bias(half_split(SEED, t, "cuda"), t, "cuda")
    checks["step_call_views"] = _check_recompute(torch, w, x, bias, real, gen, vb=vb,
                                                 timed=False)
    del x, bias
    x, bias = inputs(lengths_r)
    checks["step_call_ragged"] = _check_recompute(torch, w, x, bias, real, gen, timed=False)
    del x
    model_se = flagship_model(torch, "float32", stain_encoding=True)
    with torch.no_grad():
        w_se = {k: v.detach().contiguous()
                for k, v in train_weights(model_se, torch.float32).items()}
        code = model_se.embedding.weight[1].float()
    x, _ = inputs(full)
    x = torch.cat([x, code.expand(b, t, -1)], dim=-1).contiguous()
    checks["step_call_ragged_se"] = _check_recompute(torch, w_se, x, bias, real, gen,
                                                     need_dx=True, timed=False)
    del x, bias
    torch.cuda.empty_cache()
    # blocks of whole bags (A10): forced blocks against the unblocked call at
    # [65, 8192], then [65, 16384] in the rule's blocks, its last bag alone
    blocked = {}
    for tb, name in ((8192, "bucket_8192"), (16384, "bucket_16384")):
        lengths_b = np.exp(gen.uniform(np.log(1024), np.log(tb), b)).astype(np.int64)
        lengths_b[-1] = tb - 5            # the last bag, the longest, at the highest rows
        blocked[name] = (_check_blocked(torch, w, tb, lengths_b.tolist(), real, gen)
                         if tb == 8192 else
                         _check_grown(torch, w, tb, lengths_b.tolist(), real, gen, PEAK_FP32))
        torch.cuda.empty_cache()
    emit({"phase": "train_kernels_f32", "blocked": blocked})
    grown = blocked["bucket_16384"]
    st = checks["step_call"]
    ff, fb, bf, bb_ = _encoder_train_work(b, t, w)
    (k6b, k6by), (k7b, k7by) = _bound(ff, fb, PEAK_FP32), _bound(bf, bb_, PEAK_FP32)
    ff_r, fb_r, bf_r, bb_r = _encoder_train_work(b, t, w, recompute=True)
    (k6nb, _), (k7rb, _) = _bound(ff_r, fb_r, PEAK_FP32), _bound(bf_r, bb_r, PEAK_FP32)
    # the split-TF32 route's bounds: three TF32 terms a product at 495 TFLOP/s
    (k6t, k6ty), (k7t, k7ty) = _bound(3 * ff, fb, PEAK_TF32), _bound(3 * bf, bb_, PEAK_TF32)
    k6nt, k7rt = _bound(3 * ff_r, fb_r, PEAK_TF32)[0], _bound(3 * bf_r, bb_r, PEAK_TF32)[0]
    nh, f, e = w["wa"].shape
    dims = (512, 512, nh * e, nh, f, e, w["wt"].shape[0])
    chunks = {M: _wgrad_chunks(et, M, dims) for M in (b * t, b * 8192)}
    k7, k7r, k6n = st["k7_save_ms"], st["k7_recompute_ms"], st["k6_nosave_ms"]
    times = {"fwd_ms": k6, "fwd_plain_ms": k6p, "fwd_bound_ms": k6t, "fwd_bound_by": k6ty,
             "fwd_share_of_bound": k6t / k6, "fwd_bound_ms_ffma": k6b,
             "fwd_share_of_ffma_bound": k6b / k6, "fwd_nosave_ms": k6n,
             "fwd_nosave_bound_ms": k6nt, "fwd_nosave_bound_ms_ffma": k6nb,
             "bwd_ms": k7, "bwd_plain_ms": k7p, "bwd_bound_ms": k7t, "bwd_bound_by": k7ty,
             "bwd_share_of_bound": k7t / k7, "bwd_bound_ms_ffma": k7b,
             "bwd_share_of_ffma_bound": k7b / k7,
             "bwd_recompute_ms": k7r, "bwd_recompute_bound_ms": k7rt,
             "bwd_recompute_share_of_bound": k7rt / k7r,
             "bwd_recompute_bound_ms_ffma": k7rb,
             "bwd_recompute_share_of_ffma_bound": k7rb / k7r,
             "fwd_tflops": ff / k6 / 1e9, "bwd_tflops": bf / k7 / 1e9,
             "bwd_recompute_tflops": bf_r / k7r / 1e9,
             "fwd_tf32_term_tflops": 3 * ff / k6 / 1e9, "bwd_tf32_term_tflops": 3 * bf / k7 / 1e9,
             "fwd_gflop": ff / 1e9, "bwd_gflop": bf / 1e9}
    reps = list(checks.values())
    err_f = max(max(r["pooled_err"], r["tok_err"], r["logits_err"]) for r in reps)
    err_b = max(r["grad_max_abs_err"] for r in reps)
    common = {"route": "cuda", "library_ms": None, "operand_dtype": "float32",
              "shape": list(F32_STEP_SHAPE), "engine": "csrc/gemm_tf32.cuh (split-TF32 wgmma)"}
    state.setdefault("kernels", {}).update({
        "encoder_train_fwd_f32": dict(
            common, name="encoder_train_fwd_f32",
            source="madeleine_torch/csrc/encoder_train_fwd.cu",
            replaces="madeleine_tpu/ops/encoder_train.py:168", max_abs_err=err_f, ms=k6,
            plain_ms=k6p, bound_ms=k6t, bound_by=k6ty, bound_of="3 x TF32", bound_ms_ffma=k6b,
            nosave_ms=k6n, nosave_bound_ms=k6nt),
        "encoder_train_bwd_f32": dict(
            common, name="encoder_train_bwd_f32",
            source="madeleine_torch/csrc/encoder_train_bwd.cu",
            replaces="madeleine_tpu/ops/encoder_train.py:262", max_abs_err=err_b,
            ms=k7, plain_ms=k7p, bound_ms=k7t, bound_by=k7ty, bound_of="3 x TF32",
            bound_ms_ffma=k7b, recompute_ms=k7r, recompute_bound_ms=k7rt,
            recompute_bound_ms_ffma=k7rb)})
    for kernel, k in (("encoder_train_fwd_f32", "k6"), ("encoder_train_bwd_f32", "k7")):
        # the recompute route in the rule's blocks at [65, 16384]
        state["kernels"][kernel].update({"blocked_ms_16384": grown[f"{k}_ms"],
                                         "blocked_bound_ms_16384": grown[f"{k}_bound_ms_tf32"],
                                         "blocked_bound_ms_ffma_16384": grown[f"{k}_bound_ms"],
                                         "blocks_16384": grown["n_blocks"]})
    state["kernels"]["encoder_train_bwd_f32"]["blocked_own_peak_gb_16384"] = \
        grown["k7_own_peak_gb"]
    emit({"phase": "train_kernels_f32", "smi": state["smi"], "shape": list(F32_STEP_SHAPE),
          "rtol": F32_RTOL, "atol": F32_ATOL, "grad_rtol_fro": F32_GRAD_RTOL, "bc_atol": BC_ATOL,
          "ragged_lengths": lengths_r.tolist(), "checks": checks, "blocked": blocked,
          "times": times, "engine": engine,
          "wgrad_pieces": chunks, "peak_tflops_fp32": PEAK_FP32 / 1e12,
          "peak_tflops_tf32": PEAK_TF32 / 1e12})


# GOT kernels: relative Frobenius bars against the plain versions on the card
GOT_PLAN_RTOL = 1e-4   # T (K8) and gamma (K10)
GOT_GRAD_RTOL = 1e-3   # dC (K9)
GOT_STEP_SHAPE = (260, 256, 256)   # 4 stain pairs x 65 cases, 256 tokens subsampled
GOT_ODD_SHAPE = (7, 256, 192)
GOT_LARGE_SHAPE = (3, 512, 512)    # beyond a cluster's shared memory: K9/K10's global route
GOT_WIDE_SHAPE = (5, 100, 320)     # m > 256: the cluster route's general path, ragged rows
# operations per element per IPOT iteration: Q = A T, Q sigma, the row add, Q delta,
# the column add, (delta Q) sigma' (two products); the adjoint as csrc/ipot_bwd.cu's
# header writes it needs 18 more (each product and add once); exp(-C/beta) 2
IPOT_OPS, IPOT_ADJ_OPS, EXP_OPS = 7, 18, 2


def _rel_fro(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _got_costs(torch, b, n, m, gen, d=128):
    """C, Cs, Ct, Cst built as the GOT path builds them, from random tokens."""
    from madeleine_torch.ops import losses as L
    from madeleine_torch.ops.got_glue import cst_plain

    v = torch.from_numpy(gen.standard_normal((b, n, d)).astype(np.float32)).cuda()
    q = torch.from_numpy(gen.standard_normal((b, m, d)).astype(np.float32)).cuda()
    with torch.no_grad():
        C = L._threshold_relu(L.cosine_cost(v, q), None)
        Cs = L._threshold_relu(L.cosine_cost(v, v), None)
        Ct = L._threshold_relu(L.cosine_cost(q, q), None)
        return C, Cs, Ct, cst_plain(Cs, Ct)


def _got_work(b, n, m, iters=30, gw_outer=5, gw_iters=20):
    """(flops, bytes) of K8, K9 and K10 at their step settings: each input
    read once, each output written once."""
    nm = n * m
    k8 = (b * nm * (iters * IPOT_OPS + EXP_OPS), 2 * b * nm * 4)
    k9 = (b * nm * (iters * (IPOT_OPS + IPOT_ADJ_OPS) + 2 * EXP_OPS), 3 * b * nm * 4)
    gemm = 2 * (n * n * m + n * m * m)              # two products per outer step
    k10 = (b * gw_outer * (gemm + nm * (gw_iters * IPOT_OPS + EXP_OPS + 2)),
           b * (n * n + m * m + 2 * nm) * 4)
    return {"ipot_fwd": k8, "ipot_bwd": k9, "gw_gamma": k10}


def _check_got(torch, C, Cs, Ct, Cst):
    """Each of K8/K9/K10 against its plain version, its control and a second
    launch, with the route each took (from the launch counters); returns the
    report (bars enforced by the caller)."""
    from madeleine_torch.ops import ipot as I

    rep = {}
    before = read_counts()
    _, n, m = C.shape
    fwd_keys = []
    for beta, iters in ((0.5, 30), (0.1, 20)):
        T = I.ipot_plan_cuda(C, beta, iters)
        T2 = I.ipot_plan_cuda(C, beta, iters)
        want = I.ipot_plan_plain(C, beta, iters)
        short = I.ipot_plan_plain(C, beta, iters - 1)
        torch.cuda.synchronize()
        rep[f"ipot_fwd_{beta}_{iters}"] = {
            "rel_fro": _rel_fro(T, want), "max_abs_err": (T - want).abs().max().item(),
            "control": _rel_fro(short, want), "control_is": f"{iters - 1} iterations",
            "bitwise_equal": torch.equal(T, T2), "finite": bool(torch.isfinite(T).all())}
        fwd_keys.append(f"ipot_fwd_{beta}_{iters}")
        del T, T2, want, short
    _route_check(I, rep, "ipot_fwd", fwd_keys, before, read_counts(), n, m, 4)
    # at c = 4 the cluster route sums in the global route's order: equal bit for bit
    if tuple(I.transport_route("ipot_fwd", n, m)) == ("cluster", 4):
        for key, (beta, iters) in zip(fwd_keys, ((0.5, 30), (0.1, 20))):
            rep[key]["bitwise_equal_global"] = torch.equal(
                I.ipot_plan_cuda(C, beta, iters), I._ipot_fwd_global(C, beta, iters))
    before = read_counts()
    dC = I.ipot_plan_bwd_cuda(C, C, 0.5, 30)
    dC2 = I.ipot_plan_bwd_cuda(C, C, 0.5, 30)
    want = I.ipot_plan_bwd_plain(C, C, 0.5, 30)
    short = I.ipot_plan_bwd_plain(C, C, 0.5, 29)
    torch.cuda.synchronize()
    rep["ipot_bwd_0.5_30"] = {
        "rel_fro": _rel_fro(dC, want), "max_abs_err": (dC - want).abs().max().item(),
        "control": _rel_fro(short, want), "control_is": "29 iterations",
        "bitwise_equal": torch.equal(dC, dC2), "finite": bool(torch.isfinite(dC).all())}
    del dC, dC2, want, short
    g = I.gw_gamma_cuda(Cs, Ct, Cst, 0.1, 5, 20)
    g2 = I.gw_gamma_cuda(Cs, Ct, Cst, 0.1, 5, 20)
    want = I.gw_gamma_plain(Cs, Ct, Cst, 0.1, 5, 20)
    # the GW loop nears its fixed point within 5 outer steps, so one step
    # short may lie within the bar: the control is the largest outer count
    # below 5 whose plan lies beyond it (every count tried is reported)
    tried = {}
    for outer in (4, 3, 2, 1):
        tried[outer] = _rel_fro(I.gw_gamma_plain(Cs, Ct, Cst, 0.1, outer, 20), want)
        if tried[outer] > GOT_PLAN_RTOL:
            break
    # the f32 floor: both against the plain version in float64
    ref64 = I.gw_gamma_plain(Cs.double(), Ct.double(), Cst.double(), 0.1, 5, 20)
    torch.cuda.synchronize()
    rep["gw_gamma_0.1_5x20"] = {
        "rel_fro": _rel_fro(g, want), "max_abs_err": (g - want).abs().max().item(),
        "control": tried[outer], "control_is": f"{outer} outer steps",
        "controls_tried": tried,
        "kernel_vs_f64": _rel_fro(g.double(), ref64), "plain_vs_f64": _rel_fro(want.double(), ref64),
        "bitwise_equal": torch.equal(g, g2), "finite": bool(torch.isfinite(g).all())}
    after = read_counts()
    for kernel, key in (("ipot_bwd", "ipot_bwd_0.5_30"), ("gw_gamma", "gw_gamma_0.1_5x20")):
        _route_check(I, rep, kernel, [key], before, after, n, m, 2)
    return rep


def _route_check(I, rep, kernel, keys, before, after, n, m, calls):
    """Record in rep[key] for each of `keys` the route `transport_route`
    gives `kernel` at (n, m), the launches each route's counter took between
    `before` and `after`, and route_ok: all `calls` on that route."""
    route = I.transport_route(kernel, n, m)
    counted = {r: after[k] - before[k] for r, k in (("cluster", kernel),
                                                    ("global", f"{kernel}_global"))}
    for key in keys:
        rep[key]["route"] = list(route)
        rep[key]["route_launches"] = counted
        rep[key]["route_ok"] = counted[route[0]] == calls and sum(counted.values()) == calls


def _enforce_got(rep, where):
    for name, r in rep.items():
        bar = GOT_GRAD_RTOL if name.startswith("ipot_bwd") else GOT_PLAN_RTOL
        if not (r["finite"] and r["bitwise_equal"] and r["rel_fro"] <= bar
                and r.get("route_ok", True) and r.get("bitwise_equal_global", True)):
            raise AssertionError(f"got_kernels {where} {name}: {r} (bar {bar})")
        if not r["control"] > bar:
            raise AssertionError(f"got_kernels {where} {name}: control within the bar: {r}")


def phase_got_kernels(state):
    import ctypes

    import torch
    from madeleine_torch.ops import _build
    from madeleine_torch.ops import ipot as I

    gen = np.random.default_rng(SEED + 5)
    checks = {}
    shapes = {"odd": GOT_ODD_SHAPE, "wide": GOT_WIDE_SHAPE, "large": GOT_LARGE_SHAPE,
              "step": GOT_STEP_SHAPE}
    for label, shape in shapes.items():
        C, Cs, Ct, Cst = _got_costs(torch, *shape, gen)
        checks[label] = _check_got(torch, C, Cs, Ct, Cst)
    # each shape's route: the step's and the odd one's the cluster, the large one's global
    want_route = {"odd": "cluster", "wide": "cluster", "step": "cluster", "large": "global"}
    routes = {label: {k: I.transport_route(k, *shapes[label][1:]) for k in I.CLUSTER_SIZES}
              for label in shapes}
    # the route function's shared memory against the library's own
    smem = {}
    for kernel in I.CLUSTER_SIZES:
        for label, (_, n, m) in shapes.items():
            for c in I.CLUSTER_SIZES[kernel]:
                lib = _build.entry(kernel, f"{kernel}_cluster_smem_bytes", [ctypes.c_int] * 3,
                                   ctypes.c_size_t)(n, m, c)
                smem[f"{kernel}_{label}_c{c}"] = [I.cluster_smem_bytes(kernel, n, m, c), lib]
    # report every number first, then enforce the bars
    emit({"phase": "got_kernels", "checks": checks, "plan_rtol_fro": GOT_PLAN_RTOL,
          "grad_rtol_fro": GOT_GRAD_RTOL, "shapes": shapes, "routes": routes,
          "cluster_smem_bytes_python_vs_lib": smem})
    for label, rep in checks.items():
        _enforce_got(rep, label)
        for kernel, (route, _) in routes[label].items():
            if route != want_route[label]:
                raise AssertionError(f"got_kernels {label}: {kernel} took the {route} route")
    for key, (py, lib) in smem.items():
        if py != lib:
            raise AssertionError(f"got_kernels: cluster shared memory {key}: python {py}, "
                                 f"library {lib}")

    # times at the step's shape (C, Cs, Ct, Cst are the step shape's now)
    b, n, m = GOT_STEP_SHAPE
    fns = {"ipot_fwd": (lambda: I.ipot_plan_cuda(C, 0.5, 30),
                        lambda: I.ipot_plan_plain(C, 0.5, 30)),
           "ipot_bwd": (lambda: I.ipot_plan_bwd_cuda(C, C, 0.5, 30),
                        lambda: I.ipot_plan_bwd_plain(C, C, 0.5, 30)),
           "gw_gamma": (lambda: I.gw_gamma_cuda(Cs, Ct, Cst, 0.1, 5, 20),
                        lambda: I.gw_gamma_plain(Cs, Ct, Cst, 0.1, 5, 20))}
    work = _got_work(*GOT_STEP_SHAPE)
    sources = {"ipot_fwd": ("csrc/ipot_fwd.cu", "madeleine_tpu/ops/ipot.py:154"),
               "ipot_bwd": ("csrc/ipot_bwd.cu", "madeleine_tpu/ops/ipot.py:182"),
               "gw_gamma": ("csrc/gw_gamma.cu", "madeleine_tpu/ops/ipot.py:254")}
    err_key = {"ipot_fwd": ("ipot_fwd_0.5_30", "ipot_fwd_0.1_20"),
               "ipot_bwd": ("ipot_bwd_0.5_30",), "gw_gamma": ("gw_gamma_0.1_5x20",)}
    times = {}
    for name, (kernel, plain) in fns.items():
        ms = cuda_ms(kernel, warmup=2, iters=10)
        plain_ms = cuda_ms(plain, warmup=1, iters=3)
        flops, nbytes = work[name]
        ops, mem = flops / PEAK_FP32, nbytes / PEAK_BYTES
        bound = max(ops, mem) * 1e3
        times[name] = {"ms": ms, "ms_back_to_back": cuda_ms_back_to_back(kernel, 1, 10),
                       "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": "operations" if ops >= mem else "bytes",
                       "share_of_bound": bound / ms, "gflop": flops / 1e9, "gb": nbytes / 1e9}
        # the main path's kernel is the cluster route's (odd and step shapes)
        state.setdefault("kernels", {})[name] = {
            "name": name, "route": "cuda", "source": "madeleine_torch/" + sources[name][0],
            "replaces": sources[name][1],
            "max_abs_err": max(checks[lbl][k]["max_abs_err"] for lbl in ("odd", "wide", "step")
                               for k in err_key[name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": times[name]["bound_by"], "library_ms": None}
    # both routes of K8, K9 and K10 at the step's shape (the global route, the
    # one-block kernels, forced here), K8 at both cluster sizes, and K10 at
    # iters=0: its products and the exp epilogue alone, the split of its time
    c_gw = I.transport_route("gw_gamma", n, m)[1]
    c_bwd = I.transport_route("ipot_bwd", n, m)[1]
    c_fwd = I.transport_route("ipot_fwd", n, m)[1]
    routes_ms = {
        **{f"ipot_fwd_cluster_c{c}": cuda_ms(lambda c=c: I._ipot_fwd_cluster(C, 0.5, 30, c), 2, 10)
           for c in (4, 8)},
        **{f"ipot_fwd_cluster_c{c}_back_to_back": cuda_ms_back_to_back(
            lambda c=c: I._ipot_fwd_cluster(C, 0.5, 30, c), 1, 10) for c in (4, 8)},
        "ipot_fwd_global": cuda_ms(lambda: I._ipot_fwd_global(C, 0.5, 30), 1, 5),
        "ipot_bwd_cluster": cuda_ms(lambda: I._ipot_bwd_cluster(C, C, 0.5, 30, c_bwd), 1, 5),
        "ipot_bwd_global": cuda_ms(lambda: I._ipot_bwd_global(C, C, 0.5, 30), 1, 5),
        "gw_gamma_cluster": cuda_ms(lambda: I._gw_gamma_cluster(Cs, Ct, Cst, 0.1, 5, 20, c_gw),
                                    1, 5),
        "gw_gamma_global": cuda_ms(lambda: I._gw_gamma_global(Cs, Ct, Cst, 0.1, 5, 20), 1, 5),
        "gw_gamma_cluster_iters0": cuda_ms(
            lambda: I._gw_gamma_cluster(Cs, Ct, Cst, 0.1, 5, 0, c_gw), 1, 5),
        "gw_gamma_global_iters0": cuda_ms(
            lambda: I._gw_gamma_global(Cs, Ct, Cst, 0.1, 5, 0), 1, 5)}
    # the other cluster size each kernel could take at this shape (K10: 8; K9 fits only 8)
    routes_ms["gw_gamma_cluster_c8"] = cuda_ms(
        lambda: I._gw_gamma_cluster(Cs, Ct, Cst, 0.1, 5, 20, 8), 1, 5)
    occupancy = {f"{k}_c{c}": _build.entry(k, f"{k}_cluster_occupancy", [ctypes.c_int] * 3)(
        n, m, c) for k, cs in (("ipot_fwd", (4, 8)), ("ipot_bwd", (8,)), ("gw_gamma", (4, 8)))
        for c in cs}
    hist_bytes = 30 * b * n * m * 4
    emit({"phase": "got_kernels", "shape": GOT_STEP_SHAPE, "times": times,
          "routes_ms": routes_ms,
          "cluster_sizes": {"ipot_fwd": c_fwd, "ipot_bwd": c_bwd, "gw_gamma": c_gw},
          "max_active_clusters": occupancy,
          "cluster_smem_bytes": {
              "ipot_fwd": {c: I.cluster_smem_bytes("ipot_fwd", n, m, c) for c in (4, 8)},
              "ipot_bwd": I.cluster_smem_bytes("ipot_bwd", n, m, c_bwd),
              "gw_gamma": I.cluster_smem_bytes("gw_gamma", n, m, c_gw)},
          "k9_history_gb": hist_bytes / 1e9,
          "k9_history_floor_ms": 2 * hist_bytes / PEAK_BYTES * 1e3})


# GOT glue kernels: relative Frobenius bars against the plain versions on the card
GLUE_TB_RTOL = 1e-6     # K11/K12 outputs: elementwise work plus fixed-order row sums
GLUE_DTHR_RTOL = 1e-5   # K12's dthr: sums over whole problems
GLUE_GWT_RTOL = 1e-5    # K13/K14: full f32 products
GLUE_KERNELS = ("threshold_build_fwd", "threshold_build_bwd", "gw_trace_fwd", "gw_trace_bwd")


def _glue_work(b, n, m):
    """(flops, bytes) of K11-K14: each input read once, each output written
    once; the elementwise operations counted once each, 2 n m k per product."""
    nm, nn, mm = n * m, n * n, m * m
    k11 = (b * (nm + nn + mm + 2 * (nn + mm) + nm), 4 * b * (2 * nm + nn + mm + nm + nn + mm + 3))
    k12 = (b * (nm + 4 * (nn + mm) + 2 * nm),
           4 * b * ((nm + nn + mm + 3) + (nm + nn + mm + nm) + (nm + nn + mm + 3)))
    k13 = (2 * b * (n * n * m + n * m * m) + 3 * b * nm, 4 * b * (nn + mm + 2 * nm + 1))
    k14 = (2 * b * (2 * n * m * m + 2 * n * n * m) + b * (nn + mm + nm),
           4 * b * (nn + mm + nm + 1) + 4 * b * (nn + mm + nm))
    return {"threshold_build_fwd": k11, "threshold_build_bwd": k12, "gw_trace_fwd": k13,
            "gw_trace_bwd": k14}


def _glue_inputs(torch, b, n, m, gen, d=128):
    """C0, Cs0, Ct0 cosine costs of random tokens, per-problem thresholds
    min + 0.1 (max - min) [b, 3], and the GW plan of the thresholded costs
    (K10), as the GOT path builds them."""
    from madeleine_torch.ops import got_glue as G
    from madeleine_torch.ops import ipot as I
    from madeleine_torch.ops import losses as L

    v = torch.from_numpy(gen.standard_normal((b, n, d)).astype(np.float32)).cuda()
    q = torch.from_numpy(gen.standard_normal((b, m, d)).astype(np.float32)).cuda()
    with torch.no_grad():
        X0 = (L.cosine_cost(v, q), L.cosine_cost(v, v), L.cosine_cost(q, q))
        thr = torch.stack([x.amin((1, 2)) + 0.1 * (x.amax((1, 2)) - x.amin((1, 2)))
                           for x in X0], dim=1).contiguous()
        _, Cs, Ct, Cst = G.threshold_build_plain(*X0, thr)
        gamma = I.gw_gamma_cuda(Cs, Ct, Cst, 0.1, 5, 20)
    return X0, thr, gamma


def _check_glue(torch, X0, thr, gamma, gen):
    """K11-K14 each against its plain version (relative Frobenius per
    output), a second launch of each, and a control fed a neighbouring
    problem's threshold (K11/K12) or plan (K13/K14), which must miss."""
    from madeleine_torch.ops import got_glue as G

    b, n, m = X0[0].shape
    rep = {}

    def entry(got, again, want, control, names, control_is):
        errs = {k: _rel_fro(g, w) for k, g, w in zip(names, got, want)}
        return {"rel_fro": errs, "max_abs_err": max((g - w).abs().max().item()
                                                    for g, w in zip(got, want)),
                "control": {k: _rel_fro(c, w) for k, c, w in zip(names, control, want)},
                "control_is": control_is,
                "bitwise_equal": all(torch.equal(g, a) for g, a in zip(got, again)),
                "finite": all(bool(torch.isfinite(g).all()) for g in got)}

    rolled = thr.roll(1, 0).contiguous()
    outs = G.threshold_build_cuda(*X0, thr)
    rep["threshold_build_fwd"] = entry(
        outs, G.threshold_build_cuda(*X0, thr), G.threshold_build_plain(*X0, thr),
        G.threshold_build_plain(*X0, rolled), ("C", "Cs", "Ct", "Cst"), "thresholds rolled")
    cots = [torch.from_numpy(gen.standard_normal(tuple(o.shape)).astype(np.float32)).cuda()
            for o in outs]
    rep["threshold_build_bwd"] = entry(
        G.threshold_build_bwd_cuda(*X0, thr, *cots), G.threshold_build_bwd_cuda(*X0, thr, *cots),
        G.threshold_build_bwd_plain(*X0, thr, *cots),
        G.threshold_build_bwd_plain(*X0, rolled, *cots), ("dC0", "dCs0", "dCt0", "dthr"),
        "thresholds rolled")
    _, Cs, Ct, Cst = outs
    groll = gamma.roll(1, 0).contiguous()
    before = read_counts()
    k13 = G.gw_trace_cuda(Cs, Ct, Cst, gamma)
    rep["gw_trace_fwd"] = entry(
        [k13], [G.gw_trace_cuda(Cs, Ct, Cst, gamma)],
        [G.gw_trace_plain(Cs, Ct, Cst, gamma)], [G.gw_trace_plain(Cs, Ct, Cst, groll)],
        ("out",), "gamma rolled")
    # the route from the counters (two tiled calls, no first-design launch),
    # then the tiled K13 against its first design: another sum order, K13's bar
    after = read_counts()
    rep["gw_trace_fwd"]["route"] = {k: after[k] - before[k]
                                    for k in ("gw_trace_fwd", "gw_trace_fwd_rowblock")}
    rep["gw_trace_fwd"]["rel_fro_rowblock"] = _rel_fro(
        k13, G.gw_trace_rowblock_cuda(Cs, Ct, Cst, gamma))
    dout = torch.from_numpy(gen.standard_normal(b).astype(np.float32)).cuda()
    k14 = G.gw_trace_bwd_cuda(Cs, Ct, gamma, dout)
    rep["gw_trace_bwd"] = entry(
        k14, G.gw_trace_bwd_cuda(Cs, Ct, gamma, dout),
        G.gw_trace_bwd_plain(Cs, Ct, Cst, gamma, dout),
        G.gw_trace_bwd_plain(Cs, Ct, Cst, groll, dout), ("dCs", "dCt", "dCst"), "gamma rolled")
    # the tiled K14 against its first design, output by output, bit for bit
    rowblock = G.gw_trace_bwd_rowblock_cuda(Cs, Ct, gamma, dout)
    rep["gw_trace_bwd"]["bitwise_equal_rowblock"] = {
        k: torch.equal(a, r) for k, a, r in zip(("dCs", "dCt", "dCst"), k14, rowblock)}
    torch.cuda.synchronize()
    return rep


def _glue_bar(kernel, output):
    if kernel.startswith("gw_trace"):
        return GLUE_GWT_RTOL
    return GLUE_DTHR_RTOL if output == "dthr" else GLUE_TB_RTOL


def _enforce_glue(rep, where):
    for kernel, r in rep.items():
        if not (r["finite"] and r["bitwise_equal"]
                and all(r.get("bitwise_equal_rowblock", {}).values())
                and r.get("rel_fro_rowblock", 0.0) <= GLUE_GWT_RTOL
                and r.get("route", {}).get("gw_trace_fwd_rowblock", 0) == 0
                and r.get("route", {}).get("gw_trace_fwd", 2) == 2):
            raise AssertionError(f"glue_kernels {where} {kernel}: {r}")
        for out, err in r["rel_fro"].items():
            bar = _glue_bar(kernel, out)
            if not err <= bar:
                raise AssertionError(f"glue_kernels {where} {kernel} {out}: {err} > {bar}")
            if not r["control"][out] > bar:
                raise AssertionError(f"glue_kernels {where} {kernel} {out}: control within "
                                     f"the bar: {r}")


def phase_glue_kernels(state):
    import torch
    from madeleine_torch.ops import got_glue as G

    gen = np.random.default_rng(SEED + 6)
    checks = {}
    shapes = {"odd": GOT_ODD_SHAPE, "wide": GOT_WIDE_SHAPE, "step": GOT_STEP_SHAPE}
    for label, shape in shapes.items():
        X0, thr, gamma = _glue_inputs(torch, *shape, gen)
        checks[label] = _check_glue(torch, X0, thr, gamma, gen)
    emit({"phase": "glue_kernels", "checks": checks, "tb_rtol_fro": GLUE_TB_RTOL,
          "dthr_rtol_fro": GLUE_DTHR_RTOL, "gw_trace_rtol_fro": GLUE_GWT_RTOL,
          "shapes": shapes})
    for label, rep in checks.items():
        _enforce_glue(rep, label)

    # times at the step's shape (X0, thr and gamma are the step shape's now)
    outs = G.threshold_build_cuda(*X0, thr)
    _, Cs, Ct, Cst = outs
    cots = [torch.randn_like(o) for o in outs]
    dout = torch.randn(X0[0].shape[0], device="cuda")
    fns = {"threshold_build_fwd": (lambda: G.threshold_build_cuda(*X0, thr),
                                   lambda: G.threshold_build_plain(*X0, thr)),
           "threshold_build_bwd": (lambda: G.threshold_build_bwd_cuda(*X0, thr, *cots),
                                   lambda: G.threshold_build_bwd_plain(*X0, thr, *cots)),
           "gw_trace_fwd": (lambda: G.gw_trace_cuda(Cs, Ct, Cst, gamma),
                            lambda: G.gw_trace_plain(Cs, Ct, Cst, gamma)),
           "gw_trace_bwd": (lambda: G.gw_trace_bwd_cuda(Cs, Ct, gamma, dout),
                            lambda: G.gw_trace_bwd_plain(Cs, Ct, Cst, gamma, dout))}
    replaces = {"threshold_build_fwd": "madeleine_tpu/ops/got_glue.py:133",
                "threshold_build_bwd": "madeleine_tpu/ops/got_glue.py:166",
                "gw_trace_fwd": "madeleine_tpu/ops/got_glue.py:265",
                "gw_trace_bwd": "madeleine_tpu/ops/got_glue.py:292"}
    work = _glue_work(*GOT_STEP_SHAPE)
    times = {}
    for name, (kernel, plain) in fns.items():
        ms = cuda_ms(kernel, warmup=2, iters=10)
        plain_ms = cuda_ms(plain, warmup=1, iters=5)
        flops, nbytes = work[name]
        ops, mem = flops / PEAK_FP32, nbytes / PEAK_BYTES
        bound = max(ops, mem) * 1e3
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": "operations" if ops >= mem else "bytes",
                       "share_of_bound": bound / ms, "gflop": flops / 1e9, "gb": nbytes / 1e9}
        state.setdefault("kernels", {})[name] = {
            "name": name, "route": "cuda", "source": "madeleine_torch/csrc/got_glue.cu",
            "replaces": replaces[name],
            "max_abs_err": max(checks[lbl][name]["max_abs_err"] for lbl in checks),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": times[name]["bound_by"], "library_ms": None}
    # K13 and K14: their rate, back to back, and their first designs' times
    # (the check-only entry points)
    rowblock = {"gw_trace_fwd": lambda: G.gw_trace_rowblock_cuda(Cs, Ct, Cst, gamma),
                "gw_trace_bwd": lambda: G.gw_trace_bwd_rowblock_cuda(Cs, Ct, gamma, dout)}
    for name, first_design in rowblock.items():
        k = times[name]
        k["tflops"] = k["gflop"] / k["ms"]
        k["ms_back_to_back"] = cuda_ms_back_to_back(fns[name][0], 2, 20)
        k["rowblock_ms"] = cuda_ms(first_design, 1, 5)
    emit({"phase": "glue_kernels", "shape": GOT_STEP_SHAPE, "times": times,
          "glue_kernels_ms_per_step": sum(t["ms"] for t in times.values()),
          "glue_plain_ms_per_step": sum(t["plain_ms"] for t in times.values())})


PEROP_STEP_SHAPE = (65, 2048)   # the train step's call shape, one modality
# the checked shapes: the step's, a long bag, and partial last tiles of the GEMM
# (128 rows) and of the row kernels (64 rows): 2 x 4057 = 8114 rows
PEROP_SHAPES = (PEROP_STEP_SHAPE, (8, 4096), (2, 4057))
PEROP_KERNELS = ("preattn_fwd", "preattn_bwd", "gated_logits_fwd", "gated_logits_bwd",
                 "linear_tok_fwd", "linear_tok_bwd")
# kernel -> (source, the TPU kernel it replaces)
PEROP_SOURCES = {
    "preattn_fwd": ("madeleine_torch/csrc/preattn.cu", "madeleine_tpu/ops/preattn.py:134"),
    "preattn_bwd": ("madeleine_torch/csrc/preattn.cu", "madeleine_tpu/ops/preattn.py:200"),
    "gated_logits_fwd": ("madeleine_torch/csrc/gated_logits.cu",
                         "madeleine_tpu/ops/gated_logits.py:78"),
    "gated_logits_bwd": ("madeleine_torch/csrc/gated_logits.cu",
                         "madeleine_tpu/ops/gated_logits.py:96"),
    "linear_tok_fwd": ("madeleine_torch/csrc/linear_tok.cu", "madeleine_tpu/ops/linear_tok.py:28"),
    "linear_tok_bwd": ("madeleine_torch/csrc/linear_tok.cu", "madeleine_tpu/ops/linear_tok.py:35"),
}


def _perop_work(b, t, w, need_dx=False):
    """{kernel: (flops, bytes)} of kernels 15-20 at [b, t]: the products of
    each op (a backward kernel also recomputes its op's forward products,
    the TPU ops' residuals being the inputs and the seed); each input read
    once, each output written once; activations in the operands' dtype."""
    a = w["w1"].element_size()   # bytes of an activation: bf16 2, f32 4
    hd, d_in = w["w1"].shape
    E = w["w3"].shape[0]
    nh, f, e = w["wa"].shape
    dout = w["wt"].shape[0]
    n = b * t
    pre = ("w1", "b1", "s1", "t1", "w2", "b2", "s2", "t2", "w3", "b3", "s3", "t3")
    gate = ("wa", "ba", "wb", "bb", "wc", "bc")

    def wbytes(keys):
        return sum(w[k].numel() * w[k].element_size() for k in keys)

    def gbytes(keys):   # f32 gradients
        return sum(w[k].numel() * 4 for k in keys)

    pre_macs, gate_macs, tok_macs = d_in * hd + hd * hd + hd * E, 2 * nh * e * f, E * dout
    return {
        "preattn_fwd": (2.0 * n * pre_macs, n * (d_in + E) * a + wbytes(pre)),
        "preattn_bwd": (2.0 * n * (3 * pre_macs - (0 if need_dx else d_in * hd)),
                        n * (d_in + E + (d_in if need_dx else 0)) * a + wbytes(pre)
                        + gbytes(pre)),
        "gated_logits_fwd": (2.0 * n * gate_macs, n * (E * a + nh * 4) + wbytes(gate)),
        "gated_logits_bwd": (6.0 * n * gate_macs,
                             n * (2 * E * a + nh * 4) + wbytes(gate) + gbytes(gate)),
        "linear_tok_fwd": (2.0 * n * tok_macs, n * (E + dout) * 2 + wbytes(("wt", "bt"))),
        "linear_tok_bwd": (4.0 * n * tok_macs, n * (2 * E + dout) * 2 + wbytes(("wt",))
                           + gbytes(("wt", "bt"))),
    }


def _perop_calls(torch, w, x, rates, gen, seed=1234, row_offset=3, need_dx=False):
    """{kernel: (CUDA wrapper, plain version, args, kwargs)} of kernels 15-20
    on x: gated_logits and linear_tok read preattn's kernel output y; the
    cotangents are random (dy, g in bf16, dl in f32)."""
    from madeleine_torch.ops import gated_logits as gl
    from madeleine_torch.ops import linear_tok as lt
    from madeleine_torch.ops import preattn as pa

    b, t, _ = x.shape
    pre, gate = rates
    y = pa.preattn_fwd_cuda(x, w, seed, row_offset, pre)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).cuda().to(dtype)

    dy = randn(b, t, w["w3"].shape[0])
    dl = randn(b, t, w["wa"].shape[0], dtype=torch.float32)
    g = randn(b, t, w["wt"].shape[0])
    return {
        "preattn_fwd": (pa.preattn_fwd_cuda, pa.preattn_fwd_plain, (x, w, seed, row_offset, pre),
                        {}),
        "preattn_bwd": (pa.preattn_bwd_cuda, pa.preattn_bwd_plain,
                        (x, dy, w, seed, row_offset, pre), {"need_dx": need_dx}),
        "gated_logits_fwd": (gl.gated_logits_fwd_cuda, gl.gated_logits_fwd_plain,
                             (y, w, seed, row_offset, gate), {}),
        "gated_logits_bwd": (gl.gated_logits_bwd_cuda, gl.gated_logits_bwd_plain,
                             (y, dl, w, seed, row_offset, gate), {}),
        "linear_tok_fwd": (lt.linear_tok_fwd_cuda, lt.linear_tok_fwd_plain,
                           (y, w["wt"], w["bt"]), {}),
        "linear_tok_bwd": (lt.linear_tok_bwd_cuda, lt.linear_tok_bwd_plain, (y, g, w["wt"]), {}),
    }


def _bf16_ulp(torch, v):
    """One bf16 rounding step at each value of v (f32): 2^(floor(log2|v|) - 7)."""
    return torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 8)


# kernels 16 and 18: their input gradients (dx, dy), bf16, are also measured
# elementwise against OUT_ATOL, or one bf16 rounding step of the reference
# value where larger, and reported; their bar stays GRAD_RTOL relative
# Frobenius, as for every gradient: dx = bf16(bf16(dz1) . W1) carries the
# rounding of dz1 before its product, and at d_in 544 dx misses the
# elementwise bar by 4% in both designs (an error of 0.03125 where the bar is
# 0.03; an H100 at 700 W)
ELEMENTWISE_GRADS = ("preattn_bwd", "gated_logits_bwd")
# kernel 20: every output at GRAD_RTOL, and its dy (bf16, one product of
# K = d_out, one rounding) also held to that elementwise bar
ELEMENTWISE_BARS = ("linear_tok_bwd",)


def _backward_errs(torch, name, where, got, want):
    """A backward's outputs against a reference's: each at GRAD_RTOL
    relative Frobenius; for ELEMENTWISE_GRADS dx / dy's largest error over
    the elementwise bar is reported beside, and for ELEMENTWISE_BARS it must
    be at most 1 as well. Returns {"max_abs_err",
    "grad_rel_fro", ["input_grad_err_over_bar"], "ok"}."""
    errs, abs_err = {}, 0.0
    for k in want:
        a, b = got[k].float(), want[k].float()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} {where}: non-finite {k}")
        abs_err = max(abs_err, (a - b).abs().max().item())
        errs[k] = _rel_fro(a, b)
    rep = {"max_abs_err": abs_err, "grad_rel_fro": errs}
    ok = max(errs.values()) <= GRAD_RTOL
    if name in ELEMENTWISE_GRADS + ELEMENTWISE_BARS:
        over = 0.0
        for k in ("x", "y"):
            if k in want:
                a, b = got[k].float(), want[k].float()
                bar = torch.maximum(_bf16_ulp(torch, b), torch.full_like(b, OUT_ATOL))
                over = max(over, ((a - b).abs() / bar).max().item())
        rep["input_grad_err_over_bar"] = over
        if name in ELEMENTWISE_BARS:
            ok = ok and over <= 1.0
    rep["ok"] = ok
    return rep


def _forward_errs(torch, name, where, got, want):
    """A forward's output against a reference's at OUT_ATOL, or for a bf16
    output one bf16 rounding step of the reference value where that is
    larger. Returns {"max_abs_err", "max_err_over_bar", "ok"}."""
    a, b = got.float(), want.float()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{name} {where}: non-finite out")
    bar = (torch.maximum(_bf16_ulp(torch, b), torch.full_like(b, OUT_ATOL))
           if got.dtype == torch.bfloat16 else OUT_ATOL)
    over = ((a - b).abs() / bar).max().item()
    return {"max_abs_err": (a - b).abs().max().item(), "max_err_over_bar": over,
            "ok": over <= 1.0}


def _check_perop(torch, calls, where):
    """Each kernel of `calls` twice (bitwise equal) against its plain version:
    a forward's output at OUT_ATOL, or for a bf16 output one bf16 rounding
    step of the plain value where that is larger (preattn's y reaches |y| of
    4-8, where a rounding flip from another f32 summation order is 0.031); a
    backward's outputs (dx / dy and the f32 parameter gradients) at
    GRAD_RTOL relative Frobenius, kernels 16 and 18's dx / dy also measured
    elementwise (`_backward_errs`). Returns {kernel: {"max_abs_err", and for
    a forward "max_err_over_bar", for a backward "grad_rel_fro"}}."""
    rep = {}
    for name, (kern, plain, args, kw) in calls.items():
        got, again = kern(*args, **kw), kern(*args, **kw)
        with torch.no_grad():
            want = plain(*args, **kw)
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, again, want = {"out": got}, {"out": again}, {"out": want}
        if set(got) != set(want) or not all(torch.equal(got[k], again[k]) for k in got):
            raise AssertionError(f"{name} {where}: two launches differ, or outputs {sorted(got)}")
        if name.endswith("_fwd"):
            rep[name] = _forward_errs(torch, name, where, got["out"], want["out"])
        else:
            rep[name] = _backward_errs(torch, name, where, got, want)
        del got, again, want
    return rep


def _first_designs():
    """{kernel: its first design}: rows 15-18 and 20 as first built (the
    mma.sync GEMM), kept as check-only entry points."""
    from madeleine_torch.ops import gated_logits as gl
    from madeleine_torch.ops import linear_tok as lt
    from madeleine_torch.ops import preattn as pa

    return {"preattn_fwd": pa.preattn_fwd_rowblock_cuda,
            "preattn_bwd": pa.preattn_bwd_rowblock_cuda,
            "gated_logits_fwd": gl.gated_logits_fwd_rowblock_cuda,
            "gated_logits_bwd": gl.gated_logits_bwd_rowblock_cuda,
            "linear_tok_bwd": lt.linear_tok_bwd_mmasync_cuda}


def _check_first_designs(torch, calls, where):
    """Rows 15-18 and 20 of `calls` against their first designs on the same inputs,
    at the plain versions' bars (`_forward_errs`, `_backward_errs`); each
    first design twice, bitwise equal. Returns {kernel: errors, "ok"}."""
    rep = {}
    for name, first in _first_designs().items():
        if name not in calls:
            continue
        kern, _, args, kw = calls[name]
        got, ref, again = kern(*args, **kw), first(*args, **kw), first(*args, **kw)
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, ref, again = {"out": got}, {"out": ref}, {"out": again}
        if set(ref) != set(got) or not all(torch.equal(ref[k], again[k]) for k in ref):
            raise AssertionError(f"{name} first design {where}: two launches differ")
        against = f"{where} against its first design"
        rep[name] = (_forward_errs(torch, name, against, got["out"], ref["out"])
                     if name.endswith("_fwd") else
                     _backward_errs(torch, name, against, got, ref))
        del got, ref, again
    return rep


PRE_KEYS = ("w1", "b1", "s1", "t1", "w2", "b2", "s2", "t2", "w3", "b3", "s3", "t3")
# The per-op chain's pre-attention gradients against K7's: preattn's backward
# takes y's cotangent in bf16, the bf16 sum of three bf16 cotangents (pool,
# gates, tokens), where K7 keeps that sum in f32; the bias and LN sums over
# 133120 tokens carry that rounding (1.0-1.7% seen at rates 0.1/0.25). Held
# here, with a rate-0 run beside it (the floor without masks) and a control
# whose masks are another row's, which must miss it.
PRE_CHAIN_RTOL = 3e-2
# On the training-pool chain the gate bias ba's gradient, a sum over the
# 133120 tokens of dl-weighted branch adjoints whose terms nearly cancel,
# carries the lane's two roundings of row 5's inputs: an offset of inner per
# (bag, head), since the lane pools the bf16 y (as JAX's per-op lane does)
# where K6 pools its f32 y, and the bf16 y in g.y (on an H100 at 700 W: ba
# 1.47e-2 at (0.1, 0.25), 2.70e-2 at rates 0; 4.0e-3 and 9.4e-3 with K7's
# inner alone). It is held at TRAIN_POOL_BA_RTOL; beside it the chain's row
# 5 given K7's inner and the f32 y (the plain stack's layer-3 output before
# its rounding), and kernel 18 on that dl, must meet GRAD_RTOL.
TRAIN_POOL_BA_RTOL = 5e-2
# bc's exact gradient is 0, but the training pool's inner is formed from its
# bf16 pooled output (JAX attn_pool.py:413-420), so the chain's dbc is
# sum_b g.(pooled - bf16(pooled)) per head, predicted from row 4's f32
# pooled output and held to that prediction.
TRAIN_POOL_BC_ATOL = 1e-3


def _perop_chain_vs_fused(torch, w, x, rates, gen, seed=99, row_offset=65, chain_offset=0,
                          train_pool=False):
    """The per-op chain preattn -> gated_logits -> softmax pool ->
    linear_tok (kernels 15-20 through autograd, rows from row_offset +
    chain_offset) against K6/K7 (rows from row_offset) on the same x and
    seed, with a random pooled cotangent and dtok. The pool is the plain
    one (f32 output) or, with train_pool, the training pool (rows 4-5,
    output and cotangent in bf16, as on the no-fused lane, whose inner is
    formed from the bf16 pooled output, JAX attn_pool.py:413-420); K7 is
    then given the bf16-rounded cotangent and the inner formed from K6's
    pooled output rounded to bf16, as the lane forms its own (with K7's f32
    cotangent and inner, ba missed by 3.7e-2 on an H100). Returns the
    errors and the keys that miss their bars: pooled at POOLED_ATOL (a bf16
    pooled output: or one bf16 rounding step of K6's value, where larger),
    tokens at OUT_ATOL, the gate and token-projector gradients at GRAD_RTOL relative
    Frobenius, the 12 pre-attention ones at PRE_CHAIN_RTOL; with train_pool
    ba at TRAIN_POOL_BA_RTOL and, recomputed with row 5 given K7's inner
    and the f32 y, at GRAD_RTOL. bc's exact gradient is 0 (softmax is shift invariant):
    the plain pool's chain is held to it at BC_ATOL; the training pool's
    to its predicted rounding term at TRAIN_POOL_BC_ATOL; K7's carries the
    bf16 rounding of its saved u3 (its y32 in the backward is not the
    forward's) and is reported."""
    from madeleine_torch.ops import encoder_train as et
    from madeleine_torch.ops import gated_logits as gl
    from madeleine_torch.ops import linear_tok as lt
    from madeleine_torch.ops import preattn as pa
    from madeleine_torch.ops import prng
    from madeleine_torch.ops.attn_pool import (fused_attention_pool, pool_bwd_cuda,
                                               pool_ms_cuda, softmax_pool_plain)

    b, t, _ = x.shape
    nh, _, e = w["wa"].shape
    bias = et.token_mask_bias(None, b, t, "cuda")
    pooled32, m, s, tok, l, saved = et.encoder_train_fwd_cuda(x, bias, w, seed, row_offset,
                                                              *rates)
    G = torch.from_numpy(gen.standard_normal((b, nh * e)).astype(np.float32)).cuda()
    DT = torch.from_numpy(gen.standard_normal((b, t, w["wt"].shape[0])).astype(np.float32)
                          ).cuda().to(torch.bfloat16)
    if train_pool:   # K7 takes the lane's rounded inputs: G and pooled in bf16
        Gk = G.to(torch.bfloat16).float()
        inner = (Gk * pooled32.to(torch.bfloat16).float()).reshape(b, nh, e).sum(-1)
    else:
        Gk, inner = G, (G * pooled32).reshape(b, nh, e).sum(-1)
    k7 = et.encoder_train_bwd_cuda(x, l, m, s, Gk, inner, DT, saved, w, seed, row_offset, *rates)
    del saved
    ro = row_offset + chain_offset
    wl = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    with torch.enable_grad():
        y = pa.preattn_train(x, wl, seed, ro, rates[0])
        logits = gl.gated_logits_train(y, wl, seed, ro, rates[1])
        if train_pool:
            pooled = fused_attention_pool(y.reshape(b, t, nh, e), logits).reshape(b, -1)
        else:
            pooled = softmax_pool_plain(logits, y.reshape(b, t, nh, e))
        tok_c = lt.linear_tok_train(y, wl["wt"], wl["bt"])
        ((pooled.float() * G).sum() + (tok_c.float() * DT.float()).sum()).backward()
    torch.cuda.synchronize()
    perr = (pooled.detach().float() - pooled32).abs()
    pbar = (torch.maximum(_bf16_ulp(torch, pooled32), torch.full_like(pooled32, POOLED_ATOL))
            if pooled.dtype == torch.bfloat16 else POOLED_ATOL)
    rep = {"pooled_err": perr.max().item(), "pooled_err_over_bar": (perr / pbar).max().item(),
           "tok_err": (tok_c.detach().float() - tok.float()).abs().max().item(),
           "grad_rel_fro": {k: _rel_fro(wl[k].grad.float(), k7[k].float())
                            for k in w if k != "bc"},
           "chain_bc_max_abs": wl["bc"].grad.abs().max().item(),
           "k7_bc_max_abs": k7["bc"].abs().max().item()}
    bars = {k: PRE_CHAIN_RTOL if k in PRE_KEYS else GRAD_RTOL for k in rep["grad_rel_fro"]}
    scalar_bars = [("pooled_err", rep["pooled_err_over_bar"], 1.0),
                   ("tok_err", rep["tok_err"], OUT_ATOL)]
    if train_pool:
        bars["ba"] = TRAIN_POOL_BA_RTOL
        # the chain's forward again, then row 5 given K7's inner (with the bf16
        # y, and with the f32 y) and kernel 18 on its dl
        yb, l32 = y.detach().reshape(b, t, nh * e), logits.detach().float().contiguous()
        pooled_b, m_c, s_c = pool_ms_cuda(yb, l32)
        rows, toks = prng.site_rows(b, t, ro, x.device)
        y32 = pa.stack_fwd_plain(x, w, seed, rows, toks, rates[0])[2].contiguous()
        for key, yy in (("ba_rel_fro_k7_inner", yb), ("ba_rel_fro_k7_inner_f32_y", y32)):
            dl_k = pool_bwd_cuda(yy, l32, m_c, s_c, Gk, inner)[1]
            ba_k = gl.gated_logits_bwd_cuda(yb, dl_k, w, seed, ro, rates[1])["ba"]
            rep[key] = _rel_fro(ba_k.float(), k7["ba"].float())
        del y32
        rep["pooled_rel_fro_vs_k6"] = _rel_fro(pooled_b.float(), pooled32)
        p32 = pool_ms_cuda(yb.float(), l32)[0]
        bc_pred = (Gk * (p32 - pooled_b.float())).reshape(b, nh, e).sum(-1).sum(0)
        rep["bc_predicted_max_abs"] = bc_pred.abs().max().item()
        rep["bc_err_vs_predicted"] = (wl["bc"].grad.float() - bc_pred).abs().max().item()
        scalar_bars += [("ba_rel_fro_k7_inner_f32_y", rep["ba_rel_fro_k7_inner_f32_y"],
                         GRAD_RTOL),
                        ("bc_err_vs_predicted", rep["bc_err_vs_predicted"],
                         TRAIN_POOL_BC_ATOL)]
        del dl_k, p32
    else:
        scalar_bars.append(("chain_bc_max_abs", rep["chain_bc_max_abs"], BC_ATOL))
    rep["failed"] = ([k for k, v in rep["grad_rel_fro"].items() if not v <= bars[k]]
                     + [k for k, v, bar in scalar_bars if not v <= bar])
    return rep


# kernel 19's edges beside the step shape: (b, t, E, d_out) with a ragged
# last 64-row tile, a ragged and a second 128-column tile, a partial k tile
LINEAR_TOK_EDGES = ((3, 1000, 2048, 128), (3, 1000, 2048, 136), (2, 700, 2048, 256),
                    (3, 1000, 544, 128))


def _check_linear_tok_edges(torch, gen):
    """Kernels 19 and 20 against their plain versions at LINEAR_TOK_EDGES
    (a forward's output and 20's dy at OUT_ATOL, or one bf16 rounding step
    of the value where larger; 20's outputs, dy too, at GRAD_RTOL relative
    Frobenius), 20 also against its first design at the same bars, two
    launches of each bitwise equal; a y 2 bytes past a 16-byte boundary
    must raise, and for 20 a g so placed too. Returns {shape: {"max_abs_err",
    "max_err_over_bar", "ok"}} (20's as "bwd <shape>", "bwd_first_design
    <shape>")."""
    from madeleine_torch.ops import linear_tok as lt

    def randn(*shape, scale=1.0):
        return torch.from_numpy((gen.standard_normal(shape) * scale).astype(np.float32)).cuda()

    rep = {}
    for b, t, E, dout in LINEAR_TOK_EDGES:
        y = randn(b, t, E).to(torch.bfloat16)
        wt = randn(dout, E, scale=E ** -0.5).to(torch.bfloat16)
        bt = randn(dout)
        got, again = lt.linear_tok_fwd_cuda(y, wt, bt), lt.linear_tok_fwd_cuda(y, wt, bt)
        want = lt.linear_tok_fwd_plain(y, wt, bt).float()
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        over = (err / torch.maximum(_bf16_ulp(torch, want), torch.full_like(want, OUT_ATOL))
                ).max().item()
        rep[f"{b}x{t}x{E}->{dout}"] = {"max_abs_err": err.max().item(), "max_err_over_bar": over,
                                       "ok": over <= 1.0 and torch.equal(got, again)}
        g = randn(b, t, dout).to(torch.bfloat16)
        wantb = lt.linear_tok_bwd_plain(y, g, wt)
        for key, kern in (("bwd", lt.linear_tok_bwd_cuda),
                          ("bwd_first_design", lt.linear_tok_bwd_mmasync_cuda)):
            gotb, againb = kern(y, g, wt), kern(y, g, wt)
            torch.cuda.synchronize()
            r = _backward_errs(torch, "linear_tok_bwd", f"{key} {b}x{t}x{E}->{dout}", gotb, wantb)
            r["ok"] = r["ok"] and all(torch.equal(gotb[k], againb[k]) for k in gotb)
            rep[f"{key} {b}x{t}x{E}->{dout}"] = r
            del gotb, againb
        del y, wt, bt, got, again, want, err, g, wantb
    buf = torch.zeros(2 * 64 * 256 + 1, dtype=torch.bfloat16, device="cuda")
    try:
        lt.linear_tok_fwd_cuda(buf[1:].view(2, 64, 256),
                               torch.zeros(128, 256, dtype=torch.bfloat16, device="cuda"),
                               torch.zeros(128, device="cuda"))
        rep["misaligned_y_raises"] = {"ok": False}
    except ValueError:
        rep["misaligned_y_raises"] = {"ok": True}
    gbuf = torch.zeros(2 * 64 * 128 + 1, dtype=torch.bfloat16, device="cuda")
    y = torch.zeros(2, 64, 256, dtype=torch.bfloat16, device="cuda")
    wt = torch.zeros(128, 256, dtype=torch.bfloat16, device="cuda")
    for key, kern in (("bwd", lt.linear_tok_bwd_cuda),
                      ("bwd_first_design", lt.linear_tok_bwd_mmasync_cuda)):
        try:
            kern(y, gbuf[1:].view(2, 64, 128), wt)
            rep[f"{key}_misaligned_g_raises"] = {"ok": False}
        except ValueError:
            rep[f"{key}_misaligned_g_raises"] = {"ok": True}
    return rep


# the train kernels' row limit (csrc/train_common.cuh::MAX_TRAIN_ROWS) and
# rows 4-5's bags a call (csrc/attn_pool.cu::MAX_BAGS)
MAX_TRAIN_ROWS = 2 ** 31 - 256
MAX_POOL_BAGS = 65535


def _check_refusals(torch):
    """Rows 4-5 and 15-20 at a call past their 32-bit limits: each C entry
    point, given null buffers and the dims of such a call, returns
    cudaErrorInvalidValue before it touches a buffer, and the launch path
    raises (a wrapper never falls back to its plain version). The calls: b t
    one row past MAX_TRAIN_ROWS (a stain of [65, 32768] in one call holds
    2.1 M rows, 4.4e9 elements of y: within it, and past 2**31 elements,
    which every offset addresses in 64 bits), a global bag past 2**31 - 1
    (rows 15-18's dropout keys), row 20's M past MAX_TRAIN_ROWS, rows 4-5 at
    MAX_POOL_BAGS + 1 bags. Returns {entry point: the error raised}."""
    import ctypes

    from madeleine_torch.ops import _build

    dev = torch.device("cuda")
    t = MAX_TRAIN_ROWS // 65 + 1
    rows = [65, t]            # 65 bags of t rows: MAX_TRAIN_ROWS + 1 rows or more
    far = [1, 1]              # one row, its bag at global index 2**31 - 1 + 1
    cases = {}
    for lib, fn, n_ptrs, shape in (
            ("preattn", "preattn_forward", 18, [512, 512, 2048]),
            ("preattn", "preattn_backward", 39, [512, 512, 2048]),
            ("preattn", "preattn_forward_f32", 18, [512, 512, 2048]),
            ("preattn", "preattn_backward_f32", 39, [512, 512, 2048]),
            ("gated_logits", "gated_logits_forward", 7, [4, 512, 512]),
            ("gated_logits", "gated_logits_backward", 13, [4, 512, 512]),
            ("gated_logits", "gated_logits_forward_f32", 7, [4, 512, 512]),
            ("gated_logits", "gated_logits_backward_f32", 13, [4, 512, 512])):
        for what, (b, tt), offset in (("rows", rows, 0), ("global_bag", far, 2 ** 31 - 1)):
            cases[f"{fn}_{what}"] = (lib, fn, n_ptrs, [b, tt, *shape, 1234, offset, 1 << 30])
    for fn, n_ptrs in (("linear_tok_forward", 4), ("linear_tok_backward", 8)):
        cases[f"{fn}_rows"] = ("linear_tok", fn, n_ptrs, [MAX_TRAIN_ROWS + 1, 2048, 128])
    cases["attn_pool_backward_bags"] = ("attn_pool", "attn_pool_backward", 8,
                                        [MAX_POOL_BAGS + 1, 64, 4, 512, 1])
    out = {}
    for name, (lib, fn, n_ptrs, dims) in cases.items():
        try:
            _build.call_ptrs(lib, fn, [None] * n_ptrs, dims, [1.0], dev)
            out[name] = "accepted"
        except RuntimeError as err:
            out[name] = str(err)
    # row 4's forward takes its dims as C ints (ops/_build.py::launch_split_pool)
    fwd = _build.entry("attn_pool", "attn_pool_forward",
                       [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    try:
        _build._invoke("attn_pool", fwd, [None] * 8 + [MAX_POOL_BAGS + 1, 64, 4, 512, 1], dev)
        out["attn_pool_forward_bags"] = "accepted"
    except RuntimeError as err:
        out["attn_pool_forward_bags"] = str(err)
    torch.cuda.synchronize()
    wrong = {k: v for k, v in out.items() if not v.endswith("cudaError 1")}
    if wrong:
        raise AssertionError(f"per-op kernels past their 32-bit limits not refused: {wrong}")
    return out


def phase_perop_kernels(state):
    """Kernels 15-20 against their plain versions, the per-op chain against
    K6/K7, and their times at the train step's call shape; rows 4-5 and
    15-20 refusing calls past their 32-bit limits (`_check_refusals`)."""
    import torch
    import torch.nn.functional as F
    from madeleine_torch.models.madeleine import train_weights

    gen = np.random.default_rng(SEED + 9)
    real = (0.1, 0.25)

    def operands(stain_encoding=False):
        model = flagship_model(torch, "bfloat16", stain_encoding)
        with torch.no_grad():
            return {k: v.detach().contiguous()
                    for k, v in train_weights(model, torch.bfloat16).items()}

    def inputs(b, t, d=512):
        return torch.from_numpy(gen.standard_normal((b, t, d)).astype(np.float32)).cuda().to(
            torch.bfloat16)

    w = operands()
    checks, firsts, errs = {}, {}, {k: 0.0 for k in PEROP_KERNELS}
    step_calls = None
    for shape in PEROP_SHAPES:
        x = inputs(*shape)
        for rates in ((0.0, 0.0), real):
            where = f"{list(shape)} {rates}"
            calls = _perop_calls(torch, w, x, rates, gen)
            checks[where] = _check_perop(torch, calls, where)
            firsts[where] = _check_first_designs(torch, calls, where)
            if shape == PEROP_STEP_SHAPE and rates == real:
                step_calls = calls
            else:
                del calls
        del x
    # the stain-encoded call: d_in 544 with preattn's dx
    w_se = operands(stain_encoding=True)
    x_se = inputs(*PEROP_STEP_SHAPE, 544)
    se_calls = {"preattn_bwd": _perop_calls(torch, w_se, x_se, real, gen,
                                            need_dx=True)["preattn_bwd"]}
    checks["step_call_544_dx"] = _check_perop(torch, se_calls, "d_in 544")
    firsts["step_call_544_dx"] = _check_first_designs(torch, se_calls, "d_in 544")
    del se_calls, x_se, w_se
    edges = _check_linear_tok_edges(torch, np.random.default_rng(SEED + 19))
    for rep in checks.values():
        for k, r in rep.items():
            errs[k] = max(errs[k], r["max_abs_err"])
    errs["linear_tok_fwd"] = max([errs["linear_tok_fwd"]]
                                 + [r["max_abs_err"] for k, r in edges.items()
                                    if "max_abs_err" in r and not k.startswith("bwd")])
    errs["linear_tok_bwd"] = max([errs["linear_tok_bwd"]]
                                 + [r["max_abs_err"] for k, r in edges.items()
                                    if "max_abs_err" in r and k.startswith("bwd ")])
    # the chain against K6/K7 at the real rates, at 0 (no masks: the rounding
    # floor, reported), and a control whose masks are the next row's, which
    # must miss the pooled and every pre-attention bar
    x = inputs(*PEROP_STEP_SHAPE)
    chain = {"real": _perop_chain_vs_fused(torch, w, x, real, gen),
             "rates_0": _perop_chain_vs_fused(torch, w, x, (0.0, 0.0), gen),
             "control_rows_shifted": _perop_chain_vs_fused(torch, w, x, real, gen,
                                                           chain_offset=1)}
    del x

    # times at the step's call shape, the real rates
    work = _perop_work(*PEROP_STEP_SHAPE, w)
    times = {}
    for name, (kern, plain, args, kw) in step_calls.items():
        ms = cuda_ms(lambda: kern(*args, **kw))
        with torch.no_grad():
            plain_ms = cuda_ms(lambda: plain(*args, **kw), warmup=1, iters=3)
        bound, by = _bound(*work[name])
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "share_of_bound": bound / ms, "gflop": work[name][0] / 1e9,
                       "gb": work[name][1] / 1e9}
        first = _first_designs().get(name)
        if first:   # rows 15-18 and 20: both designs in this call, per call and back to back
            tm = times[name]
            tm["first_design_ms"] = cuda_ms(lambda: first(*args, **kw))
            tm["first_design_share_of_bound"] = bound / tm["first_design_ms"]
            tm["device_ms_back_to_back"] = cuda_ms_back_to_back(lambda: kern(*args, **kw),
                                                                calls=20)
            tm["first_design_device_ms_back_to_back"] = cuda_ms_back_to_back(
                lambda: first(*args, **kw), calls=20)
            tm["tflop_per_s"] = tm["gflop"] / tm["ms"]
            tm["first_design_tflop_per_s"] = tm["gflop"] / tm["first_design_ms"]
    y, wt, bt = step_calls["linear_tok_fwd"][2]
    lt_fwd = step_calls["linear_tok_fwd"][0]
    bt16 = bt.to(torch.bfloat16)
    times["linear_tok_fwd"]["library_ms"] = cuda_ms(lambda: F.linear(y, wt, bt16))
    tm = times["linear_tok_fwd"]
    tm["tb_per_s"], tm["tflop_per_s"] = tm["gb"] / tm["ms"], tm["gflop"] / tm["ms"]
    tm["device_ms_back_to_back"] = cuda_ms_back_to_back(lambda: lt_fwd(y, wt, bt))
    tm["library_device_ms_back_to_back"] = cuda_ms_back_to_back(lambda: F.linear(y, wt, bt16))
    lib_err = (F.linear(y, wt, bt16).float() - step_calls["linear_tok_fwd"][0](y, wt, bt).float()
               ).abs().max().item()
    del step_calls, y, wt, bt, bt16
    for name in PEROP_KERNELS:
        src, replaces = PEROP_SOURCES[name]
        tm = times[name]
        state.setdefault("kernels", {})[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "max_abs_err": errs[name], "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm.get("library_ms")}
    emit({"phase": "perop_kernels", "atol_out": OUT_ATOL, "grad_rtol_fro": GRAD_RTOL,
          "pooled_atol": POOLED_ATOL, "bc_atol": BC_ATOL, "checks": checks,
          "checks_against_first_designs": firsts,
          "pre_chain_rtol_fro": PRE_CHAIN_RTOL, "chain_vs_k6_k7": chain,
          "times_shape": PEROP_STEP_SHAPE, "times": times, "f_linear_vs_kernel_max_abs": lib_err,
          "linear_tok_fwd_edges": edges, "refused_past_32_bit_limits": _check_refusals(torch)})
    failed = ([(where, k) for where, rep in checks.items() for k, r in rep.items()
               if not r["ok"]]
              + [(where, f"{k} against its first design") for where, rep in firsts.items()
                 for k, r in rep.items() if not r["ok"]]
              + [("linear_tok edges", k) for k, r in edges.items() if not r["ok"]])
    control_missed = set(chain["control_rows_shifted"]["failed"])
    if (failed or chain["real"]["failed"]
            or not {"pooled_err"} | set(PRE_KEYS) <= control_missed):
        raise AssertionError(f"perop_kernels: missed their bars: {failed}; the chain against "
                             f"K6/K7: {chain['real']['failed']}; the shifted-mask control "
                             f"missed only {sorted(control_missed)}")


# rows 15-18 with f32 operands (--precision float32 on the per-op lane)
PEROP_F32_KERNELS = ("preattn_fwd_f32", "preattn_bwd_f32", "gated_logits_fwd_f32",
                     "gated_logits_bwd_f32")
# the f32 rows' checked shapes: the step's call and a partial last tile of
# the FFMA GEMM (128 rows) and of the row kernels (64 rows)
PEROP_F32_SHAPES = (PEROP_STEP_SHAPE, (2, 4057))


def _perop_f32_calls(torch, w, x, rates, gen, seed=1234, row_offset=3, need_dx=False):
    """{f32 kernel: (CUDA wrapper, plain version, args, kwargs)} of rows
    15-18 on the f32 x: gated_logits reads preattn's kernel output y; the
    cotangents dy and dl random f32."""
    from madeleine_torch.ops import gated_logits as gl
    from madeleine_torch.ops import preattn as pa

    b, t, _ = x.shape
    pre, gate = rates
    y = pa.preattn_fwd_cuda(x, w, seed, row_offset, pre)

    def randn(*shape):
        return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).cuda()

    dy, dl = randn(b, t, w["w3"].shape[0]), randn(b, t, w["wa"].shape[0])
    return {
        "preattn_fwd_f32": (pa.preattn_fwd_cuda, pa.preattn_fwd_plain,
                            (x, w, seed, row_offset, pre), {}),
        "preattn_bwd_f32": (pa.preattn_bwd_cuda, pa.preattn_bwd_plain,
                            (x, dy, w, seed, row_offset, pre), {"need_dx": need_dx}),
        "gated_logits_fwd_f32": (gl.gated_logits_fwd_cuda, gl.gated_logits_fwd_plain,
                                 (y, w, seed, row_offset, gate), {}),
        "gated_logits_bwd_f32": (gl.gated_logits_bwd_cuda, gl.gated_logits_bwd_plain,
                                 (y, dl, w, seed, row_offset, gate), {}),
    }


def _check_perop_f32(torch, calls, where):
    """Each f32 kernel of `calls` twice (bitwise equal) against its plain
    version: a forward's output within F32_RTOL / F32_ATOL elementwise; a
    backward's dx / dy and every parameter gradient within F32_GRAD_RTOL
    relative Frobenius, bc within BC_ATOL. Returns {kernel: {"max_abs_err",
    "excess" (forward: the largest |err| past its bar) or "grad_rel_fro",
    "ok"}}."""
    rep = {}
    for name, (kern, plain, args, kw) in calls.items():
        got, again = kern(*args, **kw), kern(*args, **kw)
        with torch.no_grad():
            want = plain(*args, **kw)
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, again, want = {"out": got}, {"out": again}, {"out": want}
        if set(got) != set(want) or not all(torch.equal(got[k], again[k]) for k in got) \
                or any(v.dtype != torch.float32 for v in got.values()):
            raise AssertionError(f"{name} {where}: two launches differ, or outputs "
                                 f"{ {k: v.dtype for k, v in got.items()} }")
        if not all(torch.isfinite(v).all() for v in got.values()):
            raise AssertionError(f"{name} {where}: non-finite output")
        r = {"max_abs_err": max((got[k] - want[k]).abs().max().item() for k in got)}
        if name.startswith(("preattn_fwd", "gated_logits_fwd")):
            r["excess"] = _f32_excess(torch, got["out"], want["out"])
            r["ok"] = r["excess"] <= 0
        else:
            r["grad_rel_fro"] = {k: _rel_fro(got[k], want[k]) for k in got if k != "bc"}
            r["ok"] = max(r["grad_rel_fro"].values()) <= F32_GRAD_RTOL
            if "bc" in got:
                r["bc_max_abs_err"] = (got["bc"] - want["bc"]).abs().max().item()
                r["ok"] = r["ok"] and r["bc_max_abs_err"] <= BC_ATOL
        rep[name] = r
        del got, again, want
    return rep


def _perop_f32_chain_vs_fused(torch, w, x, rates, gen, seed=99, row_offset=65,
                              chain_offset=0):
    """The f32 per-op chain (rows 15 -> 17 -> the plain softmax pool, the
    token projector's plain f32 product; backward rows 18 -> 16 through
    autograd; rows from row_offset + chain_offset) against K6/K7 with f32
    operands (rows from row_offset) on the same x, weights and seed, with a
    random pooled cotangent and dtok: pooled and tokens within F32_RTOL /
    F32_ATOL, every gradient within F32_GRAD_RTOL relative Frobenius, bc
    (exactly 0: softmax is shift invariant) within BC_ATOL on both sides.
    Returns the errors and the keys that miss their bars."""
    import torch.nn.functional as F
    from madeleine_torch.ops import encoder_train as et
    from madeleine_torch.ops import gated_logits as gl
    from madeleine_torch.ops import preattn as pa
    from madeleine_torch.ops.attn_pool import softmax_pool_plain

    b, t, _ = x.shape
    nh, _, e = w["wa"].shape
    bias = et.token_mask_bias(None, b, t, "cuda")
    pooled32, m, s, tok, l, saved = et.encoder_train_fwd_cuda(x, bias, w, seed, row_offset,
                                                              *rates)
    G = torch.from_numpy(gen.standard_normal((b, nh * e)).astype(np.float32)).cuda()
    DT = torch.from_numpy(gen.standard_normal((b, t, w["wt"].shape[0])).astype(np.float32)
                          ).cuda()
    inner = (G * pooled32).reshape(b, nh, e).sum(-1)
    k7 = et.encoder_train_bwd_cuda(x, l, m, s, G, inner, DT, saved, w, seed, row_offset, *rates)
    del saved
    ro = row_offset + chain_offset
    wl = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    with torch.enable_grad():
        y = pa.preattn_train(x, wl, seed, ro, rates[0])
        logits = gl.gated_logits_train(y, wl, seed, ro, rates[1])
        pooled = softmax_pool_plain(logits, y.reshape(b, t, nh, e)).reshape(b, -1)
        tok_c = F.linear(y, wl["wt"], wl["bt"])
        ((pooled * G).sum() + (tok_c * DT).sum()).backward()
    torch.cuda.synchronize()
    rep = {"pooled_excess": _f32_excess(torch, pooled.detach(), pooled32),
           "pooled_err": (pooled.detach() - pooled32).abs().max().item(),
           "tok_excess": _f32_excess(torch, tok_c.detach(), tok),
           "grad_rel_fro": {k: _rel_fro(wl[k].grad, k7[k]) for k in w if k != "bc"},
           "chain_bc_max_abs": wl["bc"].grad.abs().max().item(),
           "k7_bc_max_abs": k7["bc"].abs().max().item()}
    rep["failed"] = ([k for k, v in rep["grad_rel_fro"].items() if not v <= F32_GRAD_RTOL]
                     + [k for k in ("pooled_excess", "tok_excess") if not rep[k] <= 0]
                     + [k for k in ("chain_bc_max_abs", "k7_bc_max_abs")
                        if not rep[k] <= BC_ATOL])
    return rep


def phase_perop_kernels_f32(state):
    """Rows 15-18 with f32 operands (the per-op lane at --precision float32)
    against their plain versions on the card, with the flagship weights in
    f32: at the train step's call shape [65, 2048] and at a ragged M (2 x
    4057: partial last tiles), rates 0 and the real (0.1, 0.25), and row 16
    with dx at d_in 544 (the stain-encoded call); outputs within rtol 1e-4
    / atol 1e-5, every gradient, dx and dy within 1e-4 relative Frobenius,
    bc within BC_ATOL, two launches bitwise equal. The f32 per-op chain
    (15 -> 17 -> softmax pool; 18 -> 16) against K6/K7 f32 on the same
    operands and seed at the same bars, with a shifted-mask control that
    must miss them. Each kernel timed at [65, 2048] beside its bound at the
    FP32 FMA peak, its plain version's time and back to back."""
    import torch
    from madeleine_torch.models.madeleine import train_weights

    gen = np.random.default_rng(SEED + 23)
    real = (0.1, 0.25)

    def operands(stain_encoding=False):
        model = flagship_model(torch, "float32", stain_encoding)
        with torch.no_grad():
            return {k: v.detach().contiguous()
                    for k, v in train_weights(model, torch.float32).items()}

    def inputs(b, t, d=512):
        return torch.from_numpy(gen.standard_normal((b, t, d)).astype(np.float32)).cuda()

    w = operands()
    checks, step_calls = {}, None
    for shape in PEROP_F32_SHAPES:
        x = inputs(*shape)
        for rates in ((0.0, 0.0), real):
            where = f"{list(shape)} {rates}"
            calls = _perop_f32_calls(torch, w, x, rates, gen)
            checks[where] = _check_perop_f32(torch, calls, where)
            if shape == PEROP_STEP_SHAPE and rates == real:
                step_calls = calls
            del calls
        del x
    w_se = operands(stain_encoding=True)
    x_se = inputs(*PEROP_STEP_SHAPE, 544)
    se_calls = {"preattn_bwd_f32": _perop_f32_calls(torch, w_se, x_se, real, gen,
                                                    need_dx=True)["preattn_bwd_f32"]}
    checks["step_call_544_dx"] = _check_perop_f32(torch, se_calls, "d_in 544")
    del se_calls, x_se, w_se
    x = inputs(*PEROP_STEP_SHAPE)
    chain = {"real": _perop_f32_chain_vs_fused(torch, w, x, real, gen),
             "rates_0": _perop_f32_chain_vs_fused(torch, w, x, (0.0, 0.0), gen),
             "control_rows_shifted": _perop_f32_chain_vs_fused(torch, w, x, real, gen,
                                                               chain_offset=1)}
    del x
    work = {f"{k}_f32": v for k, v in _perop_work(*PEROP_STEP_SHAPE, w).items()}
    times = {}
    for name, (kern, plain, args, kw) in step_calls.items():
        ms = cuda_ms(lambda: kern(*args, **kw), iters=5)
        with torch.no_grad():
            plain_ms = cuda_ms(lambda: plain(*args, **kw), warmup=1, iters=1)
        bound, by = _bound(*work[name], PEAK_FP32)
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "share_of_bound": bound / ms, "tflop_per_s": work[name][0] / ms / 1e9,
                       "device_ms_back_to_back": cuda_ms_back_to_back(
                           lambda: kern(*args, **kw), warmup=1, calls=5)}
    del step_calls
    torch.cuda.empty_cache()
    errs = {k: max(rep[k]["max_abs_err"] for rep in checks.values() if k in rep)
            for k in PEROP_F32_KERNELS}
    src = dict(PEROP_SOURCES)
    for name in PEROP_F32_KERNELS:
        source, replaces = src[name[:-4]]
        tm = times[name]
        state.setdefault("kernels", {})[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": errs[name], "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"], "library_ms": None,
            "operand_dtype": "float32", "shape": list(PEROP_STEP_SHAPE)}
    emit({"phase": "perop_kernels_f32", "smi": state["smi"], "rtol": F32_RTOL, "atol": F32_ATOL,
          "grad_rtol_fro": F32_GRAD_RTOL, "bc_atol": BC_ATOL, "checks": checks,
          "chain_vs_k6_k7_f32": chain, "times_shape": PEROP_STEP_SHAPE, "times": times,
          "peak_tflops_fp32": PEAK_FP32 / 1e12})
    failed = [(where, k) for where, rep in checks.items() for k, r in rep.items() if not r["ok"]]
    control_missed = set(chain["control_rows_shifted"]["failed"])
    if (failed or chain["real"]["failed"] or chain["rates_0"]["failed"]
            or not {"pooled_excess"} | set(PRE_KEYS) <= control_missed):
        raise AssertionError(f"perop_kernels_f32: missed their bars: {failed}; the chain "
                             f"against K6/K7 f32: {chain['real']['failed']} (rates 0: "
                             f"{chain['rates_0']['failed']}); the shifted-mask control missed "
                             f"only {sorted(control_missed)}")


def phase_perop_bwd_digest(state):
    """A sha256 of every output of kernels 16 and 18 at the train step's
    call shape, flagship weights, seeded inputs (y random, not kernel 15's
    output), rates 0 and (0.1, 0.25). Nothing is checked here: run in two
    checkouts (this script copied to the other), the digests show whether
    their backward kernels agree bit for bit."""
    import torch
    from madeleine_torch.models.madeleine import train_weights
    from madeleine_torch.ops import gated_logits as gl
    from madeleine_torch.ops import preattn as pa

    model = flagship_model(torch, "bfloat16")
    with torch.no_grad():
        w = {k: v.detach().contiguous() for k, v in train_weights(model, torch.bfloat16).items()}
    del model
    gen = np.random.default_rng(SEED + 21)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).cuda().to(dtype)

    b, t = PEROP_STEP_SHAPE
    E, nh = w["w3"].shape[0], w["wa"].shape[0]
    x, dy, y = randn(b, t, w["w1"].shape[1]), randn(b, t, E), randn(b, t, E)
    dl = randn(b, t, nh, dtype=torch.float32)
    digests = {}
    for rates in ((0.0, 0.0), (0.1, 0.25)):
        for name, out in (("preattn_bwd", pa.preattn_bwd_cuda(x, dy, w, 7, 3, rates[0])),
                          ("gated_logits_bwd",
                           gl.gated_logits_bwd_cuda(y, dl, w, 7, 3, rates[1]))):
            h = hashlib.sha256()
            for k in sorted(out):
                h.update(k.encode())
                h.update(out[k].contiguous().view(torch.uint8).cpu().numpy().tobytes())
            digests[f"{name} {list(rates)}"] = h.hexdigest()
    emit({"phase": "perop_bwd_digest", "shape": list(PEROP_STEP_SHAPE), "seed": 7,
          "row_offset": 3, "sha256": digests})


def phase_golden(state):
    import torch
    from madeleine_torch.models.factory import create_model_from_pretrained
    from madeleine_torch.models.madeleine import encode, encode_he, forward_train

    gold = np.load(os.path.join(HERE, "tests", "golden", "golden_flagship.npz"))
    x = torch.from_numpy(gold["fs/encode_he/in"]).cuda()
    want = gold["fs/encode_he/out"]
    out = {"phase": "golden"}
    start = read_counts()
    with tempfile.TemporaryDirectory() as root:
        for precision, dtype, kernel in (("float32", torch.float32, "gated_pool"),
                                         ("bfloat16", torch.bfloat16, "encode_fused")):
            d = write_model_dir(os.path.join(root, precision), precision)
            cfg, model, cdt = create_model_from_pretrained(d, download=False, device="cuda")
            if cdt != dtype:
                raise AssertionError(f"golden {precision}: compute dtype {cdt}")
            before = read_counts()[kernel]
            got = encode_he(model, x.to(dtype)).float().cpu().numpy()
            launched = read_counts()[kernel] - before
            if launched < 1:
                raise AssertionError(f"golden {precision}: {kernel} was not launched")
            rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (0.0, 3e-2)
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=f"golden {precision}")
            out[precision] = {"kernel": kernel, "max_abs_err": float(np.abs(got - want).max()),
                              "rtol": rtol, "atol": atol}
        # stain codes 3 and 1 (d_in 544) through K2 in f32 and K1 in bf16
        x_se = torch.from_numpy(gold["se/eval/in"][:, 0]).cuda()
        for precision, dtype, kernel in (("float32", torch.float32, "gated_pool"),
                                         ("bfloat16", torch.bfloat16, "encode_fused")):
            d = write_model_dir(os.path.join(root, "se_" + precision), precision, True)
            _, model, _ = create_model_from_pretrained(d, download=False, device="cuda")
            rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (0.0, 3e-2)
            rec = {"kernel": kernel, "rtol": rtol, "atol": atol, "d_in": model.cfg.input_dim}
            for idx in (3, 1):
                before = read_counts()[kernel]
                got = encode(model, x_se.to(dtype), stain_idx=idx).float().cpu().numpy()
                if read_counts()[kernel] - before < 1:
                    raise AssertionError(f"golden se/eval/{idx} {precision}: {kernel} was not "
                                         "launched")
                want = gold[f"se/eval/{idx}"].squeeze(1)
                np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                           err_msg=f"golden se/eval/{idx} {precision}")
                rec[f"max_abs_err_stain_{idx}"] = float(np.abs(got - want).max())
            out[f"se_eval_{precision}"] = rec
    # K1 and K2 by their new designs only
    _check_off_path({k: v - start[k] for k, v in read_counts().items()}, "golden")
    # the eval forward in f32 (K3 for every modality's pool) against the
    # reference model's activations, without and with stain encodings
    for prefix, se in (("fs", False), ("se", True)):
        model = flagship_model(torch, "float32", se)
        feats = torch.from_numpy(gold[f"{prefix}/train/in"]).cuda()
        before = read_counts()["attn_pool"]
        slide, tok = forward_train(model, feats, train=False)
        launched = read_counts()["attn_pool"] - before
        if launched != model.cfg.n_modalities:
            raise AssertionError(f"golden {prefix}/train: attn_pool launched {launched} times")
        errs = []
        for idx, mod in enumerate(model.cfg.MODALITIES):
            for got, key in ((slide[:, idx], "wsi"), (tok[:, idx], "tok")):
                want = gold[f"{prefix}/train/{key}/{mod}"]
                want = want[..., 0] if mod == "HE" else want
                got = got.float().cpu().numpy()
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                           err_msg=f"golden {prefix}/train/{key}/{mod}")
                errs.append(float(np.abs(got - want).max()))
        out[f"{prefix}_train_eval_forward_float32"] = {
            "kernel": "attn_pool", "launches": launched, "max_abs_err": max(errs),
            "rtol": 1e-4, "atol": 1e-5}
    emit(out)


def phase_serve(state):
    import torch
    from http.server import ThreadingHTTPServer
    from madeleine_torch.models.factory import create_model_from_pretrained
    from madeleine_torch.models.madeleine import encode_he
    from madeleine_torch.serve.server import EmbeddingService, make_handler

    gen = np.random.default_rng(SEED + 1)
    lengths = [300, 9000, 450, 1000, 1800, 2047, 2600, 3900, 5000, 700, 8000, 1200,
               4100, 333, 6500, 999]
    bags = [gen.standard_normal((n, 512)).astype(np.float32) for n in lengths]
    with tempfile.TemporaryDirectory() as root:
        d = write_model_dir(root, "bfloat16")
        _, model, _ = create_model_from_pretrained(d, download=False, device="cuda")
    svc = EmbeddingService(model, max_batch=32, max_wait_ms=50.0, device="cuda")
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    results = [None] * len(bags)

    def post(i):
        buf = io.BytesIO()
        np.savez(buf, features=bags[i])
        req = urllib.request.Request(url + "/encode", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            results[i] = np.asarray(json.loads(r.read())["embedding"], np.float32)

    try:
        svc.encode(bags[0])  # first call: allocator warm-up, not timed
        with svc._stats_lock:
            svc._latencies.clear()
        reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bags))]
        for th_ in threads:
            th_.start()
        for th_ in threads:
            th_.join()
        wall = time.perf_counter() - t0
        counts = read_counts()
        stats = svc.stats()
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    if counts["encode_fused"] < 1:
        raise AssertionError(f"serve: encode_fused was not launched ({counts})")
    _check_off_path(counts, "serve")
    state["launches_serve"] = counts
    max_err = 0.0
    for bag, got in zip(bags, results):
        if got is None:
            raise AssertionError("serve: a request got no answer")
        want = encode_he(model, torch.from_numpy(bag)[None].cuda().to(torch.bfloat16))
        want = want.float().cpu().numpy()[0]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg="serve vs direct")
        max_err = max(max_err, float(np.abs(got - want).max()))
    emit({"phase": "serve", "requests": len(bags), "buckets": sorted({svc._bucket_of(n)
                                                                       for n in lengths}),
          "wall_s": wall, "slides_per_s": len(bags) / wall,
          "latency_p50_ms": stats["latency_p50_ms"], "latency_p95_ms": stats["latency_p95_ms"],
          "batches": stats["batches"], "launches": counts, "max_abs_err_vs_direct": max_err,
          "healthz": health["status"]})


EXTRACT_SLIDES = 16
COHORT_PATCH = 256   # the extract cohort's patch pitch in level-0 px (its coords)


def write_extract_cohort(cohort: str):
    """The extract phase's cohort: 16 .npz bags of 300-9000 N(0, 1) 512-d
    tokens under <cohort>/patch_embeddings, each with coords, distinct
    cells of a square grid at a 256-px pitch (from their own generator,
    so that the features are those the phase always had). Returns the
    lengths."""
    gen, cgen = np.random.default_rng(SEED + 2), np.random.default_rng(SEED + 12)
    lengths = [int(n) for n in gen.integers(300, 9000, size=EXTRACT_SLIDES)]
    bag_dir = os.path.join(cohort, "patch_embeddings")
    os.makedirs(bag_dir)
    for i, n in enumerate(lengths):
        side = int(np.ceil(np.sqrt(1.3 * n)))
        cells = cgen.choice(side * side, n, replace=False)
        np.savez(os.path.join(bag_dir, f"slide_{i:02d}.npz"),
                 features=gen.standard_normal((n, 512)).astype(np.float32),
                 coords=np.stack([cells % side, cells // side], 1).astype(np.int64) * COHORT_PATCH)
    return lengths


def phase_extract(state):
    """The extraction CLI over one cohort twice: with an f32 model (the
    parity route, K2) and a bf16 one (K1's live-tile route)."""
    from madeleine_torch.cli import extract_slide_embeddings
    from madeleine_torch.utils.file_utils import load_pkl

    runs = {}
    with tempfile.TemporaryDirectory() as root:
        lengths = write_extract_cohort(os.path.join(root, "cohort"))
        reset_counts()
        for precision, kernel in (("float32", "gated_pool"), ("bfloat16", "encode_fused")):
            write_model_dir(os.path.join(root, precision), precision)
            before = read_counts()
            t0 = time.perf_counter()
            pkl = extract_slide_embeddings.main([
                "--local_dir", os.path.join(root, "cohort"),
                "--model_dir", os.path.join(root, precision), "--no_download",
                "--device", "cuda"])
            wall = time.perf_counter() - t0
            after = read_counts()
            res = load_pkl(pkl)
            launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
            if launched.get(kernel, 0) < 1:
                raise AssertionError(f"extract {precision}: {kernel} was not launched "
                                     f"({launched})")
            emb, ids = res["embeds"], res["slide_ids"]
            if set(res) != {"embeds", "slide_ids"} or emb.shape != (16, 512) \
                    or sorted(ids) != [f"slide_{i:02d}" for i in range(16)] \
                    or not np.isfinite(emb).all():
                raise AssertionError(f"extract {precision}: bad pkl {set(res)} {emb.shape} {ids}")
            runs[precision] = {"wall_s": wall, "slides_per_s": len(ids) / wall,
                               "launches": launched}
        counts = read_counts()
    _check_off_path(counts, "extract")
    state["launches_extract"] = counts
    emit({"phase": "extract", "slides": len(lengths), "lengths": lengths, "runs": runs,
          "launches": counts})


MEAN_ATOL = 1e-6     # extract_mean_embs' f32 means on the card against numpy's


def _quiet(fn, *args, **kw):
    """fn's result, its standard output (the CLIs' progress lines) kept from
    the script's."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def phase_downstream(state):
    """The downstream CLIs over the extract phase's cohort (with coords):
    the extraction CLI with the bf16 model (K1), extract_mean_embs, and
    extract_attention_maps with the bf16 and the f32 model."""
    import torch
    from madeleine_torch.cli import (extract_attention_maps, extract_mean_embs,
                                     extract_slide_embeddings)
    from madeleine_torch.data.io import load_coords, load_features
    from madeleine_torch.eval.heatmap import png_size
    from madeleine_torch.utils.file_utils import load_pkl

    with tempfile.TemporaryDirectory() as root:
        cohort = os.path.join(root, "cohort")
        lengths = write_extract_cohort(cohort)
        bag_dir = os.path.join(cohort, "patch_embeddings")
        ids = [f"slide_{i:02d}" for i in range(EXTRACT_SLIDES)]
        for precision in ("bfloat16", "float32"):
            write_model_dir(os.path.join(root, precision), precision)
        reset_counts()
        t0 = time.perf_counter()
        emb = load_pkl(_quiet(extract_slide_embeddings.main, [
            "--local_dir", cohort, "--model_dir", os.path.join(root, "bfloat16"),
            "--no_download", "--device", "cuda"]))
        extract_s = time.perf_counter() - t0
        if sorted(emb["slide_ids"]) != ids or not np.isfinite(emb["embeds"]).all():
            raise AssertionError(f"downstream: extraction wrote {emb['slide_ids']}")

        t0 = time.perf_counter()
        means = load_pkl(_quiet(extract_mean_embs.main, ["--local_dir", cohort,
                                                         "--device", "cuda"]))
        mean_s = time.perf_counter() - t0
        want = np.stack([load_features(os.path.join(bag_dir, f"{sid}.npz")).mean(axis=0)
                         for sid in ids])
        mean_err = float(np.abs(means["embeds"] - want).max())
        if set(means) != {"embeds", "slide_ids"} or means["slide_ids"] != ids \
                or means["embeds"].dtype != np.float32 or not mean_err <= MEAN_ATOL:
            raise AssertionError(f"downstream: mean embeddings {means['slide_ids']} "
                                 f"{means['embeds'].dtype}, error {mean_err} > {MEAN_ATOL}")

        maps, map_s = {}, {}
        for precision in ("bfloat16", "float32"):
            t0 = time.perf_counter()
            maps[precision] = _quiet(extract_attention_maps.main, [
                "--local_dir", cohort, "--model_dir", os.path.join(root, precision),
                "--no_download", "--device", "cuda",
                "--out_dir", os.path.join(root, f"maps_{precision}")])
            map_s[precision] = time.perf_counter() - t0
        counts = read_counts()
        sizes, rel = {}, {}
        for sid, n in zip(ids, lengths):
            coords = load_coords(os.path.join(bag_dir, f"{sid}.npz")) // COHORT_PATCH
            cells = coords.max(axis=0) - coords.min(axis=0) + 1          # cols, rows
            for precision, out in maps.items():
                raw = out["logits"][sid]
                if raw.shape != (n, 4) or not np.isfinite(raw).all():
                    raise AssertionError(f"downstream: {precision} logits of {sid} {raw.shape}")
                got = png_size(out["maps"][sid])
                if got != (int(cells[0]) * 8, int(cells[1]) * 8):
                    raise AssertionError(f"downstream: {out['maps'][sid]} is {got}, the grid "
                                         f"{cells.tolist()} of 8-px cells")
            sizes[sid] = os.path.getsize(maps["bfloat16"]["maps"][sid])
            rel[sid] = _rel_fro(torch.from_numpy(maps["bfloat16"]["logits"][sid]),
                                torch.from_numpy(maps["float32"]["logits"][sid]))
    if counts["encode_fused"] < 1:
        raise AssertionError(f"downstream: encode_fused was not launched ({counts})")
    _check_off_path(counts, "downstream")
    state["launches_downstream"] = counts
    worst = max(rel.values())
    emit({"phase": "downstream", "slides": EXTRACT_SLIDES, "tokens": sum(lengths),
          "extract_s": extract_s, "mean_embs_s": mean_s,
          "mean_embs_s_per_slide": mean_s / EXTRACT_SLIDES, "mean_max_abs_err": mean_err,
          "mean_atol": MEAN_ATOL, "attention_maps_s": map_s,
          "attention_maps_s_per_slide": {k: v / EXTRACT_SLIDES for k, v in map_s.items()},
          "png_bytes": sizes, "logits_bf16_vs_f32_rel_fro_max": worst,
          "rel_fro_bar": EVAL_REL_FRO, "launches": counts})
    if not worst <= EVAL_REL_FRO:
        raise AssertionError(f"downstream: bf16 attention logits against f32's {rel}")


PROBE_CSV = os.path.join("dataset_csv", "BCNB", "BCNB.csv")
PROBE_TASKS = ("er", "pr", "her2")
PROBE_SHIFT = 2.0     # a label's shift of the embedding along its task's unit direction
PROBE_TOL = 1e-9      # the card's fits against the CPU's: float64 probabilities, metrics
PROBE_MODULES = ("sklearn", "PIL", "cv2", "h5py", "openslide")


def _importable(names):
    """{name: whether `import name` succeeds}, in a fresh interpreter."""
    code = ("import importlib, json\nout = {}\n"
            f"for n in {list(names)!r}:\n"
            "    try:\n        importlib.import_module(n)\n        out[n] = True\n"
            "    except Exception:\n        out[n] = False\n"
            "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def write_probe_embeddings(path: str):
    """512-d embeddings for every slide of BCNB.csv: N(0, 1) from SEED, plus
    PROBE_SHIFT along a unit direction per task whose label is 1."""
    with open(os.path.join(HERE, PROBE_CSV), newline="") as f:
        rows = list(csv.DictReader(f))
    gen = np.random.default_rng(SEED + 11)
    emb = gen.standard_normal((len(rows), 512))
    dirs = gen.standard_normal((len(PROBE_TASKS), 512))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for j, task in enumerate(PROBE_TASKS):
        emb += PROBE_SHIFT * np.array([r[task] == "1" for r in rows])[:, None] * dirs[j]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"embeds": emb.astype(np.float32),
                     "slide_ids": [r["slide_id"] for r in rows]}, f)
    return len(rows)


def phase_probe(state):
    """The linear probe at BCNB's scale through the CLI's main: 3 k x 3
    tasks x 10 folds on the card, then the same code on the CPU."""
    import torch
    from madeleine_torch.cli import run_linear_probing

    emit({"phase": "probe_imports", "importable": _importable(PROBE_MODULES)})
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        for device in ("cuda", "cpu"):
            pkl = os.path.join(root, device, "madeleine_slide_embeddings.pkl")
            n_slides = write_probe_embeddings(pkl)
            record = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = _quiet(run_linear_probing.main, [
                "--slide_embedding_pkl", pkl, "--label_path", os.path.join(HERE, PROBE_CSV),
                "--device", device], record=record)
            wall = time.perf_counter() - t0
            written = sorted(os.listdir(os.path.join(root, device, "res_linear_probing",
                                                     "madeleine_slide_embeddings")))
            runs[device] = {"metrics": metrics, "record": record, "wall_s": wall,
                            "pickles": written}
    card, cpu = runs["cuda"], runs["cpu"]
    fits = len(card["record"])
    if fits != 90 or len(cpu["record"]) != fits or len(card["pickles"]) != 9:
        raise AssertionError(f"probe: {fits} fits on the card, {len(cpu['record'])} on the "
                             f"CPU, pickles {card['pickles']}")
    proba_err = 0.0
    for a, b in zip(card["record"], cpu["record"]):
        if (a["k"], a["task"], a["fold"]) != (b["k"], b["task"], b["fold"]) \
                or a["train_ids"] != b["train_ids"] or a["test_ids"] != b["test_ids"]:
            raise AssertionError(f"probe: the split of {a['k'], a['task'], a['fold']} differs")
        proba_err = max(proba_err, float(np.abs(a["proba"] - b["proba"]).max()))
    store_err = 0.0
    for key, store in card["metrics"].items():
        for m, v in store.items():
            w = cpu["metrics"][key][m]
            if len(v) != len(w):
                raise AssertionError(f"probe: {key} {m} has {len(v)} folds, the CPU's {len(w)}")
            if v:
                store_err = max(store_err, float(np.nanmax(np.abs(np.subtract(v, w)))))
    by_k = {k: [r["seconds"] * 1e3 for r in card["record"] if r["k"] == k]
            for k in (1, 10, 25)}
    emit({"phase": "probe", "csv": PROBE_CSV, "slides": n_slides, "fits": fits,
          "wall_s": card["wall_s"], "wall_s_cpu": cpu["wall_s"],
          "ms_per_fit_by_k": {k: statistics.median(v) for k, v in by_k.items()},
          "ms_per_fit_by_k_cpu": {k: statistics.median(
              r["seconds"] * 1e3 for r in cpu["record"] if r["k"] == k) for k in by_k},
          "newton_steps_max": max(r["newton_steps"] for r in card["record"]),
          "auc_mean": {f"k={k} {t}": float(np.mean(card["metrics"][(k, t)]["auc"]))
                       for k in (1, 10, 25) for t in PROBE_TASKS},
          "proba_max_abs_diff_vs_cpu": proba_err, "store_max_abs_diff_vs_cpu": store_err,
          "tol": PROBE_TOL})
    if not (proba_err <= PROBE_TOL and store_err <= PROBE_TOL):
        raise AssertionError(f"probe: card against CPU: probabilities {proba_err}, "
                             f"metric stores {store_err} > {PROBE_TOL}")


EVAL_REL_FRO = 2e-2   # bf16 eval forward against the f32 model's: a few bf16 roundings
EVAL_CHECK_CASES = 4


def phase_eval_forward(state):
    """forward_train(train=False) at full width in bf16: the MLP and gates
    as plain PyTorch, each modality's pool in K3; then with n_views=3, the
    half-bag views' pools in K3 too."""
    import torch
    from madeleine_torch.models.madeleine import forward_train

    cfg = train_path_config()
    model = flagship_model(torch, "bfloat16")
    feats = synthetic_train_batch(torch, cfg, SEED + 8)["feats"]
    forward_train(model, feats, train=False)            # allocator warm-up, not counted
    torch.cuda.synchronize()
    reset_counts()
    slide, tok = forward_train(model, feats, train=False)
    torch.cuda.synchronize()
    counts = read_counts()
    state["launches_eval_forward"] = counts
    n_mod = cfg.n_modalities
    if counts["attn_pool"] != n_mod:
        raise AssertionError(f"eval_forward: attn_pool launched {counts['attn_pool']} times, "
                             f"not once per modality ({counts})")
    bs, t = cfg.batch_size, cfg.n_subsamples
    if tuple(slide.shape) != (bs, n_mod, 1, cfg.embed_dim) \
            or tuple(tok.shape) != (bs, n_mod, t, cfg.token_proj_dim) \
            or not (torch.isfinite(slide.float()).all() and torch.isfinite(tok.float()).all()):
        raise AssertionError(f"eval_forward: outputs {tuple(slide.shape)} {tuple(tok.shape)}")
    ms = cuda_ms(lambda: forward_train(model, feats, train=False), warmup=1, iters=5)
    k3_ms = state.get("kernels", {}).get("attn_pool", {}).get("ms")
    # the first cases against the f32 model's eval forward on the same feats
    model32 = flagship_model(torch, "float32")
    x = feats[:EVAL_CHECK_CASES]
    want_s, want_t = forward_train(model32, x.float(), train=False)
    errs = {"slide_rel_fro": _rel_fro(slide[:EVAL_CHECK_CASES].float(), want_s),
            "tokens_rel_fro": _rel_fro(tok[:EVAL_CHECK_CASES].float(), want_t)}
    # n_views=3: the whole bag and the two half-bag views of half_split(0, t),
    # every pool in K3 (its own run: the counts set to 0 just before it)
    reset_counts()
    views, _ = forward_train(model, feats, train=False, n_views=3)
    torch.cuda.synchronize()
    counts3 = read_counts()
    state["launches_eval_forward"] = {k: counts[k] + counts3[k] for k in counts}
    if counts3["attn_pool"] != 3 * n_mod:
        raise AssertionError(f"eval_forward n_views=3: attn_pool launched "
                             f"{counts3['attn_pool']} times, not 3 per modality ({counts3})")
    if tuple(views.shape) != (bs, n_mod, 3, cfg.embed_dim) \
            or not torch.isfinite(views.float()).all():
        raise AssertionError(f"eval_forward n_views=3: outputs {tuple(views.shape)}")
    whole_equal = bool(torch.equal(views[:, :, :1], slide))
    ms3 = cuda_ms(lambda: forward_train(model, feats, train=False, n_views=3), warmup=1, iters=5)
    want_v, _ = forward_train(model32, x.float(), train=False, n_views=3)
    errs["views_rel_fro"] = _rel_fro(views[:EVAL_CHECK_CASES].float(), want_v)
    emit({"phase": "eval_forward", "batch": list(feats.shape), "launches": counts,
          "ms": ms, "k3_ms_per_call": k3_ms,
          "k3_share": None if k3_ms is None else n_mod * k3_ms / ms,
          "n_views_3": {"ms": ms3, "launches": {k: v for k, v in counts3.items() if v},
                        "whole_view_equals_n_views_1": whole_equal},
          "vs_f32_cases": EVAL_CHECK_CASES, "rel_fro_bar": EVAL_REL_FRO, **errs})
    if not max(errs.values()) <= EVAL_REL_FRO:
        raise AssertionError(f"eval_forward: bf16 against f32 {errs} > {EVAL_REL_FRO}")
    if not whole_equal:
        raise AssertionError("eval_forward: the n_views=3 whole-bag view differs from n_views=1")


VIT_TILES = 256       # tiles per batch
VIT_TILE_PX = 256     # the tiles' side: resized on the card to the tower's 224
VIT_CHECK_TILES = 4   # the f32 card run against the f32 CPU run on these
VIT_F32_REL = 1e-4    # relative Frobenius, card against CPU (f32)
VIT_BF16_REL = 2e-2   # relative Frobenius, bf16 against f32 on the card
VIT_RUNS = 5


def _vit_work(cfg, n, elem):
    """(FLOPs, bytes) of the tower on n images of `elem`-byte values: its
    products (2 per multiply-add); the images and each weight read once,
    the features written once."""
    s, w, mlp = cfg.seq_len, cfg.width, int(cfg.width * cfg.mlp_ratio)
    per_layer = 2 * s * (3 * w * w + w * w + 2 * w * mlp) + 2 * 2 * s * s * w
    flops = n * (cfg.layers * per_layer + 2 * (s - 1) * cfg.patch_size ** 2 * 3 * w
                 + 2 * w * (cfg.out_dim or 0))
    params = cfg.layers * (4 * w * w + 2 * w * mlp) + cfg.patch_size ** 2 * 3 * w
    nbytes = elem * (params + n * cfg.image_size ** 2 * 3) + 4 * n * (cfg.out_dim or w)
    return flops, nbytes


def phase_vit(state):
    """The ViT-B/16 tile tower (the JAX package's default ViTConfig) with
    random weights from SEED through TorchViTEncoder: 256 uint8 tiles of
    256 x 256 a batch, end to end from the host (H2D, resize, normalise,
    tower) in f32 and bf16."""
    import copy

    import torch
    from madeleine_torch.preprocessing.vit import (TorchViTEncoder, ViTConfig,
                                                   VisionTransformer, init_vit)

    cfg = ViTConfig()
    model = init_vit(VisionTransformer(cfg), torch.Generator().manual_seed(SEED))
    tiles = np.random.default_rng(SEED + 13).integers(
        0, 256, (VIT_TILES, VIT_TILE_PX, VIT_TILE_PX, 3), dtype=np.uint8)
    out, runs = {}, {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        enc = TorchViTEncoder(cfg, copy.deepcopy(model), dtype=dtype, device="cuda")
        enc(tiles)   # first call: allocator and library warm-up, not timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(VIT_RUNS):
            t0 = time.perf_counter()
            out[name] = enc(tiles)
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        host = torch.from_numpy(tiles)
        dev = host.cuda()
        x = enc.preprocess(dev)
        with torch.no_grad():
            tower = cuda_ms(lambda: enc.model(x), warmup=1, iters=VIT_RUNS)
        pre = cuda_ms(lambda: enc.preprocess(dev), warmup=1, iters=VIT_RUNS)
        h2d = cuda_ms(lambda: host.cuda(), warmup=1, iters=VIT_RUNS)
        ms = statistics.median(times)
        peak_flops = PEAK_FP32 if dtype == torch.float32 else PEAK_BF16
        flops, nbytes = _vit_work(cfg, VIT_TILES, 4 if dtype == torch.float32 else 2)
        bound, bound_by = _bound(flops, nbytes, peak_flops)
        runs[name] = {"ms_per_batch": ms, "ms_runs": times, "tiles_per_s": VIT_TILES / ms * 1e3,
                      "tower_ms": tower, "tower_share": tower / ms, "preprocess_ms": pre,
                      "h2d_ms": h2d, "peak_gb": peak, "tower_tflops": flops / tower / 1e9,
                      "tower_bound_ms": bound, "tower_bound_by": bound_by,
                      "tower_bound_share": bound / tower}
        del enc, x, dev
        torch.cuda.empty_cache()
    cpu = TorchViTEncoder(cfg, copy.deepcopy(model), device="cpu")(tiles[:VIT_CHECK_TILES])
    if out["f32"].shape != (VIT_TILES, cfg.out_dim) or not np.isfinite(out["f32"]).all() \
            or not np.isfinite(out["bf16"]).all():
        raise AssertionError(f"vit: outputs {out['f32'].shape}")
    errs = {"f32_card_vs_cpu_rel_fro": _rel_fro(torch.from_numpy(out["f32"][:VIT_CHECK_TILES]),
                                                torch.from_numpy(cpu)),
            "bf16_vs_f32_rel_fro": _rel_fro(torch.from_numpy(out["bf16"]),
                                            torch.from_numpy(out["f32"]))}
    emit({"phase": "vit", "config": dataclasses.asdict(cfg), "tiles": VIT_TILES,
          "tile_px": VIT_TILE_PX, "tower_gflop": flops / 1e9, **runs, **errs,
          "bars": {"f32_card_vs_cpu": VIT_F32_REL, "bf16_vs_f32": VIT_BF16_REL}})
    if not (errs["f32_card_vs_cpu_rel_fro"] <= VIT_F32_REL
            and errs["bf16_vs_f32_rel_fro"] <= VIT_BF16_REL):
        raise AssertionError(f"vit: {errs}")


SLIDE_SIZE = (32768, 24576)   # w, h in px: 16.4 x 12.3 mm at 0.5 um/px
SLIDE_MPP = 0.5
SLIDE_MAG, SLIDE_PATCH = 10, 256   # 10x tiles of 256 px from 512-px regions: a 64 x 48 grid
SLIDE_BAND = 2048                  # rows of the synthetic slide made on the card at a time
SLIDE_CLI_SIZE = (8192, 6144)
SLIDE_CHECK_TILES = 32             # the first batch's tiles checked against the CPU and cv2
SLIDE_FEAT_TOL = dict(rtol=1e-5, atol=1e-6)


def synthetic_slide(torch, w, h, seed, band=SLIDE_BAND):
    """(RGB uint8 [h, w, 3] on the host, tissue share): a 245 background and
    six stained ellipses from `seed` (each pixel's colour uniform in
    [120, 200) x [40, 110) x [120, 200), as tests/test_preprocessing.py's
    slide), made on the card a band of rows at a time and copied into one
    host array."""
    rng = np.random.default_rng(seed)
    blobs = [((i + 0.5) / 3 * w + rng.uniform(-0.04, 0.04) * w,
              (j + 0.5) / 2 * h + rng.uniform(-0.04, 0.04) * h,
              rng.uniform(0.13, 0.15) * w, rng.uniform(0.19, 0.22) * h)
             for i in range(3) for j in range(2)]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lo = torch.tensor([120, 40, 120], device="cuda", dtype=torch.int32)
    span = torch.tensor([80, 70, 80], device="cuda", dtype=torch.int32)
    xs = torch.arange(w, device="cuda", dtype=torch.float32)[None, :]
    slide = np.empty((h, w, 3), np.uint8)
    tissue = 0
    for r0 in range(0, h, band):
        r1 = min(h, r0 + band)
        ys = torch.arange(r0, r1, device="cuda", dtype=torch.float32)[:, None]
        inside = torch.zeros(r1 - r0, w, dtype=torch.bool, device="cuda")
        for cx, cy, rx, ry in blobs:
            inside |= ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 < 1.0
        draw = torch.randint(0, 256, (r1 - r0, w, 3), generator=gen, device="cuda",
                             dtype=torch.uint8)
        colour = lo + ((draw.to(torch.int32) * span) >> 8)
        img = torch.where(inside[..., None], colour, 245).to(torch.uint8)
        torch.from_numpy(slide[r0:r1]).copy_(img)
        tissue += int(inside.sum())
    return slide, tissue / (w * h)


class _Recorded:
    """A tile encoder that keeps what it returns (on the device)."""

    def __init__(self, encoder):
        self.encoder, self.dim, self.outs = encoder, encoder.dim, []

    def __call__(self, tiles):
        out = self.encoder(tiles)
        self.outs.append(out)
        return out


def _slide_checks(torch, wsi, mask):
    """The first batch's tiles: resized on the card against cv2.INTER_LINEAR
    on the host; the handcrafted pool and features on the card against the
    same code on the CPU."""
    import cv2

    from madeleine_torch.preprocessing.patching import WSIPatcher, mag_to_px_size
    from madeleine_torch.preprocessing.tile_embedder import HandcraftedEncoder, area_pool_uint8

    patcher = WSIPatcher(wsi, SLIDE_PATCH, SLIDE_MPP, dst_pixel_size=mag_to_px_size(SLIDE_MAG),
                         mask=mask)
    regions = patcher.read_regions(range(SLIDE_CHECK_TILES), pin=True)
    tiles = patcher.resize(regions.to("cuda", non_blocking=True))
    host = tiles.cpu()
    ref = np.stack([cv2.resize(r, (SLIDE_PATCH, SLIDE_PATCH), interpolation=cv2.INTER_LINEAR)
                    for r in regions.numpy()])
    diff = np.abs(host.numpy().astype(np.int16) - ref.astype(np.int16))
    pooled_equal = bool(torch.equal(area_pool_uint8(tiles, 8).cpu(), area_pool_uint8(host, 8)))
    card = HandcraftedEncoder(device="cuda")(tiles).cpu().numpy()
    cpu = HandcraftedEncoder(device="cpu")(host).numpy()
    feat_ok = bool(np.allclose(card, cpu, **SLIDE_FEAT_TOL))
    out = {"tiles": SLIDE_CHECK_TILES, "region_px": patcher.level_patch_size,
           "resize_max_level_diff_vs_cv2": int(diff.max()),
           "resize_share_differing_vs_cv2": float((diff > 0).mean()),
           "handcrafted_pooled_equal_cpu": pooled_equal,
           "handcrafted_max_abs_vs_cpu": float(np.abs(card - cpu).max()),
           "handcrafted_within_tol": feat_ok, "tol": SLIDE_FEAT_TOL}
    if diff.max() > 1 or not pooled_equal or not feat_ok:
        raise AssertionError(f"slide: the card's tiles or features against the host's: {out}")
    return out, patcher.coords


def _slide_cli(torch, root, tower):
    """The patch-extraction CLI (in this process) on one 8192 x 6144 PNG with
    the ViT tower into .bag and the handcrafted encoder into .npz, then the
    slide-embedding CLI over the handcrafted bags with the bf16 model (K1)."""
    from madeleine_torch.cli import extract_patch_embeddings, extract_slide_embeddings
    from madeleine_torch.data.io import load_coords, load_features
    from madeleine_torch.eval.heatmap import write_png
    from madeleine_torch.utils.file_utils import load_pkl

    w, h = SLIDE_CLI_SIZE
    img, share = synthetic_slide(torch, w, h, SEED + 21)
    slide_dir = os.path.join(root, "cli_slides")
    os.makedirs(slide_dir)
    t0 = time.perf_counter()
    write_png(os.path.join(slide_dir, "s1.png"), img)
    png_s = time.perf_counter() - t0
    del img
    ckpt = os.path.join(root, "vit.pt")
    torch.save({f"visual.{k}": v for k, v in tower.state_dict().items()}, ckpt)
    runs = {}
    for name, fmt, extra in (("vit", "bag", ["--encoder", "vit", "--vit_checkpoint", ckpt]),
                             ("handcrafted", "npz", [])):
        t0 = time.perf_counter()
        out = _quiet(extract_patch_embeddings.main, [
            "--slide_dir", slide_dir, "--local_dir", os.path.join(root, f"cli_{name}"),
            "--patch_mag", str(SLIDE_MAG), "--patch_size", str(SLIDE_PATCH),
            "--pixel_size", str(SLIDE_MPP), "--bag_format", fmt, "--device", "cuda", *extra])
        secs = time.perf_counter() - t0
        bag = os.path.join(out, "patch_embeddings", f"s1.{fmt}")
        feats, coords = load_features(bag), load_coords(bag)
        if feats.ndim != 2 or feats.shape[1] != 512 or len(feats) < 1 \
                or coords.shape != (len(feats), 2) or not np.isfinite(feats).all():
            raise AssertionError(f"slide: the CLI's {name} bag {feats.shape} {coords.shape}")
        runs[name] = {"seconds_per_slide": secs, "tiles": len(feats), "bag": fmt,
                      "out_dir": os.path.basename(out)}
    model_root = os.path.join(root, "model")
    write_model_dir(model_root, "bfloat16")
    before = read_counts()
    t0 = time.perf_counter()
    pkl = _quiet(extract_slide_embeddings.main, [
        "--local_dir", os.path.join(root, "cli_handcrafted", runs["handcrafted"]["out_dir"]),
        "--model_dir", model_root, "--no_download", "--device", "cuda"])
    secs = time.perf_counter() - t0
    after = read_counts()
    res = load_pkl(pkl)
    if after["encode_fused"] - before["encode_fused"] < 1 or res["embeds"].shape != (1, 512) \
            or not np.isfinite(res["embeds"]).all():
        raise AssertionError(f"slide: the slide embedding of the CLI's bag: "
                             f"{res['embeds'].shape}, K1 launches "
                             f"{after['encode_fused'] - before['encode_fused']}")
    runs["slide_embedding"] = {"seconds": secs, "encode_fused_launches":
                               after["encode_fused"] - before["encode_fused"]}
    return {"slide_px": list(SLIDE_CLI_SIZE), "tissue_share": share, "png_write_s": png_s,
            **runs}


def phase_slide(state):
    """From a slide to patch embeddings on the card: a synthetic 32768 x
    24576 slide through TissueSegmenter (Otsu) and TileEmbedder, with the
    handcrafted encoder and the ViT-B/16 tower in bf16 and f32; then the
    patch-extraction CLI on a PNG slide, and the slide-embedding CLI on its
    bags (K1)."""
    import copy
    import resource

    import torch
    from madeleine_torch.data.io import load_coords, load_features
    from madeleine_torch.preprocessing.segmentation import TissueSegmenter
    from madeleine_torch.preprocessing.tile_embedder import HandcraftedEncoder, TileEmbedder
    from madeleine_torch.preprocessing.vit import (TorchViTEncoder, ViTConfig,
                                                   VisionTransformer, init_vit)
    from madeleine_torch.preprocessing.wsi import NumpyWSI

    reset_counts()
    t0 = time.perf_counter()
    w, h = SLIDE_SIZE
    img, share = synthetic_slide(torch, w, h, SEED)
    make_s = time.perf_counter() - t0
    wsi = NumpyWSI(img, pixel_size=SLIDE_MPP)
    vcfg = ViTConfig()
    tower = init_vit(VisionTransformer(vcfg), torch.Generator().manual_seed(SEED))
    runs, checks, coords = {}, None, None
    with tempfile.TemporaryDirectory() as root:
        for name, dtype, batch, fmt in (("handcrafted", None, 64, "bag"),
                                        ("vit_bf16", torch.bfloat16, 256, "npz"),
                                        ("vit_f32", torch.float32, 256, "bag")):
            enc = HandcraftedEncoder(device="cuda") if dtype is None else TorchViTEncoder(
                vcfg, copy.deepcopy(tower), dtype=dtype, device="cuda")
            rec = _Recorded(enc)
            emb = TileEmbedder(rec, SLIDE_PATCH, SLIDE_MAG, batch, os.path.join(root, name),
                               device="cuda", bag_format=fmt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            seg = TissueSegmenter()
            t0 = time.perf_counter()
            mask, contours, _ = seg.segment_tissue(wsi, SLIDE_MPP)
            seg_s = time.perf_counter() - t0
            if checks is None:
                checks, coords = _slide_checks(torch, wsi, mask)
            path = emb.embed_tiles(wsi, mask, "slide", pixel_size=SLIDE_MPP)
            peak = torch.cuda.max_memory_allocated() / 1e9
            got = torch.cat(rec.outs).cpu().numpy()
            read_equal = bool(np.array_equal(load_features(path), got)
                              and np.array_equal(load_coords(path), coords))
            t = emb.timings
            wall = seg_s + t["wall"]
            runs[name] = {"batch": batch, "bag": fmt, "tiles": t["tiles"],
                          "tiles_per_s": t["tiles"] / wall, "seconds": wall,
                          "seconds_by_part": {"thumbnail": seg.timings["thumbnail"],
                                              "otsu_contours": seg.timings["otsu_contours"],
                                              **{k: t[k] for k in ("plan", "read", "h2d", "resize",
                                                                   "encode", "write")}},
                          "embed_wall_s": t["wall"], "peak_device_gb": peak,
                          "contours": len(contours), "mask_share": float(mask.mean()),
                          "bag_read_back_equal": read_equal}
            if not read_equal or got.shape != (len(coords), enc.dim) \
                    or not np.isfinite(got).all():
                raise AssertionError(f"slide {name}: bag {path} against the encoder's "
                                     f"{got.shape}, read back equal {read_equal}")
            del enc, rec, emb, got
            torch.cuda.empty_cache()
        del wsi, img
        gc.collect()
        cli = _slide_cli(torch, root, tower)
    counts = read_counts()
    _check_off_path(counts, "slide")
    state["launches_slide"] = counts
    emit({"phase": "slide", "slide_px": list(SLIDE_SIZE), "mpp": SLIDE_MPP,
          "slide_gb": w * h * 3 / 1e9, "tissue_share": share, "make_s": make_s,
          "mag": SLIDE_MAG, "patch_px": SLIDE_PATCH, "grid_cells": (w // 512) * (h // 512),
          "runs": runs, "checks": checks, "cli": cli,
          "host_peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
          "launches": {k: v for k, v in counts.items() if v}})


TRAIN_STEPS = 5
TRAIN_SIGNAL = 0.015  # per-case vector shared by a case's bags (alignment is learnable)


def train_path_config(**overrides):
    """The canonical pretraining run's settings at full width (ref:
    scripts/launch_pretrain_withoutStainEncodings.sh), InfoNCE only (the CLI's
    default --local_loss -1), warmup off so the learning rate is not ~1e-9."""
    from madeleine_torch.config import MadeleineConfig

    return MadeleineConfig.from_dict(dict(dict(
        flagship_config("bfloat16"), local_loss="-1", global_loss="info-nce",
        symmetric_cl=True, temperature=0.001, lr=1e-4, end_learning_rate=1e-8,
        weight_decay=0.01, warmup=False, max_epochs=120, batch_size=65, n_subsamples=2048,
        modality_scan=True), **overrides))


def synthetic_train_batch(torch, cfg, seed: int, signal: float = TRAIN_SIGNAL):
    """[bs, n_mod, t, d] bf16 on the card, made from `seed` on the card: noise
    plus a per-case vector shared by every stain of the case; every stain
    present."""
    bs, n_mod, t, d = cfg.batch_size, cfg.n_modalities, cfg.n_subsamples, cfg.patch_embedding_dim
    g = torch.Generator(device="cuda").manual_seed(seed)
    case = torch.randn(bs, 1, 1, d, generator=g, device="cuda")
    feats = torch.randn(bs, n_mod, t, d, generator=g, device="cuda").add_(signal * case)
    return {"feats": feats.to(torch.bfloat16),
            "modality_labels": torch.ones(bs, n_mod, device="cuda"),
            "sample_mask": torch.ones(bs, dtype=torch.bool, device="cuda")}


def got_path_config(**overrides):
    """The canonical run's published objective, `--local_loss got`
    (scripts/launch_pretrain_withoutStainEncodings.sh:19): InfoNCE + GOT at
    weight 1 with 256 tokens subsampled per stain pair."""
    return train_path_config(**dict(dict(local_loss="got", local_loss_weight=1.0,
                                         got_subsample=256), **overrides))


def _train_setup(torch, cfg=None, batch=None, group=None):
    """(cfg, model, step, batch): the path's model from SEED, its AdamW and
    train step (on a process `group` when given), and `batch`, or one
    synthetic full-width batch."""
    from madeleine_torch.models.factory import create_model
    from madeleine_torch.train.optim import make_optimizer
    from madeleine_torch.train.trainer import make_train_step

    cfg = train_path_config() if cfg is None else cfg
    _, model = create_model(cfg, seed=SEED, device="cuda")
    opt, sched = make_optimizer(cfg, model.parameters(), steps_per_epoch=TRAIN_STEPS)
    return cfg, model, make_train_step(cfg, model, opt, sched, group=group), (
        synthetic_train_batch(torch, cfg, SEED + 4) if batch is None else batch)


ENCODER_KERNELS = ("encoder_train_fwd", "encoder_train_bwd")
GOT_KERNELS = ("ipot_fwd", "ipot_bwd", "gw_gamma")


BACK_TO_BACK_STEPS = 10


def _optimizer_state(step):
    """Clones of every parameter, both AdamW moments and the count."""
    opt = step.optimizer
    return ([p.detach().clone() for p in step.model.parameters()]
            + [opt.state[p][k].clone() for p in step.model.parameters()
               for k in ("exp_avg", "exp_avg_sq")] + [opt.count.clone()])


def _skips_on_the_card(torch, step, batch, seed):
    """A step on an H&E-only copy of the batch and one on a copy with a NaN
    feature (a non-finite loss): each must report itself skipped and leave
    the parameters, both moments and the count bit for bit."""
    out = {}
    he_only = dict(batch, modality_labels=torch.cat(
        [batch["modality_labels"][:, :1], torch.zeros_like(batch["modality_labels"][:, 1:])], 1))
    nan = dict(batch, feats=batch["feats"].clone())
    nan["feats"][0, 0, 0, 0] = float("nan")
    for name, b in (("he_only", he_only), ("nan", nan)):
        before = _optimizer_state(step)
        _, metrics = step(b, seed)
        same = all(torch.equal(x, y) for x, y in zip(before, _optimizer_state(step)))
        out[name] = {"skipped": bool(metrics["skipped"]), "loss": float(metrics["loss"]),
                     "state_unchanged": same}
        if not (out[name]["skipped"] and same):
            raise AssertionError(f"a skipped step on the card ({name}): {out[name]}")
    del nan, he_only
    return out


def _run_train_steps(torch, state, phase, kernels, cfg=None, setup=None, steps=TRAIN_STEPS,
                     b2b_steps=BACK_TO_BACK_STEPS, skips=True, falls=True, sync_debug=True):
    """`steps` steps of make_train_step at full width on one fixed batch
    (`setup`: the caller's `_train_setup`, else the synthetic batch's), the
    counts set to 0 just before: fails
    unless no step is skipped, every loss is finite, the last is below the
    first (unless not `falls`) and each of `kernels` launches on every
    step; then the parameters' digest. Each step is timed alone (CUDA
    events, the host waiting for each; one step is its own median). Then,
    on the same model: with `sync_debug` one step under
    torch.cuda.set_sync_debug_mode("error") (a step that reads the card
    from the host raises), `b2b_steps` (if any) steps launched back to back
    between two events (also the host's ms a step to launch them), and
    with `skips` a skipped step on an H&E-only batch and on a NaN one, each
    leaving the parameters, the moments and the count bit for bit; the
    model then gets the steps' weights back. Returns (cfg, model, batch,
    summary)."""
    from madeleine_torch.train.trainer import step_seed

    cfg, model, step, batch = _train_setup(torch, cfg) if setup is None else setup
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, skipped, step_ms, per_step = [], [], [], []
    for i in range(steps):
        before = read_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, metrics = step(batch, step_seed(SEED, 0, i))
        end.record()
        end.synchronize()
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in kernels})
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        skipped.append(bool(metrics["skipped"]))
        emit({"phase": phase, "step": i, "loss": losses[-1], "skipped": skipped[-1],
              "lr": float(metrics["lr"]), "step_ms": step_ms[-1], "launches": per_step[-1]})
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    state[f"launches_{phase}"] = counts
    if any(skipped) or not all(np.isfinite(losses)) or (falls and not losses[-1] < losses[0]):
        raise AssertionError(f"{phase}: skipped {skipped}, losses {losses}")
    missing = [(i, k) for i, c in enumerate(per_step) for k in kernels if c[k] < 1]
    if missing:
        raise AssertionError(f"{phase}: kernels not launched on every step: {missing}")
    # the step's 256 x 256 transport problems take K8's, K9's and K10's
    # cluster route; K13's and K14's first designs are checks, never on a path
    _check_off_path(counts, phase)
    # the trained weights, bit for bit: another package's steps must leave the same
    digest = _param_digest(model)
    trained = {k: v.clone() for k, v in model.state_dict().items()}
    seeds = itertools.count(steps)
    if sync_debug:
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(batch, step_seed(SEED, 0, next(seeds)))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    host = b2b = None
    if b2b_steps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        for _ in range(b2b_steps):
            step(batch, step_seed(SEED, 0, next(seeds)))
        host = (time.perf_counter() - t0) * 1e3 / b2b_steps
        end.record()
        end.synchronize()
        b2b = start.elapsed_time(end) / b2b_steps
    skipped_on_card = (_skips_on_the_card(torch, step, batch, step_seed(SEED, 0, next(seeds)))
                       if skips else "not run")
    model.load_state_dict(trained)   # the later checks read the steps' weights
    return cfg, model, batch, {
        "steps": steps, "batch": list(batch["feats"].shape),
        "losses": losses, "skipped": skipped, "step_ms": step_ms,
        "step_ms_median_after_first": statistics.median(step_ms[1:] or step_ms),
        "step_ms_back_to_back": b2b, "back_to_back_steps": b2b_steps,
        "host_ms_per_step_back_to_back": host,
        "sync_debug_error_step": "ran" if sync_debug else "not run",
        "skipped_steps_on_card": skipped_on_card,
        "param_sha256_after_steps": digest,
        "peak_memory_gb": peak / 1e9, "peak_reserved_gb": reserved / 1e9, "launches": counts,
        "launches_per_step": per_step}


def phase_train(state):
    """The InfoNCE train step (kernels K6/K7 for the encoder), then K6 and K7
    alone at the path's call shape."""
    import torch
    from madeleine_torch.ops import encoder_train as et

    cfg, model, batch, run = _run_train_steps(torch, state, "train", ENCODER_KERNELS)
    with torch.no_grad():
        from madeleine_torch.models.madeleine import train_weights

        w = {k: v.detach().contiguous() for k, v in train_weights(model, torch.bfloat16).items()}
        x = batch["feats"][:, 0].contiguous()
        bias = et.token_mask_bias(None, x.shape[0], x.shape[1], "cuda")
        rates = (et.PRE_RATE, et.GATE_RATE)
        pooled32, m, s, _, l, saved = et.encoder_train_fwd_cuda(x, bias, w, 1, 0, *rates)
        g = torch.randn_like(pooled32)
        inner = (g * pooled32).reshape(x.shape[0], cfg.n_heads, -1).sum(-1)
        dtok = torch.zeros(*x.shape[:2], w["wt"].shape[0], device="cuda", dtype=torch.bfloat16)
        args = (x, l, m, s, g, inner, dtok, saved, w, 1, 0, *rates)
        k6 = cuda_ms(lambda: et.encoder_train_fwd_cuda(x, bias, w, 1, 0, *rates))
        k7 = cuda_ms(lambda: et.encoder_train_bwd_cuda(*args))
    n_mod = cfg.n_modalities
    ff, fb, bf, bb = _encoder_train_work(x.shape[0], x.shape[1], w)
    steady = run["step_ms_median_after_first"]
    emit({"phase": "train", **run, "k6_ms_call": k6, "k7_ms_call": k7,
          "encoder_ms_per_step": n_mod * (k6 + k7),
          "encoder_share_of_step": n_mod * (k6 + k7) / steady,
          "encoder_bound_ms_per_step": n_mod * (_bound(ff, fb)[0] + _bound(bf, bb)[0])})


def _param_digest(model) -> str:
    """sha256 over every parameter's bytes, in name order."""
    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _adamw_vs_torch(torch, model, cfg, steps=3):
    """`steps` updates of the port's GatedAdamW against torch.optim.AdamW's
    multi-tensor (foreach, its default on the card) and single-tensor paths,
    on copies of `model`'s parameters with seeded gradients and the schedule's
    float learning rate: the share of parameter elements each leaves
    different from GatedAdamW's, and the largest difference over lr."""
    from madeleine_torch.train.optim import make_optimizer

    g = torch.Generator(device="cuda").manual_seed(SEED)
    base = [p.detach().clone() for p in model.parameters()]
    grads = [[torch.randn(p.shape, generator=g, device="cuda") for p in base]
             for _ in range(steps)]

    def run(kind):
        ps = [torch.nn.Parameter(p.clone()) for p in base]
        opt, sched = make_optimizer(cfg, ps, steps_per_epoch=TRAIN_STEPS)
        if kind != "gated":
            opt = torch.optim.AdamW(ps, lr=sched(0), betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=cfg.weight_decay, foreach=kind == "foreach")
        for i in range(steps):
            for p, gr in zip(ps, grads[i]):
                p.grad = gr
            if kind != "gated":
                for group in opt.param_groups:
                    group["lr"] = sched(i)
            opt.step()
        return ps

    gated = run("gated")
    n = sum(p.numel() for p in gated)
    out = {}
    for kind in ("foreach", "single_tensor"):
        other = run(kind)
        out[kind] = {"elements_differing_share": sum(int((a != b).sum()) for a, b in
                                                     zip(gated, other)) / n,
                     "max_abs_diff_over_lr": max(float((a - b).abs().max())
                                                 for a, b in zip(gated, other)) / cfg.lr}
    return dict(out, steps=steps, elements=n)


def phase_train_got(state):
    """The published objective, InfoNCE + GOT: K6/K7 for the encoder and
    K8/K9/K10 for the 260 transport problems of each step; then the GOT loss
    alone (forward + backward) on tokens of the step's shape."""
    import torch
    from madeleine_torch.ops import losses as L

    cfg, model, _, run = _run_train_steps(torch, state, "train_got",
                                          ENCODER_KERNELS + GOT_KERNELS + GLUE_KERNELS,
                                          got_path_config())
    # the trained weights, bit for bit: K13 adds the trace to the loss, so its
    # sum order must leave every parameter as another package's steps leave it
    digest = run["param_sha256_after_steps"]
    adamw = _adamw_vs_torch(torch, model, cfg)
    del model
    n_pairs = cfg.n_modalities - 1
    shape = (n_pairs, cfg.batch_size, cfg.got_subsample, cfg.token_proj_dim)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    v = torch.randn(*shape, generator=g, device="cuda").requires_grad_(True)
    q = torch.randn(*shape, generator=g, device="cuda").requires_grad_(True)
    smask = torch.ones(n_pairs, cfg.batch_size, dtype=torch.bool, device="cuda")
    got_ms = cuda_ms(lambda: L.got_loss_multi(v, q, sample_mask=smask).sum().backward(),
                     warmup=1, iters=5)
    # the GOT loss's own peak above its inputs (K9's history included)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    L.got_loss_multi(v, q, sample_mask=smask).sum().backward()
    torch.cuda.synchronize()
    got_peak = torch.cuda.max_memory_allocated() - base
    # device time by kernel of one GOT forward + backward: the glue kernels
    # (K11-K14), the transport kernels (K8-K10) and the rest (cosine costs,
    # thresholds' min/max, gathers)
    got_split = _split_got_rows(_profiled(
        torch, lambda: L.got_loss_multi(v, q, sample_mask=smask).sum().backward()))
    hist = 30 * n_pairs * cfg.batch_size * cfg.got_subsample ** 2 * 4
    emit({"phase": "train_got", **run, "param_sha256": digest, "adamw_vs_torch": adamw,
          "got_problems_per_step": n_pairs * cfg.batch_size,
          "got_subsample": cfg.got_subsample, "k9_history_gb": hist / 1e9,
          "got_loss_own_peak_gb": got_peak / 1e9,
          "got_loss_own_peak_gb_less_k9_history": (got_peak - hist) / 1e9,
          "got_loss_fwd_bwd_ms": got_ms,
          "got_share_of_step": got_ms / run["step_ms_median_after_first"],
          "got_device_ms_by_part": got_split})
    state["train_got_step_ms"] = run["step_ms_median_after_first"]
    state["train_got_peak_gb"] = run["peak_memory_gb"]
    state["train_got_launches_per_step"] = run["launches_per_step"]


def phase_train_se(state):
    """The second published run's step, InfoNCE + GOT with stain encodings
    (scripts/launch_pretrain_withStainEncodings.sh): d_in 544, K7 with dx."""
    import torch
    from madeleine_torch.models.factory import create_model

    cfg, model, _, run = _run_train_steps(torch, state, "train_se",
                                          ENCODER_KERNELS + GOT_KERNELS + GLUE_KERNELS,
                                          got_path_config(add_stain_encoding=True))
    _, init = create_model(cfg, seed=SEED, device="cuda")
    moved = (model.embedding.weight - init.embedding.weight).abs().max().item()
    emit({"phase": "train_se", **run, "d_in": cfg.input_dim, "table_max_abs_move": moved,
          "train_got_step_ms": state.get("train_got_step_ms"),
          "train_got_peak_gb": state.get("train_got_peak_gb")})
    if not moved > 0:
        raise AssertionError("train_se: the stain table did not move")


def _pool_own_peak(torch, cfg, activation):
    """GB the plain masked pool's forward and backward allocate above their
    inputs at one modality's call shape [bs, t, nh, e] bf16 (f32 logits)."""
    from madeleine_torch.ops.attn_pool import masked_attention_pool

    g = torch.Generator(device="cuda").manual_seed(SEED)
    nh, e = cfg.n_heads, cfg.wsi_encoder_hidden_dim
    shape = (cfg.batch_size, cfg.n_subsamples)
    xh = torch.randn(*shape, nh, e, generator=g, device="cuda").to(torch.bfloat16)
    logits = torch.randn(*shape, nh, generator=g, device="cuda")
    xh.requires_grad_(True)
    logits.requires_grad_(True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    masked_attention_pool(xh, logits, None, activation).float().sum().backward()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def _remat_vs_no_remat(torch):
    """One bf16 sigmoid step (InfoNCE + GOT, [65, 5, 2048]) from the same
    weights, batch and seed under cfg.remat (the default: each modality's
    body recomputed in its backward) and under --no_remat (every modality's
    saves kept until the backward): the loss and every parameter gradient
    bit for bit; each route's peak, and its peak above what was allocated
    before the step."""
    from madeleine_torch.train.trainer import step_seed

    out, grads, batch = {}, {}, None
    for name, remat in (("remat", True), ("no_remat", False)):
        _, model, step, batch = _train_setup(torch, got_path_config(activation="sigmoid",
                                                                    remat=remat), batch=batch)
        params = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, grads[name], _ = _grads_of_step(torch, model, step, batch, step_seed(SEED, 4, 0),
                                              params)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out[name] = {"loss": loss, "peak_memory_gb": peak / 1e9,
                     "peak_above_start_gb": (peak - base) / 1e9}
        del model, step, params
        torch.cuda.empty_cache()
    unequal = [k for k in grads["remat"] if not torch.equal(grads["remat"][k],
                                                            grads["no_remat"][k])]
    rep = dict(out, loss_bitwise_equal=out["remat"]["loss"] == out["no_remat"]["loss"],
               grads_bitwise_equal=not unequal, unequal=unequal)
    if unequal or not rep["loss_bitwise_equal"]:
        raise AssertionError(f"train_sigmoid: the remat step differs from --no_remat's: {rep}")
    return rep


def phase_train_sigmoid(state):
    """The published objective with --activation sigmoid, the per-op lane
    (JAX madeleine.py:157-172): kernels 15-20 for the encoder and K8-K14 for
    GOT on every step, K6/K7 on none; one step under cfg.remat against one
    under --no_remat, bit for bit (`_remat_vs_no_remat`); then one profiled
    step."""
    import torch

    cfg = got_path_config(activation="sigmoid")
    _, model, _, run = _run_train_steps(torch, state, "train_sigmoid",
                                        PEROP_KERNELS + GOT_KERNELS + GLUE_KERNELS, cfg)
    fused = {k: run["launches"][k] for k in ENCODER_KERNELS}
    if any(fused.values()):
        raise AssertionError(f"train_sigmoid: the whole-encoder kernels launched {fused}")
    state["train_sigmoid_step_ms"] = run["step_ms_median_after_first"]
    state["train_sigmoid_peak_gb"] = run["peak_memory_gb"]
    del model
    remat = _remat_vs_no_remat(torch)
    pool_peak = _pool_own_peak(torch, cfg, "sigmoid")
    # one profiled step after two unprofiled ones, as phase_profile does
    _, _, step, batch = _train_setup(torch, cfg)
    for i in range(2):
        step(batch, i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    seeds = iter((2, 3))

    def one_step():
        start.record()
        step(batch, next(seeds))
        end.record()

    rows = _profiled(torch, one_step)
    busy, wall = sum(r[2] for r in rows), start.elapsed_time(end)
    emit({"phase": "train_sigmoid", **run, "activation": cfg.activation,
          "plain_pool_own_peak_gb": pool_peak, "remat_vs_no_remat": remat,
          "train_got_step_ms": state.get("train_got_step_ms"),
          "train_got_peak_gb": state.get("train_got_peak_gb"),
          "profiled_step": {"wall_ms": wall, "device_busy_ms": busy,
                            "device_idle_share": 1.0 - busy / wall,
                            "by_kernel_ms": [[k, c, ms] for k, c, ms in rows[:24]]}})


NO_FUSED_VAR = "MADELEINE_NO_FUSED_ENCODER"
NOFUSED_KERNELS = ("attn_pool_ms", "attn_pool_bwd") + PEROP_KERNELS
# the per-op lane's forward kernels: under cfg.remat (the default) each
# modality's backward recomputes its body, so these run twice a step per
# call of the forward, the backward kernels once
PEROP_FORWARD_KERNELS = ("attn_pool_ms", "preattn_fwd", "gated_logits_fwd", "linear_tok_fwd",
                         "preattn_fwd_f32", "gated_logits_fwd_f32")


def _perop_per_step(kernel, calls, remat=True):
    """A per-op kernel's launches a step where its op runs `calls` times in
    the forward: twice that for a forward kernel under cfg.remat."""
    return 2 * calls if remat and kernel in PEROP_FORWARD_KERNELS else calls


def _no_fused_encoder(on=True):
    """MADELEINE_NO_FUSED_ENCODER=1 inside the block (forward_train reads it
    at each call; with on=False the environment is left as it is), and the
    environment restored after it."""
    return mock.patch.dict(os.environ, {NO_FUSED_VAR: "1"} if on else {})


def phase_train_nofused(state):
    """The published objective with softmax and MADELEINE_NO_FUSED_ENCODER
    set, the softmax per-op lane (JAX madeleine.py:157-174): rows 4-5 and
    kernels 15-20 once per modality on every step (the forward rows 4, 15,
    17 and 19 twice: cfg.remat's recompute), K6/K7 on none, K8-K14 as
    in train_got; then the chain preattn -> gated_logits -> training pool
    -> linear_tok against K6/K7 on one modality at (0.1, 0.25), beside the
    same at rates 0 (the rounding floor, reported) and a shifted-mask
    control that must miss."""
    import torch
    from madeleine_torch.models.madeleine import train_weights

    cfg = got_path_config()
    with _no_fused_encoder():
        _, model, batch, run = _run_train_steps(torch, state, "train_nofused",
                                                NOFUSED_KERNELS + GOT_KERNELS + GLUE_KERNELS, cfg)
    fused = {k: run["launches"][k] for k in ENCODER_KERNELS}
    wrong = [(i, k, c[k]) for i, c in enumerate(run["launches_per_step"])
             for k in NOFUSED_KERNELS if c[k] != _perop_per_step(k, cfg.n_modalities)]
    got_ref = state.get("train_got_launches_per_step")
    got_diff = [] if got_ref is None else [
        (i, k) for i, (c, r) in enumerate(zip(run["launches_per_step"], got_ref))
        for k in GOT_KERNELS + GLUE_KERNELS if c[k] != r[k]]
    if any(fused.values()) or wrong or got_diff:
        raise AssertionError(f"train_nofused: K6/K7 {fused}, per-step counts off {wrong}, "
                             f"GOT counts unlike train_got's {got_diff}")
    with torch.no_grad():
        w = {k: v.detach().contiguous() for k, v in train_weights(model, torch.bfloat16).items()}
    x = batch["feats"][:, 0].contiguous()
    del model, batch
    gen = np.random.default_rng(SEED + 12)
    real = (0.1, 0.25)
    chain = {"real": _perop_chain_vs_fused(torch, w, x, real, gen, train_pool=True),
             "rates_0": _perop_chain_vs_fused(torch, w, x, (0.0, 0.0), gen, train_pool=True),
             "control_rows_shifted": _perop_chain_vs_fused(torch, w, x, real, gen,
                                                           chain_offset=1, train_pool=True)}
    emit({"phase": "train_nofused", **run, "activation": cfg.activation,
          "variable": f"{NO_FUSED_VAR}=1", "chain_vs_k6_k7": chain,
          "train_got_step_ms": state.get("train_got_step_ms"),
          "train_got_peak_gb": state.get("train_got_peak_gb"),
          "train_sigmoid_step_ms": state.get("train_sigmoid_step_ms"),
          "train_sigmoid_peak_gb": state.get("train_sigmoid_peak_gb")})
    control_missed = set(chain["control_rows_shifted"]["failed"])
    if (chain["real"]["failed"] or chain["rates_0"]["failed"]
            or not {"pooled_err"} | set(PRE_KEYS) <= control_missed):
        raise AssertionError(f"train_nofused: the chain against K6/K7 missed "
                             f"{chain['real']['failed']} (rates 0: {chain['rates_0']['failed']}); "
                             f"the shifted-mask control missed only {sorted(control_missed)}")


def views_path_config(**overrides):
    """The published objective plus the paper's optional intra-modality
    multi-view InfoNCE (--intra_modality_loss info-nce: n_views=3, two
    half-bag views of every bag, madeleine_tpu/utils/args.py:55)."""
    return got_path_config(**dict(dict(intra_modality_loss="info-nce"), **overrides))


def phase_train_views(state):
    """The published objective plus the intra-modality InfoNCE (n_views=3)
    at full width: on the fused route K6/K7 take their view route once per
    modality on every step; under MADELEINE_NO_FUSED_ENCODER rows 4-5 run
    three times per modality (the whole bag and each half), kernels 15-20
    once (each forward row twice: cfg.remat's recompute); K8-K14 as in
    train_got. The loss falls over the steps and no step
    is skipped, on both routes (_run_train_steps)."""
    import torch

    cfg = views_path_config()
    steps_kernels = GOT_KERNELS + GLUE_KERNELS
    _, model, _, fused = _run_train_steps(torch, state, "train_views",
                                          ENCODER_KERNELS + steps_kernels, cfg)
    del model
    with _no_fused_encoder():
        _, model, _, nofused = _run_train_steps(torch, state, "train_views_nofused",
                                                NOFUSED_KERNELS + steps_kernels, cfg)
    del model
    n_mod = cfg.n_modalities
    want = {k: _perop_per_step(k, (3 if k.startswith("attn_pool") else 1) * n_mod)
            for k in NOFUSED_KERNELS}
    wrong = [("nofused", i, k, c[k]) for i, c in enumerate(nofused["launches_per_step"])
             for k in want if c[k] != want[k]]
    wrong += [("fused", i, k, c[k]) for i, c in enumerate(fused["launches_per_step"])
              for k in ENCODER_KERNELS if c[k] != n_mod]
    wrong += [("nofused", k, nofused["launches"][k]) for k in ENCODER_KERNELS
              if nofused["launches"][k]]
    emit({"phase": "train_views", "intra_modality_loss": cfg.intra_modality_loss,
          "n_views": 3, "fused": fused, "nofused": dict(nofused, variable=f"{NO_FUSED_VAR}=1"),
          "train_got_step_ms": state.get("train_got_step_ms"),
          "train_got_peak_gb": state.get("train_got_peak_gb")})
    if wrong:
        raise AssertionError(f"train_views: launches per step off: {wrong}")


# Full-bag (ragged) training, the JAX package's default --n_subsamples -1:
# per case the published step on bags of log-uniform lengths padded to the
# bucket, and the route the save_acts gate must take at that bucket
F32_KERNELS = ("encoder_train_fwd_f32", "encoder_train_bwd_f32")   # K6 / K7, f32 operands
F32_LOSS_RTOL = 1e-5    # train_f32: the loss against the plain K6/K7's step, relative
F32_B2B_STEPS = 3       # train_f32: steps launched back to back


def phase_train_f32(state):
    """The published step at --precision float32 (the JAX package's parity
    route): InfoNCE + GOT with the launch script's flags, 65 x 5 x 2048 f32,
    5 steps (_run_train_steps: the loss falls, none skipped, K6/K7 with f32
    operands and K8-K14 on every step, no bf16 K6/K7 launch; a step under
    sync debug mode "error", 3 back to back). Then from the trained weights
    one step's loss and every parameter gradient against the same step with
    K6 and K7 replaced by their plain versions on the card: the loss within
    1e-5 relative, each gradient within 1e-4 relative Frobenius (bc, the
    attention's output bias, within BC_ATOL). The step ms, the host's ms a
    step, the peak and the weights' digest; the plain step's ms."""
    import torch
    from madeleine_torch.ops import encoder_train as et
    from madeleine_torch.train.trainer import step_seed
    from madeleine_torch.utils.device import full_precision_matmul

    full_precision_matmul()   # the plain versions' products in full f32, as JAX's HIGHEST
    torch.cuda.empty_cache()
    cfg = got_path_config(precision="float32")
    setup = _train_setup(torch, cfg)
    _, model, step, batch = setup
    run = _run_train_steps(torch, state, "train_f32", F32_KERNELS + GOT_KERNELS + GLUE_KERNELS,
                           cfg, setup=setup, b2b_steps=F32_B2B_STEPS, skips=False)[3]
    del setup
    if any(run["launches"][k] for k in ENCODER_KERNELS):
        raise AssertionError(f"train_f32: bf16 K6/K7 launched {run['launches']}")
    params = [p.detach().clone() for p in model.parameters()]
    seed = step_seed(SEED, 2, 0)
    loss_k, g_k, _ = _grads_of_step(torch, model, step, batch, seed, params)
    before = read_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with mock.patch.object(et, "encoder_train_fwd_cuda", et.encoder_train_fwd_plain), \
            mock.patch.object(et, "encoder_train_bwd_cuda", et.encoder_train_bwd_plain):
        start.record()
        loss_p, g_p, _ = _grads_of_step(torch, model, step, batch, seed, params)
        end.record()
        end.synchronize()
    after = read_counts()
    if any(after[k] - before[k] for k in F32_KERNELS):
        raise AssertionError("train_f32: the plain step launched K6/K7")
    errs, bc = {}, {}
    for k in g_p:
        if k.endswith("attention_c.bias"):
            bc[k] = float((g_k[k] - g_p[k]).abs().max())
        elif g_p[k].norm() > 0:
            errs[k] = _rel_fro(g_k[k], g_p[k])
    vs_plain = {"seed": seed, "loss": loss_k, "loss_plain": loss_p,
                "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
                "grad_max_rel_fro": max(errs.values()), "grad_rel_fro": errs,
                "bc_max_abs": max(bc.values()), "plain_step_ms": start.elapsed_time(end)}
    del params, g_k, g_p, model, step, batch
    torch.cuda.empty_cache()
    emit({"phase": "train_f32", "smi": state["smi"], **run, "vs_plain": vs_plain})
    if not (vs_plain["loss_rel_err"] <= F32_LOSS_RTOL
            and vs_plain["grad_max_rel_fro"] <= F32_GRAD_RTOL
            and vs_plain["bc_max_abs"] <= BC_ATOL):
        raise AssertionError(f"train_f32: the kernels' step misses the plain step: loss "
                             f"{vs_plain['loss_rel_err']}, gradients "
                             f"{vs_plain['grad_max_rel_fro']}, bc {vs_plain['bc_max_abs']}")
    ragged = _train_f32_ragged(torch, state, cfg)
    state["train_f32"] = {"step_ms": run["step_ms_median_after_first"],
                          "host_ms": run["host_ms_per_step_back_to_back"],
                          "peak_gb": run["peak_memory_gb"], "ragged": ragged}


F32_RAGGED = (1024, 16384)   # train_f32's full bags: lengths, the longest the bucket
F32_RAGGED_STEPS = 2         # timed steps (about 6 s each), then one back to back
F32_PAD_LENGTHS = (1024, 8192)   # the padding check's lengths, padded to 16384


def _train_f32_ragged(torch, state, cfg):
    """Full bags at --precision float32: a ragged f32 batch of lengths
    log-uniform in F32_RAGGED (bucket 16384, three IHC bags empty),
    F32_RAGGED_STEPS steps (_run_train_steps: none skipped, K6/K7 f32 and
    K8-K14 every step; the sync-debug step, one back to back), every K6/K7
    call on the recompute route in blocks of whole bags, the peak under 80
    GB; then a batch of lengths in F32_PAD_LENGTHS (bucket 8192, one block)
    padded to 16384 (in blocks), one step from the same weights and seed
    each: the loss within 1e-5 relative, every gradient within 1e-4
    relative Frobenius, bc within BC_ATOL."""
    from madeleine_torch.train.trainer import step_seed

    lo, hi = F32_RAGGED
    lengths = ragged_lengths(SEED + 40, cfg.batch_size, cfg.n_modalities, lo, hi)
    setup = _train_setup(torch, cfg, ragged_batch(torch, lengths, SEED + 41,
                                                  dtype=torch.float32))
    run = _run_train_steps(torch, state, "train_f32_ragged",
                           F32_KERNELS + GOT_KERNELS + GLUE_KERNELS, setup=setup,
                           steps=F32_RAGGED_STEPS, b2b_steps=1, skips=False, falls=False)[3]
    del setup
    torch.cuda.empty_cache()
    n_calls = F32_RAGGED_STEPS * cfg.n_modalities
    blocked = {k: run["launches"][k] for k in BLOCK_COUNTERS}
    routes = {"k6_nosave": run["launches"]["encoder_train_fwd_f32_nosave"],
              "k7_recompute": run["launches"]["encoder_train_bwd_f32_recompute"]}
    blocks = blocked["encoder_train_fwd_blocks"]   # a launch a block, every one recompute
    if (routes != {"k6_nosave": blocks, "k7_recompute": blocks}
            or blocked["encoder_train_fwd_blocked_calls"] != n_calls
            or blocked["encoder_train_bwd_blocked_calls"] != n_calls
            or run["peak_memory_gb"] >= 80.0):
        raise AssertionError(f"train_f32 ragged: routes {routes}, blocked calls {blocked} of "
                             f"{n_calls}, peak {run['peak_memory_gb']} GB")
    lengths_p = ragged_lengths(SEED + 42, cfg.batch_size, cfg.n_modalities, *F32_PAD_LENGTHS)
    _, model, step, batch = _train_setup(torch, cfg, ragged_batch(
        torch, lengths_p, SEED + 43, dtype=torch.float32))
    box = [batch]
    del batch
    pad, ok = _padding_check(torch, model, step, box, hi, step_seed(SEED, 3, 0),
                             "encoder_train_bwd_f32_recompute", f32=True)
    del model, step
    torch.cuda.empty_cache()
    out = dict(run, lengths_range=list(F32_RAGGED), valid_tokens=int(lengths.sum()),
               empty_bags=int((lengths == 0).sum()), route_launches=routes,
               blocked_launches=blocked,
               blocks_per_call=blocked["encoder_train_fwd_blocks"] / n_calls,
               padding_check=pad)
    emit({"phase": "train_f32", "ragged": out})
    if (not ok or pad["encoder_train_bwd_blocked_calls_unpadded"] != 0
            or pad["encoder_train_bwd_blocked_calls_padded"] != cfg.n_modalities):
        raise AssertionError(f"train_f32 ragged: the padded step misses the unpadded one: "
                             f"{pad}")
    return {"step_ms": run["step_ms_median_after_first"],
            "host_ms": run["host_ms_per_step_back_to_back"],
            "peak_gb": run["peak_memory_gb"], "blocks_per_call": out["blocks_per_call"]}


PEROP_F32_NOFUSED_STEPS = 3   # train_perop_f32: the no-fused softmax steps
PEROP_BF16_ROWS = PEROP_KERNELS[:4]   # rows 15-18 with bf16 operands


def _perop_f32_launches(phase, run, n_mod):
    """Raise unless each of rows 15-18 f32 launched once per modality on
    every step of `run` (the forward rows twice: cfg.remat's recompute) and
    neither their bf16 routes nor K6/K7 (bf16 or f32) launched."""
    wrong = [(i, k, c[k]) for i, c in enumerate(run["launches_per_step"])
             for k in PEROP_F32_KERNELS if c[k] != _perop_per_step(k, n_mod)]
    other = {k: run["launches"][k] for k in PEROP_BF16_ROWS + ENCODER_KERNELS + F32_KERNELS
             if run["launches"][k]}
    if wrong or other:
        raise AssertionError(f"{phase}: rows 15-18 f32 per step off {wrong}, or other "
                             f"encoder kernels launched {other}")


PEROP_F32_RAGGED = (1024, 16384)   # the f32 sigmoid full bags: lengths, the longest the bucket
PEROP_F32_PAD = 8192               # the padding check's longest: bucket 8192, padded to 16384


def _train_perop_f32_ragged(torch, state):
    """The sigmoid per-op lane at --precision float32 on a ragged batch of
    [65, 5] whose longest bag has PEROP_F32_RAGGED[1] tokens (bucket 16384,
    lengths log-uniform from PEROP_F32_RAGGED[0], three IHC bags empty),
    under cfg.remat with every per-op call in blocks of whole bags: one
    timed step (about 7 s; `_run_train_steps`, no sync-debug or
    back-to-back step: train_perop_f32's steps at 2048 run those on the
    same code), the loss finite and applied, rows 15-18 with f32 operands
    once per block of every call (15 and 17 twice: the recompute), no bf16
    row 15-18 and no K6/K7; the step ms and the peak. Then the padding
    check at the f32 bars: a batch of bucket 8192 (one block a call) one
    step from the trained weights against the same batch padded to 16384
    (in blocks): the loss within 1e-5 relative, every gradient within 1e-4
    relative Frobenius, bc within BC_ATOL."""
    from madeleine_torch.train.trainer import step_seed

    cfg = got_path_config(precision="float32", activation="sigmoid")
    lo, hi = PEROP_F32_RAGGED
    n_mod = cfg.n_modalities
    lengths = ragged_lengths(SEED + 44, cfg.batch_size, n_mod, lo, hi)
    torch.cuda.empty_cache()
    setup = _train_setup(torch, cfg, ragged_batch(torch, lengths, SEED + 45,
                                                  dtype=torch.float32))
    _, model, step, _ = setup
    run = _run_train_steps(torch, state, "train_perop_f32_ragged",
                           PEROP_F32_KERNELS + GOT_KERNELS + GLUE_KERNELS, setup=setup, steps=1,
                           b2b_steps=0, skips=False, falls=False, sync_debug=False)[3]
    del setup
    per_call = _perop_grown_run(run, "train_perop_f32_ragged", PEROP_F32_KERNELS, n_mod,
                                PEROP_BF16_ROWS + ENCODER_KERNELS + F32_KERNELS)
    torch.cuda.empty_cache()
    box = [ragged_batch(torch, ragged_lengths(SEED + 46, cfg.batch_size, n_mod, lo,
                                              PEROP_F32_PAD), SEED + 47, dtype=torch.float32)]
    pad, ok = _padding_check(torch, model, step, box, hi, step_seed(SEED, 3, 0), f32=True,
                             counters=PEROP_BLOCK_COUNTERS)
    del model, step
    torch.cuda.empty_cache()
    out = dict(run, activation=cfg.activation, remat=cfg.remat, lengths_range=[lo, hi],
               bucket=run["batch"][2], valid_tokens=int(lengths.sum()),
               blocks_per_call=per_call, padding_check=pad)
    if (run["peak_memory_gb"] >= 80.0 or per_call < 2 or not ok
            or pad["perop_blocked_calls_unpadded"] != 0
            or pad["perop_blocked_calls_padded"] != 2 * n_mod):
        raise AssertionError(f"train_perop_f32 ragged: peak {run['peak_memory_gb']} GB, "
                             f"{per_call} blocks a call, padding check {pad}")
    return out


def phase_train_perop_f32(state):
    """The per-op lane at --precision float32: 5 published f32 steps
    (InfoNCE + GOT, 65 x 5 x 2048) with --activation sigmoid, then 3 with
    softmax under MADELEINE_NO_FUSED_ENCODER (_run_train_steps: the loss
    falls, none skipped; rows 15-18 with f32 operands once per modality on
    every step, no bf16 row 15-18 and no K6/K7 launch; a step under sync
    debug mode "error", steps back to back). Then from the trained sigmoid
    weights one step's loss and every parameter gradient against the same
    step with rows 15-18 replaced by their plain versions on the card: the
    loss within 1e-5 relative, each gradient within 1e-4 relative
    Frobenius, each head's attention output bias bc within BC_ATOL, as
    train_f32 holds it (its gradient is one sum over every token of a
    stain, 133,120, of terms of either sign, whose relative error measures
    their cancellation, not the kernels; its relative error is reported).
    The step ms, the host's ms a step, the peak; the plain step's ms. Last,
    full bags at bucket 16384 in blocks (`_train_perop_f32_ragged`)."""
    import torch
    from madeleine_torch.ops import gated_logits as gl
    from madeleine_torch.ops import preattn as pa
    from madeleine_torch.train.trainer import step_seed
    from madeleine_torch.utils.device import full_precision_matmul

    full_precision_matmul()   # the plain versions' products in full f32, as JAX's HIGHEST
    torch.cuda.empty_cache()
    kernels = PEROP_F32_KERNELS + GOT_KERNELS + GLUE_KERNELS
    cfg = got_path_config(precision="float32", activation="sigmoid")
    setup = _train_setup(torch, cfg)
    _, model, step, batch = setup
    run = _run_train_steps(torch, state, "train_perop_f32", kernels, cfg, setup=setup,
                           b2b_steps=F32_B2B_STEPS, skips=False)[3]
    del setup
    _perop_f32_launches("train_perop_f32", run, cfg.n_modalities)
    params = [p.detach().clone() for p in model.parameters()]
    seed = step_seed(SEED, 2, 0)
    loss_k, g_k, _ = _grads_of_step(torch, model, step, batch, seed, params)
    before = read_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with mock.patch.object(pa, "preattn_fwd_cuda", pa.preattn_fwd_plain), \
            mock.patch.object(pa, "preattn_bwd_cuda", pa.preattn_bwd_plain), \
            mock.patch.object(gl, "gated_logits_fwd_cuda", gl.gated_logits_fwd_plain), \
            mock.patch.object(gl, "gated_logits_bwd_cuda", gl.gated_logits_bwd_plain):
        start.record()
        loss_p, g_p, _ = _grads_of_step(torch, model, step, batch, seed, params)
        end.record()
        end.synchronize()
    after = read_counts()
    if any(after[k] - before[k] for k in PEROP_F32_KERNELS):
        raise AssertionError("train_perop_f32: the plain step launched rows 15-18")
    errs, bc = {}, {}
    for k in g_p:
        if k.endswith("attention_c.bias"):   # a sum of cancelling terms over every token
            bc[k] = {"abs_err": float((g_k[k] - g_p[k]).abs().max()),
                     "rel_err": _rel_fro(g_k[k], g_p[k]), "value": float(g_p[k].abs().max())}
        elif g_p[k].norm() > 0:
            errs[k] = _rel_fro(g_k[k], g_p[k])
    vs_plain = {"seed": seed, "loss": loss_k, "loss_plain": loss_p,
                "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
                "grad_max_rel_fro": max(errs.values()), "grad_rel_fro": errs,
                "bc_max_abs": max(v["abs_err"] for v in bc.values()), "bc": bc,
                "plain_step_ms": start.elapsed_time(end)}
    del params, g_k, g_p, model, step, batch
    torch.cuda.empty_cache()
    with _no_fused_encoder():
        cfg_nf = got_path_config(precision="float32")
        nofused = _run_train_steps(torch, state, "train_perop_f32_nofused",
                                   ("attn_pool_ms", "attn_pool_bwd") + kernels, cfg_nf,
                                   steps=PEROP_F32_NOFUSED_STEPS, b2b_steps=1, skips=False)[3]
    _perop_f32_launches("train_perop_f32_nofused", nofused, cfg_nf.n_modalities)
    torch.cuda.empty_cache()
    ragged = _train_perop_f32_ragged(torch, state)
    emit({"phase": "train_perop_f32", "smi": state["smi"], "activation": cfg.activation, **run,
          "vs_plain": vs_plain,
          "nofused": dict(nofused, activation="softmax", variable=f"{NO_FUSED_VAR}=1"),
          "ragged": ragged, "train_f32": state.get("train_f32")})
    if not (vs_plain["loss_rel_err"] <= F32_LOSS_RTOL
            and vs_plain["grad_max_rel_fro"] <= F32_GRAD_RTOL
            and vs_plain["bc_max_abs"] <= BC_ATOL):
        raise AssertionError(f"train_perop_f32: the kernels' step misses the plain step: loss "
                             f"{vs_plain['loss_rel_err']}, gradients "
                             f"{vs_plain['grad_max_rel_fro']}, bc {bc}: {errs}")
    state["train_perop_f32"] = {"step_ms": run["step_ms_median_after_first"],
                                "host_ms": run["host_ms_per_step_back_to_back"],
                                "peak_gb": run["peak_memory_gb"],
                                "nofused_step_ms": nofused["step_ms_median_after_first"],
                                "ragged_step_ms": ragged["step_ms"][0],
                                "ragged_peak_gb": ragged["peak_memory_gb"],
                                "ragged_blocks_per_call": ragged["blocks_per_call"]}


RAGGED_CASES = {"a": (1024, 16384, "recompute"), "b": (1024, 8192, "save"),
                "c": (1024, 32768, "recompute")}
RAGGED_BUCKETS_TOP = 16384   # past it (case c) every K6/K7 call runs in blocks of whole bags
RAGGED_GROWN_STEPS = 2       # case c's timed steps (about 2 s each)
RAGGED_PAD_TO = {"a": "c", "b": "a"}   # each padding check's batch, padded to that case's bucket
RAGGED_EMPTY = 3          # empty (case, stain) bags per batch, label 0
RAGGED_B2B_STEPS = 3
RAGGED_PAD_LOSS_RTOL = 1e-4
# the softmax per-op lane's full bags: lengths, the longest the bucket (32768:
# every per-op call in blocks), and the padding check's longest (bucket 16384)
RAGGED_NOFUSED = (1024, 32768)
RAGGED_NOFUSED_PAD = 16384
RAGGED_NOFUSED_STEPS = 2     # timed steps (about 2 s each), then one under sync debug, one b2b


def ragged_lengths(seed, bs, n_mod, lo, hi, n_empty=RAGGED_EMPTY):
    """[bs, n_mod] bag lengths, log-uniform in [lo, hi] from `seed`, bag
    (0, 0) at hi (it sets the bucket), n_empty IHC bags empty."""
    gen = np.random.default_rng(seed)
    lengths = np.exp(gen.uniform(np.log(lo), np.log(hi), (bs, n_mod))).astype(np.int64)
    lengths = np.clip(lengths, lo, hi)
    lengths[0, 0] = hi
    empty = gen.choice(bs * (n_mod - 1), n_empty, replace=False)
    lengths[empty // (n_mod - 1), 1 + empty % (n_mod - 1)] = 0
    return lengths


def ragged_batch(torch, lengths, seed, t=None, d=512, signal=TRAIN_SIGNAL, dtype=None):
    """A ragged batch as the loaders make it: feats [bs, n_mod, t, d] in
    `dtype` (bf16 by default) on the card (noise plus a per-case vector,
    made there from `seed`, zero past each bag's length), the token mask on
    the host (numpy, as a loader yields it: the step copies it from pinned
    memory), labels 0 for the empty bags; t the bucket of the longest bag
    unless given."""
    from madeleine_torch.data.datasets import RAGGED_BUCKETS, bucket_of

    bs, n_mod = lengths.shape
    t = t or bucket_of(int(lengths.max()), RAGGED_BUCKETS)
    mask = np.arange(t)[None, None, :] < lengths[..., None]
    g = torch.Generator(device="cuda").manual_seed(seed)
    case = torch.randn(bs, 1, d, generator=g, device="cuda")
    dtype = dtype or torch.bfloat16
    feats = torch.empty(bs, n_mod, t, d, dtype=dtype, device="cuda")
    valid = torch.from_numpy(mask).cuda()
    for m in range(n_mod):
        x = torch.randn(bs, t, d, generator=g, device="cuda").add_(signal * case)
        feats[:, m] = x.mul_(valid[:, m, :, None]).to(dtype)
        del x
    return {"feats": feats,
            "modality_labels": torch.from_numpy((lengths > 0).astype(np.float32)).cuda(),
            "sample_mask": torch.ones(bs, dtype=torch.bool, device="cuda"), "token_mask": mask}


def _profiled_step(torch, step, batch, seeds):
    """(device busy ms, wall ms, rows) of one profiled train step (`_profiled`,
    two windows; each window one step, seeds drawn from `seeds`)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def one_step():
        start.record()
        step(batch, next(seeds))
        end.record()

    rows = _profiled(torch, one_step)
    return sum(r[2] for r in rows), start.elapsed_time(end), rows


def _grads_of_step(torch, model, step, batch, seed, params):
    """(loss, {name: gradient clone}, {counter: launches}) of one step from
    the parameters `params` (copied in first)."""
    with torch.no_grad():
        for p, v in zip(model.parameters(), params):
            p.copy_(v)
    before = read_counts()
    _, metrics = step(batch, seed)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    loss = float(metrics["loss"])
    if bool(metrics["skipped"]):
        raise AssertionError("padding check: a step was skipped")
    after = read_counts()
    return loss, grads, {k: after[k] - before[k] for k in after}


BLOCK_COUNTERS = ("encoder_train_fwd_blocked_calls", "encoder_train_fwd_blocks",
                  "encoder_train_bwd_blocked_calls", "encoder_train_bwd_blocks")


def _padding_check(torch, model, step, box, t_pad, seed, recompute_key=None, f32=False,
                   counters=BLOCK_COUNTERS):
    """One step from the model's weights on the ragged batch `box.pop()`
    (the caller keeps no other reference: it is freed before the padded
    step) and on the same batch padded to t_pad tokens, from the same
    weights and seed: the losses within RAGGED_PAD_LOSS_RTOL relative
    (F32_LOSS_RTOL with f32), every gradient within GRAD_RTOL relative
    Frobenius (f32: F32_GRAD_RTOL, bc within BC_ATOL). Returns the errors
    and each step's recompute calls (`recompute_key`, where given) and
    `counters` (the blocked K6/K7 calls and their blocks by default)."""
    batch = box.pop()
    params = [p.detach().clone() for p in model.parameters()]
    loss_u, g_u, l_u = _grads_of_step(torch, model, step, batch, seed, params)
    t = batch["feats"].shape[2]
    padded = dict(batch, feats=torch.nn.functional.pad(batch["feats"], (0, 0, 0, t_pad - t)),
                  token_mask=np.pad(batch["token_mask"], ((0, 0), (0, 0), (0, t_pad - t))))
    del batch
    loss_p, g_p, l_p = _grads_of_step(torch, model, step, padded, seed, params)
    del padded
    errs, bc = {}, {}
    for k in g_u:
        if f32 and k.endswith("attention_c.bias"):
            bc[k] = float((g_p[k] - g_u[k]).abs().max())
        elif g_u[k].float().norm() > 0:
            errs[k] = _rel_fro(g_p[k].float(), g_u[k].float())
    pad = {"bucket_unpadded": int(t), "bucket_padded": t_pad, "loss_unpadded": loss_u,
           "loss_padded": loss_p, "loss_rel_err": abs(loss_p - loss_u) / abs(loss_u),
           "grad_max_rel_fro": max(errs.values()), "grad_rel_fro": errs,
           **({"recompute_calls_unpadded": l_u[recompute_key],
               "recompute_calls_padded": l_p[recompute_key]} if recompute_key else {}),
           **{f"{k}_unpadded": l_u[k] for k in counters},
           **{f"{k}_padded": l_p[k] for k in counters}}
    if f32:
        pad["bc_max_abs"] = max(bc.values())
    ok = (pad["loss_rel_err"] <= (F32_LOSS_RTOL if f32 else RAGGED_PAD_LOSS_RTOL)
          and pad["grad_max_rel_fro"] <= (F32_GRAD_RTOL if f32 else GRAD_RTOL)
          and (not f32 or pad["bc_max_abs"] <= BC_ATOL))
    return pad, ok


def phase_train_ragged(state):
    """The published step (softmax, fused, InfoNCE + GOT, bf16, 65 x 5) on
    full-bag batches: (a) lengths log-uniform in [1024, 16384], bucket 16384,
    where the save_acts gate must send every K6/K7 call to the recompute
    route (the saves of one call, 15.3 GB, pass the 10 GiB budget); (b) in
    [1024, 8192], bucket 8192, the save route; (c) in [1024, 32768], bucket
    32768 (a bag past 16384 tokens grows it), the recompute route with every
    K6/K7 call in blocks of whole bags (`encoder_blocks`). Three IHC bags
    empty (label 0) in each; no call of (a) or (b) in blocks. (a) and (b)
    run 5 steps (_run_train_steps: the loss falls, none skipped, K6-K14
    every step, a step under sync debug mode "error", 3 back to back), then
    one profiled step (idle share); (c) 2 steps (the loss need not fall),
    the sync-debug step and 3 back to back. Then the padding checks, each
    one step from the same weights and seed against the unpadded step:
    batch (a) padded to 32768 (every call in blocks) and batch (b) padded
    to 16384 (the recompute route): losses at 1e-4 relative, every
    parameter gradient at 1e-2 relative Frobenius."""
    import torch
    from madeleine_torch.train.trainer import step_seed

    cfg = got_path_config()
    kernels = ENCODER_KERNELS + GOT_KERNELS + GLUE_KERNELS
    out, launches = {}, {}
    torch.cuda.empty_cache()
    # (b) runs on the cache (a) left: its peak reserved against its peak
    # allocated shows what a change of bucket costs the caching allocator
    for name, (lo, hi, route) in RAGGED_CASES.items():
        grown = hi > RAGGED_BUCKETS_TOP
        steps = RAGGED_GROWN_STEPS if grown else TRAIN_STEPS
        lengths = ragged_lengths(SEED + 20 + hi, cfg.batch_size, cfg.n_modalities, lo, hi)
        if grown:
            torch.cuda.empty_cache()
        setup = _train_setup(torch, cfg, ragged_batch(torch, lengths, SEED + 21))
        _, model, step, batch = setup
        run = _run_train_steps(torch, state, f"train_ragged_{name}", kernels, setup=setup,
                               steps=steps, b2b_steps=RAGGED_B2B_STEPS, skips=False,
                               falls=not grown)[3]
        del setup
        n_calls = steps * cfg.n_modalities
        got = {"k6_nosave": run["launches"]["encoder_train_fwd_nosave"],
               "k7_recompute": run["launches"]["encoder_train_bwd_recompute"]}
        blocked = {k: run["launches"][k] for k in BLOCK_COUNTERS}
        calls = n_calls if grown else 0
        if (blocked["encoder_train_fwd_blocked_calls"] != calls
                or blocked["encoder_train_bwd_blocked_calls"] != calls
                or run["peak_memory_gb"] >= 80.0):
            raise AssertionError(f"train_ragged ({name}): blocked calls {blocked} of "
                                 f"{n_calls}, wanted {calls}; peak {run['peak_memory_gb']} GB")
        # a launch a block: a blocked call's route launches are its blocks
        want = 0 if route != "recompute" else (
            blocked["encoder_train_fwd_blocks"] if grown else n_calls)
        if got["k6_nosave"] != want or got["k7_recompute"] != want:
            raise AssertionError(f"train_ragged ({name}): route {got} of {n_calls} calls, "
                                 f"wanted {route}")
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        hd, nh = cfg.wsi_encoder_hidden_dim, cfg.n_heads
        saves = cfg.batch_size * batch["feats"].shape[2] * (
            2 * (2 * hd + nh * hd + 2 * nh * cfg.attention_hidden_dim) + 12)
        out[name] = dict(run, lengths_range=[lo, hi], bucket=int(batch["feats"].shape[2]),
                         valid_tokens=int(lengths.sum()), empty_bags=int((lengths == 0).sum()),
                         route=route, route_launches=got, saves_per_call_gb=saves / 1e9,
                         blocked_launches=blocked,
                         blocks_per_call=(blocked["encoder_train_fwd_blocks"] / calls
                                          if calls else 1))
        if not grown:
            busy, wall, rows = _profiled_step(torch, step, batch, iter((90, 91)))
            out[name]["profiled_step"] = {"wall_ms": wall, "device_busy_ms": busy,
                                          "device_idle_share": 1.0 - busy / wall,
                                          "by_kernel_ms": [[k, c, ms] for k, c, ms in rows[:12]]}
        emit({"phase": "train_ragged", "case": name, **out[name]})
        if name in RAGGED_PAD_TO:
            # the padding check, from the trained weights and one seed
            t_pad = RAGGED_CASES[RAGGED_PAD_TO[name]][1]
            box = [batch]
            del batch
            pad, ok = _padding_check(torch, model, step, box, t_pad, step_seed(SEED, 1, 0),
                                     "encoder_train_bwd_recompute")
            emit({"phase": "train_ragged", "case": name, "padding_check": pad})
            grown_pad = t_pad > RAGGED_BUCKETS_TOP
            if (not ok or pad["recompute_calls_unpadded"]
                    != (cfg.n_modalities if route == "recompute" else 0)
                    or pad["recompute_calls_padded"]
                    != (pad["encoder_train_bwd_blocks_padded"] if grown_pad
                        else cfg.n_modalities)
                    or pad["encoder_train_bwd_blocked_calls_unpadded"] != 0
                    or pad["encoder_train_bwd_blocked_calls_padded"]
                    != (cfg.n_modalities if grown_pad else 0)):
                raise AssertionError(f"train_ragged: the padded step ({name} to {t_pad}) "
                                     f"misses the unpadded one: {pad}")
            out[f"padding_check_{name}"] = pad
        else:
            del batch
        del model, step
        torch.cuda.empty_cache()
    state["launches_train_ragged"] = launches
    state["train_ragged"] = {k: {"step_ms": v["step_ms_median_after_first"],
                                 "host_ms": v["host_ms_per_step_back_to_back"],
                                 "peak_gb": v["peak_memory_gb"],
                                 "blocks_per_call": v["blocks_per_call"]}
                             for k, v in out.items() if k in RAGGED_CASES}


PEROP_BLOCK_COUNTERS = ("perop_blocked_calls", "perop_blocks")
PEROP_PEAK_SHAPE = (16, 16384)   # `_perop_own_peaks`' call: one block of 262,144 rows


def _perop_own_peaks(torch):
    """The per-op chain's own peak against the reckoning that sizes its
    blocks: one `abmil_embed_train` call (one block, the token projector
    inside) at PEROP_PEAK_SHAPE with the flagship weights, the forward and
    then the backward from fixed cotangents, in bf16 with softmax and with
    sigmoid and in f32 with sigmoid; each direction's peak above what was
    allocated before the call, beside `perop_saved_row_bytes` (what the
    stain keeps into its backward) plus `perop_row_bytes` (the transients
    of the larger direction) times the rows."""
    from madeleine_torch.models import abmil
    from madeleine_torch.models.madeleine import project_tokens, train_weights

    b, t = PEROP_PEAK_SHAPE
    out = {}
    for precision, activation in (("bfloat16", "softmax"), ("bfloat16", "sigmoid"),
                                  ("float32", "sigmoid")):
        dtype = getattr(torch, precision)
        with torch.no_grad():
            w = train_weights(flagship_model(torch, precision), dtype)
        w = {k: v.detach().contiguous().requires_grad_() for k, v in w.items()}
        g = torch.Generator(device="cuda").manual_seed(SEED + 50)
        x = torch.randn(b, t, w["w1"].shape[1], generator=g, device="cuda").to(dtype)
        nh, f, e = w["wa"].shape
        gp = torch.randn(b, nh, e, generator=g, device="cuda").to(dtype)
        gt = torch.randn(b, t, w["wt"].shape[0], generator=g, device="cuda").to(dtype)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pooled, tok = abmil.abmil_embed_train(
            w, x, activation=activation, seed=1234,
            project=lambda y: project_tokens(y, w["wt"], w["bt"]))
        torch.cuda.synchronize()
        fwd = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        torch.autograd.backward([pooled, tok], [gp, gt])
        torch.cuda.synchronize()
        bwd = torch.cuda.max_memory_allocated() - base
        widths = (x.shape[2], w["w1"].shape[0], nh, e, f, w["wt"].shape[0])
        rows, q = b * t, x.element_size()
        saved = abmil.perop_saved_row_bytes(widths, q, activation) * rows
        transient = abmil.perop_row_bytes(widths, q, activation) * rows
        out[f"{precision}_{activation}"] = {
            "rows": rows, "fwd_peak_gb": fwd / 1e9, "bwd_peak_gb": bwd / 1e9,
            "reckoned_saved_gb": saved / 1e9, "reckoned_transient_gb": transient / 1e9,
            "measured_over_reckoned": max(fwd, bwd) / (saved + transient)}
        del w, x, gp, gt, pooled, tok
        torch.cuda.empty_cache()
    return out


def _perop_grown_run(run, phase, kernels, n_mod, off):
    """Blocks per call of a per-op run whose every call runs in blocks of
    whole bags (its forward calls and cfg.remat's recomputes alike), after
    checking that each of `kernels` launched once per block of every call
    on every timed step (the forward kernels twice: the recompute) and none
    of `off`."""
    calls = run["launches"]["perop_blocked_calls"]
    per_call = run["launches"]["perop_blocks"] / max(calls, 1)
    want = {k: _perop_per_step(k, round(n_mod * per_call)) for k in kernels}
    wrong = [(i, k, c[k]) for i, c in enumerate(run["launches_per_step"]) for k in kernels
             if c[k] != want[k]]
    wrong += [(k, run["launches"][k]) for k in off if run["launches"][k]]
    if wrong or calls != 2 * n_mod * run["steps"]:
        raise AssertionError(f"{phase}: launches per step off, or other encoder kernels "
                             f"launched: {wrong}; blocked calls {calls}")
    return per_call


def phase_train_ragged_nofused(state):
    """The softmax per-op lane (MADELEINE_NO_FUSED_ENCODER, bf16) on a
    ragged batch of [65, 5] whose longest bag has RAGGED_NOFUSED[1] tokens
    (bucket 32768; lengths log-uniform from RAGGED_NOFUSED[0], three IHC bags
    empty), RAGGED_NOFUSED_STEPS steps under cfg.remat (each modality's body
    recomputed in its backward) with every per-op call in blocks of whole
    bags (`models/abmil.py::perop_blocks_of`): the losses finite, none
    skipped, rows 4-5 and 15-20 once per block of every call on every step
    (the forward rows twice: the recompute), K6/K7 never, the peak under 80
    GB; a step under sync debug mode "error", one back to back. Then the
    padding check: a batch of bucket 16384 (lengths up to RAGGED_NOFUSED_PAD,
    one block a call) one step from the trained weights against the same
    batch padded to 32768 (in blocks), the losses within 1e-4 relative,
    every gradient within 1e-2 relative Frobenius. First the chain's own
    peaks against their reckoning (`_perop_own_peaks`)."""
    import torch
    from madeleine_torch.train.trainer import step_seed

    cfg = got_path_config()
    lo, hi = RAGGED_NOFUSED
    n_mod = cfg.n_modalities
    lengths = ragged_lengths(SEED + 30, cfg.batch_size, n_mod, lo, hi)
    torch.cuda.empty_cache()
    own_peaks = _perop_own_peaks(torch)
    with _no_fused_encoder():
        setup = _train_setup(torch, cfg, ragged_batch(torch, lengths, SEED + 31))
        _, model, step, _ = setup
        run = _run_train_steps(torch, state, "train_ragged_nofused",
                               NOFUSED_KERNELS + GOT_KERNELS + GLUE_KERNELS, setup=setup,
                               steps=RAGGED_NOFUSED_STEPS, b2b_steps=1, skips=False,
                               falls=False)[3]
        del setup
        per_call = _perop_grown_run(run, "train_ragged_nofused", NOFUSED_KERNELS, n_mod,
                                    ENCODER_KERNELS)
        torch.cuda.empty_cache()
        box = [ragged_batch(torch, ragged_lengths(SEED + 32, cfg.batch_size, n_mod,
                                                  lo, RAGGED_NOFUSED_PAD), SEED + 33)]
        pad, ok = _padding_check(torch, model, step, box, hi, step_seed(SEED, 1, 0),
                                 counters=PEROP_BLOCK_COUNTERS)
    del model, step
    torch.cuda.empty_cache()
    emit({"phase": "train_ragged_nofused", "smi": state["smi"], **run,
          "variable": f"{NO_FUSED_VAR}=1", "remat": cfg.remat, "lengths_range": [lo, hi],
          "bucket": run["batch"][2], "valid_tokens": int(lengths.sum()),
          "blocks_per_call": per_call, "padding_check": pad, "perop_own_peaks": own_peaks})
    if (run["peak_memory_gb"] >= 80.0 or per_call < 2 or not ok
            or pad["perop_blocked_calls_unpadded"] != 0
            or pad["perop_blocked_calls_padded"] != 2 * n_mod):
        raise AssertionError(f"train_ragged_nofused: peak {run['peak_memory_gb']} GB, "
                             f"{per_call} blocks a call, padding check {pad}")
    state["train_ragged_nofused"] = {"step_ms": run["step_ms_median_after_first"],
                                     "host_ms": run["host_ms_per_step_back_to_back"],
                                     "peak_gb": run["peak_memory_gb"],
                                     "blocks_per_call": per_call}


HEAD_CLASSES = 4
HEAD_STEPS = 5


def phase_heads(state):
    """Classification heads on slide embeddings: a cohort of 65 bags of 2048
    tokens embedded by encode_he in bf16 (K1), then HEAD_STEPS AdamW steps
    of an MLP head and of a ProjHead (f32, dropout 0.2: row 21 in every
    forward and backward) on synthetic labels; the loss falls."""
    import torch
    import torch.nn.functional as F
    from madeleine_torch.models import heads
    from madeleine_torch.models.madeleine import encode_he, init_madeleine

    model = flagship_model(torch, "bfloat16")
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    labels = torch.arange(65, device="cuda") % HEAD_CLASSES
    centres = torch.randn(HEAD_CLASSES, 1, 512, generator=g, device="cuda")
    feats = (torch.randn(65, 2048, 512, generator=g, device="cuda")
             + centres[labels]).to(torch.bfloat16)
    torch.cuda.synchronize()
    reset_counts()
    emb = encode_he(model, feats)
    del model, feats
    runs = {}
    for name, cls, sites in (("mlp", heads.MLP, 2), ("proj_head", heads.ProjHead, 1)):
        head = init_madeleine(cls(512, HEAD_CLASSES), torch.Generator().manual_seed(SEED))
        head = head.cuda()
        opt = torch.optim.AdamW(head.parameters(), lr=1e-3, weight_decay=0.01)
        losses, per_step = [], []
        for i in range(HEAD_STEPS):
            before = read_counts()["dropout"]
            opt.zero_grad()
            loss = F.cross_entropy(head(emb, seed=SEED + i, train=True), labels)
            loss.backward()
            opt.step()
            losses.append(loss.item())
            per_step.append(read_counts()["dropout"] - before)
        runs[name] = {"losses": losses, "dropout_launches_per_step": per_step}
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                and all(c == 2 * sites for c in per_step)):
            raise AssertionError(f"heads {name}: {runs[name]}")
    state["launches_heads"] = read_counts()
    if state["launches_heads"]["encode_fused"] < 1:
        raise AssertionError(f"heads: encode_fused was not launched ({state['launches_heads']})")
    _check_off_path(state["launches_heads"], "heads")
    emit({"phase": "heads", "embeddings": list(emb.shape), "classes": HEAD_CLASSES,
          "steps": HEAD_STEPS, "runs": runs, "launches": state["launches_heads"]})


PRETRAIN_CASES = 70        # 65 + 5: two steps per epoch, the second padded by 60 masked rows
PRETRAIN_TOKENS = (512, 2561)   # bag lengths; below 2048 the subsample draws with replacement
PRETRAIN_IHC_PRESENT = 0.8
PRETRAIN_DOWNSTREAM = 16


PRETRAIN_STAINS = ["HE", "HER2", "PGR", "KI67", "ER"]
PRETRAIN_SEED = 42     # the CLI's --seed default


def _write_pretrain_cohort(root, gen, tokens=PRETRAIN_TOKENS, dtype="float32",
                           cases=PRETRAIN_CASES, long_bag=None):
    """<root>/feats/case{i}_{stain}.bag (512-d bags of `tokens` lengths in
    `dtype`, the native loader's format, written by the port's writer: noise
    plus a per-case vector shared by the case's bags), <root>/ACROBAT.csv,
    and <root>/downstream/patch_embeddings/*.npz, for `cases` cases; with
    `long_bag`, case 0's H&E bag and the first downstream slide have that
    many tokens. Returns (bags, bytes written)."""
    from madeleine_torch.native.bagio import write_bag_file

    stains = PRETRAIN_STAINS
    feats = os.path.join(root, "feats")
    os.makedirs(feats)
    rows, n_bags, n_bytes = [], 0, 0
    for i in range(cases):
        case = gen.standard_normal(512, dtype=np.float32)
        labels = {s: int(s == "HE" or gen.random() < PRETRAIN_IHC_PRESENT) for s in stains}
        for s, present in labels.items():
            if present:
                n = int(gen.integers(*tokens))
                n = long_bag if long_bag and i == 0 and s == "HE" else n
                x = gen.standard_normal((n, 512), dtype=np.float32)
                x += TRAIN_SIGNAL * case
                write_bag_file(os.path.join(feats, f"case{i:02d}_{s}.bag"), x, dtype=dtype)
                n_bags = n_bags + 1
                n_bytes += x.nbytes // (2 if dtype == "bfloat16" else 1)
        rows.append(",".join([f"case{i:02d}"] + [str(labels[s]) for s in stains] + ["train"]))
    with open(os.path.join(root, "ACROBAT.csv"), "w") as f:
        f.write("slide_id," + ",".join(stains) + ",split\n" + "\n".join(rows) + "\n")
    down = os.path.join(root, "downstream", "patch_embeddings")
    os.makedirs(down)
    for i in range(PRETRAIN_DOWNSTREAM):
        n = int(gen.integers(300, 4000))
        n = long_bag if long_bag and i == 0 else n
        np.savez(os.path.join(down, f"slide_{i:02d}.npz"),
                 features=gen.standard_normal((n, 512), dtype=np.float32))
    return n_bags, n_bytes


def _pretrain_argv(root, results, max_epochs, *extra, n_subsamples=2048):
    """The flags of scripts/launch_pretrain_withoutStainEncodings.sh; with
    --add_stain_encoding in `extra`, those of
    scripts/launch_pretrain_withStainEncodings.sh; with n_subsamples None,
    no --n_subsamples (the CLI's default, -1: full bags)."""
    sub = () if n_subsamples is None else ("--n_subsamples", str(n_subsamples))
    return ["--dataset", "ACROBAT", "--csv_fpath", os.path.join(root, "ACROBAT.csv"),
            "--data_root_dir", os.path.join(root, "feats"), "--results_dir", results,
            "--wsi_encoder", "abmil", "--n_heads", "4", "--patch_embedding_dim", "512",
            "--wsi_encoder_hidden_dim", "512", "--activation", "softmax",
            "--global_loss", "info-nce", "--local_loss", "got", "--temperature", "0.001",
            "--symmetric_cl", "--lr", "0.0001", "--batch_size", "65", *sub,
            "--warmup", "--warmup_epochs", "5", "--precision", "bfloat16",
            "--max_epochs", str(max_epochs), "--downstream_dir", os.path.join(root, "downstream"),
            *extra]


# every CLI process of the run: its log's name and its wall seconds by part
CLI_RUNS = []
# the parts of a CLI process, each ending at the mark of its name: the CLI's
# timeline (cli/pretrain.py main), then the process's exit seen from here
CLI_PARTS = ("main", "setup", "loader", "model", "epochs", "saved", "downstream", "end", "exit")


def _cli_parts(launched, exited, timeline):
    """{part: seconds} of one CLI process from the wall clock at its launch
    and exit here and its printed timeline: main = interpreter start and
    imports up to the entry into main, setup = arguments, group, device and
    results dir, loader = the loader (the native loader's pinned ring),
    model = model, optimizer, train step and resume, epochs = the epochs
    (the first step loads the kernels' libraries), saved = the final
    model.pt, downstream = the downstream pass, end = the parameters'
    digest and the logger's close, exit = interpreter and CUDA teardown."""
    marks = [launched] + [timeline[k] for k in CLI_PARTS[:-1]] + [exited]
    return {k: marks[i + 1] - marks[i] for i, k in enumerate(CLI_PARTS)}


def _run_pretrain_cli(argv, log_path, launcher=()):
    """The pretrain CLI from the repo root on `argv`, this process's cached
    device memory released first; returns (results dir, metrics records,
    wall seconds). With a `launcher` (the module and arguments to `python
    -m` before the CLI's, e.g. torchrun's) `python -m <launcher> -m
    madeleine_torch.cli.pretrain` in a fresh process; else the CLI's entry
    point `madeleine_torch.cli.pretrain.main(argv)` in this process, its
    output to the log, which spares the fixed cost of a process (the
    interpreter, torch's import, torch._dynamo's import by the first
    optimizer, and the exit: about 16 s of a 20 s run, PERF §7). The run's
    seconds by part (`_cli_parts`) go to CLI_RUNS."""
    fresh = bool(launcher)
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0, launched = time.perf_counter(), time.time()
    with open(log_path, "w") as log:
        if fresh:
            proc = subprocess.run([sys.executable, "-m", *launcher, "-m",
                                   "madeleine_torch.cli.pretrain", *argv],
                                  cwd=HERE, stdout=log, stderr=subprocess.STDOUT, timeout=900,
                                  env=dict(os.environ, PYTHONPATH=HERE))
            rc = proc.returncode
        else:
            from madeleine_torch.cli import pretrain

            with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
                try:
                    pretrain.main(list(argv))
                    rc = 0
                except Exception:
                    traceback.print_exc()
                    rc = 1
            gc.collect()
            torch.cuda.empty_cache()
    wall, exited = time.perf_counter() - t0, time.time()
    out = open(log_path).read()
    if rc != 0:
        raise AssertionError(f"pretrain CLI failed (rc {rc}, fresh process {fresh}):\n"
                             f"{out[-4000:]}")
    lines = out.splitlines()
    results = [ln.split(": ", 1)[1] for ln in lines if ln.startswith("* Results dir: ")][0]
    timeline = json.loads([ln.split(": ", 1)[1] for ln in lines
                           if ln.startswith("* Timeline: ")][-1])
    CLI_RUNS.append({"log": os.path.basename(log_path), "fresh_process": fresh, "wall_s": wall,
                     "parts_s": _cli_parts(launched, exited, timeline)})
    with open(os.path.join(results, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return results, records, wall


def _release_host_cache(torch):
    """Hand the host's page-locked memory that nothing holds back to the
    system: the native rings' spare buffers (`native/dataset.py::
    release_spare`; the in-process CLI runs of a phase leave their rings'
    buffers there, for the next ring of the same size) and the caching host
    allocator's free pinned blocks. Returns the allocator's call used, None
    where this PyTorch has none."""
    from madeleine_torch.native.dataset import release_spare

    release_spare()
    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
        fn = getattr(torch._C, name, None)
        if fn is not None:
            fn()
            return name
    return None


def _process_probe():
    """Seconds a fresh Python process spends on what every CLI process
    repeats, by part, on the wall clock: interpreter start, `import torch`,
    the CUDA context (a first allocation on the card), the CLI module's
    imports, torch._dynamo's import (the first torch.optim optimizer's
    add_param_group imports it, through torch._disable_dynamo), and the
    exit."""
    code = ("import json, time; t = [time.time()]; import torch; t.append(time.time()); "
            "torch.zeros(1, device='cuda'); torch.cuda.synchronize(); t.append(time.time()); "
            "import madeleine_torch.cli.pretrain; t.append(time.time()); "
            "import torch._dynamo; t.append(time.time()); print(json.dumps(t))")
    launched = time.time()
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE, capture_output=True, text=True,
                         check=True, timeout=300, env=dict(os.environ, PYTHONPATH=HERE))
    exited = time.time()
    t = json.loads(out.stdout.strip().splitlines()[-1])
    marks = [launched] + t + [exited]
    names = ("interpreter", "import_torch", "cuda_context", "import_cli", "import_dynamo",
             "exit")
    return {k: marks[i + 1] - marks[i] for i, k in enumerate(names)}


PRETRAIN_STEP_KERNELS = ENCODER_KERNELS + GOT_KERNELS + GLUE_KERNELS
LOADER_PARTS = ("draw_ms", "assemble_ms", "guard_wait_ms")   # the native loader's


def _check_pretrain_run(name, results, records, epochs, kernels=PRETRAIN_STEP_KERNELS,
                        downstream_kernel="encode_fused", loader="native-bf16"):
    """Every epoch fed by `loader` (metrics.jsonl's name), every step finite,
    none skipped, `kernels` (K6-K14) launched on every step,
    `downstream_kernel` (K1; None: none, as for a non-softmax model, whose
    eval forward is plain) in the downstream pass, the artifacts written.
    Returns the run's summary."""
    import torch
    from madeleine_torch.utils.file_utils import load_pkl

    ep = [r for r in records if "steps" in r]
    if [r["epoch"] for r in ep] != list(epochs):
        raise AssertionError(f"pretrain {name}: epochs {[r['epoch'] for r in ep]}")
    if any(r["loader"] != loader for r in ep):
        raise AssertionError(f"pretrain {name}: loaders {[r['loader'] for r in ep]}, "
                             f"not {loader}")
    steps = [s for r in ep for s in r["steps"]]
    bad = [s for s in steps if s["skipped"] or not np.isfinite(s["loss"])
           or any(s["launches"].get(k, 0) < 1 for k in kernels)]
    if bad or len(steps) != 2 * len(ep):
        raise AssertionError(f"pretrain {name}: bad steps {bad} of {len(steps)}")
    down = [r for r in records if "downstream" in r]
    if len(down) != 1 or down[0]["slides"] != PRETRAIN_DOWNSTREAM or (
            downstream_kernel and down[0]["launches"].get(downstream_kernel, 0) < 1):
        raise AssertionError(f"pretrain {name}: downstream pass {down}")
    for i, s in enumerate(steps):
        _check_off_path(s["launches"], f"pretrain {name} step {i}")
    _check_off_path(down[0]["launches"], f"pretrain {name} downstream pass")
    names = set(os.listdir(results))
    want = {"config.json", "model_config.txt", "model.pt", "model_config.json",
            "downstream.pkl", "train_state", "metrics.jsonl"}
    if not want <= names:
        raise AssertionError(f"pretrain {name}: missing {sorted(want - names)}")
    emb = load_pkl(os.path.join(results, "downstream.pkl"))["embeds"]
    if emb.shape != (PRETRAIN_DOWNSTREAM, 512) or not np.isfinite(emb).all():
        raise AssertionError(f"pretrain {name}: downstream embeds {emb.shape}")
    launched = {}
    for s in steps:
        for k, v in s["launches"].items():
            launched[k] = launched.get(k, 0) + v
    for k, v in down[0]["launches"].items():
        launched[k] = launched.get(k, 0) + v
    sd = torch.load(os.path.join(results, "model.pt"), map_location="cpu")
    return {"epochs": len(ep), "losses": [s["loss"] for s in steps],
            "step_ms": [s["step_ms"] for s in steps], "wait_ms": [s["wait_ms"] for s in steps],
            "buckets": [s.get("bucket") for s in steps],
            "valid_tokens": [s.get("valid_tokens") for s in steps],
            "truncation_count": [x for r in ep for x in r.get("truncation_count", [])],
            "pinned_bytes": max((r.get("pinned_bytes", 0) for r in ep), default=0),
            "ring_depth": max((r.get("ring_depth", 0) for r in ep), default=0),
            "loader_ms": [x for r in ep for x in r["loader_ms"]],
            **{part: [x for r in ep for x in r[part]] for part in LOADER_PARTS if part in ep[0]},
            "epoch_time_s": [r["epoch_time"] for r in ep],
            "peak_memory_gb": max(r["peak_memory_gb"] for r in ep),
            "launches": launched}, sd


def _loader_breakdown(root):
    """The Python loader's host ms of one full-width batch (the first 65
    cases), by part: reading the bags, the 2048-token subsamples,
    `collate`, and the pin."""
    import torch
    from madeleine_torch.data.datasets import SlideDataset, collate
    from madeleine_torch.data.io import load_features

    ds = SlideDataset("ACROBAT", os.path.join(root, "ACROBAT.csv"), os.path.join(root, "feats"),
                      PRETRAIN_STAINS, embedding_size=512, sample=2048)
    ms = {"read": 0.0, "subsample": 0.0}
    items = []
    for i in range(65):
        row, feats = ds.rows[i], []
        for s in ds.modalities:
            t0 = time.perf_counter()
            x = (load_features(ds._bag_path(row, s)) if int(row[s]) == 1
                 else np.zeros((2, 512), np.float32))
            t1 = time.perf_counter()
            feats.append(ds.sample_n(x))
            ms["read"] += (t1 - t0) * 1e3
            ms["subsample"] += (time.perf_counter() - t1) * 1e3
        items.append({"feats": feats, "modality_labels": [int(row[s]) for s in ds.modalities],
                      "slide_id": row["slide_id"]})
    t0 = time.perf_counter()
    batch = collate(items)
    t1 = time.perf_counter()
    torch.from_numpy(batch["feats"]).pin_memory()
    ms.update(collate=(t1 - t0) * 1e3, pin=(time.perf_counter() - t1) * 1e3)
    return ms


def _native_first_batch(root, out_dtype, buffer_depth=4):
    """The first batch of epoch 0 as the CLI's native loader makes it (the
    launch script's batch of 65, 2048 tokens, seed 42; the host library
    built here with -march=native; a pinned ring) against the plain route's
    (pure-Python draw, numpy gather, half-up bf16 rounding) bit for bit.
    Returns (report, the batch: its feats pinned, its ``copied`` guard for
    the caller to record after its copy, as every consumer of a pinned ring
    does)."""
    import torch
    from madeleine_torch.native.dataset import NativeTrainLoader

    def first(plain):
        loader = NativeTrainLoader(os.path.join(root, "ACROBAT.csv"), os.path.join(root, "feats"),
                                   PRETRAIN_STAINS, embedding_size=512, sample=2048,
                                   batch_size=65, seed=PRETRAIN_SEED, out_dtype=out_dtype,
                                   buffer_depth=2 if plain else buffer_depth,
                                   device="cpu" if plain else "cuda",
                                   plain=plain)
        loader.set_epoch(0)
        t0 = time.perf_counter()
        batch = next(iter(loader))
        return loader, batch, (time.perf_counter() - t0) * 1e3

    loader, batch, ms = first(False)
    _, want, plain_ms = first(True)
    bits = torch.int16 if out_dtype == "bfloat16" else torch.int32
    got_bits, want_bits = batch["feats"].view(bits), want["feats"].view(bits)
    equal = torch.equal(got_bits, want_bits)
    if not equal or not batch["feats"].is_pinned():
        diff = (got_bits != want_bits).sum().item()
        raise AssertionError(f"pretrain: the native {out_dtype} batch differs from its plain "
                             f"version in {diff} elements (pinned {batch['feats'].is_pinned()})")
    n_bags = int(np.count_nonzero(batch["modality_labels"]))
    out_bytes = batch["feats"].numel() * batch["feats"].element_size()
    in_bytes = n_bags * 2048 * 512 * 4              # each present bag's f32 rows, read once
    part = loader.timings[0]
    return {"dtype": out_dtype, "bitwise_equal_plain": equal, "pinned": True,
            "host_ms": ms, **part, "plain_ms": plain_ms, "bags": n_bags,
            "bytes_in": in_bytes, "bytes_out": out_bytes,
            "assembly_gb_per_s": (in_bytes + out_bytes) / part["assemble_ms"] / 1e6,
            "n_threads": loader.n_threads, "cpu_count": os.cpu_count(),
            "ring_depth": loader.ring_depth}, batch


def _pinned_batch_outlives_its_copy(torch, n=64 << 20):
    """The Python loader's batches are pinned with Tensor.pin_memory() (the
    CLI's host_batches), by PyTorch's caching host allocator. With the host
    ahead of the card a batch can be freed before its copy has run: the
    allocator must keep its block until the copy's recorded event completes.
    A pinned block of n f32 ones is copied behind about 0.1 s of device
    sleep, freed, and a block of the same size pinned and filled with twos
    at once; the copy must still read ones."""
    a = torch.ones(n).pin_memory()
    dst = torch.empty(n, device="cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    dst.copy_(a, non_blocking=True)
    freed = a.data_ptr()
    del a
    b = torch.empty(n).pin_memory()
    b.fill_(2.0)
    reused = b.data_ptr() == freed
    torch.cuda.synchronize()
    intact = bool((dst == 1.0).all())
    if not intact:
        raise AssertionError("a pinned batch freed before its copy ran was overwritten")
    return {"copy_intact": intact, "freed_block_reused_before_the_copy": reused,
            "mb": n * 4 / 2 ** 20}


def _pretrain_trio(root, tag, epochs_a, epochs, *extra, n_subsamples=2048, **check):
    """Three CLI runs on the cohort, in this process: A epochs_a epochs with
    --checkpoint_every 1, B A resumed to `epochs`, C `epochs` straight, each
    checked by `_check_pretrain_run`
    (`check`: its keywords). Returns (runs, model.pt state dicts, wall
    seconds, resume report); B must equal C bit for bit."""
    import torch

    runs, sds, walls = {}, {}, {}
    resume_from = None
    for name, n in (("A", epochs_a), ("B", epochs), ("C", epochs)):
        more = ("--resume", resume_from) if name == "B" else ()
        results, records, walls[name] = _run_pretrain_cli(
            _pretrain_argv(root, os.path.join(root, tag + name.lower()), n,
                           "--checkpoint_every", "1", *more, *extra, n_subsamples=n_subsamples),
            os.path.join(root, f"pretrain_{tag}{name.lower()}.log"))
        if name == "A":
            resume_from = os.path.join(results, "train_state")
        first = epochs_a if name == "B" else 0
        runs[name], sds[name] = _check_pretrain_run(tag + name, results, records,
                                                    range(first, n), **check)
    unequal = [k for k in sds["C"] if not torch.equal(sds["B"][k], sds["C"][k])]
    max_diff = max((sds["B"][k] - sds["C"][k]).abs().max().item() for k in sds["C"])
    # the resumed epochs against the uninterrupted ones: the same batches, losses
    n_b = len(runs["B"]["losses"])
    same_losses = runs["B"]["losses"] == runs["C"]["losses"][-n_b:]
    if unequal or not same_losses:
        raise AssertionError(f"pretrain {tag}: resumed run differs from the uninterrupted one: "
                             f"{len(unequal)} tensors, max |diff| {max_diff}")
    return runs, sds, walls, {"resume_bitwise_equal": not unequal,
                              "resume_max_abs_diff": max_diff, "resume_same_losses": same_losses}


def _loader_line(rs):
    """Host ms per batch, parts, step ms, epoch time and busy share of
    runs; the last two also over the epochs after each process's first,
    whose first step loads every kernel (two steps an epoch)."""
    steps_ms = [ms for r in rs for ms in r["step_ms"]]
    epoch_s = [s for r in rs for s in r["epoch_time_s"]]
    warm_s = [s for r in rs for s in r["epoch_time_s"][1:]]
    warm_steps = [ms for r in rs for ms in r["step_ms"][2:]]
    line = {"host_ms_per_batch_median": statistics.median(
                [ms for r in rs for ms in r["loader_ms"]]),
            "cli_step_ms_median": statistics.median(steps_ms),
            "epoch_time_s_median": statistics.median(epoch_s),
            "stream_busy_share_of_epochs": sum(steps_ms) / (1e3 * sum(epoch_s)),
            "warm_epochs": len(warm_s),
            "warm_epoch_time_s_median": statistics.median(warm_s) if warm_s else None,
            "warm_stream_busy_share": (sum(warm_steps) / (1e3 * sum(warm_s))
                                       if warm_s else None)}
    for part in LOADER_PARTS:
        if part in rs[0]:
            line[part + "_median"] = statistics.median([x for r in rs for x in r[part]])
    return line


def phase_pretrain(state):
    """The pretrain CLI at full width with the launch scripts' flags on one
    synthetic cohort of f32 .bag files, which --native_loader auto (the
    default) feeds through the native loader in bf16: without stain
    encodings A 2 epochs with --checkpoint_every 1, B A resumed to 3
    epochs, C 3 epochs straight; with them (--add_stain_encoding) A' 1
    epoch, B' A' resumed to 2, C' 2 straight. B's model.pt must equal C's,
    B''s C''s. Then one epoch with --activation sigmoid (the per-op lane,
    kernels 15-20) through the Python loader (--native_loader off), and one
    with softmax and MADELEINE_NO_FUSED_ENCODER=1 (rows 4-5 and kernels
    15-20), native. The first native batch, bf16 and f32, against its
    plain version bit for bit; both loaders' host ms and parts, H2D ms,
    step ms, epoch time and stream busy share. Every run goes through the
    CLI's entry point in this process (`_run_pretrain_cli`): a fresh
    process's own seconds are the bare process's (`_process_probe`), and
    data_parallel's torchrun run starts `python -m
    madeleine_torch.cli.pretrain` in one. The cohort stays for the
    data_parallel phase's CLI runs when that phase is in the run."""
    import torch

    gen = np.random.default_rng(SEED + 7)
    probe = _process_probe()
    pinned = _pinned_batch_outlives_its_copy(torch)
    root = tempfile.mkdtemp(prefix="pretrain_")
    keep = False
    try:
        t0 = time.perf_counter()
        n_bags, n_bytes = _write_pretrain_cohort(root, gen)
        cohort_s = time.perf_counter() - t0
        native_f32, batch = _native_first_batch(root, "float32", buffer_depth=2)
        batch["copied"].record()   # not copied: no later batch of its ring is drawn
        native_bf16, batch = _native_first_batch(root, "bfloat16")
        # host -> device copy of one bf16 batch from its pinned ring slot
        h2d_bf16_ms = cuda_ms(lambda: batch["feats"].to("cuda", non_blocking=True), warmup=2,
                              iters=10)
        batch["copied"].record()
        del batch
        runs, _, walls, resume = _pretrain_trio(root, "", 2, 3)
        runs_se, sds_se, walls_se, resume_se = _pretrain_trio(
            root, "se_", 1, 2, "--add_stain_encoding")
        results, records, wall_sig = _run_pretrain_cli(
            _pretrain_argv(root, os.path.join(root, "sigmoid"), 1, "--activation", "sigmoid",
                           "--checkpoint_every", "1", "--native_loader", "off"),
            os.path.join(root, "pretrain_sigmoid.log"))
        run_sig, _ = _check_pretrain_run("sigmoid", results, records, range(1),
                                         kernels=PEROP_KERNELS + GOT_KERNELS + GLUE_KERNELS,
                                         downstream_kernel=None, loader="python")
        with _no_fused_encoder():   # forward_train reads the variable at each call
            results, records, wall_nf = _run_pretrain_cli(
                _pretrain_argv(root, os.path.join(root, "nofused"), 1, "--checkpoint_every", "1"),
                os.path.join(root, "pretrain_nofused.log"))
        run_nf, _ = _check_pretrain_run("nofused", results, records, range(1),
                                        kernels=NOFUSED_KERNELS + GOT_KERNELS + GLUE_KERNELS)
        if any(run_nf["launches"].get(k, 0) for k in ENCODER_KERNELS):
            raise AssertionError(f"pretrain nofused: K6/K7 launched {run_nf['launches']}")
        # the intra-modality InfoNCE (n_views=3, K6/K7's view route), one epoch
        results, records, wall_intra = _run_pretrain_cli(
            _pretrain_argv(root, os.path.join(root, "intra"), 1, "--checkpoint_every", "1",
                           "--intra_modality_loss", "info-nce"),
            os.path.join(root, "pretrain_intra.log"))
        run_intra, _ = _check_pretrain_run("intra", results, records, range(1))
        trace_summary = _trace_summary(root)
        loader_parts = _loader_breakdown(root)
        keep = "data_parallel" in state["phases"]
    finally:
        if keep:
            state["pretrain_cohort"] = root
        else:
            shutil.rmtree(root, ignore_errors=True)
        _release_host_cache(torch)
    table = sds_se["C"]["embedding.weight"]
    if tuple(table.shape) != (5, 32) or sds_se["C"]["wsi_embedders.pre_attn.0.weight"].shape[1] \
            != 544:
        raise AssertionError(f"pretrain se_: model.pt table {tuple(table.shape)}")
    # host -> device copy of one batch's f32 feats from pinned memory (the Python loader's)
    x = torch.empty(65, 5, 2048, 512, dtype=torch.float32).pin_memory()
    h2d_ms = cuda_ms(lambda: x.to("cuda", non_blocking=True), warmup=2, iters=10)
    del x

    every = list(runs.values()) + list(runs_se.values()) + [run_sig, run_nf, run_intra]
    state["launches_pretrain"] = {k: sum(r["launches"].get(k, 0) for r in every)
                                  for k in read_counts()}
    state["launches_pretrain_side"] = {k: sum(r["launches"].get(k, 0) for r in (run_sig, run_nf))
                                       for k in read_counts()}
    native = _loader_line(list(runs.values()))
    emit({"phase": "pretrain", "process_probe_s": probe, "cases": PRETRAIN_CASES, "bags": n_bags,
          "cohort_gb": n_bytes / 1e9, "cohort_format": ".bag f32", "cohort_write_s": cohort_s,
          "runs": runs, "cli_wall_s": walls, **resume,
          "loader": "native-bf16",
          "loader_host_ms_per_batch_median": native["host_ms_per_batch_median"],
          "native_loader": dict(native, first_batch_bf16=native_bf16, first_batch_f32=native_f32,
                                h2d_ms_per_batch_bf16=h2d_bf16_ms,
                                h2d_gb_per_batch_bf16=65 * 5 * 2048 * 512 * 2 / 1e9),
          "python_loader": dict(_loader_line([run_sig]), run="sigmoid",
                                pinned_batch_outlives_its_copy=pinned,
                                one_batch_by_part=loader_parts, h2d_ms_per_batch_f32=h2d_ms,
                                h2d_gb_per_batch_f32=65 * 5 * 2048 * 512 * 4 / 1e9),
          "cli_step_ms_median": native["cli_step_ms_median"],
          "in_memory_step_ms": state.get("train_got_step_ms"),
          "epoch_time_s_median": native["epoch_time_s_median"],
          "stream_busy_share_of_epochs": native["stream_busy_share_of_epochs"],
          "peak_memory_gb": max(r["peak_memory_gb"] for r in runs.values()),
          "stain_encoded": {"runs": runs_se, "cli_wall_s": walls_se, **resume_se,
                            "table_shape": list(table.shape),
                            "cli_step_ms_median": statistics.median(
                                [ms for r in runs_se.values() for ms in r["step_ms"]]),
                            "peak_memory_gb": max(r["peak_memory_gb"]
                                                  for r in runs_se.values())},
          "sigmoid": {"run": run_sig, "cli_wall_s": wall_sig,
                      "cli_step_ms_median": statistics.median(run_sig["step_ms"])},
          "nofused": {"run": run_nf, "cli_wall_s": wall_nf,
                      "cli_step_ms_median": statistics.median(run_nf["step_ms"])},
          "intra": {"run": run_intra, "cli_wall_s": wall_intra,
                    "flags": "--intra_modality_loss info-nce",
                    "cli_step_ms_median": statistics.median(run_intra["step_ms"])},
          "trace_summary": trace_summary})


# names of K6's and K7's row kernels (WINDOW_KERNELS): one of each must be
# among the top of a profiled step's summary
TRACE_K6_ROWS = ("ln_gelu_fwd", "gate_logits_sum", "pool_partial", "pool_merge")
TRACE_K7_ROWS = ("recon_h", "pool_bwd", "gate_bwd", "layer_bwd", "colsum_rows")


def _trace_summary(root):
    """(d): one CLI epoch (2 steps at 2048 tokens, the launch script's
    flags) with --profile_dir, its trace.json summarised by
    `python -m madeleine_torch.tools.profile_summary` (its functions, here):
    one ``step_fn`` range a step, the wgmma GEMM and K6's and K7's row
    kernels among the top 20, the ms a step of the kernels inside the
    ranges at or below the range's (beside it every kernel's, the epoch's
    smooth rank included). This run's step ms is read nowhere else."""
    from madeleine_torch.tools import profile_summary

    prof = os.path.join(root, "profiled_trace")
    results, records, wall = _run_pretrain_cli(
        _pretrain_argv(root, os.path.join(root, "profiled"), 1, "--checkpoint_every", "1",
                       "--profile_dir", prof),
        os.path.join(root, "pretrain_profiled.log"))
    run, _ = _check_pretrain_run("profiled", results, records, range(1))
    path = profile_summary.newest_trace(prof)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    agg = profile_summary.aggregate(events)
    top = [profile_summary.short_name(k) for k, _ in agg["ops"].most_common(20)]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("ph") == "X"
             and e.get("cat") == "gpu_user_annotation" and "step_fn" in e.get("name", "")]
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    in_steps = [e for e in kernels if any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                                          for a, b in spans)]
    kernel_ms = sum(e["dur"] for e in in_steps) / 1e3 / agg["steps"]
    range_ms = sum(agg["ranges"]) / 1e3 / agg["steps"]
    report = {"trace_mb": os.path.getsize(path) / 1e6, "cli_wall_s": wall,
              "steps": len(run["step_ms"]), "step_fn_ranges": len(agg["ranges"]),
              "step_fn_range_ms": [d / 1e3 for d in agg["ranges"]],
              "kernel_ms_per_step": kernel_ms, "range_ms_per_step": range_ms,
              "kernels_in_steps": len(in_steps), "kernels": len(kernels),
              "all_kernels_ms_per_step": sum(e["dur"] for e in kernels) / 1e3 / agg["steps"],
              "top20": top, "summary": profile_summary.summarize(events, top=12)}
    if (not agg["device"] or len(agg["ranges"]) != len(run["step_ms"])
            or "gemm_kernel" not in top or not set(top) & set(TRACE_K6_ROWS)
            or not set(top) & set(TRACE_K7_ROWS) or kernel_ms > range_ms):
        raise AssertionError(f"trace summary: {report}")
    return report


RAGGED_PRETRAIN_TOKENS = (300, 8001)   # bag lengths of the full-bag cohort: bucket 8192


def _ragged_cohort(state):
    """(root, bags, bytes, write seconds) of the full-bag cohort that
    pretrain_ragged and pretrain_f32 share: 70 cases of bf16 .bag bags of
    RAGGED_PRETRAIN_TOKENS lengths from SEED + 9, written once a run; the
    last of the two phases in the run removes it (`_drop_ragged_cohort`)."""
    if "ragged_cohort" not in state:
        root = tempfile.mkdtemp(prefix="pretrain_ragged_")
        t0 = time.perf_counter()
        n_bags, n_bytes = _write_pretrain_cohort(root, np.random.default_rng(SEED + 9),
                                                 tokens=RAGGED_PRETRAIN_TOKENS,
                                                 dtype="bfloat16")
        state["ragged_cohort"] = (root, n_bags, n_bytes, time.perf_counter() - t0)
    return state["ragged_cohort"]


def _drop_ragged_cohort(state, keep=False):
    """Remove the shared full-bag cohort, unless `keep` (a later phase of
    the run reads it)."""
    if not keep and "ragged_cohort" in state:
        shutil.rmtree(state.pop("ragged_cohort")[0], ignore_errors=True)


def phase_pretrain_ragged(state):
    """The pretrain CLI's `main` in this process (data_parallel's torchrun
    run starts it as `python -m` in a fresh one) with the launch script's
    flags but its default --n_subsamples (-1: full bags) on a synthetic
    cohort of 70 cases of bf16 .bag bags of 300-8000 tokens (bucket 8192),
    20% of IHC stains absent: through the native loader (NativeRaggedLoader)
    A 1 epoch with --checkpoint_every 1, B A resumed to 2, C 2 straight (B's
    model.pt equal to C's bit for bit), and one epoch through the Python
    loader (--native_loader off: RaggedTrainLoader). Every step finite and
    applied, K6-K14 every step, bucket 8192, nothing truncated; the host ms
    per batch, the H2D ms of a pinned bf16 batch of the bucket, the ring's
    pinned bytes, the CLI step ms and the stream busy share."""
    import torch

    from madeleine_torch.data.datasets import RAGGED_BUCKETS, bucket_of

    root, n_bags, n_bytes, cohort_s = _ragged_cohort(state)
    done = False
    try:
        runs, _, walls, resume = _pretrain_trio(root, "ragged_", 1, 2, n_subsamples=None)
        results, records, wall_py = _run_pretrain_cli(
            _pretrain_argv(root, os.path.join(root, "ragged_python"), 1, "--checkpoint_every",
                           "1", "--native_loader", "off", n_subsamples=None),
            os.path.join(root, "pretrain_ragged_python.log"))
        run_py, _ = _check_pretrain_run("ragged_python", results, records, range(1),
                                        loader="python")
        logs = open(os.path.join(root, "pretrain_ragged_a.log")).read()
        _release_host_cache(torch)
        grown = _pretrain_grown(torch, root)
        done = True
    finally:
        _drop_ragged_cohort(state, keep=done and "pretrain_f32" in state["phases"])
        _release_host_cache(torch)
    bucket = bucket_of(RAGGED_PRETRAIN_TOKENS[1] - 1, RAGGED_BUCKETS)
    every = list(runs.values()) + [run_py]
    bad = [(r["buckets"], r["truncation_count"]) for r in every
           if any(b != bucket for b in r["buckets"]) or any(r["truncation_count"])]
    if bad or "full-bag (ragged) batches" not in logs:
        raise AssertionError(f"pretrain_ragged: buckets / truncations {bad}, or the native "
                             f"loader's ragged line missing from the log")
    x = torch.empty(65, 5, bucket, 512, dtype=torch.bfloat16).pin_memory()
    h2d_ms = cuda_ms(lambda: x.to("cuda", non_blocking=True), warmup=2, iters=10)
    del x
    state["launches_pretrain_ragged"] = {k: sum(r["launches"].get(k, 0)
                                                for r in every + [grown["run"],
                                                                  grown["sigmoid_run"]])
                                         for k in read_counts()}
    native = _loader_line(list(runs.values()))
    emit({"phase": "pretrain_ragged", "cases": PRETRAIN_CASES, "bags": n_bags,
          "cohort_gb": n_bytes / 1e9, "cohort_format": ".bag bf16", "cohort_write_s": cohort_s,
          "bag_tokens": list(RAGGED_PRETRAIN_TOKENS), "bucket": bucket,
          "flags": "launch script's, without --n_subsamples (default -1)",
          "runs": runs, "cli_wall_s": walls, **resume,
          "native_loader": dict(native, pinned_bytes=max(r["pinned_bytes"] for r in runs.values()),
                                h2d_ms_per_batch_bf16=h2d_ms,
                                h2d_gb_per_batch_bf16=65 * 5 * bucket * 512 * 2 / 1e9),
          "python_loader": dict(_loader_line([run_py]), run=run_py, cli_wall_s=wall_py),
          "grown_bucket": grown,
          "peak_memory_gb": max(r["peak_memory_gb"] for r in every)})


GROWN_PRETRAIN = (16, 8, 20000)   # cases, --batch_size, the long bag's tokens (bucket 32768)
GROWN_RING_SLEEP_CYCLES = 2_000_000_000   # (b)'s device sleep before each copy, about 1 s


def _host_memory_gb():
    """MemTotal and MemAvailable of the host (/proc/meminfo), and this
    process's resident, locked and pinned memory (/proc/self/status), GB."""
    out = {}
    for path, keys in (("/proc/meminfo", ("MemTotal", "MemAvailable")),
                       ("/proc/self/status", ("VmRSS", "VmLck", "VmPin"))):
        with open(path) as f:
            kb = {ln.split(":")[0]: ln.split()[1:] for ln in f}
        out.update({k: int(kb[k][0]) * 1024 / 1e9 for k in keys if k in kb})
    return out


@contextlib.contextmanager
def _least_available_gb(every_s=0.25):
    """Samples MemAvailable (GB) every `every_s` seconds in a thread while
    the block runs; yields a dict whose "least" is the smallest sample."""
    seen = {"least": _host_memory_gb()["MemAvailable"], "samples": 0}
    stop = threading.Event()

    def poll():
        while not stop.wait(every_s):
            seen["least"] = min(seen["least"], _host_memory_gb()["MemAvailable"])
            seen["samples"] += 1

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        yield seen
    finally:
        stop.set()
        poller.join()


def _grown_cohort(ragged_root, root, n_long):
    """<root>/feats: a symlink to each of the ragged cohort's bags but case
    0's H&E bag, a new bf16 bag of `n_long` tokens; <root>/ACROBAT.csv a
    symlink to its CSV; <root>/downstream/patch_embeddings: symlinks to its
    slides but slide 0, `n_long` tokens. The shared cohort is not touched.
    Returns the long bag's path."""
    from madeleine_torch.native.bagio import write_bag_file

    gen = np.random.default_rng(SEED + 11)
    for sub in ("feats", os.path.join("downstream", "patch_embeddings")):
        os.makedirs(os.path.join(root, sub))
        for fn in sorted(os.listdir(os.path.join(ragged_root, sub))):
            os.symlink(os.path.join(ragged_root, sub, fn), os.path.join(root, sub, fn))
    os.symlink(os.path.join(ragged_root, "ACROBAT.csv"), os.path.join(root, "ACROBAT.csv"))
    long_bag = os.path.join(root, "feats", "case00_HE.bag")
    os.remove(long_bag)
    x = gen.standard_normal((n_long, 512), dtype=np.float32)
    x += TRAIN_SIGNAL * gen.standard_normal(512, dtype=np.float32)
    write_bag_file(long_bag, x, dtype="bfloat16")
    slide = os.path.join(root, "downstream", "patch_embeddings", "slide_00.npz")
    os.remove(slide)
    np.savez(slide, features=gen.standard_normal((n_long, 512), dtype=np.float32))
    return long_bag


def _by_bucket(buckets, values):
    """{bucket: [values]} of per-batch values beside their buckets."""
    out = {}
    for b, v in zip(buckets, values):
        out.setdefault(str(b), []).append(v)
    return out


def _grown_cli(torch, root, bucket):
    """(a): the CLI's main at the published batch of 65 on full bags, two
    epochs (4 steps, one a epoch at `bucket`), on the grown cohort at
    `root`: every step finite and applied, K6-K14 every step, K1
    downstream (a slide at `bucket`), nothing truncated, `bucket` on at
    least 2 steps, the native ring 2 slots deep. Returns its report."""
    slot = 65 * len(PRETRAIN_STAINS) * bucket * 512 * 2
    before = _host_memory_gb()
    with _least_available_gb() as during:
        results, records, wall = _run_pretrain_cli(
            _pretrain_argv(root, os.path.join(root, "grown"), 2, "--checkpoint_every", "1",
                           n_subsamples=None),
            os.path.join(root, "pretrain_grown.log"))
    parts = CLI_RUNS[-1]["parts_s"]
    run, _ = _check_pretrain_run("grown", results, records, range(2))
    at_bucket = sum(b == bucket for b in run["buckets"])
    if (at_bucket < 2 or any(run["truncation_count"]) or run["ring_depth"] != 2
            or run["pinned_bytes"] != 2 * slot):
        raise AssertionError(f"pretrain_ragged grown (b = 65): buckets {run['buckets']}, "
                             f"truncations {run['truncation_count']}, ring depth "
                             f"{run['ring_depth']}, pinned {run['pinned_bytes']} (want 2 x "
                             f"{slot})")
    return {"batch_size": 65, "epochs": 2, "bucket": bucket, "steps_at_bucket": at_bucket,
            "run": run, "cli_wall_s": wall, "ring_depth": run["ring_depth"],
            "pinned_bytes": run["pinned_bytes"], "pinned_bytes_four_slots": 4 * slot,
            "ring_construction_s": parts["loader"],
            "mem_available_gb_before": before["MemAvailable"],
            "mem_available_gb_least_during": during["least"], "mem_samples": during["samples"],
            "mem_total_gb": before["MemTotal"],
            "loader_ms_by_bucket": _by_bucket(run["buckets"], run["loader_ms"]),
            "guard_wait_ms_by_bucket": _by_bucket(run["buckets"], run["guard_wait_ms"]),
            "assemble_ms_by_bucket": _by_bucket(run["buckets"], run["assemble_ms"]),
            "step_ms_by_bucket": _by_bucket(run["buckets"], run["step_ms"]),
            "peak_memory_gb": run["peak_memory_gb"]}


def _grown_ring(torch, root, long_bag, bucket):
    """(b): a NativeRaggedLoader of 65 cases a batch on the grown cohort (2
    pinned slots at `bucket`) through a Prefetcher of depth 2 for two
    epochs, the consumer queuing each batch's copy to the card (into a
    buffer made beforehand) behind about 1 s of device sleep and then
    recording it, its host ms per batch reported: the third batch waits on
    its slot's guard; on the card every row past a bag's length is zero;
    in each batch at `bucket` the last task (324, past 2**31 elements into
    the slot), the last present task and the long bag equal the plain
    route's rows of their .bag files bit for bit. Returns its report."""
    from madeleine_torch.data.datasets import Prefetcher
    from madeleine_torch.native import bagio
    from madeleine_torch.native.dataset import NativeRaggedLoader

    feats = os.path.join(root, "feats")
    mem_before, t0 = _host_memory_gb(), time.perf_counter()
    loader = NativeRaggedLoader(os.path.join(root, "ACROBAT.csv"), feats, PRETRAIN_STAINS,
                                embedding_size=512, batch_size=65, seed=PRETRAIN_SEED,
                                out_dtype="bfloat16", device="cuda")
    build_s = time.perf_counter() - t0
    mem_built = _host_memory_gb()
    depth, pinned = loader.ring_depth, loader.pinned_bytes
    # the copies land in buffers of a slot's size made before the first batch,
    # so no allocation (a cudaMalloc of up to a slot, or a release of cached
    # blocks that waits for the card) holds the consumer between batches
    dests = [torch.empty(pinned // depth // 2, dtype=torch.bfloat16, device="cuda")
             for _ in range(4)]
    torch.cuda.synchronize()
    got, waits, consumer_ms = [], [], []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        for b in Prefetcher(loader, depth=2):
            t0 = time.perf_counter()
            torch.cuda._sleep(GROWN_RING_SLEEP_CYCLES)
            src = b["feats"]
            dev = dests[len(got) % len(dests)][:src.numel()].view(src.shape)
            dev.copy_(src, non_blocking=True)
            b["copied"].record()
            consumer_ms.append((time.perf_counter() - t0) * 1e3)
            got.append((dev, b["token_mask"], b["sample_mask"], b["slide_ids"]))
        waits += [t["guard_wait_ms"] for t in loader.timings]
    torch.cuda.synchronize()
    loader.close()
    if depth != 2 or len(got) != 4 or waits[2] < 50:
        raise AssertionError(f"pretrain_ragged grown ring: depth {depth}, {len(got)} batches, "
                             f"guard waits {waits} ms (the third must wait)")
    checked, nonzero_pad = [], 0
    for dev, token_mask, sample_mask, slide_ids in got:
        mask = torch.from_numpy(np.ascontiguousarray(token_mask)).to("cuda")
        pad = sum(((dev[i] != 0).any(-1) & ~mask[i]).sum() for i in range(dev.shape[0]))
        nonzero_pad += int(pad)
        t = dev.shape[2]
        if t != bucket:
            continue
        cases = [slide_ids[r] if sample_mask[r] else slide_ids[0] for r in range(65)]
        paths = [os.path.join(feats, f"{c}_{s}.bag") for c in cases for s in PRETRAIN_STAINS]
        present = [k for k, path in enumerate(paths) if os.path.exists(path)]
        tasks = {324, present[-1], paths.index(long_bag)}
        for k in sorted(tasks):
            r, s = divmod(k, len(PRETRAIN_STAINS))
            reader = bagio.PlainBag(paths[k]) if k in present else None
            want = bagio.assemble_batch_plain([reader], np.arange(t)[None], 512, torch.bfloat16)
            equal = torch.equal(dev[r, s].cpu().view(torch.int16), want[0].view(torch.int16))
            checked.append({"task": k, "offset_elements": k * t * 512,
                            "bag": os.path.basename(paths[k]) if reader else None,
                            "rows": reader.n_rows if reader else 0, "bitwise_equal": equal})
    del got, dests
    if nonzero_pad or not checked or not all(c["bitwise_equal"] for c in checked) or not any(
            c["offset_elements"] >= 2 ** 31 for c in checked):
        raise AssertionError(f"pretrain_ragged grown ring: {nonzero_pad} padded rows not "
                             f"zero; tasks {checked}")
    return {"ring_depth": depth, "pinned_bytes": pinned, "construction_s": build_s,
            "host_memory_gb_before": mem_before, "host_memory_gb_built": mem_built,
            "guard_wait_ms": waits, "consumer_ms": consumer_ms, "nonzero_padded_rows": nonzero_pad, "tasks": checked,
            "sleep_cycles_before_each_copy": GROWN_RING_SLEEP_CYCLES}


def _csv_tool(ragged_root):
    """(c): `python -m madeleine_torch.tools.build_dataset_csvs
    --scan_features` (its main, here) over empty stand-ins named like the
    ragged cohort's bags as .npz: the manifest must equal the cohort's CSV
    byte for byte (its cases, stain flags and splits). pandas is absent
    from this machine."""
    from madeleine_torch.tools import build_dataset_csvs

    root = tempfile.mkdtemp(prefix="csv_tool_")
    try:
        stand_ins = os.path.join(root, "feats")
        os.makedirs(stand_ins)
        for fn in os.listdir(os.path.join(ragged_root, "feats")):
            open(os.path.join(stand_ins, fn[:-len(".bag")] + ".npz"), "w").close()
        out = os.path.join(root, "ACROBAT.csv")
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            build_dataset_csvs.main(["--scan_features", stand_ins, "--out", out])
        got = open(out, "rb").read()
        want = open(os.path.join(ragged_root, "ACROBAT.csv"), "rb").read()
        n_files = len(os.listdir(stand_ins))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if got != want:
        raise AssertionError(f"csv tool: the manifest differs from the cohort's CSV:\n"
                             f"{got[:400]!r}\n{want[:400]!r}")
    return {"stand_ins": n_files, "rows": got.count(b"\n") - 1, "equal_to_cohort_csv": True,
            "pandas_importable": importlib.util.find_spec("pandas") is not None,
            "printed": printed.getvalue().splitlines()}


def _pretrain_grown(torch, ragged_root):
    """(a) The pretrain CLI's main in this process at the published batch
    of 65 (full bags, the launch script's other flags, two epochs of two
    steps, checkpoints every epoch, the downstream pass) on a cohort of
    links to the ragged cohort's 70 cases where case 0's H&E bag has 20000
    tokens (the loaders grow its batch's bucket to 32768) and so has the
    first downstream slide (K1 at the inference loader's bucket 32768):
    every step finite and applied, K6-K14 every step, K1 downstream,
    nothing truncated, at least 2 steps at 32768, the native ring 2 slots
    deep (21.81 GB pinned, against 4 slots' 43.62 GB); its construction
    seconds, the host's MemAvailable before and during the run, host ms
    and guard wait a batch and step ms by bucket, the peak. (b) The ring at
    depth 2 at that size under a Prefetcher (`_grown_ring`). (c) The CSV
    tool on the ragged cohort's names (`_csv_tool`). Then the --batch_size 8
    epoch with --activation sigmoid on 16 cases of the same lengths (the
    per-op lane under cfg.remat at bucket 32768, kernels 15-20 every step,
    no K6/K7; a non-softmax model's downstream pass is plain), the buckets
    including 32768, nothing truncated."""
    from madeleine_torch.data.datasets import RAGGED_BUCKETS, bucket_of

    cases, bs, n_long = GROWN_PRETRAIN
    bucket = bucket_of(n_long, RAGGED_BUCKETS)
    root = tempfile.mkdtemp(prefix="pretrain_grown_")
    try:
        t0 = time.perf_counter()
        long_bag = _grown_cohort(ragged_root, os.path.join(root, "linked"), n_long)
        link_s = time.perf_counter() - t0
        try:
            grown = _grown_cli(torch, os.path.join(root, "linked"), bucket)
        finally:
            _release_host_cache(torch)
        try:
            ring = _grown_ring(torch, os.path.join(root, "linked"), long_bag, bucket)
        finally:
            _release_host_cache(torch)
        csv_tool = _csv_tool(ragged_root)
        t0 = time.perf_counter()
        sig_root = os.path.join(root, "sigmoid")
        n_bags, n_bytes = _write_pretrain_cohort(sig_root, np.random.default_rng(SEED + 10),
                                                 tokens=RAGGED_PRETRAIN_TOKENS,
                                                 dtype="bfloat16", cases=cases, long_bag=n_long)
        write_s = time.perf_counter() - t0
        results, records, wall_sig = _run_pretrain_cli(
            _pretrain_argv(sig_root, os.path.join(sig_root, "grown_sigmoid"), 1, "--batch_size",
                           str(bs), "--checkpoint_every", "1", "--activation", "sigmoid",
                           n_subsamples=None),
            os.path.join(sig_root, "pretrain_grown_sigmoid.log"))
        run_sig, _ = _check_pretrain_run("grown_sigmoid", results, records, range(1),
                                         kernels=PEROP_KERNELS + GOT_KERNELS + GLUE_KERNELS,
                                         downstream_kernel=None)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _release_host_cache(torch)
    fused = {k: run_sig["launches"].get(k, 0) for k in ENCODER_KERNELS}
    if bucket not in run_sig["buckets"] or any(run_sig["truncation_count"]) or any(
            fused.values()):
        raise AssertionError(f"pretrain_ragged grown bucket (sigmoid): buckets "
                             f"{run_sig['buckets']}, truncations "
                             f"{run_sig['truncation_count']}, K6/K7 launched {fused}")
    return {"long_bag_tokens": n_long, "bucket": bucket, "link_s": link_s,
            "published_batch": grown, "ring_at_depth_2": ring, "csv_tool": csv_tool,
            "run": grown["run"], "sigmoid": {
                "cases": cases, "batch_size": bs, "bags": n_bags, "cohort_gb": n_bytes / 1e9,
                "cohort_write_s": write_s, "pinned_bytes": run_sig["pinned_bytes"],
                "ring_depth": run_sig["ring_depth"], "cli_wall_s": wall_sig},
            "sigmoid_run": run_sig, "host_memory_gb": _host_memory_gb()}


# the f32 sigmoid CLI epoch's peak measured before the per-op lane read
# cfg.remat, every modality's saves kept until the backward (PERF.md §5)
NO_REMAT_F32_SIGMOID_CLI_PEAK_GB = 70.878


def phase_pretrain_f32(state):
    """The pretrain CLI's `main` in this process at --precision float32 with
    the launch script's other flags and its default full bags
    (--n_subsamples -1) on pretrain_ragged's synthetic cohort (70 cases of
    bf16 .bag bags of 300-8000 tokens, bucket 8192; the native loader
    assembles f32): A 1 epoch with --checkpoint_every 1, B A resumed to 2, C
    2 straight, B's model.pt equal to C's bit for bit. Every step finite and
    applied, K6/K7 with f32 operands (on the recompute route: a call's saves,
    15.3 GB in f32, pass the 10 GiB budget) and K8-K14 on every step, no
    bf16 K6/K7, K2 in the downstream pass; the CLI step ms and the peak.
    Then one epoch with --activation sigmoid on the same cohort (the per-op
    lane at f32 under cfg.remat): every step finite and applied, rows 15-18
    with f32 operands on every step, no bf16 row 15-18 and no K6/K7; its
    peak beside the 70.88 GB measured before the lane read cfg.remat."""
    import torch

    root = _ragged_cohort(state)[0]   # pretrain_ragged's cohort
    try:
        runs, _, walls, resume = _pretrain_trio(
            root, "f32_", 1, 2, "--precision", "float32", n_subsamples=None,
            kernels=F32_KERNELS + GOT_KERNELS + GLUE_KERNELS, downstream_kernel="gated_pool",
            loader="native-f32")
        # the per-op lane at f32: one epoch with --activation sigmoid (rows 15-18
        # with f32 operands; a non-softmax model's eval forward is plain)
        results, records, wall_sig = _run_pretrain_cli(
            _pretrain_argv(root, os.path.join(root, "f32_sigmoid"), 1, "--checkpoint_every", "1",
                           "--precision", "float32", "--activation", "sigmoid",
                           n_subsamples=None),
            os.path.join(root, "pretrain_f32_sigmoid.log"))
        run_sig, _ = _check_pretrain_run("f32_sigmoid", results, records, range(1),
                                         kernels=PEROP_F32_KERNELS + GOT_KERNELS + GLUE_KERNELS,
                                         downstream_kernel=None, loader="native-f32")
    finally:
        _drop_ragged_cohort(state)
        _release_host_cache(torch)
    other = {k: run_sig["launches"].get(k, 0) for k in PEROP_BF16_ROWS + ENCODER_KERNELS
             + F32_KERNELS if run_sig["launches"].get(k, 0)}
    if other:
        raise AssertionError(f"pretrain_f32 sigmoid: other encoder kernels launched {other}")
    launches = {k: sum(r["launches"].get(k, 0) for r in runs.values()) for k in read_counts()}
    every = list(runs.values())
    steps = sum(len(r["losses"]) for r in every)
    n_calls = steps * len(PRETRAIN_STAINS)
    routes = {"k6_nosave": launches["encoder_train_fwd_f32_nosave"],
              "k7_recompute": launches["encoder_train_bwd_f32_recompute"]}
    if any(launches[k] for k in ENCODER_KERNELS) or routes != {"k6_nosave": n_calls,
                                                               "k7_recompute": n_calls}:
        raise AssertionError(f"pretrain_f32: routes {routes} of {n_calls} calls, bf16 K6/K7 "
                             f"{[launches[k] for k in ENCODER_KERNELS]}")
    state["launches_pretrain_f32"] = {k: v + run_sig["launches"].get(k, 0)
                                      for k, v in launches.items()}
    warm = [ms for r in every for ms in r["step_ms"][1:]]
    emit({"phase": "pretrain_f32", "smi": state["smi"], "cases": PRETRAIN_CASES,
          "bag_tokens": list(RAGGED_PRETRAIN_TOKENS),
          "flags": "launch script's with --precision float32, without --n_subsamples",
          "runs": runs, "cli_wall_s": walls, **resume, "route_launches": routes,
          "step_ms_median_warm": statistics.median(warm),
          "peak_memory_gb": max(r["peak_memory_gb"] for r in every),
          "sigmoid": {"run": run_sig, "cli_wall_s": wall_sig,
                      "flags": "and --activation sigmoid (rows 15-18 f32, cfg.remat)",
                      "step_ms": run_sig["step_ms"],
                      "peak_memory_gb": run_sig["peak_memory_gb"],
                      "peak_memory_gb_without_remat": NO_REMAT_F32_SIGMOID_CLI_PEAK_GB}})


DP_BS = 64                   # (b)'s global batch: 32 rows a rank
DP_RAGGED = (16, 1024, 4096)  # (b)'s ragged step: rows, shortest and longest bag (the bucket)
DP_BAG = (8, 4096)           # (c): bags, tokens
DP_SEED = 17                 # the steps' seed in (b)
DP_TIMED_STEPS = 3           # (b): dense steps timed after the compared one
DP_HE_REL = 1e-4             # (b): H&E embeddings, relative Frobenius
DP_LOSS_REL = 1e-5           # (b): the loss, relative
# (b): each gradient's error over the norms of what was summed (the world-1
# gradient and each rank's): one bf16 rounding step (bc: BC_ATOL)
DP_GRAD_SUMMANDS = 2.0 ** -8
DP_BAG_ATOL = 3e-2           # (c): against K1's encode, K1's bar
DP_KERNELS = ENCODER_KERNELS + GOT_KERNELS + GLUE_KERNELS


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_group(backend, rank, world, port):
    """The default process group from a TCPStore on localhost."""
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", port, world, rank == 0)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    return dist.group.WORLD


def _dp_step(torch, step, batch, seed):
    """One step: (H&E embeddings, loss, {name: gradient}) on the host."""
    he, metrics = step(batch, seed)
    if bool(metrics["skipped"]):
        raise AssertionError("data_parallel: a step was skipped")
    return (he.float().cpu(), float(metrics["loss"]),
            {n: p.grad.detach().float().cpu() for n, p in step.model.named_parameters()
             if p.grad is not None})


def _dp_inputs(torch, rank=0, world=1, precision="bfloat16"):
    """(b)'s and (c)'s inputs, made on the card from seeds (every process
    makes the same), and this rank's share: (cfg, model, initial weights,
    the dense batch's rows, the ragged batch's rows, the bags' token shard);
    the step at `precision`."""
    from madeleine_torch.parallel.mesh import shard_batch

    cfg, model, _, dense = _train_setup(torch, got_path_config(batch_size=DP_BS,
                                                               precision=precision))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rows, lo, hi = DP_RAGGED
    ragged = ragged_batch(torch, ragged_lengths(SEED + 31, rows, cfg.n_modalities, lo, hi),
                          SEED + 32, t=hi)
    b, t = DP_BAG
    g = torch.Generator(device="cuda").manual_seed(SEED + 33)
    bags = torch.randn(b, t, cfg.patch_embedding_dim, generator=g, device="cuda").to(
        torch.bfloat16)
    lt = t // world
    return (cfg, model, init, shard_batch(dense, rank, world), shard_batch(ragged, rank, world),
            bags[:, rank * lt:(rank + 1) * lt].contiguous())


def _dp_results(torch, cfg, model, init, dense, ragged, bags, group):
    """(b)'s two steps from the initial weights and (c)'s bag-parallel
    encode on `group` (None: one process, no group; (c) then K1's encode;
    with an f32 step, no (c))."""
    from madeleine_torch.models.madeleine import encode
    from madeleine_torch.parallel import collectives
    from madeleine_torch.parallel.bag_parallel import encode_bag_parallel
    from madeleine_torch.train.optim import make_optimizer
    from madeleine_torch.train.trainer import make_train_step

    out, local = {}, {}
    sum_gradients = collectives.sum_gradients

    def keep_local(params, grp):   # this rank's gradients, before the sum over ranks
        params = list(params)
        local.update({id(p): p.grad.detach().float().cpu() for p in params
                      if p.grad is not None})
        sum_gradients(params, grp)

    for name, batch in (("dense", dense), ("ragged", ragged)):
        model.load_state_dict(init)
        opt, sched = make_optimizer(cfg, model.parameters(), steps_per_epoch=TRAIN_STEPS)
        step = make_train_step(cfg, model, opt, sched, group=group)
        local.clear()
        collectives.sum_gradients = keep_local
        try:
            out[name] = _dp_step(torch, step, batch, DP_SEED)
        finally:
            collectives.sum_gradients = sum_gradients
        out[name + "_local"] = {n: local[id(p)] for n, p in model.named_parameters()
                                if id(p) in local}
        if name == "dense":   # then the step's wall ms, the host waiting for each
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(DP_TIMED_STEPS):
                step(batch, DP_SEED + 1 + i)
                torch.cuda.synchronize()
            out["dense_step_ms"] = (time.perf_counter() - t0) * 1e3 / DP_TIMED_STEPS
    if cfg.precision != "bfloat16":
        return out
    model.load_state_dict(init)
    model.eval()
    with torch.no_grad():
        out["bag"] = (encode(model, bags) if group is None
                      else encode_bag_parallel(model, bags, group)).float().cpu()
    return out


DP_PRECISIONS = ("bfloat16", "float32")   # (b)'s steps, both in each rank's one process


def dp_worker(rank: int, world: int, port: int, out_path: str) -> None:
    """One rank of (b): a Gloo group over CUDA tensors on the one card; runs
    `_dp_results` on its rows with the step at each of DP_PRECISIONS, and
    saves them to out_path ({precision: results})."""
    import torch

    sys.path.insert(0, HERE)
    from madeleine_torch.utils.device import resolve_device

    resolve_device("cuda")
    group = _init_group("gloo", rank, world, port)
    out = {}
    for precision in DP_PRECISIONS:
        cfg, model, init, dense, ragged, bags = _dp_inputs(torch, rank, world, precision)
        out[precision] = _dp_results(torch, cfg, model, init, dense, ragged, bags, group)
        del model, init, dense, ragged, bags
        torch.cuda.empty_cache()
    torch.save(out, out_path)
    torch.distributed.destroy_process_group()


def _dp_world_2(torch):
    """(b)'s two ranks, each a process on the one card that runs the step at
    each of DP_PRECISIONS (one process start for both): their saved results
    ({precision: [rank 0's, rank 1's]}) and the wall seconds."""
    tmp, procs = tempfile.mkdtemp(prefix="dp_"), []
    try:
        port = _free_port()
        t0 = time.perf_counter()
        for r in range(2):
            code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
                    f"chip_smoke.dp_worker({r}, 2, {port}, {os.path.join(tmp, f'rank{r}.pt')!r})")
            log = open(os.path.join(tmp, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen([sys.executable, "-c", code], cwd=HERE, stdout=log,
                                           stderr=subprocess.STDOUT), log))
        rcs = [p.wait(timeout=600) for p, _ in procs]
        wall = time.perf_counter() - t0
        for _, log in procs:
            log.close()
        if any(rcs):
            logs = "\n".join(open(os.path.join(tmp, f"rank{r}.log")).read()[-3000:]
                             for r in range(2))
            raise AssertionError(f"data_parallel (b): a rank failed ({rcs}):\n{logs}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
        return {p: [r[p] for r in ranks] for p in DP_PRECISIONS}, wall
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)


def _dp_gather(torch, ranks):
    """The world-2 step's results (the ranks' H&E rows in rank order, the
    loss, the summed gradients) and whether both ranks hold the same loss
    and gradients."""
    got = {name: (torch.cat([r[name][0] for r in ranks]), ranks[0][name][1], ranks[0][name][2])
           for name in ("dense", "ragged")}
    same = all(ranks[0][n][1] == ranks[1][n][1] and all(
        torch.equal(ranks[0][n][2][k], ranks[1][n][2][k]) for k in ranks[0][n][2])
        for n in ("dense", "ragged"))
    return got, same


def _dp_compare(torch, got, want, partials, f32=False):
    """(b)'s comparison of the world-2 step (`got`; `partials`: each rank's
    gradients before their sum) with the world-1 step on the same rows:
    the H&E embeddings (relative Frobenius, DP_HE_REL), the loss (relative,
    DP_LOSS_REL), bc absolutely (BC_ATOL), and every other gradient g2
    against g1 by the bf16 rounding bound: each rank rounds its gradient of
    a bf16 operand to bf16 before the sum over ranks (as the JAX package
    does), so ||g2 - g1|| must stay within DP_GRAD_SUMMANDS, one bf16
    rounding step (2^-8), of ||g1|| + sum_r ||g_r||. A rank's gradients can
    cancel (the projector's are nearly opposite), so the plain relative
    Frobenius error is reported beside it. With the f32 step (`f32`) every
    gradient but bc is held to F32_GRAD_RTOL relative Frobenius instead.
    Returns ({step: errors}, [failures])."""
    errs, bad = {}, []
    for name in ("dense", "ragged"):
        (he, loss, grads), (he_w, loss_w, grads_w) = got[name], want[name]
        e = {"he_rel_fro": _rel_fro(he, he_w), "loss_rel": abs(loss - loss_w) / abs(loss_w),
             "loss": loss, "loss_world_1": loss_w}
        fro, summands, bc = {}, {}, {}
        for k, w in grads_w.items():
            d = grads[k] - w
            if k.endswith("attention_c.bias"):
                bc[k] = float(d.abs().max())
                continue
            fro[k] = _rel_fro(grads[k], w)
            summands[k] = float(d.norm() / (w.norm() + sum(p[name + "_local"][k].norm()
                                                            for p in partials)))
        e.update(grad_rel_fro=fro, grad_err_over_summands=summands,
                 grad_max_rel_fro=max(fro.values()),
                 grad_max_err_over_summands=max(summands.values()), bc_max_abs=max(bc.values()))
        errs[name] = e
        grads_ok = (e["grad_max_rel_fro"] <= F32_GRAD_RTOL if f32
                    else e["grad_max_err_over_summands"] <= DP_GRAD_SUMMANDS)
        if not (grads.keys() == grads_w.keys() and e["he_rel_fro"] <= DP_HE_REL
                and e["loss_rel"] <= DP_LOSS_REL and e["bc_max_abs"] <= BC_ATOL and grads_ok):
            bad.append(f"(b) {name}{' f32' if f32 else ''}: he {e['he_rel_fro']}, loss "
                       f"{e['loss_rel']}, bc {e['bc_max_abs']}, gradients "
                       f"{e['grad_max_rel_fro']} relative, {e['grad_max_err_over_summands']} "
                       f"of their summands")
    return errs, bad


def phase_data_parallel(state):
    """Data parallelism (A7) on the card. (a) World size 1 on NCCL (a
    TCPStore on localhost): 5 published InfoNCE + GOT steps (65 x 5 x 2048,
    bf16) through the step's group lane, every collective a copy; the
    weights' sha256 must equal the same steps' without a group bit for
    bit; the step ms and the host's launch ms a step of both, back to back
    in the order plain, group, group, plain; each step's collectives
    (calls, bytes). (b) World size 2 on the one card: two processes on a
    Gloo group over CUDA tensors (NCCL takes one rank a device), each
    running the bf16 and then the f32 step (`dp_worker`), a global
    batch of 64 x 5 x 2048 at the real rates, and one ragged step of 16 x 5
    x 4096, against this process's step on the same rows without a group:
    H&E embeddings within 1e-4 relative Frobenius, the loss 1e-5 relative,
    each gradient within one bf16 rounding step of the norms it sums
    (`_dp_compare`; bc within BC_ATOL). (c) Bag
    parallelism, b 8, t 4096: at world size 1 on NCCL and on each of (b)'s
    ranks (half the tokens each), against K1's encode at K1's atol 3e-2;
    row 4 launches. (d) The pretrain CLI under torchrun --nproc_per_node 1
    and without it, one epoch with the pretrain phase's flags on its
    cohort: model.pt bit for bit."""
    import torch
    import torch.distributed as dist

    from madeleine_torch.parallel import collectives
    from madeleine_torch.parallel.bag_parallel import encode_bag_parallel

    torch.cuda.empty_cache()
    out, launches = {}, {}
    # (a) world size 1 on NCCL
    t0 = time.perf_counter()
    group = _init_group("nccl", 0, 1, _free_port())
    init_s = time.perf_counter() - t0
    cfg = got_path_config()
    try:
        plain = _run_train_steps(torch, state, "data_parallel_plain", DP_KERNELS, cfg,
                                 setup=_train_setup(torch, cfg), skips=False)
        reset_counts()
        collectives.reset()
        dp = _run_train_steps(torch, state, "data_parallel", DP_KERNELS, cfg,
                              setup=_train_setup(torch, cfg, group=group))
        launches = dict(dp[3]["launches"])
        # each step's collectives: (5 steps + 1 under sync debug + 10 back to back + 2 skips)
        n_steps = TRAIN_STEPS + 1 + BACK_TO_BACK_STEPS + 2
        per_step = {k: {"calls": v["calls"] / n_steps, "bytes": v["bytes"] / n_steps,
                        "max_numel": v["max_numel"]} for k, v in collectives.read().items()}
        seeds = itertools.count(1000)
        # A/B: the two steps back to back in the order plain, group, group, plain
        ab = {"plain": [], "group": []}
        setups = {"plain": _train_setup(torch, cfg),
                  "group": _train_setup(torch, cfg, group=group)}
        for kind in ("plain", "group", "group", "plain"):
            _, _, step, batch = setups[kind]
            step(batch, next(seeds))
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t1 = time.perf_counter()
            for _ in range(BACK_TO_BACK_STEPS):
                step(batch, next(seeds))
            host = (time.perf_counter() - t1) * 1e3 / BACK_TO_BACK_STEPS
            end.record()
            end.synchronize()
            ab[kind].append({"step_ms_back_to_back": start.elapsed_time(end) / BACK_TO_BACK_STEPS,
                             "host_ms_per_step": host})
        del setups
        digest_plain = plain[3]["param_sha256_after_steps"]
        digest_dp = dp[3]["param_sha256_after_steps"]
        out["a"] = {"backend": "nccl", "world_size": 1, "init_group_s": init_s,
                    "param_sha256_plain": digest_plain, "param_sha256_group": digest_dp,
                    "bitwise_equal": digest_plain == digest_dp,
                    "losses_plain": plain[3]["losses"], "losses_group": dp[3]["losses"],
                    "step_ms_plain": plain[3]["step_ms_median_after_first"],
                    "step_ms_group": dp[3]["step_ms_median_after_first"],
                    "host_ms_plain": plain[3]["host_ms_per_step_back_to_back"],
                    "host_ms_group": dp[3]["host_ms_per_step_back_to_back"],
                    "ab_back_to_back": ab, "collectives_per_step": per_step,
                    "peak_memory_gb_group": dp[3]["peak_memory_gb"]}
        del plain, dp
        emit({"phase": "data_parallel", "smi": state["smi"], "a": out["a"]})
        if digest_plain != digest_dp:
            raise AssertionError(f"data_parallel (a): world size 1 on NCCL left other weights "
                                 f"({digest_dp}) than the step without a group ({digest_plain})")
        # (c) at world size 1 on NCCL, and the world-1 references of (b) and (c)
        cfg_b, model, init, dense, ragged, bags = _dp_inputs(torch)
        reset_counts()
        model.eval()
        with torch.no_grad():
            bag_w1 = encode_bag_parallel(model, bags, group).float()
        c_counts = read_counts()
        for k, v in c_counts.items():
            launches[k] = launches.get(k, 0) + v
        ref = _dp_results(torch, cfg_b, model, init, dense, ragged, bags, None)
        bag_err_w1 = float((bag_w1.cpu() - ref["bag"]).abs().max())
        del model, init, dense, ragged, bags
    finally:
        dist.destroy_process_group()
    if c_counts["attn_pool_ms"] < 1 or not bag_err_w1 <= DP_BAG_ATOL:
        raise AssertionError(f"data_parallel (c): row 4 launched {c_counts['attn_pool_ms']} "
                             f"times, max |err| {bag_err_w1} against K1's encode")
    torch.cuda.empty_cache()
    # (b) again with the f32 step (K6/K7 with f32 operands): nothing is rounded
    # to bf16 before the sum over ranks, so every gradient meets 1e-4
    # relative Frobenius against one process on the same rows; both steps'
    # world-1 references first, then both in each rank's one process
    cfg_f, model, init, dense, ragged, bags = _dp_inputs(torch, precision="float32")
    ref_f = _dp_results(torch, cfg_f, model, init, dense, ragged, bags, None)
    del model, init, dense, ragged, bags
    torch.cuda.empty_cache()
    # (b) world size 2 on the one card, Gloo over CUDA tensors
    by_precision, wall_b = _dp_world_2(torch)
    ranks = by_precision["bfloat16"]
    got, same = _dp_gather(torch, ranks)
    errs, failures = _dp_compare(torch, got, ref, ranks)
    bag_err_w2 = [float((r["bag"] - ref["bag"]).abs().max()) for r in ranks]
    if not same or not max(bag_err_w2) <= DP_BAG_ATOL:
        failures.append(f"(b)/(c): ranks agree {same}, bag-parallel max |err| {bag_err_w2}")
    out["b"] = {"backend": "gloo (CUDA tensors)", "world_size": 2, "global_batch": DP_BS,
                "ragged": list(DP_RAGGED), "seed": DP_SEED,
                "wall_s_both_precisions": wall_b,
                "step_ms_world_2": [r["dense_step_ms"] for r in ranks],
                "step_ms_world_1_same_rows": ref["dense_step_ms"],
                "ranks_agree": same, **errs}
    out["c"] = {"bags": list(DP_BAG), "max_abs_err_world_1_nccl": bag_err_w1,
                "max_abs_err_world_2_gloo": bag_err_w2, "bar": DP_BAG_ATOL,
                "row4_launches_world_1": c_counts["attn_pool_ms"]}
    emit({"phase": "data_parallel", "smi": state["smi"], "b": out["b"], "c": out["c"]})
    ranks = by_precision["float32"]
    got, same = _dp_gather(torch, ranks)
    errs_f, bad_f = _dp_compare(torch, got, ref_f, ranks, f32=True)
    if not same:
        bad_f.append("(b) f32: the ranks disagree")
    failures += bad_f
    out["b_f32"] = {"backend": "gloo (CUDA tensors)", "world_size": 2,
                    "step_ms_world_2": [r["dense_step_ms"] for r in ranks],
                    "step_ms_world_1_same_rows": ref_f["dense_step_ms"], "ranks_agree": same,
                    "grad_rtol_fro": F32_GRAD_RTOL, **errs_f}
    emit({"phase": "data_parallel", "smi": state["smi"], "b_f32": out["b_f32"]})
    # (d) the CLI under torchrun --nproc_per_node 1 against the plain CLI, on
    # the pretrain phase's cohort (written here when that phase did not run)
    root = state.pop("pretrain_cohort", None)
    try:
        if root is None:
            root = tempfile.mkdtemp(prefix="dp_cli_")
            _write_pretrain_cohort(root, np.random.default_rng(SEED + 7))
        sds, walls, digests = {}, {}, {}
        for name, launcher in (("plain", ()), ("torchrun", ("torch.distributed.run",
                                                             "--standalone",
                                                             "--nproc_per_node", "1"))):
            log_path = os.path.join(root, f"{name}.log")
            results, records, walls[name] = _run_pretrain_cli(
                _pretrain_argv(root, os.path.join(root, name), 1, "--checkpoint_every", "1"),
                log_path, launcher)
            run, sds[name] = _check_pretrain_run(f"dp_{name}", results, records, range(1))
            if name == "torchrun":   # the lane's own launches
                for k, v in run["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            digests[name] = [ln.rsplit(" ", 1)[1] for ln in open(log_path).read().splitlines()
                             if "parameters sha256" in ln]
    finally:
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)
    equal = all(torch.equal(sds["plain"][k], sds["torchrun"][k]) for k in sds["plain"])
    out["d"] = {"model_pt_bitwise_equal": equal, "cli_wall_s": walls,
                "param_sha256": digests}
    if not equal:
        failures.append(f"(d): torchrun's model.pt differs from the plain CLI's ({digests})")
    emit({"phase": "data_parallel", "smi": state["smi"], "d": out["d"]})
    if failures:
        raise AssertionError("data_parallel: " + "; ".join(failures))
    state["launches_data_parallel"] = launches
    state["data_parallel"] = out


# kernel-name prefixes of K8-K10 and of K11-K14 in a profiler trace
TRANSPORT_NAMES = ("ipot_fwd_kernel", "ipot_bwd_kernel", "gw_gamma_kernel",
                   "ipot_fwd_cluster_kernel", "ipot_bwd_cluster_kernel",
                   "gw_gamma_cluster_kernel")
GLUE_NAMES = ("tb_fwd_kernel", "tb_bwd_kernel", "gwt_fwd_kernel", "gwt_bwd_kernel",
              "gwt_fwd_tiles_kernel", "gwt_fwd_sum_kernel", "gwt_bwd_tiles_kernel")


def _kernel_base(name):
    """'(anonymous namespace)::tb_fwd_kernel(float const*, ...' -> 'tb_fwd_kernel';
    template arguments go too ('gw_gamma_cluster_kernel<true>(...' ->
    'gw_gamma_cluster_kernel')."""
    return name.split("(anonymous namespace)::")[-1].split("(")[0].split("<")[0].split("::")[-1]


def _split_got_rows(rows):
    """Device ms of the glue kernels, the transport kernels and everything else."""
    parts = {"glue_kernels_ms": 0.0, "transport_kernels_ms": 0.0, "other_ms": 0.0}
    for name, _, ms in rows:
        base = _kernel_base(name)
        key = ("glue_kernels_ms" if base in GLUE_NAMES else
               "transport_kernels_ms" if base in TRANSPORT_NAMES else "other_ms")
        parts[key] += ms
    return parts


def _profile_rows(prof):
    """[(kernel name, launches, device ms)] of a torch.profiler run, longest first."""
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us:
            rows.append((ev.key[:90], ev.count, us / 1e3))
    return sorted(rows, key=lambda r: -r[2])


def _profiled(torch, fn):
    """[(kernel, launches, device ms)] of one call of fn, from the second of
    two profiled windows: the first window of a profiler can miss
    the kernels launched at its start (the K6 forward read 0 to 0.015 ms
    that way), so a warm-up window runs first (torch.profiler.schedule)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return _profile_rows(prof)


PROFILE_WINDOWS = 10   # profiled windows a call may take before its window is complete
PROFILE_B2B_STEPS = 3  # train steps in one profiled window, launched back to back
# What a profiled window of each wrapper call must show before the absence of
# the mma.sync GEMM (gemm_bf16_kernel) in it counts: the TMA + wgmma GEMM's
# launches (wg::gemm_kernel, one per product the call runs) and the row
# kernels it launches besides. The profiler can lose a window, whole or in
# part, late in a full run; a window short of these is taken again.
WINDOW_KERNELS = {
    "encoder_train_fwd": (5, ("ln_gelu_fwd", "gate_logits_sum", "pool_partial", "pool_merge")),
    "encoder_train_bwd": (9, ("recon_h", "pool_bwd", "gate_bwd", "layer_bwd", "colsum_rows",
                              "colsum_reduce_kernel")),
    "preattn_fwd": (3, ("ln_gelu_rows_train",)),
    "preattn_bwd": (8, ("ln_gelu_rows_train", "layer_bwd", "colsum_reduce_kernel")),
    "gated_logits_fwd": (1, ("gate_logits_sum",)),
    "gated_logits_bwd": (3, ("colsum_reduce_kernel",)),
    "linear_tok_fwd": (1, ()),
    "linear_tok_bwd": (2, ("colsum_rows", "colsum_reduce_kernel")),
}


def _window_short(rows, calls):
    """What a profiled window lacks of the kernels that `calls` ({wrapper:
    calls in the window}) launch; empty when it shows them all."""
    gemm = sum(c for k, c, _ in rows if "wg::gemm_kernel" in k)
    want = sum(WINDOW_KERNELS[k][0] * n for k, n in calls.items() if k in WINDOW_KERNELS)
    seen = {_kernel_base(k) for k, _, _ in rows}
    short = [f"wg::gemm_kernel {gemm} of {want}"] if gemm < want else []
    for k, n in calls.items():
        if n and k in WINDOW_KERNELS:
            short += [r for r in WINDOW_KERNELS[k][1] if r not in seen and r not in short]
    return short


def _complete_window(torch, fn, what, calls=None):
    """(rows, windows taken) of the first profiled window (`_profiled`) of
    fn that shows every kernel its wrapper calls launch: `calls` {wrapper:
    calls per window}, or read from the launch counters around each try
    (fn runs twice a try). Raises after PROFILE_WINDOWS short windows."""
    short = []
    for windows in range(1, PROFILE_WINDOWS + 1):
        before = read_counts()
        rows = _profiled(torch, fn)
        after = read_counts()
        n = calls or {k: (after[k] - before[k]) // 2 for k in after}
        short = _window_short(rows, n)
        if not short:
            return rows, windows
    raise AssertionError(f"profile: {what}: no complete window in {PROFILE_WINDOWS}; "
                         f"the last lacks {short}")


def phase_profile(state):
    """Device time by kernel of one K6 and one K7 call at the train step's
    call shape [65, 2048] (torch.profiler, CUDA activity), flagship weights."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from madeleine_torch.models.madeleine import MADELEINE, train_weights
    from madeleine_torch.config import MadeleineConfig
    from madeleine_torch.ops import encoder_train as et

    cfg = MadeleineConfig.from_dict(flagship_config("bfloat16"))
    model = MADELEINE(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flagship_state_dict().items()})
    with torch.no_grad():
        w = {k: v.detach().contiguous().cuda()
             for k, v in train_weights(model, torch.bfloat16).items()}
        g = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn(65, 2048, 512, generator=g, device="cuda").to(torch.bfloat16)
        bias = et.token_mask_bias(None, 65, 2048, "cuda")
        rates = (et.PRE_RATE, et.GATE_RATE)
        out = {}
        for name in ("fwd", "bwd"):
            def run():
                fwd = et.encoder_train_fwd_cuda(x, bias, w, 1, 0, *rates)
                if name == "bwd":
                    pooled32, m, s, _, l, saved = fwd
                    gp = torch.randn_like(pooled32)
                    inner = (gp * pooled32).reshape(65, 4, -1).sum(-1)
                    dtok = torch.zeros(65, 2048, 128, device="cuda", dtype=torch.bfloat16)
                    torch.cuda.synchronize()
                    return lambda: et.encoder_train_bwd_cuda(x, l, m, s, gp, inner, dtok, saved,
                                                             w, 1, 0, *rates)
                return lambda: et.encoder_train_fwd_cuda(x, bias, w, 1, 0, *rates)
            fn = run()
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:   # a single window
                fn()
                torch.cuda.synchronize()
            single = sum(r[2] for r in _profile_rows(prof))
            rows, windows = _complete_window(torch, fn, f"K6/K7 ({name})",
                                             {f"encoder_train_{name}": 1})
            # every product of K6/K7 runs on the TMA + wgmma GEMM
            left = [[k, c, ms] for k, c, ms in rows if "gemm_bf16_kernel" in k]
            if left:
                raise AssertionError(f"profile: K6/K7 ({name}) still launch the mma.sync GEMM: "
                                     f"{left}")
            out[name] = {"total_ms": sum(r[2] for r in rows), "single_window_total_ms": single,
                         "wgmma_gemm_ms": sum(ms for k, _, ms in rows if "wg::gemm_kernel" in k),
                         "mma_sync_gemm_launches": 0, "profiled_windows": windows,
                         "by_kernel_ms": [[k, c, ms] for k, c, ms in rows[:16]]}
        # rows 15-18 and 20 alone at the same call shape, the real rates:
        # every product on the TMA + wgmma GEMM, and what sets their pace
        from madeleine_torch.ops import gated_logits as gl
        from madeleine_torch.ops import linear_tok as lt
        from madeleine_torch.ops import preattn as pa

        y = pa.preattn_fwd_cuda(x, w, 1, 0, rates[0])
        dy = torch.randn(65, 2048, y.shape[-1], generator=g, device="cuda").to(torch.bfloat16)
        dl = torch.randn(65, 2048, w["wa"].shape[0], generator=g, device="cuda")
        dtok = torch.randn(65, 2048, w["wt"].shape[0], generator=g, device="cuda").to(
            torch.bfloat16)
        for name, fn in (("preattn_fwd", lambda: pa.preattn_fwd_cuda(x, w, 1, 0, rates[0])),
                         ("preattn_bwd", lambda: pa.preattn_bwd_cuda(x, dy, w, 1, 0, rates[0])),
                         ("gated_logits_fwd",
                          lambda: gl.gated_logits_fwd_cuda(y, w, 1, 0, rates[1])),
                         ("gated_logits_bwd",
                          lambda: gl.gated_logits_bwd_cuda(y, dl, w, 1, 0, rates[1])),
                         ("linear_tok_bwd", lambda: lt.linear_tok_bwd_cuda(y, dtok, w["wt"]))):
            fn()
            # late in a full run the profiler can lose a short call's window,
            # whole or in part (rows 15 and 17, about 2 ms each, read empty
            # in one full run; row 15 lost a row kernel in another): take it
            # again until it shows every kernel the call launches, and fail
            # rather than pass the check below on a short window
            rows, windows = _complete_window(torch, fn, name, {name: 1})
            left = [[k, c, ms] for k, c, ms in rows if "gemm_bf16_kernel" in k]
            if left:
                raise AssertionError(f"profile: {name} still launches the mma.sync GEMM: {left}")
            out[name] = {"total_ms": sum(r[2] for r in rows),
                         "wgmma_gemm_ms": sum(ms for k, _, ms in rows if "wg::gemm_kernel" in k),
                         "mma_sync_gemm_launches": 0, "profiled_windows": windows,
                         "by_kernel_ms": [[k, c, ms] for k, c, ms in rows[:16]]}
        del y, dy, dl, dtok
    del x, w
    # one full-width train step of each objective (after two unprofiled
    # ones): device time by kernel against the step's wall time on the
    # CUDA-event clock; then PROFILE_B2B_STEPS steps launched back to back
    # in one window, the host no longer waiting between them
    steps = {}
    for name, cfg, no_fused in (("train_step", None, False),
                                ("train_step_got", got_path_config(), False),
                                ("train_step_nofused", got_path_config(), True),
                                ("train_step_sigmoid", got_path_config(activation="sigmoid"),
                                 False),
                                ("train_step_views", views_path_config(), False)):
        _, _, step, batch = _train_setup(torch, cfg)
        with _no_fused_encoder(no_fused):
            for i in range(2):
                step(batch, i)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            seeds = itertools.count(2)

            def one_step():   # the CUDA events time the last profiled window's step
                start.record()
                step(batch, next(seeds))
                end.record()

            # a window counts once it shows every product and row kernel of
            # the step's wrapper calls (read from the launch counters)
            rows, windows = _complete_window(torch, one_step, name)
            busy, wall = sum(r[2] for r in rows), start.elapsed_time(end)

            def steps_back_to_back():
                start.record()
                for _ in range(PROFILE_B2B_STEPS):
                    step(batch, next(seeds))
                end.record()

            rows_b, windows_b = _complete_window(torch, steps_back_to_back,
                                                 f"{name} back to back")
            busy_b, wall_b = sum(r[2] for r in rows_b), start.elapsed_time(end)
        # every product of every step, the no-fused one's kernel 20 included,
        # runs on the TMA + wgmma GEMM: no step launches the mma.sync GEMM
        mma = sum(c for k, c, _ in rows if "gemm_bf16_kernel" in k)
        if mma:
            raise AssertionError(f"profile: {name} launched the mma.sync GEMM {mma} times, "
                                 f"not 0")
        steps[name] = {"wall_ms": wall, "device_busy_ms": busy,
                       "device_idle_share": 1.0 - busy / wall,
                       "back_to_back": {"steps": PROFILE_B2B_STEPS,
                                        "wall_ms_per_step": wall_b / PROFILE_B2B_STEPS,
                                        "device_busy_ms_per_step": busy_b / PROFILE_B2B_STEPS,
                                        "device_idle_share": 1.0 - busy_b / wall_b,
                                        "profiled_windows": windows_b},
                       **_split_got_rows(rows),
                       "mma_sync_gemm_launches": mma, "profiled_windows": windows,
                       "wgmma_gemm_ms": sum(ms for k, _, ms in rows if "wg::gemm_kernel" in k),
                       "by_kernel_ms": [[k, c, ms] for k, c, ms in rows[:24]]}
        del step, batch
    # the eval forward at full width (bf16): device time by kernel, K3's part
    # (its partial kernel and the shared combine, which only K3 runs here)
    from madeleine_torch.models.madeleine import forward_train

    model = flagship_model(torch, "bfloat16")
    feats = synthetic_train_batch(torch, train_path_config(), SEED + 8)["feats"]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def one_eval():
        start.record()
        forward_train(model, feats, train=False)
        end.record()

    rows = _profiled(torch, one_eval)
    busy, wall = sum(r[2] for r in rows), start.elapsed_time(end)
    k3 = sum(ms for k, _, ms in rows
             if _kernel_base(k).startswith(("attn_pool_partial", "pool_combine_kernel")))
    steps["eval_forward"] = {"wall_ms": wall, "device_busy_ms": busy,
                             "device_idle_share": 1.0 - busy / wall, "k3_ms": k3,
                             "by_kernel_ms": [[k, c, ms] for k, c, ms in rows[:24]]}
    emit({"phase": "profile", "shape": [65, 2048, 512], **out, **steps})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not os.path.isdir(os.path.join(HERE, "madeleine_torch")):
        print("chip_smoke: madeleine_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from madeleine_torch.utils.device import resolve_device

    resolve_device("cuda")
    state, seconds, t_start = {"phases": phases}, {}, time.perf_counter()
    for p in PHASES:
        if p in phases:
            t0 = time.perf_counter()
            globals()[f"phase_{p}"](state)
            seconds[p] = time.perf_counter() - t0
    emit({"phase_seconds": seconds, "total_s": time.perf_counter() - t_start})
    if CLI_RUNS:   # the pretrain CLI's runs: seconds by part, fresh processes and in this one
        emit({"cli_runs": CLI_RUNS,
              "cli_parts_total_s": {f"{'fresh' if f else 'in_process'}": {
                  k: sum(r["parts_s"][k] for r in CLI_RUNS if r["fresh_process"] == f)
                  for k in CLI_PARTS} for f in (True, False)},
              "cli_wall_total_s": sum(r["wall_s"] for r in CLI_RUNS)})
    if phases != list(PHASES):
        emit({"partial": phases})
        return 0

    # the kernels' launches, and beside them K6/K7's and the per-op lane's
    # calls in blocks of whole bags and their blocks (a counter a phase lacks
    # counts 0)
    counted = list(state["kernels"]) + list(BLOCK_COUNTERS) + list(PEROP_BLOCK_COUNTERS)

    def lane(paths, k):
        return sum(state[f"launches_{p}"].get(k, 0) for p in paths)

    launches = {k: lane(MAIN_PATHS, k) for k in counted}
    for k in state["kernels"]:
        if launches[k] < 1:
            raise AssertionError(f"{k} was not launched on the main path")
    # the same launches split: the side lanes (a sigmoid activation, the
    # no-fused softmax lane: their train phases and CLI epochs) and the rest
    side = {k: lane(SIDE_PATHS, k) + state["launches_pretrain_side"].get(k, 0) for k in counted}
    ragged = {k: lane(RAGGED_PATHS, k) for k in counted}
    f32 = {k: lane(F32_PATHS, k) for k in counted}
    emit({"launches_by_lane": {k: {"published": launches[k] - side[k] - ragged[k] - f32[k],
                                   "side_lanes": side[k], "ragged": ragged[k], "f32": f32[k]}
                               for k in launches}})
    # K6's save-off and K7's recompute launches on the main path (within theirs)
    for kernel, route, counter in (("encoder_train_fwd", "nosave_launches", "_nosave"),
                                   ("encoder_train_bwd", "recompute_launches", "_recompute"),
                                   ("encoder_train_fwd_f32", "nosave_launches", "_nosave"),
                                   ("encoder_train_bwd_f32", "recompute_launches",
                                    "_recompute")):
        state["kernels"][kernel][route] = sum(state[f"launches_{p}"][kernel + counter]
                                              for p in MAIN_PATHS)
    # K6's and K7's calls in blocks on the main path: the f32 rows' from the f32 lane
    for kernel, counter in (("encoder_train_fwd", "encoder_train_fwd_blocked_calls"),
                            ("encoder_train_bwd", "encoder_train_bwd_blocked_calls")):
        state["kernels"][kernel]["blocked_calls"] = launches[counter] - f32[counter]
        state["kernels"][kernel + "_f32"]["blocked_calls"] = f32[counter]
    # the per-op lane's forward calls in blocks on the main path (cfg.remat's
    # recomputes counted too) and their blocks: rows 4-5 and 15-20 run once a
    # block; the f32 rows' from the f32 lane
    for kernel in NOFUSED_KERNELS + PEROP_F32_KERNELS:
        lane_ = f32 if kernel in PEROP_F32_KERNELS else {
            k: launches[k] - f32[k] for k in PEROP_BLOCK_COUNTERS}
        if kernel in state["kernels"]:
            state["kernels"][kernel].update(perop_blocked_calls=lane_["perop_blocked_calls"],
                                            perop_blocks=lane_["perop_blocks"])
    emit({"kernels": [dict(v, launches=launches[k]) for k, v in state["kernels"].items()]})
    print(state["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": state["kind"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
