#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (ct_clip_ut_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py
(phase 17 spawns DP_WORLD processes on the same card and joins them)

Phases, each printing its lines before the last:
  1. the device: `nvidia-smi` name and power limit, torch and CUDA versions;
  2. the build of csrc/*.cu (one nvcc per source, in parallel), with its
     seconds, and the tensor-core instructions in the SASS, counted with
     cuobjdump where the toolkit has it: HGMMA (wgmma) in each GEMM on the
     Hopper core (csrc/gemm_sm90.cuh), in each weight-gradient kernel on
     its MN-major variant (csrc/wgrad_sm90.cuh) and in attn_qrows'
     attention core, every one of which must have some, the GEMMs of
     vq_nearest (its argmax epilogue), of attn_qrows' projections (QkvPlan
     with the per-head l2-norm epilogue), of the fp32 BERT layer (SplitPlan:
     three bf16 passes a product), of geglu_ff_bwd (the value / gate
     recompute with dh, the weight gradients), of the attention blocks'
     projections (QkvPlan with tc::QkvEpi, attn_block and attn_packed) and
     of the patch embed (PatchEpi: the folded LN1) and the qrows core among
     them; HMMA (mma.sync) in the shared split-bf16 core (csrc/attn_mma.cuh:
     attn_block's and attn_packed's forward, the backward's statistics
     pass), the backward's query and key passes (attn_block_bwd and
     attn_packed_bwd), its dbias pass, the cosine_attention core and the
     fp32 BERT layer's attention, each of which must have some; and for
     the bf16 BERT layer's chain, HGMMA in its products (its epilogues on
     gemm_kernel and the 64-row gemm64_kernel) and weight gradients
     (BertWgradPlan), HMMA in its forward core and its backward's query
     and key passes; HGMMA in the patch embed's weight gradient over its
     patch matrix (PatchWgradPlan); IGMMA (int8 wgmma) in geglu_ff_int8's
     two products (HEpi, OutEpi); HGMMA in the fp32 patch embed's product
     on split4_kernel, split4_32_kernel and split4_64_kernel; for the fp32
     BERT layer in train mode and its backward (rows 6F, 12F), HGMMA in the
     hidden sites' epilogue (HiddenF32Epi), the backward's GELU and dctx
     products and its weight gradients (SplitPairPlan), HMMA in the core
     with STATS and the backward's query and key passes;
  3. each of the six forward kernels against its plain PyTorch version on the card,
     at the shapes the zero-shot path gives it (2 volumes; 36 prompts of
     512 tokens), with both times, the least time the card could take
     (`bound_ms`) and one PyTorch call or chain of calls computing the
     same function (`library_ms`: nn.TransformerEncoderLayer for the BERT
     layer; LN, projections, F.normalize and F.scaled_dot_product_attention
     for the attention blocks; LN, F.linear and F.gelu for the FF; tok @
     cb.t() + argmax for the VQ; patchify, LN, F.linear, LN for the patch
     embed), with its error against the plain version; attn_packed's and
     the patch embed's chains run under torch.profiler once, printing each
     launch's ms, and fail if a launch of theirs is not on the Hopper pieces
     (ctc::sm90, ctc::tc, ctc::pe: no wmma kernel of gemm_tile.cuh), or
     if no gemm_kernel is among them. vq_nearest is the
     Hopper GEMM core with an argmax epilogue (64-bit atomicMax keys a
     row and code tile): >= VQ_AGREE equal indices, every mismatch a
     near-tie (<= VQ_TIE), and two equal codes in tiles 0 and 32 give the
     first; each float check also shows that its
     band rejects a plain version that leaves out a norm gain, LN bias, q/k
     scale, the position bias, the LN1 fold's gain or mean correction, the
     key mask or the QKV bias; the fp32 BERT layer (every product as three
     bf16 products of hi / lo planes) also that it rejects the kernel with
     one bf16 product each (lo planes zeroed), that skipping the key chunks
     the mask removes changes no bit, and that it reads no faster than its
     route's bound (three bf16 products at the bf16 peak);
  4. the zero-shot slice at flagship width and the default configuration
     (conv patch embed; random weights from a seed): CTClipInference.predict
     over 3 batches of 2 bf16 volumes [2, 1, 240, 480, 480], encoding the 36
     prompts (stand-in tokenizer, padded to 512 tokens) on the way, with
     every kernel's launch count > 0; one prompt encoding timed alone; the
     prompt latents, the patch embed's token grid (against the plain
     embed), the encoder output and one batch's image latents held against
     the plain path; then zeroshot() writes metrics.txt;
  4a. geglu_ff_int8 (--quantize-ff's W8A8 GEGLU) against its plain version
     at the 2-volume FF shape (x [27648, 512], spatial layer 0's FF of the
     seeded flagship quantised, inner 1365 padded to 1376), residual off
     and on, within INT8_BAND relative rms, with the controls (h left
     unquantised, one scale per tensor, sv and sg swapped), one call under
     torch.profiler (every launch on the Hopper pieces, ctc::sm90 and
     ctc::q8, a gemm_kernel among them), its times, `bound_ms` (int8
     operations) and the torch._int_mm chain as `library_ms`;
  4b. the zero-shot path on quantize_ctclip_ff(model): predict() over 3
     batches of 2 volumes with 8 geglu_ff_int8 launches a batch and no
     geglu_ff; batch 0's image latents against plain=True (share of equal
     VQ ids printed), the probabilities against the bf16 model's and both
     FF weight sizes;
  4c. the CLI end to end: scripts.inference_ctclip.main over 2 synthetic
     NIfTI volumes (128 x 128 x 60 int16, resampled and padded to [1, 240,
     480, 480]) with their CSVs, with --quantize-ff and without, each
     writing metrics.txt;
  4e. the train CLI (scripts.train_ctclip.main) at flagship width with
     peg_pallas=True: a reference-layout ctclip_v2.pt of seeded weights
     (module. prefix, the codebook's leading axis, HF BERT's position_ids
     and pooler) converted to the source's bits, a vocab.txt for the
     WordPiece tokenizer, one epoch over 8 synthetic NIfTI volumes with
     --batch-size 2 --grad-accum 2 (bf16, 512 tokens): finite losses, every
     kernel of the path launched with GradCache's counts, the
     last_checkpoint.pt reloading the trained bits, the seconds of each
     step; then one GradCache step (k = 2) against one single-pass step at
     B = 2 on a batch whose latents lie apart at init (a white-noise and a
     smooth volume, a 4-word and a 300-word report), dropout 0: in fp32 the
     loss and every gradient within 1e-3 of the tensor's largest entry; in
     bf16 the loss and every gradient within 1.5e-2 of the same
     microbatches' forwards in one graph, and each group's relative rms
     against the fp32 single-pass step within the bf16 single-pass step's
     own plus 1.5e-2 (the direct bf16 reading printed); the codes replayed
     and their flips counted, the gradients of another batch as the
     control; with dropout, pass 2's latents pass 1's bits in both dtypes;
  4d. cosine_attention (the bare core: a prologue writing the l2-normed,
     scaled q and k as bf16 hi / lo pairs, then the shared split-bf16 core)
     against its plain version at q/k/v [384, 576, 32] with the [8, 576,
     576] bias and at [9216, 24, 32] without, with the controls (q_scale,
     k_scale or the bias left out),
     its times, `bound_ms` and F.scaled_dot_product_attention as
     `library_ms`; one cross-attention through ops/attention.attention()
     launches it once;
  5. each of the five backward kernels of the train step against its plain
     version at the shapes a B = 2 train step gives it (every gradient),
     with both times, `bound_ms` and `library_ms`: forward + backward under
     autograd of the phase-3 chains for the attention blocks (the bias's
     gradient on) and the FF, phase 3's patch-embed chain for the
     residual-saving embed, torch.nn.grad.conv3d_weight for its weight grad
     (timed from the volume, and from the forward's patch matrix as the
     train step calls it; both forms and two calls the same bits; one call
     from the volume under torch.profiler, every launch on the Hopper
     pieces, a wgrad_kernel among them); the
     controls are the gradients of a plain backward with one fault (the
     LN gain left out of dx, the softmax row term or the l2-norm
     projection dropped, g missing from dx under the residual, dbias zero,
     dbias with one sequence left out of its sum, dbias with one 64 x 64
     block of its pass left unwritten, GELU for its derivative, wv / cin
     swapped in the weight grad, geglu_ff_bwd's weight gradients with a
     64-token slice left out or one 128 x 128 tile unwritten);
     attn_block_bwd's dbias and geglu_ff_bwd's weight gradients the same
     bits on two calls (each sums in a fixed order, no atomics);
  6. the four kernels of the 512-token train step at the shapes a B = 2
     step gives them: the bf16 BERT layer, deterministic and in train mode
     (dropout 0.1 / 0.1), and its backward (dx and the twelve parameter
     gradients) against their plain versions through the same Philox masks,
     the masks themselves bit for bit against the plain generator with
     their keep shares, and nn.TransformerEncoderLayer as the library call;
     one train-mode call of each under torch.profiler, failing if a launch
     of theirs lies outside the Hopper pieces (ctc::sm90, ctc::bh: no wmma
     kernel of gemm_tile.cuh or bwd_common.cuh), and the backward's
     thirteen gradients the same bits on two calls;
     the PEG stencil (causal, and the backward's flipped form, each timed)
     and its weight gradient against their plain versions, with the default
     route's copy + F.conv3d + copy and torch.nn.grad.conv3d_weight as the
     library calls; each with the controls a faulty kernel would give;
  7. the earlier train path (120-token reports, the PEG on F.conv3d): two
     steps of make_train_step and one evaluation, its kernels' launch
     counters > 0 and the new kernels' at 0;
  8. the train path as users run it, at flagship width, B = 2, 512-token
     reports, peg_pallas=True: one step's gradients held against the same
     step on the plain path from the same generator state (relative rms
     per parameter group, with the gradients of another batch as the
     control), then CTClipTrainer.train() over three steps (the step-0
     evaluation and a checkpoint included) with every train-path launch
     counter > 0, finite losses, the VQ cluster sizes grown by
     b t h w (1 - decay^3), and the time of three more steps;
  9. CTGenerate at CTGenerateConfig() (random weights from a seed): the
     attn_qrows chain (LN pass, the q / k / v projections on the Hopper
     GEMM core with the per-head l2-norm epilogue, the two-pass wgmma
     attention core over TMA-fed K, V^T and bias tiles in blocks of 256
     query rows at B = 1 and 128 at B = 2, the output
     projection) against its plain version at MaskGit's shapes (x [B,
     6464, 512], B = 1 and 2, the bf16 [8, 6464, 6464] CPB table), with
     the controls a faulty kernel would give (bias left out, k from the LN'd
     x, q_scale dropped, p unnormalised), its times, `bound_ms`, the two
     passes' floor of bias bytes and, as `library_ms`,
     F.scaled_dot_product_attention with the bias as its mask and the
     projections around it; then the localisation path as users run
     it (the script's `localize`: T5 encodes stand-in reports,
     ctgenerate_apply_batched runs bf16 MaskGit over the bias cache, each
     report's pathologies get a [201, 128, 128] heatmap) over 2 batches of 2
     bf16 scans [2, 1, 201, 128, 128], every kernel of that path launched;
     the feature map and the cross-attention held against plain=True, from
     the same codebook ids and end to end, with the plain tokenizer's id
     agreement; and `maskgit_generate` at B = 1 over
     18 steps: 108 attn_qrows launches, every id inside the codebook;
 10. the forward attribution methods in fp32 at flagship width (random
     weights from seed 0, the matmul patch embed of `capture.parity_cfg`,
     one [1, 1, 240, 480, 480] fp32 volume, a 512-token stand-in prompt):
     first the fp32 variants of rows 1-4 against their plain versions at
     the path's shapes (attn_block [24, 576, 512] with the fp32 bias,
     attn_packed [4608, 24, 512], geglu_ff and vq_nearest at [13824, 512]):
     F32_BAND max relative error, the VQ's share of equal indices and tie
     margin, controls the kernel with its lo planes zeroed (one bf16
     product each) and the plain version without the LN gain / bias, q
     scale or bias; times, `bound_ms` (three bf16 products at the bf16
     peak), the PyTorch chain in fp32 as `library_ms`; one call of each
     under torch.profiler on the Hopper pieces; the fp32 PEG conv under
     `full_fp32` against float64 (no TF32). Then, counted, the path:
     `raw_attention_maps`, `rollout_volumes` (its host expansion timed
     apart), the two latents (a prompt's, a diff embedding's), the
     frame-sparse occlusion sweep over the flagship grid's first 80 windows
     in slabs of 72 (a ragged tail) at chunk 8 and the dense shortcut (the
     only caller of attn_block's fp32 variant), with seconds, ms a window,
     the projected full sweep and peak memory; every fp32 variant launched.
     The maps held against plain=True (MAP_BAND); the scores against
     plain=True and the dense shortcut: each window within OCC_BAND unless
     one of its VQ indices flipped between the two paths, each flip a tie
     within VQ_F32_TIE (counted per forward by patching the models' VQ
     call), a second sweep the same bits, a sweep shifted by one stride
     outside the band.
 11. the gradient attribution methods in fp32 at flagship width (phase
     10's model, volume and prompt): first the fp32 data-gradient chains of
     rows 7-9 (attn_block, attn_packed and geglu_ff backward, dx alone)
     against the plain backwards' dx at an integrated-gradients chunk's
     shapes ([120, 576, 512] with the fp32 bias, [2880, 24, 512], [69120,
     512]) and a Grad-CAM's (one volume): F32_BAND, controls the chain with
     its lo planes zeroed and the plain backward with the softmax row term,
     the l2-norm projection, the LN gain or GELU's derivative wrong; two
     calls the same bits; times, `bound_ms`, the fp32 PyTorch chain forward
     + backward with x alone wanting its gradient as `library_ms`; one call
     of each under torch.profiler on the Hopper pieces; an fp32 backward
     with a weight wanting its gradient on the full chain (phase 14's), not
     the dx-only one. Then, counted, the path: a
     Grad-CAM map set (7f x 3, 8f x 4, 9f x 8) and one default
     integrated-gradients map (50 steps, chunk 5: 7f x 40, 8f x 40, 9f x
     80), with seconds and peak memory, the six maps expanded on the host,
     `integrated_gradients_pipelined` over two volumes (its first map the
     serial one's bits). Grad-CAM in both pairings against plain=True
     within MAP_BAND when its forward flipped no VQ index (each flip a tie
     within VQ_F32_TIE; the combined map, sqrt(spatial * temporal + 1e-8),
     through its square), the aligned pairing outside the reference's band;
     `grad_cam_maps` against plain=True's (MAP_BAND; the combined map
     within its volume's error);
     integrated gradients at 10 steps against plain=True: the map before
     the threshold and the final map off the threshold's crossings within
     MAP_BAND, each crossing within IG_CROSS_BAND of the threshold, the VQ
     flips of each forward counted.
 12. CTGenerate's one-scan fp32 route at CTGenerateConfig() (the JAX
     script's --batch-size 1 default): rows 5f (the fp32 conv patch embed
     at the route's two temporal patches, timed together) and 13f (the
     fp32 q-row attention at [1, 6464, 512] with the fp32 [8, 6464, 6464]
     table) against their plain versions (F32_BAND; controls one bf16
     product each, and 13f's bias or q scale left out), 5f's two calls
     profiled (its products on split4_64_kernel and split4_32_kernel, no
     gemm_kernel), times, `bound_ms`, the fp32 PyTorch chains as
     `library_ms`; then, counted,
     `inference_ctgenerate.main --data-valid` over 2 synthetic NIfTI
     volumes at --batch-size 1: 5f x 2 and 13f x 6 a scan, the fp32
     CT-ViT variants, no bf16 kernel; each scan through `localize_scan`
     timed and against plain=True (heatmaps within HEAT_BAND where no
     codebook id flipped, each flip a tie within VQ_F32_TIE, the files the
     CLI wrote the same maps), control scan 0's report over scan 1.
 13. the attribution suite: `CTClipInference.infer()` with zero-shot and
     the five methods (render_gifs off; occlusion at 27 windows through the
     flags dict, integrated gradients at 50 steps) on one flagship fp32
     volume, then occlusion's text-embeds mode: every artifact at the JAX
     suite's path and within SUITE_BAND of a direct call of its method,
     seconds a method; `scripts.embedding_arithmetic.main` over 64
     512-token reports in batches of 32 (the fp32 bert_layer), its CLS and
     diff embeddings against plain=True within EMBED_BAND of the CLS scale.
 14. the fp32 train step at 120-token reports (TrainConfig(compute_dtype=
     "float32", text_max_length=120), flagship width, peg_pallas=True, B =
     2): first the full fp32 backwards 7F-9F (attn_block / attn_packed /
     geglu_ff backward with every parameter gradient at [48, 576, 512] with
     the fp32 bias, [1152, 24, 512], [27648, 512]), the fp32 residual-saving
     patch embed (10f) and its weight gradient (11f) on a [2, 1, 240, 480,
     480] fp32 volume, and the PEG kernels (16, 17) on fp32 tokens, each
     against its plain version within F32_BAND (PEG_F32_KERNEL_BAND,
     PEG_WGRAD_BAND) with a one-pass control outside (the PEG's: fault
     controls), 10f's two calls the same bits and its profile (the product
     on split4_kernel, no gemm_kernel), times, `bound_ms`, the fp32 PyTorch
     chain forward + backward with every parameter wanting its gradient
     (conv3d_weight for 11f and 17) as `library_ms`; 9F's and 11f's
     weight gradients profiled on wgrad4_kernel, no wgrad_kernel. Then the
     close-token checks (F10 over two temporal blocks, F11 over two spatial
     blocks at 24 frames of 576 patches against a float64 block) and one
     step's gradients against plain=True from
     the same weights, batch, dropout draws and codes (the plain path
     quantises with the kernel path's indices; each index that flipped a
     tie within VQ_F32_TIE): every parameter within STEP_GRAD_BAND of its
     largest entry (the shift-invariant biases, whose gradient is zero up
     to rounding, of their group's; control another batch); then
     CTClipTrainer.train() over 3 steps with 10f, 11f x 1, 7F, 8F x 4, 9F
     x 8 and 17 x 8 a step, 1f-4f, 5f in the evaluations and no bf16 or
     dx-only kernel; the losses; three more steps timed.
 15. the fp32 train step at the TrainConfig default 512-token reports
     (TrainConfig(compute_dtype="float32")) on phase 14's model: first rows
     6F (the fp32 BERT layer in train mode, Philox dropout 0.1 / 0.1 at its
     three sites) and 12F (its fp32 recompute backward, dx and the twelve
     parameter gradients) at [2, 512, 768], one sequence padded after 300
     tokens, against their plain versions through the same masks within
     F32_BAND, controls one bf16 product each, other seeds, the attention
     site left out and the plain backward's three faults; two calls the
     same bits, train mode at rate 0 row 6's bits; times, `bound_ms`, the
     fp32 PyTorch chain (TF32 off, SDPA with the key mask and dropout) as
     `library_ms`, forward and forward + backward. F12 (bert_close_check):
     two BERT layers over [2, 512, 768] tokens 2% apart, keys padded, a
     cotangent on each [CLS], at rate 0 and with dropout: dWq, dWk and dx of
     plain fp32 and 12F (rerunning the forward, and from the kept state:
     the same bits) within CLOSE_BAND of a float64 layer (bert_f64) through
     the same keep factors, the one-pass chain outside at rate 0. Then phase 14's step
     checks at 512 tokens: one step's gradients against plain=True within
     STEP_GRAD_BAND, CTClipTrainer.train() over 3 steps with 6F x 12 and 12F
     x 12 a step besides phase 14's launches, row 6 in the evaluations, no
     bf16 BERT kernel; three more steps timed.
 16. the W8A8 FF on fp32 activations (row 15f) and the forward attribution
     methods on a quantised model: first geglu_ff_int8 on fp32 x at
     INT8_F32_ROWS (2 volumes, 1 volume, a quantised occlusion chunk's
     temporal tokens; the seeded flagship's spatial layer 0 FF, quantised),
     residual off and on, against its plain version within INT8_BAND
     relative rms with row 15's controls, xn's and h's codes read from the
     chain's workspaces (`launch_chain`) against the plain steps', each
     flip a tie within CODE_TIE; fp32 out, two calls the same bits, one
     call profiled on the Hopper pieces; times, `bound_ms`, the
     torch._int_mm chain on fp32 rows as `library_ms`. Then, counted,
     `inference_ctclip --quantize-ff --visualize raw_attention_maps
     attention_rollout occlusion --no-gifs` over 2 synthetic NIfTI volumes
     (occlusion at SUITE_OCC, 27 windows): geglu_ff_int8_f32 launched, the
     bf16 and dense FFs not at all; every map file the same as a direct call
     on the same model and volume (SUITE_BAND), those calls against
     plain=True from the same codes (the VQ indices and int8 codes of the
     kernel path replayed by VQRecorder / Int8Recorder, each flip counted
     and a tie within VQ_F32_TIE / CODE_TIE_PATH): maps within MAP_BAND,
     each window's score within OCC_BAND.
 17. data parallelism over torch.distributed on the one card: (a) a
     one-rank NCCL group through parallel.mesh: the fp32 step at B = 2,
     512 tokens, flagship width, peg_pallas=True, dropout 0, over the mesh
     (latents all-gathered, VQ statistics and gradients all-reduced) gives
     the single-process step's loss, gradients and codebook bit for bit
     (the EMA statistics are summed in a fixed order, ops/vq.py), as two
     single-process runs do;
     (b) DP_WORLD spawned ranks sharing the card over gloo (named here; the
     package's default for CUDA ranks is NCCL, which takes one rank a
     device), local batch 1: loss and every gradient within STEP_GRAD_BAND
     of the single-process B = 2 step (its VQ indices replayed, flips
     counted as ties), the codebook within DP_CODEBOOK_BAND, every gradient
     the same bits on both ranks; sharded zero-shot over DP_ZS_VOLUMES
     volumes (the wrapped duplicate dropped) and the window-sharded
     occlusion sweep over DP_OCC_WINDOWS windows against one process. A
     failed collective fails its rank, and the phase.
     FSDP (parallel/sharding.py): in (a) the fp32 step with fsdp=True over
     the one-rank group against the single-process step (loss, gradients,
     codebook and parameters after the step the same bits, else the first
     quantity that differs named and held within FSDP_BAND), a sharded
     checkpoint saved, loaded into a fresh state and stepped again: the
     uninterrupted run's bits; in (b) two FSDP steps at local batch 1
     against two data-parallel ones (the loss the same bits, each gradient
     piece the bits of the averaged gradient's slice, the parameters within
     FSDP_BAND, the gathered parameters the same bits on both ranks), each
     rank's memory at rest beside data parallelism's;
     `integrated_gradients_sharded` (DP_IG_STEPS steps in chunks of
     DP_IG_CHUNK) against one process's map (the average gradient within
     DP_IG_BAND, the final map off the threshold crossings within MAP_BAND,
     each crossing within IG_CROSS_BAND of the threshold), both timed; and
     CTGenerate over DP_CTGEN_SCANS scans (`ctgenerate_apply_batched(mesh=)`
     and `localize(mesh=)`): the cross-attention and the heatmaps against
     one process within CROSS_BAND.
Kernel times are CUDA events over 10 calls after 2 warm-ups; every
library_ms is the median of 5 windows of 50 calls, with their range on the
kernel's line (a library chain of ~0.3 ms reads what the host's launches
allow in a short window).
The line before the last is the kernels' JSON record (launches: the
zero-shot run's counts for the forward kernels, phase 4b's for
geglu_ff_int8, 4d's cross-attention for cosine_attention, phase 8's for
the train kernels, phase 9's for attn_qrows, phase 10's path for the fp32
variants, phase 11's for the fp32 backwards, phase 12's --data-valid run
for rows 5f and 13f, phase 14's train run for 10f, 11f, 7F-9F and the fp32
PEG rows, phase 15's for 6F and 12F, phase 16's CLI run for 15f); the last
line is {"ok": true,
"device": {...}}. Any failed phase exits non-zero before it.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

# Read on an H100 80GB HBM3 at 700 W: the bf16 kernels' branches within
# 3.3e-3 to 5.4e-3 of their plain versions, the fault controls 0.038 to 0.94;
# the fp32 BERT layer within 1.3e-5 as three bf16 products a product (5.5e-7
# on FFMA; controls 0.020 to 0.44, one bf16 product each 2.7e-3) and the
# prompt latents within 6e-8 (1 - cos; control 0.19).
FLOAT_BAND = 1.5e-2      # max relative error of a bf16 kernel's branch vs its plain version
VQ_AGREE = 0.999         # least share of equal VQ indices
VQ_TIE = 1e-3            # a mismatch must be a near-tie: fp32 sims within this
# The end-to-end bands sit between the same card's readings (encoder 1.2e-2: bf16
# flips from fp32 sums in another order, over 8 layers; latents 8.6e-3: 2.3%
# of VQ indices flip at near-ties) and the controls (1.0 and 0.8), see PERF.md.
ENCODER_BAND = 3e-2      # relative rms of the CT-ViT encoder output vs the plain path
LATENT_BAND = 3e-2       # 1 - cosine of batch 0's image latents vs the plain path
PROMPT_BAND = 1e-4       # 1 - cosine of the fp32 prompt latents vs the plain path
BERT_BAND = 1e-4         # max relative error of the fp32 BERT layer vs its plain version
# Train-path gradients vs the plain path, relative rms per parameter group.
# Read on an H100 80GB HBM3 at 700 W: the CT-ViT groups 0.028 to 0.040; the
# text tower and the latent projections / temperature 0.16 to 0.17, since
# their gradients are functions of the image latents, which differ from the
# plain path's where bf16 flips VQ indices at near ties (PR 1: 2.7% of
# indices, latents 1 - cos 9e-3); the controls (another batch) 1.30 to 1.58.
GRAD_BAND = 0.1          # the CT-ViT groups
LATENT_GRAD_BAND = 0.5   # the groups downstream of the image latents only
BATCHES, BATCH = 3, 2
TEXT_LEN = 512           # the train slice's reports: the TrainConfig default
EARLIER_TEXT_LEN = 120   # the earlier train path: under the fused BERT layer's gate
# fp32 sums of the same bf16 (or fp32) products in another order
PEG_WGRAD_BAND = 1e-4    # max relative error of the PEG weight and bias gradients
# The bf16 BERT layer's second residual, read from its own workspaces: r2 - y against
# g W2^T + b2 (times the keep mask), relative rms. The output's bf16 rounding hides a
# residual taken from the rounded y; this difference shows it
RESIDUAL_BAND = 1e-4
VOLUME = (1, 240, 480, 480)
PROMPTS, PROMPT_LEN = 36, 512

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its FLOPs over the peak of its operands' type and its bytes (each
# input read once, each output written once) over the memory rate
BF16_PEAK, FP32_PEAK, INT8_PEAK, HBM_RATE = 989e12, 67e12, 1979e12, 3.35e12
LIB_WINDOWS, LIB_CALLS = 5, 50      # library_ms: the median of 5 windows of 50 calls
PROFILE_TRIES = 3                   # profiles of one call in hopper_chain_check at most
PROFILE_PAD = 64                    # short kernels before a profiled call (hopper_chain_check)
SLICE, TILE = 64, 128               # the weight-gradient kernel's token slice and output tile

KERNELS = {
    "attn_block": ("ct_clip_ut_tpu_torch/csrc/attn_block.cu",
                   "ct_clip_ut_tpu/ops/pallas_attn_block.py:192"),
    "attn_packed": ("ct_clip_ut_tpu_torch/csrc/attn_packed.cu",
                    "ct_clip_ut_tpu/ops/pallas_attn_packed.py:230"),
    "geglu_ff": ("ct_clip_ut_tpu_torch/csrc/geglu_ff.cu",
                 "ct_clip_ut_tpu/ops/pallas_ff.py:120"),
    "vq_nearest": ("ct_clip_ut_tpu_torch/csrc/vq_nearest.cu",
                   "ct_clip_ut_tpu/ops/pallas_vq.py:56"),
    "patch_embed": ("ct_clip_ut_tpu_torch/csrc/patch_embed.cu",
                    "ct_clip_ut_tpu/ops/pallas_patch_embed.py:287"),
    "bert_layer": ("ct_clip_ut_tpu_torch/csrc/bert_layer.cu",
                   "ct_clip_ut_tpu/ops/pallas_bert_layer.py:440"),
    "attn_block_bwd": ("ct_clip_ut_tpu_torch/csrc/attn_block_bwd.cu",
                       "ct_clip_ut_tpu/ops/pallas_attn_block.py:407"),
    "attn_packed_bwd": ("ct_clip_ut_tpu_torch/csrc/attn_packed_bwd.cu",
                        "ct_clip_ut_tpu/ops/pallas_attn_packed.py:424"),
    "geglu_ff_bwd": ("ct_clip_ut_tpu_torch/csrc/geglu_ff_bwd.cu",
                     "ct_clip_ut_tpu/ops/pallas_ff.py:234"),
    "patch_embed_res": ("ct_clip_ut_tpu_torch/csrc/patch_embed.cu",
                        "ct_clip_ut_tpu/ops/pallas_patch_embed.py:329"),
    "patch_embed_dkw": ("ct_clip_ut_tpu_torch/csrc/patch_embed_dkw.cu",
                        "ct_clip_ut_tpu/ops/pallas_patch_embed.py:381"),
    "bert_layer_bf16": ("ct_clip_ut_tpu_torch/csrc/bert_layer_bf16.cu",
                        "ct_clip_ut_tpu/ops/pallas_bert_layer.py:440"),
    "bert_layer_bwd": ("ct_clip_ut_tpu_torch/csrc/bert_layer_bwd.cu",
                       "ct_clip_ut_tpu/ops/pallas_bert_layer.py:473"),
    "peg": ("ct_clip_ut_tpu_torch/csrc/peg.cu", "ct_clip_ut_tpu/ops/pallas_peg.py:131"),
    "peg_weight_grads": ("ct_clip_ut_tpu_torch/csrc/peg_wgrad.cu",
                         "ct_clip_ut_tpu/ops/pallas_peg_bwd.py:85"),
    "attn_qrows": ("ct_clip_ut_tpu_torch/csrc/attn_qrows.cu",
                   "ct_clip_ut_tpu/ops/pallas_attn_qrows.py:230"),
    "geglu_ff_int8": ("ct_clip_ut_tpu_torch/csrc/geglu_ff_int8.cu",
                      "ct_clip_ut_tpu/ops/pallas_ff_int8.py:148"),
    "cosine_attention": ("ct_clip_ut_tpu_torch/csrc/cosine_attention.cu",
                         "ct_clip_ut_tpu/ops/pallas_attention.py:125"),
    "attn_block_f32": ("ct_clip_ut_tpu_torch/csrc/attn_block.cu",
                       "ct_clip_ut_tpu/ops/pallas_attn_block.py:192"),
    "attn_packed_f32": ("ct_clip_ut_tpu_torch/csrc/attn_packed.cu",
                        "ct_clip_ut_tpu/ops/pallas_attn_packed.py:230"),
    "geglu_ff_f32": ("ct_clip_ut_tpu_torch/csrc/geglu_ff.cu",
                     "ct_clip_ut_tpu/ops/pallas_ff.py:120"),
    "vq_nearest_f32": ("ct_clip_ut_tpu_torch/csrc/vq_nearest.cu",
                       "ct_clip_ut_tpu/ops/pallas_vq.py:56"),
    "attn_block_bwd_f32": ("ct_clip_ut_tpu_torch/csrc/attn_block_bwd_f32.cu",
                           "ct_clip_ut_tpu/ops/pallas_attn_block.py:407"),
    "attn_packed_bwd_f32": ("ct_clip_ut_tpu_torch/csrc/attn_packed_bwd_f32.cu",
                            "ct_clip_ut_tpu/ops/pallas_attn_packed.py:424"),
    "geglu_ff_bwd_f32": ("ct_clip_ut_tpu_torch/csrc/geglu_ff_bwd_f32.cu",
                         "ct_clip_ut_tpu/ops/pallas_ff.py:234"),
    "patch_embed_f32": ("ct_clip_ut_tpu_torch/csrc/patch_embed.cu",
                        "ct_clip_ut_tpu/ops/pallas_patch_embed.py:287"),
    "attn_qrows_f32": ("ct_clip_ut_tpu_torch/csrc/attn_qrows.cu",
                       "ct_clip_ut_tpu/ops/pallas_attn_qrows.py:230"),
    "attn_block_bwd_f32_full": ("ct_clip_ut_tpu_torch/csrc/attn_block_bwd_f32.cu",
                                "ct_clip_ut_tpu/ops/pallas_attn_block.py:407"),
    "attn_packed_bwd_f32_full": ("ct_clip_ut_tpu_torch/csrc/attn_packed_bwd_f32.cu",
                                 "ct_clip_ut_tpu/ops/pallas_attn_packed.py:424"),
    "geglu_ff_bwd_f32_full": ("ct_clip_ut_tpu_torch/csrc/geglu_ff_bwd_f32.cu",
                              "ct_clip_ut_tpu/ops/pallas_ff.py:234"),
    "patch_embed_res_f32": ("ct_clip_ut_tpu_torch/csrc/patch_embed.cu",
                            "ct_clip_ut_tpu/ops/pallas_patch_embed.py:329"),
    "patch_embed_dkw_f32": ("ct_clip_ut_tpu_torch/csrc/patch_embed_dkw.cu",
                            "ct_clip_ut_tpu/ops/pallas_patch_embed.py:381"),
    "peg_f32": ("ct_clip_ut_tpu_torch/csrc/peg.cu", "ct_clip_ut_tpu/ops/pallas_peg.py:131"),
    "peg_weight_grads_f32": ("ct_clip_ut_tpu_torch/csrc/peg_wgrad.cu",
                             "ct_clip_ut_tpu/ops/pallas_peg_bwd.py:85"),
    "bert_layer_f32_train": ("ct_clip_ut_tpu_torch/csrc/bert_layer.cu",
                             "ct_clip_ut_tpu/ops/pallas_bert_layer.py:440"),
    "bert_layer_bwd_f32": ("ct_clip_ut_tpu_torch/csrc/bert_layer_bwd_f32.cu",
                           "ct_clip_ut_tpu/ops/pallas_bert_layer.py:473"),
    "geglu_ff_int8_f32": ("ct_clip_ut_tpu_torch/csrc/geglu_ff_int8.cu",
                          "ct_clip_ut_tpu/ops/pallas_ff_int8.py:148"),
}
# Phase 10, the attribution suite in fp32 (the fp32 variants of rows 1-4):
F32_BAND = 1e-4         # max relative error of an fp32 variant vs its plain version (row 6's)
VQ_F32_AGREE = 0.9999   # least share of fp32 VQ indices equal to the plain version's
VQ_F32_TIE = 1e-5       # a mismatch must be a tie: fp32 sims within this
MAP_BAND = 1e-3         # max abs error of the [0, 1]-normalised maps vs plain=True
PEG_F32_BAND = 1e-5     # max relative error of the fp32 PEG conv (TF32 off) vs float64
OCC_BAND = 1e-4         # relative error of a window's score vs plain=True / the dense shortcut
OCC_WINDOWS, OCC_SLAB, OCC_CHUNK = 80, 72, 8   # slabs of 72 windows: a ragged tail of 8
FULL_SWEEP = 12167      # windows of the flagship grid (23^3)
ATTRIBUTION_KERNELS = ("attn_block_f32", "attn_packed_f32", "geglu_ff_f32", "vq_nearest_f32")
# Phase 11, the gradient methods in fp32 (the fp32 data-gradient chains of rows 7-9):
GRADIENT_KERNELS = ("attn_block_bwd_f32", "attn_packed_bwd_f32", "geglu_ff_bwd_f32")
GRAD_CAM_LAUNCHES = {"attn_block_bwd_f32": 3, "attn_packed_bwd_f32": 4, "geglu_ff_bwd_f32": 8}
IG_LAUNCHES = {"attn_block_bwd_f32": 40, "attn_packed_bwd_f32": 40, "geglu_ff_bwd_f32": 80}
IG_CHUNK, IG_CHECK_STEPS = 5, 10
IG_CROSS_BAND = 1e-5    # an IG threshold crossing's distance from the threshold (map max 1)
BERT_PEG_KERNELS = ("bert_layer_bf16", "bert_layer_bwd", "peg", "peg_weight_grads")
TRAIN_KERNELS = ("attn_block_bwd", "attn_packed_bwd", "geglu_ff_bwd", "patch_embed_res",
                 "patch_embed_dkw", *BERT_PEG_KERNELS)
# Phase 12, CTGenerate's one-scan fp32 route (rows 5f and 13f):
CTGEN_F32_KERNELS = {"patch_embed_f32": 2, "attn_qrows_f32": 6}   # launches a one-scan forward
CTGEN_F32_PATH = ("attn_block_f32", "attn_packed_f32", "geglu_ff_f32", "vq_nearest_f32")
CTGEN_BF16 = ("patch_embed", "attn_block", "attn_packed", "geglu_ff", "vq_nearest", "attn_qrows")
CTGEN_SCANS = 2                      # synthetic NIfTI volumes of the --data-valid run
HEAT_BAND = 1e-3                     # max abs error of a [0, 1] heatmap vs plain=True (ids equal)
CTGEN_REPORTS = ("Mild emphysema in both upper lobes and a lung nodule on the right.",
                 "Cardiomegaly with a small pericardial effusion and atelectasis.")
CTGEN_POSITIVES = (("Emphysema", "Lung nodule", "Hiatal hernia"),
                   ("Cardiomegaly", "Pericardial effusion", "Atelectasis"))
# Phase 13, the attribution suite and embedding arithmetic at flagship width:
SUITE_OCC = dict(patch_size=(80, 160, 160), stride=(80, 160, 160))   # 3 x 3 x 3 = 27 windows
SUITE_BAND = 1e-6       # an artifact vs a direct call of its method (the same kernels, max abs)
EMBED_BAND = 1e-4       # max abs error of the CLS / diff embeddings vs plain=True over the CLS scale
EMBED_REPORTS, EMBED_BATCH = 64, 32
# Phase 14, the fp32 train step at 120-token reports: rows 10f, 11f and the
# full fp32 backwards 7F-9F, with rows 16 and 17 on fp32 tensors
F32_TRAIN_KERNELS = ("attn_block_bwd_f32_full", "attn_packed_bwd_f32_full",
                     "geglu_ff_bwd_f32_full", "patch_embed_res_f32", "patch_embed_dkw_f32")
F32_TRAIN_STEP = {"patch_embed_res_f32": 1, "patch_embed_dkw_f32": 1,
                  "attn_block_bwd_f32_full": 4, "attn_packed_bwd_f32_full": 4,
                  "geglu_ff_bwd_f32_full": 8, "peg_weight_grads": 8}   # launches a train step
F32_TRAIN_FORWARD = ("attn_block_f32", "attn_packed_f32", "geglu_ff_f32", "vq_nearest_f32")
STEP_GRAD_BAND = 1e-3   # max |kernel - plain| / max |plain| of each parameter's step gradient
# ... over its parameter group's largest entry instead for the parameters whose
# gradient is zero up to rounding: softmax ignores a constant added to a row,
# so neither the CPB MLP's last bias nor BERT's key biases move the loss
PEG_F32_KERNEL_BAND = 1e-5   # the fp32 PEG stencil's branch vs its plain version
# Phase 15, the fp32 train step at 512-token reports: rows 6F and 12F, BERT's
# 12 layers forward in train mode and backward (launches a train step)
BERT_F32_KERNELS = ("bert_layer_f32_train", "bert_layer_bwd_f32")
BERT_F32_STEP = dict.fromkeys(BERT_F32_KERNELS, 12)
# Phase 16, the W8A8 FF on fp32 activations (row 15f) under the forward methods:
# zero-shot's 2 volumes; one volume (a slab's clean stack); a quantised occlusion
# chunk's temporal tokens (8 windows' volumes)
INT8_F32_ROWS = (27648, 13824, 110592)
CODE_TIE = 1e-3         # a flipped int8 code: the plain quotient within this of a .5 boundary
# ... along a whole forward, where the FF's inputs already differ by the fp32
# attention kernels' rounding (~1e-5 relative after 8 layers: ~1e-3 of a code
# step at |q| ~ 127); a flip that is no tie sits ~0.5 away
CODE_TIE_PATH = 1e-2
INT8_F32_ATTRIBUTION = ("attn_packed_f32", "vq_nearest_f32", "geglu_ff_int8_f32")
INT8_F32_ABSENT = ("geglu_ff_int8", "geglu_ff", "geglu_ff_f32")   # no bf16 or dense FF
# Phase 17, data parallelism on the one card:
DP_WORLD = 2            # gloo ranks sharing the card (NCCL takes one rank a device)
DP_OCC_WINDOWS = 40     # the sharded occlusion sweep's windows: 20 a rank
DP_ZS_VOLUMES = 3       # sharded zero-shot: 2 + 2 with the wrapped duplicate dropped
# the step's reports: phase 15's length (~300 real tokens), and a short one
DP_REPORT_WORDS, DP_SHORT_WORDS = 300, 40
# Against the same rows in forwards of 1 in one process the data-parallel
# gradients should be those bits: rank r backpropagates 2 x its rows'
# cotangent (exact), the all-reduce sums and halves (exact)
DP_SPLIT_BAND = 1e-6
# Against the B = 2 step each gradient is held over at least DP_GRAD_FLOOR of
# its group's largest entry: at dropout 0 BERT's last layers' query / key
# gradients are sums that cancel to ~1e-6 of their terms, which any change
# of the sums' order moves (6.3e-4 between a batch of 2 and two of 1 in one
# process since 12F takes its row term from the same split dP, as plain fp32
# does; ~10% before; phase 17 (a) prints the reading); the phase 14 band over
# that floor is 1e-5 of the group's largest entry, the chains' resolution
DP_GRAD_FLOOR = 1e-2
# the codebook after phase 17 (b)'s step over two ranks vs the single-process
# step's: max abs over the buffer's largest entry (the ranks' EMA statistics
# are summed by halves, one process sums them whole; phase 17 (a) holds its
# one-rank step's codebook bit for bit)
DP_CODEBOOK_BAND = 1e-5
# FSDP against data parallelism: a quantity that is not the same bits is
# named and held within this of its tensor's largest entry (none is expected:
# the FSDP step is the data-parallel step's arithmetic, its clip norm taken
# over the whole leaves)
FSDP_BAND = 1e-6
# the sharded integrated gradients (phase 17 (b)): steps in chunks, the
# chunks each rank's contiguous share; the average gradient vs one process
# within DP_IG_BAND of its largest entry (the sums over the chunks in another
# order)
DP_IG_STEPS, DP_IG_CHUNK, DP_IG_BAND = 8, 2, 1e-5
DP_CTGEN_SCANS = 3      # CTGenerate over the ranks: padded to 4, 2 a rank
# kernel rows whose launches another counter holds (the PEG wrappers count either dtype)
COUNTER_OF = {"peg_f32": "peg", "peg_weight_grads_f32": "peg_weight_grads"}
# CTGenerate (phase 9): the kernels of one batched forward, with their launches each
CTGEN_KERNELS = {"patch_embed": 2, "attn_block": 4, "attn_packed": 4, "geglu_ff": 8 + 6,
                 "vq_nearest": 1, "attn_qrows": 6}
# kernels of other paths, launched by neither zero-shot nor training:
# CTGenerate's q-row attention, the int8 FF (--quantize-ff) in both forms, the
# bare cosine core, the attribution suite's fp32 variants (phase 10) and fp32
# backwards (phase 11), CTGenerate's fp32 route (phase 12), the fp32 train
# step's (phases 14 and 15)
SERVING_KERNELS = ("attn_qrows", "geglu_ff_int8", "geglu_ff_int8_f32", "cosine_attention",
                   *ATTRIBUTION_KERNELS, *GRADIENT_KERNELS, *CTGEN_F32_KERNELS,
                   *F32_TRAIN_KERNELS, *BERT_F32_KERNELS)
CTGEN_SCAN = (1, 201, 128, 128)
CTGEN_BATCHES, GENERATE_STEPS = 2, 18
SHORT_REPORT = 30                    # words of every second stand-in report
# MaskGit's feature map (relative rms) and last cross-attention (max abs)
# against the plain path: from the same codebook ids and end to end (where
# 2.9% of the bf16 tokenizer's ids differ from the plain tokenizer's). Read
# on an H100 80GB HBM3 at 700 W: 5.6e-3 / 5.4e-3 from the same ids, 1.1e-2 /
# 1.2e-2 end to end. Controls: scan 0 against scan 1, 1.21 / 0.37; plain
# MaskGit from the same ids without the CPB table, 7.1e-2 / 3.5e-2 (3.8e-2
# against the end-to-end plain path); without the text mask, 0.66 / 0.35. Each band lies between the readings and the
# nearest control (the end-to-end feature band near their geometric mean).
FEATURE_BAND = 3e-2
CROSS_BAND = 1e-2
E2E_FEATURE_BAND = 3e-2
E2E_CROSS_BAND = 2e-2
# geglu_ff_int8 vs its plain version, relative rms: the two differ only where
# LN's last bit moves a code across a .5 boundary, a few codes in a tensor;
# the controls (h left unquantised, one scale per tensor, sv and sg swapped)
# move every row
INT8_BAND = 2e-3
CLI_VOLUME = (128, 128, 60)         # raw [H, W, D] int16 grid of the CLI phase
CLI_SPACING = (2.5, 5.0)            # xy, z mm: resampled to [200, 426, 426], padded
COSINE_TEMPORAL = (9216, 24)        # (b h w, t) slices of the temporal stack at B = 1


# Mangled-name marks of the wgmma kernels that must be in the library: the
# argmax GEMM of vq_nearest, the q / k / v GEMM and the attention core of
# attn_qrows, the fp32 BERT layer's split products, the FF backward's
# recompute and its MN-major weight gradients, the attention blocks'
# projections, the patch embed's product and its weight gradient
SASS_REQUIRED = {"vq_nearest GEMM (ArgmaxEpi)": "2vq9ArgmaxEpi",
                 "attn_block / attn_packed projections (QkvPlan, tc::QkvEpi)": "2tc6QkvEpi",
                 "patch_embed GEMM (PatchEpi: the folded LN1, conv)": "2pe8PatchEpi",
                 "attn_qrows projections (QkvPlan, qr::QkvEpi)": "2qr6QkvEpi",
                 "attn_qrows core": "2qr11core_kernel",
                 "three-pass split products (gemm_kernel over SplitPlan: 4f's vq_nearest, the "
                 "core's test entry)": ("11gemm_kernel", "9SplitPlanE"),
                 "geglu_ff_bwd value / gate recompute with dh (GateBwdEpi)": "10GateBwdEpi",
                 "geglu_ff_bwd weight gradients (FFWgradPlan, MN-major)": "11FFWgradPlan",
                 "bf16 bert_layer hidden sites (HiddenEpi: bias, Philox keep, residual)":
                     "2bh9HiddenEpi",
                 "bf16 bert_layer_bwd GELU backward (GeluBwdEpi, W2 read as stored)":
                     "2bh10GeluBwdEpi",
                 "bf16 bert_layer_bwd weight gradients (BertWgradPlan, MN-major)":
                     "2bh13BertWgradPlan",
                 "patch_embed_dkw weight gradient over P (PatchWgradPlan, MN-major)":
                     "2pe14PatchWgradPlan",
                 "fp32 attn_qrows projections (QkvSplitPlan on split4_kernel)":
                     ("13split4_kernel", "12QkvSplitPlanENS_2qr6QkvEpi"),
                 "fp32 attn_block / attn_packed projections (split4_kernel: a slice's four "
                 "planes at once)": ("13split4_kernel", "2tc12QkvSplitPlan"),
                 "fp32 geglu_ff value / gate product (split4_kernel, GegluSplitPlan, h as hi / "
                 "lo planes)": ("13split4_kernel", "2ff14GegluSplitPlan"),
                 "fp32 forward output products (split4_kernel into F32OutEpi: geglu_ff, the "
                 "blocks)": ("13split4_kernel", "9SplitPlanENS0_9F32OutEpi"),
                 "fp32 vq_nearest GEMM (SplitPlan into ArgmaxEpi)": "9SplitPlanENS_2vq9ArgmaxEpi",
                 "fp32 output products (SplitPlan into F32OutEpi: geglu_ff, the blocks, BERT)":
                     "9SplitPlanENS0_9F32OutEpi",
                 "fp32 backward products with a weight read as stored (SplitKNPlan)":
                     "11SplitKNPlanENS0_9F32OutEpi",
                 "fp32 block backward's dO as hi / lo planes (SplitKNPlan, SplitOutEpi)":
                     "11SplitKNPlanENS0_11SplitOutEpi",
                 "fp32 geglu_ff backward: value | gate and dh in one block "
                 "(gate_bwd_split_kernel)": "5ff32b21gate_bwd_split_kernel",
                 "fp32 geglu_ff backward's dxn (split4_kn_kernel: a slice's four planes at once)":
                     "4sm9016split4_kn_kernel",
                 "fp32 spatial backward's query pass (wgmma: split S, dP, dS.K)":
                     ("2tc16bwd_dq_wg_kernel", "Lb0E"),
                 "fp32 spatial backward's row term (wgmma: D = c + rowsum(P (dP - c)) / "
                 "rowsum(P) from the split S and dP, F11)": ("2tc16bwd_dq_wg_kernel", "Lb1E"),
                 "fp32 spatial backward's key pass (wgmma: split S^T, dP^T, P^T.dO, dS^T.Q)":
                     "2tc17bwd_dkv_wg_kernel",
                 "fp32 patch_embed product, the train step's 27,648 patches (split4_kernel "
                 "into PatchF32Epi: a slice's four planes at once)":
                     ("13split4_kernel", "2pe11PatchF32Epi"),
                 "fp32 patch_embed product, CTGenerate's 6,400 patches (split4_32_kernel into "
                 "PatchF32Epi)": ("16split4_32_kernel", "2pe11PatchF32Epi"),
                 "fp32 patch_embed product, CTGenerate's first frame (split4_64_kernel into "
                 "PatchF32Epi)": ("16split4_64_kernel", "2pe11PatchF32Epi"),
                 "fp32 attn_qrows projections (QkvSplitPlan into qr::QkvEpi)":
                     "12QkvSplitPlanENS_2qr6QkvEpi",
                 "fp32 attn_qrows core (one pass: split scores and P.V, the fp32 bias, o "
                 "rescaled as the row max moves)": ("2qr15core_f32_kernel", "ILb1E"),
                 "fp32 block weight gradients (BlockWgradSplitPlan: three passes, 12 maps)":
                     "19BlockWgradSplitPlan",
                 "fp32 FF weight gradients (wgrad4_kernel, FFWgradSplitPlan: a slice's four "
                 "planes at once)": ("13wgrad4_kernel", "16FFWgradSplitPlan"),
                 "fp32 patch embed weight gradient (wgrad4_kernel, PatchWgradSplitPlan)":
                     ("13wgrad4_kernel", "19PatchWgradSplitPlan"),
                 "fp32 bert_layer hidden sites (HiddenF32Epi: bias, Philox keep, residual)":
                     "4bert12HiddenF32Epi",
                 "fp32 bert_layer_bwd GELU backward (GeluBwdSplitEpi, W2 read as stored)":
                     "4bert15GeluBwdSplitEpi",
                 "fp32 bert_layer_bwd weight gradients (wgrad4_kernel, SplitQuadPlan: the four "
                 "in one launch, each token slice's four planes at once, 16 maps)":
                     ("13wgrad4_kernel", "4bert13SplitQuadPlan"),
                 "fp32 bert_layer products (split4_kernel: a slice's four planes at once)":
                     ("13split4_kernel", "4bert8SplitEpi"),
                 "fp32 bert_layer products at 32-deep slices, two blocks an SM "
                 "(split4_32_kernel)": ("16split4_32_kernel", "4bert8SplitEpi"),
                 "fp32 bert_layer_bwd GELU backward at 32-deep slices (split4_32_kernel)":
                     ("16split4_32_kernel", "4bert15GeluBwdSplitEpi"),
                 "fp32 bert_layer 64-row staged products (split4_64_kernel, hidden sites)":
                     ("16split4_64_kernel", "4bert12HiddenF32Epi"),
                 "fp32 bert_layer_bwd 64-row staged products, weights read as stored "
                 "(split4_64_kernel)": ("16split4_64_kernel", "ILb1ENS0_9F32OutEpi")}
# ... and of the mma.sync kernels of the split-bf16 attention cores
SASS_MMA_REQUIRED = {"shared core (attn_block, attn_packed, the backward's statistics)":
                         "17block_core_kernel",
                     "the backward's query pass (attn_block_bwd, attn_packed_bwd)":
                         "13bwd_dq_kernel",
                     "the backward's key pass (attn_block_bwd, attn_packed_bwd)":
                         "14bwd_dkv_kernel",
                     "attn_block_bwd dbias pass": "16bwd_dbias_kernel",
                     "cosine_attention core": "18cosine_core_kernel",
                     "fp32 bert_layer attention (split-bf16 scores and P.V)":
                         "4bert11attn_kernel",
                     "bf16 bert_layer attention forward (two passes, Philox keep)":
                         "2bh15fwd_core_kernel",
                     "bf16 bert_layer_bwd query pass": "2bh14dq_pass_kernel",
                     "bf16 bert_layer_bwd key pass": "2bh15dkv_pass_kernel",
                     "fp32 block core (attn_block_f32, attn_packed_f32 past 64 tokens: split "
                     "P.V)":
                         ("17block_core_kernel", "Lb0ELb1E"),
                     "fp32 backward's statistics (the fp32 core with STATS)":
                         ("17block_core_kernel", "Lb1ELb1E"),
                     "fp32 temporal backward's fused pass, n <= 32 (split S, dP, dS.K, "
                     "P^T.dO, dS^T.Q)": ("2tc21bwd_packed_f32_kernel", "Li32ELb0E"),
                     "fp32 temporal backward's fused pass, train form (o = split P.V too)":
                         ("2tc21bwd_packed_f32_kernel", "Li32ELb1E"),
                     "fp32 temporal backward's fused pass, n <= 64":
                         ("2tc21bwd_packed_f32_kernel", "Li64E"),
                     "fp32 temporal forward core, whole items, n <= 32 (split S and P.V)":
                         ("2tc21fwd_packed_f32_kernel", "Li32E"),
                     "fp32 temporal forward core, whole items, n <= 64":
                         ("2tc21fwd_packed_f32_kernel", "Li64E"),
                     "fp32 backward's dbias pass (split S and dP)": "20bwd_dbias_f32_kernel",
                     "fp32 bert_layer attention with STATS (row 12F's recompute, Philox keep)":
                         ("4bert11attn_kernel", "ILb1E"),
                     "fp32 bert_layer_bwd query pass (split dS.K, keep bits)":
                         ("4bert13dq_f32_kernel", "ILb0E"),
                     "fp32 bert_layer_bwd row term (D from the split S and dP)":
                         ("4bert13dq_f32_kernel", "ILb1E"),
                     "fp32 bert_layer_bwd key pass (split p_used^T.dctx, dS^T.Q)":
                         "4bert14dkv_f32_kernel"}


# the wgmma kernels that sum over tokens in a fixed order: no atomic instruction
# (ATOM, ATOMS, RED) in their SASS
SASS_NO_ATOMICS = ("2tc16bwd_dq_wg_kernel", "2tc17bwd_dkv_wg_kernel",
                   "5ff32b21gate_bwd_split_kernel", "4sm9013split4_kernel",
                   "4sm9016split4_64_kernel", "4sm9016split4_32_kernel",
                   "4bert13SplitQuadPlan", "16FFWgradSplitPlan", "19PatchWgradSplitPlan")
# ... and the other fixed-order kernels: the temporal backward's fused pass
# (mma.sync) and the chunked weight gradient's in-order sum of its partials
SASS_NO_ATOMICS_OTHER = ("2tc21bwd_packed_f32_kernel", "4sm9016wgrad_sum_kernel",
                         "2tc21fwd_packed_f32_kernel")
# ... and the fixed-order kernels whose only atomics are on shared memory
# (the ring's count of warps yet to leave a stage, ATOMS): no global ATOM or
# RED (the fp32 q-row core's sums are registers, in order)
SASS_NO_GLOBAL_ATOMICS = ("2qr15core_f32_kernel",)
# ... and of the int8 wgmma kernels of geglu_ff_int8 (IGMMA, not HGMMA)
SASS_INT8_REQUIRED = {"geglu_ff_int8 value | gate product writing h (HEpi)":
                          "11gemm_kernelINS_2q810GegluPlan8ENS2_4HEpi",
                      "geglu_ff_int8 W2 product with the residual, bf16 rows (OutEpi<bf16>)":
                          ("11gemm_kernelINS_2q811LinearPlan8ENS2_6OutEpi", "6OutEpiI13__nv_bf"),
                      "geglu_ff_int8 W2 product with the residual, fp32 rows (OutEpi<float>, "
                      "row 15f)": ("11gemm_kernelINS_2q811LinearPlan8ENS2_6OutEpi", "6OutEpiIf")}


def marked(fn: str, mark) -> bool:
    """Whether a mangled name holds a mark (a substring, or each of a tuple's)."""
    return all(m in fn for m in ((mark,) if isinstance(mark, str) else mark))


def sass_check(lib: Path) -> None:
    """Print the wgmma instructions (HGMMA, IGMMA for int8 operands) in the
    SASS of each GEMM of the Hopper core, of attn_qrows' core, of the fp32
    spatial backward's passes and of the fp32 FF backward's recompute in
    the built library, and the HMMA (mma.sync) instructions of the
    split-bf16 attention cores, counted with the toolkit's cuobjdump; raise
    if one has none or a kernel of SASS_REQUIRED / SASS_MMA_REQUIRED is
    missing, one of SASS_INT8_REQUIRED has no IGMMA, one of
    SASS_NO_ATOMICS holds an atomic instruction or one of
    SASS_NO_GLOBAL_ATOMICS a global one. Without cuobjdump, say so and check
    nothing."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        print("sass: no cuobjdump on this machine; HGMMA / HMMA not counted")
        return
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, igmma, mma, atomics, global_atomics, fn = {}, {}, {}, {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if ("sm90" in fn and ("gemm_kernel" in fn or "gemm64_kernel" in fn
                                  or "wgrad_kernel" in fn or "split4_kn_kernel" in fn
                                  or "split4_kernel" in fn or "split4_64_kernel" in fn
                                  or "split4_32_kernel" in fn or "wgrad4_kernel" in fn)
                    or "2qr11core_kernel" in fn or "2qr15core_f32_kernel" in fn
                    or "3ffb15gate_bwd_kernel" in fn
                    or any(mark in fn for mark in SASS_NO_ATOMICS)):
                counts.setdefault(fn, 0)
            if any(marked(fn, mark) for mark in SASS_MMA_REQUIRED.values()):
                mma.setdefault(fn, 0)
            if any(mark in fn for mark in SASS_NO_ATOMICS + SASS_NO_ATOMICS_OTHER):
                atomics.setdefault(fn, 0)
            if any(mark in fn for mark in SASS_NO_GLOBAL_ATOMICS):
                global_atomics.setdefault(fn, 0)
        elif fn in counts and ("HGMMA" in line or "IGMMA" in line):
            counts[fn] += 1
            if "IGMMA" in line:
                igmma[fn] = igmma.get(fn, 0) + 1
        elif fn in mma and "HMMA" in line:
            mma[fn] += 1
        if fn in atomics and any(op in line for op in (" ATOM", " ATOMS", " RED.", " RED ")):
            atomics[fn] += 1
        if fn in global_atomics and any(op in line for op in (" ATOMG", " RED.", " RED ")):
            global_atomics[fn] += 1
    print("sass: HGMMA / IGMMA instructions per wgmma kernel: "
          + ", ".join(f"{fn[:90]} {n}" for fn, n in counts.items()))
    if not counts or not all(counts.values()):
        raise AssertionError(f"a Hopper-core kernel without wgmma: {counts}")
    if not all(mma.values()):
        raise AssertionError(f"an attention core without mma.sync: {mma}")
    for what, mark in SASS_REQUIRED.items():
        found = {fn: n for fn, n in counts.items() if marked(fn, mark)}
        print(f"sass: {what}: {sum(found.values())} HGMMA in {len(found)} kernel(s)")
        if not found:
            raise AssertionError(f"no wgmma kernel for {what} in the library")
    for what, mark in SASS_INT8_REQUIRED.items():
        found = {fn: n for fn, n in igmma.items() if marked(fn, mark)}
        print(f"sass: {what}: {sum(found.values())} IGMMA in {len(found)} kernel(s)")
        if not found:
            raise AssertionError(f"no int8 wgmma kernel for {what} in the library")
    for what, mark in SASS_MMA_REQUIRED.items():
        found = {fn: n for fn, n in mma.items() if marked(fn, mark)}
        print(f"sass: {what}: {sum(found.values())} HMMA in {len(found)} kernel(s) "
              f"({', '.join(str(n) for n in found.values())})")
        if not found:
            raise AssertionError(f"no mma.sync kernel for {what} in the library")
    print(f"sass: atomic instructions in the fixed-order wgmma kernels: "
          + ", ".join(f"{fn[:60]} {n}" for fn, n in atomics.items()))
    missing = [m for m in SASS_NO_ATOMICS + SASS_NO_ATOMICS_OTHER
               if not any(m in fn for fn in atomics)]
    if missing or any(atomics.values()):
        raise AssertionError(f"a fixed-order kernel missing ({missing}) or with atomics: "
                             f"{atomics}")
    print(f"sass: global atomic instructions in the fixed-order cores: "
          + ", ".join(f"{fn[:60]} {n}" for fn, n in global_atomics.items()))
    if len(global_atomics) < len(SASS_NO_GLOBAL_ATOMICS) or any(global_atomics.values()):
        raise AssertionError(f"a fixed-order core missing or with global atomics: "
                             f"{global_atomics}")


# the temporal fp32 backward at n <= 64: its fused pass, no core rerun and
# none of the first design's passes
FUSED_TEMPORAL = {"must": ("bwd_packed_f32_kernel",),
                  "must_not": ("block_core_kernel", "bwd_dq_f32_kernel", "bwd_dkv_f32_kernel")}
# kernels on wgmma, as the profiler names them: a chain's profile holds one
WGMMA_KERNELS = ("gemm_kernel", "sm90::wgrad_kernel", "split4_kn_kernel", "split4_kernel",
                 "gate_bwd_split_kernel", "bwd_dq_wg_kernel", "split4_64_kernel",
                 "split4_32_kernel", "wgrad4_kernel")
# the fp32 forward chains of rows 1f-3f: every product on split4_kernel, and
# the temporal block's core (n = 24, no bias) the whole-item one
F32_FORWARD = {"attn_block_f32": {"must": ("split4_kernel", "block_core_kernel"),
                                  "must_not": ("gemm_kernel", "fwd_packed_f32_kernel")},
               "attn_packed_f32": {"must": ("split4_kernel", "fwd_packed_f32_kernel"),
                                   "must_not": ("gemm_kernel", "block_core_kernel")},
               "geglu_ff_f32": {"must": ("split4_kernel",), "must_not": ("gemm_kernel",)}}
# The namespaces of the Hopper pieces (mangled or demangled): a chain moved
# off the wmma tile of gemm_tile.cuh launches no ctc kernel outside them
# (vq:: holds vq_nearest's key-to-index pass after its argmax GEMM)
HOPPER_SPACES = ("sm90", "tc::", "pe::", "bh::", "q8::", "vq::", "ff32b::", "bert::", "3ctc2tc",
                 "3ctc2pe", "3ctc2bh", "3ctc2q8", "3ctc2vq", "3ctc4bert")


def hopper_chain_check(name: str, fn, card: str, must=(), must_not=(), launches=None) -> None:
    """Run fn once under torch.profiler (after a warm-up), print each of the
    port's launches with its ms, and raise if one lies outside
    HOPPER_SPACES (a wmma kernel of gemm_tile.cuh or bwd_common.cuh) or none
    is a wgmma kernel of the Hopper core (gemm_kernel, or wgrad_kernel for a
    weight gradient). The profiled call starts with torch kernels (sleeps,
    not listed): without one, the profiler did not record the first launch
    of a call that starts in the port's library (patch_embed_dkw from the
    volume, whose first launch is the patchify pass), and late in a whole
    smoke it dropped a call's first launches (2 of phase 11's, 8 of phase
    14's full backwards), so PROFILE_PAD short sleeps come first. `must` /
    `must_not`: kernel names the accepted profile has to hold / no profile
    may hold (the temporal backward's fused pass, and no core rerun);
    `launches`: {name: count} the accepted profile must hold exactly (12F's
    train route: one attention core, the forward's, no rerun). A
    profile without a wgmma kernel (once a bert_layer_bwd call's profile
    held no device activity, though its times and bits showed it ran) or
    without a name of `must` (a full backward's profile once held only the
    chain's second half) is printed and taken again, after a longer sleep,
    up to PROFILE_TRIES profiles; every profile taken is checked for
    launches outside the Hopper pieces and for `must_not`. (WGMMA_KERNELS
    names the wgmma kernels.)"""
    import torch

    from ct_clip_ut_tpu_torch.infer.profile_zeroshot import profile_call

    def wgmma(rows):
        return any(any(w in k for w in WGMMA_KERNELS) for _, _, k in rows)

    def absent(rows):
        return [m for m in must if not any(m in k for _, _, k in rows)]

    stray, present = [], []
    for attempt in range(1, PROFILE_TRIES + 1):
        cycles = 1000 * 100 ** (attempt - 1)

        def call():
            for _ in range(PROFILE_PAD * attempt):
                torch.cuda._sleep(1)
            torch.cuda._sleep(cycles)
            fn()

        try:
            rows = [(ms, n, k) for ms, n, k in profile_call(call)["rows"] if "ctc" in k]
        except RuntimeError as e:     # "the profiler recorded no device activity"
            rows, why = [], str(e)
        else:
            why = "no wgmma kernel among them" if not wgmma(rows) else f"no {absent(rows)}"
        print(f"kernel {name}: one call's launches (profile {attempt}): "
              + "; ".join(f"{k.split('(')[0][-70:]} x{n} {ms:.3f} ms" for ms, n, k in rows)
              + f" [{card}]")
        stray += [k for _, _, k in rows if not any(sp in k for sp in HOPPER_SPACES)]
        present += [m for m in must_not if any(m in k for _, _, k in rows)]
        if wgmma(rows) and not absent(rows):
            break
        print(f"kernel {name}: profile {attempt} of {PROFILE_TRIES} not accepted: {why}")
    if stray or not wgmma(rows):
        raise AssertionError(f"{name}: launches outside the Hopper pieces {stray}, or no "
                             f"wgmma kernel among {[k for _, _, k in rows]}")
    if absent(rows) or present:
        raise AssertionError(f"{name}: the profile lacks {absent(rows)} or holds {present}")
    got = {m: sum(n for _, n, k in rows if m in k) for m in (launches or {})}
    if got != (launches or {}):
        raise AssertionError(f"{name}: the profile holds {got} launches, expected {launches}")


def bound(flops: float, nbytes: float, peak: float) -> dict:
    """bound_ms and what sets it."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class LibraryMs(float):
    """A library call's ms per call: the median of LIB_WINDOWS windows of
    LIB_CALLS calls each (CUDA events), with their range. At ~0.3 ms a call
    a single short window reads what the host's launches allow; the median
    of long windows is the yardstick."""

    def __new__(cls, times: list):
        obj = super().__new__(cls, statistics.median(times))
        obj.lo, obj.hi = min(times), max(times)
        return obj

    @property
    def span(self) -> str:
        return f"median of {LIB_WINDOWS} x {LIB_CALLS} calls, range {self.lo:.3f}-{self.hi:.3f}"


def library_time(torch, fn) -> LibraryMs:
    """fn's LibraryMs, after 2 warm-up calls."""
    for _ in range(2):
        fn()
    return LibraryMs([cuda_ms(torch, fn, LIB_CALLS, warmup=0) for _ in range(LIB_WINDOWS)])


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def rel_rms(got, want) -> float:
    """||got - want|| / ||want||."""
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def around_ones(torch, g, n: int, base: float = 1.0):
    """base + 0.1 N: a norm gain or scale drawn away from the init's ones."""
    return base + 0.1 * torch.randn((n,), generator=g, device="cuda")


def block_args(torch, g, tf) -> list:
    """Layer 0's attention weights of a stack in the block kernels' argument
    order (gamma, wq, wk, wv, wo, q_scale, k_scale), gains drawn by around_ones."""
    a = tf.layers[0][1]
    bf = torch.bfloat16
    wkv = a.to_kv.weight.to(bf)
    inner, d, dh = a.cfg.inner_dim, a.cfg.dim, a.cfg.dim_head
    return [around_ones(torch, g, d), a.to_q.weight.to(bf), wkv[:inner].contiguous(),
            wkv[inner:].contiguous(), a.to_out.weight.to(bf), around_ones(torch, g, dh),
            around_ones(torch, g, dh)]


def attn_library(x, gamma, wq, wk, wv, wo, qs, ks, bias, scale: float, residual: bool = True):
    """The attention block as a chain of PyTorch calls the port never makes,
    the yardstick (library_ms) of rows attn_block / attn_packed and, under
    autograd, of their backward rows: F.layer_norm (gamma only), F.linear of
    q from the LN'd x and of k, v from x, F.normalize of q and k times
    q_scale * scale / k_scale, bf16 F.scaled_dot_product_attention (scale 1:
    q carries it) with the bias in bf16 as its additive mask, F.linear out
    (+ x)."""
    import torch.nn.functional as F

    r, n, d = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh

    def heads_of(t):
        return t.view(r, n, heads, dh).transpose(1, 2)

    xn = F.layer_norm(x.float(), (d,), gamma).to(x.dtype)
    q, k, v = heads_of(F.linear(xn, wq)), heads_of(F.linear(x, wk)), heads_of(F.linear(x, wv))
    q = (F.normalize(q.float(), dim=-1) * (qs * scale)).to(x.dtype)
    k = (F.normalize(k.float(), dim=-1) * ks).to(x.dtype)
    mask = None if bias is None else bias.to(x.dtype)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
    out = F.linear(o.transpose(1, 2).reshape(r, n, heads * dh), wo)
    return out + x if residual else out


def ff_library(x, gamma, beta, w_in, w_out, residual: bool = True):
    """The GEGLU FF as PyTorch calls (the yardstick of geglu_ff and, under
    autograd, geglu_ff_bwd): F.layer_norm, F.linear (w_in), F.gelu(gate) *
    value, F.linear (w_out) (+ x)."""
    import torch.nn.functional as F

    xn = F.layer_norm(x.float(), (x.shape[-1],), gamma, beta).to(x.dtype)
    value, gate = F.linear(xn, w_in).chunk(2, dim=-1)
    out = F.linear(F.gelu(gate) * value, w_out)
    return out + x if residual else out


def patch_library(emb, p: int, tp: int):
    """The patch embed as PyTorch calls on `emb`'s unfolded weights (the
    yardstick of patch_embed and patch_embed_res): patchify by reshape /
    permute, F.layer_norm, F.linear, F.layer_norm. Returns fn(image)."""
    import torch.nn.functional as F

    g1, be1, g2, be2 = (t.detach().float().clone() for t in (emb[1].weight, emb[1].bias,
                                                             emb[3].weight, emb[3].bias))
    w, bias = emb[2].weight.detach().clone(), emb[2].bias.detach().clone()

    def fn(image):
        b, c, T, H, W = image.shape
        t, hp, wp = T // tp, H // p, W // p
        x = image.reshape(b, c, t, tp, hp, p, wp, p).permute(0, 2, 4, 6, 1, 3, 5, 7)
        x = x.reshape(b, t, hp, wp, -1)
        h = F.layer_norm(x.float(), (x.shape[-1],), g1, be1).to(image.dtype)
        h = F.linear(h, w.to(image.dtype), bias.to(image.dtype))
        return F.layer_norm(h.float(), (h.shape[-1],), g2, be2).to(image.dtype)

    return fn


def library_grad_ms(torch, fn, leaves: list, g) -> tuple:
    """(ms of forward + backward of fn(*leaves) under autograd with
    cotangent g, the leaves' gradients of one such step)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]

    def step():
        for t in leaves:
            t.grad = None
        fn(*leaves).backward(g)

    step()
    grads = [t.grad for t in leaves]
    return library_time(torch, step), grads


def kernel_phase(torch, model, card: str) -> dict:
    """Each kernel vs its plain version at the shapes predict() gives it at
    B = BATCH; returns the per-kernel record (without launch counts).

    The float kernels are compared on their branch (residual=False), with
    the norm gains, LN bias and q/k scales drawn as 1 + 0.1 N (beta 0.1 N)
    rather than the init's ones and zeros. Each check also reads its
    controls: the kernel's output against the plain version with one of
    those parameters (or the position bias) left out. A control at or under
    the band means the band cannot tell such a faulty kernel from a right
    one, and fails the phase."""
    from ct_clip_ut_tpu_torch.ops.attn_block import attn_block, attn_block_plain
    from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed, attn_packed_plain
    from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff, geglu_ff_plain
    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.layers import l2norm
    from ct_clip_ut_tpu_torch.ops.posbias import continuous_pos_bias
    from ct_clip_ut_tpu_torch.ops.vq_nearest import vq_nearest, vq_nearest_plain

    vit = model.visual_transformer
    cfg = vit.cfg
    g = torch.Generator(device="cuda").manual_seed(7)
    bf = torch.bfloat16
    t, h, w = token_grid_shape(cfg, VOLUME)
    hw, d = h * w, cfg.dim

    def around(base, n):
        return around_ones(torch, g, n, base)

    def attn_args(tf):
        return block_args(torch, g, tf)

    bias = continuous_pos_bias(vit.spatial_rel_pos_bias, cfg.patch_height, cfg.patch_width)
    xs = torch.randn((BATCH * t, hw, d), generator=g, device="cuda").to(bf)
    xt = torch.randn((BATCH * hw, t, d), generator=g, device="cuda").to(bf)
    ff = vit.enc_spatial_transformer.layers[0][3]
    xf = torch.randn((BATCH * t * hw, d), generator=g, device="cuda").to(bf)
    scale = vit.enc_spatial_transformer.layers[0][1].cfg.scale

    # name: (kernel, plain, args before `residual`, {control: (arg index, neutral value)},
    #        the PyTorch chain of library_ms)
    attn_faults = {"no gamma": (1, 1.0), "no q_scale": (6, 1.0), "no k_scale": (7, 1.0)}

    def packed_library(*a, residual=True):
        return attn_library(*a[:8], None, *a[8:], residual=residual)

    cases = {
        "attn_block": (attn_block, attn_block_plain,
                       [xs, *attn_args(vit.enc_spatial_transformer), bias, scale],
                       {**attn_faults, "no bias": (8, 0.0)}, attn_library),
        "attn_packed": (attn_packed, attn_packed_plain,
                        [xt, *attn_args(vit.enc_temporal_transformer), scale], attn_faults,
                        packed_library),
        "geglu_ff": (geglu_ff, geglu_ff_plain,
                     [xf, around(1.0, d), 0.1 * torch.randn((d,), generator=g, device="cuda"),
                      ff[1].weight.to(bf), ff[4].weight.to(bf)],
                     {"no gamma": (1, 1.0), "no beta": (2, 0.0)}, ff_library),
    }
    out = {}
    for name, (kern, plain, args, faults, library) in cases.items():
        got = kern(*args, residual=False)
        want = plain(*args, residual=False)
        torch.cuda.synchronize()
        controls = {}
        for fault, (i, value) in faults.items():
            wrong = list(args)
            wrong[i] = torch.full_like(args[i], value)
            controls[fault] = rel_err(got, plain(*wrong, residual=False))
        abs_err = band_check(name, got, want, FLOAT_BAND, controls,
                             f"x {list(args[0].shape)}, branch max "
                             f"{want.float().abs().max().item():.3e}")
        ms = cuda_ms(torch, lambda: kern(*args, residual=True))
        plain_ms = cuda_ms(torch, lambda: plain(*args, residual=True))
        lib_err = rel_err(library(*args, residual=False), want)
        library_ms = library_time(torch, lambda: library(*args, residual=True))
        print(f"kernel {name}: {ms:.3f} ms vs plain {plain_ms:.3f} ms, the PyTorch chain "
              f"{library_ms:.3f} ms ({library_ms.span}) (max_rel_err {lib_err:.3e} vs the plain "
              f"version) [{card}]")
        x = args[0]
        m, dm = x.numel() // x.shape[-1], x.shape[-1]
        if name == "geglu_ff":
            flops = 2 * m * dm * args[4].shape[1] * 3
        else:
            r, n, hd = x.shape[0], x.shape[1], args[2].shape[0]
            flops = 2 * m * dm * hd * 4 + 4 * r * n * n * hd
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        out[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                         **bound(flops, nbytes(*tensors, got), BF16_PEAK), library_ms=library_ms)
        if name == "attn_packed":
            hopper_chain_check(name, lambda: kern(*args, residual=True), card)

    tok = l2norm(torch.randn((BATCH * t * hw, d), generator=g, device="cuda")).to(bf)
    cb = vit.vq.state().embed.to(bf)
    got, want = vq_nearest(tok, cb).long(), vq_nearest_plain(tok, cb).long()
    torch.cuda.synchronize()
    agree = (got == want).float().mean().item()
    bad = (got != want).nonzero().flatten()
    gap = 0.0
    if bad.numel():
        sims = tok[bad].float() @ cb.float().t()
        gap = (sims.gather(1, got[bad, None]) - sims.gather(1, want[bad, None])).abs().max().item()
    ms = cuda_ms(torch, lambda: vq_nearest(tok, cb))
    plain_ms = cuda_ms(torch, lambda: vq_nearest_plain(tok, cb))
    lib_agree = ((tok @ cb.t()).argmax(-1) == want).float().mean().item()
    library_ms = library_time(torch, lambda: (tok @ cb.t()).argmax(-1))
    print(f"kernel vq_nearest {list(tok.shape)} x {list(cb.shape)}: {agree:.6f} of indices "
          f"equal (band {VQ_AGREE}), {bad.numel()} mismatches, largest sim gap {gap:.3e} "
          f"(band {VQ_TIE}); {ms:.3f} ms vs plain {plain_ms:.3f} ms, tok @ cb.t() + argmax "
          f"{library_ms:.3f} ms ({library_ms.span}) ({lib_agree:.6f} of its indices equal the "
          f"plain version's) "
          f"[{card}]")
    if agree < VQ_AGREE or gap > VQ_TIE:
        raise AssertionError(f"vq_nearest: agreement {agree}, tie gap {gap}")
    # an exact tie across code tiles 0 and 32: the first maximum wins
    tie_cb, tie_tok = cb.clone(), tok[:77].clone()
    tie_cb[4100] = tie_cb[5]
    tie_tok[0] = tie_cb[5]
    first = int(vq_nearest(tie_tok, tie_cb)[0])
    print(f"kernel vq_nearest: token 0 equal to codes 5 and 4100 -> index {first} [{card}]")
    if first != 5:
        raise AssertionError(f"vq_nearest: a tie between codes 5 and 4100 gave {first}")
    out["vq_nearest"] = dict(max_abs_err=gap, ms=ms, plain_ms=plain_ms,
                             **bound(2 * tok.shape[0] * cb.shape[0] * tok.shape[1],
                                     nbytes(tok, cb) + 4 * tok.shape[0], BF16_PEAK),
                             library_ms=library_ms)
    out["patch_embed"] = patch_embed_check(torch, model, card, g)
    out["bert_layer"] = bert_layer_check(torch, model, card, g)
    return out


def band_check(name: str, got, want, band: float, controls: dict, line: str) -> float:
    """Print the check's line; raise unless got is within `band` of want
    and every control (the output a faulty kernel would give) lies above
    it. Returns the max abs error."""
    abs_err = (got.float() - want.float()).abs().max().item()
    rel = rel_err(got, want)
    print(f"kernel {name} {line}: max_rel_err {rel:.3e} (band {band}) max_abs_err {abs_err:.3e}; "
          "controls " + ", ".join(f"{k} {v:.3e}" for k, v in controls.items()))
    if not got.float().isfinite().all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if not rel <= band:
        raise AssertionError(f"{name}: max relative error {rel} over {band}")
    blind = {k: v for k, v in controls.items() if not v > band}
    if blind:
        raise AssertionError(f"{name}: the band {band} passes faulty kernels {blind}")
    return abs_err


def patch_embed_check(torch, model, card: str, g) -> dict:
    """The patch embed on a [2, 1, 240, 480, 480] bf16 volume, LN1 / LN2
    gains drawn as 1 + 0.1 N and biases as 0.1 N, on the branch output
    (there is no residual). Controls: LN1's gain left out of the fold, no
    mean correction (s1 = 0), LN2's bias left out."""
    import copy

    from ct_clip_ut_tpu_torch.ops.patch_embed import (fold_patch_embed, patch_embed_fused,
                                                      patch_embed_plain)

    cfg = model.visual_transformer.cfg
    p, tp = cfg.patch_size, cfg.temporal_patch_size
    emb = copy.deepcopy(model.visual_transformer.to_patch_emb)
    with torch.no_grad():
        for ln in (emb[1], emb[3]):
            ln.weight.copy_(1.0 + 0.1 * torch.randn(ln.weight.shape, generator=g, device="cuda"))
            ln.bias.copy_(0.1 * torch.randn(ln.bias.shape, generator=g, device="cuda"))
        image = torch.randn((BATCH, *VOLUME), generator=g, device="cuda").to(torch.bfloat16)
        kw, s1, b1 = fold_patch_embed(emb, p, tp)
        library = patch_library(emb, p, tp)
        args = [image, kw, s1, b1, emb[3].weight.float(), emb[3].bias.float()]
        got = patch_embed_fused(*args, p, tp)
        want = patch_embed_plain(*args, p, tp)
        torch.cuda.synchronize()
        emb[1].weight.fill_(1.0)
        kw0, s10, _ = fold_patch_embed(emb, p, tp)
        faults = {"no LN1 gain": {1: kw0, 2: s10}, "s1 = 0": {2: torch.zeros_like(s1)},
                  "no LN2 beta": {5: torch.zeros_like(args[5])}}
        controls = {}
        for fault, swap in faults.items():
            wrong = [swap.get(i, a) for i, a in enumerate(args)]
            controls[fault] = rel_err(got, patch_embed_plain(*wrong, p, tp))
        ms = cuda_ms(torch, lambda: patch_embed_fused(*args, p, tp))
        plain_ms = cuda_ms(torch, lambda: patch_embed_plain(*args, p, tp))
        lib_err = rel_err(library(image), want)
        library_ms = library_time(torch, lambda: library(image))
        hopper_chain_check("patch_embed", lambda: patch_embed_fused(*args, p, tp), card)
    abs_err = band_check("patch_embed", got, want, FLOAT_BAND, controls,
                         f"{list(image.shape)} -> {list(got.shape)}")
    print(f"kernel patch_embed: {ms:.3f} ms vs plain {plain_ms:.3f} ms, the PyTorch chain "
          f"{library_ms:.3f} ms ({library_ms.span}) (max_rel_err {lib_err:.3e} vs the plain "
          f"version) [{card}]")
    m, dim = got.numel() // got.shape[-1], got.shape[-1]
    k = kw.shape[0] * kw.shape[1]
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                **bound(2 * m * k * dim, nbytes(image, got) + 2 * k * dim + 4 * 4 * dim,
                        BF16_PEAK),
                library_ms=library_ms)


def bert_layer_check(torch, model, card: str, g) -> dict:
    """One BERT layer in fp32 on [36, 512, 768], keys padded after 6 to 14
    real tokens per row and two rows at full length, LN gains drawn as
    1 + 0.1 N and biases as 0.1 N. Controls: mask dropped, LN1's gain left
    out, QKV bias left out, and the kernel with one bf16 product for each
    fp32 one (every lo plane zeroed). The key chunks the mask removes add
    exactly 0: the output must be the same bits as the kernel's that walks
    them. library_ms: nn.TransformerEncoderLayer (post-LN, exact GELU) in
    eval mode with the same weights and key padding mask, one PyTorch call
    computing the same function (a yardstick: the port never calls it).
    bound_ms: the route's, three bf16 products for each fp32 one at the
    bf16 peak, the attention over the real keys only; the kernel must not
    read faster."""
    from ct_clip_ut_tpu_torch.models.bert import layer_args
    from ct_clip_ut_tpu_torch.ops.bert_layer import bert_layer, bert_layer_fp32, bert_layer_plain

    bcfg = model.cfg.bert
    d, heads, eps = bcfg.hidden_size, bcfg.num_heads, bcfg.layer_norm_eps
    lengths = torch.randint(6, 15, (PROMPTS,), generator=g, device="cuda")
    lengths[3] = lengths[17] = PROMPT_LEN
    pad = torch.arange(PROMPT_LEN, device="cuda")[None, :] >= lengths[:, None]
    mask_row = pad.float() * torch.finfo(torch.float32).min
    x = torch.randn((PROMPTS, PROMPT_LEN, d), generator=g, device="cuda")
    w = [t.detach().clone() for t in layer_args(model.text_transformer.encoder.layer[0])]
    for i in (4, 10):                                  # LN gains
        w[i] = 1.0 + 0.1 * torch.randn((d,), generator=g, device="cuda")
    for i in (5, 11):                                  # LN biases
        w[i] = 0.1 * torch.randn((d,), generator=g, device="cuda")
    args = [x, mask_row, *w]
    with torch.no_grad():
        got = bert_layer(*args, heads, eps)
        want = bert_layer_plain(*args, heads, eps)
        walked = bert_layer_fp32(*args, heads, eps, skip_masked=False)
        torch.cuda.synchronize()
        faults = {"no mask": (1, torch.zeros_like(mask_row)), "no LN1 gain": (6, torch.ones_like(w[4])),
                  "no QKV bias": (3, torch.zeros_like(w[1]))}
        controls = {}
        for fault, (i, value) in faults.items():
            wrong = list(args)
            wrong[i] = value
            controls[fault] = rel_err(got, bert_layer_plain(*wrong, heads, eps))
        controls["one-pass bf16 products"] = rel_err(
            bert_layer_fp32(*args, heads, eps, one_pass=True), want)
        ms = cuda_ms(torch, lambda: bert_layer(*args, heads, eps))
        plain_ms = cuda_ms(torch, lambda: bert_layer_plain(*args, heads, eps))

        lib = torch.nn.TransformerEncoderLayer(d, heads, w[6].shape[0], dropout=0.0,
                                               activation="gelu", batch_first=True,
                                               norm_first=False, layer_norm_eps=eps,
                                               device="cuda").eval()
        sd = dict(zip(["self_attn.in_proj_weight", "self_attn.in_proj_bias",
                       "self_attn.out_proj.weight", "self_attn.out_proj.bias", "norm1.weight",
                       "norm1.bias", "linear1.weight", "linear1.bias", "linear2.weight",
                       "linear2.bias", "norm2.weight", "norm2.bias"], w))
        lib.load_state_dict(sd, strict=True)
        lib_out = lib(x, src_key_padding_mask=pad)
        keep = ~pad
        lib_err = rel_err(lib_out[keep], want[keep])
        library_ms = library_time(torch, lambda: lib(x, src_key_padding_mask=pad))
    abs_err = band_check("bert_layer", got, want, BERT_BAND, controls,
                         f"fp32 {list(x.shape)}, {int(keep.sum())} real tokens")
    same = torch.equal(got, walked)
    print(f"kernel bert_layer: masked key chunks skipped vs walked: the same bits: {same}")
    if not same:
        raise AssertionError("bert_layer: skipping the masked key chunks changed the output")
    b, n, f = PROMPTS, PROMPT_LEN, w[6].shape[0]
    linear = 2 * b * n * d * (3 * d + d + 2 * f)
    real_keys = int(lengths.sum())
    rec = bound(3 * (linear + 4 * n * d * real_keys), nbytes(x, mask_row, *w, got), BF16_PEAK)
    ffma_ms = 1e3 * (linear + 4 * b * n * n * d) / FP32_PEAK
    print(f"kernel bert_layer: {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
          f"nn.TransformerEncoderLayer {library_ms:.3f} ms ({library_ms.span}) (its real rows vs "
          f"the plain version: max_rel_err {lib_err:.3e}); bound {rec['bound_ms']:.4f} ms "
          f"(three bf16 products, {real_keys} real keys), the fp32 FFMA bound over every key "
          f"{ffma_ms:.3f} ms [{card}]")
    if ms < rec["bound_ms"]:
        raise AssertionError(f"bert_layer: {ms} ms reads faster than its bound {rec['bound_ms']}")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **rec, library_ms=library_ms)


def slice_phase(torch, model, card: str) -> dict:
    """The zero-shot path through CTClipInference.predict; returns launch counts."""
    import tempfile

    import numpy as np

    from ct_clip_ut_tpu_torch.infer.zeroshot import (CTClipInference, WordTokenizer,
                                                     encode_prompt_latents, tokenize_prompts,
                                                     zeroshot_probs)
    from ct_clip_ut_tpu_torch.models.ctclip import encode_image_latents, encode_text_latents
    from ct_clip_ut_tpu_torch.models.ctvit import (_patch_embed, _patch_embed_conv,
                                                   ctvit_encode, patchify, token_grid_shape)
    from ct_clip_ut_tpu_torch.ops import launches

    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = tokenize_prompts(WordTokenizer(cfg.bert.vocab_size), max_length=PROMPT_LEN,
                               device="cuda")
    real = prompts["attention_mask"].sum(1)
    rng = np.random.default_rng(1)
    data = [(torch.randn((BATCH, *VOLUME), generator=g, device="cuda", dtype=torch.bfloat16),
             None, rng.integers(0, 2, (BATCH, 18))) for _ in range(BATCHES)]
    latents = encode_prompt_latents(model, prompts)                # warm-up
    zeroshot_probs(model, data[0][0], latents)
    torch.cuda.synchronize()

    runner = CTClipInference(model, prompts, data)
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    preds, targets = runner.predict()
    seconds = time.perf_counter() - t0
    counts = launches.launch_counts()
    print(f"slice: CTClipInference.predict {BATCHES} x {BATCH} volumes with one encoding of "
          f"{PROMPTS} prompts x {PROMPT_LEN} tokens ({int(real.min())} to {int(real.max())} real) "
          f"in {seconds:.3f} s (smoke reading, host clock) [{card}]; launches {json.dumps(counts)}")
    if preds.shape != (BATCHES * BATCH, 18) or not np.isfinite(preds).all():
        raise AssertionError(f"bad predictions: shape {preds.shape}")
    if not ((preds >= 0) & (preds <= 1)).all():
        raise AssertionError("probabilities outside [0, 1]")
    missing = [k for k, v in counts.items()
               if v <= 0 and k not in TRAIN_KERNELS and k not in SERVING_KERNELS]
    if missing:
        raise AssertionError(f"kernels not launched on the zero-shot path: {missing}")

    # one prompt encoding alone (12 bert_layer chains), then its latents
    # against the plain path; the control drops the attention mask
    launches.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = CTClipInference(model, prompts, []).prompt_latents()
    torch.cuda.synchronize()
    prompt_ms = 1e3 * (time.perf_counter() - t0)
    text_counts = launches.launch_counts()
    with torch.no_grad():
        text_plain = encode_text_latents(model, prompts, plain=True)
        text_nomask = encode_text_latents(model, {**prompts, "attention_mask":
                                                  torch.ones_like(prompts["attention_mask"])},
                                          plain=True)
    cos = torch.nn.functional.cosine_similarity
    text_err = (1.0 - cos(text, text_plain, dim=-1)).max().item()
    text_control = (1.0 - cos(text_nomask, text_plain, dim=-1)).min().item()
    print(f"slice: CTClipInference.prompt_latents() {prompt_ms:.3f} ms (host clock, "
          f"synchronised) [{card}]; launches {json.dumps(text_counts)}; prompt latents vs the "
          f"plain path: 1 - cos {text_err:.3e} (band {PROMPT_BAND}); control (mask dropped) "
          f"1 - cos >= {text_control:.3e}")
    if text_counts["bert_layer"] != cfg.bert.num_layers:
        raise AssertionError(f"prompt encoding launched bert_layer {text_counts['bert_layer']} "
                             f"times, not {cfg.bert.num_layers}")
    if not text_err <= PROMPT_BAND < text_control:
        raise AssertionError(f"prompt latents: 1 - cos {text_err}, band {PROMPT_BAND}, "
                             f"control {text_control}")

    # the patch embed's token grid against the plain embed (PR 1's path) on
    # the same volume; the encoder (spatial + temporal stacks, every float
    # kernel) on N(0, 1) tokens; batch 0's image latents, kernel path vs
    # plain path. The controls are the distances between the batch's two
    # volumes (the signal).
    vit = model.visual_transformer
    vcfg = vit.cfg
    t, h, w = token_grid_shape(vcfg, VOLUME)
    tokens = torch.randn((BATCH, t, h, w, vcfg.dim), generator=g, device="cuda",
                         dtype=torch.bfloat16)
    with torch.no_grad():
        vol = data[0][0]
        grid = _patch_embed_conv(vit, vol).float()
        grid_plain = _patch_embed(vit.to_patch_emb, patchify(vol, vcfg.patch_size,
                                                             vcfg.temporal_patch_size)).float()
        enc = ctvit_encode(vit, tokens)[0].float()
        enc_plain = ctvit_encode(vit, tokens, plain=True)[0].float()
        enc_fp32 = ctvit_encode(vit, tokens.float(), plain=True)[0]
        lat, out = encode_image_latents(model, vol)
        lat_plain, out_plain = encode_image_latents(model, vol, plain=True)
    lat, lat_plain = lat.float(), lat_plain.float()
    if not all(torch.isfinite(v).all() for v in (grid, enc, lat)):
        raise AssertionError("non-finite token grid, encoder output or image latents")
    if lat.shape != (BATCH, cfg.dim_latent):
        raise AssertionError(f"bad image latents: shape {tuple(lat.shape)}")
    grid_err = rel_rms(grid, grid_plain)
    grid_control = rel_rms(grid_plain[1], grid_plain[0])
    enc_err = rel_rms(enc, enc_plain)
    enc_control = rel_rms(enc_plain[1], enc_plain[0])
    lat_err = (1.0 - cos(lat, lat_plain, dim=-1)).max().item()
    lat_control = (1.0 - cos(lat_plain[0], lat_plain[1], dim=-1)).item()
    same_ids = (out.codebook_ids == out_plain.codebook_ids).float().mean().item()
    print(f"slice: patch_embed token grid vs the plain embed (patch_embed_conv=False): relative "
          f"rms {grid_err:.3e} (band {ENCODER_BAND}), max_rel_err {rel_err(grid, grid_plain):.3e};"
          f" control (volume 0 vs 1) {grid_control:.3e}")
    print(f"slice: encoder output vs the plain path: relative rms {enc_err:.3e} (band "
          f"{ENCODER_BAND}), max_rel_err {rel_err(enc, enc_plain):.3e}; control (volume 0 vs 1) "
          f"{enc_control:.3e}; the plain path in bf16 vs in fp32: relative rms "
          f"{rel_rms(enc_plain, enc_fp32):.3e}")
    print(f"slice: batch 0 image latents vs the plain path: 1 - cos {lat_err:.3e} (band "
          f"{LATENT_BAND}), max abs diff {(lat - lat_plain).abs().max().item():.3e}, "
          f"{same_ids:.6f} of VQ indices equal; control (volume 0 vs 1) 1 - cos "
          f"{lat_control:.3e}; probabilities in [{preds.min():.4f}, {preds.max():.4f}]")
    if not grid_err <= ENCODER_BAND < grid_control:
        raise AssertionError(f"token grid: relative rms {grid_err}, band {ENCODER_BAND}, "
                             f"control {grid_control}")
    if not enc_err <= ENCODER_BAND < enc_control:
        raise AssertionError(f"encoder output: relative rms {enc_err}, band {ENCODER_BAND}, "
                             f"control {enc_control}")
    if not lat_err <= LATENT_BAND < lat_control:
        raise AssertionError(f"image latents: 1 - cos {lat_err}, band {LATENT_BAND}, "
                             f"control {lat_control}")

    # the metrics, with numpy alone (the card's machine has no scikit-learn)
    with tempfile.TemporaryDirectory() as tmp:
        runner.results_folder = Path(tmp)
        m, _, _ = runner.zeroshot()
        report = (Path(tmp) / "metrics.txt").read_text()
    if not report.startswith("Epoch 0 Metrics:") or "+=" not in report:
        raise AssertionError("zeroshot() wrote no metrics table")
    print(f"slice: zeroshot() wrote metrics.txt ({len(report.splitlines())} lines): label "
          f"accuracy {m['label_accuracy']:.4f}, mean ROC-AUC {m['mean_roc_auc']:.4f}")
    return counts


def int8_check(torch, model, card: str) -> dict:
    """geglu_ff_int8 against its plain version at the zero-shot FF's shape
    (x [2 * 13824, 512] bf16; spatial layer 0's FF of the seeded flagship,
    quantised, with the LN gain drawn as 1 + 0.1 N and bias 0.1 N), residual
    off and on, with the controls; times, the bound and the torch._int_mm
    chain (LN, per-row quantisation, cuBLASLt int8 products, GELU) as the
    library yardstick."""
    import torch.nn.functional as F

    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.geglu_ff_int8 import (geglu_ff_int8, geglu_ff_int8_plain,
                                                        row_quant)
    from ct_clip_ut_tpu_torch.ops.quant import quantize_ff_params

    vit = model.visual_transformer
    g = torch.Generator(device="cuda").manual_seed(11)
    t, h, w = token_grid_shape(vit.cfg, VOLUME)
    d = vit.cfg.dim
    q = quantize_ff_params(vit.enc_spatial_transformer.layers[0][3])
    q.gamma.copy_(around_ones(torch, g, d))
    q.beta.copy_(0.1 * torch.randn((d,), generator=g, device="cuda"))
    args = [q.gamma, q.beta, q.wv_q, q.wg_q, q.w2_q, q.sv, q.sg, q.s2]
    swapped = list(args)
    swapped[5], swapped[6] = args[6], args[5]
    x = torch.randn((BATCH * t * h * w, d), generator=g, device="cuda").to(torch.bfloat16)
    for residual in (False, True):
        got = geglu_ff_int8(x, *args, residual=residual)
        want = geglu_ff_int8_plain(x, *args, residual=residual)
        torch.cuda.synchronize()
        err = rel_rms(got, want)
        controls = {"h unquantised": geglu_ff_int8_plain(x, *args, residual=residual,
                                                         faults=("h_float",)),
                    "per-tensor scales": geglu_ff_int8_plain(x, *args, residual=residual,
                                                             faults=("per_tensor",)),
                    "sv / sg swapped": geglu_ff_int8_plain(x, *swapped, residual=residual)}
        controls = {k: rel_rms(got, c) for k, c in controls.items()}
        abs_err = (got.float() - want.float()).abs().max().item()
        print(f"kernel geglu_ff_int8 x {list(x.shape)}, inner {q.inner_dim} (padded "
              f"{q.wv_q.shape[0]}), residual={residual}: relative rms {err:.3e} (band "
              f"{INT8_BAND}), max_rel_err {rel_err(got, want):.3e}, max_abs_err {abs_err:.3e}; "
              "controls " + ", ".join(f"{k} {v:.3e}" for k, v in controls.items()))
        if not got.float().isfinite().all():
            raise AssertionError("geglu_ff_int8: non-finite kernel output")
        if not err <= INT8_BAND < min(controls.values()):
            raise AssertionError(f"geglu_ff_int8: relative rms {err}, band {INT8_BAND}, "
                                 f"controls {controls}")
        if not residual:
            branch_abs_err = abs_err
    hopper_chain_check("geglu_ff_int8", lambda: geglu_ff_int8(x, *args, residual=True), card)
    inner = q.wv_q.shape[0]
    wvg_t = torch.cat([q.wv_q, q.wg_q]).t()            # [512, 2 * inner], column-major
    w2_t = q.w2_q.t()

    def library():
        xn = F.layer_norm(x.float(), (d,), q.gamma, q.beta, eps=1e-5)
        xi, rx = row_quant(xn)
        vg = torch._int_mm(xi, wvg_t).float() * rx
        hh = F.gelu(vg[:, inner:] * q.sg) * (vg[:, :inner] * q.sv)
        hi, rh = row_quant(hh)
        return (torch._int_mm(hi, w2_t).float() * rh * q.s2 + x.float()).to(x.dtype)

    lib_err = rel_rms(library(), geglu_ff_int8_plain(x, *args, residual=True))
    ms = cuda_ms(torch, lambda: geglu_ff_int8(x, *args, residual=True))
    plain_ms = cuda_ms(torch, lambda: geglu_ff_int8_plain(x, *args, residual=True), iters=3)
    library_ms = library_time(torch, library)
    flops = 2 * x.shape[0] * d * q.inner_dim * 3
    rec = bound(flops, nbytes(x, *args, x), INT8_PEAK)
    print(f"kernel geglu_ff_int8: {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), torch._int_mm chain {library_ms:.3f} "
          f"ms ({library_ms.span}) (relative rms {lib_err:.3e} vs the plain version) [{card}]")
    return dict(max_abs_err=branch_abs_err, ms=ms, plain_ms=plain_ms, **rec,
                library_ms=library_ms)


def quantized_phase(torch, model, card: str) -> dict:
    """The zero-shot path with --quantize-ff: CTClipInference.predict over
    BATCHES batches of BATCH volumes on quantize_ctclip_ff(model), 8
    geglu_ff_int8 launches a batch and no geglu_ff; batch 0's image latents
    against plain=True on the same quantised model (control: volume 0 vs
    1); the probabilities against the bf16 model's; both FF weight sizes.
    Returns the launch counts of the predict run."""
    import numpy as np

    from ct_clip_ut_tpu_torch.infer.zeroshot import (CTClipInference, WordTokenizer,
                                                     tokenize_prompts)
    from ct_clip_ut_tpu_torch.models.ctclip import encode_image_latents
    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.ops.quant import ff_weight_bytes, quantize_ctclip_ff

    qmodel = quantize_ctclip_ff(model)
    g = torch.Generator(device="cuda").manual_seed(12)
    prompts = tokenize_prompts(WordTokenizer(model.cfg.bert.vocab_size), max_length=PROMPT_LEN,
                               device="cuda")
    data = [(torch.randn((BATCH, *VOLUME), generator=g, device="cuda", dtype=torch.bfloat16),
             None, np.zeros((BATCH, 18))) for _ in range(BATCHES)]
    runner = CTClipInference(qmodel, prompts, data)
    runner.predict()                                                   # warm-up
    torch.cuda.synchronize()
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    preds, _ = runner.predict()
    seconds = time.perf_counter() - t0
    counts = launches.launch_counts()
    depth = model.cfg.ctvit.spatial_depth + model.cfg.ctvit.temporal_depth
    print(f"quantized: CTClipInference.predict on quantize_ctclip_ff(model), {BATCHES} x {BATCH} "
          f"volumes in {seconds:.3f} s (smoke reading, host clock) [{card}]; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    if counts["geglu_ff_int8"] != depth * BATCHES or counts["geglu_ff"] != 0:
        raise AssertionError(f"quantized path: geglu_ff_int8 {counts['geglu_ff_int8']} "
                             f"launches (want {depth * BATCHES}), geglu_ff {counts['geglu_ff']}")
    missing = [k for k in ("attn_block", "attn_packed", "vq_nearest", "patch_embed")
               if counts[k] <= 0]
    if missing or not np.isfinite(preds).all():
        raise AssertionError(f"quantized path: kernels not launched {missing} or bad preds")

    bf16_preds, _ = CTClipInference(model, prompts, data).predict()
    cos = torch.nn.functional.cosine_similarity
    with torch.no_grad():
        lat, out = encode_image_latents(qmodel, data[0][0])
        lat_plain, out_plain = encode_image_latents(qmodel, data[0][0], plain=True)
    lat, lat_plain = lat.float(), lat_plain.float()
    lat_err = (1.0 - cos(lat, lat_plain, dim=-1)).max().item()
    lat_control = (1.0 - cos(lat_plain[0], lat_plain[1], dim=-1)).item()
    same_ids = (out.codebook_ids == out_plain.codebook_ids).float().mean().item()
    wq, wb = ff_weight_bytes(qmodel), ff_weight_bytes(model)
    print(f"quantized: batch 0 image latents vs plain=True: 1 - cos {lat_err:.3e} (band "
          f"{LATENT_BAND}), {same_ids:.6f} of VQ indices equal; control (volume 0 vs 1) 1 - cos "
          f"{lat_control:.3e}")
    print(f"quantized: probabilities vs the bf16 model over {BATCHES * BATCH} volumes: max abs "
          f"diff {np.abs(preds - bf16_preds).max():.4e}, mean abs diff "
          f"{np.abs(preds - bf16_preds).mean():.4e}; FF weights (8 layers) int8 + scales "
          f"{wq['stored']} B, fp {wb['stored']} B as stored ({wb['served']} B as the bf16 "
          f"kernels read them)")
    if not lat_err <= LATENT_BAND < lat_control:
        raise AssertionError(f"quantized latents: 1 - cos {lat_err}, band {LATENT_BAND}, "
                             f"control {lat_control}")
    return counts


def write_cli_dataset(root: Path, rng, reports=("the lungs are clear", "no acute finding"),
                      volumes: int = 2):
    """`volumes` synthetic NIfTI volumes (raw CLI_VOLUME int16 grids at
    CLI_SPACING, which the chain resamples and pads to [1, 240, 480, 480])
    under root/valid with their reports / metadata / labels CSVs; returns
    the CLI's data arguments."""
    import csv

    import numpy as np

    from ct_clip_ut_tpu_torch.data.nifti import write_nii

    xy, z = CLI_SPACING
    (root / "valid").mkdir()
    names = [f"valid_{i}_a_1.nii.gz" for i in range(volumes)]
    for name in names:
        write_nii(root / "valid" / name, rng.integers(-1024, 2000, CLI_VOLUME).astype(np.int16),
                  pixdim=(xy, xy, z))
    tables = {"reports.csv": [["VolumeName", "Findings_EN", "Impressions_EN"]] + [
                  [n, *reports] for n in names],
              "metadata.csv": [["VolumeName", "RescaleSlope", "RescaleIntercept",
                                "XYSpacing", "ZSpacing"]] + [
                  [n, "1", "0", f"[{xy}, {xy}]", str(z)] for n in names],
              "labels.csv": [["VolumeName"] + [f"p{i}" for i in range(18)]] + [
                  [n] + [str(int(v)) for v in rng.integers(0, 2, 18)] for n in names]}
    for fname, rows in tables.items():
        with open(root / fname, "w", newline="") as f:
            csv.writer(f).writerows(rows)
    return ["--data-valid", str(root / "valid"), "--valid-reports", str(root / "reports.csv"),
            "--valid-labels", str(root / "labels.csv"), "--valid-metadata",
            str(root / "metadata.csv")]


def cli_phase(torch, card: str) -> None:
    """scripts.inference_ctclip.main end to end: 2 synthetic NIfTI volumes
    (raw int16 grids the chain resamples and pads to [1, 240, 480, 480])
    with their reports / labels / metadata CSVs in a temporary directory,
    --zero-shot with --quantize-ff and without, each writing metrics.txt."""
    import tempfile

    import numpy as np

    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.scripts import inference_ctclip

    xy, z = CLI_SPACING
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data_argv = write_cli_dataset(root, np.random.default_rng(13))
        for quantize in (True, False):
            out = root / ("results_int8" if quantize else "results")
            argv = data_argv + ["--results-folder", str(out), "--zero-shot", "--batch-size",
                                "2", "--num-workers", "2"]
            launches.reset_launch_counts()
            t0 = time.perf_counter()
            m, preds, _ = inference_ctclip.main(argv + (["--quantize-ff"] if quantize else []))
            seconds = time.perf_counter() - t0
            counts = launches.launch_counts()
            report = (out / "metrics.txt").read_text()
            print(f"cli: inference_ctclip --zero-shot{' --quantize-ff' if quantize else ''} on 2 "
                  f"volumes {list(CLI_VOLUME)} int16 (xy {xy} mm, z {z} mm) in {seconds:.1f} s "
                  f"(host clock, model init and preprocessing included) [{card}]: metrics.txt "
                  f"{len(report.splitlines())} lines, probabilities [{preds.min():.4f}, "
                  f"{preds.max():.4f}]; launches {json.dumps({k: v for k, v in counts.items() if v})}")
            if not report.startswith("Epoch 0 Metrics:") or preds.shape != (2, 18):
                raise AssertionError("the CLI wrote no metrics table")
            if (counts["geglu_ff_int8"] > 0) != quantize or (counts["geglu_ff"] > 0) == quantize:
                raise AssertionError(f"the CLI took the wrong FF route: {counts}")


def reference_state_dict(torch, model) -> dict:
    """`model`'s weights in the layout of the reference's ctclip_v2.pt as
    its trainer saves it: {"model": ..., "optim": ...}, every key under
    DDP's `module.` prefix, the VQ buffers with their leading
    num_codebooks axis, HF BERT's position-id buffer and pooler (which the
    converter drops), on the CPU."""
    sd = {}
    for k, v in model.state_dict().items():
        v = v.detach().cpu()
        sd[f"module.{k}"] = v[None] if ".vq._codebook." in k else v
    d, n = model.cfg.bert.hidden_size, model.cfg.bert.max_position_embeddings
    sd["module.text_transformer.embeddings.position_ids"] = torch.arange(n)[None]
    sd["module.text_transformer.pooler.dense.weight"] = torch.zeros(d, d)
    sd["module.text_transformer.pooler.dense.bias"] = torch.zeros(d)
    return {"model": sd, "optim": {}}


TRAIN_CLI_VOLUMES = 8        # the train CLI's epoch: 4 steps of 2 volumes in 2 microbatches
TRAIN_CLI_WORDS = ("the lungs are clear no acute finding emphysema nodule effusion in right "
                   "upper lobe").split()
# the bf16 512-token step's kernels with peg_pallas=True (GradCache: pass 1
# takes each forward's no-grad kernel, pass 2 its autograd forward and backward)
TRAIN_CLI_PATH = ("patch_embed", "patch_embed_res", "patch_embed_dkw", "attn_block",
                  "attn_block_bwd", "attn_packed", "attn_packed_bwd", "geglu_ff", "geglu_ff_bwd",
                  "vq_nearest", "bert_layer_bf16", "bert_layer_bwd", "peg", "peg_weight_grads")


def train_cli_phase(torch, card: str) -> None:
    """Phase 4e, the train CLI as users run it, at flagship width with
    peg_pallas=True: a reference-layout state dict of init_ctclip's seeded
    weights (reference_state_dict), a vocab.txt of the reports' words, and
    scripts.train_ctclip.main for one epoch over TRAIN_CLI_VOLUMES synthetic
    NIfTI volumes with --checkpoint, --tokenizer, --batch-size 2
    --grad-accum 2 (bf16, 512-token reports). Checks: the converted weights
    the source's bits; finite losses; the run's last_checkpoint.pt (the
    port's train state) reloads into the trained model's bits; every kernel
    of TRAIN_CLI_PATH launched, the GradCache counts of BERT's and the
    PEG's kernels (two forwards and one backward a microbatch), no fp32 or
    serving kernel. Prints the seconds of each step (host clock,
    synchronised)."""
    import tempfile

    import numpy as np

    from ct_clip_ut_tpu_torch import convert
    from ct_clip_ut_tpu_torch.config import flagship_cfg, replace
    from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.scripts import train_ctclip
    from ct_clip_ut_tpu_torch.train import trainer as trainer_mod

    t_phase = time.perf_counter()
    cfg = flagship_cfg()
    cfg = replace(cfg, ctvit=replace(cfg.ctvit, peg_pallas=True))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        source = init_ctclip(cfg, seed=31, device="cuda")
        want = {k: v.detach().clone() for k, v in source.state_dict().items()}
        torch.save(reference_state_dict(torch, source), root / "ctclip_v2.pt")
        del source
        converted = convert.load_ctclip(root / "ctclip_v2.pt", cfg, device="cuda").state_dict()
        same = [k for k, v in converted.items() if torch.equal(v, want[k])]
        print(f"train cli: the reference-layout checkpoint ({len(want)} tensors under module., "
              f"the codebook's leading axis, position_ids and the pooler) converted to the "
              f"source's bits in {len(same)} of {len(want)} tensors")
        if len(same) != len(want) or set(converted) != set(want):
            raise AssertionError(f"the converter moved {sorted(set(want) - set(same))[:5]}")
        del converted
        (root / "tok").mkdir()
        (root / "tok" / "vocab.txt").write_text("\n".join(
            ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ","] + list(TRAIN_CLI_WORDS)))
        data = write_cli_dataset(root, np.random.default_rng(17), volumes=TRAIN_CLI_VOLUMES,
                                 reports=("the lungs are clear, no acute finding.",
                                          "emphysema in the right upper lobe; a nodule."))
        csvs = dict(zip(data[::2], data[1::2]))
        argv = ["--data-train", csvs["--data-valid"], "--train-reports", csvs["--valid-reports"],
                "--train-metadata", csvs["--valid-metadata"], *data,
                "--checkpoint", str(root / "ctclip_v2.pt"), "--tokenizer", str(root / "tok"),
                "--batch-size", "2", "--grad-accum", "2", "--num-epochs", "1",
                "--num-train-samples", str(TRAIN_CLI_VOLUMES), "--num-valid-samples", "2",
                "--save-every-steps", "2", "--num-workers", "4",
                "--results-folder", str(root / "train")]
        seconds, make = [], trainer_mod.make_train_step

        def timed_make(*a, **kw):
            step = make(*a, **kw)

            def timed(state, image, tokens):
                t0 = time.perf_counter()
                loss = step(state, image, tokens)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                return loss
            return timed

        trainer_mod.make_train_step = timed_make
        launches.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            tr = train_ctclip.main(argv, model_cfg=cfg)
        finally:
            trainer_mod.make_train_step = make
        total = time.perf_counter() - t0
        counts = launches.launch_counts()
        last = tr.results_folder / "last_checkpoint.pt"
        back = convert.load_ctclip(last, cfg, device="cuda").state_dict()
        reloaded = all(torch.equal(v, back[k]) for k, v in tr.state.model.state_dict().items())
        files = sorted(p.name for p in tr.results_folder.iterdir())
    losses = tr.train_losses["epochs"] + tr.valid_losses
    steps = int(tr.state.step)
    print(f"train cli: train_ctclip --batch-size 2 --grad-accum 2 over {TRAIN_CLI_VOLUMES} "
          f"volumes {list(CLI_VOLUME)} int16 -> [1, 240, 480, 480] bf16, 512-token reports, "
          f"peg_pallas=True: {steps} steps in {total:.1f} s (host clock; weights, preprocessing, "
          f"{len(tr.valid_losses)} evaluations and a checkpoint included), the steps "
          + ", ".join(f"{v:.3f}" for v in seconds) + f" s each (host clock, synchronised; after "
          f"the first, median {statistics.median(seconds[1:]):.3f} s) [{card}]; losses {losses}; last_checkpoint.pt reloads the trained bits: {reloaded}; "
          f"files {files}; launches {json.dumps({k: v for k, v in counts.items() if v})}")
    if steps != TRAIN_CLI_VOLUMES // 2 or not all(np.isfinite(losses)) or not reloaded:
        raise AssertionError(f"the train CLI: {steps} steps, losses {losses}, reloaded {reloaded}")
    missing = [k for k in TRAIN_CLI_PATH if counts[k] <= 0]
    foreign = [k for k in SERVING_KERNELS if counts[k] > 0]
    layers, pegs = cfg.bert.num_layers, cfg.ctvit.spatial_depth + cfg.ctvit.temporal_depth
    micro, evals = 2 * steps, len(tr.valid_losses)
    want_counts = {"bert_layer_bf16": (2 * micro + evals) * layers,
                   "bert_layer_bwd": micro * layers, "peg": (3 * micro + evals) * pegs,
                   "peg_weight_grads": micro * pegs, "patch_embed": micro + evals,
                   "patch_embed_res": micro, "patch_embed_dkw": micro}
    got_counts = {k: counts[k] for k in want_counts}
    if missing or foreign or got_counts != want_counts:
        raise AssertionError(f"the train CLI's launches: not launched {missing}, other paths' "
                             f"{foreign}, GradCache counts {got_counts} (expected "
                             f"{want_counts})")
    print(f"train cli: phase 4e in {time.perf_counter() - t_phase:.1f} s [{card}]")


GRADCACHE_SPLIT_BANDS = {"float32": DP_SPLIT_BAND, "bfloat16": FLOAT_BAND}


def group_rms(model, got, want) -> dict:
    """Relative rms of the gradients `got` against `want` (parameter
    order) over each parameter group (param_group)."""
    import torch

    groups = {}
    for (n, _), g, w in zip(model.named_parameters(), got, want):
        a, b = groups.setdefault(param_group(n), ([], []))
        a.append(g.detach().float().flatten())
        b.append(w.detach().float().flatten())
    return {k: ((torch.cat(a) - torch.cat(b)).norm() / torch.cat(b).norm()).item()
            for k, (a, b) in groups.items()}


def gradcache_batch(torch, g) -> tuple:
    """Phase 4e's GradCache batch, B = 2, whose latents lie apart at init:
    a white-noise volume and a smooth one (noise on a 15 x 30 x 30 grid,
    trilinear to VOLUME, standardised), and a 4-word report beside a
    300-word one from the other half of REPORT_WORDS. Two white-noise
    volumes and two long reports of the same words give latents that
    nearly coincide at init, and every gradient of a B = 2 contrastive loss
    is then the difference of two near-equal per-sample terms. Returns
    (images [2, *VOLUME] fp32, texts)."""
    import torch.nn.functional as F

    smooth = torch.randn((1, 1, 15, 30, 30), generator=g, device="cuda")
    smooth = F.interpolate(smooth, size=VOLUME[1:], mode="trilinear", align_corners=False)[0]
    images = torch.stack([torch.randn(VOLUME, generator=g, device="cuda"),
                          (smooth - smooth.mean()) / smooth.std()])
    half = len(REPORT_WORDS) // 2
    texts = [" ".join(REPORT_WORDS[:4]),
             " ".join(REPORT_WORDS[half + k % (len(REPORT_WORDS) - half)] for k in range(300))]
    return images, texts


def gradcache_check(torch, card: str) -> None:
    """Phase 4e's GradCache check at flagship width (peg_pallas=True), B = 2
    with 512-token reports, in fp32 (TrainConfig(compute_dtype="float32"):
    rows 6F-12F, 7F-9F, 10f, 11f) and bf16, on gradcache_batch. Deterministic
    (every dropout rate 0), from the same weights, every forward quantising
    with the single-pass step's VQ codes (VQRecorder; the flips counted,
    each a tie within VQ_F32_TIE, VQ_TIE in bf16). One GradCache step
    (k = 2) against (a) the same batch's loss with each microbatch's
    latents from a forward of its own in one graph (split_step_grads:
    GradCache's function without its two passes): every gradient within
    GRADCACHE_SPLIT_BANDS of its largest entry (fp32 DP_SPLIT_BAND, bf16
    FLOAT_BAND); (b) the single-pass step of make_train_step: the codebook
    within DP_CODEBOOK_BAND, the loss within STEP_GRAD_BAND (fp32) or
    FLOAT_BAND (bf16); in fp32 every gradient entering the optimizer within
    STEP_GRAD_BAND of its largest entry. In bf16 the single-pass step
    itself lies ~3e-2 (relative rms per group) from the fp32 step at these
    codes, a batch of 1 rounds otherwise than a batch of 2, and so
    GradCache's bf16 gradients are held against the fp32 single-pass step
    (on the bf16 run's codes): each group's relative rms within the bf16
    single-pass step's own plus FLOAT_BAND; the direct reading against the
    bf16 single-pass step is printed. The controls, another batch's
    single-pass gradients, lie outside the bands. In train mode (BERT's
    dropout 0.1) each microbatch's latents of pass 2 are pass 1's, bit for
    bit, in both dtypes (the generator's state replayed: the same Philox
    seeds for the BERT kernels)."""
    import torch.nn.functional as F

    from ct_clip_ut_tpu_torch.config import TrainConfig, flagship_cfg, replace
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
    from ct_clip_ut_tpu_torch.models.ctclip import CTCLIP, ctclip_apply, init_ctclip
    from ct_clip_ut_tpu_torch.train.trainer import create_train_state, make_train_step_gradcache

    cfg = flagship_cfg()
    cfg = replace(cfg, ctvit=replace(cfg.ctvit, peg_pallas=True))
    det = replace(cfg, bert=replace(cfg.bert, hidden_dropout=0.0, attention_dropout=0.0))
    with torch.device("meta"):
        meta = CTCLIP(det)                     # the parameters' names and groups
    g = torch.Generator(device="cuda").manual_seed(53)
    batch, texts = gradcache_batch(torch, g)
    other, other_texts = train_batches(torch, g, 1, DP_REPORT_WORDS, dtype=torch.float32)[0]
    tok = WordTokenizer(cfg.bert.vocab_size)
    f32 = TrainConfig(compute_dtype="float32")

    def tokens(t):
        enc = tok(t, max_length=f32.text_max_length)
        return {k: torch.as_tensor(v, device="cuda") for k, v in enc.items()}

    def worst(e):
        return ", ".join(f"{k} {v:.3e}" for k, v in sorted(e.items(), key=lambda kv: -kv[1])[:2])

    def groups(e):
        return ", ".join(f"{k} {v:.3e}" for k, v in e.items())

    with torch.no_grad():
        out = ctclip_apply(init_ctclip(det, seed=47), tokens(texts), batch)
        i, t = (F.normalize(x.float(), dim=-1) for x in (out.image_latents, out.text_latents))
    print(f"gradcache: B = 2 apart at init (gradcache_batch): fp32 latents' cosines, images "
          f"{(i[0] @ i[1]).item():.4f}, reports {(t[0] @ t[1]).item():.4f}")
    for dtype in ("float32", "bfloat16"):
        fp32 = dtype == "float32"
        tcfg = TrainConfig(compute_dtype=dtype)
        images = batch.to(getattr(torch, dtype))
        with VQRecorder(torch) as rec:
            loss_sp, grads_sp, cb_sp = dp_step(torch, det, tcfg, init_ctclip(det, seed=47),
                                               images, tokens(texts))
        rows = rec.ids[0]

        class Codes:
            ids = [rows[0:1], rows[1:2]] * 2      # pass 1's microbatches, then pass 2's

        class Whole:
            ids = [rows]

        with VQRecorder(torch, against=Codes, replay=True) as vq:
            loss_gc, grads_gc, cb_gc = dp_step(torch, det, replace(tcfg, grad_accum=2),
                                               init_ctclip(det, seed=47), images, tokens(texts))
        with VQRecorder(torch, against=Codes, replay=True):
            split = split_step_grads(torch, init_ctclip(det, seed=47).requires_grad_(True),
                                     images, tokens(texts), ((0, 1), (1, 2)))
        ctrl = dp_step(torch, det, tcfg, init_ctclip(det, seed=47), other.to(images.dtype),
                       tokens(other_texts))[1]
        band, tie = (STEP_GRAD_BAND, VQ_F32_TIE) if fp32 else (FLOAT_BAND, VQ_TIE)
        errs, ctrl_errs = step_errors(meta, grads_gc, grads_sp), step_errors(meta, ctrl, grads_sp)
        split_errs = step_errors(meta, grads_gc, split)
        loss_err = abs(loss_gc - loss_sp) / abs(loss_sp)
        cb_err = codebook_err(cb_gc, cb_sp)
        flips = int(vq.flips().sum())
        line = (f"gradcache {dtype}: one GradCache step (k = 2) vs one single-pass step at B = 2, "
                f"flagship, {tcfg.text_max_length}-token reports, dropout 0: loss {loss_gc:.6f} vs "
                f"{loss_sp:.6f} (relative {loss_err:.3e}, band {band}); gradients max |diff| over "
                f"the tensor's largest entry {max(errs.values()):.3e} ({worst(errs)}"
                + (f", band {band}" if fp32 else "") + "), relative rms per group "
                + groups(group_rms(meta, grads_gc, grads_sp))
                + f"; vs the same microbatches' forwards in one graph (the split step) "
                f"{max(split_errs.values()):.3e} ({worst(split_errs)}; band "
                f"{GRADCACHE_SPLIT_BANDS[dtype]}); codebook {cb_err:.3e} (band "
                f"{DP_CODEBOOK_BAND}); VQ flips {flips} (largest tie "
                f"{max(vq.gaps, default=0.0):.2e}, band {tie})")
        bad = (loss_err > band or cb_err > DP_CODEBOOK_BAND
               or max(split_errs.values()) > GRADCACHE_SPLIT_BANDS[dtype]
               or max(vq.gaps, default=0.0) > tie)
        if fp32:
            blind = not max(ctrl_errs.values()) > band
            bad = bad or max(errs.values()) > band
            line += f"; control (another batch) max {max(ctrl_errs.values()):.3e}"
        else:
            # the fp32 single-pass step at the bf16 run's codes (the flips
            # printed: bf16's VQ inputs move off fp32's by its rounding)
            with VQRecorder(torch, against=Whole, replay=True) as vq32:
                ref = dp_step(torch, det, f32, init_ctclip(det, seed=47), images.float(),
                              tokens(texts))[1]
            own, gc_rms = group_rms(meta, grads_sp, ref), group_rms(meta, grads_gc, ref)
            ctrl_rms = group_rms(meta, ctrl, ref)
            over = {k: v for k, v in gc_rms.items() if not v <= own[k] + FLOAT_BAND}
            blind = any(not v > own[k] + FLOAT_BAND for k, v in ctrl_rms.items())
            bad = bad or bool(over)
            line += (f"; vs the fp32 single-pass step (its VQ flips {int(vq32.flips().sum())}, "
                     f"largest gap {max(vq32.gaps, default=0.0):.2e}), relative rms per group, "
                     f"GradCache " + groups(gc_rms) + ", the single-pass step " + groups(own)
                     + f" (band: the single-pass step's + {FLOAT_BAND}); control (another "
                     f"batch) " + groups(ctrl_rms))
            del ref
        print(line + f" [{card}]")
        if bad or blind:
            raise AssertionError(f"GradCache {dtype}: {line}")
        del grads_gc, grads_sp, ctrl, split

        # train mode: pass 2 replays pass 1's dropout
        record = {}
        state = create_train_state(cfg, tcfg, params=init_ctclip(cfg, seed=47), device="cuda")
        make_train_step_gradcache(cfg, replace(tcfg, grad_accum=2), record=record)(
            state, images, tokens(texts))
        same = [torch.equal(a, b) for p1, p2 in zip(record["pass1"], record["pass2"])
                for a, b in zip(p1, p2)]
        print(f"gradcache {dtype}: dropout 0.1 at BERT's sites, pass 2's latents pass 1's bits in "
              f"{sum(same)} of {len(same)} (image and text latents of each microbatch)")
        if not all(same):
            raise AssertionError(f"GradCache {dtype}: pass 2 drew other masks than pass 1")
        del state, record
        torch.cuda.empty_cache()


def cosine_check(torch, card: str) -> tuple:
    """cosine_attention against its plain version at the spatial shape the
    TPU kernel was written for (q / k / v [384, 576, 32] bf16, bias [8, 576,
    576] fp32) and the temporal one without a bias ([9216, 24, 32]), with the
    controls (q_scale or k_scale left out, the bias left out); times, the
    bound and F.scaled_dot_product_attention (F.normalize, the scales, the
    bias as its mask, fp32) as the library yardstick. Then one
    cross-attention through ops/attention.attention() with a context and no
    null key/values, which must launch the kernel once. Returns (the record
    at the spatial shape, that call's launch counts)."""
    import torch.nn.functional as F

    from ct_clip_ut_tpu_torch.config import AttentionConfig
    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.ops.attention import Attention, attention
    from ct_clip_ut_tpu_torch.ops.cosine_attention import (cosine_attention,
                                                           cosine_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(14)
    heads, dh, scale = 8, 32, 8.0

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    record = None
    for bh, n, with_bias in ((BATCH * 24 * heads, 576, True), (*COSINE_TEMPORAL, False)):
        q, k, v = (randn(bh, n, dh).to(torch.bfloat16) for _ in range(3))
        qs, ks = around_ones(torch, g, dh), around_ones(torch, g, dh)
        bias = 0.5 * randn(heads, n, n) if with_bias else None
        args = (q, k, v, qs, ks, bias, heads, scale)
        got = cosine_attention(*args)
        want = cosine_attention_plain(*args)
        torch.cuda.synchronize()
        controls = {"no q_scale": cosine_attention_plain(q, k, v, torch.ones_like(qs), ks, bias,
                                                         heads, scale),
                    "k without k_scale": cosine_attention_plain(q, k, v, qs, torch.ones_like(ks),
                                                                bias, heads, scale)}
        if with_bias:
            controls["no bias"] = cosine_attention_plain(q, k, v, qs, ks, None, heads, scale)
        abs_err = band_check("cosine_attention", got, want, FLOAT_BAND,
                             {c: rel_err(got, o) for c, o in controls.items()},
                             f"q/k/v {list(q.shape)}, bias "
                             f"{list(bias.shape) if with_bias else None}")

        def library():
            mask = None if bias is None else bias.expand(bh // heads, heads, n, n)
            qn = (F.normalize(q.float(), dim=-1) * (qs * scale)).view(-1, heads, n, dh)
            kn = (F.normalize(k.float(), dim=-1) * ks).view(-1, heads, n, dh)
            o = F.scaled_dot_product_attention(qn, kn, v.float().view(-1, heads, n, dh),
                                               attn_mask=mask, scale=1.0)
            return o.reshape(bh, n, dh).to(q.dtype)

        lib_err = rel_err(library(), want)
        ms = cuda_ms(torch, lambda: cosine_attention(*args))
        plain_ms = cuda_ms(torch, lambda: cosine_attention_plain(*args), iters=3)
        library_ms = library_time(torch, library)
        rec = bound(4 * bh * n * n * dh, nbytes(q, k, v, qs, ks, got)
                    + (nbytes(bias) if with_bias else 0), BF16_PEAK)
        print(f"kernel cosine_attention [{bh}, {n}, {dh}]: {ms:.3f} ms vs plain {plain_ms:.3f} "
              f"ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), SDPA yardstick "
              f"{library_ms:.3f} ms ({library_ms.span}) (max_rel_err {lib_err:.3e} vs the plain "
              f"version) [{card}]")
        if record is None:
            record = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **rec,
                          library_ms=library_ms)

    torch.manual_seed(15)
    cfg = AttentionConfig(dim=512, dim_head=dh, heads=heads, dim_context=768)
    attn = Attention(cfg).cuda()
    x = torch.randn((BATCH, 576, 512), generator=g, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((BATCH, 120, 768), generator=g, device="cuda").to(torch.bfloat16)
    launches.reset_launch_counts()
    with torch.no_grad():
        got = attention(attn, x, context=ctx, return_weights=False, residual=False).out
        counts = launches.launch_counts()
        want = attention(attn, x, context=ctx, return_weights=False, residual=False,
                         plain=True).out
    err = rel_err(got, want)
    print(f"cosine_attention: cross-attention x {list(x.shape)}, context {list(ctx.shape)}, "
          f"no null key/values: launches {json.dumps({k: v for k, v in counts.items() if v})}; "
          f"branch vs plain=True max_rel_err {err:.3e} (band {FLOAT_BAND})")
    if counts["cosine_attention"] != 1 or not err <= FLOAT_BAND:
        raise AssertionError(f"cross-attention route: {counts['cosine_attention']} launches, "
                             f"error {err}")
    return record, counts


def grads_check(name: str, got: dict, want: dict, band: float, faulty: dict, line: str) -> float:
    """Every gradient of a backward kernel within `band` (max relative
    error) of its plain version; each control (the gradients a kernel with
    one fault would give) must differ from the kernel's by more than the
    band in at least one gradient. Returns the largest abs error."""
    errs = {k: rel_err(got[k], want[k]) for k in want}
    # a control's distance is taken relative to the right gradient's maximum
    controls = {f: max(((got[k].float() - v[k].float()).abs().max()
                        / want[k].float().abs().max()).item() for k in v)
                for f, v in faulty.items()}
    abs_err = max((got[k].float() - want[k].float()).abs().max().item() for k in want)
    print(f"kernel {name} {line}: max_rel_err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (band {band}); controls " + ", ".join(f"{k} {v:.3e}" for k, v in controls.items()))
    if not all(got[k].float().isfinite().all() for k in got):
        raise AssertionError(f"{name}: non-finite gradients")
    bad = {k: v for k, v in errs.items() if not v <= band}
    if bad:
        raise AssertionError(f"{name}: gradients over the band {band}: {bad}")
    blind = {k: v for k, v in controls.items() if not v > band}
    if blind:
        raise AssertionError(f"{name}: the band {band} passes faulty kernels {blind}")
    return abs_err


def backward_phase(torch, model, card: str) -> dict:
    """The five backward kernels of the train step against their plain
    versions at the shapes a B = BATCH train step gives them; returns the
    per-kernel record (without launch counts). The attention and FF checks
    run on the branch (residual=False) with the math-fault controls, then
    with the residual, whose control leaves g out of dx."""
    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.attn_block import attn_block_bwd, attn_block_bwd_plain
    from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed_bwd, attn_packed_bwd_plain
    from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff_bwd, geglu_ff_bwd_plain
    from ct_clip_ut_tpu_torch.ops.posbias import continuous_pos_bias

    vit = model.visual_transformer
    cfg = vit.cfg
    g = torch.Generator(device="cuda").manual_seed(11)
    bf = torch.bfloat16
    t, h, w = token_grid_shape(cfg, VOLUME)
    hw, d = h * w, cfg.dim

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf)

    attn_names = ("dx", "dgamma", "dwq", "dwk", "dwv", "dwo", "dqs", "dks", "dbias")
    ff_names = ("dx", "dgamma", "dbeta", "dw_in", "dw_out")
    scale = vit.enc_spatial_transformer.layers[0][1].cfg.scale
    with torch.no_grad():
        bias = continuous_pos_bias(vit.spatial_rel_pos_bias, cfg.patch_height, cfg.patch_width)
    ff = vit.enc_spatial_transformer.layers[0][3]
    attn_faults = {"no LN gain in dx": "gamma", "softmax row term dropped": "row_term",
                   "l2-norm projection dropped": "l2norm"}
    # name: (kernel, plain, args before g, names, {control: fault})
    cases = {
        "attn_block_bwd": (attn_block_bwd, attn_block_bwd_plain,
                           [randn(BATCH * t, hw, d),
                            *block_args(torch, g, vit.enc_spatial_transformer), bias],
                           attn_names, attn_faults),
        "attn_packed_bwd": (attn_packed_bwd, attn_packed_bwd_plain,
                            [randn(BATCH * hw, t, d),
                             *block_args(torch, g, vit.enc_temporal_transformer)],
                            attn_names[:8], attn_faults),
        "geglu_ff_bwd": (geglu_ff_bwd, geglu_ff_bwd_plain,
                         [randn(BATCH * t * hw, d), around_ones(torch, g, d),
                          0.1 * torch.randn((d,), generator=g, device="cuda"),
                          ff[1].weight.to(bf), ff[4].weight.to(bf)],
                         ff_names, {"no LN gain in dx": "gamma", "GELU for GELU'": "gelu_prime"}),
    }
    out = {}
    for name, (kern, plain, args, names, faults) in cases.items():
        gr = randn(*args[0].shape)
        extra = (scale,) if name.startswith("attn") else ()
        got = dict(zip(names, kern(*args, gr, *extra, False)))
        want = dict(zip(names, plain(*args, gr, *extra, False)))
        torch.cuda.synchronize()
        faulty = {f: dict(zip(names, plain(*args, gr, *extra, False, faults=(fault,))))
                  for f, fault in faults.items()}
        if name == "geglu_ff_bwd":
            # the weight-gradient tiles' faults: a 64-token slice left out
            # of the sum, one 128 x 128 tile of each weight never written
            short = plain(args[0][SLICE:], *args[1:], gr[SLICE:], False)
            holes = {k: want[k].clone() for k in ("dw_in", "dw_out")}
            for t in holes.values():
                t[-TILE:, -TILE:] = 0
            faulty.update({"dW with one token slice left out": {"dw_in": short[3],
                                                                "dw_out": short[4]},
                           "dW with one tile unwritten": holes})
            again = kern(*args, gr, False)
            same = torch.equal(again[3], got["dw_in"]) and torch.equal(again[4], got["dw_out"])
            print(f"kernel {name}: dW of two calls equal: {same}")
            if not same:
                raise AssertionError(f"{name}: the weight gradients differ between two calls")
        if "dbias" in want:
            # the dbias pass's faults: its sum short of one sequence, one
            # 64 x 64 block never written
            short = plain(args[0][:-1], *args[1:], gr[:-1], *extra, False)[8]
            hole = want["dbias"].clone()
            hole[:, -64:, -64:] = 0
            faulty.update({"dbias zero": {"dbias": torch.zeros_like(want["dbias"])},
                           "dbias with one sequence left out": {"dbias": short},
                           "dbias with one block unwritten": {"dbias": hole}})
            again = kern(*args, gr, *extra, False)[8]
            print(f"kernel {name}: dbias of two calls equal: {torch.equal(again, got['dbias'])}")
            if not torch.equal(again, got["dbias"]):
                raise AssertionError(f"{name}: dbias differs between two calls")
        abs_err = grads_check(name, got, want, FLOAT_BAND, faulty,
                              f"x {list(args[0].shape)} (branch)")
        got = dict(zip(names, kern(*args, gr, *extra, True)))
        want = dict(zip(names, plain(*args, gr, *extra, True)))
        no_g = {"g missing from dx": {"dx": plain(*args, gr, *extra, False)[0]}}
        grads_check(name, got, want, FLOAT_BAND, no_g, "(residual)")
        ms = cuda_ms(torch, lambda: kern(*args, gr, *extra, True))
        plain_ms = cuda_ms(torch, lambda: plain(*args, gr, *extra, True))
        if name == "geglu_ff_bwd":
            def library(*a):
                return ff_library(*a, residual=True)
        else:
            def library(*a):
                bias_arg = a[8:] or (None,)
                return attn_library(*a[:8], *bias_arg, scale, residual=True)
        library_ms, lib_grads = library_grad_ms(torch, library, args, gr)
        lib_err = max(rel_err(lg, want[k]) for k, lg in zip(names, lib_grads))
        print(f"kernel {name}: {ms:.3f} ms vs plain {plain_ms:.3f} ms, the PyTorch chain's "
              f"forward + backward {library_ms:.3f} ms ({library_ms.span}) (its gradients vs the "
              f"plain ones: "
              f"max_rel_err {lib_err:.3e}) [{card}]")
        x = args[0]
        m = x.numel() // d
        grads = [v for v in got.values() if v is not None]
        if name == "geglu_ff_bwd":
            flops = 2 * 8 * m * d * args[4].shape[1]
        else:
            r, n, hd = x.shape[0], x.shape[1], args[2].shape[0]
            heads = hd // 32
            flops = 2 * r * (9 * n * d * hd + heads * 6 * n * n * 32)
        tensors = [a for a in args if isinstance(a, torch.Tensor)] + [gr]
        out[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                         **bound(flops, nbytes(*tensors, *grads), BF16_PEAK),
                         library_ms=library_ms)
    out.update(patch_embed_train_check(torch, model, card, g))
    return out


def patch_embed_train_check(torch, model, card: str, g) -> dict:
    """The residual-saving patch embed (out, the fp32 product, the LN1
    moments) and the projection weight grad on a [2, 1, 240, 480, 480] bf16
    volume. Controls: LN1's gain left out of the fold (the saved product
    and output change), LN2's bias left out; the weight grad with wv / cin
    swapped, and with the second volume's patches left out. The weight
    grad in both forms: from the volume (its call writes the patch matrix
    P first; the row's time, as the parent PRs timed it) and from the P the
    forward wrote (the train step's form, timed beside it); the two give the
    same bits, and two calls too. library_ms
    of the weight grad: torch.nn.grad.conv3d_weight on the same volume and
    cotangent (laid out as [b, dim, t, hp, wp] outside the timed call)."""
    import copy

    from ct_clip_ut_tpu_torch.ops.patch_embed import (_res_with_patches, fold_patch_embed,
                                                      patch_embed_dkw, patch_embed_dkw_plain,
                                                      patch_embed_res, patch_embed_res_plain)

    cfg = model.visual_transformer.cfg
    p, tp = cfg.patch_size, cfg.temporal_patch_size
    emb = copy.deepcopy(model.visual_transformer.to_patch_emb)
    out = {}
    with torch.no_grad():
        for ln in (emb[1], emb[3]):
            ln.weight.copy_(1.0 + 0.1 * torch.randn(ln.weight.shape, generator=g, device="cuda"))
            ln.bias.copy_(0.1 * torch.randn(ln.bias.shape, generator=g, device="cuda"))
        image = torch.randn((BATCH, *VOLUME), generator=g, device="cuda").to(torch.bfloat16)
        kw, s1, b1 = fold_patch_embed(emb, p, tp)
        library = patch_library(emb, p, tp)
        args = [image, kw, s1, b1, emb[3].weight.float(), emb[3].bias.float()]
        names = ("out", "conv", "stats")
        got = dict(zip(names, patch_embed_res(*args, p, tp)))
        want = dict(zip(names, patch_embed_res_plain(*args, p, tp)))
        torch.cuda.synchronize()
        emb[1].weight.fill_(1.0)
        kw0, s10, _ = fold_patch_embed(emb, p, tp)
        faulty = {"no LN1 gain": dict(zip(names, patch_embed_res_plain(image, kw0, s10, *args[3:],
                                                                       p, tp))),
                  "no LN2 beta": {"out": patch_embed_res_plain(
                      *args[:5], torch.zeros_like(args[5]), p, tp)[0]}}
        abs_err = grads_check("patch_embed_res", got, want, FLOAT_BAND, faulty,
                              f"{list(image.shape)} -> out, conv {list(got['conv'].shape)}, stats")
        ms = cuda_ms(torch, lambda: patch_embed_res(*args, p, tp))
        plain_ms = cuda_ms(torch, lambda: patch_embed_res_plain(*args, p, tp))
        lib_err = rel_err(library(image), want["out"])
        library_ms = library_time(torch, lambda: library(image))
        hopper_chain_check("patch_embed_res", lambda: patch_embed_res(*args, p, tp), card)
        print(f"kernel patch_embed_res: {ms:.3f} ms vs plain {plain_ms:.3f} ms, the PyTorch "
              f"chain {library_ms:.3f} ms ({library_ms.span}) (its output vs the plain out: max_rel_err "
              f"{lib_err:.3e}) [{card}]")
        m, dim = got["conv"].shape
        k = kw.shape[0] * kw.shape[1]
        out["patch_embed_res"] = dict(
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
            **bound(2 * m * k * dim, nbytes(image, *args[1:], *got.values()), BF16_PEAK),
            library_ms=library_ms)

        dconv = torch.randn((m, dim), generator=g, device="cuda").to(torch.bfloat16)
        patches = _res_with_patches(*args, p, tp)[3]
        got = patch_embed_dkw(image, dconv, p, tp, patches)
        want = patch_embed_dkw_plain(image, dconv, p, tp)
        torch.cuda.synchronize()
        if not (torch.equal(got, patch_embed_dkw(image, dconv, p, tp, patches))
                and torch.equal(got, patch_embed_dkw(image, dconv, p, tp))):
            raise AssertionError("patch_embed_dkw: two calls, or the call from the volume and "
                                 "the call from the forward's P, differ")
        half = dconv.clone()
        half[m // BATCH:] = 0
        faulty = {"wv/cin swapped": {"dkw": want.permute(1, 0, 2).reshape(want.shape)},
                  "one volume only": {"dkw": patch_embed_dkw_plain(image, half, p, tp)}}
        abs_err = grads_check("patch_embed_dkw", {"dkw": got}, {"dkw": want}, FLOAT_BAND, faulty,
                              f"{list(image.shape)}, dconv {list(dconv.shape)} -> "
                              f"{list(got.shape)} (two calls and both forms bit-equal)")
        ms = cuda_ms(torch, lambda: patch_embed_dkw(image, dconv, p, tp))
        from_p_ms = cuda_ms(torch, lambda: patch_embed_dkw(image, dconv, p, tp, patches))
        plain_ms = cuda_ms(torch, lambda: patch_embed_dkw_plain(image, dconv, p, tp))
        hopper_chain_check("patch_embed_dkw (from the volume)",
                           lambda: patch_embed_dkw(image, dconv, p, tp), card)
        b, _, T, H, W = image.shape
        go = dconv.reshape(b, T // tp, H // p, W // p, dim).permute(0, 4, 1, 2, 3).contiguous()
        lib = torch.nn.grad.conv3d_weight(image, (dim, 1, tp, p, p), go, stride=(tp, p, p))
        lib_err = rel_err(lib.reshape(dim, k // p, p).permute(2, 1, 0), want)
        library_ms = library_time(torch, lambda: torch.nn.grad.conv3d_weight(
            image, (dim, 1, tp, p, p), go, stride=(tp, p, p)))
        print(f"kernel patch_embed_dkw: {ms:.3f} ms from the volume (P written in the call; "
              f"{from_p_ms:.3f} ms from the forward's P, the train step's form) vs plain "
              f"{plain_ms:.3f} ms, "
              f"torch.nn.grad.conv3d_weight {library_ms:.3f} ms ({library_ms.span}) (vs the plain "
              f"version: "
              f"max_rel_err {lib_err:.3e}) [{card}]")
        out["patch_embed_dkw"] = dict(
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
            **bound(2 * m * k * dim, nbytes(image, dconv, got), BF16_PEAK), library_ms=library_ms)
    return out


def bert_train_check(torch, model, card: str) -> dict:
    """The bf16 BERT layer and its backward at the shapes of a B = 2,
    512-token train step: [2, 512, 768], one row padded after 300 tokens,
    LN gains drawn as 1 + 0.1 N and biases as 0.1 N, fp32 weights as the
    model holds them.

    Forward, deterministic and in train mode (p = 0.1 / 0.1), against
    bert_layer_plain through the same Philox masks. Controls: the masks of
    other seeds, the key mask dropped, LN1's gain left out; and, on the
    second residual read from the chain's own fp32 workspaces (the output's
    bf16 rounding hides it), the FF residual taken from the rounded y. The masks themselves: the kernels' generator
    bit for bit against the plain one per site, the keep share within 4
    sigma of 1 - p, two calls equal, another seed different.

    Backward: dx and the twelve parameter gradients against autograd of the
    plain forward through the same masks. Controls (a plain backward with
    one fault): masks from other seeds, the attention keep mask left out of
    dp, the post-FF keep mask left out, p_used in place of p in ds. The
    thirteen gradients the same bits on two train-mode calls; one train
    call of the forward and of the backward profiled, every launch on the
    Hopper pieces (hopper_chain_check).

    library_ms: nn.TransformerEncoderLayer (bf16, post-LN, exact GELU,
    dropout 0) with the same weights, its forward in eval mode, and forward
    + backward in train mode: yardsticks the port never calls."""
    from ct_clip_ut_tpu_torch.models.bert import layer_args
    from ct_clip_ut_tpu_torch.ops.bert_layer import (SITES, bert_layer, bert_layer_bwd,
                                                     bert_layer_bwd_plain, bert_layer_plain,
                                                     keep_mask, philox_keep)

    bcfg = model.cfg.bert
    d, heads, eps = bcfg.hidden_size, bcfg.num_heads, bcfg.layer_norm_eps
    pa, ph = bcfg.attention_dropout, bcfg.hidden_dropout
    b, n = BATCH, TEXT_LEN
    g = torch.Generator(device="cuda").manual_seed(13)
    bf = torch.bfloat16
    pad = torch.arange(n, device="cuda")[None, :] >= torch.tensor([n, 300], device="cuda")[:, None]
    mask_row = pad.float() * torch.finfo(torch.float32).min
    x = torch.randn((b, n, d), generator=g, device="cuda").to(bf)
    w = [t.detach().clone() for t in layer_args(model.text_transformer.encoder.layer[0])]
    for i in (4, 10):                                  # LN gains
        w[i] = around_ones(torch, g, d)
    for i in (5, 11):                                  # LN biases
        w[i] = 0.1 * torch.randn((d,), generator=g, device="cuda")
    f = w[6].shape[0]
    seeds = torch.tensor([20231, 77, 1 << 30], dtype=torch.int32, device="cuda")
    args = [x, mask_row, *w]
    train = dict(p_attn=pa, p_hidden=ph, train=True, seeds=seeds)
    other = {**train, "seeds": seeds + 1}
    out = {}

    with torch.no_grad():
        # the masks
        for site, name in enumerate(SITES):
            hh, inner, rate = (heads, n * n, pa) if site == 0 else (1, n * d, ph)
            got = keep_mask(seeds, site, b, hh, inner, rate)
            share = (got > 0).float().mean().item()
            sigma = (rate * (1 - rate) / got.numel()) ** 0.5
            same = torch.equal(got, philox_keep(seeds, site, b, hh, inner, rate))
            again = torch.equal(got, keep_mask(seeds, site, b, hh, inner, rate))
            moved = (got != keep_mask(seeds + 1, site, b, hh, inner, rate)).float().mean().item()
            print(f"kernel bert_layer_bf16 dropout site {name} [{b}, {hh}, {inner}] at p = {rate}: "
                  f"kernel bits == plain Philox4x32-10 bits: {same}; two calls equal: {again}; "
                  f"keep share {share:.6f} (1 - p = {1 - rate}, 4 sigma = {4 * sigma:.2e}); another "
                  f"seed changes {moved:.4f} of the mask")
            if not (same and again and abs(share - (1 - rate)) <= 4 * sigma and moved > rate):
                raise AssertionError(f"dropout site {name}: mask check failed")

        # the forward
        faults = {"no mask": (1, torch.zeros_like(mask_row)),
                  "no LN1 gain": (6, torch.ones_like(w[4]))}
        for label, kw in (("deterministic", {}), ("train", train)):
            parts, plain_parts = {}, {}
            got = bert_layer(*args, heads, eps, **kw, parts=parts)
            want = bert_layer_plain(*args, heads, eps, **kw, parts=plain_parts)
            torch.cuda.synchronize()
            controls = {}
            if kw:
                controls["other seeds"] = rel_err(got, bert_layer_plain(*args, heads, eps, **other))
            for fault, (i, value) in faults.items():
                wrong = list(args)
                wrong[i] = value
                controls[fault] = rel_err(got, bert_layer_plain(*wrong, heads, eps, **kw))
            abs_err = band_check("bert_layer_bf16", got, want, FLOAT_BAND, controls,
                                 f"{label} bf16 {list(x.shape)}")
            o2 = parts["g"].float() @ w[8].to(bf).float().t() + w[9]
            if kw:
                o2 = o2 * philox_keep(seeds, 2, b, 1, n * d, ph).reshape(b, n, d)
            y = parts["y"]
            r2_err = rel_rms(parts["r2"] - y, o2)
            r2_control = rel_rms(parts["r2"] - y + y.to(bf).float() - y, o2)
            print(f"kernel bert_layer_bf16 {label}: its second residual r2 - y vs g W2^T + b2"
                  f"{' (x keep)' if kw else ''} from its own workspaces: relative rms {r2_err:.3e} "
                  f"(band {RESIDUAL_BAND}); control (the residual taken from the rounded y) "
                  f"{r2_control:.3e}; r2 vs the plain version's {rel_rms(parts['r2'], plain_parts['r2']):.3e}")
            if not r2_err <= RESIDUAL_BAND < r2_control:
                raise AssertionError(f"bert_layer_bf16 {label}: second residual {r2_err}, band "
                                     f"{RESIDUAL_BAND}, control {r2_control}")
        if not torch.equal(got, bert_layer(*args, heads, eps, **train)):
            raise AssertionError("bert_layer_bf16: two train-mode calls with the same seeds differ")
        hopper_chain_check("bert_layer_bf16 (train)",
                           lambda: bert_layer(*args, heads, eps, **train), card)
        ms = cuda_ms(torch, lambda: bert_layer(*args, heads, eps, **train))
        det_ms = cuda_ms(torch, lambda: bert_layer(*args, heads, eps))
        plain_ms = cuda_ms(torch, lambda: bert_layer_plain(*args, heads, eps, **train))

    lib = torch.nn.TransformerEncoderLayer(d, heads, f, dropout=0.0, activation="gelu",
                                           batch_first=True, norm_first=False,
                                           layer_norm_eps=eps, device="cuda")
    lib.load_state_dict(dict(zip(
        ["self_attn.in_proj_weight", "self_attn.in_proj_bias", "self_attn.out_proj.weight",
         "self_attn.out_proj.bias", "norm1.weight", "norm1.bias", "linear1.weight",
         "linear1.bias", "linear2.weight", "linear2.bias", "norm2.weight", "norm2.bias"], w)),
        strict=True)
    lib = lib.to(bf)
    with torch.no_grad():
        lib.eval()
        lib_out = lib(x, src_key_padding_mask=pad)
        det = bert_layer_plain(*args, heads, eps)
        lib_err = rel_err(lib_out[~pad], det[~pad])
        library_ms = library_time(torch, lambda: lib(x, src_key_padding_mask=pad))
    print(f"kernel bert_layer_bf16: train {ms:.3f} ms, deterministic {det_ms:.3f} ms vs plain "
          f"(train) {plain_ms:.3f} ms, nn.TransformerEncoderLayer (bf16, eval) {library_ms:.3f} ms "
          f"({library_ms.span}) "
          f"(its real rows vs the plain version: max_rel_err {lib_err:.3e}) [{card}]")
    flops = 2 * b * n * d * (3 * d + d + 2 * f) + 4 * b * heads * n * n * (d // heads)
    wbytes = 2 * (4 * d * d + 2 * d * f) + 4 * (3 * d + d + f + 5 * d)     # bf16 matrices, fp32 vectors
    out["bert_layer_bf16"] = dict(
        max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
        **bound(flops, nbytes(x, mask_row, seeds, got) + wbytes, BF16_PEAK), library_ms=library_ms)

    # the backward
    names = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dg1", "dbe1", "dw1", "db1", "dw2", "db2",
             "dg2", "dbe2")
    dout = torch.randn((b, n, d), generator=g, device="cuda").to(bf)
    for label, kw in (("deterministic", {}), ("train", train)):
        got = dict(zip(names, bert_layer_bwd(*args, dout, heads, eps, **kw)))
        leaves = [x.clone().requires_grad_(True)] + [t.clone().requires_grad_(True) for t in w]
        bert_layer_plain(leaves[0], mask_row, *leaves[1:], heads, eps, **kw).backward(dout)
        want = dict(zip(names, (t.grad for t in leaves)))
        torch.cuda.synchronize()
        faulty = {}
        if kw:
            with torch.no_grad():
                cases = {"masks from other seeds": dict(kw=other),
                         "attention keep mask left out of dp": dict(faults=("no_attn_keep",)),
                         "post-FF keep mask left out": dict(faults=("no_hidden_keep",)),
                         "p_used for p in ds": dict(faults=("p_used_in_ds",))}
                for fault, c in cases.items():
                    faulty[fault] = dict(zip(names, bert_layer_bwd_plain(
                        *args, dout, heads, eps, **c.get("kw", kw), faults=c.get("faults", ()))))
        else:
            faulty["mask dropped"] = dict(zip(names, bert_layer_bwd_plain(
                x, torch.zeros_like(mask_row), *w, dout, heads, eps)))
        abs_err = grads_check("bert_layer_bwd", got, want, FLOAT_BAND, faulty,
                              f"{label} bf16 {list(x.shape)} vs autograd of the plain forward")
    with torch.no_grad():
        first = bert_layer_bwd(*args, dout, heads, eps, **train)
        second = bert_layer_bwd(*args, dout, heads, eps, **train)
        same = [nm for nm, x, y in zip(names, first, second) if torch.equal(x, y)]
        print(f"kernel bert_layer_bwd: two train-mode calls with the same seeds give the same bits "
              f"in {len(same)} of {len(names)} gradients (dx and the twelve parameters' sums in a "
              f"fixed order, no atomics) [{card}]")
        if len(same) != len(names):
            raise AssertionError(f"bert_layer_bwd: gradients differ between two calls: "
                                 f"{sorted(set(names) - set(same))}")
        hopper_chain_check("bert_layer_bwd (train)",
                           lambda: bert_layer_bwd(*args, dout, heads, eps, **train), card)
        ms = cuda_ms(torch, lambda: bert_layer_bwd(*args, dout, heads, eps, **train))
        plain_ms = cuda_ms(torch, lambda: bert_layer_bwd_plain(*args, dout, heads, eps, **train))
    lib.train()
    xl = x.clone().requires_grad_(True)

    def lib_step():
        lib.zero_grad(set_to_none=True)
        xl.grad = None
        lib(xl, src_key_padding_mask=pad).backward(dout)

    library_ms = library_time(torch, lib_step)
    print(f"kernel bert_layer_bwd: {ms:.3f} ms (the forward recomputed inside) vs plain "
          f"{plain_ms:.3f} ms, nn.TransformerEncoderLayer forward + backward (bf16, dropout 0) "
          f"{library_ms:.3f} ms ({library_ms.span}) [{card}]")
    flops = 6 * b * n * d * (3 * d + d + 2 * f) + 12 * b * heads * n * n * (d // heads)
    out["bert_layer_bwd"] = dict(
        max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
        **bound(flops, nbytes(x, mask_row, seeds, dout, *got.values()) + wbytes, BF16_PEAK),
        library_ms=library_ms)
    return out


def peg_check(torch, model, card: str) -> dict:
    """The PEG stencil and its weight gradient on the token video of a B = 2
    step, [2, 24, 24, 24, 512] bf16, with layer 0's Conv3d taps and a bias
    drawn as 0.2 N. The stencil on its branch (output minus residual), in
    the causal forward form (front padding 2, bias) and the input
    gradient's form (front padding 0, flipped taps, no bias). Controls: the
    frame padding (1, 1) for (2, 0), the bias left out; the taps unflipped
    in the backward form. The weight gradient's controls: x shifted by one
    frame, the non-causal padding. The stencil's ms is the forward form's;
    the input gradient's form is timed beside it. library_ms: what the
    default route runs, the NCDHW copy + F.conv3d + bias + residual + copy
    back (peg_residual), and torch.nn.grad.conv3d_weight on NCDHW copies
    made outside the timed call."""
    import torch.nn.functional as F

    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.layers import peg_residual
    from ct_clip_ut_tpu_torch.ops.peg import (peg, peg_plain, peg_weight_grads,
                                              peg_weight_grads_plain, taps_of)

    vit = model.visual_transformer
    t, h, w = token_grid_shape(vit.cfg, VOLUME)
    c = vit.cfg.dim
    g = torch.Generator(device="cuda").manual_seed(17)
    bf = torch.bfloat16
    x = torch.randn((BATCH, t, h, w, c), generator=g, device="cuda").to(bf)
    gr = torch.randn((BATCH, t, h, w, c), generator=g, device="cuda").to(bf)
    weight = vit.enc_spatial_transformer.layers[0][0].dsconv.weight.detach()
    taps = taps_of(weight)
    flipped = taps.flip(0).contiguous()
    bias = 0.2 * torch.randn((c,), generator=g, device="cuda")
    out = {}
    with torch.no_grad():
        def branch(y, base):
            return y.float() - base.float()

        got = branch(peg(x, taps, bias, 2), x)
        want = branch(peg_plain(x, taps, bias, 2), x)
        torch.cuda.synchronize()
        controls = {"frame padding (1, 1)": rel_err(got, branch(peg_plain(x, taps, bias, 1), x)),
                    "no bias": rel_err(got, branch(peg_plain(x, taps, None, 2), x))}
        abs_err = band_check("peg", got, want, FLOAT_BAND, controls,
                             f"causal forward {list(x.shape)} bf16, branch max "
                             f"{want.abs().max().item():.3e}")
        got = branch(peg(gr, flipped, None, 0), gr)
        want = branch(peg_plain(gr, flipped, None, 0), gr)
        controls = {"taps unflipped": rel_err(got, branch(peg_plain(gr, taps, None, 0), gr)),
                    "frame padding (2, 0)": rel_err(got, branch(peg_plain(gr, flipped, None, 2), gr))}
        abs_err = max(abs_err, band_check("peg", got, want, FLOAT_BAND, controls,
                                          "input-gradient form (front 0, flipped taps, no bias)"))
        tokens = x.reshape(BATCH, t * h * w, c)
        lib_err = rel_err(peg_residual(weight, bias, tokens, (BATCH, t, h, w), True),
                          peg_plain(x, taps, bias, 2).reshape(tokens.shape))
        ms = cuda_ms(torch, lambda: peg(x, taps, bias, 2))
        back_ms = cuda_ms(torch, lambda: peg(gr, flipped, None, 0))
        plain_ms = cuda_ms(torch, lambda: peg_plain(x, taps, bias, 2))
        library_ms = library_time(torch, lambda: peg_residual(weight, bias, tokens,
                                                         (BATCH, t, h, w), True))
        print(f"kernel peg: {ms:.3f} ms (the input-gradient form {back_ms:.3f} ms) vs plain "
              f"{plain_ms:.3f} ms, the default route (NCDHW copy "
              f"+ F.conv3d + copy back) {library_ms:.3f} ms ({library_ms.span}) (vs the plain "
              f"version, with its "
              f"residual: max_rel_err {lib_err:.3e}) [{card}]")
        npos = x.numel() // c
        out["peg"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                          **bound(2 * 27 * npos * c, nbytes(x, taps, bias, x), FP32_PEAK),
                          library_ms=library_ms)

        names = ("dw", "db")
        got = dict(zip(names, peg_weight_grads(x, gr, 2)))
        want = dict(zip(names, peg_weight_grads_plain(x, gr, 2)))
        torch.cuda.synchronize()
        again = peg_weight_grads(x, gr, 2)
        if not (torch.equal(got["dw"], again[0]) and torch.equal(got["db"], again[1])):
            raise AssertionError("peg_weight_grads: two calls on the same inputs differ")
        faulty = {"x shifted by one frame": {"dw": peg_weight_grads_plain(x.roll(1, 1), gr, 2)[0]},
                  "frame padding (1, 1)": {"dw": peg_weight_grads_plain(x, gr, 1)[0]}}
        abs_err = grads_check("peg_weight_grads", got, want, PEG_WGRAD_BAND, faulty,
                              f"{list(x.shape)} bf16 -> dw {list(got['dw'].shape)}, db (fp32 sums; "
                              "two calls bit-equal)")
        ms = cuda_ms(torch, lambda: peg_weight_grads(x, gr, 2))
        plain_ms = cuda_ms(torch, lambda: peg_weight_grads_plain(x, gr, 2))
        xc = F.pad(x.permute(0, 4, 1, 2, 3), (1, 1, 1, 1, 2, 0)).contiguous()
        gc = gr.permute(0, 4, 1, 2, 3).contiguous()
        lib = torch.nn.grad.conv3d_weight(xc, (c, 1, 3, 3, 3), gc, groups=c)
        lib_err = rel_err(lib, want["dw"])
        library_ms = library_time(torch, lambda: torch.nn.grad.conv3d_weight(xc, (c, 1, 3, 3, 3), gc,
                                                                         groups=c))
        print(f"kernel peg_weight_grads: {ms:.3f} ms vs plain {plain_ms:.3f} ms, "
              f"torch.nn.grad.conv3d_weight {library_ms:.3f} ms ({library_ms.span}) (vs the plain "
              f"version: max_rel_err "
              f"{lib_err:.3e}) [{card}]")
        out["peg_weight_grads"] = dict(
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
            **bound(2 * 28 * npos * c, nbytes(x, gr, *got.values()), FP32_PEAK),
            library_ms=library_ms)
    return out


def param_group(name: str) -> str:
    """The parameter group of a CTCLIP parameter, for the gradient check."""
    import re

    if name.startswith("text_transformer"):
        return "text tower"
    if "to_patch_emb" in name:
        return "patch embed"
    if "spatial_rel_pos_bias" in name:
        return "CPB MLP"
    hit = re.match(r"visual_transformer\.enc_(spatial|temporal)_transformer\.layers\.\d+\.(\d)\.",
                   name)
    if hit:
        return f"{hit[1]} " + {"0": "PEG", "1": "attention", "3": "FF"}[hit[2]]
    if "norm_out" in name:
        return "norm_out"
    return "latents + temperature"


REPORT_WORDS = ("the lungs are clear without consolidation effusion or nodule heart size is normal "
                "mild emphysema and atelectasis in the lower lobes no lymphadenopathy").split()


def train_batches(torch, g, count: int, words: int, dtype=None) -> list:
    """`count` batches of BATCH volumes (bf16 unless `dtype` says otherwise)
    and stand-in reports of about `words` words (one token a word)."""
    def texts(i):
        return [" ".join(REPORT_WORDS[(i * 5 + j * 3 + k) % len(REPORT_WORDS)]
                         for k in range(words + 9 * j)) for j in range(BATCH)]

    dtype = dtype or torch.bfloat16
    return [(torch.randn((BATCH, *VOLUME), generator=g, device="cuda", dtype=dtype),
             texts(i)) for i in range(count)]


def earlier_train_phase(torch, model, card: str) -> dict:
    """The earlier train path: 120-token reports (under the fused BERT
    layer's gate, so BERT trains on its layer loop) and the PEG on F.conv3d
    and autograd. Two steps of make_train_step and one evaluation; its
    kernels must launch and this slice's must not. Returns the launch counts."""
    from ct_clip_ut_tpu_torch.config import TrainConfig
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.train.trainer import (create_train_state, make_eval_step,
                                                    make_train_step)

    cfg = model.cfg
    tcfg = TrainConfig(text_max_length=EARLIER_TEXT_LEN)
    g = torch.Generator(device="cuda").manual_seed(2)
    image, texts = train_batches(torch, g, 1, 40)[0]
    enc = WordTokenizer(cfg.bert.vocab_size)(texts, max_length=EARLIER_TEXT_LEN)
    text = {k: torch.as_tensor(v, device="cuda") for k, v in enc.items()}
    state = create_train_state(cfg, tcfg, params=model, device="cuda")
    step, eval_step = make_train_step(cfg, tcfg), make_eval_step(cfg, tcfg)
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step(state, image, text) for _ in range(2)] + [eval_step(state.model, image, text)]
    losses = [v.item() for v in losses]
    seconds = time.perf_counter() - t0
    counts = launches.launch_counts()
    print(f"earlier train path: 2 steps of make_train_step and 1 evaluation at B = {BATCH}, "
          f"{EARLIER_TEXT_LEN}-token reports, peg_pallas=False in {seconds:.3f} s (host clock, "
          f"first calls) [{card}]; losses {losses}; launches {json.dumps(counts)}")
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise AssertionError(f"non-finite losses on the earlier train path: {losses}")
    missing = [k for k, v in counts.items() if v <= 0 and k not in BERT_PEG_KERNELS
               and k not in ("bert_layer", *SERVING_KERNELS)]
    stray = [k for k in (*BERT_PEG_KERNELS, "bert_layer") if counts[k] != 0]
    if missing or stray:
        raise AssertionError(f"earlier train path: kernels not launched {missing}, kernels of "
                             f"another path launched {stray}")
    return counts


def train_phase(torch, model, card: str) -> dict:
    """The train path as users run it, at flagship width: 512-token reports
    through the fused BERT layer (bf16, Philox dropout, backward kernel) and
    the PEG through its stencil and weight-grad kernels (`model` is built
    with peg_pallas=True); returns the train run's launch counts."""
    import tempfile

    from ct_clip_ut_tpu_torch.config import TrainConfig
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.models.ctclip import contrastive_loss, ctclip_apply
    from ct_clip_ut_tpu_torch.train.trainer import CTClipTrainer

    cfg = model.cfg
    if not cfg.ctvit.peg_pallas:
        raise AssertionError("the train phase runs the peg_pallas=True configuration")
    tcfg = TrainConfig(num_epochs=1)
    if tcfg.text_max_length != TEXT_LEN or tcfg.compute_dtype != "bfloat16":
        raise AssertionError("the train phase runs the TrainConfig defaults: 512 tokens, bf16")
    g = torch.Generator(device="cuda").manual_seed(3)
    tok = WordTokenizer(cfg.bert.vocab_size)
    data = train_batches(torch, g, 4, 300)

    def tokens(texts):
        enc = tok(texts, max_length=TEXT_LEN)
        return {k: torch.as_tensor(v, device="cuda") for k, v in enc.items()}

    # one step's gradients, kernels vs the plain path, from the same weights,
    # inputs and dropout masks; the control is the plain gradient of another batch
    def grads(i, plain):
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(5)
        out = ctclip_apply(model, tokens(data[i][1]), data[i][0], freeze_vq=False,
                           generator=gen, deterministic=False, plain=plain)
        loss = contrastive_loss(out.sim_matrix)
        loss.backward()
        by_group = {}
        for name, prm in model.named_parameters():
            if prm.grad is not None:
                by_group.setdefault(param_group(name), []).append(
                    prm.grad.detach().float().flatten())
        model.zero_grad(set_to_none=True)
        return (loss.item(), out.image_latents.detach().float(), out.image_tokens.detach(),
                {k: torch.cat(v) for k, v in by_group.items()})

    loss_k, lat_k, tok_k, gk = grads(0, False)
    loss_p, lat_p, tok_p, gp = grads(0, True)
    gc = grads(1, True)[3]
    cos = torch.nn.functional.cosine_similarity(lat_k, lat_p, dim=-1)
    # a token whose code matches keeps the same row up to the straight-through
    # form's bf16 rounding (~1e-2); a flipped code moves it by ~1
    same = ((tok_k.float() - tok_p.float()).abs().amax(-1) < 0.1).float().mean().item()
    errs = {k: ((gk[k] - gp[k]).norm() / gp[k].norm()).item() for k in gp}
    ctrl = {k: ((gc[k] - gp[k]).norm() / gp[k].norm()).item() for k in gp}
    bands = {k: LATENT_GRAD_BAND if k in ("text tower", "latents + temperature") else GRAD_BAND
             for k in gp}
    real = tokens(data[0][1])["attention_mask"].sum(1).tolist()
    print(f"train: reports of {real} real tokens padded to {TEXT_LEN}, peg_pallas=True")
    print(f"train: one step's loss {loss_k:.6f} (plain path {loss_p:.6f}); image latents vs the "
          f"plain path 1 - cos {(1 - cos).max().item():.3e}, {same:.6f} of quantised tokens on "
          f"the same code; "
          f"gradients vs the plain path, relative rms per group (band {GRAD_BAND}, "
          f"{LATENT_GRAD_BAND} downstream of the latents): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + "; controls (another batch): "
          + ", ".join(f"{k} {v:.3e}" for k, v in ctrl.items()) + f" [{card}]")
    if set(gk) != set(gp) or not all(torch.isfinite(v).all() for v in gk.values()):
        raise AssertionError("kernel-path gradients missing or non-finite")
    bad = {k: v for k, v in errs.items() if not v <= bands[k]}
    blind = {k: v for k, v in ctrl.items() if not v > bands[k]}
    if bad or blind:
        raise AssertionError(f"train gradients: over the band {bad}, controls within it {blind}")

    # CTClipTrainer.train(): 3 steps, the step-0 evaluation, a checkpoint
    vq = model.visual_transformer.vq._codebook
    cs0 = vq.cluster_size.sum().item()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = CTClipTrainer(cfg, tcfg, tok, data[:3], data[3:], results_folder=tmp,
                                params=model, device="cuda")
        launches.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launches.launch_counts()
        saved = sorted(p.name for p in trainer.results_folder.iterdir())
    losses = trainer.train_losses["epochs"] + trainer.valid_losses
    print(f"train: CTClipTrainer.train() over 3 steps of {BATCH} x {list(VOLUME)} bf16 volumes "
          f"with {TEXT_LEN}-token reports, peg_pallas=True, the step-0 and end-of-epoch evaluations "
          f"and a checkpoint in "
          f"{seconds:.3f} s (host clock) [{card}]; epoch losses {trainer.train_losses['epochs']}, "
          f"validation {trainer.valid_losses}; files {saved}; launches {json.dumps(counts)}")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise AssertionError(f"non-finite train losses {losses}")
    missing = [k for k, v in counts.items() if v <= 0 and k not in ("bert_layer",
                                                                      *SERVING_KERNELS)]
    if missing:
        raise AssertionError(f"kernels not launched on the train path: {missing}")
    layers, pegs = cfg.bert.num_layers, cfg.ctvit.spatial_depth + cfg.ctvit.temporal_depth
    evals = len(trainer.valid_losses)
    want_counts = {"bert_layer_bf16": (3 + evals) * layers, "bert_layer_bwd": 3 * layers,
                   "peg": (2 * 3 + evals) * pegs, "peg_weight_grads": 3 * pegs}
    got_counts = {k: counts[k] for k in want_counts}
    if got_counts != want_counts:
        raise AssertionError(f"train path launches {got_counts}, expected {want_counts} (3 steps "
                             f"forward and backward, {evals} evaluations)")
    t, h, w = (s // d for s, d in zip(VOLUME[1:], (cfg.ctvit.temporal_patch_size,
                                                   cfg.ctvit.patch_size, cfg.ctvit.patch_size)))
    grow = BATCH * t * h * w
    decay = cfg.ctvit.vq_decay
    want_cs = cs0 * decay ** 3 + grow * (1 - decay ** 3)
    cs = vq.cluster_size.sum().item()
    print(f"train: VQ cluster sizes sum {cs:.3f} after 3 EMA steps (expected "
          f"{want_cs:.3f} = {cs0:.3f} decay^3 + {grow} (1 - {decay}^3))")
    if abs(cs - want_cs) > 1e-3 * want_cs:
        raise AssertionError(f"VQ cluster size sum {cs}, expected {want_cs}")

    # three more steps, each synchronised
    state, step = trainer.state, trainer.train_step
    image, text = data[0][0], tokens(data[0][1])
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = step(state, image, text)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    print(f"train: make_train_step at B = {BATCH}: {', '.join(f'{v:.3f}' for v in ms)} ms per "
          f"step (host clock, synchronised; loss {loss.item():.6f}); peak memory of these steps "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{card}]")
    return counts


def qrows_check(torch, model, card: str, g) -> dict:
    """attn_qrows against its plain version at MaskGit's shapes (x [B, 6464,
    512] for B = 1 and 2, layer 0's weights with gains drawn around their
    ones, the bf16 CPB table of the 101 x 8 x 8 grid), with the controls; the
    record holds B = 2, the batched forward's shape. library_ms: LN, the q
    and kv projections, F.normalize, F.scaled_dot_product_attention with the
    bias as its additive mask (scale 1: q already carries the scale), the
    output projection, and the residual: one PyTorch call for the core."""
    import torch.nn.functional as F

    from ct_clip_ut_tpu_torch.models.ctgenerate import maskgit_bias_table
    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.attn_qrows import attn_qrows, attn_qrows_plain

    cfg = model.cfg
    grid = token_grid_shape(cfg.ctvit, (1, *CTGEN_SCAN))
    n = grid[0] * grid[1] * grid[2]
    bias = maskgit_bias_table(model, grid, dtype="bfloat16")
    w = block_args(torch, g, model.maskgit.transformer)
    scale = model.maskgit.transformer.layers[0][1].cfg.scale
    heads, dh = cfg.maskgit.heads, cfg.maskgit.dim_head
    out = {}
    for b in (1, 2):
        x = torch.randn((b, n, cfg.maskgit.dim), generator=g, device="cuda").to(torch.bfloat16)
        args = [x, *w, bias]
        got = attn_qrows(*args, scale, False)
        want = attn_qrows_plain(*args, scale, False)
        torch.cuda.synchronize()
        no_qs = list(args)
        no_qs[6] = torch.ones_like(args[6])
        controls = {"no bias": rel_err(got, attn_qrows_plain(*args[:8], None, scale, False)),
                    "k from LN(x)": rel_err(got, attn_qrows_plain(*args, scale, False,
                                                                  faults=("k_from_ln",))),
                    "no q_scale": rel_err(got, attn_qrows_plain(*no_qs, scale, False)),
                    "p unnormalised": rel_err(got, attn_qrows_plain(*args, scale, False,
                                                                    faults=("unnormalised",)))}
        abs_err = band_check("attn_qrows", got, want, FLOAT_BAND, controls,
                             f"x {list(x.shape)}, bias {list(bias.shape)} bf16, branch max "
                             f"{want.float().abs().max().item():.3e}")
        ms = cuda_ms(torch, lambda: attn_qrows(*args, scale, True))
        plain_ms = cuda_ms(torch, lambda: attn_qrows_plain(*args, scale, True), iters=3)
        gamma, wq, wk, wv, wo, qs, ks = w
        wkv = torch.cat([wk, wv])

        def library():   # the branch; timed with the residual add
            xn = F.layer_norm(x.float(), (x.shape[-1],), gamma).to(x.dtype)
            q = (xn @ wq.t()).view(b, n, heads, dh).transpose(1, 2)
            k, v = (x @ wkv.t()).view(b, n, 2, heads, dh).permute(2, 0, 3, 1, 4)
            q = (F.normalize(q.float(), dim=-1) * (qs * scale)).to(x.dtype)
            k = (F.normalize(k.float(), dim=-1) * ks).to(x.dtype)
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias[None], scale=1.0)
            return o.transpose(1, 2).reshape(b, n, heads * dh) @ wo.t()

        lib_err = rel_err(library(), want)
        library_ms = library_time(torch, lambda: library() + x)
        hd = heads * dh
        flops = 2 * b * (4 * n * x.shape[-1] * hd + heads * 2 * n * n * dh)
        rec = bound(flops, nbytes(x, *w, bias, got), BF16_PEAK)
        floor_ms = 1e3 * 2 * nbytes(bias) / HBM_RATE     # the two passes read the table twice
        print(f"kernel attn_qrows B={b}: {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), two-pass floor of bias bytes "
              f"{floor_ms:.4f} ms, SDPA yardstick {library_ms:.3f} ms ({library_ms.span}) "
              f"(max_rel_err "
              f"{lib_err:.3e} vs the plain branch) [{card}]")
        out = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **rec, library_ms=library_ms)
    return out


def ctgenerate_phase(torch, card: str) -> tuple:
    """CTGenerate's localisation and generation paths at CTGenerateConfig();
    returns (the attn_qrows record, the localisation run's launch counts)."""
    import numpy as np

    from ct_clip_ut_tpu_torch.config import PATHOLOGIES, CTGenerateConfig
    from ct_clip_ut_tpu_torch.infer.profile_ctgenerate import reports
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
    from ct_clip_ut_tpu_torch.models.ctgenerate import (ctgenerate_apply_batched,
                                                        init_ctgenerate)
    from ct_clip_ut_tpu_torch.models.ctvit import ctvit_apply
    from ct_clip_ut_tpu_torch.models.maskgit import maskgit_apply
    from ct_clip_ut_tpu_torch.models.t5 import T5TextConditioner
    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.scripts.inference_ctgenerate import generate, localize

    cfg = CTGenerateConfig()
    model = init_ctgenerate(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(9)
    record = qrows_check(torch, model, card, g)

    t5 = T5TextConditioner(model.t5, WordTokenizer(cfg.t5.vocab_size))
    b = BATCH
    # reports of 120 and SHORT_REPORT words: the text mask pads the short one
    texts = [r if i % 2 == 0 else " ".join(r.split()[:SHORT_REPORT])
             for i, r in enumerate(reports(b))]
    data = [(torch.randn((b, *CTGEN_SCAN), generator=g, device="cuda", dtype=torch.bfloat16),
             texts) for _ in range(CTGEN_BATCHES)]
    cache = {}
    localize(model, t5, *data[0], bias_cache=cache)                  # warm-up, builds the table
    torch.cuda.synchronize()
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    maps = [m for scans, texts in data for m in localize(model, t5, scans, texts,
                                                          bias_cache=cache)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches.launch_counts()
    print(f"ctgenerate: localize() over {CTGEN_BATCHES} x {b} bf16 scans "
          f"{[b, *CTGEN_SCAN]} with stand-in reports in {seconds:.3f} s (smoke reading, host "
          f"clock) [{card}]; {sum(len(m) for m in maps)} heatmaps; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    short = {k: counts[k] for k, per in CTGEN_KERNELS.items()
             if counts[k] < per * CTGEN_BATCHES}
    if short:
        raise AssertionError(f"kernels launched fewer times than the path needs: {short}")
    for heat in (v for m in maps for v in m.values()):
        if heat.shape != CTGEN_SCAN[1:] or not (np.isfinite(heat).all() and heat.min() >= 0
                                                  and heat.max() <= 1 + 1e-6):
            raise AssertionError(f"bad heatmap: shape {heat.shape}, range "
                                 f"[{heat.min()}, {heat.max()}]")
    if not all(maps):
        raise AssertionError("a report matched no pathology")

    # batch 0 against plain=True: MaskGit from the kernel path's ids, then end to end.
    # Controls: the batch's other scan, and plain MaskGit from the same ids with one
    # fault each: the CPB table left out, the text mask left out.
    scans, texts = data[0]
    emb, mask = t5.encode(texts)
    with torch.no_grad():
        out = ctgenerate_apply_batched(model, scans, emb, mask, bias_cache=cache)
        plain = ctgenerate_apply_batched(model, scans, emb, mask, bias_cache=cache, plain=True)
        fp32_ids = ctvit_apply(model.ctvit, scans.float(), plain=True).codebook_ids
        ids = out.codebook_ids.reshape(b, -1)
        table = cache[(*out.video_patch_shape, "bfloat16")]

        def plain_maskgit(bias, text_mask):
            r = maskgit_apply(model.maskgit, ids, emb, out.video_patch_shape,
                              text_mask=text_mask, return_embeds=True, weights="last_cross",
                              self_attn_block=64, precomputed_bias=(bias, None),
                              compute_dtype="bfloat16", plain=True)
            return r.output.float(), r.cross_attn[-1][..., 2:]

        same_feat, same_cross = plain_maskgit(table, mask)
        faults = {"no CPB table": plain_maskgit(None, mask),
                  "no text mask": plain_maskgit(table, None)}
    feat, cross = out.feature_map.float(), out.cross_attention
    plain_feat, plain_cross = plain.feature_map.float(), plain.cross_attention

    def cross_err(got, want):
        return (got - want).abs().max().item()

    checks = [("same ids: feature map, relative rms", rel_rms, feat, same_feat, FEATURE_BAND,
               (same_feat[1], same_feat[0]), 0),
              ("same ids: cross-attention, max abs", cross_err, cross, same_cross, CROSS_BAND,
               (same_cross[1], same_cross[0]), 1),
              ("end to end: feature map, relative rms", rel_rms, feat, plain_feat,
               E2E_FEATURE_BAND, (plain_feat[1], plain_feat[0]), 0),
              ("end to end: cross-attention, max abs", cross_err, cross, plain_cross,
               E2E_CROSS_BAND, (plain_cross[1], plain_cross[0]), 1)]
    agree = (out.codebook_ids == plain.codebook_ids).float().mean().item()
    agree32 = (out.codebook_ids == fp32_ids).float().mean().item()
    print(f"ctgenerate: codebook ids equal to the plain bf16 tokenizer's: {agree:.6f}; to the "
          f"plain fp32 tokenizer's on the same scans (the JAX script's one-scan route): "
          f"{agree32:.6f}")
    for name, dist, got, want, band, other, part in checks:
        err = dist(got, want)
        controls = {"scan 0 vs 1": dist(*other),
                    **{k: dist(f[part], want) for k, f in faults.items()}}
        print(f"ctgenerate: {name} vs plain=True {err:.3e} (band {band}); controls "
              f"{json.dumps({k: float(f'{v:.3e}') for k, v in controls.items()})}")
        if not (math.isfinite(err) and err <= band < min(controls.values())):
            raise AssertionError(f"ctgenerate {name}: {err}, band {band}, controls {controls}")
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    grid_ids = generate(model, t5, ["mild emphysema in the lower lobes"], CTGEN_SCAN[1],
                        GENERATE_STEPS, 1.0, 0)
    seconds = time.perf_counter() - t0
    gen_counts = {k: v for k, v in launches.launch_counts().items() if v}
    print(f"ctgenerate: maskgit_generate B=1, {GENERATE_STEPS} steps, grid "
          f"{list(grid_ids.shape)} in {seconds:.3f} s (host clock) [{card}]; "
          f"{len(np.unique(grid_ids))} distinct ids; launches {json.dumps(gen_counts)}")
    if gen_counts.get("attn_qrows") != GENERATE_STEPS * cfg.maskgit.depth:
        raise AssertionError(f"generate launched attn_qrows {gen_counts.get('attn_qrows')} times")
    if grid_ids.shape != (1, 101, 8, 8) or grid_ids.min() < 0 or \
            grid_ids.max() >= cfg.maskgit.num_tokens:
        raise AssertionError(f"bad generated grid: {grid_ids.shape}, "
                             f"[{grid_ids.min()}, {grid_ids.max()}]")
    return record, counts


def f32_check(torch, model, card: str) -> dict:
    """Phase 10's kernel checks: the fp32 variants of rows 1-4 against their
    plain versions at the attribution path's shapes (TF32 off): attn_block
    over one volume's spatial stack [24, 576, 512] with the fp32 [8, 576,
    576] bias, attn_packed over a chunk of 8 windows' temporal stacks
    [4608, 24, 512], geglu_ff over the same chunk's temporal tokens [110592,
    512], vq_nearest on [13824, 512] unit tokens x the 8192 codes. Bands:
    F32_BAND (max relative error), the VQ's share of equal indices and tie
    margin; a second call gives the same bits. Controls: the kernel with
    every lo plane zeroed (one bf16 product for each fp32 one), and the
    plain version without the LN gain / bias, the q scale or the position
    bias. bound_ms: three bf16 products for each fp32 one at the bf16 peak,
    as row 6. library_ms: the same PyTorch chain in fp32. Then geglu_ff's
    times at the sweep's other shapes (its largest frame-sparse slice,
    [46080, 512], and a slab's clean stack, [13824, 512]). One call of each
    under torch.profiler, every launch on the Hopper pieces: the products
    on split4_kernel, attn_packed's core the whole-item one
    (F32_FORWARD)."""
    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.attn_block import attn_block, attn_block_plain, launch_block_f32
    from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed, attn_packed_plain
    from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff, geglu_ff_f32, geglu_ff_plain
    from ct_clip_ut_tpu_torch.ops.layers import l2norm
    from ct_clip_ut_tpu_torch.ops.posbias import continuous_pos_bias
    from ct_clip_ut_tpu_torch.ops.vq_nearest import vq_nearest, vq_nearest_f32, vq_nearest_plain

    vit = model.visual_transformer
    cfg = vit.cfg
    g = torch.Generator(device="cuda").manual_seed(15)
    t, h, w = token_grid_shape(cfg, VOLUME)
    hw, d = h * w, cfg.dim

    def attn_args(tf):
        a = tf.layers[0][1]
        inner = a.cfg.inner_dim
        wkv = a.to_kv.weight.float()
        return [around_ones(torch, g, d), a.to_q.weight.float(), wkv[:inner].contiguous(),
                wkv[inner:].contiguous(), a.to_out.weight.float(),
                around_ones(torch, g, a.cfg.dim_head), around_ones(torch, g, a.cfg.dim_head)]

    with torch.no_grad():
        bias = continuous_pos_bias(vit.spatial_rel_pos_bias, cfg.patch_height,
                                   cfg.patch_width).float().contiguous()
    scale = vit.enc_spatial_transformer.layers[0][1].cfg.scale
    xs = torch.randn((t, hw, d), generator=g, device="cuda")
    xt = torch.randn((OCC_CHUNK * hw, t, d), generator=g, device="cuda")
    xf = torch.randn((OCC_CHUNK * t * hw, d), generator=g, device="cuda")
    ff = vit.enc_spatial_transformer.layers[0][3]
    attn_faults = {"no gamma": (1, 1.0), "no q_scale": (6, 1.0)}

    def packed_library(*a, residual=True):
        return attn_library(*a[:8], None, *a[8:], residual=residual)

    def attn_flops(x, hd):
        r, n, dm = x.shape
        return 3 * (2 * r * n * dm * hd * 4 + 4 * r * n * n * hd)

    cases = {
        "attn_block_f32": (attn_block, attn_block_plain,
                           [xs, *attn_args(vit.enc_spatial_transformer), bias, scale],
                           {**attn_faults, "no bias": (8, 0.0)}, attn_library,
                           lambda *a, residual: launch_block_f32("ctc_attn_block_f32", *a,
                                                                 residual, one_pass=True)),
        "attn_packed_f32": (attn_packed, attn_packed_plain,
                            [xt, *attn_args(vit.enc_temporal_transformer), scale], attn_faults,
                            packed_library,
                            lambda *a, residual: launch_block_f32(
                                "ctc_attn_packed_f32", *a[:8], None, *a[8:], residual,
                                one_pass=True)),
        "geglu_ff_f32": (geglu_ff, geglu_ff_plain,
                         [xf, around_ones(torch, g, d),
                          0.1 * torch.randn((d,), generator=g, device="cuda"),
                          ff[1].weight.float(), ff[4].weight.float()],
                         {"no gamma": (1, 1.0), "no beta": (2, 0.0)}, ff_library,
                         lambda *a, residual: geglu_ff_f32(*a, residual, one_pass=True)),
    }
    out = {}
    with torch.no_grad():
        for name, (kern, plain, args, faults, library, one_pass) in cases.items():
            got = kern(*args, residual=False)
            want = plain(*args, residual=False)
            same = torch.equal(kern(*args, residual=False), got)
            torch.cuda.synchronize()
            if not same:
                raise AssertionError(f"{name}: two calls gave different bits")
            controls = {"one bf16 product each (lo planes zeroed)":
                        rel_err(one_pass(*args, residual=False), want)}
            for fault, (i, value) in faults.items():
                wrong = list(args)
                wrong[i] = torch.full_like(args[i], value)
                controls[fault] = rel_err(got, plain(*wrong, residual=False))
            if got.dtype != torch.float32:
                raise AssertionError(f"{name}: output dtype {got.dtype}")
            abs_err = band_check(name, got, want, F32_BAND, controls,
                                 f"fp32 x {list(args[0].shape)}, branch max "
                                 f"{want.abs().max().item():.3e}")
            ms = cuda_ms(torch, lambda: kern(*args, residual=True))
            plain_ms = cuda_ms(torch, lambda: plain(*args, residual=True))
            lib_err = rel_err(library(*args, residual=False), want)
            library_ms = library_time(torch, lambda: library(*args, residual=True))
            x = args[0]
            if name == "geglu_ff_f32":
                flops = 3 * 6 * x.shape[0] * x.shape[1] * args[4].shape[1]
            else:
                flops = attn_flops(x, args[2].shape[0])
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            rec = bound(flops, nbytes(*tensors, got), BF16_PEAK)
            print(f"kernel {name}: {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, three bf16 products each), the "
                  f"PyTorch chain in fp32 {library_ms:.3f} ms ({library_ms.span}) (max_rel_err "
                  f"{lib_err:.3e} vs the plain version); a second call the same bits [{card}]")
            out[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **rec,
                             library_ms=library_ms)
            hopper_chain_check(name, lambda: kern(*args, residual=True), card, **F32_FORWARD[name])

        # geglu_ff at the sweep's other shapes: its largest frame-sparse
        # slice (8 windows x 10 frames) and a slab's clean stack
        ff_args = cases["geglu_ff_f32"][2][1:]
        for rows in (OCC_CHUNK * 10 * hw, t * hw):
            x = torch.randn((rows, d), generator=g, device="cuda")
            err = rel_err(geglu_ff(x, *ff_args, residual=True),
                          geglu_ff_plain(x, *ff_args, residual=True))
            ms = cuda_ms(torch, lambda: geglu_ff(x, *ff_args, residual=True))
            rec = bound(3 * 6 * rows * d * ff_args[3].shape[1],
                        nbytes(x, x, *[a for a in ff_args if isinstance(a, torch.Tensor)]),
                        BF16_PEAK)
            print(f"kernel geglu_ff_f32 at [{rows}, {d}]: {ms:.3f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), max_rel_err {err:.3e} vs plain "
                  f"(band {F32_BAND}) [{card}]")
            if not err <= F32_BAND:
                raise AssertionError(f"geglu_ff_f32 at {rows} rows: {err}")

        tok = l2norm(torch.randn((t * hw, d), generator=g, device="cuda"))
        cb = vit.vq.state().embed.float().contiguous()
        got, want = vq_nearest(tok, cb).long(), vq_nearest_plain(tok, cb).long()
        one = vq_nearest_f32(tok, cb, one_pass=True).long()
        torch.cuda.synchronize()
        agree = (got == want).float().mean().item()
        one_agree = (one == want).float().mean().item()
        bad = (got != want).nonzero().flatten()
        gap = 0.0
        if bad.numel():
            sims = tok[bad].double() @ cb.double().t()
            gap = (sims.gather(1, got[bad, None]) - sims.gather(1, want[bad, None])).abs().max().item()
        ms = cuda_ms(torch, lambda: vq_nearest(tok, cb))
        plain_ms = cuda_ms(torch, lambda: vq_nearest_plain(tok, cb))
        lib_agree = ((tok @ cb.t()).argmax(-1) == want).float().mean().item()
        library_ms = library_time(torch, lambda: (tok @ cb.t()).argmax(-1))
        rec = bound(3 * 2 * tok.shape[0] * cb.shape[0] * d, nbytes(tok, cb) + 4 * tok.shape[0],
                    BF16_PEAK)
        print(f"kernel vq_nearest_f32 fp32 {list(tok.shape)} x {list(cb.shape)}: {agree:.6f} of "
              f"indices equal the plain version's (band {VQ_F32_AGREE}), {bad.numel()} "
              f"mismatches, largest fp64 sim gap {gap:.3e} (band {VQ_F32_TIE}); control (one bf16 "
              f"product, lo planes zeroed) {one_agree:.6f} equal; {ms:.3f} ms vs plain "
              f"{plain_ms:.3f} ms, bound {rec['bound_ms']:.4f} ms (three bf16 products), fp32 tok "
              f"@ cb.t() + argmax {library_ms:.3f} ms ({library_ms.span}) ({lib_agree:.6f} of its "
              f"indices equal) [{card}]")
        if agree < VQ_F32_AGREE or gap > VQ_F32_TIE or not one_agree < VQ_F32_AGREE:
            raise AssertionError(f"vq_nearest_f32: agreement {agree}, tie gap {gap}, control "
                                 f"{one_agree}")
        out["vq_nearest_f32"] = dict(max_abs_err=gap, ms=ms, plain_ms=plain_ms, **rec,
                                     library_ms=library_ms)
        hopper_chain_check("vq_nearest_f32", lambda: vq_nearest(tok, cb), card)
    return out


def peg_f32_check(torch, model, card: str) -> None:
    """The fp32 PEG on the attribution path (F.conv3d through cuDNN, under
    capture.full_fp32) against a float64 conv on the same input: not TF32.
    The same conv with cuDNN's TF32 flag on is printed beside it (cuDNN
    may or may not take TF32 for a depthwise conv)."""
    import torch.nn.functional as F

    from ct_clip_ut_tpu_torch.attribution.capture import full_fp32
    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.layers import peg_residual

    vit = model.visual_transformer
    t, h, w = token_grid_shape(vit.cfg, VOLUME)
    d = vit.cfg.dim
    peg = vit.enc_spatial_transformer.layers[0][0]
    x = torch.randn((t, h * w, d), generator=torch.Generator(device="cuda").manual_seed(17),
                    device="cuda")
    with torch.no_grad():
        v = x.double().reshape(1, t, h, w, d).permute(0, 4, 1, 2, 3)
        ref = F.conv3d(F.pad(v, (1, 1, 1, 1, 2, 0)), peg.dsconv.weight.double(), groups=d)
        ref = (ref + peg.dsconv.bias.double()[:, None, None, None] + v)
        ref = ref.permute(0, 2, 3, 4, 1).reshape(x.shape)
        with full_fp32():
            got = peg_residual(peg.dsconv.weight, peg.dsconv.bias, x, (1, t, h, w), peg.causal)
        flag = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = peg_residual(peg.dsconv.weight, peg.dsconv.bias, x, (1, t, h, w), peg.causal)
        finally:
            torch.backends.cudnn.allow_tf32 = flag
    err, tf32_err = rel_err(got, ref), rel_err(tf32, ref)
    print(f"attribution: fp32 peg_residual {list(x.shape)} under full_fp32 vs a float64 conv: "
          f"max_rel_err {err:.3e} (band {PEG_F32_BAND}); with cuDNN's TF32 flag on "
          f"{tf32_err:.3e} [{card}]")
    if not err <= PEG_F32_BAND:
        raise AssertionError(f"fp32 PEG: {err} from float64 (TF32?)")


def peak_timed(torch, fn) -> tuple:
    """(fn(), its seconds on the host clock, synchronised, and the peak GB
    of device memory allocated during it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


class VQRecorder:
    """A context manager that records the indices of every vq_apply call a
    sweep makes (patching the name the models call, in models.ctclip and
    models.ctvit). Given `against`, an earlier recording of a sweep with
    the same chunks, it also measures each token whose index differs: the
    fp64 gap between the two codes' cosine sims with this sweep's VQ input
    (a tie when small). With `replay` the calls then quantise with
    `against`'s indices (vq_apply's straight-through output from those
    codes), so two paths compare from the same codes."""

    def __init__(self, torch, against=None, replay=False):
        self.torch, self.against, self.replay = torch, against, replay
        self.ids, self.gaps = [], []

    def __enter__(self):
        import ct_clip_ut_tpu_torch.models.ctclip as mc
        import ct_clip_ut_tpu_torch.models.ctvit as mv

        self.mods, self.orig = (mc, mv), mc.vq_apply

        def recorded(state, x, **kw):
            out, idx, new = self.orig(state, x, **kw)
            rows = idx.reshape(x.shape[0], -1)
            if self.against is not None:
                other = self.against.ids[len(self.ids)]
                r, c = (rows != other).nonzero(as_tuple=True)
                if r.numel():
                    u = x[r, c].double()
                    u = u / u.norm(dim=-1, keepdim=True)
                    e = state.embed.double()
                    self.gaps.append(((u * e[rows[r, c].long()]).sum(-1)
                                      - (u * e[other[r, c].long()]).sum(-1)).abs().max().item())
                if self.replay:
                    cb = state.embed.to(x.dtype)
                    out = x + (cb[other.reshape(idx.shape).long()] - x).detach()
            self.ids.append(rows.clone())
            return out, idx, new

        for m in self.mods:
            m.vq_apply = recorded
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.vq_apply = self.orig

    def flips(self):
        """Tokens whose index differs from `against`'s, per forward (row)."""
        return self.torch.cat([(a != b).sum(1) for a, b in
                               zip(self.ids, self.against.ids)]).cpu().numpy()


def attribution_phase(torch, card: str) -> tuple:
    """Phase 10: the forward attribution methods in fp32 at flagship width
    (`flagship_cfg()`, random weights from seed 0, the matmul patch embed
    of `capture.parity_cfg`) on one [1, 1, 240, 480, 480] fp32 volume with
    a 512-token stand-in prompt. Returns (kernel record, launch counts)."""
    import numpy as np

    from ct_clip_ut_tpu_torch.attribution import capture, occlusion, raw_attention, rollout
    from ct_clip_ut_tpu_torch.config import OcclusionConfig, flagship_cfg
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer, tokenize_prompts
    from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
    from ct_clip_ut_tpu_torch.ops import launches

    cfg = flagship_cfg()
    model = init_ctclip(cfg, seed=0, device="cuda")
    record = f32_check(torch, model, card)
    peg_f32_check(torch, model, card)

    g = torch.Generator(device="cuda").manual_seed(16)
    image = torch.randn((1, *VOLUME), generator=g, device="cuda")
    prompts = tokenize_prompts(WordTokenizer(cfg.bert.vocab_size), max_length=PROMPT_LEN,
                               device="cuda")
    prompt = {k: v[:1] for k, v in prompts.items()}
    diff = torch.randn((cfg.dim_text,), generator=g, device="cuda")
    occ = OcclusionConfig()
    grid = occlusion.window_grid(VOLUME[1:], occ.patch_size, occ.stride)
    coords = grid[:OCC_WINDOWS]
    peak = {}

    def timed(label, fn):
        res, secs, peak[label] = peak_timed(torch, fn)
        return res, secs

    # the main path, counted: raw attention, rollout, two latents, the
    # frame-sparse sweep in slabs (a ragged tail), the dense shortcut
    launches.reset_launch_counts()
    (sp, tm), raw_s = timed("raw attention", lambda: raw_attention.raw_attention_maps(
        model, prompt, image))
    raw_counts = launches.launch_counts()
    (rsp, rtm), roll_s = timed("rollout", lambda: rollout.rollout_volumes(model, prompt, image))
    t0 = time.perf_counter()
    maps = [capture.upsample_to_host(v.cpu().numpy(), VOLUME[1:]) for v in (rsp, rtm)]
    expand_s = time.perf_counter() - t0
    latents = torch.stack([occlusion.report_text_latent(model, prompt),
                           occlusion.diff_embedding_latent(model, diff)])
    (orig, scores), occ_s = timed("occlusion", lambda: occlusion.occlusion_scores_slabbed(
        model, image, latents, coords, occ=occ, chunk=OCC_CHUNK, slab=OCC_SLAB))
    (orig_d, dense), dense_s = timed("dense shortcut", lambda: occlusion.occlusion_scores_multi(
        model, image, latents, coords, occ=occ, chunk=OCC_CHUNK, frame_sparse=False))
    counts = launches.launch_counts()
    print(f"attribution: launches of the path {json.dumps({k: counts[k] for k in counts if counts[k]})};"
          f" raw attention's alone {json.dumps({k: raw_counts[k] for k in raw_counts if raw_counts[k]})}")
    missing = [k for k in ATTRIBUTION_KERNELS if counts[k] <= 0]
    if missing or raw_counts["geglu_ff_f32"] <= 0 or raw_counts["vq_nearest_f32"] <= 0:
        raise AssertionError(f"attribution path: kernels not launched {missing}, {raw_counts}")
    ms_window = 1e3 * occ_s / OCC_WINDOWS
    print(f"attribution: raw_attention_maps {raw_s:.3f} s a map set (peak {peak['raw attention']:.2f}"
          f" GB); rollout {roll_s:.3f} s on the device + {expand_s:.3f} s host expansion a pair "
          f"(peak {peak['rollout']:.2f} GB); occlusion frame-sparse, chunk {OCC_CHUNK}, "
          f"{OCC_WINDOWS} windows in slabs of {OCC_SLAB}: {ms_window:.3f} ms a window, a full "
          f"{FULL_SWEEP}-window sweep ~{FULL_SWEEP * ms_window / 1e3:.1f} s (peak "
          f"{peak['occlusion']:.2f} GB); the dense shortcut {1e3 * dense_s / OCC_WINDOWS:.3f} ms "
          f"a window (peak {peak['dense shortcut']:.2f} GB) (host clock, synchronised, first "
          f"calls) [{card}]")

    # the same against plain=True and a shifted sweep; the scores also
    # against the dense shortcut. A window's score may move by ~1e-2 where
    # one of its 13,824 VQ indices flips at a near-tie between the two
    # paths (their inputs differ by fp32 rounding); the recorders count
    # the flips of each forward and measure their ties.
    psp, ptm = raw_attention.raw_attention_maps(model, prompt, image, plain=True)
    prsp, prtm = rollout.rollout_volumes(model, prompt, image, plain=True)
    pmaps = [capture.upsample_to_host(v.cpu().numpy(), VOLUME[1:]) for v in (prsp, prtm)]
    map_errs = {"raw spatial": (sp - psp).abs().max().item(),
                "raw temporal": (tm - ptm).abs().max().item(),
                "rollout spatial": float(np.abs(maps[0] - pmaps[0]).max()),
                "rollout temporal": float(np.abs(maps[1] - pmaps[1]).max())}
    map_control = (sp[0] - sp[1]).abs().max().item()
    print(f"attribution: maps vs plain=True, max abs error on [0, 1]-normalised volumes "
          + ", ".join(f"{k} {v:.3e}" for k, v in map_errs.items())
          + f" (band {MAP_BAND}); control (raw spatial layer 0 vs layer 1) {map_control:.3e}; "
          f"shapes {list(sp.shape)}, {list(tm.shape)}, {list(maps[0].shape)}")
    if not all(np.isfinite(m).all() for m in maps) or not torch.isfinite(sp).all():
        raise AssertionError("non-finite maps")
    if max(map_errs.values()) > MAP_BAND or not map_control > MAP_BAND:
        raise AssertionError(f"maps: {map_errs}, control {map_control}")

    def slabbed(coords, plain=False):
        return occlusion.occlusion_scores_slabbed(model, image, latents, coords, occ=occ,
                                                  chunk=OCC_CHUNK, slab=OCC_SLAB, plain=plain)

    def multi(frame_sparse):
        o, sc = occlusion.occlusion_scores_multi(model, image, latents, coords, occ=occ,
                                                 chunk=OCC_CHUNK, frame_sparse=frame_sparse)
        return o.double().cpu().numpy(), sc.double().cpu().numpy()

    with VQRecorder(torch) as rec_k:
        again = slabbed(coords)
    with VQRecorder(torch, rec_k) as rec_p:
        porig, pscores = slabbed(coords, plain=True)
    with VQRecorder(torch) as rec_s:
        _, sparse = multi(True)
    with VQRecorder(torch, rec_s) as rec_d:
        _, dense = multi(False)
    _, shifted = slabbed(grid[1:OCC_WINDOWS + 1])
    same = np.array_equal(again[1], scores) and np.array_equal(again[0], orig)
    scale = np.abs(pscores).max()

    def window_errs(a, b):
        return np.abs(a - b).max(axis=1) / scale

    # the windows' forwards in a slabbed sweep's: each slab's baseline, then its windows
    slab_rows, row = [], 0
    for lo in range(0, OCC_WINDOWS, OCC_SLAB):
        n = min(OCC_SLAB, OCC_WINDOWS - lo)
        slab_rows += range(row + 1, row + 1 + n)
        row += 1 + n
    checks = {"plain=True": (window_errs(scores, pscores), rec_p.flips()[slab_rows], rec_p.gaps),
              "the dense shortcut": (window_errs(sparse, dense), rec_d.flips()[1:], rec_d.gaps)}
    shift_errs = window_errs(shifted, scores)
    orig_err = float(np.abs(orig - porig).max() / np.abs(porig).max())
    print(f"attribution: occlusion scores {list(scores.shape)} (2 latents: a prompt's, a diff "
          f"embedding's; range {scores.min():.4f} to {scores.max():.4f}, originals "
          f"{np.round(orig, 5).tolist()}; a second sweep the same bits: {same}); a window's "
          f"relative error (over the largest score): "
          + "; ".join(f"vs {k}: max {e.max():.3e}, median {np.median(e):.3e}, "
                      f"{(e <= OCC_BAND).mean():.4f} of windows within {OCC_BAND}, "
                      f"{int((f > 0).sum())} windows with a VQ index flipped ({int(f.sum())} "
                      f"tokens), the largest tie {max(gaps, default=0.0):.3e}, the largest "
                      f"error of a window without one {e[f == 0].max(initial=0.0):.3e}"
                      for k, (e, f, gaps) in checks.items())
          + f"; control (a sweep shifted by one stride) max {shift_errs.max():.3e}, median "
          f"{np.median(shift_errs):.3e}, {(shift_errs <= OCC_BAND).mean():.4f} within; originals "
          f"vs plain=True {orig_err:.3e}")
    if not np.isfinite(scores).all() or scores.shape != (OCC_WINDOWS, 2) or not same:
        raise AssertionError(f"occlusion scores: shape {scores.shape}, same bits {same}")
    for k, (e, f, gaps) in checks.items():
        if e[f == 0].max(initial=0.0) > OCC_BAND or max(gaps, default=0.0) > VQ_F32_TIE:
            raise AssertionError(f"occlusion scores vs {k}: a window without a VQ flip over "
                                 f"{OCC_BAND}, or a flip at no tie ({max(gaps, default=0.0)})")
    if not (shift_errs <= OCC_BAND).mean() < 0.5:
        raise AssertionError("occlusion: the band passes a sweep shifted by one stride")
    return record, counts


def attn_bwd_flops(r: int, n: int, d: int, hd: int, weights: bool = False) -> float:
    """The fp32 block backward's products for dx as three bf16 products
    each: q, k, v, dO, dxn (2 r n d hd each), dx_direct (over 2 hd), and S,
    P.V, dP, dS.K, dS^T.Q, P^T.dO (2 r n^2 hd each); with `weights` also
    dWq, dWk | dWv, dWo (2 r n d hd each, four in all)."""
    return 3 * 2 * r * ((11 if weights else 7) * n * d * hd + 6 * n * n * hd)


def f32_layer_args(torch, g, vit) -> tuple:
    """Layer 0's fp32 weights of a CT-ViT in the fp32 kernels' argument
    order, gains drawn by around_ones: (the spatial stack's CPB bias [8,
    576, 576] fp32 at the flagship volume, the attention scale, the spatial
    and the temporal block's (gamma, wq, wk, wv, wo, q_scale, k_scale), the
    FF's (gamma, beta drawn as 0.1 N, w_in, w_out))."""
    from ct_clip_ut_tpu_torch.ops.posbias import continuous_pos_bias

    cfg = vit.cfg
    d = cfg.dim

    def attn_args(tf):
        a = tf.layers[0][1]
        inner = a.cfg.inner_dim
        wkv = a.to_kv.weight.detach().float()
        return [around_ones(torch, g, d), a.to_q.weight.detach().float(),
                wkv[:inner].contiguous(), wkv[inner:].contiguous(),
                a.to_out.weight.detach().float(), around_ones(torch, g, a.cfg.dim_head),
                around_ones(torch, g, a.cfg.dim_head)]

    with torch.no_grad():
        bias = continuous_pos_bias(vit.spatial_rel_pos_bias, cfg.patch_height,
                                   cfg.patch_width).float().contiguous()
    scale = vit.enc_spatial_transformer.layers[0][1].cfg.scale
    ff = vit.enc_spatial_transformer.layers[0][3]
    sp, tm = attn_args(vit.enc_spatial_transformer), attn_args(vit.enc_temporal_transformer)
    ffw = [around_ones(torch, g, d), 0.1 * torch.randn((d,), generator=g, device="cuda"),
           ff[1].weight.detach().float(), ff[4].weight.detach().float()]
    return bias, scale, sp, tm, ffw


def f32_bwd_check(torch, model, card: str) -> dict:
    """Phase 11's kernel checks: the fp32 data-gradient chains of rows 7-9
    against the plain backwards' dx (TF32 off) at an integrated-gradients
    chunk's shapes (5 volumes: attn_block [120, 576, 512] with the fp32
    [8, 576, 576] bias, attn_packed [2880, 24, 512], geglu_ff [69120, 512])
    and at a Grad-CAM's (one volume). attn_block_bwd_f32 runs as the
    methods run it, from the forward's o planes and row statistics
    (attn_block(..., keep=True), what _BlockFn keeps), and must give the
    bits of the chain that reruns the forward core. Band F32_BAND (max
    relative error); controls the chain with every lo plane zeroed (one
    bf16 product each) and the plain backward with one fault (the softmax
    row term, the l2-norm projection, the LN gain, GELU for its
    derivative); two calls the same bits. At the chunk's shapes: times (and
    the rerunning chain's), bound_ms (three bf16 products of the function's
    products, `attn_bwd_flops`; 30 N D inner for the FF), library_ms (the
    fp32 PyTorch chain forward + backward under autograd with only x
    wanting its gradient), one call under torch.profiler on the Hopper
    pieces (its launches with their ms: the per-launch split). Last, an
    fp32 backward whose weights want their gradients takes the full chain
    (phase 14's), not this one."""
    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.attention import _BlockFn
    from ct_clip_ut_tpu_torch.ops.attn_block import (attn_block, attn_block_bwd_f32,
                                                     attn_block_bwd_plain)
    from ct_clip_ut_tpu_torch.ops.attn_packed import attn_packed_bwd_f32, attn_packed_bwd_plain
    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.ops.geglu_ff import geglu_ff_bwd_f32, geglu_ff_bwd_plain

    vit = model.visual_transformer
    cfg = vit.cfg
    g = torch.Generator(device="cuda").manual_seed(18)
    t, h, w = token_grid_shape(cfg, VOLUME)
    hw, d = h * w, cfg.dim

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    bias, scale, sp, tm, ffw = f32_layer_args(torch, g, vit)
    attn_faults, ff_faults = ("row_term", "l2norm", "gamma"), ("gelu_prime", "gamma")
    # name -> (chain, plain backward, weights, faults, library fn(x, *weights), flops(x))
    cases = {
        "attn_block_bwd_f32": (
            lambda x, gg, **kw: attn_block_bwd_f32(x, *sp, bias, gg, scale, **kw),
            lambda x, gg, f=(): attn_block_bwd_plain(x, *sp, bias, gg, scale, faults=f)[0],
            {"IG chunk": (IG_CHUNK * t, hw, d), "Grad-CAM": (t, hw, d)}, attn_faults,
            lambda x: attn_library(x, *sp, bias, scale, residual=False),
            lambda x: attn_bwd_flops(x.shape[0], x.shape[1], d, sp[1].shape[0])),
        "attn_packed_bwd_f32": (
            lambda x, gg, **kw: attn_packed_bwd_f32(x, *tm, gg, scale, **kw),
            lambda x, gg, f=(): attn_packed_bwd_plain(x, *tm, gg, scale, faults=f)[0],
            {"IG chunk": (IG_CHUNK * hw, t, d), "Grad-CAM": (hw, t, d)}, attn_faults,
            lambda x: attn_library(x, *tm, None, scale, residual=False),
            lambda x: attn_bwd_flops(x.shape[0], x.shape[1], d, tm[1].shape[0])),
        "geglu_ff_bwd_f32": (
            lambda x, gg, **kw: geglu_ff_bwd_f32(x, *ffw, gg, **kw),
            lambda x, gg, f=(): geglu_ff_bwd_plain(x, *ffw, gg, faults=f)[0],
            {"IG chunk": (IG_CHUNK * t * hw, d), "Grad-CAM": (t * hw, d)}, ff_faults,
            lambda x: ff_library(x, *ffw, residual=False),
            lambda x: 3 * 10 * x.shape[0] * d * ffw[3].shape[1]),
    }
    out = {}
    for name, (kern, plain, shapes, faults, library, flops) in cases.items():
        for label, shape in shapes.items():
            x, gg = randn(*shape), randn(*shape)
            with torch.no_grad():
                # the spatial chain from the forward's o planes and statistics
                kept = ({"saved": attn_block(x, *sp, bias, scale, keep=True)[1]}
                        if name == "attn_block_bwd_f32" else {})
                got, want = kern(x, gg, **kept), plain(x, gg)
                same = torch.equal(got, kern(x, gg, **kept))
                rerun = not kept or torch.equal(got, kern(x, gg))
                controls = {"one bf16 product each (lo planes zeroed)":
                            rel_err(kern(x, gg, one_pass=True), want)}
                controls.update({f"plain with fault {f}": rel_err(got, plain(x, gg, (f,)))
                                 for f in faults})
            abs_err = band_check(name, got, want, F32_BAND, controls,
                                 f"{label} fp32 x {list(shape)}, dx max "
                                 f"{want.abs().max().item():.3e}, two calls the same bits: "
                                 f"{same}" + (f", the chain rerunning the forward core the same "
                                              f"bits: {rerun}" if kept else ""))
            if not (same and rerun):
                raise AssertionError(f"{name}: two calls, or the saved and the rerun route, "
                                     f"gave different bits")
            if label != "IG chunk":
                continue
            with torch.no_grad():
                ms = cuda_ms(torch, lambda: kern(x, gg, **kept))
                plain_ms = cuda_ms(torch, lambda: plain(x, gg))
                if kept:
                    print(f"kernel {name}: the chain rerunning the forward core "
                          f"{cuda_ms(torch, lambda: kern(x, gg)):.3f} ms [{card}]")
            library_ms, (lib_dx,) = library_grad_ms(torch, library, [x], gg)
            ins = [x, gg, got, *(sp if "attn" in name else ffw)]
            rec = bound(flops(x), nbytes(*ins, *([bias] if name == "attn_block_bwd_f32" else [])),
                        BF16_PEAK)
            print(f"kernel {name}: {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, three bf16 products each), the "
                  f"fp32 PyTorch chain forward + backward (x alone wanting its gradient) "
                  f"{library_ms:.3f} ms ({library_ms.span}) (max_rel_err "
                  f"{rel_err(lib_dx, want):.3e} vs the plain dx) [{card}]")
            out[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **rec,
                             library_ms=library_ms)
            with torch.no_grad():
                hopper_chain_check(name, lambda: kern(x, gg, **kept), card,
                                   **(FUSED_TEMPORAL if name == "attn_packed_bwd_f32" else {}))
            del x, gg, got, want, kept
            torch.cuda.empty_cache()

    # a parameter that wants its gradient: the full chain (the fp32 train
    # step's, phase 14), not this one
    x = randn(2, t, d).requires_grad_(True)
    wq = sp[1].clone().requires_grad_(True)
    launches.reset_launch_counts()
    _BlockFn.apply(x, sp[0], wq, *sp[2:], None, scale, True).sum().backward()
    counts = launches.launch_counts()
    print(f"kernel attn_packed_bwd_f32: an fp32 backward with a weight wanting its gradient "
          f"launches the full chain: {json.dumps({k: v for k, v in counts.items() if v})}")
    if counts["attn_packed_bwd_f32"] != 0 or counts["attn_packed_bwd_f32_full"] != 1:
        raise AssertionError(f"an fp32 backward with parameter gradients: launches {counts}")
    return out


def gradient_phase(torch, card: str) -> tuple:
    """Phase 11: the gradient attribution methods in fp32 at flagship width
    (`flagship_cfg()`, random weights from seed 0, the matmul patch embed,
    phase 10's [1, 1, 240, 480, 480] fp32 volume and 512-token stand-in
    prompt). Returns (kernel record, launch counts of the counted path)."""
    import numpy as np

    from ct_clip_ut_tpu_torch.attribution import grad_cam
    from ct_clip_ut_tpu_torch.attribution import integrated_gradients as ig
    from ct_clip_ut_tpu_torch.config import flagship_cfg
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer, tokenize_prompts
    from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
    from ct_clip_ut_tpu_torch.ops import launches

    t_phase = time.perf_counter()
    cfg = flagship_cfg()
    model = init_ctclip(cfg, seed=0, device="cuda")
    record = f32_bwd_check(torch, model, card)

    g = torch.Generator(device="cuda").manual_seed(16)
    image = torch.randn((1, *VOLUME), generator=g, device="cuda")
    prompts = tokenize_prompts(WordTokenizer(cfg.bert.vocab_size), max_length=PROMPT_LEN,
                               device="cuda")
    prompt = {k: v[:1] for k, v in prompts.items()}

    # the main path, counted: a Grad-CAM map set, then one default IG map
    # (50 steps in chunks of 5), first calls
    launches.reset_launch_counts()
    cams, cam_s, cam_gb = peak_timed(torch, lambda: grad_cam.grad_cam_volumes(model, prompt,
                                                                               image))
    cam_counts = launches.launch_counts()
    ig_map, ig_s, ig_gb = peak_timed(torch, lambda: ig.integrated_gradients(model, prompt,
                                                                            image))
    counts = launches.launch_counts()
    ig_counts = {k: counts[k] - cam_counts[k] for k in counts}
    print(f"gradients: launches of a Grad-CAM map set "
          f"{json.dumps({k: v for k, v in cam_counts.items() if v})}; of a default IG map "
          f"{json.dumps({k: v for k, v in ig_counts.items() if v})}")
    want_cam = {k: cam_counts[k] for k in GRAD_CAM_LAUNCHES}
    want_ig = {k: ig_counts[k] for k in IG_LAUNCHES}
    if want_cam != GRAD_CAM_LAUNCHES or want_ig != IG_LAUNCHES:
        raise AssertionError(f"gradient path launches: Grad-CAM {want_cam} (expected "
                             f"{GRAD_CAM_LAUNCHES}), IG {want_ig} (expected {IG_LAUNCHES})")
    t0 = time.perf_counter()
    maps = grad_cam.grad_cam_maps(model, prompt, image)
    maps_s = time.perf_counter() - t0
    image2 = torch.randn((1, *VOLUME), generator=g, device="cuda")
    piped, piped_s, piped_gb = peak_timed(torch, lambda: list(
        ig.integrated_gradients_pipelined(model, [(prompt, image), (prompt, image2)])))
    print(f"gradients: grad_cam_volumes {cam_s:.3f} s a map set (peak {cam_gb:.2f} GB), "
          f"grad_cam_maps with the host expansion of its six maps {maps_s:.3f} s; "
          f"integrated_gradients {ig_s:.3f} s a map, {ig_s / 50:.4f} s a step (50 steps, chunk "
          f"5; peak {ig_gb:.2f} GB); pipelined over 2 items {piped_s / 2:.3f} s a map (peak "
          f"{piped_gb:.2f} GB) (host clock, synchronised, first calls) [{card}]")
    finite = all(torch.isfinite(v).all() for v in cams.values()) and all(
        np.isfinite(m).all() for m in (ig_map, *piped, *maps.values()))
    if (not finite or ig_map.shape != VOLUME[1:] or not np.array_equal(piped[0], ig_map)
            or any(m.shape != VOLUME[1:] for m in maps.values())):
        raise AssertionError("gradient maps: non-finite, misshapen, or the pipelined map differs "
                             "from the serial one")

    # Grad-CAM against plain=True, both pairings; the flips of the one
    # forward counted, each a tie
    vols, recs, roots = {}, {}, {}
    for pairing in ("reference", "aligned"):
        with VQRecorder(torch) as rec_k:
            got = grad_cam.grad_cam_volumes(model, prompt, image, pairing=pairing)
        with VQRecorder(torch, rec_k) as rec_p:
            want, plain_s, plain_gb = peak_timed(torch, lambda: grad_cam.grad_cam_volumes(
                model, prompt, image, pairing=pairing, plain=True))
        vols[pairing], recs[pairing] = got, rec_k
        # combined = sqrt(spatial * temporal + 1e-8) is held through its square,
        # the product it is made of: the root turns an error e of a product
        # near zero into ~sqrt(e), whatever the kernels' precision
        errs = {k: (got[k] - want[k]).abs().max().item() for k in got if k != "combined"}
        errs["combined^2"] = (got["combined"] ** 2 - want["combined"] ** 2).abs().max().item()
        root_err = roots[pairing] = (got["combined"] - want["combined"]).abs().max().item()
        flips = int(rec_p.flips().sum())
        print(f"gradients: grad_cam_volumes ({pairing}) vs plain=True, max abs error on [0, 1] "
              f"volumes " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (band {MAP_BAND}; combined itself {root_err:.3e}); VQ indices flipped "
              f"{flips}, the largest tie "
              f"{max(rec_p.gaps, default=0.0):.3e} (band {VQ_F32_TIE}); plain=True {plain_s:.3f} s"
              f" (peak {plain_gb:.2f} GB) [{card}]")
        if max(rec_p.gaps, default=0.0) > VQ_F32_TIE or (flips == 0
                                                         and max(errs.values()) > MAP_BAND):
            raise AssertionError(f"Grad-CAM ({pairing}) vs plain=True: {errs}, {flips} flips")
    control = max((vols["reference"][k] - vols["aligned"][k]).abs().max().item()
                  for k in ("spatial", "temporal", "spatial_ff", "temporal_ff"))
    print(f"gradients: control (the aligned pairing vs the reference one) {control:.3e}")
    if not control > MAP_BAND:
        raise AssertionError("Grad-CAM: the band passes the other pairing")
    # grad_cam_maps (the path's maps above) against plain=True's: the host
    # expansion weighs grid values by linear weights that sum to 1, so a
    # map is as close as its volume, the combined one as its own volume
    with VQRecorder(torch, recs["reference"]) as rec_p:
        pmaps = grad_cam.grad_cam_maps(model, prompt, image, plain=True)
    map_errs = {k: float(np.abs(maps[k] - pmaps[k]).max()) for k in maps}
    flips = int(rec_p.flips().sum())
    print(f"gradients: grad_cam_maps vs plain=True, max abs error "
          + ", ".join(f"{k} {v:.3e}" for k, v in map_errs.items())
          + f" (band {MAP_BAND}; combined within its volume's {roots['reference']:.3e}); VQ "
          f"indices flipped {flips}, the largest tie {max(rec_p.gaps, default=0.0):.3e}")
    if max(rec_p.gaps, default=0.0) > VQ_F32_TIE or (flips == 0 and (
            max(v for k, v in map_errs.items() if k != "combined") > MAP_BAND
            or map_errs["combined"] > roots["reference"] + 1e-6)):
        raise AssertionError(f"grad_cam_maps vs plain=True: {map_errs}, {flips} flips")

    # integrated gradients against plain=True at 10 steps: the map before
    # the threshold, the final map off the crossings, each crossing a tie
    with VQRecorder(torch) as rec_k:
        diff, avg = ig._ig_avg_grads(model, prompt, image, steps=IG_CHECK_STEPS, chunk=IG_CHUNK)
    with VQRecorder(torch, rec_k) as rec_p:
        (pdiff, pavg), plain_s, plain_gb = peak_timed(torch, lambda: ig._ig_avg_grads(
            model, prompt, image, steps=IG_CHECK_STEPS, chunk=IG_CHUNK, plain=True))
    pre, ppre = ig._ig_normalize(diff, avg, 0.0, 1.0), ig._ig_normalize(pdiff, pavg, 0.0, 1.0)
    fin, pfin = ig._ig_normalize(diff, avg, 0.9, 0.05), ig._ig_normalize(pdiff, pavg, 0.9, 0.05)
    crossed = (fin > 0) != (pfin > 0)
    threshold = ig._quantile(ppre, 0.9)
    pre_err = (pre - ppre).abs().max().item()
    fin_err = (fin - pfin).abs()[~crossed].max().item()
    cross_gap = (ppre[crossed] - threshold).abs().max().item() if crossed.any() else 0.0
    flips = rec_p.flips()
    print(f"gradients: integrated gradients vs plain=True ({IG_CHECK_STEPS} steps, chunk "
          f"{IG_CHUNK}, {pre.numel()} elements): before the threshold max abs error {pre_err:.3e}"
          f" (band {MAP_BAND}); the final map off the crossings {fin_err:.3e}; "
          f"{int(crossed.sum())} elements crossed the 0.90 threshold "
          f"({threshold.item():.6f}), the farthest {cross_gap:.3e} from it (band {IG_CROSS_BAND}); "
          f"{int((flips > 0).sum())} of {flips.size} forwards flipped a VQ index "
          f"({int(flips.sum())} tokens), the largest tie {max(rec_p.gaps, default=0.0):.3e}; "
          f"plain=True {plain_s:.3f} s (peak {plain_gb:.2f} GB) [{card}]")
    if (max(rec_p.gaps, default=0.0) > VQ_F32_TIE
            or (flips.sum() == 0 and (pre_err > MAP_BAND or fin_err > MAP_BAND
                                      or cross_gap > IG_CROSS_BAND))):
        raise AssertionError("integrated gradients vs plain=True outside the bands")
    print(f"gradients: phase 11 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return record, counts

def ctgen_f32_check(torch, model, card: str, g) -> dict:
    """Phase 12's kernel checks at the one-scan route's shapes: row 5f, the
    fp32 conv patch embed, on one [1, 1, 201, 128, 128] scan as the route
    cuts it (the first frame at temporal patch 1 through
    to_patch_emb_first_frame, K = 256; the other 200 frames at 2, K = 512),
    and row 13f, the fp32 q-row attention at [1, 6464, 512] with layer 0's
    weights (gains drawn around their ones) and the fp32 [8, 6464, 6464]
    CPB table. Bands: F32_BAND (max relative error); controls the kernel
    with its lo planes zeroed (one bf16 product each), and for 13f the
    plain version without the bias or the q scale. The 5f row times the
    route's two launches together. bound_ms: three bf16 products for each
    fp32 one at the bf16 peak, or the bytes; library_ms: the same PyTorch
    chain in fp32 (TF32 off): patchify, F.layer_norm, F.linear,
    F.layer_norm; and LN, the projections, F.normalize,
    F.scaled_dot_product_attention with the float bias, the output
    projection and the residual."""
    import torch.nn.functional as F

    from ct_clip_ut_tpu_torch.models.ctgenerate import maskgit_bias_table
    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.attn_qrows import attn_qrows, attn_qrows_plain, launch_chain_f32
    from ct_clip_ut_tpu_torch.ops.patch_embed import (fold_patch_embed, patch_embed_f32,
                                                      patch_embed_fused, patch_embed_plain)

    cfg = model.cfg
    vit = model.ctvit
    p = cfg.ctvit.patch_size
    scan = torch.randn((1, *CTGEN_SCAN), generator=g, device="cuda")
    out = {}
    with torch.no_grad():
        cases = []
        for emb, img, tp in ((vit.to_patch_emb_first_frame, scan[:, :, :1].contiguous(), 1),
                             (vit.to_patch_emb, scan[:, :, 1:].contiguous(),
                              cfg.ctvit.temporal_patch_size)):
            kw, s1, b1 = fold_patch_embed(emb, p, tp)
            cases.append(([img, kw, s1, b1, emb[3].weight.float(), emb[3].bias.float()], tp, emb))
        errs, abs_errs, controls = [], [], []
        for args, tp, _ in cases:
            got = patch_embed_fused(*args, p, tp)
            want = patch_embed_plain(*args, p, tp)
            one = patch_embed_f32(*args, p, tp, one_pass=True)
            torch.cuda.synchronize()
            if got.dtype != torch.float32 or got.shape != want.shape:
                raise AssertionError(f"patch_embed_f32: {got.dtype} {tuple(got.shape)}")
            errs.append(rel_err(got, want))
            abs_errs.append((got - want).abs().max().item())
            controls.append(rel_err(one, want))
            print(f"kernel patch_embed_f32 t_patch {tp}: image {list(args[0].shape)} fp32, K = "
                  f"{tp * p * p}, max_rel_err {errs[-1]:.3e} vs plain (band {F32_BAND}); control "
                  f"(one bf16 product, lo planes zeroed) {controls[-1]:.3e}")
        if max(errs) > F32_BAND or min(controls) <= F32_BAND:
            raise AssertionError(f"patch_embed_f32: errors {errs}, controls {controls}")

        def both(fn):
            return [fn(*args, p, tp) for args, tp, _ in cases]

        # the first frame's 64 patches on 64-row tiles, the other frames' 6,400 on
        # 32-deep slices: the staged split products, no gemm_kernel
        hopper_chain_check("patch_embed_f32 (the route's two launches)",
                           lambda: both(patch_embed_fused), card,
                           must=("split4_64_kernel", "split4_32_kernel"),
                           must_not=("gemm_kernel",))

        libs = [patch_library(emb, p, tp) for _, tp, emb in cases]
        lib_err = max(rel_err(lib(args[0]), patch_embed_plain(*args, p, tp))
                      for lib, (args, tp, _) in zip(libs, cases))
        ms = cuda_ms(torch, lambda: both(patch_embed_fused))
        plain_ms = cuda_ms(torch, lambda: both(patch_embed_plain))
        library_ms = library_time(torch, lambda: [lib(args[0]) for lib, (args, _, _) in
                                                   zip(libs, cases)])
        flops = sum(3 * 2 * a[0].numel() // tp // (p * p) * tp * p * p * a[1].shape[-1]
                    for a, tp, _ in cases)
        rec = bound(flops, sum(nbytes(*a) + a[0].numel() // (tp * p * p) * a[1].shape[-1] * 4
                               for a, tp, _ in cases), BF16_PEAK)
        print(f"kernel patch_embed_f32 (the route's two launches): {ms:.3f} ms vs plain "
              f"{plain_ms:.3f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, three bf16 "
              f"products each), the PyTorch chain in fp32 {library_ms:.3f} ms "
              f"({library_ms.span}) (max_rel_err {lib_err:.3e} vs plain) [{card}]")
        out["patch_embed_f32"] = dict(max_abs_err=max(abs_errs), ms=ms, plain_ms=plain_ms, **rec,
                                      library_ms=library_ms)

        grid = token_grid_shape(cfg.ctvit, (1, *CTGEN_SCAN))
        n = grid[0] * grid[1] * grid[2]
        bias = maskgit_bias_table(model, grid)
        a = model.maskgit.transformer.layers[0][1]
        inner = a.cfg.inner_dim
        wkv = a.to_kv.weight.float()
        heads, dh = a.cfg.heads, a.cfg.dim_head
        w = [around_ones(torch, g, a.cfg.dim), a.to_q.weight.float(), wkv[:inner].contiguous(),
             wkv[inner:].contiguous(), a.to_out.weight.float(), around_ones(torch, g, dh),
             around_ones(torch, g, dh)]
        scale = a.cfg.scale
        x = torch.randn((1, n, a.cfg.dim), generator=g, device="cuda")
        args = [x, *w, bias]
        got = attn_qrows(*args, scale, False)
        want = attn_qrows_plain(*args, scale, False)
        torch.cuda.synchronize()
        no_qs = list(args)
        no_qs[6] = torch.ones_like(args[6])
        controls = {"one bf16 product each (lo planes zeroed)":
                    rel_err(launch_chain_f32(*args, scale, False, one_pass=True), want),
                    "no bias": rel_err(got, attn_qrows_plain(*args[:8], None, scale, False)),
                    "no q_scale": rel_err(got, attn_qrows_plain(*no_qs, scale, False))}
        if got.dtype != torch.float32:
            raise AssertionError(f"attn_qrows_f32: output dtype {got.dtype}")
        abs_err = band_check("attn_qrows_f32", got, want, F32_BAND, controls,
                             f"x {list(x.shape)} fp32, bias {list(bias.shape)} fp32, branch max "
                             f"{want.abs().max().item():.3e}")
        same = torch.equal(got, attn_qrows(*args, scale, False))
        print(f"kernel attn_qrows_f32: the one-pass core, two calls the same bits: {same}")
        if not same:
            raise AssertionError("attn_qrows_f32: two calls give different bits")
        ms = cuda_ms(torch, lambda: attn_qrows(*args, scale, True))
        plain_ms = cuda_ms(torch, lambda: attn_qrows_plain(*args, scale, True), iters=3)
        gamma, wq, wk, wv, wo, qs, ks = w
        wkv = torch.cat([wk, wv])

        def library():   # the branch; timed with the residual add
            xn = F.layer_norm(x, (x.shape[-1],), gamma)
            q = (xn @ wq.t()).view(1, n, heads, dh).transpose(1, 2)
            k, v = (x @ wkv.t()).view(1, n, 2, heads, dh).permute(2, 0, 3, 1, 4)
            q = F.normalize(q, dim=-1) * (qs * scale)
            k = F.normalize(k, dim=-1) * ks
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias[None], scale=1.0)
            return o.transpose(1, 2).reshape(1, n, heads * dh) @ wo.t()

        lib_err = rel_err(library(), want)
        library_ms = library_time(torch, lambda: library() + x)
        hd = heads * dh
        flops = 3 * 2 * (4 * n * x.shape[-1] * hd + heads * 2 * n * n * dh)
        rec = bound(flops, nbytes(x, *w, bias, got), BF16_PEAK)
        floor_ms = 1e3 * nbytes(bias) / HBM_RATE
        print(f"kernel attn_qrows_f32 B=1: {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; three bf16 products each), the "
              f"one-pass core's floor of bias bytes {floor_ms:.4f} ms (the table read once), fp32 "
              f"SDPA yardstick {library_ms:.3f} ms "
              f"({library_ms.span}) (max_rel_err {lib_err:.3e} vs the plain branch) [{card}]")
        out["attn_qrows_f32"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **rec,
                                     library_ms=library_ms)
    return out


def write_ctgen_dataset(root: Path, volumes: int, rng) -> None:
    """`volumes` raw int16 CT grids (CLI_VOLUME) with their reports, labels
    (the PATHOLOGIES columns, CTGEN_POSITIVES positive) and metadata CSVs:
    the inputs of inference_ctgenerate --data-valid."""
    import csv

    import numpy as np

    from ct_clip_ut_tpu_torch.config import PATHOLOGIES
    from ct_clip_ut_tpu_torch.data.nifti import write_nii

    xy, z = CLI_SPACING
    (root / "valid").mkdir()
    names = [f"valid_{i}_a_1.nii.gz" for i in range(volumes)]
    for name in names:
        write_nii(root / "valid" / name, rng.integers(-1024, 2000, CLI_VOLUME).astype(np.int16),
                  pixdim=(xy, xy, z))
    tables = {"reports.csv": [["VolumeName", "Findings_EN", "Impressions_EN"]] + [
                  [n, CTGEN_REPORTS[i % 2], ""] for i, n in enumerate(names)],
              "metadata.csv": [["VolumeName", "RescaleSlope", "RescaleIntercept", "XYSpacing",
                                "ZSpacing"]] + [[n, "1", "0", f"[{xy}, {xy}]", str(z)]
                                                for n in names],
              "labels.csv": [["VolumeName", *PATHOLOGIES]] + [
                  [n] + [str(int(p in CTGEN_POSITIVES[i % 2])) for p in PATHOLOGIES]
                  for i, n in enumerate(names)]}
    for fname, rows in tables.items():
        with open(root / fname, "w", newline="") as f:
            csv.writer(f).writerows(rows)


def ctgen_f32_phase(torch, card: str) -> tuple:
    """Phase 12: CTGenerate's one-scan fp32 route at CTGenerateConfig().
    Rows 5f and 13f against their plain versions (ctgen_f32_check); then,
    counted, `inference_ctgenerate.main --data-valid` over CTGEN_SCANS
    synthetic NIfTI volumes at --batch-size 1 (each scan's positives from
    its labels, the report T5-encoded, the scan and MaskGit in fp32): 5f x
    2 and 13f x 6 a scan, the fp32 CT-ViT variants, no bf16 kernel. Each
    scan again through `localize_scan`, timed, and against plain=True: the
    heatmaps within HEAT_BAND where the codebook ids agree, the VQ flips
    counted (each a tie within VQ_F32_TIE), the files main wrote the same
    maps; control the other scan's heatmaps. Returns (record, counts)."""
    import tempfile

    import numpy as np

    from ct_clip_ut_tpu_torch.config import CTGenerateConfig
    from ct_clip_ut_tpu_torch.data.datasets import InferenceDataset
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
    from ct_clip_ut_tpu_torch.models.ctgenerate import init_ctgenerate
    from ct_clip_ut_tpu_torch.models.t5 import T5TextConditioner
    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.scripts import inference_ctgenerate as script

    cfg = CTGenerateConfig()
    model = init_ctgenerate(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(17)
    record = ctgen_f32_check(torch, model, card, g)
    torch.cuda.empty_cache()
    t5 = T5TextConditioner(model.t5, WordTokenizer(cfg.t5.vocab_size))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_ctgen_dataset(root, CTGEN_SCANS, np.random.default_rng(18))
        out = root / "results"
        argv = ["--data-valid", str(root / "valid"), "--valid-reports", str(root / "reports.csv"),
                "--valid-labels", str(root / "labels.csv"), "--valid-metadata",
                str(root / "metadata.csv"), "--num-valid-samples", str(CTGEN_SCANS),
                "--batch-size", "1", "--results-folder", str(out), "--seed", "0"]
        launches.reset_launch_counts()
        t0 = time.perf_counter()
        written = script.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = launches.launch_counts()
        print(f"ctgenerate fp32: inference_ctgenerate --data-valid --batch-size 1 over "
              f"{CTGEN_SCANS} volumes {list(CLI_VOLUME)} int16 in {cli_s:.1f} s (host clock, model "
              f"init and preprocessing included) [{card}]: {len(written)} heatmaps; launches "
              f"{json.dumps({k: v for k, v in counts.items() if v})}")
        wrong = {k: counts[k] for k, per in CTGEN_F32_KERNELS.items()
                 if counts[k] != per * CTGEN_SCANS}
        wrong.update({k: counts[k] for k in CTGEN_F32_PATH if counts[k] <= 0})
        wrong.update({k: counts[k] for k in CTGEN_BF16 if counts[k] != 0})
        if wrong:
            raise AssertionError(f"the one-scan route's launches: {wrong}")

        ds = InferenceDataset(root / "valid", root / "reports.csv", root / "metadata.csv",
                              root / "labels.csv", num_samples=CTGEN_SCANS,
                              model_type="ctgenerate")
        samples = [ds[i] for i in range(len(ds))]
        heats, secs = [], []
        for image, text, labels, name, _ in samples:
            scan = torch.as_tensor(image)[None].cuda()
            positives = script.positives_of(labels)
            script.localize_scan(model, t5, scan, text, positives)          # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with VQRecorder(torch) as rec_k:
                maps, res = script.localize_scan(model, t5, scan, text, positives)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            with VQRecorder(torch, rec_k) as rec_p:
                pmaps, pres = script.localize_scan(model, t5, scan, text, positives, plain=True)
            flips = int(rec_p.flips().sum())
            gap = max(rec_p.gaps, default=0.0)
            if sorted(maps) != sorted(pmaps) or not maps:
                raise AssertionError(f"{name}: heatmaps {sorted(maps)} vs plain {sorted(pmaps)}")
            errs = {p: float(np.abs(maps[p] - pmaps[p]).max()) for p in maps}
            filed = {p: float(np.abs(np.load(out / f"ctgenerate_{name}_{p}.npy")
                                     - script.rot90_ct(maps[p])).max()) for p in maps}
            feat = rel_rms(res.feature_map, pres.feature_map)
            print(f"ctgenerate fp32: {name}: {flips} of {res.codebook_ids.numel()} codebook ids "
                  f"differ from plain=True's (the largest fp64 cosine gap {gap:.3e}, band "
                  f"{VQ_F32_TIE}); heatmaps vs plain=True max abs "
                  f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} (band "
                  f"{HEAT_BAND} where no id flipped); feature map relative rms {feat:.3e}; the "
                  f"files main wrote vs this call {max(filed.values()):.1e}; "
                  f"localize_scan {secs[-1]:.3f} s a scan (host clock, synchronised) [{card}]")
            if gap > VQ_F32_TIE or max(filed.values()) > SUITE_BAND:
                raise AssertionError(f"{name}: a VQ flip at no tie ({gap}), or the CLI's files "
                                     f"differ ({filed})")
            if flips == 0 and max(errs.values()) > HEAT_BAND:
                raise AssertionError(f"{name}: heatmaps vs plain=True {errs}")
            for heat in maps.values():
                if heat.shape != CTGEN_SCAN[1:] or not (np.isfinite(heat).all()
                                                         and 0 <= heat.min() <= heat.max() <= 1 + 1e-6):
                    raise AssertionError(f"{name}: bad heatmap {heat.shape}")
            heats.append(maps)
        image, text, labels, _, _ = samples[0]
        other, _ = script.localize_scan(model, t5, torch.as_tensor(samples[1][0])[None].cuda(),
                                        text, script.positives_of(labels))
        control = min(float(np.abs(heats[0][p] - other[p]).max()) for p in heats[0])
        print(f"ctgenerate fp32: control (scan 0's report over scan 1) {control:.3e}; "
              f"{statistics.mean(secs):.3f} s a scan one at a time (smoke reading, host clock) "
              f"[{card}]")
        if not control > HEAT_BAND:
            raise AssertionError(f"the heatmap band passes another scan's maps ({control})")
    return record, counts


def suite_phase(torch, card: str) -> None:
    """Phase 13: `CTClipInference.infer()` with zero-shot and all five
    attribution methods (`AttributionContext(render_gifs=False)`) on one
    flagship fp32 volume [1, 1, 240, 480, 480] (`flagship_cfg()`, seed 0) in
    a temporary directory: occlusion through the flags dict at SUITE_OCC (27
    windows), integrated gradients at its default 50 steps; then occlusion
    in the text-embeds mode through a second `visualize`. Every artifact
    at the JAX suite's path and within SUITE_BAND of a direct call of its
    method; seconds a method. Then `scripts.embedding_arithmetic.main` over
    EMBED_REPORTS synthetic reports of 512 tokens in batches of
    EMBED_BATCH (the fp32 bert_layer kernel): its file the same bits as
    `compute_diff_embeddings` of the phase's model, its CLS and diff
    embeddings against plain=True within EMBED_BAND of the CLS scale (a
    diff of two means carries the CLS embeddings' absolute error)."""
    import csv
    import tempfile

    import numpy as np

    from ct_clip_ut_tpu_torch.attribution import (capture, embedding_arithmetic, grad_cam,
                                                  integrated_gradients, occlusion,
                                                  raw_attention, rollout)
    from ct_clip_ut_tpu_torch.attribution.suite import AttributionContext, Visualizations
    from ct_clip_ut_tpu_torch.config import PATHOLOGIES, OcclusionConfig, flagship_cfg
    from ct_clip_ut_tpu_torch.infer.zeroshot import (CTClipInference, WordTokenizer,
                                                     tokenize_prompts)
    from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.scripts import embedding_arithmetic as escript

    cfg = flagship_cfg()
    model = init_ctclip(cfg, seed=0, device="cuda")
    tok = WordTokenizer(cfg.bert.vocab_size)
    g = torch.Generator(device="cuda").manual_seed(19)
    image = torch.randn((1, *VOLUME), generator=g, device="cuda")     # [1, 1, D, H, W]
    text = CTGEN_REPORTS[0]
    labels = np.array([float(p in CTGEN_POSITIVES[0]) for p in PATHOLOGIES], np.float32)
    diff = {p: torch.randn((cfg.dim_text,), generator=g, device="cuda").cpu().numpy()
            for p in ("Emphysema", "Lung nodule")}
    occ = OcclusionConfig(**SUITE_OCC)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ctx = AttributionContext(model=model, tokenizer=tok,
                                 data=[(image, text, labels, "scan_0", "synthetic")],
                                 diff_embeds=diff, render_gifs=False)
        flags = {"raw_attention_maps": True, "attention_rollout": True,
                 "integrated_gradients": True, "grad_cam": True,
                 "occlusion": {"occ": occ, "prompt": "report"}}
        inference = CTClipInference(model, tokenize_prompts(tok, device="cuda"),
                                    [(image, [text], labels[None])], results_folder=root,
                                    visualize=flags, attribution_ctx=ctx)
        launches.reset_launch_counts()
        t0 = time.perf_counter()
        metrics, preds, _ = inference.infer()
        infer_s = time.perf_counter() - t0
        counts = launches.launch_counts()
        vis = Visualizations(ctx, root)
        vis.visualize(occlusion={"occ": occ, "use_text_embeds": True, "prompt": "diff"})
        timings = {**inference.suite.timings, "occlusion (text embeds)": vis.timings["occlusion"]}
        print(f"suite: infer() with zero-shot and the five methods on one fp32 volume "
              f"{[1, *VOLUME]} in {infer_s:.1f} s; seconds a method "
              f"{json.dumps({k: round(v, 3) for k, v in timings.items()})} (host clock, "
              f"synchronised, first calls) [{card}]; launches "
              f"{json.dumps({k: v for k, v in counts.items() if v})}")
        need = ("bert_layer", *ATTRIBUTION_KERNELS, *GRADIENT_KERNELS)
        if [k for k in need if counts[k] <= 0] or preds.shape != (1, 18):
            raise AssertionError(f"the suite's launches {counts}, preds {preds.shape}")
        if not (root / "metrics.txt").read_text().startswith("Epoch 0 Metrics:"):
            raise AssertionError("infer() wrote no metrics table")

        # each artifact against a direct call of its method
        tokens = vis._tokenize(text)
        rot = capture.rot90_ct
        positives = [p for p in PATHOLOGIES if p in diff and p in CTGEN_POSITIVES[0]]
        direct = {}

        def call(name, fn):   # a direct call, timed (host clock, synchronised, warm)
            res, direct[name], _ = peak_timed(torch, fn)
            return res

        sp, tm = call("raw_attention_maps", lambda: raw_attention.raw_attention_maps_np(
            model, tokens, image))
        rsp, rtm = call("attention_rollout", lambda: rollout.rollout_maps(model, tokens, image))
        ig = call("integrated_gradients", lambda: integrated_gradients.integrated_gradients(
            model, tokens, image))
        cams = call("grad_cam", lambda: grad_cam.grad_cam_maps(model, tokens, image))
        heat = call("occlusion", lambda: occlusion.occlusion_heatmap(
            model, image, occlusion.report_text_latent(model, tokens), occ=occ))
        multi = call("occlusion (text embeds)", lambda: occlusion.occlusion_heatmaps_multi(
            model, image, torch.stack([occlusion.diff_embedding_latent(
                model, torch.as_tensor(diff[p], device="cuda")) for p in positives]), occ=occ))
        want = {"raw_attention_grids/1/scan_0_spatial.npy": sp,
                "raw_attention_grids/1/scan_0_temporal.npy": tm,
                "attention_rollout/1/scan_0_spatial.npy": rot(rsp),
                "attention_rollout/1/scan_0_temporal.npy": rot(rtm),
                "integrated_gradients/1/scan_0.npy": rot(ig),
                **{f"grad_cam/1/scan_0_{k}.npy": rot(v) for k, v in cams.items()},
                "occlusion/1/scan_0_report_heatmap.npy": rot(heat)}
        multi_rel = f"occlusion/2/scan_0_{occ.patch_size}_{occ.stride}_diff_heatmaps.npy"
        got = sorted(str(p.relative_to(root)) for p in root.rglob("*.npy"))
        if got != sorted([*want, multi_rel]):
            raise AssertionError(f"artifacts {got}")
        errs = {k: float(np.abs(np.load(root / k) - v).max()) for k, v in want.items()}
        saved = np.load(root / multi_rel, allow_pickle=True).item()
        errs[multi_rel] = max(float(np.abs(saved[p] - rot(h)).max())
                              for p, h in zip(positives, multi))
        print(f"suite: {len(errs)} artifacts at the JAX suite's paths; each vs a direct call of "
              f"its method, max abs {max(errs.values()):.3e} (band {SUITE_BAND}); text-embeds "
              f"occlusion scored {sorted(saved)} in one sweep; the direct calls' seconds, warm, "
              f"without writing the maps {json.dumps({k: round(v, 3) for k, v in direct.items()})}"
              f" [{card}]")
        if max(errs.values()) > SUITE_BAND or sorted(saved) != sorted(positives):
            raise AssertionError(f"suite artifacts vs direct calls: {errs}")

        # embedding arithmetic over a CSV corpus, through row 6, against plain=True
        rng = np.random.default_rng(20)
        texts = [" ".join(f"w{j}" for j in rng.integers(0, 4096, PROMPT_LEN))
                 for _ in range(EMBED_REPORTS)]
        lab = rng.integers(0, 2, (EMBED_REPORTS, len(PATHOLOGIES)))
        with open(root / "reports.csv", "w", newline="") as fr, \
                open(root / "labels.csv", "w", newline="") as fl:
            wr, wl = csv.writer(fr), csv.writer(fl)
            wr.writerow(["VolumeName", "Findings_EN", "Impressions_EN"])
            wl.writerow(["VolumeName", *PATHOLOGIES])
            for i, t in enumerate(texts):
                wr.writerow([f"v{i}.nii.gz", t, ""])
                wl.writerow([f"v{i}.nii.gz", *lab[i]])
        launches.reset_launch_counts()
        t0 = time.perf_counter()
        embeds = escript.main(["--reports", str(root / "reports.csv"), "--labels",
                               str(root / "labels.csv"), "--out", str(root / "diff.npy"),
                               "--batch-size", str(EMBED_BATCH)])
        torch.cuda.synchronize()
        embed_s = time.perf_counter() - t0
        bert = launches.launch_counts()["bert_layer"]
        cls = embedding_arithmetic.cls_embeddings(model, tok, texts, EMBED_BATCH)
        pcls = embedding_arithmetic.cls_embeddings(model, tok, texts, EMBED_BATCH, plain=True)
        plain = embedding_arithmetic.diff_embeddings(pcls, lab)
        same = all(np.array_equal(embeds[k], v)
                   for k, v in embedding_arithmetic.diff_embeddings(cls, lab).items())
        # a diff embedding is a difference of two means of CLS embeddings: its error is the
        # CLS embeddings' (the kernel's output), so both are read against the CLS scale
        scale = float(np.abs(pcls).max())
        cls_err = float(np.abs(cls - pcls).max()) / scale
        err = max(float(np.abs(embeds[k] - plain[k]).max()) for k in plain) / scale
        own = max(float(np.abs(embeds[k] - plain[k]).max() / np.abs(plain[k]).max())
                  for k in plain)
        control = float(np.abs(embeds[PATHOLOGIES[0]] - plain[PATHOLOGIES[1]]).max()) / scale
        print(f"suite: embedding_arithmetic over {EMBED_REPORTS} reports of {PROMPT_LEN} tokens in "
              f"batches of {EMBED_BATCH}: {len(embeds)} diff embeddings in {embed_s:.1f} s (host "
              f"clock, model init included) [{card}], {bert} bert_layer launches, the script's "
              f"file the same bits as compute_diff_embeddings: {same}; vs plain=True, over the "
              f"CLS embeddings' largest |entry|: the CLS embeddings {cls_err:.3e}, the diff "
              f"embeddings {err:.3e} (band {EMBED_BAND}; over each diff's own largest entry "
              f"{own:.3e}); control (another pathology's) {control:.3e}")
        if sorted(embeds) != sorted(plain) or bert != 2 * cfg.bert.num_layers or not same or \
                not max(err, cls_err) <= EMBED_BAND < control:
            raise AssertionError(f"embedding arithmetic: {sorted(embeds)}, {bert} launches, "
                                 f"same bits {same}, errors {cls_err} / {err}, control {control}")



def f32_train_check(torch, model, card: str) -> dict:
    """Phase 14's kernel checks at the shapes of a B = 2 fp32 train step,
    TF32 off: the full fp32 backwards (rows 7F, 8F: attn_block_bwd /
    attn_packed_bwd on fp32 tensors at [48, 576, 512] with the fp32 [8,
    576, 576] bias and [1152, 24, 512]; 9F: geglu_ff_bwd at [27648, 512]),
    each with the residual as the step runs them (7F from the forward's o
    planes and row statistics, as _BlockFn keeps them): every gradient
    within F32_BAND of the plain backward's (max relative error), the chain
    with its lo planes zeroed (one bf16 product each) outside, two calls the
    same bits, dx the dx-only chain's bits (7F: every gradient the bits of
    the chain rerunning the forward core). Then the fp32 residual-saving patch
    embed (10f: out, conv and the LN1 moments of a [2, 1, 240, 480, 480]
    fp32 volume) and its weight gradient from the forward's P planes (11f;
    from the volume the same bits), controls one bf16 product each; and the
    PEG kernels on fp32 [2, 24, 24, 24, 512] tokens (rows 16, 17 in fp32:
    the causal stencil within PEG_F32_KERNEL_BAND, the weight gradient
    within PEG_WGRAD_BAND, controls the non-causal frame padding, the bias
    left out, x shifted by a frame). Times, bound_ms (three bf16 products at
    the bf16 peak; the PEG's fp32 operations or bytes), library_ms: the fp32
    PyTorch chain forward + backward with x and every parameter wanting its
    gradient (7F-9F), fp32 patchify + F.layer_norm + F.linear + F.layer_norm
    (10f), torch.nn.grad.conv3d_weight (11f, 17), the NCDHW copy + F.conv3d
    + copy (16); one call of each backward (7F-9F), of 10f and of 11f under
    torch.profiler on the Hopper pieces (9F's and 11f's weight gradients on
    wgrad4_kernel, no wgrad_kernel)."""
    import copy

    import torch.nn.functional as F

    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.attn_block import (attn_block, attn_block_bwd,
                                                     attn_block_bwd_f32, attn_block_bwd_plain)
    from ct_clip_ut_tpu_torch.ops.attn_packed import (attn_packed_bwd, attn_packed_bwd_f32,
                                                      attn_packed_bwd_plain)
    from ct_clip_ut_tpu_torch.ops.geglu_ff import (geglu_ff_bwd, geglu_ff_bwd_f32,
                                                   geglu_ff_bwd_plain)
    from ct_clip_ut_tpu_torch.ops.layers import peg_residual
    from ct_clip_ut_tpu_torch.ops.patch_embed import (_res_with_patches, fold_patch_embed,
                                                      patch_embed_dkw, patch_embed_dkw_plain,
                                                      patch_embed_res_f32, patch_embed_res_plain)
    from ct_clip_ut_tpu_torch.ops.peg import (peg, peg_plain, peg_weight_grads,
                                              peg_weight_grads_plain, taps_of)

    vit = model.visual_transformer
    cfg = vit.cfg
    g = torch.Generator(device="cuda").manual_seed(19)
    t, h, w = token_grid_shape(cfg, VOLUME)
    hw, d = h * w, cfg.dim

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    bias, scale, sp, tm, ffw = f32_layer_args(torch, g, vit)
    attn_names = ("dx", "dgamma", "dwq", "dwk", "dwv", "dwo", "dqs", "dks", "dbias")
    ff_names = ("dx", "dgamma", "dbeta", "dw_in", "dw_out")
    # name -> (full chain, dx-only chain, plain backward, x's shape, names,
    # weights (the library's leaves after x), library fn, flops)
    cases = {
        "attn_block_bwd_f32_full": (
            lambda x, gg, **kw: attn_block_bwd(x, *sp, bias, gg, scale, True, **kw),
            lambda x, gg: attn_block_bwd_f32(x, *sp, bias, gg, scale, True),
            lambda x, gg: attn_block_bwd_plain(x, *sp, bias, gg, scale, True),
            (BATCH * t, hw, d), attn_names, [*sp, bias],
            lambda *a: attn_library(*a, scale, residual=True),
            attn_bwd_flops(BATCH * t, hw, d, sp[1].shape[0], weights=True)),
        "attn_packed_bwd_f32_full": (
            lambda x, gg, **kw: attn_packed_bwd(x, *tm, gg, scale, True, **kw),
            lambda x, gg: attn_packed_bwd_f32(x, *tm, gg, scale, True),
            lambda x, gg: attn_packed_bwd_plain(x, *tm, gg, scale, True),
            (BATCH * hw, t, d), attn_names[:8], tm,
            lambda *a: attn_library(*a, None, scale, residual=True),
            attn_bwd_flops(BATCH * hw, t, d, tm[1].shape[0], weights=True)),
        "geglu_ff_bwd_f32_full": (
            lambda x, gg, **kw: geglu_ff_bwd(x, *ffw, gg, True, **kw),
            lambda x, gg: geglu_ff_bwd_f32(x, *ffw, gg, True),
            lambda x, gg: geglu_ff_bwd_plain(x, *ffw, gg, True),
            (BATCH * t * hw, d), ff_names, ffw,
            lambda *a: ff_library(*a, residual=True),
            48 * BATCH * t * hw * d * ffw[3].shape[1]),
    }
    out = {}
    for name, (kern, dx_only, plain, shape, names, weights, library, flops) in cases.items():
        x, gg = randn(*shape), randn(*shape)
        with torch.no_grad():
            kept = ({"saved": attn_block(x, *sp, bias, scale, True, keep=True)[1]}
                    if name == "attn_block_bwd_f32_full" else {})
            got = dict(zip(names, kern(x, gg, **kept)))
            want = dict(zip(names, plain(x, gg)))
            again = kern(x, gg, **kept)
            same = all(torch.equal(a, b) for a, b in zip(got.values(), again))
            if kept:
                same = same and all(torch.equal(a, b) for a, b in zip(got.values(), kern(x, gg)))
            same_dx = torch.equal(got["dx"], dx_only(x, gg))
            faulty = {"one bf16 product each (lo planes zeroed)":
                      dict(zip(names, kern(x, gg, one_pass=True)))}
        abs_err = grads_check(name, got, want, F32_BAND, faulty,
                              f"fp32 x {list(shape)} (residual), every gradient; two calls the "
                              f"same bits: {same}, dx the dx-only chain's bits: {same_dx}")
        if not (same and same_dx):
            raise AssertionError(f"{name}: two calls, or dx and the dx-only chain, differ")
        with torch.no_grad():
            ms = cuda_ms(torch, lambda: kern(x, gg, **kept))
            plain_ms = cuda_ms(torch, lambda: plain(x, gg))
            if kept:
                print(f"kernel {name}: the chain rerunning the forward core "
                      f"{cuda_ms(torch, lambda: kern(x, gg)):.3f} ms [{card}]")
        library_ms, lib_grads = library_grad_ms(torch, library, [x, *weights], gg)
        lib_err = max(rel_err(lg, want[k]) for k, lg in zip(names, lib_grads))
        rec = bound(flops, nbytes(x, gg, *weights, *got.values()), BF16_PEAK)
        print(f"kernel {name}: {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, three bf16 products each), the "
              f"fp32 PyTorch chain forward + backward (x and every parameter wanting its "
              f"gradient) {library_ms:.3f} ms ({library_ms.span}) (its gradients vs the plain "
              f"ones: max_rel_err {lib_err:.3e}) [{card}]")
        out[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **rec,
                         library_ms=library_ms)
        with torch.no_grad():
            hopper_chain_check(name, lambda: kern(x, gg, **kept), card, **(
                {"must": FUSED_TEMPORAL["must"] + ("wgrad_sum_kernel",),
                 "must_not": FUSED_TEMPORAL["must_not"]} if name == "attn_packed_bwd_f32_full"
                else {"must": ("wgrad_sum_kernel",)} if name == "attn_block_bwd_f32_full"
                else {"must": ("wgrad4_kernel",), "must_not": ("wgrad_kernel",)}))
        del x, gg, got, want, again, faulty, lib_grads, kept
        torch.cuda.empty_cache()

    # rows 10f and 11f: the fp32 patch embed's residual-saving chain and its weight gradient
    p, tp = cfg.patch_size, cfg.temporal_patch_size
    emb = copy.deepcopy(vit.to_patch_emb)
    with torch.no_grad():
        for ln in (emb[1], emb[3]):
            ln.weight.copy_(1.0 + 0.1 * torch.randn(ln.weight.shape, generator=g, device="cuda"))
            ln.bias.copy_(0.1 * torch.randn(ln.bias.shape, generator=g, device="cuda"))
        image = randn(BATCH, *VOLUME)
        kw, s1, b1 = fold_patch_embed(emb, p, tp)
        args = [image, kw, s1, b1, emb[3].weight.float(), emb[3].bias.float()]
        names = ("out", "conv", "stats")
        got = dict(zip(names, _res_with_patches(*args, p, tp)[:3]))
        want = dict(zip(names, patch_embed_res_plain(*args, p, tp)))
        one = dict(zip(names, patch_embed_res_f32(*args, p, tp, one_pass=True)[:3]))
        abs_err = grads_check("patch_embed_res_f32", got, want, F32_BAND,
                              {"one bf16 product each (lo planes zeroed)": one},
                              f"fp32 {list(image.shape)} -> out, conv, stats")
        again = _res_with_patches(*args, p, tp)[:3]
        if not all(torch.equal(got[k], v) for k, v in zip(names, again)):
            raise AssertionError("patch_embed_res_f32: two calls differ")
        # the product on split4_kernel (a slice's four planes at once), no gemm_kernel
        hopper_chain_check("patch_embed_res_f32", lambda: _res_with_patches(*args, p, tp), card,
                           must=("split4_kernel", "patchify_f32_kernel", "pe_ln_f32_kernel"),
                           must_not=("gemm_kernel",))
        ms = cuda_ms(torch, lambda: _res_with_patches(*args, p, tp))
        plain_ms = cuda_ms(torch, lambda: patch_embed_res_plain(*args, p, tp))
        library = patch_library(emb, p, tp)
        lib_err = rel_err(library(image), want["out"])
        library_ms = library_time(torch, lambda: library(image))
        m, dim = got["conv"].shape
        k = kw.shape[0] * kw.shape[1]
        rec = bound(3 * 2 * m * k * dim, nbytes(image, *args[1:], *got.values()), BF16_PEAK)
        print(f"kernel patch_embed_res_f32: {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, three bf16 products), the fp32 "
              f"PyTorch chain {library_ms:.3f} ms ({library_ms.span}) (its output vs the plain "
              f"out: max_rel_err {lib_err:.3e}) [{card}]")
        out["patch_embed_res_f32"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **rec,
                                          library_ms=library_ms)

        dconv = randn(m, dim)
        planes = _res_with_patches(*args, p, tp)[3]
        got = patch_embed_dkw(image, dconv, p, tp, planes)
        want = patch_embed_dkw_plain(image, dconv, p, tp)
        same = (torch.equal(got, patch_embed_dkw(image, dconv, p, tp, planes))
                and torch.equal(got, patch_embed_dkw(image, dconv, p, tp)))
        one = patch_embed_dkw(image, dconv, p, tp, one_pass=True)
        abs_err = grads_check("patch_embed_dkw_f32", {"dkw": got}, {"dkw": want}, F32_BAND,
                              {"one bf16 product each (lo planes zeroed)": {"dkw": one}},
                              f"fp32 {list(image.shape)}, dconv {list(dconv.shape)} -> "
                              f"{list(got.shape)}; two calls and both forms the same bits: "
                              f"{same}")
        if not same:
            raise AssertionError("patch_embed_dkw_f32: two calls, or the call from the volume "
                                 "and the call from the forward's planes, differ")
        # the weight gradient on the staged walk, none of wgrad_kernel's three passes
        hopper_chain_check("patch_embed_dkw_f32",
                           lambda: patch_embed_dkw(image, dconv, p, tp, planes), card,
                           must=("wgrad4_kernel",), must_not=("wgrad_kernel", "gemm_kernel"))
        ms = cuda_ms(torch, lambda: patch_embed_dkw(image, dconv, p, tp, planes))
        vol_ms = cuda_ms(torch, lambda: patch_embed_dkw(image, dconv, p, tp))
        plain_ms = cuda_ms(torch, lambda: patch_embed_dkw_plain(image, dconv, p, tp))
        b, _, T, H, W = image.shape
        go = dconv.reshape(b, T // tp, H // p, W // p, dim).permute(0, 4, 1, 2, 3).contiguous()
        lib = torch.nn.grad.conv3d_weight(image, (dim, 1, tp, p, p), go, stride=(tp, p, p))
        lib_err = rel_err(lib.reshape(dim, k // p, p).permute(2, 1, 0), want)
        library_ms = library_time(torch, lambda: torch.nn.grad.conv3d_weight(
            image, (dim, 1, tp, p, p), go, stride=(tp, p, p)))
        rec = bound(3 * 2 * m * k * dim, nbytes(planes, dconv, got), BF16_PEAK)
        print(f"kernel patch_embed_dkw_f32: {ms:.3f} ms from the forward's P planes (the train "
              f"step's form; {vol_ms:.3f} ms from the volume) vs plain {plain_ms:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, three bf16 products), fp32 "
              f"torch.nn.grad.conv3d_weight {library_ms:.3f} ms ({library_ms.span}) (vs the "
              f"plain version: max_rel_err {lib_err:.3e}) [{card}]")
        out["patch_embed_dkw_f32"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **rec,
                                          library_ms=library_ms)
        del image, args, planes, dconv, got, want, one, go, lib
        torch.cuda.empty_cache()

        # rows 16 and 17 on fp32 tokens
        x = randn(BATCH, t, h, w, d)
        gr = randn(BATCH, t, h, w, d)
        weight = vit.enc_spatial_transformer.layers[0][0].dsconv.weight.detach()
        taps = taps_of(weight)
        pbias = 0.2 * randn(d)
        got = peg(x, taps, pbias, 2) - x
        want = peg_plain(x, taps, pbias, 2) - x
        controls = {"frame padding (1, 1)": rel_err(got, peg_plain(x, taps, pbias, 1) - x),
                    "no bias": rel_err(got, peg_plain(x, taps, None, 2) - x)}
        abs_err = band_check("peg_f32", got, want, PEG_F32_KERNEL_BAND, controls,
                             f"causal forward {list(x.shape)} fp32, branch max "
                             f"{want.abs().max().item():.3e}")
        tokens = x.reshape(BATCH, t * h * w, d)
        lib_err = rel_err(peg_residual(weight, pbias, tokens, (BATCH, t, h, w), True),
                          peg_plain(x, taps, pbias, 2).reshape(tokens.shape))
        ms = cuda_ms(torch, lambda: peg(x, taps, pbias, 2))
        plain_ms = cuda_ms(torch, lambda: peg_plain(x, taps, pbias, 2))
        library_ms = library_time(torch, lambda: peg_residual(weight, pbias, tokens,
                                                              (BATCH, t, h, w), True))
        npos = x.numel() // d
        rec = bound(2 * 27 * npos * d, nbytes(x, taps, pbias, x), FP32_PEAK)
        print(f"kernel peg_f32: {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), the fp32 NCDHW copy + F.conv3d + "
              f"copy {library_ms:.3f} ms ({library_ms.span}) (max_rel_err {lib_err:.3e}) "
              f"[{card}]")
        out["peg_f32"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **rec,
                              library_ms=library_ms)
        names = ("dw", "db")
        got = dict(zip(names, peg_weight_grads(x, gr, 2)))
        want = dict(zip(names, peg_weight_grads_plain(x, gr, 2)))
        again = peg_weight_grads(x, gr, 2)
        if not (torch.equal(got["dw"], again[0]) and torch.equal(got["db"], again[1])):
            raise AssertionError("peg_weight_grads (fp32): two calls on the same inputs differ")
        faulty = {"x shifted by one frame": {"dw": peg_weight_grads_plain(x.roll(1, 1), gr, 2)[0]},
                  "frame padding (1, 1)": {"dw": peg_weight_grads_plain(x, gr, 1)[0]}}
        abs_err = grads_check("peg_weight_grads_f32", got, want, PEG_WGRAD_BAND, faulty,
                              f"{list(x.shape)} fp32 -> dw, db (two calls bit-equal)")
        ms = cuda_ms(torch, lambda: peg_weight_grads(x, gr, 2))
        plain_ms = cuda_ms(torch, lambda: peg_weight_grads_plain(x, gr, 2))
        xc = F.pad(x.permute(0, 4, 1, 2, 3), (1, 1, 1, 1, 2, 0)).contiguous()
        gc = gr.permute(0, 4, 1, 2, 3).contiguous()
        lib_err = rel_err(torch.nn.grad.conv3d_weight(xc, (d, 1, 3, 3, 3), gc, groups=d),
                          want["dw"])
        library_ms = library_time(torch, lambda: torch.nn.grad.conv3d_weight(
            xc, (d, 1, 3, 3, 3), gc, groups=d))
        rec = bound(2 * 28 * npos * d, nbytes(x, gr, *got.values()), FP32_PEAK)
        print(f"kernel peg_weight_grads_f32: {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), fp32 "
              f"torch.nn.grad.conv3d_weight {library_ms:.3f} ms ({library_ms.span}) "
              f"(max_rel_err {lib_err:.3e}) [{card}]")
        out["peg_weight_grads_f32"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **rec,
                                           library_ms=library_ms)
    return out


def f32_train_run(torch, model, card: str, text_len: int, words: int, seed: int,
                  step_want: dict, label: str) -> tuple:
    """The fp32 train step on `model` (flagship width, peg_pallas=True, B =
    2) with reports of about `words` words padded to `text_len` tokens:
    one step's gradients from the same weights, batch, dropout draws and
    codes, the kernels against plain=True (every parameter's gradient within
    STEP_GRAD_BAND of that tensor's largest entry, its group's for the
    shift-invariant biases; the plain path quantising with the kernel path's
    codes, each index that flipped between the two forwards a tie within
    VQ_F32_TIE; control another batch's plain gradients outside the band in
    every parameter group); then CTClipTrainer.train() over 3 steps (the
    step-0 and end-of-epoch evaluations, a checkpoint) with `step_want`'s
    launches a step, the PEGs', 5f in the evaluations (and row 6, BERT's
    deterministic layer, where the reports meet the fused-layer gate),
    1f-4f, and every other counter at 0; the losses; three more steps
    timed. Returns (the gradient step's launch counts, the train run's)."""
    import tempfile

    from ct_clip_ut_tpu_torch.config import TrainConfig
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
    from ct_clip_ut_tpu_torch.models.bert import fused_layer_gate
    from ct_clip_ut_tpu_torch.models.ctclip import contrastive_loss, ctclip_apply
    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.train.trainer import CTClipTrainer

    cfg = model.cfg
    tcfg = TrainConfig(num_epochs=1, compute_dtype="float32", text_max_length=text_len)
    g = torch.Generator(device="cuda").manual_seed(seed)
    tok = WordTokenizer(cfg.bert.vocab_size)
    data = train_batches(torch, g, 4, words, dtype=torch.float32)

    def tokens(texts):
        enc = tok(texts, max_length=text_len)
        return {k: torch.as_tensor(v, device="cuda") for k, v in enc.items()}

    def grads(i, plain, against=None):
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(5)
        with VQRecorder(torch, against, replay=against is not None) as rec:
            out = ctclip_apply(model, tokens(data[i][1]), data[i][0], freeze_vq=False,
                               generator=gen, deterministic=False, plain=plain)
            loss = contrastive_loss(out.sim_matrix)
            loss.backward()
        got = {n: prm.grad.detach().clone() for n, prm in model.named_parameters()
               if prm.grad is not None}
        model.zero_grad(set_to_none=True)
        return loss.item(), got, rec

    launches.reset_launch_counts()
    loss_k, gk, rec_k = grads(0, False)
    step_counts = launches.launch_counts()
    loss_p, gp, rec_p = grads(0, True, rec_k)
    gc = grads(1, True)[1]
    flips, gaps = int(rec_p.flips().sum()), rec_p.gaps

    group_top = {}
    for n, v in gp.items():
        grp = param_group(n)
        group_top[grp] = max(group_top.get(grp, 0.0), v.abs().max().item())
    cpb = model.visual_transformer.spatial_rel_pos_bias.net
    shift_invariant = [n for n in gp if n.endswith("attention.self.key.bias")
                       or n == f"visual_transformer.spatial_rel_pos_bias.net.{len(cpb) - 1}.bias"]

    def err(a, n):
        b = gp[n]
        top = group_top[param_group(n)] if n in shift_invariant else b.abs().max().item()
        return (a - b).abs().max().item() / top

    errs = {n: err(gk[n], n) for n in gp}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    ctrl = {}
    for n in gp:
        grp = param_group(n)
        ctrl[grp] = max(ctrl.get(grp, 0.0), err(gc[n], n))
    real = tokens(data[0][1])["attention_mask"].sum(1).tolist()
    print(f"{label}: one step at B = {BATCH}, reports of {real} real tokens padded to "
          f"{text_len}, peg_pallas=True: loss {loss_k:.6f} (plain path {loss_p:.6f}, from the "
          f"kernel path's codes); {flips} VQ index flips between the two forwards (gaps "
          f"{[f'{v:.2e}' for v in gaps]}, tie band {VQ_F32_TIE}); gradients of {len(errs)} "
          f"parameters vs the plain path, max |diff| over the tensor's largest entry: max "
          f"{max(errs.values()):.3e} (band {STEP_GRAD_BAND}), worst "
          + ", ".join(f"{n} {v:.3e}" for n, v in worst)
          + f"; held against their group's largest entry: {len(shift_invariant)} "
          f"shift-invariant biases, max {max(errs[n] for n in shift_invariant):.3e}; "
          "controls (another batch) per group "
          + ", ".join(f"{k} {v:.3e}" for k, v in ctrl.items()) + f" [{card}]")
    print(f"{label}: launches of the step "
          + json.dumps({k: v for k, v in step_counts.items() if v}))
    if set(gk) != set(gp) or not all(torch.isfinite(v).all() for v in gk.values()):
        raise AssertionError("fp32 kernel-path gradients missing or non-finite")
    if any(not gap <= VQ_F32_TIE for gap in gaps):
        raise AssertionError(f"fp32 train step: a VQ flip that is no tie: {gaps}")
    bad = {n: v for n, v in errs.items() if not v <= STEP_GRAD_BAND}
    if bad:
        raise AssertionError(f"fp32 train gradients over the band {STEP_GRAD_BAND}: {bad}")
    blind = {k: v for k, v in ctrl.items() if not v > STEP_GRAD_BAND}
    if blind:
        raise AssertionError(f"fp32 train gradients: controls within the band {blind}")

    # CTClipTrainer.train(): 3 steps, the evaluations, a checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        trainer = CTClipTrainer(cfg, tcfg, tok, data[:3], data[3:], results_folder=tmp,
                                params=model, device="cuda")
        launches.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launches.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
    evals = len(trainer.valid_losses)
    print(f"{label}: CTClipTrainer.train() over 3 steps of {BATCH} x {list(VOLUME)} fp32 "
          f"volumes with {text_len}-token reports, peg_pallas=True, {evals} evaluations "
          f"and a checkpoint in {seconds:.3f} s (host clock; peak {peak:.2f} GB) [{card}]; step "
          f"losses {trainer.train_losses['steps']}, epoch {trainer.train_losses['epochs']}, "
          f"validation {trainer.valid_losses}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    losses = trainer.train_losses["steps"] + trainer.train_losses["epochs"] + trainer.valid_losses
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise AssertionError(f"non-finite fp32 train losses {losses}")
    pegs = cfg.ctvit.spatial_depth + cfg.ctvit.temporal_depth
    want = {k: 3 * v for k, v in step_want.items()}
    want.update({"peg": (2 * 3 + evals) * pegs, "patch_embed_f32": evals})
    if fused_layer_gate(cfg.bert, text_len):
        want["bert_layer"] = evals * cfg.bert.num_layers
    wrong = {k: counts[k] for k, v in want.items() if counts[k] != v}
    wrong.update({k: counts[k] for k in F32_TRAIN_FORWARD if counts[k] <= 0})
    bf16_or_dx = [k for k in counts if k not in (*want, *F32_TRAIN_FORWARD)]
    wrong.update({k: counts[k] for k in bf16_or_dx if counts[k] != 0})
    if wrong:
        raise AssertionError(f"fp32 train path launches {wrong}, expected {want}, "
                             f"{F32_TRAIN_FORWARD} > 0 and every other counter 0")

    state, step = trainer.state, trainer.train_step
    image, text = data[0][0], tokens(data[0][1])
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = step(state, image, text)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    print(f"{label}: make_train_step at B = {BATCH}: {', '.join(f'{v:.3f}' for v in ms)} ms "
          f"per step (host clock, synchronised; loss {loss.item():.6f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{card}]")
    return step_counts, counts


CLOSE_BAND = 1e-2   # the close-token stacks' query / key weight gradients and dx (F10, F11)
F11_FRAMES = 24     # one volume's frames of the flagship's 24 x 24 patches (spatial_close_check)
LONG_TEMPORAL = (16, 101)   # R, n: the temporal chain above the fused pass's n <= 64


def temporal_f32_check(torch, model, card: str) -> None:
    """Phase 14's checks of the temporal fp32 backward's routes (rows 8f /
    8F) and of the chunked block weight gradient (7F / 8F):
    - F10, close tokens: layers 0 and 1 of the temporal stack (residual,
      gains drawn by around_ones) over one volume's 576 sequences of 24
      tokens 2% apart (adjacent CT slices lie that close), a cotangent on
      each sequence's first token; each layer's query / key weight
      gradients and the stack's dx from the full fp32 chain (its fused
      pass, D = rowsum(P dP)), each propagating its own dx, within
      CLOSE_BAND of the plain backward's (TF32 off); the chain with its lo
      planes zeroed outside;
    - above n = 64 (LONG_TEMPORAL: the core with statistics, then the
      wgmma passes without a bias): dx alone and every gradient within
      F32_BAND of the plain backward, the same bits on two calls, dx the
      dx-only chain's; the one-pass control outside;
    - the weight gradient of the B = 2 step's temporal block (27,648
      tokens, D = 512, HD = 256) in its chunks (block_wgrad_partition)
      against the same chain with one chunk (each tile over every token):
      within F32_BAND, the same bits on two calls, both timed."""
    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops import attn_block as ab
    from ct_clip_ut_tpu_torch.ops.attn_packed import (attn_packed_bwd, attn_packed_bwd_f32,
                                                      attn_packed_bwd_plain, attn_packed_plain)

    vit = model.visual_transformer
    d = vit.cfg.dim
    t, h, w = token_grid_shape(vit.cfg, VOLUME)
    g = torch.Generator(device="cuda").manual_seed(22)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def layer(i):
        a = vit.enc_temporal_transformer.layers[i][1]
        inner = a.cfg.inner_dim
        wkv = a.to_kv.weight.detach().float()
        return [around_ones(torch, g, d), a.to_q.weight.detach().float(),
                wkv[:inner].contiguous(), wkv[inner:].contiguous(),
                a.to_out.weight.detach().float(), around_ones(torch, g, a.cfg.dim_head),
                around_ones(torch, g, a.cfg.dim_head)]

    scale = vit.enc_temporal_transformer.layers[0][1].cfg.scale
    ws = [layer(0), layer(1)]
    with torch.no_grad():
        x0 = randn(h * w, 1, d) + 0.02 * randn(h * w, t, d)
        cot = torch.zeros_like(x0)
        cot[:, 0] = randn(h * w, d)
        xs = [x0, attn_packed_plain(x0, *ws[0], scale, True)]

        def stack(fn):
            """[dWq, dWk of layer 1, of layer 0, dx], each layer's chain
            propagating its own dx."""
            dout, out = cot, []
            for i in (1, 0):
                grads = fn(xs[i], *ws[i], dout, scale, True)
                out += [grads[2], grads[3]]
                dout = grads[0]
            return out + [dout]

        want = stack(attn_packed_bwd_plain)
        got = stack(attn_packed_bwd)
        one = stack(lambda *a: attn_packed_bwd(*a, one_pass=True))
    names = ("dWq layer 1", "dWk layer 1", "dWq layer 0", "dWk layer 0", "dx")
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    one_errs = [rel_err(a, b) for a, b in zip(one, want)]
    print(f"kernel attn_packed_bwd_f32_full: F10 close tokens (two temporal blocks, "
          f"[{h * w}, {t}, {d}] tokens 2% apart, a cotangent on the first token) vs the plain "
          f"backward, max_rel_err " + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
          + f" (band {CLOSE_BAND}); one bf16 product each "
          + ", ".join(f"{e:.3e}" for e in one_errs) + f" [{card}]")
    if max(errs) > CLOSE_BAND or not max(one_errs) > CLOSE_BAND:
        raise AssertionError(f"F10 close tokens: {errs}, the control {one_errs}")
    del xs, got, want, one
    torch.cuda.empty_cache()

    # above the fused pass: the core with statistics and the wgmma passes
    r, n = LONG_TEMPORAL
    x, gg = randn(r, n, d), randn(r, n, d)
    tm = ws[0]
    with torch.no_grad():
        dx = attn_packed_bwd_f32(x, *tm, gg, scale, True)
        full = attn_packed_bwd(x, *tm, gg, scale, True)
        want = attn_packed_bwd_plain(x, *tm, gg, scale, True)
        same = (torch.equal(dx, attn_packed_bwd_f32(x, *tm, gg, scale, True))
                and all(torch.equal(a, b) for a, b in zip(full, attn_packed_bwd(
                    x, *tm, gg, scale, True))) and torch.equal(full[0], dx))
        errs = [rel_err(a, b) for a, b in zip(full, want)]
        one = [rel_err(a, b) for a, b in zip(attn_packed_bwd(x, *tm, gg, scale, True,
                                                             one_pass=True), want)]
    print(f"kernel attn_packed_bwd_f32: n = {n} > 64 ([{r}, {n}, {d}], the fp32 core and the "
          f"wgmma passes without a bias), every gradient max_rel_err "
          + ", ".join(f"{e:.3e}" for e in errs) + f" (band {F32_BAND}); two calls the same "
          f"bits, dx the dx-only chain's: {same}; one bf16 product each max {max(one):.3e} "
          f"[{card}]")
    if max(errs) > F32_BAND or not same or not max(one) > F32_BAND:
        raise AssertionError(f"the temporal chain at n = {n}: {errs}, same bits {same}, "
                             f"control {one}")

    # the weight gradient in chunks against one chunk
    r = BATCH * h * w
    chunk, chunks = ab.block_wgrad_partition(r * t, d, tm[1].shape[0])
    x, gg = randn(r, t, d), randn(r, t, d)
    split = ab.block_wgrad_partition
    with torch.no_grad():
        got = attn_packed_bwd(x, *tm, gg, scale, True)
        same = all(torch.equal(a, b) for a, b in zip(got, attn_packed_bwd(x, *tm, gg, scale,
                                                                          True)))
        ms = cuda_ms(torch, lambda: attn_packed_bwd(x, *tm, gg, scale, True))
        ab.block_wgrad_partition = lambda *a, **k: (0, 1)
        try:
            whole = attn_packed_bwd(x, *tm, gg, scale, True)
            whole_ms = cuda_ms(torch, lambda: attn_packed_bwd(x, *tm, gg, scale, True))
        finally:
            ab.block_wgrad_partition = split
    errs = [rel_err(got[i], whole[i]) for i in (2, 3, 4, 5)]
    print(f"kernel attn_packed_bwd_f32_full: BlockWgradSplitPlan over {r * t} tokens in "
          f"{chunks} chunks of {chunk} slices ({chunks} x 32 blocks) vs one chunk (32 blocks): "
          f"dWq, dWk, dWv, dWo max_rel_err " + ", ".join(f"{e:.3e}" for e in errs)
          + f"; two calls the same bits: {same}; the full chain {ms:.3f} ms chunked, "
          f"{whole_ms:.3f} ms with one chunk [{card}]")
    if max(errs) > F32_BAND or not same or chunks < 3:
        raise AssertionError(f"the chunked weight gradient: {errs}, same bits {same}, "
                             f"{chunks} chunks")


def block_f64(torch, x, gamma, wq, wk, wv, wo, qs, ks, bias, scale: float):
    """The residual attention block in float64 (two-pass LayerNorm moments),
    independent of attn_block_plain: x + Wo attention(l2norm(LN(x) Wq^T)
    qs scale, l2norm(x Wk^T) ks, x Wv^T, + bias)."""
    r, n, _ = x.shape
    dh = qs.shape[0]
    heads = wq.shape[0] // dh

    def heads_of(t):
        return t.reshape(r, n, heads, dh).transpose(1, 2)

    mean = x.mean(-1, keepdim=True)
    xn = (x - mean) * torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + 1e-5) * gamma
    q, k, v = heads_of(xn @ wq.t()), heads_of(x @ wk.t()), heads_of(x @ wv.t())
    q = q / q.norm(dim=-1, keepdim=True) * (qs * scale)
    k = k / k.norm(dim=-1, keepdim=True) * ks
    p = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
    return x + (p @ v).transpose(1, 2).reshape(r, n, heads * dh) @ wo.t()


def spatial_close_grads(torch, model) -> dict:
    """F11's stack: layers 0 and 1 of the spatial transformer (residual, the
    CPB bias of the flagship's 24 x 24 patches, gains drawn by around_ones)
    over F11_FRAMES frames of patches 2% apart (adjacent patches of a frame
    lie that close), a cotangent on each frame's first patch. Returns, for the
    float64 block (block_f64, each layer at the fp32 chain's own input and
    the float64 dx of the layer above), the plain fp32 backward (TF32 off),
    the full fp32 chain rerunning the forward core, the chain from the
    statistics the fp32 forward kept (the train step's form) and the
    one-pass control, [dWq, dWk of layer 1, of layer 0, dx], each backward
    propagating its own dx."""
    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.ops.attn_block import (attn_block, attn_block_bwd,
                                                     attn_block_bwd_plain, attn_block_plain)
    from ct_clip_ut_tpu_torch.ops.posbias import continuous_pos_bias

    vit = model.visual_transformer
    d = vit.cfg.dim
    _, h, w = token_grid_shape(vit.cfg, VOLUME)
    scale = vit.enc_spatial_transformer.layers[0][1].cfg.scale
    g = torch.Generator(device="cuda").manual_seed(23)

    def layer(i):
        a = vit.enc_spatial_transformer.layers[i][1]
        inner = a.cfg.inner_dim
        wkv = a.to_kv.weight.detach().float()
        return [around_ones(torch, g, d), a.to_q.weight.detach().float(),
                wkv[:inner].contiguous(), wkv[inner:].contiguous(),
                a.to_out.weight.detach().float(), around_ones(torch, g, a.cfg.dim_head),
                around_ones(torch, g, a.cfg.dim_head)]

    ws = [layer(0), layer(1)]
    with torch.no_grad():
        bias = continuous_pos_bias(vit.spatial_rel_pos_bias, h, w).float().contiguous()
        x0 = (torch.randn((F11_FRAMES, 1, d), generator=g, device="cuda")
              + 0.02 * torch.randn((F11_FRAMES, h * w, d), generator=g, device="cuda"))
        cot = torch.zeros_like(x0)
        cot[:, 0] = torch.randn((F11_FRAMES, d), generator=g, device="cuda")
        xs = [x0, attn_block_plain(x0, *ws[0], bias, scale, True)]
        kept = [attn_block(x, *wl, bias, scale, True, keep=True)[1] for x, wl in zip(xs, ws)]

    def f64(x, *args):
        dout = args[-3]
        leaves = [t.double().requires_grad_() for t in (x, *args[:7])]
        with torch.enable_grad():
            y = block_f64(torch, *leaves, bias.double(), scale)
            return torch.autograd.grad(y, leaves, dout.double())

    def stack(fn, **kw):
        dout, out = cot, []
        for i in (1, 0):
            grads = fn(xs[i], *ws[i], bias, dout, scale, True,
                       **{k: v[i] for k, v in kw.items()})
            out += [grads[2], grads[3]]
            dout = grads[0]
        return out + [dout]

    with torch.no_grad():
        return {"float64": stack(f64), "plain": stack(attn_block_bwd_plain),
                "chain": stack(attn_block_bwd), "chain, kept": stack(attn_block_bwd, saved=kept),
                "one_pass": stack(lambda *a: attn_block_bwd(*a, one_pass=True))}


def spatial_close_check(torch, model, card: str) -> None:
    """F11 in phase 14: spatial_close_grads over one volume's 24 frames of
    576 patches. The plain fp32 backward and the full fp32 chain (the row
    term's walk, D = c + rowsum(P (dP - c)) / rowsum(P) from the same split
    S and dP, c each row's dP at key 0, then the wgmma passes), rerunning
    the forward core or from the statistics the forward kept, each within
    CLOSE_BAND of float64 in every gradient, the one-pass control outside.
    (On the H100 the walk's first form, D = rowsum(P dP) summed in order
    with P from the forward's 1 / l, read 3.9e-2 here, plain fp32 5.3e-3.)"""
    got = spatial_close_grads(torch, model)
    ref = got.pop("float64")
    errs = {k: [rel_err(a, b) for a, b in zip(v, ref)] for k, v in got.items()}
    names = ("dWq layer 1", "dWk layer 1", "dWq layer 0", "dWk layer 0", "dx")
    print(f"kernel attn_block_bwd_f32_full: F11 close tokens (two spatial blocks with the "
          f"bias, [{F11_FRAMES}, {ref[-1].shape[1]}, {ref[-1].shape[2]}] patches 2% apart, "
          f"a cotangent on each frame's first patch) vs float64, max_rel_err "
          + "; ".join(f"{k}: " + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, v))
                      for k, v in errs.items())
          + f" (band {CLOSE_BAND}); the chain vs the plain backward "
          + ", ".join(f"{rel_err(a, b):.3e}" for a, b in zip(got["chain"], got["plain"]))
          + f" [{card}]")
    if (max(max(errs[k]) for k in ("plain", "chain", "chain, kept")) > CLOSE_BAND
            or not max(errs["one_pass"]) > CLOSE_BAND):
        raise AssertionError(f"F11 close tokens: {errs}")


def f32_train_phase(torch, card: str) -> tuple:
    """Phase 14: the fp32 train step at 120-token reports, at flagship width
    with peg_pallas=True, B = 2 (TrainConfig(compute_dtype="float32",
    text_max_length=120): BERT unfused under its n >= 128 gate, as in JAX;
    the CT-ViT on its fp32 kernels both ways). First f32_train_check and
    temporal_f32_check, then f32_train_run: one step's gradients against plain=True and
    CTClipTrainer.train() over 3 steps with the launches of each step
    (F32_TRAIN_STEP), 1f-4f, 5f in the evaluations, 16, and no bf16 kernel
    or dx-only chain. Returns (kernel record, launch counts of the train
    run, the model for phase 15)."""
    from ct_clip_ut_tpu_torch.config import flagship_cfg, replace
    from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip

    t_phase = time.perf_counter()
    cfg = flagship_cfg()
    cfg = replace(cfg, ctvit=replace(cfg.ctvit, peg_pallas=True))
    model = init_ctclip(cfg, seed=0, device="cuda")
    record = f32_train_check(torch, model, card)
    temporal_f32_check(torch, model, card)
    spatial_close_check(torch, model, card)
    _, counts = f32_train_run(torch, model, card, EARLIER_TEXT_LEN, 40, 20, F32_TRAIN_STEP,
                              "train fp32")
    print(f"train fp32: phase 14 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return record, counts, model


def bert_library(x, pad, w, heads: int, eps: float, p: float):
    """The fp32 BERT layer as PyTorch calls the port never makes (TF32 off),
    the yardstick of rows 6F and, under autograd, 12F: F.linear (Wqkv),
    F.scaled_dot_product_attention with the additive key mask and dropout_p
    = p, F.linear (Wo), F.dropout, + x, F.layer_norm, F.linear (W1), exact
    F.gelu, F.linear (W2), F.dropout, + y, F.layer_norm. Its dropout draws
    its own masks: the same function, not the same draws."""
    import torch.nn.functional as F

    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = w
    b, n, d = x.shape
    q, k, v = (t.reshape(b, n, heads, d // heads).transpose(1, 2)
               for t in F.linear(x, wqkv, bqkv).split(d, dim=-1))
    mask = (pad.float() * -1e30)[:, None, None, :]
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=p)
    ctx = ctx.transpose(1, 2).reshape(b, n, d)
    y = F.layer_norm(F.dropout(F.linear(ctx, wo, bo), p) + x, (d,), g1, be1, eps)
    h = F.gelu(F.linear(y, w1, b1))
    return F.layer_norm(F.dropout(F.linear(h, w2, b2), p) + y, (d,), g2, be2, eps)


def bert_f32_train_check(torch, model, card: str) -> dict:
    """Phase 15's kernel checks: rows 6F (the fp32 BERT layer in train mode,
    dropout 0.1 / 0.1 at the three sites) and 12F (its fp32 backward, dx and
    the twelve parameter gradients) at the shapes of a B = 2, 512-token fp32
    train step: x [2, 512, 768] fp32, 12 heads, F = 3072, one sequence
    padded after 300 tokens, layer 0's weights with the LN gains drawn as 1
    + 0.1 N and biases as 0.1 N. Against bert_layer_plain /
    bert_layer_bwd_plain through the same Philox masks within F32_BAND.
    Controls: the chains with every lo plane zeroed (one bf16 product each),
    masks from other seeds, the attention site left out (forward); the plain
    backward's three faults (the attention keep left out of dp, the post-FF
    keep left out of do2, the dropped probabilities in ds). Two calls the
    same bits; train mode at rate 0 (both thresholds 0) row 6's bits. 12F
    through the train step's route (bert_layer_grad under autograd: the
    forward keeps its state, the backward starts from it) against the
    direct call that reruns the forward, bit for bit, with one attention
    core a layer in its profile and no three-pass gemm_kernel. Times (12F
    from the kept state, as the step runs it; the rerun printed beside),
    bound_ms (three bf16 products at the bf16 peak, the attention over the
    real keys; 12F's bound counts the backward, twice the forward),
    library_ms: bert_library forward (6F) and forward + backward with x and
    every parameter wanting its gradient (12F)."""
    from ct_clip_ut_tpu_torch.models.bert import layer_args
    from ct_clip_ut_tpu_torch.ops.bert_layer import (bert_layer, bert_layer_bwd,
                                                     bert_layer_bwd_f32, bert_layer_bwd_plain,
                                                     bert_layer_fp32, bert_layer_grad,
                                                     bert_layer_plain)

    bcfg = model.cfg.bert
    d, heads, eps = bcfg.hidden_size, bcfg.num_heads, bcfg.layer_norm_eps
    pa, ph = bcfg.attention_dropout, bcfg.hidden_dropout
    b, n = BATCH, TEXT_LEN
    g = torch.Generator(device="cuda").manual_seed(23)
    lengths = torch.tensor([n, 300], device="cuda")
    pad = torch.arange(n, device="cuda")[None, :] >= lengths[:, None]
    mask_row = pad.float() * torch.finfo(torch.float32).min
    x = torch.randn((b, n, d), generator=g, device="cuda")
    w = [t.detach().clone() for t in layer_args(model.text_transformer.encoder.layer[0])]
    for i in (4, 10):                                  # LN gains
        w[i] = around_ones(torch, g, d)
    for i in (5, 11):                                  # LN biases
        w[i] = 0.1 * torch.randn((d,), generator=g, device="cuda")
    f = w[6].shape[0]
    seeds = torch.tensor([20231, 77, 1 << 30], dtype=torch.int32, device="cuda")
    args = [x, mask_row, *w]
    train = dict(p_attn=pa, p_hidden=ph, train=True, seeds=seeds)
    other = {**train, "seeds": seeds + 1}
    real_keys = int(lengths.sum())
    forward_flops = 2 * b * n * d * (3 * d + d + 2 * f) + 4 * n * d * real_keys
    wbytes = 4 * (4 * d * d + 2 * d * f + 3 * d + d + f + 5 * d)
    out = {}

    with torch.no_grad():
        got = bert_layer(*args, heads, eps, **train)
        want = bert_layer_plain(*args, heads, eps, **train)
        controls = {
            "one bf16 product each (lo planes zeroed)":
                rel_err(bert_layer_fp32(*args, heads, eps, **train, one_pass=True), want),
            "masks from other seeds": rel_err(got, bert_layer_plain(*args, heads, eps, **other)),
            "attention site left out": rel_err(got, bert_layer_plain(
                *args, heads, eps, **{**train, "p_attn": 0.0}))}
        abs_err = band_check("bert_layer_f32_train", got, want, F32_BAND, controls,
                             f"train fp32 {list(x.shape)}, p = {pa} / {ph}, {real_keys} real keys")
        same = torch.equal(got, bert_layer(*args, heads, eps, **train))
        zero = bert_layer_fp32(*args, heads, eps, p_attn=0.0, p_hidden=0.0, train=True,
                               seeds=seeds)
        row6 = torch.equal(zero, bert_layer(*args, heads, eps))
        print(f"kernel bert_layer_f32_train: two calls the same bits: {same}; train mode at rate "
              f"0 (thresholds 0) row 6's bits: {row6}")
        if not (same and row6):
            raise AssertionError("bert_layer_f32_train: two calls differ, or thresholds 0 move "
                                 "row 6's bits")
        ms = cuda_ms(torch, lambda: bert_layer(*args, heads, eps, **train))
        plain_ms = cuda_ms(torch, lambda: bert_layer_plain(*args, heads, eps, **train))
        lib_err = rel_err(bert_library(x, pad, w, heads, eps, 0.0)[~pad],
                          bert_layer_plain(*args, heads, eps)[~pad])
        library_ms = library_time(torch, lambda: bert_library(x, pad, w, heads, eps, pa))
    rec = bound(3 * forward_flops, nbytes(x, mask_row, seeds, got) + wbytes, BF16_PEAK)
    print(f"kernel bert_layer_f32_train: {ms:.3f} ms vs plain {plain_ms:.3f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, three bf16 products each, "
          f"{real_keys} real keys), the fp32 PyTorch chain (TF32 off, SDPA with dropout "
          f"{pa}) {library_ms:.3f} ms ({library_ms.span}) (at p = 0 its real rows vs the plain "
          f"version: max_rel_err {lib_err:.3e}) [{card}]")
    out["bert_layer_f32_train"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **rec,
                                       library_ms=library_ms)

    names = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dg1", "dbe1", "dw1", "db1", "dw2", "db2",
             "dg2", "dbe2")
    dout = torch.randn((b, n, d), generator=g, device="cuda")
    with torch.no_grad():
        got = dict(zip(names, bert_layer_bwd(*args, dout, heads, eps, **train)))
        want = dict(zip(names, bert_layer_bwd_plain(*args, dout, heads, eps, **train)))
        faulty = {"one bf16 product each (lo planes zeroed)": dict(zip(names, bert_layer_bwd_f32(
                      *args, dout, heads, eps, **train, one_pass=True))),
                  "masks from other seeds": dict(zip(names, bert_layer_bwd_plain(
                      *args, dout, heads, eps, **other)))}
        for fault, label in (("no_attn_keep", "attention keep mask left out of dp"),
                             ("no_hidden_keep", "post-FF keep mask left out"),
                             ("p_used_in_ds", "p_used for p in ds")):
            faulty[label] = dict(zip(names, bert_layer_bwd_plain(
                *args, dout, heads, eps, **train, faults=(fault,))))
        again = bert_layer_bwd(*args, dout, heads, eps, **train)
        same = [nm for nm, y in zip(names, again) if torch.equal(got[nm], y)]
    abs_err = grads_check("bert_layer_bwd_f32", got, want, F32_BAND, faulty,
                          f"train fp32 {list(x.shape)} vs the plain backward through the same "
                          f"masks; two calls the same bits in {len(same)} of {len(names)}")
    if len(same) != len(names):
        raise AssertionError(f"bert_layer_bwd_f32: gradients differ between two calls: "
                             f"{sorted(set(names) - set(same))}")
    # the train step's route: under autograd the forward keeps its state and
    # the backward starts from it, where the direct call above reran the
    # forward: the same bits, one attention core (the forward's) a step
    xg = x.detach().clone().requires_grad_(True)
    wg = [t.detach().clone().requires_grad_(True) for t in w]

    def train_route():
        out_ = bert_layer_grad(xg, mask_row, *wg, heads, eps, **train)
        return torch.autograd.grad(out_, [xg, *wg], dout)

    kept = dict(zip(names, train_route()))
    kept_same = [nm for nm in names if torch.equal(kept[nm], got[nm])]
    print(f"kernel bert_layer_bwd_f32: the train route (bert_layer_grad under autograd) from the "
          f"kept state: the rerun route's bits in {len(kept_same)} of {len(names)} gradients")
    if len(kept_same) != len(names):
        raise AssertionError(f"bert_layer_bwd_f32: the kept route differs from the rerun in "
                             f"{sorted(set(names) - set(kept_same))}")
    hopper_chain_check("bert_layer_bwd_f32 (the train route: forward with its state kept, "
                       "backward)", train_route, card,
                       must=("split4_64_kernel", "split4_32_kernel", "dkv_f32_kernel",
                             "wgrad4_kernel"), must_not=("gemm_kernel",),
                       launches={"attn_kernel": 1})
    with torch.no_grad():
        state = bert_layer_fp32(*args, heads, eps, **train, keep=True)[1]
        ms = cuda_ms(torch, lambda: bert_layer_bwd(*args, dout, heads, eps, **train,
                                                   saved=state))
        rerun_ms = cuda_ms(torch, lambda: bert_layer_bwd(*args, dout, heads, eps, **train))
        plain_ms = cuda_ms(torch, lambda: bert_layer_bwd_plain(*args, dout, heads, eps, **train))
        del state
    library_ms, lib_grads = library_grad_ms(
        torch, lambda xl, *wl: bert_library(xl, pad, wl, heads, eps, pa), [x, *w], dout)
    rec = bound(6 * forward_flops, nbytes(x, mask_row, seeds, dout, *got.values()) + wbytes,
                BF16_PEAK)
    print(f"kernel bert_layer_bwd_f32: {ms:.3f} ms from the kept state ({rerun_ms:.3f} ms "
          f"rerunning the forward) vs plain {plain_ms:.3f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}, the backward as three bf16 products each), the fp32 PyTorch "
          f"chain forward + backward (x and every parameter wanting its gradient, dropout {pa}) "
          f"{library_ms:.3f} ms ({library_ms.span}) [{card}]")
    out["bert_layer_bwd_f32"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **rec,
                                     library_ms=library_ms)
    del lib_grads
    return out


BERT_CLOSE_LENGTHS = (512, 300)   # real tokens of the two sequences of bert_close_check


def bert_f64(torch, x, mask_row, w, heads: int, eps: float, keeps):
    """One post-LN BERT layer in float64 (two-pass LayerNorm moments, exact
    GELU), independent of bert_layer_plain: the additive key mask, the
    attention keep factors on the probabilities after the softmax and the
    hidden sites' on each sublayer's output before its residual, `keeps`
    = (attention [B, heads, n, n], post-attention, post-FF [B, n, D])."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = w
    ka, k1, k2 = keeps
    b, n, d = x.shape
    dh = d // heads

    def ln(r, gamma, beta):
        mean = r.mean(-1, keepdim=True)
        return (r - mean) * torch.rsqrt(((r - mean) ** 2).mean(-1, keepdim=True) + eps) \
            * gamma + beta

    q, k, v = ((x @ wqkv.t() + bqkv)[..., i * d:(i + 1) * d].reshape(b, n, heads, dh)
               .transpose(1, 2) for i in range(3))
    p = torch.softmax(q @ k.transpose(-1, -2) / dh ** 0.5 + mask_row[:, None, None, :], dim=-1)
    ctx = ((p * ka) @ v).transpose(1, 2).reshape(b, n, d)
    y = ln((ctx @ wo.t() + bo) * k1 + x, g1, be1)
    h = y @ w1.t() + b1
    h = 0.5 * h * (1.0 + torch.erf(h / 2 ** 0.5))
    return ln((h @ w2.t() + b2) * k2 + y, g2, be2)


def bert_close_grads(torch, model, dropout: bool) -> dict:
    """F12's stack: layers 0 and 1 of the text transformer in train mode
    (with `dropout` the config's 0.1 / 0.1 at the three sites, each layer's
    own seeds, else rate 0; LN gains drawn by around_ones, LN biases 0.1 N)
    over [2, 512, 768] tokens whose
    rows lie 2% apart (each sequence's common part plus 0.02 N), the second
    sequence's keys padded after BERT_CLOSE_LENGTHS[1], a cotangent on each
    sequence's first token ([CLS], the latent's row). Returns, for the
    float64 layer (bert_f64 at each layer's fp32 input, through the same
    Philox keep factors, the float64 dx of the layer above), the plain fp32
    backward, 12F rerunning the forward, 12F from the state the train
    forward kept and the one-pass control, [dWq, dWk of layer 1, of layer
    0, dx], each backward propagating its own dx."""
    from ct_clip_ut_tpu_torch.models.bert import layer_args
    from ct_clip_ut_tpu_torch.ops.bert_layer import (bert_layer_bwd, bert_layer_bwd_f32,
                                                     bert_layer_bwd_plain, bert_layer_fp32,
                                                     bert_layer_plain, philox_keep)

    bcfg = model.cfg.bert
    d, heads, eps = bcfg.hidden_size, bcfg.num_heads, bcfg.layer_norm_eps
    pa, ph = (bcfg.attention_dropout, bcfg.hidden_dropout) if dropout else (0.0, 0.0)
    b, n = len(BERT_CLOSE_LENGTHS), max(BERT_CLOSE_LENGTHS)
    g = torch.Generator(device="cuda").manual_seed(29)
    lengths = torch.tensor(BERT_CLOSE_LENGTHS, device="cuda")
    pad = torch.arange(n, device="cuda")[None, :] >= lengths[:, None]
    mask_row = pad.float() * torch.finfo(torch.float32).min

    def layer(i):
        w = [t.detach().clone() for t in layer_args(model.text_transformer.encoder.layer[i])]
        for j in (4, 10):
            w[j] = around_ones(torch, g, d)
        for j in (5, 11):
            w[j] = 0.1 * torch.randn((d,), generator=g, device="cuda")
        return w

    ws = [layer(0), layer(1)]
    train = [dict(p_attn=pa, p_hidden=ph, train=True,
                    seeds=torch.tensor([20231 + i, 77 + i, (1 << 30) + i], dtype=torch.int32,
                                     device="cuda")) for i in range(2)]
    with torch.no_grad():
        x0 = (torch.randn((b, 1, d), generator=g, device="cuda")
              + 0.02 * torch.randn((b, n, d), generator=g, device="cuda"))
        cot = torch.zeros_like(x0)
        cot[:, 0] = torch.randn((b, d), generator=g, device="cuda")
        xs = [x0, bert_layer_plain(x0, mask_row, *ws[0], heads, eps, **train[0])]
        kept = [bert_layer_fp32(x, mask_row, *wl, heads, eps, **tr, keep=True)[1]
                for x, wl, tr in zip(xs, ws, train)]

    def f64(x, mask, *args, seeds, **_):
        *w, dout = args[:13]
        keeps = (philox_keep(seeds, 0, b, heads, n * n, pa).reshape(b, heads, n, n),
                 *(philox_keep(seeds, s, b, 1, n * d, ph).reshape(b, n, d) for s in (1, 2)))
        leaves = [t.double().requires_grad_() for t in (x, *w)]
        with torch.enable_grad():
            y = bert_f64(torch, leaves[0], mask.double(), leaves[1:], heads, eps,
                         [t.double() for t in keeps])
            return torch.autograd.grad(y, leaves, dout.double())

    def stack(fn, **kw):
        dout, out = cot, []
        for i in (1, 0):
            grads = fn(xs[i], mask_row, *ws[i], dout, heads, eps, **train[i],
                       **{k: v[i] for k, v in kw.items()})
            out += [grads[1][:d], grads[1][d:2 * d]]
            dout = grads[0]
        return out + [dout]

    with torch.no_grad():
        got = {"float64": stack(f64), "plain": stack(bert_layer_bwd_plain),
               "12F rerunning": stack(bert_layer_bwd),
               "12F, kept": stack(bert_layer_bwd, saved=kept),
               "one_pass": stack(lambda *a, **k: bert_layer_bwd_f32(*a, **k, one_pass=True))}
    del kept
    return got


def bert_close_check(torch, model, card: str) -> None:
    """F12 in phase 15: bert_close_grads at rate 0 and with dropout. The
    plain fp32 backward and row 12F (the row term's walk, D = c + rowsum(P
    (keep dP - c)) / rowsum(P) from the same split S and dP, c each row's
    dP at key 0 as a kept key gives it), rerunning the forward and from the
    state the train forward kept (the same bits), each within CLOSE_BAND of
    float64 in every gradient; the one-pass chain outside it at rate 0,
    where the gradients cancel (with dropout the keep factors part the
    close rows' dP, and the one-pass chain's reading is printed)."""
    names = ("dWq layer 1", "dWk layer 1", "dWq layer 0", "dWk layer 0", "dx")
    for dropout in (False, True):
        got = bert_close_grads(torch, model, dropout)
        ref = got.pop("float64")
        errs = {k: [rel_err(a, b) for a, b in zip(v, ref)] for k, v in got.items()}
        same = all(torch.equal(a, b) for a, b in zip(got["12F rerunning"], got["12F, kept"]))
        mode = "dropout 0.1 / 0.1" if dropout else "rate 0"
        print(f"kernel bert_layer_bwd_f32: F12 close tokens, {mode} (two BERT layers, "
              f"{list(ref[-1].shape)} tokens 2% apart, keys padded after "
              f"{BERT_CLOSE_LENGTHS[1]} in the second sequence, a cotangent on each [CLS]) vs "
              f"float64, max_rel_err "
              + "; ".join(f"{k}: " + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, v))
                          for k, v in errs.items())
              + f" (band {CLOSE_BAND}); 12F vs the plain backward "
              + ", ".join(f"{rel_err(a, b):.3e}"
                          for a, b in zip(got["12F rerunning"], got["plain"]))
              + f"; kept and rerun routes the same bits: {same} [{card}]")
        if (max(max(errs[k]) for k in ("plain", "12F rerunning", "12F, kept")) > CLOSE_BAND
                or not (dropout or max(errs["one_pass"]) > CLOSE_BAND) or not same):
            raise AssertionError(f"F12 close tokens, {mode}: {errs}, kept == rerun: {same}")
        del got, ref


def bert_f32_train_phase(torch, model, card: str) -> tuple:
    """Phase 15: the fp32 train step at the TrainConfig default 512-token
    reports (TrainConfig(compute_dtype="float32")), on phase 14's model
    (flagship width, peg_pallas=True, B = 2): BERT's 12 layers through rows
    6F and 12F, the CT-ViT through phase 14's fp32 kernels. First
    bert_f32_train_check; then f32_train_run at 512 tokens (reports of ~300
    words): one step's gradients against plain=True, CTClipTrainer.train()
    over 3 steps with F32_TRAIN_STEP and BERT_F32_STEP launches a step, row
    6 in the evaluations, no bf16 BERT kernel; three more steps timed.
    Returns (kernel record, launch counts of the train run)."""
    t_phase = time.perf_counter()
    record = bert_f32_train_check(torch, model, card)
    bert_close_check(torch, model, card)
    step_counts, counts = f32_train_run(torch, model, card, TEXT_LEN, 300, 21,
                                        {**F32_TRAIN_STEP, **BERT_F32_STEP}, "train fp32 512")
    got = {k: step_counts[k] for k in BERT_F32_STEP}
    if got != BERT_F32_STEP:
        raise AssertionError(f"the fp32 512-token step launched {got}, expected {BERT_F32_STEP}")
    print(f"train fp32 512: phase 15 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return record, counts


def int8_plain_steps(torch, x, args, xq=None, rx=None) -> dict:
    """geglu_ff_int8_plain's steps on x [N, D] with args (gamma, beta, wv_q,
    wg_q, w2_q, sv, sg, s2): xn and its codes (xi, its scales rx_p), then h
    from the codes `xq` / `rx` where given (a kernel's: the plain h from the
    same codes) or else from its own, and h's codes (hi, rh_p)."""
    from ct_clip_ut_tpu_torch.ops.geglu_ff_int8 import int8_dot, row_quant

    gamma, beta, wv, wg, _, sv, sg, _ = args
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mean * mean
    xn = (x32 - mean) * torch.rsqrt(var.clamp_min(0.0) + 1e-5) * gamma + beta
    xi, rx_p = row_quant(xn)
    codes, scale = (xi, rx_p) if xq is None else (xq, rx.reshape(-1, 1))
    value = int8_dot(codes, wv).float() * scale * sv
    gate = int8_dot(codes, wg).float() * scale * sg
    h = 0.5 * gate * (1.0 + torch.erf(gate * 0.7071067811865476)) * value
    hi, rh_p = row_quant(h)
    return dict(xn=xn, xi=xi, rx=rx_p, h=h, hi=hi, rh=rh_p)


def code_flips(codes, want, quotient) -> tuple:
    """(codes that differ from `want`, the largest distance of their plain
    quotient from a .5 boundary in code units: a tie when small)."""
    diff = codes != want
    n = int(diff.sum())
    if not n:
        return 0, 0.0
    q = quotient[diff].double()
    return n, ((q - q.floor()) - 0.5).abs().max().item()


class Int8Recorder:
    """A context manager over the W8A8 FF calls a forward makes (patching
    the two names ops.layers.feedforward calls). On the kernel path it
    records each call's xn / h codes and row scales (launch_chain's
    workspaces). Given `against`, such a recording of the same forward, the
    plain path's calls count the codes their own fp32 LN and h give that
    differ from `against`'s (xn's; then h's from the same xn codes), each
    one's distance from a .5 boundary, and quantise with `against`'s codes
    and scales, so the two paths compare from the same codes."""

    def __init__(self, torch, against=None):
        self.torch, self.against = torch, against
        self.calls, self.flips, self.ties = [], [0, 0], [0.0, 0.0]

    def __enter__(self):
        import ct_clip_ut_tpu_torch.ops.layers as layers
        from ct_clip_ut_tpu_torch.ops.geglu_ff_int8 import int8_dot, launch_chain

        self.layers, self.orig = layers, (layers.geglu_ff_int8, layers.geglu_ff_int8_plain)
        torch = self.torch

        def kernel(x, *args, residual=False):
            out, xq, rx, hq, rh = launch_chain(x, *args, residual)
            self.calls.append((xq, rx, hq, rh))
            return out

        def plain(x, *args, residual=False):
            xq, rx, hq, rh = self.against.calls[len(self.calls)]
            st = int8_plain_steps(torch, x, args, xq, rx)
            for i, (codes, want, quo) in enumerate(((st["xi"], xq, st["xn"] / st["rx"]),
                                                    (st["hi"], hq, st["h"] / st["rh"]))):
                n, tie = code_flips(codes, want, quo)
                self.flips[i] += n
                self.ties[i] = max(self.ties[i], tie)
            out = int8_dot(hq, args[4]).float() * rh.reshape(-1, 1) * args[7]
            if residual:
                out = out + x.float()
            self.calls.append(None)
            return out.to(x.dtype)

        layers.geglu_ff_int8 = kernel if self.against is None else self.orig[0]
        layers.geglu_ff_int8_plain = plain if self.against is not None else self.orig[1]
        return self

    def __exit__(self, *exc):
        self.layers.geglu_ff_int8, self.layers.geglu_ff_int8_plain = self.orig


def int8_f32_check(torch, model, card: str) -> dict:
    """Row 15f: geglu_ff_int8 on fp32 x at INT8_F32_ROWS tokens (spatial
    layer 0's FF of the seeded flagship, quantised, the LN gain drawn as 1
    + 0.1 N and bias 0.1 N), residual off and on, against its plain version
    within INT8_BAND relative rms with the bf16 form's controls; the codes
    of xn and h from the chain's workspaces against the plain steps' (xn's,
    then h's from the kernel's xn codes), each flip a tie within CODE_TIE;
    fp32 out, two calls the same bits, one call under torch.profiler on the
    Hopper pieces; times at each row count, bound_ms (int8 operations) and
    the torch._int_mm chain on fp32 rows as library_ms."""
    import torch.nn.functional as F

    from ct_clip_ut_tpu_torch.ops.geglu_ff_int8 import (geglu_ff_int8, geglu_ff_int8_plain,
                                                        launch_chain, row_quant)
    from ct_clip_ut_tpu_torch.ops.quant import quantize_ff_params

    vit = model.visual_transformer
    g = torch.Generator(device="cuda").manual_seed(31)
    d = vit.cfg.dim
    q = quantize_ff_params(vit.enc_spatial_transformer.layers[0][3])
    q.gamma.copy_(around_ones(torch, g, d))
    q.beta.copy_(0.1 * torch.randn((d,), generator=g, device="cuda"))
    args = [q.gamma, q.beta, q.wv_q, q.wg_q, q.w2_q, q.sv, q.sg, q.s2]
    swapped = list(args)
    swapped[5], swapped[6] = args[6], args[5]
    inner = q.wv_q.shape[0]
    wvg_t = torch.cat([q.wv_q, q.wg_q]).t()
    w2_t = q.w2_q.t()
    rec, times = {}, {}
    for n in INT8_F32_ROWS:
        x = torch.randn((n, d), generator=g, device="cuda")
        for residual in (False, True):
            got = geglu_ff_int8(x, *args, residual=residual)
            want = geglu_ff_int8_plain(x, *args, residual=residual)
            _, xq, rx, hq, rh = launch_chain(x, *args, residual)
            same = torch.equal(got, geglu_ff_int8(x, *args, residual=residual))
            st = int8_plain_steps(torch, x, args)
            fx, tx = code_flips(st["xi"], xq, st["xn"] / st["rx"])
            sk = int8_plain_steps(torch, x, args, xq, rx)
            fh, th = code_flips(sk["hi"], hq, sk["h"] / sk["rh"])
            torch.cuda.synchronize()
            err = rel_rms(got, want)
            controls = {k: rel_rms(got, c) for k, c in (
                ("h unquantised", geglu_ff_int8_plain(x, *args, residual=residual,
                                                      faults=("h_float",))),
                ("per-tensor scales", geglu_ff_int8_plain(x, *args, residual=residual,
                                                          faults=("per_tensor",))),
                ("sv / sg swapped", geglu_ff_int8_plain(x, *swapped, residual=residual)))}
            abs_err = (got - want).abs().max().item()
            print(f"kernel geglu_ff_int8_f32 x {list(x.shape)} fp32, inner {q.inner_dim} (padded "
                  f"{inner}), residual={residual}: out {got.dtype}, relative rms {err:.3e} "
                  f"(band {INT8_BAND}), max_rel_err {rel_err(got, want):.3e}, max_abs_err "
                  f"{abs_err:.3e}; code flips vs the plain steps: xn {fx} of {xq.numel()} "
                  f"(largest tie {tx:.2e}), h from the kernel's xn codes {fh} of {hq.numel()} "
                  f"(largest tie {th:.2e}; tie band {CODE_TIE}); two calls the same bits: {same};"
                  " controls " + ", ".join(f"{k} {v:.3e}" for k, v in controls.items()))
            if got.dtype != torch.float32 or not got.isfinite().all() or not same:
                raise AssertionError("geglu_ff_int8_f32: not fp32, non-finite or unstable")
            if not err <= INT8_BAND < min(controls.values()):
                raise AssertionError(f"geglu_ff_int8_f32: relative rms {err}, band {INT8_BAND}, "
                                     f"controls {controls}")
            if max(tx, th) > CODE_TIE:
                raise AssertionError(f"geglu_ff_int8_f32: a code flip at no tie ({tx}, {th})")
            if n == INT8_F32_ROWS[0] and not residual:
                rec["max_abs_err"] = abs_err

        def library():
            xn = F.layer_norm(x, (d,), q.gamma, q.beta, eps=1e-5)
            xi, rxl = row_quant(xn)
            vg = torch._int_mm(xi, wvg_t).float() * rxl
            hh = F.gelu(vg[:, inner:] * q.sg) * (vg[:, :inner] * q.sv)
            hi, rhl = row_quant(hh)
            return torch._int_mm(hi, w2_t).float() * rhl * q.s2 + x

        lib_err = rel_rms(library(), geglu_ff_int8_plain(x, *args, residual=True))
        times[n] = dict(ms=cuda_ms(torch, lambda: geglu_ff_int8(x, *args, residual=True)),
                        plain_ms=cuda_ms(torch, lambda: geglu_ff_int8_plain(x, *args,
                                                                             residual=True),
                                         iters=3),
                        library_ms=library_time(torch, library),
                        **bound(2 * n * d * q.inner_dim * 3, nbytes(x, *args, x), INT8_PEAK))
        t = times[n]
        print(f"kernel geglu_ff_int8_f32 at {n} rows: {t['ms']:.3f} ms vs plain "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"torch._int_mm chain on fp32 rows {t['library_ms']:.3f} ms "
              f"({t['library_ms'].span}) (relative rms {lib_err:.3e} vs the plain version) "
              f"[{card}]")
        if n == INT8_F32_ROWS[0]:
            hopper_chain_check("geglu_ff_int8_f32",
                               lambda: geglu_ff_int8(x, *args, residual=True), card)
    return dict(rec, **times[INT8_F32_ROWS[0]])


def int8_attribution_phase(torch, card: str) -> tuple:
    """Phase 16: row 15f under the forward attribution methods with
    --quantize-ff. First int8_f32_check on the seeded flagship. Then, counted,
    `inference_ctclip.main --quantize-ff --visualize raw_attention_maps
    attention_rollout occlusion --no-gifs` over the 2 synthetic NIfTI
    volumes of the CLI phase (the JAX script's CTCLIPConfig(dim_head=32),
    random weights from --seed 0; occlusion at SUITE_OCC, 27 windows, its
    default window is cut for time): geglu_ff_int8_f32 launched, the bf16
    and dense FFs not at all. Each map file the same as a direct call of its
    method on the same quantised model and preprocessed volume
    (SUITE_BAND); those calls against plain=True from the same codes (the
    VQ indices and int8 codes of the kernel path replayed, each flip
    counted and shown a tie within VQ_F32_TIE / CODE_TIE_PATH): maps within
    MAP_BAND, each occlusion window's score within OCC_BAND. Returns (the
    row's record, the CLI run's launch counts)."""
    import tempfile

    import numpy as np

    from ct_clip_ut_tpu_torch.attribution import capture, occlusion, raw_attention, rollout
    from ct_clip_ut_tpu_torch.attribution.suite import AttributionContext, Visualizations
    from ct_clip_ut_tpu_torch.config import (CTCLIPConfig, CTViTConfig, OcclusionConfig,
                                             PreprocessConfig, flagship_cfg)
    from ct_clip_ut_tpu_torch.data.datasets import InferenceDataset
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
    from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
    from ct_clip_ut_tpu_torch.ops import launches
    from ct_clip_ut_tpu_torch.ops.quant import quantize_ctclip_ff
    from ct_clip_ut_tpu_torch.scripts import inference_ctclip

    t_phase = time.perf_counter()
    record = int8_f32_check(torch, init_ctclip(flagship_cfg(), seed=0, device="cuda"), card)
    torch.cuda.empty_cache()
    occ = OcclusionConfig(**SUITE_OCC)
    methods = ["raw_attention_maps", "attention_rollout", "occlusion"]
    keep = Visualizations.occlusion.__defaults__
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data_argv = write_cli_dataset(
            root, np.random.default_rng(17),
            reports=("emphysema and a nodule in the right upper lobe", "no effusion"))
        out = root / "results"
        argv = data_argv + ["--results-folder", str(out), "--quantize-ff", "--no-gifs",
                            "--num-workers", "2", "--visualize", *methods]
        Visualizations.occlusion.__defaults__ = (occ, False, "")
        try:
            launches.reset_launch_counts()
            t0 = time.perf_counter()
            inference_ctclip.main(argv)
            seconds = time.perf_counter() - t0
            counts = launches.launch_counts()
        finally:
            Visualizations.occlusion.__defaults__ = keep
        files = sorted(str(p.relative_to(out)) for p in out.rglob("*.npy"))
        print(f"int8 fp32: inference_ctclip --quantize-ff --visualize {' '.join(methods)} "
              f"--no-gifs on 2 volumes {list(CLI_VOLUME)} int16 (occlusion at "
              f"{occ.patch_size} / {occ.stride}) in {seconds:.1f} s (host clock, model init and "
              f"preprocessing included) [{card}]: {len(files)} maps; launches "
              f"{json.dumps({k: v for k, v in counts.items() if v})}")
        missing = [k for k in INT8_F32_ATTRIBUTION if counts[k] <= 0]
        stray = [k for k in INT8_F32_ABSENT if counts[k] != 0]
        if missing or stray or len(files) != 2 * 5:
            raise AssertionError(f"--quantize-ff attribution: not launched {missing}, launched "
                                 f"{stray}, {len(files)} map files")

        # the same model and volumes, each method called directly
        cfg = CTCLIPConfig(ctvit=CTViTConfig(dim_head=32))
        model = quantize_ctclip_ff(inference_ctclip.load_model(cfg, None, 0, "cuda"))
        ds = InferenceDataset(str(root / "valid"), str(root / "reports.csv"),
                              str(root / "metadata.csv"), str(root / "labels.csv"),
                              num_samples=10, preprocess_cfg=PreprocessConfig())
        vis = Visualizations(AttributionContext(model=model, tokenizer=WordTokenizer(
            cfg.bert.vocab_size), data=ds, render_gifs=False), root / "unused")
        file_err, map_errs, score_errs = 0.0, {}, []
        flips = {"VQ": [0, 0.0], "xn codes": [0, 0.0], "h codes": [0, 0.0]}

        def replayed(fn):
            """fn(plain) on the kernel path, then on plain=True from its codes."""
            with VQRecorder(torch) as vk, Int8Recorder(torch) as qk:
                got = fn(False)
            with VQRecorder(torch, vk, replay=True) as vp, Int8Recorder(torch, qk) as qp:
                want = fn(True)
            flips["VQ"][0] += int(vp.flips().sum())
            flips["VQ"][1] = max([flips["VQ"][1], *vp.gaps])
            for i, k in enumerate(("xn codes", "h codes")):
                flips[k][0] += qp.flips[i]
                flips[k][1] = max(flips[k][1], qp.ties[i])
            return got, want

        for image, tokens, _, scan, _ in vis.prepared():
            def load(rel):
                # each method's call claims its own indexed directory
                method, name = rel.split("/")
                found = list((out / method).glob(f"*/{name}"))
                if len(found) != 1:
                    raise AssertionError(f"--quantize-ff maps: {rel} found {len(found)} times")
                return np.load(found[0], allow_pickle=False)

            sp, tm = raw_attention.raw_attention_maps_np(model, tokens, image)
            rsp, rtm = (capture.rot90_ct(m) for m in rollout.rollout_maps(model, tokens, image))
            lat = occlusion.report_text_latent(model, tokens)
            heat = capture.rot90_ct(occlusion.occlusion_heatmap(model, image, lat, occ=occ))
            for rel, direct in ((f"raw_attention_grids/{scan}_spatial.npy", sp),
                                (f"raw_attention_grids/{scan}_temporal.npy", tm),
                                (f"attention_rollout/{scan}_spatial.npy", rsp),
                                (f"attention_rollout/{scan}_temporal.npy", rtm),
                                (f"occlusion/{scan}__heatmap.npy", heat)):
                file_err = max(file_err, float(np.abs(load(rel) - direct).max()))
            (ksp, ktm), (psp, ptm) = replayed(
                lambda plain: raw_attention.raw_attention_maps(model, tokens, image, plain=plain))
            (krs, krt), (prs, prt) = replayed(
                lambda plain: rollout.rollout_volumes(model, tokens, image, plain=plain))
            for k, a, b in (("raw spatial", ksp, psp), ("raw temporal", ktm, ptm),
                            ("rollout spatial", krs, prs), ("rollout temporal", krt, prt)):
                map_errs[k] = max(map_errs.get(k, 0.0), (a - b).abs().max().item())
            coords = occlusion.window_grid(tuple(image.shape[-3:]), occ.patch_size, occ.stride)
            (_, ks), (_, ps) = replayed(lambda plain: occlusion.occlusion_scores_slabbed(
                model, image, lat[None], coords, occ=occ, plain=plain))
            score_errs.append(np.abs(ks - ps).max(axis=1) / np.abs(ps).max())
        score_errs = np.concatenate(score_errs)
        print(f"int8 fp32: the CLI's {len(files)} map files vs direct calls on the same model "
              f"and volumes: max abs {file_err:.3e} (band {SUITE_BAND}); direct calls vs "
              f"plain=True from the kernel path's codes: maps "
              + ", ".join(f"{k} {v:.3e}" for k, v in map_errs.items())
              + f" (band {MAP_BAND}); occlusion, {score_errs.size} windows: a window's "
              f"relative error max {score_errs.max():.3e}, median {np.median(score_errs):.3e} "
              f"(band {OCC_BAND}); flips between the two paths (replayed): "
              + ", ".join(f"{k} {n} (largest tie {t:.2e})" for k, (n, t) in flips.items())
              + f" (tie bands {VQ_F32_TIE} / {CODE_TIE_PATH}) [{card}]")
        if file_err > SUITE_BAND or max(map_errs.values()) > MAP_BAND:
            raise AssertionError(f"--quantize-ff maps: files {file_err}, maps {map_errs}")
        if not score_errs.max() <= OCC_BAND:
            raise AssertionError(f"--quantize-ff occlusion scores: {score_errs.max()}")
        if flips["VQ"][1] > VQ_F32_TIE or max(flips["xn codes"][1],
                                               flips["h codes"][1]) > CODE_TIE_PATH:
            raise AssertionError(f"--quantize-ff attribution: a flip at no tie {flips}")
    print(f"int8 fp32: phase 16 in {time.perf_counter() - t_phase:.1f} s [{card}]")
    return record, counts


def dp_train_setup(torch, seed: int, words: int = DP_REPORT_WORDS):
    """Phase 17's train step: the fp32 step at the TrainConfig defaults (512
    tokens) at flagship width with peg_pallas=True and every dropout rate 0,
    a model drawn from `seed`, and one B = 2 fp32 batch with reports of about
    `words` words (tokens on the card)."""
    from ct_clip_ut_tpu_torch.config import TrainConfig, flagship_cfg, replace
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
    from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip

    cfg = flagship_cfg()
    cfg = replace(cfg, ctvit=replace(cfg.ctvit, peg_pallas=True),
                  bert=replace(cfg.bert, hidden_dropout=0.0, attention_dropout=0.0))
    tcfg = TrainConfig(compute_dtype="float32")
    images, texts = train_batches(torch, torch.Generator(device="cuda").manual_seed(43), 1,
                                  words, dtype=torch.float32)[0]
    enc = WordTokenizer(cfg.bert.vocab_size)(texts, max_length=tcfg.text_max_length)
    tokens = {k: torch.as_tensor(v, device="cuda") for k, v in enc.items()}
    return cfg, tcfg, init_ctclip(cfg, seed=seed, device="cuda"), images, tokens


def dp_step(torch, cfg, tcfg, model, images, tokens, mesh=None):
    """One train step of `model` (on this rank's rows with a mesh): (loss,
    the gradients entering the optimizer in parameter order, the codebook
    buffers after the step)."""
    from ct_clip_ut_tpu_torch.parallel.sharding import shard_host_batch
    from ct_clip_ut_tpu_torch.train.trainer import create_train_state, make_train_step

    state = create_train_state(cfg, tcfg, params=model.requires_grad_(True), device=images.device,
                               mesh=mesh)
    grads, opt_step = [], state.optimizer.step

    def recording_step(*args):
        grads.extend(g.detach().clone() for g in state.optimizer.grads())
        return opt_step(*args)

    state.optimizer.step = recording_step
    if mesh is not None:
        images, tokens = shard_host_batch(images, mesh), shard_host_batch(tokens, mesh)
    loss = make_train_step(cfg, tcfg, mesh=mesh)(state, images, tokens).item()
    cb = state.model.visual_transformer.vq._codebook
    return loss, grads, [b.detach().clone() for b in (cb.embed, cb.embed_avg, cb.cluster_size)]


def split_step_grads(torch, model, images, tokens, parts) -> list:
    """The fp32 step's gradients (kernel path, dropout 0) of the batch's
    contrastive loss with the latents of each (lo, hi) row range computed
    in a forward of its own, one process."""
    from ct_clip_ut_tpu_torch.models.ctclip import contrastive_loss, ctclip_apply

    model.zero_grad(set_to_none=True)
    latents = []
    for lo, hi in parts:
        out = ctclip_apply(model, {k: v[lo:hi] for k, v in tokens.items()}, images[lo:hi],
                           freeze_vq=False, generator=torch.Generator(device="cuda").manual_seed(5),
                           deterministic=False)
        latents.append((out.image_latents, out.text_latents))
    img, txt = (torch.cat(t) for t in zip(*latents))
    contrastive_loss((img.float() @ txt.float().t()) * model.temperature.exp()).backward()
    grads = [p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
             for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return grads


def step_errors(model, got, want, floor: float = 0.0) -> dict:
    """Each gradient's max |got - want| over its largest entry (over its
    parameter group's for the shift-invariant biases, whose gradient is
    rounding noise), as phase 14 holds them; with `floor`, over at least
    that fraction of its group's largest entry."""
    names = [n for n, _ in model.named_parameters()]
    cpb = model.visual_transformer.spatial_rel_pos_bias.net
    shift = {n for n in names if n.endswith("attention.self.key.bias")
             or n == f"visual_transformer.spatial_rel_pos_bias.net.{len(cpb) - 1}.bias"}
    top, out = {}, {}
    for n, w in zip(names, want):
        if w.numel():
            top[param_group(n)] = max(top.get(param_group(n), 0.0), w.abs().max().item())
    for n, g, w in zip(names, got, want):
        if w.numel():
            group = top[param_group(n)]
            scale = group if n in shift else max(w.abs().max().item(), floor * group)
            out[n] = (g - w).abs().max().item() / max(scale, 1e-30)
    return out


def codebook_err(got, want) -> float:
    """The largest of the codebook buffers' max |got - want| over the
    buffer's largest entry."""
    return max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(got, want))


def state_run(torch, cfg, tcfg, model, images, tokens, mesh=None, steps: int = 1,
              state=None) -> dict:
    """`steps` train steps of `tcfg` (FSDP where it says so) on one batch
    (this rank's rows with a mesh), from `model` or from `state` where
    given: {"state", "losses", "grads": the first step's gradients entering
    the optimizer on the host (an FSDP leaf's piece)}."""
    from ct_clip_ut_tpu_torch.parallel.sharding import shard_host_batch
    from ct_clip_ut_tpu_torch.train.trainer import create_train_state, make_train_step

    if state is None:
        state = create_train_state(cfg, tcfg, params=model.requires_grad_(True),
                                   device=images.device, mesh=mesh)
    grads, opt_step = [], state.optimizer.step

    def recording_step(*args):
        if not grads:
            grads.extend(g.detach().cpu() for g in state.optimizer.grads())
        return opt_step(*args)

    state.optimizer.step = recording_step
    if mesh is not None:
        images, tokens = shard_host_batch(images, mesh), shard_host_batch(tokens, mesh)
    step = make_train_step(cfg, tcfg, mesh=mesh)
    losses = [step(state, images, tokens).item() for _ in range(steps)]
    state.optimizer.step = opt_step
    return {"state": state, "losses": losses, "grads": grads}


def state_tensors(torch, state) -> list:
    """(name, tensor) of what a train state holds, on the host: the
    parameters (gathered whole under FSDP), the moments as the optimizer
    holds them, the codebook buffers, the generator."""
    from ct_clip_ut_tpu_torch.parallel import sharding

    if state.fsdp is not None:
        sharding.gather_params(state.fsdp)
    out = [(n, p.detach().cpu()) for n, p in state.model.named_parameters()]
    if state.fsdp is not None:
        sharding.release_params(state.fsdp)
    names = [n for n, _ in out]
    out += [(f"mu {n}", m.cpu()) for n, m in zip(names, state.optimizer.mu)]
    out += [(f"nu {n}", v.cpu()) for n, v in zip(names, state.optimizer.nu)]
    cb = state.model.visual_transformer.vq._codebook
    out += [(f"codebook {k}", getattr(cb, k).cpu()) for k in ("embed", "embed_avg",
                                                              "cluster_size")]
    return out + [("generator", state.generator.get_state())]


def first_difference(pairs, band: float = FSDP_BAND) -> tuple:
    """Over (name, got, want) triples: (the name of the first pair that is
    not the same bits or None, the largest max |got - want| over the
    tensor's largest entry among them, whether every such pair lies within
    `band`)."""
    first, worst = None, 0.0
    for name, got, want in pairs:
        got = got.reshape(want.shape)
        if got.dtype != want.dtype or not got.equal(want):
            first = first or name
            top = want.double().abs().max().item() if want.numel() else 0.0
            err = (got.double() - want.double()).abs().max().item()
            worst = max(worst, err / top if top else float("inf"))
    return first, worst, worst <= band


def fsdp_one_rank(torch, cfg, tcfg, images, tokens, mesh, card: str) -> None:
    """Phase 17 (a)'s FSDP: the step with fsdp=True over the one-rank group
    (each sharded leaf's one piece the whole leaf) against the
    single-process step, then the sharded checkpoint's resume."""
    import tempfile

    from ct_clip_ut_tpu_torch.config import replace
    from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
    from ct_clip_ut_tpu_torch.train import checkpoint as ckpt

    fcfg = replace(tcfg, fsdp=True, sharded_checkpoints=True)
    single = state_run(torch, cfg, tcfg, init_ctclip(cfg, seed=0, device="cuda"), images, tokens)
    want = state_tensors(torch, single["state"])
    del single["state"]
    torch.cuda.empty_cache()
    fsdp = state_run(torch, cfg, fcfg, init_ctclip(cfg, seed=0, device="cuda"), images, tokens,
                     mesh)
    state = fsdp["state"]
    layout = state.fsdp
    got = state_tensors(torch, state)
    grads = [(f"grad {n}", g, w) for (n, _), g, w in zip(got, fsdp["grads"], single["grads"])]
    first, worst, ok = first_difference(
        [("loss", torch.tensor(fsdp["losses"]), torch.tensor(single["losses"])), *grads,
         *((n, a, b) for (n, a), (_, b) in zip(got, want))])
    print(f"fsdp: the fp32 step at B = {BATCH} with fsdp=True over the one-rank "
          f"{torch.distributed.get_backend()} group ({sum(layout.sharded)} of "
          f"{len(layout.sharded)} parameters sharded, each one piece) vs the single-process "
          f"step: loss {fsdp['losses'][0]:.7f}; loss, {len(grads)} gradients, the parameters, "
          f"moments and codebook after the step "
          + ("the same bits" if first is None else
             f"first off the same bits: {first}, the largest {worst:.2e} of a tensor's largest "
             f"entry (band {FSDP_BAND})") + f" [{card}]")
    if not ok:
        raise AssertionError("FSDP over one rank: off the single-process step")
    del want, got, grads, single
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "last.dcp"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint_sharded(path, state, mesh)
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
        straight = state_run(torch, cfg, fcfg, None, images, tokens, mesh, state=state)
        want = [("loss", torch.tensor(straight["losses"])), *state_tensors(torch, state)]
        del state, fsdp, straight
        torch.cuda.empty_cache()
        fresh = state_run(torch, cfg, fcfg, init_ctclip(cfg, seed=1, device="cuda"), images,
                          tokens, mesh, steps=0)["state"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.load_checkpoint_sharded(path, fresh, mesh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    resumed = state_run(torch, cfg, fcfg, None, images, tokens, mesh, state=fresh)
    got = [("loss", torch.tensor(resumed["losses"])), *state_tensors(torch, fresh)]
    first, worst, _ = first_difference([(n, a, b) for (n, a), (_, b) in zip(got, want)])
    print(f"fsdp: a sharded checkpoint after the step ({size / 1e9:.3f} GB written in "
          f"{save_s:.2f} s, read into a fresh state in {load_s:.2f} s, host clock, the page "
          f"cache warm), then one more step: loss {resumed['losses'][0]:.7f}; parameters, "
          f"moments, codebook and generator, and the loss, vs the uninterrupted run "
          + ("the same bits" if first is None else f"first off: {first} ({worst:.2e})")
          + f" [{card}]")
    if first is not None:
        raise AssertionError("the sharded checkpoint's resume is not the uninterrupted run")
    del fresh, resumed, got, want
    torch.cuda.empty_cache()


def fsdp_ranks(torch, cfg, tcfg, images, tokens, mesh, say, card: str) -> None:
    """Phase 17 (b)'s FSDP: two steps at local batch 1 of data parallelism,
    then of FSDP, from rank 0's model; each rank's memory at rest (the
    allocator's bytes past those before the model, gradients freed) and
    its peak over the two steps (torch.cuda.max_memory_allocated past the
    same base) beside the other's."""
    from ct_clip_ut_tpu_torch.config import replace
    from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
    from ct_clip_ut_tpu_torch.parallel import collectives, sharding

    import gc

    runs = {}
    for name, c in (("dp", tcfg), ("fsdp", replace(tcfg, fsdp=True))):
        gc.collect()            # a state held only by a cycle (a patched step) frees here
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = init_ctclip(cfg, seed=0 if mesh.is_main else 1, device="cuda")
        t0 = time.perf_counter()
        run = state_run(torch, cfg, c, model, images, tokens, mesh, steps=2)
        torch.cuda.synchronize()
        run["seconds"] = time.perf_counter() - t0
        run["peak"] = torch.cuda.max_memory_allocated() - base
        state = run.pop("state")
        state.optimizer.zero_grad()
        gc.collect()
        torch.cuda.synchronize()
        run["rest"] = torch.cuda.memory_allocated() - base
        layout = state.fsdp
        run["spans"] = None if layout is None else layout.spans
        run["pieces_only"] = layout is None or all(
            p.numel() == 0 and p.grad is None for p, s in zip(layout.params, layout.spans)
            if s is not None)
        if layout is not None:
            sharding.gather_params(layout)
            same = 0
            for p in layout.params:
                t = p.detach().clone()
                collectives.broadcast(t, mesh)
                same += int(torch.equal(t, p))
            run["same"] = int(collectives.psum(torch.tensor([same], device="cuda"), mesh).item())
            sharding.release_params(layout)
        run["params"] = [t for n, t in state_tensors(torch, state)[:len(run["grads"])]]
        runs[name] = run
        del state, model, layout
    dp, fs = runs["dp"], runs["fsdp"]
    pieces = sum(torch.equal(g.reshape(-1), w.reshape(-1) if s is None
                             else w.reshape(-1)[s[0]:s[1]])
                 for s, g, w in zip(fs["spans"], fs["grads"], dp["grads"]))
    pieces = int(collectives.psum(torch.tensor([pieces], device="cuda"), mesh).item())
    rest = collectives.gather_rows(torch.tensor([[dp["rest"], fs["rest"], dp["peak"],
                                                  fs["peak"]]], device="cuda",
                                                dtype=torch.float64), mesh).cpu().tolist()
    first, worst, ok = first_difference(
        [(f"param {i}", a, b) for i, (a, b) in enumerate(zip(fs["params"], dp["params"]))])
    n = len(dp["grads"])
    say(f"fsdp: {mesh.world} gloo ranks on the one card, two fp32 steps at local batch 1 "
        f"({sum(s is not None for s in fs['spans'])} of {n} parameters sharded): the first loss "
        f"{fs['losses'][0]:.7f} vs data parallelism's the same bits "
        f"{fs['losses'][0] == dp['losses'][0]}, the second {fs['losses'][1]:.7f} vs "
        f"{dp['losses'][1]:.7f}; gradient pieces the bits of the averaged gradient's slice in "
        f"{pieces} of {mesh.world * n}; the parameters after two steps "
        + ("the same bits" if first is None else
           f"within {worst:.2e} of each tensor's largest entry (band {FSDP_BAND})")
        + f"; the gathered parameters the same bits on both ranks in {fs['same']} of "
        f"{mesh.world * n}; at rest (the allocator's "
        f"bytes over the state, gradients freed) by rank "
        + ", ".join(f"DP {a / 1e9:.3f} GB / FSDP {b / 1e9:.3f} GB" for a, b, _, _ in rest)
        + "; the peak over the two steps (max_memory_allocated past the same bytes) by rank "
        + ", ".join(f"DP {c / 1e9:.3f} GB / FSDP {d / 1e9:.3f} GB" for _, _, c, d in rest)
        + f"; two steps in {dp['seconds']:.2f} s (DP) / {fs['seconds']:.2f} s (FSDP), host "
        f"clock, first calls, gloo's all-reduces through the host included [{card}]")
    if not (fs["losses"][0] == dp["losses"][0] and pieces == mesh.world * n and ok
            and fs["same"] == mesh.world * n and fs["pieces_only"]):
        raise AssertionError("FSDP over the ranks: off the data-parallel steps")


def ig_ranks(torch, model, prompt, image, mesh, say, card: str) -> None:
    """Phase 17 (b)'s integrated gradients: DP_IG_STEPS steps in chunks of
    DP_IG_CHUNK over the ranks (each rank's chunks the same batches as one
    process's) against one process on rank 0, and each map's time."""
    import numpy as np

    from ct_clip_ut_tpu_torch.attribution import integrated_gradients as ig
    from ct_clip_ut_tpu_torch.parallel import collectives

    kw = dict(steps=DP_IG_STEPS, chunk=DP_IG_CHUNK)
    ig.integrated_gradients_sharded(model, prompt, image, mesh, **kw)        # first calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ig.integrated_gradients_sharded(model, prompt, image, mesh, **kw)
    sharded_s = time.perf_counter() - t0
    diff, avg = ig._ig_avg_grads_sharded(model, prompt, image, mesh, **kw)
    same = torch.from_numpy(got).to("cuda")
    collectives.broadcast(same, mesh)
    same = bool(torch.equal(same.cpu(), torch.from_numpy(got)))
    if not mesh.is_main:
        return
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ig.integrated_gradients(model, prompt, image, **kw)
    one_s = time.perf_counter() - t0
    _, want_avg = ig._ig_avg_grads(model, prompt, image, **kw)
    avg_err = ((avg - want_avg).abs().max() / want_avg.abs().max()).item()
    # in patch space: the crossings of the 0.90 threshold and their distance from it
    pre = ig._ig_normalize(diff, want_avg, 0.0, 1.0)
    threshold = ig._quantile(pre, 0.9)
    crossed = ((ig._ig_normalize(diff, avg, 0.9, 0.05) > 0)
               != (ig._ig_normalize(diff, want_avg, 0.9, 0.05) > 0))
    gap = (pre[crossed] - threshold).abs().max().item() if crossed.any() else 0.0
    # the public maps, off their crossings
    off = (got > 0) == (want > 0)
    map_err = float(np.abs(got - want)[off].max())
    say(f"fsdp: integrated gradients over {mesh.world} ranks ({DP_IG_STEPS} steps in chunks of "
        f"{DP_IG_CHUNK}, each rank {DP_IG_STEPS // mesh.world}) vs one process: the average "
        f"gradient within {avg_err:.2e} of its largest entry (band {DP_IG_BAND}); the map the "
        f"same on both ranks {same}, {int(crossed.sum())} elements crossed the threshold (the "
        f"farthest {gap:.2e} from it, band {IG_CROSS_BAND}), off them within {map_err:.2e} "
        f"(band {MAP_BAND}); a map in {sharded_s:.3f} s over the ranks vs {one_s:.3f} s in one "
        f"process (host clock; the ranks share the card, so no speedup is expected) [{card}]")
    if not (avg_err <= DP_IG_BAND and same and map_err <= MAP_BAND and gap <= IG_CROSS_BAND):
        raise AssertionError("sharded integrated gradients: off one process's map")


def ctgen_ranks(torch, mesh, say, card: str) -> None:
    """Phase 17 (b)'s CTGenerate: DP_CTGEN_SCANS bf16 scans over the ranks
    (padded with the last) through ctgenerate_apply_batched(mesh=) and
    localize(mesh=), against one process on rank 0."""
    import numpy as np

    from ct_clip_ut_tpu_torch.config import CTGenerateConfig
    from ct_clip_ut_tpu_torch.infer.profile_ctgenerate import reports
    from ct_clip_ut_tpu_torch.infer.zeroshot import WordTokenizer
    from ct_clip_ut_tpu_torch.models.ctgenerate import ctgenerate_apply_batched, init_ctgenerate
    from ct_clip_ut_tpu_torch.models.t5 import T5TextConditioner
    from ct_clip_ut_tpu_torch.scripts.inference_ctgenerate import localize

    cfg = CTGenerateConfig()
    model = init_ctgenerate(cfg, seed=0, device="cuda")
    t5 = T5TextConditioner(model.t5, WordTokenizer(cfg.t5.vocab_size))
    g = torch.Generator(device="cuda").manual_seed(9)
    scans = torch.randn((DP_CTGEN_SCANS, *CTGEN_SCAN), generator=g, device="cuda",
                        dtype=torch.bfloat16)
    texts = [r if i % 2 == 0 else " ".join(r.split()[:SHORT_REPORT])
             for i, r in enumerate(reports(DP_CTGEN_SCANS))]
    emb, mask = t5.encode(texts)
    cache = {}
    with torch.no_grad():
        got = ctgenerate_apply_batched(model, scans, emb, mask, mesh=mesh, bias_cache=cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        maps = localize(model, t5, scans, texts, bias_cache=cache, mesh=mesh)
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
        if not mesh.is_main:
            return
        want = ctgenerate_apply_batched(model, scans, emb, mask, bias_cache=cache)
        t0 = time.perf_counter()
        want_maps = localize(model, t5, scans, texts, bias_cache=cache)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
    cross = (got.cross_attention.float() - want.cross_attention.float()).abs().max().item()
    ids = bool(torch.equal(got.codebook_ids, want.codebook_ids))
    bits = bool(torch.equal(got.cross_attention, want.cross_attention)
                and torch.equal(got.feature_map, want.feature_map))
    heat = max(float(np.abs(maps[i][k] - want_maps[i][k]).max())
               for i in range(DP_CTGEN_SCANS) for k in want_maps[i])
    keys = [sorted(m) for m in maps] == [sorted(m) for m in want_maps]
    say(f"fsdp: CTGenerate over {mesh.world} ranks, {DP_CTGEN_SCANS} bf16 scans "
        f"{list(CTGEN_SCAN)} padded to {-(-DP_CTGEN_SCANS // mesh.world) * mesh.world}: "
        f"codebook ids those of one process {ids}, the cross-attention max abs "
        f"{cross:.2e} (band {CROSS_BAND}), the same bits (and feature map) {bits}; "
        f"localize()'s heatmaps the same pathologies {keys}, max abs {heat:.2e} (band "
        f"{CROSS_BAND}); localize in "
        f"{mesh_s:.3f} s over the ranks vs {one_s:.3f} s in one process (host clock) [{card}]")
    if not (ids and keys and cross <= CROSS_BAND and heat <= CROSS_BAND
            and got.cross_attention.shape[0] == DP_CTGEN_SCANS):
        raise AssertionError("CTGenerate over the ranks: off one process")


def dp_rank(rank: int, port: int, out_dir: str, card: str) -> None:
    """Phase 17 (b): one of DP_WORLD ranks sharing the card over gloo (the
    smoke names the backend; NCCL takes one rank a device). Rank 0 first
    runs each check's single-process reference; then both ranks run the
    data-parallel step (local batch 1, rank 1's model drawn from another
    seed so that rank 0's broadcast shows), sharded zero-shot over
    DP_ZS_VOLUMES volumes and the window-sharded occlusion sweep over
    DP_OCC_WINDOWS windows; then FSDP against data parallelism
    (`fsdp_ranks`), the sharded integrated gradients (`ig_ranks`) and
    CTGenerate over the ranks (`ctgen_ranks`). Rank 0 prints and checks; a
    failed collective raises in its rank."""
    import types

    import numpy as np
    import torch

    from ct_clip_ut_tpu_torch.attribution import occlusion
    from ct_clip_ut_tpu_torch.config import MeshConfig, OcclusionConfig, flagship_cfg
    from ct_clip_ut_tpu_torch.data.loader import DataLoader, ShardedSampler
    from ct_clip_ut_tpu_torch.infer.zeroshot import (CTClipInference, WordTokenizer,
                                                     tokenize_prompts)
    from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
    from ct_clip_ut_tpu_torch.models.ctvit import token_grid_shape
    from ct_clip_ut_tpu_torch.parallel import collectives
    from ct_clip_ut_tpu_torch.parallel.mesh import initialize_runtime, make_mesh, shutdown_runtime

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    initialize_runtime(f"localhost:{port}", DP_WORLD, rank, device="cuda", backend="gloo")
    mesh = make_mesh(MeshConfig(data=DP_WORLD), device="cuda:0")
    is_main = mesh.is_main

    def say(*args):
        if is_main:
            print(*args, flush=True)

    # the train step: the reference on rank 0, then the step over the ranks
    cfg, tcfg, model, images, tokens = dp_train_setup(torch, seed=0 if is_main else 1)
    ref_ids = torch.zeros((images.shape[0], math.prod(token_grid_shape(cfg.ctvit, VOLUME))),
                          dtype=torch.int32, device="cuda")
    if is_main:
        ref_model = init_ctclip(cfg, seed=0, device="cuda")
        halves = split_step_grads(torch, ref_model.requires_grad_(True), images, tokens,
                                  [(0, 1), (1, 2)])
        with VQRecorder(torch) as rec:
            ref = dp_step(torch, cfg, tcfg, ref_model, images, tokens)
        ref_ids.copy_(rec.ids[0])
        del ref_model
        torch.cuda.empty_cache()
    collectives.broadcast(ref_ids, mesh)
    against = types.SimpleNamespace(ids=[ref_ids[rank:rank + 1]])
    t0 = time.perf_counter()
    with VQRecorder(torch, against, replay=True) as rec:
        loss, grads, codebook = dp_step(torch, cfg, tcfg, model, images, tokens, mesh)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    same = 0
    for g in [*grads, *codebook]:
        t = g.clone()
        collectives.broadcast(t, mesh)
        same += int(torch.equal(t, g))
    same = int(collectives.psum(torch.tensor([same], device="cuda"), mesh).item())
    # each rank's VQ flips and its largest tie gap, one row a rank: every
    # rank's gap is held to the tie band on its own
    ties = collectives.gather_rows(torch.tensor([[float(rec.flips().sum()),
                                                  max(rec.gaps, default=0.0)]],
                                                device="cuda"), mesh)
    if is_main:
        rloss, rgrads, rcb = ref
        split_same = sum(torch.equal(a, b) for a, b in zip(grads, halves))
        split_err = max(step_errors(model, grads, halves).values())
        raw = step_errors(model, grads, rgrads)
        errs = step_errors(model, grads, rgrads, DP_GRAD_FLOOR)
        worst = sorted(raw.items(), key=lambda kv: -kv[1])[:3]
        cb_err = codebook_err(codebook, rcb)
        loss_err = abs(loss - rloss) / abs(rloss)
        say(f"data parallel: {DP_WORLD} gloo ranks on the one card, the fp32 step at "
            f"{tcfg.text_max_length} tokens, local batch 1: loss {loss:.7f} vs the "
            f"single-process B = {BATCH} step {rloss:.7f} (relative {loss_err:.2e}); gradients "
            f"of {len(errs)} parameters against the same two rows in forwards of 1 in one "
            f"process: the same bits in {split_same}, max {split_err:.2e}; against the B = "
            f"{BATCH} step, max |diff| over the tensor's largest entry {max(raw.values()):.3e}, "
            f"worst " + ", ".join(f"{n} {v:.2e}" for n, v in worst)
            + f"; over at least {DP_GRAD_FLOOR} of its group's largest {max(errs.values()):.3e} "
            f"(band {STEP_GRAD_BAND}); the codebook after the step, max abs over the largest "
            f"entry, {cb_err:.2e} (band {DP_CODEBOOK_BAND}); the same bits on both ranks in "
            f"{same} of {DP_WORLD * (len(grads) + 3)} tensors; VQ flips vs the reference "
            f"(replayed) {int(ties[:, 0].sum())}, largest tie by rank "
            f"{[f'{v:.2e}' for v in ties[:, 1].tolist()]}; the step in "
            f"{step_s:.2f} s (host clock, the first, its gradient all-reduce over gloo "
            f"included)")
        if not (split_err <= DP_SPLIT_BAND and max(errs.values()) <= STEP_GRAD_BAND
                and loss_err <= STEP_GRAD_BAND and cb_err <= DP_CODEBOOK_BAND
                and same == DP_WORLD * (len(grads) + 3)
                and bool((ties[:, 1] <= VQ_F32_TIE).all())):
            raise AssertionError("data-parallel step: off the single-process step, or the ranks "
                                 "differ")
        del ref, rgrads, rcb, halves
    del model, grads, codebook
    torch.cuda.empty_cache()
    fsdp_ranks(torch, cfg, tcfg, images, tokens, mesh, say, card)
    del images, tokens
    torch.cuda.empty_cache()

    # sharded zero-shot over DP_ZS_VOLUMES volumes (the last shard wraps)
    zs_model = init_ctclip(flagship_cfg(), seed=0, device="cuda")
    prompts = tokenize_prompts(WordTokenizer(zs_model.cfg.bert.vocab_size),
                               max_length=PROMPT_LEN, device="cuda")
    rng = np.random.default_rng(47)
    labels = np.eye(DP_ZS_VOLUMES, 18, dtype=np.float32) + np.eye(DP_ZS_VOLUMES, 18, 9)
    samples = [(rng.standard_normal(VOLUME, dtype=np.float32), "", labels[i])
               for i in range(DP_ZS_VOLUMES)]

    def loader():
        return DataLoader(samples, batch_size=1, num_workers=1, drop_last=False,
                          sampler=ShardedSampler(DP_ZS_VOLUMES, shuffle=False, drop_last=False))

    out = Path(out_dir)
    if is_main:
        _, ref_preds, _ = CTClipInference(zs_model, prompts, loader(),
                                          results_folder=str(out / "single")).zeroshot()
    inf = CTClipInference(zs_model, prompts, loader(), results_folder=str(out / "sharded"),
                          mesh=mesh)
    _, preds, targets = inf.zeroshot()
    if is_main:
        zs_err = float(np.abs(preds - ref_preds).max())
        say(f"data parallel: sharded zero-shot, {DP_ZS_VOLUMES} volumes over {DP_WORLD} ranks "
            f"(the wrapped duplicate dropped): preds {list(preds.shape)} vs one process max abs "
            f"{zs_err:.2e}, targets in order {bool(np.array_equal(targets, labels))}, "
            f"metrics.txt by rank 0: {(out / 'sharded' / 'metrics.txt').exists()}")
        if preds.shape != (DP_ZS_VOLUMES, 18) or zs_err > 1e-6 or \
                not np.array_equal(targets, labels):
            raise AssertionError("sharded zero-shot: off the single-process predictions")

    # the window-sharded occlusion sweep (phase 10's volume, prompt and latents)
    g = torch.Generator(device="cuda").manual_seed(16)
    image = torch.randn((1, *VOLUME), generator=g, device="cuda")
    diff = torch.randn((zs_model.cfg.dim_text,), generator=g, device="cuda")
    latents = torch.stack([occlusion.report_text_latent(zs_model, {k: v[:1]
                                                                   for k, v in prompts.items()}),
                           occlusion.diff_embedding_latent(zs_model, diff)])
    occ = OcclusionConfig()
    coords = occlusion.window_grid(VOLUME[1:], occ.patch_size, occ.stride)[:DP_OCC_WINDOWS]

    def window_ids(rec):
        return torch.cat(rec.ids)[1:]                  # the baseline first

    if is_main:
        with VQRecorder(torch) as rec_s:
            ref_orig, ref_scores = occlusion.occlusion_scores_slabbed(
                zs_model, image, latents, coords, occ=occ, chunk=OCC_CHUNK)
    t0 = time.perf_counter()
    with VQRecorder(torch) as rec_d:
        orig, scores = occlusion.occlusion_scores_multi_sharded(
            zs_model, image, latents, coords, mesh, occ=occ, chunk=OCC_CHUNK)
    occ_s = time.perf_counter() - t0
    ids = collectives.gather_rows(window_ids(rec_d), mesh)
    if is_main:
        flipped = (ids != window_ids(rec_s)).any(dim=1).cpu().numpy()
        errs = np.abs(scores - ref_scores).max(axis=1) / np.abs(ref_scores).max()
        say(f"data parallel: occlusion over {DP_OCC_WINDOWS} windows sharded over {DP_WORLD} "
            f"ranks in {occ_s:.2f} s (host clock, a rank's {DP_OCC_WINDOWS // DP_WORLD} windows "
            f"and the gathers): scores {list(scores.shape)} vs one process, a window's relative "
            f"error max {errs.max():.3e} (band {OCC_BAND}), {int(flipped.sum())} windows with a "
            f"VQ index flipped (the largest error of a window without one "
            f"{errs[~flipped].max(initial=0.0):.3e}); originals max abs "
            f"{float(np.abs(orig - ref_orig).max()):.2e}")
        if scores.shape != (DP_OCC_WINDOWS, 2) or errs[~flipped].max(initial=0.0) > OCC_BAND \
                or not np.array_equal(orig, ref_orig):
            raise AssertionError("sharded occlusion: off the single-process sweep")
    ig_ranks(torch, zs_model, {k: v[:1] for k, v in prompts.items()}, image, mesh, say, card)
    del zs_model, latents, image
    torch.cuda.empty_cache()
    ctgen_ranks(torch, mesh, say, card)
    shutdown_runtime()


def dp_phase(torch, card: str) -> None:
    """Phase 17: data parallelism over torch.distributed on the one card.
    (a) a one-rank NCCL group through the package's own code
    (parallel.mesh.initialize_runtime with an address, make_mesh): the fp32
    step at B = 2 over the mesh (the latents' all-gather, the VQ
    statistics' and the gradients' all-reduces) gives the single-process
    step's loss, gradients and codebook bit for bit, as two single-process
    runs do (the VQ's EMA statistics in a fixed order). (b) DP_WORLD ranks
    sharing the card over gloo (`dp_rank`): the step at local batch 1
    against the single-process B = 2 step within STEP_GRAD_BAND (the VQ
    indices of the reference replayed, flips counted as ties), the same
    bits on every rank; sharded zero-shot and the window-sharded occlusion
    sweep against one process."""
    import socket
    import tempfile

    from ct_clip_ut_tpu_torch.parallel.mesh import initialize_runtime, make_mesh, shutdown_runtime

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    t_phase = time.perf_counter()
    cfg, tcfg, model, images, tokens = dp_train_setup(torch, seed=0)
    single = dp_step(torch, cfg, tcfg, model, images, tokens)
    _, _, model, _, _ = dp_train_setup(torch, seed=0)
    again = dp_step(torch, cfg, tcfg, model, images, tokens)
    initialize_runtime(f"localhost:{free_port()}", 1, 0, device="cuda")
    try:
        mesh = make_mesh(device="cuda:0")
        backend = torch.distributed.get_backend()
        _, _, model, _, _ = dp_train_setup(torch, seed=0)
        over_mesh = dp_step(torch, cfg, tcfg, model, images, tokens, mesh)
        del model
        torch.cuda.empty_cache()
        fsdp_one_rank(torch, cfg, tcfg, images, tokens, mesh, card)
    finally:
        shutdown_runtime()
    same_loss = single[0] == over_mesh[0]
    same = [torch.equal(a, b) for a, b in zip(single[1], over_mesh[1])]
    # the codebook's EMA statistics are summed in a fixed order: the same
    # bits over the mesh and in two single-process runs
    cb_run = all(torch.equal(a, b) for a, b in zip(again[2], single[2]))
    cb_same = all(torch.equal(a, b) for a, b in zip(over_mesh[2], single[2]))
    print(f"data parallel: a one-rank {backend} group (world {mesh.world}), the fp32 step at "
          f"B = {BATCH} over the mesh vs the single-process step: loss {over_mesh[0]:.7f} the "
          f"same bits {same_loss}; gradients the same bits in {sum(same)} of {len(same)}; the "
          f"codebook after the step the same bits {cb_same} (max abs over the largest entry "
          f"{codebook_err(over_mesh[2], single[2]):.2e}; two single-process runs the same bits "
          f"{cb_run}) [{card}]")
    if (backend != "nccl" or not same_loss or not all(same) or not cb_same or not cb_run):
        raise AssertionError("one-rank NCCL step: not the single-process step's bits")
    del single, again, over_mesh, images, tokens
    # at short reports: a batch of 2 against two forwards of 1 in one
    # process (no collective), the sensitivity that sets the step's reports
    _, _, model, images, tokens = dp_train_setup(torch, seed=0, words=DP_SHORT_WORDS)
    whole = split_step_grads(torch, model.requires_grad_(True), images, tokens, [(0, 2)])
    halves = split_step_grads(torch, model, images, tokens, [(0, 1), (1, 2)])
    errs = step_errors(model, halves, whole)
    top = {n: v.abs().max().item() for n, v in zip((n for n, _ in model.named_parameters()),
                                                    whole) if v.numel()}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    print(f"data parallel: at reports of ~{DP_SHORT_WORDS} words, the step's gradients from two "
          f"forwards of 1 against one of {BATCH} in one process (kernel path): "
          + ", ".join(f"{n} {v:.2e} (its largest entry {top[n]:.2e})" for n, v in worst)
          + f"; the next largest {sorted(errs.values())[-4]:.2e} [{card}]")
    del model, images, tokens, whole, halves
    torch.cuda.empty_cache()

    sys.stdout.flush()
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(dp_rank, args=(free_port(), tmp, card),
                                              nprocs=DP_WORLD,
                                              join=True, start_method="spawn")
    print(f"data parallel: phase 17 in {time.perf_counter() - t_phase:.1f} s [{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs the port on a GPU", file=sys.stderr)
        return 2
    try:
        from ct_clip_ut_tpu_torch import _build
        from ct_clip_ut_tpu_torch.config import flagship_cfg, replace
        from ct_clip_ut_tpu_torch.models.ctclip import init_ctclip
    except ImportError:
        print("chip_smoke: run from the root of a checkout (ct_clip_ut_tpu_torch not found)",
              file=sys.stderr)
        return 2
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
        print(card)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

        t0 = time.perf_counter()
        lib = _build.build()
        _build.load()
        print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
        sass_check(lib)

        model = init_ctclip(flagship_cfg(), seed=0, device="cuda")
        record = kernel_phase(torch, model, card)
        counts = slice_phase(torch, model, card)
        record["geglu_ff_int8"] = int8_check(torch, model, card)
        int8_counts = quantized_phase(torch, model, card)
        cli_phase(torch, card)
        train_cli_phase(torch, card)
        gradcache_check(torch, card)
        torch.cuda.empty_cache()
        record["cosine_attention"], cosine_counts = cosine_check(torch, card)
        torch.cuda.empty_cache()
        record.update(backward_phase(torch, model, card))
        record.update(bert_train_check(torch, model, card))
        record.update(peg_check(torch, model, card))
        earlier_train_phase(torch, model, card)
        del model
        torch.cuda.empty_cache()
        cfg = flagship_cfg()
        cfg = replace(cfg, ctvit=replace(cfg.ctvit, peg_pallas=True))
        train_counts = train_phase(torch, init_ctclip(cfg, seed=0, device="cuda"), card)
        torch.cuda.empty_cache()
        record["attn_qrows"], ctgen_counts = ctgenerate_phase(torch, card)
        torch.cuda.empty_cache()
        attribution_record, attribution_counts = attribution_phase(torch, card)
        record.update(attribution_record)
        torch.cuda.empty_cache()
        gradient_record, gradient_counts = gradient_phase(torch, card)
        record.update(gradient_record)
        torch.cuda.empty_cache()
        ctgen_f32_record, ctgen_f32_counts = ctgen_f32_phase(torch, card)
        record.update(ctgen_f32_record)
        torch.cuda.empty_cache()
        suite_phase(torch, card)
        torch.cuda.empty_cache()
        f32_train_record, f32_train_counts, f32_model = f32_train_phase(torch, card)
        record.update(f32_train_record)
        bert_f32_record, bert_f32_counts = bert_f32_train_phase(torch, f32_model, card)
        record.update(bert_f32_record)
        del f32_model
        torch.cuda.empty_cache()
        record["geglu_ff_int8_f32"], int8_f32_counts = int8_attribution_phase(torch, card)
        torch.cuda.empty_cache()
        dp_phase(torch, card)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    def run_of(name):
        return (int8_f32_counts if name == "geglu_ff_int8_f32" else
                bert_f32_counts if name in BERT_F32_KERNELS else
                f32_train_counts if name in (*F32_TRAIN_KERNELS, *COUNTER_OF) else
                train_counts if name in TRAIN_KERNELS else
                attribution_counts if name in ATTRIBUTION_KERNELS else
                gradient_counts if name in GRADIENT_KERNELS else
                ctgen_f32_counts if name in CTGEN_F32_KERNELS else
                ctgen_counts if name == "attn_qrows" else
                int8_counts if name == "geglu_ff_int8" else
                cosine_counts if name == "cosine_attention" else counts)

    kernels = [dict(name=n, route="cuda", source=src, replaces=rep,
                    launches=run_of(n)[COUNTER_OF.get(n, n)], **record[n])
               for n, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
