// One post-LN BERT encoder layer in fp32: the port of
// ct_clip_ut_tpu/ops/pallas_bert_layer.py:bert_layer_fused's forward
// (`_fwd_impl` / `_kernel_fwd` / `_fwd_body`), deterministic (the zero-shot
// prompts: 36 x 512, D = 768, 12 heads of 64, F = 3072) or in train mode
// with dropout on the attention probabilities and both hidden outputs (the
// fp32 train step's 512-token reports, B = 2), over B sequences of n tokens
// with HF's additive key mask (0 or finfo(float32).min) and LayerNorm in the
// TPU kernel's one-pass E[r^2] - E[r]^2 form.
//
// What bounds it on the H100: operations. 2 * B * n * D * (3D + D + 2F) in
// the four products plus 4 * B * heads * n * keys * dh in attention, 290
// GFLOP a layer at 36 x 512 with every key: 4.3 ms at the 67 TFLOP/s of
// fp32 FFMA. The tensor cores take bf16, whose one-pass products miss the
// fp32 layer by ~1e-3, so every product is made of three bf16 products
// with fp32 sums, a . b ~ a_hi b_hi + a_lo b_hi + a_hi b_lo with hi =
// bf16(a), lo = bf16(a - hi): within ~2^-16 of fp32 (the layer within
// ~5e-6 of its fp32 version on the CPU, where one-pass bf16 products miss
// by ~1e-3 and a one-pass P.V alone by ~3e-4). Bound of that route: three
// times the products at 989 TFLOP/s, 0.88 ms at 36 x 512; 0.049 ms for the
// train step's 2 x 512. The chain is bert_f32.cuh's (nine launches: the
// split pass, the four products, the attention core, the two LayerNorms);
// train mode adds the Philox draws of its three dropout sites, in the
// attention core's P.V fragments and in the two hidden products'
// epilogues, and no launch; under autograd it also keeps its state for the
// backward (h1, r2 and the attention statistics beside the planes). What it loses most to: the attention core's
// one-pass online softmax keeps a 16-row block's o, m, l and its q planes
// in registers (4 warps a block, 64 KB of staged key / value planes).
// flags: ONE_PASS writes every lo plane as zeros (one-pass bf16 products:
// the control that shows the band needs the split); NO_SKIP walks every
// key chunk (the skipped chunks' sums are the same bits).
#include "bert_f32.cuh"

using namespace ctc::bert;

// x [B*n, D], mask [B, n] (additive), seeds [3] int32 on the device (read
// only where a threshold is not 0; may be null otherwise), wqkv [3D, D],
// bqkv [3D], wo [D, D], bo/g1/be1/b2/g2/be2 [D], w1 [F, D], b1 [F], w2 [D,
// F], all fp32 (weights in the nn.Linear (out, in) layout), 16-B aligned.
// Workspaces: bf16 hi / lo planes [2][rows][cols] of x, wqkv, wo, w1, w2 (as
// those), qkv [B*n, 3D], ctx [B*n, D], y [B*n, D], h [B*n, F]; fp32 r, y
// [B*n, D]. The state kept for the backward (ctc_bert_layer_bwd_f32 with
// KEPT), each null where nothing is kept: h1 [B*n, F] fp32 (the FF's
// pre-activation), r2 [B*n, D] fp32 (null: r2 overwrites r), rowstat [B,
// heads, n] float4 (not null: the attention core writes each row's (max, 1
// / sum) and, with attention dropout, the keep bits to keep [B, heads, n,
// keep_words(n)] u32). out [B*n, D]. D = heads * 64; F a multiple of 8;
// with dropout n a multiple of 4. flags: ONE_PASS, NO_SKIP. Dropout: a
// site keeps an element iff its Philox bits >= its threshold (thresh_attn
// for the attention probabilities, thresh_hidden for both hidden outputs;
// 0 switches the site off) and scales kept ones by scale_attn /
// scale_hidden.
extern "C" int ctc_bert_layer(const void* x, const void* mask, const void* seeds, const void* wqkv,
                              const void* bqkv, const void* wo, const void* bo, const void* g1,
                              const void* be1, const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* g2, const void* be2, void* x_s,
                              void* wqkv_s, void* wo_s, void* w1_s, void* w2_s, void* qkv_s,
                              void* ctx_s, void* y_s, void* h_s, void* r_ws, void* y_ws, void* h1,
                              void* r2, void* rowstat, void* keep, void* out, int B, int n, int D,
                              int F, int heads, int flags, float eps,
                              float scale, unsigned thresh_attn, unsigned thresh_hidden,
                              float scale_attn, float scale_hidden, void* stream) {
  const void* const w[12] = {wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2};
  const F32Work ws{(bf16*)x_s,   (bf16*)wqkv_s, (bf16*)wo_s, (bf16*)w1_s,
                   (bf16*)w2_s,  (bf16*)qkv_s,  (bf16*)ctx_s, (bf16*)y_s,
                   (bf16*)h_s,   (float*)r_ws,  (float*)y_ws, (float*)(r2 ? r2 : r_ws),
                   (float*)h1,   (float4*)rowstat, (unsigned*)keep};
  const Dropout drop{(const int*)seeds, thresh_attn, thresh_hidden, scale_attn, scale_hidden};
  return forward_chain_f32(static_cast<const float*>(x), static_cast<const float*>(mask), w, ws,
                           static_cast<float*>(out), drop, B, n, D, F, heads, flags, eps, scale,
                           reinterpret_cast<cudaStream_t>(stream));
}
