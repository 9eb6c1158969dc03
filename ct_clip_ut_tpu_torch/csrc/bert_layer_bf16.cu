// One post-LN BERT encoder layer in bf16, deterministic or in train mode with
// dropout: the port of ct_clip_ut_tpu/ops/pallas_bert_layer.py:_fwd_impl
// (`_kernel_fwd` / `_fwd_body`) as the train step runs it (reports of 512
// tokens, bf16, dropout 0.1 on the attention probabilities and both hidden
// outputs). The fp32 deterministic chain of the zero-shot prompts stays in
// bert_layer.cu.
//
//   qkv = x Wqkv^T + bqkv (fp32 sums, q / k / v used as bf16 operands);
//   p = softmax(q k^T / sqrt(dh) + mask) in fp32, normalised, times the
//   attention keep mask, rounded to bf16; ctx = p v (bf16 as an operand);
//   r1 = (ctx Wo^T + bo) keep1 + x;  y = LN1(r1) in fp32;
//   h1 = bf16(y) W1^T + b1;  g = bf16(gelu_erf(h1));
//   r2 = (g W2^T + b2) keep2 + y (fp32);  out = bf16(LN2(r2)).
//
// What bounds it on the H100: tensor-core operations, 2 B n D (3D + D + 2F) +
// 4 B heads n^2 dh (16.1 GFLOP at B = 2, n = 512: 16 us at the bf16 peak);
// the bytes (3 MB of activations, 14 MB of bf16 weights) take a third of
// that. The TPU kernel holds a sequence's whole layer in VMEM; here the
// layer is seven launches (bert_bf16.cuh) whose intermediates pass through
// global memory, rounded where the TPU kernel rounds. The four products run
// on the Hopper core (gemm_sm90.cuh: TMA ring, wgmma, epilogues from the
// accumulator registers); the attention core is a two-pass mma.sync kernel
// over 64-key chunks (pass 1 the row statistics, pass 2 the normalised,
// masked, rounded p and P.V), so no score row is kept whole. The masks are
// Philox4x32-10 bits computed in the epilogues and the core
// (bert_bf16.cuh), not the TPU's hardware PRNG: the same rates, other bits.
#include "bert_bf16.cuh"

namespace ctc {
namespace bh {

// mask[(b * heads + h) * inner + i] = the keep factor of position i of the
// slab (site, b, h): what the layer's kernels compute in their epilogues,
// exposed so that a run can hold it bit for bit against the plain version's
// generator. inner a multiple of 4.
__global__ void keep_mask_kernel(const int* __restrict__ seeds, unsigned site, int B, int heads,
                                 int inner, unsigned thresh, float scale,
                                 float* __restrict__ out) {
  const int64_t quads = (int64_t)B * heads * (inner / 4);
  for (int64_t q = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; q < quads;
       q += (int64_t)gridDim.x * blockDim.x) {
    const int idx = (int)(q % (inner / 4)) * 4;
    const int slab = (int)(q / (inner / 4));
    const float4 k = keep4(seeds[site], site, slab / heads, slab % heads, (unsigned)idx, thresh,
                           scale);
    *reinterpret_cast<float4*>(out + (int64_t)slab * inner + idx) = k;
  }
}

}  // namespace bh
}  // namespace ctc

using namespace ctc::bh;

// x [B * npad, D] bf16; mask [B, npad] fp32 (additive); seeds [3] int32 (read
// only when a threshold is non-zero); wqkv [3D, D], wo [D, D], w1 [F, D],
// w2 [D, F] (nn.Linear (out, in)) bf16, or fp32 with weights_f32 (cast into
// wbf16 [3D D + D D + 2 F D] bf16 by the chain's first launch); the biases
// and LN parameters fp32. Workspaces as Work (rowstat and keep null: the
// forward alone). out [B * npad, D] bf16. D = heads * 64, F a multiple of
// 8, npad a multiple of 64, n a multiple of 4; every pointer 16-B aligned.
extern "C" int ctc_bert_layer_bf16(
    const void* x, const void* mask, const void* seeds, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, const void* g1, const void* be1, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* g2, const void* be2,
    void* wbf16, void* qkv, void* ctx, void* r1, void* stats1, void* yf, void* yb, void* h1,
    void* g, void* r2, void* stats2, void* out, int weights_f32, int B, int n, int npad, int D,
    int F, int heads, float eps, float scale, unsigned thresh_attn, unsigned thresh_hidden,
    float scale_attn, float scale_hidden, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const void* const p[12] = {wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2};
  Weights w;
  int err = chain_weights(p, weights_f32, wbf16, D, F, w, st);
  if (err) return err;
  const Work ws{(bf16*)qkv, (bf16*)ctx, (float*)r1, (float2*)stats1, (float*)yf, (bf16*)yb,
                (float*)h1, (bf16*)g, (float*)r2, (float2*)stats2, nullptr, nullptr};
  const Dropout drop{(const int*)seeds, thresh_attn, thresh_hidden, scale_attn, scale_hidden};
  return forward_chain((const bf16*)x, (const float*)mask, w, ws, (bf16*)out, drop, B, n, npad, D,
                       F, heads, eps, scale, st);
}

// out [B, heads, inner] fp32: the keep factors of one dropout site.
extern "C" int ctc_bert_keep_mask(const void* seeds, unsigned site, int B, int heads, int inner,
                                  unsigned thresh, float scale, void* out, void* stream) {
  if (inner % 4) return (int)cudaErrorInvalidValue;
  keep_mask_kernel<<<1024, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int*)seeds, site, B, heads, inner, thresh, scale, (float*)out);
  return (int)cudaGetLastError();
}
