// Spatial cosine-attention block, backward in fp32, the data gradient only:
// the port of ct_clip_ut_tpu/ops/pallas_attn_block.py:_backward_impl
// (_bwd_kernel) at fp32 for the gradient attribution methods. The chain
// and its design are in attn_bwd_f32.cuh. At the flagship spatial stack (n
// = 576, 8 heads of 32, bias [8, 576, 576] fp32; R = 24 sequences a
// Grad-CAM, 120 an integrated-gradients chunk of 5) the passes run 8 warps
// a block over 128 query or key rows of one (sequence, head), one block an
// SM (four staged planes, 147 KB). Bound on the H100: operations, three
// bf16 products for each fp32 one, 3 * 2 * R * (7 * n * 512 * 256 + 8 * 6
// * n^2 * 32) FLOP at the bf16 peak (the function's products, counted in
// attn_bwd_f32.cuh; the passes recompute four n^2 products more).
#include "attn_bwd_f32.cuh"

using ctc::tc::bf16;

// x, g [R*n, D] fp32; gamma [D], qs / ks [32], wq / wk / wv [HD, D], wo [D,
// HD], bias [H, n, n] fp32; the workspaces of tc::block_backward_f32 (xs,
// w_s, wo_s, gs, qk, unit, norm, biasT, v, dO, o, mld, dq, dkv, dxn, dxd);
// out dx [R*n, D] fp32. flags 1: every lo plane zeroed (the control).
extern "C" int ctc_attn_block_bwd_f32(const void* x, const void* gamma, const void* wq,
                                      const void* wk, const void* wv, const void* wo,
                                      const void* qs, const void* ks, const void* bias,
                                      const void* g, void* xs, void* w_s, void* wo_s, void* gs,
                                      void* qk, void* unit, void* norm, void* biasT, void* v,
                                      void* dO, void* o, void* mld, void* dq, void* dkv,
                                      void* dxn, void* dxd, void* dx, int R, int n, int D, int H,
                                      float scale, int residual, int flags, void* stream) {
  return ctc::tc::block_backward_f32(
      (const float*)x, (const float*)gamma, (const float*)wq, (const float*)wk, (const float*)wv,
      (const float*)wo, (const float*)qs, (const float*)ks, (const float*)bias, (const float*)g,
      (bf16*)xs, (bf16*)w_s, (bf16*)wo_s, (bf16*)gs, (bf16*)qk, (float*)unit, (float*)norm,
      (float*)biasT, (bf16*)v, (bf16*)dO, (bf16*)o, (float4*)mld, (bf16*)dq, (bf16*)dkv,
      (float*)dxn, (float*)dxd, (float*)dx, R, n, D, H, scale, residual, !(flags & 1),
      reinterpret_cast<cudaStream_t>(stream));
}

// Largest sequence length both fp32 backward entries take.
extern "C" int ctc_attn_bwd_f32_max_n(void) { return ctc::tc::bwd_f32_max_n(); }
