// Spatial cosine-attention block, backward in fp32: the port of
// ct_clip_ut_tpu/ops/pallas_attn_block.py:_backward_impl (_bwd_kernel) at
// fp32, dx alone for the gradient attribution methods or with every
// parameter gradient for the fp32 train step. The chain is
// attn_bwd_f32.cuh's, its attention passes attn_bwd_wg.cuh's (wgmma, one
// warpgroup a block over 64 query or key rows of one (sequence, head), the
// other operand streamed in 64-row tiles through a TMA ring). At the
// flagship spatial stack (n = 576, 8 heads of 32, bias [8, 576, 576] fp32;
// R = 24 sequences a Grad-CAM, 120 an integrated-gradients chunk of 5, 48 a
// B = 2 train step). Bound on the H100: operations, three bf16 products for
// each fp32 one, 3 * 2 * R * (7 * n * 512 * 256 + 8 * 6 * n^2 * 32) FLOP at
// the bf16 peak for dx alone, 3 * 2 * R * (11 * n * 512 * 256 + 8 * 6 * n^2
// * 32) with the weight gradients (the function's products, counted in
// attn_bwd_f32.cuh; the passes recompute S and dP in both, the dbias pass
// both again).
#include "attn_bwd_f32.cuh"

using ctc::tc::bf16;

// x, g [R*n, D] fp32; gamma [D], qs / ks [32], wq / wk / wv [HD, D], wo [D,
// HD], bias [H, n, n] fp32; the workspaces of tc::block_backward_f32 (xs,
// w_s, wo_s, gs, qk, unit, norm, biasT, v, dO, o, mld, dq, dkv, dxn, dxd);
// out dx [R*n, D] fp32. The train step's form also takes dgamma [D], dw_qkv
// [3 HD, D], dwo [D, HD], dqs / dks [32], dbias [H, n, n] (fp32, written
// whole) and the workspaces ln_part, q_part, k_part, wg_part with
// wg_chunk, the token slices a chunk of the weight gradient (0: none;
// tc::BlockGradsF32); with dgamma null these are unused and the chain
// computes dx alone.
// flags 1: every lo plane zeroed (the control); 2: o and mld hold the
// forward's o planes and row statistics (ctc_attn_block_f32 with its mld),
// and the chain does not rerun the core.
extern "C" int ctc_attn_block_bwd_f32(const void* x, const void* gamma, const void* wq,
                                      const void* wk, const void* wv, const void* wo,
                                      const void* qs, const void* ks, const void* bias,
                                      const void* g, void* xs, void* w_s, void* wo_s, void* gs,
                                      void* qk, void* unit, void* norm, void* biasT, void* v,
                                      void* dO, void* o, void* mld, void* dq, void* dkv,
                                      void* dxn, void* dxd, void* dx, void* dgamma, void* dw_qkv,
                                      void* dwo, void* dqs, void* dks, void* dbias, void* ln_part,
                                      void* q_part, void* k_part, void* wg_part, int R, int n,
                                      int D, int H, float scale, int residual, int wg_chunk,
                                      int flags, void* stream) {
  const ctc::tc::BlockGradsF32 grads{(float*)dgamma,  (float*)dw_qkv, (float*)dwo,
                                     (float*)dqs,     (float*)dks,    (float*)dbias,
                                     (float*)ln_part, (float*)q_part, (float*)k_part,
                                     (float*)wg_part, wg_chunk};
  return ctc::tc::block_backward_f32(
      (const float*)x, (const float*)gamma, (const float*)wq, (const float*)wk, (const float*)wv,
      (const float*)wo, (const float*)qs, (const float*)ks, (const float*)bias, (const float*)g,
      (bf16*)xs, (bf16*)w_s, (bf16*)wo_s, (bf16*)gs, (bf16*)qk, (float*)unit, (float*)norm,
      (float*)biasT, (bf16*)v, (bf16*)dO, (bf16*)o, (float4*)mld, (bf16*)dq, (bf16*)dkv,
      (float*)dxn, (float*)dxd, (float*)dx, dgamma != nullptr ? &grads : nullptr, R, n, D, H,
      scale, residual, !(flags & 1), (flags & 2) != 0, reinterpret_cast<cudaStream_t>(stream));
}

// Largest sequence length both fp32 backward entries take.
extern "C" int ctc_attn_bwd_f32_max_n(void) { return ctc::tc::bwd_f32_max_n(); }
