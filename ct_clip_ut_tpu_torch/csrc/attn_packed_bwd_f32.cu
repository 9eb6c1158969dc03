// Temporal (short-sequence) cosine-attention block, backward in fp32: the
// port of ct_clip_ut_tpu/ops/pallas_attn_packed.py:_backward_impl
// (_bwd_kernel) at fp32, dx alone for the gradient attribution methods or
// with every parameter gradient for the fp32 train step (R = 1152
// sequences at B = 2): attn_block_bwd_f32.cu's chain (attn_bwd_f32.cuh)
// without the bias, its transpose and dbias. At the CT-ViT temporal stack
// (n = 24, 8 heads of 32; R = 576 sequences a Grad-CAM, 2880 an
// integrated-gradients chunk of 5) its attention is one fused pass over
// whole (sequence, head) rows, D = rowsum(P dP) (attn_bwd_packed.cuh);
// above n = 64 the fp32 core and the spatial block's wgmma passes without
// a bias. Bound on the H100: operations, 3 * 2 * R * (7 * n * 512 * 256 +
// 8 * 6 * n^2 * 32) FLOP at the bf16 peak (11 * n * 512 * 256 with the
// weight gradients), the projections nearly all of it (the core is 24 x 24
// scores per sequence and head); its attention pass alone is bound by
// bytes.
#include "attn_bwd_f32.cuh"

using ctc::tc::bf16;

// The arguments of ctc_attn_block_bwd_f32 without the bias, biasT and
// dbias; mld is unused at n <= 64, and o there only in the train form.
extern "C" int ctc_attn_packed_bwd_f32(const void* x, const void* gamma, const void* wq,
                                       const void* wk, const void* wv, const void* wo,
                                       const void* qs, const void* ks, const void* g, void* xs,
                                       void* w_s, void* wo_s, void* gs, void* qk, void* unit,
                                       void* norm, void* v, void* dO, void* o, void* mld,
                                       void* dq, void* dkv, void* dxn, void* dxd, void* dx,
                                       void* dgamma, void* dw_qkv, void* dwo, void* dqs,
                                       void* dks, void* ln_part, void* q_part, void* k_part,
                                       void* wg_part, int R, int n, int D, int H, float scale,
                                       int residual, int wg_chunk, int flags, void* stream) {
  const ctc::tc::BlockGradsF32 grads{(float*)dgamma, (float*)dw_qkv,  (float*)dwo,
                                     (float*)dqs,    (float*)dks,     nullptr,
                                     (float*)ln_part, (float*)q_part, (float*)k_part,
                                     (float*)wg_part, wg_chunk};
  return ctc::tc::block_backward_f32(
      (const float*)x, (const float*)gamma, (const float*)wq, (const float*)wk, (const float*)wv,
      (const float*)wo, (const float*)qs, (const float*)ks, nullptr, (const float*)g, (bf16*)xs,
      (bf16*)w_s, (bf16*)wo_s, (bf16*)gs, (bf16*)qk, (float*)unit, (float*)norm, nullptr,
      (bf16*)v, (bf16*)dO, (bf16*)o, (float4*)mld, (bf16*)dq, (bf16*)dkv, (float*)dxn,
      (float*)dxd, (float*)dx, dgamma != nullptr ? &grads : nullptr, R, n, D, H, scale, residual,
      !(flags & 1), 0, reinterpret_cast<cudaStream_t>(stream));
}
