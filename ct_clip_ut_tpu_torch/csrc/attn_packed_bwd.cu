// Temporal (short-sequence) cosine-attention block, backward: the port of
// ct_clip_ut_tpu/ops/pallas_attn_packed.py:_backward_impl (_bwd_kernel).
//
// The chain of attn_bwd.cuh with no bias (twelve launches): the products on
// the Hopper GEMM core, the core's passes on mma.sync with split-bf16
// scores. The TPU kernel packs several sequences into one masked [r*n, r*n]
// score block to fill its MXU; that packing is not carried over: at n = 24
// (R = B * 576 sequences) each block of the passes takes one (sequence,
// head). Bound on the H100: the projection products (2 * M * 512 * 256 * 9
// FLOP); the core is 24 x 24 per (sequence, head).
#include "attn_bwd.cuh"

using namespace ctc;

// Arguments: those of ctc_attn_block_bwd without bias, biasT and dbias.
extern "C" int ctc_attn_packed_bwd(const void* x, const void* gamma, const void* wq,
                                   const void* wk, const void* wv, const void* wqT,
                                   const void* wkvT, const void* woT, const void* qs,
                                   const void* ks, const void* g, void* xn, void* stats, void* qk,
                                   void* unit, void* norm, void* vw, void* dOw, void* Ow,
                                   void* dqw, void* dkvw, void* mld, void* dxn, void* dxd,
                                   void* dx, void* dgamma, void* dwq, void* dwkv, void* dwo,
                                   void* dqs, void* dks, int R, int n, int D, int H, float scale,
                                   int residual, void* stream) {
  const BwdIn in{(const bf16*)x,   (const float*)gamma, (const bf16*)wq,   (const bf16*)wk,
                 (const bf16*)wv,  (const bf16*)wqT,    (const bf16*)wkvT, (const bf16*)woT,
                 (const float*)qs, (const float*)ks,    nullptr,           (const bf16*)g};
  const BwdWork w{(bf16*)xn,  (float2*)stats, (bf16*)qk,   (float*)unit, (float*)norm,
                  nullptr,    (bf16*)vw,      (bf16*)dOw,  (bf16*)Ow,    (bf16*)dqw,
                  (bf16*)dkvw, (float4*)mld,  (float*)dxn, (float*)dxd};
  const BwdOut out{(bf16*)dx,  (float*)dgamma, (float*)dwq, (float*)dwkv,
                   (float*)dwo, (float*)dqs,   (float*)dks, nullptr};
  return attn_bwd_launch(in, w, out, R, n, D, H, scale, residual,
                         reinterpret_cast<cudaStream_t>(stream));
}
