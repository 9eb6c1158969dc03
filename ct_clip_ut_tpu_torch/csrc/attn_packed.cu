// Temporal (short-sequence) cosine-attention block: the port of
// ct_clip_ut_tpu/ops/pallas_attn_packed.py:attention_block_packed
// (_forward / _kernel).
//
// out = (softmax(l2n(LN(x) Wq^T) qs*scale . l2n(x Wk^T) ks) (x Wv^T)) Wo^T (+ x)
// over R sequences of n tokens (the CT-ViT temporal stack: n = 24, R = B *
// 576, 8 heads of 32): the block of attn_block.cu without the bias. The TPU
// kernel packs (token, head) pairs into one masked [192, 192] matmul to
// fill its 128-wide MXU; that packing is a TPU artefact and is not carried
// over.
//
// What bounds it on the H100: the four projections (2 * M * 512 * 256 * 4
// FLOP, 29 GFLOP at M = 27,648) and the bytes of x, the workspaces and the
// output; the core is 24 x 24 scores per (sequence, head). The chain is the
// spatial block's, tc::block_forward of attn_mma.cuh (four launches):
// ln_rows_kernel writes xn; QkvPlan + QkvEpi on the Hopper GEMM core
// (gemm_sm90.cuh) write q / k as bf16 hi / lo planes and v; the split-bf16
// core (one block a sequence and head, one warp per 16 query rows: two at
// n = 24, keys padded to 64 with zeros and masked to -inf) writes o; a
// LinearPlan GEMM writes o Wo^T with the residual added in fp32. The fp32
// variant (ctc_attn_packed_f32) is tc::block_forward_f32 without the bias
// (attn_fwd_packed.cuh): its products each K slice's four planes staged
// once (split4_kernel), its core at n <= 64 whole (sequence, head) items,
// one warp an item, keys padded to 16, fed by a TMA ring.
#include "attn_fwd_packed.cuh"

// The arguments of ctc_attn_block without the bias.
extern "C" int ctc_attn_packed(const void* x, const void* gamma, const void* wq, const void* wk,
                               const void* wv, const void* wo, const void* qs, const void* ks,
                               void* xn, void* qk, void* v_ws, void* o_ws, void* out, int R,
                               int n, int D, int H, float scale, int residual, void* stream) {
  return ctc::tc::block_forward(x, gamma, wq, wk, wv, wo, qs, ks, nullptr, xn, qk, v_ws, o_ws,
                                out, R, n, D, H, scale, residual,
                                reinterpret_cast<cudaStream_t>(stream));
}

// Largest sequence length the core holds: its staged keys and values fit a
// block's shared memory.
extern "C" int ctc_attn_packed_max_n(void) { return ctc::tc::core_max_keys(); }

// The fp32 variant: the arguments of ctc_attn_block_f32 without the bias
// and mld (the temporal backward reruns its core).
extern "C" int ctc_attn_packed_f32(const void* x, const void* gamma, const void* wq,
                                   const void* wk, const void* wv, const void* wo, const void* qs,
                                   const void* ks, void* xs, void* w_s, void* wo_s, void* qk,
                                   void* v_ws, void* o_ws, void* out, int R, int n, int D, int H,
                                   float scale, int residual, int flags, void* stream) {
  using ctc::tc::bf16;
  return ctc::tc::block_forward_f32(
      (const float*)x, (const float*)gamma, (const float*)wq, (const float*)wk, (const float*)wv,
      (const float*)wo, (const float*)qs, (const float*)ks, nullptr, (bf16*)xs, (bf16*)w_s,
      (bf16*)wo_s, (bf16*)qk, (bf16*)v_ws, (bf16*)o_ws, nullptr, (float*)out, R, n, D, H, scale,
      residual, !(flags & 1), reinterpret_cast<cudaStream_t>(stream));
}
