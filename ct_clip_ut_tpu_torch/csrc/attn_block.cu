// Spatial cosine-attention block: the port of
// ct_clip_ut_tpu/ops/pallas_attn_block.py:attention_block_fused
// (_forward_impl / _kernel).
//
// out = (softmax(l2n(LN(x) Wq^T) qs*scale . l2n(x Wk^T) ks + bias) (x Wv^T)) Wo^T (+ x)
// over R sequences of n tokens (the CT-ViT spatial stack: n = 576, 8 heads
// of 32, bias [8, 576, 576] fp32).
//
// What bounds it on the H100: the four projections are tensor-core GEMMs
// (2 * M * 512 * 256 * 4 FLOP); the core's 2 * R * 8 * n^2 * 32 * 2 FLOP,
// one exp per score and the fp32 bias, read from L2 for every (sequence,
// head). Four launches, the chain tc::block_forward of attn_mma.cuh that
// the temporal block (attn_packed.cu) shares:
//   ln_rows_kernel      xn = LN(x) * gamma (no beta), bf16;
//   gemm_kernel         q from xn, k and v from the pre-norm x, on the
//                       Hopper core of gemm_sm90.cuh (QkvPlan picks the maps
//                       a tile reads). The q / k epilogue l2-normalises each
//                       32-wide head in registers (a head's columns of a row
//                       sit in one quad of 4 threads: two shuffles give the
//                       norm), applies q_scale * scale / k_scale and writes
//                       the fp32 result as a bf16 pair hi = bf16(y), lo =
//                       bf16(y - hi), 4 B an element like an fp32
//                       workspace; v is rounded to bf16 (the TPU kernel's
//                       cast before PV);
//   block_core_kernel   the core on the tensor cores (mma.sync m16n8k16),
//                       shared with the backward and the bare cosine core
//                       (attn_mma.cuh): scores as q_hi.k_hi + q_hi.k_lo +
//                       q_lo.k_hi in fp32, within ~2^-16 of the fp32 scores
//                       the TPU kernel takes (one bf16 product would err by
//                       ~1e-2 at scale 8); K hi / lo and V of one (sequence,
//                       head) staged in shared memory once a block; each
//                       warp takes 16 query rows in two passes: the running
//                       row max and sum, then the scores again, p = exp(s -
//                       m) / l rounded to bf16 (the TPU kernel's rounding
//                       point) and P.V with p fed from the score registers;
//                       o rounded to bf16;
//   gemm_kernel         O . Wo^T with the residual added in fp32.
// The fp32 variant (ctc_attn_block_f32) runs the same chain with every
// product as three bf16 products of hi / lo planes, P.V included:
// tc::block_forward_f32 (attn_fwd_packed.cuh). Its bound: three times the bf16
// operations at the bf16 peak.
#include "attn_fwd_packed.cuh"

// x [R*n, D] bf16 (D a multiple of 8); gamma [D], qs/ks [32], bias [H, n, n]
// fp32; wq/wk/wv [HD, D], wo [D, HD] bf16; xn [R*n, D], qk [4, R*n, HD]
// (q_hi, q_lo, k_hi, k_lo), v_ws / o_ws [R*n, HD] bf16 workspaces; out
// [R*n, D] bf16. HD = H * 32, a multiple of 128; every pointer 16-B aligned.
extern "C" int ctc_attn_block(const void* x, const void* gamma, const void* wq, const void* wk,
                              const void* wv, const void* wo, const void* qs, const void* ks,
                              const void* bias, void* xn, void* qk, void* v_ws, void* o_ws,
                              void* out, int R, int n, int D, int H, float scale, int residual,
                              void* stream) {
  return ctc::tc::block_forward(x, gamma, wq, wk, wv, wo, qs, ks,
                                static_cast<const float*>(bias), xn, qk, v_ws, o_ws, out, R, n,
                                D, H, scale, residual, reinterpret_cast<cudaStream_t>(stream));
}

// Largest sequence length whose staged keys and values fit a block's shared memory.
extern "C" int ctc_attn_block_max_n(void) { return ctc::tc::core_max_keys(); }

// The fp32 variant (the JAX kernel at fp32: every rounding point an
// identity), tc::block_forward_f32: the arguments of ctc_attn_block in fp32,
// the workspaces xs [4][R*n][D], w_s [2][3 HD][D], wo_s [2][D][HD], qk
// [4][R*n][HD], v_ws / o_ws [2][R*n][HD] bf16, out [R*n, D] fp32; mld
// [R][H][n] float4 or null: with it the forward keeps its row statistics
// beside o's planes in o_ws for the backward (flags 2 of
// ctc_attn_block_bwd_f32); flags 1: every lo plane zeroed (one bf16 product
// for each fp32 one, the control).
extern "C" int ctc_attn_block_f32(const void* x, const void* gamma, const void* wq,
                                  const void* wk, const void* wv, const void* wo, const void* qs,
                                  const void* ks, const void* bias, void* xs, void* w_s,
                                  void* wo_s, void* qk, void* v_ws, void* o_ws, void* mld,
                                  void* out, int R, int n, int D, int H, float scale, int residual,
                                  int flags, void* stream) {
  using ctc::tc::bf16;
  return ctc::tc::block_forward_f32(
      (const float*)x, (const float*)gamma, (const float*)wq, (const float*)wk, (const float*)wv,
      (const float*)wo, (const float*)qs, (const float*)ks, (const float*)bias, (bf16*)xs,
      (bf16*)w_s, (bf16*)wo_s, (bf16*)qk, (bf16*)v_ws, (bf16*)o_ws, (float4*)mld, (float*)out, R,
      n, D, H, scale, residual, !(flags & 1), reinterpret_cast<cudaStream_t>(stream));
}

// Largest sequence length of the fp32 core (four staged planes), both blocks.
extern "C" int ctc_attn_f32_max_n(void) { return ctc::tc::core_max_keys(4); }
