// Spatial cosine-attention block, backward: the port of
// ct_clip_ut_tpu/ops/pallas_attn_block.py:_backward_impl (_bwd_kernel).
//
// The chain and its design are in attn_bwd.cuh (fourteen launches). At the flagship spatial stack (R = 48 sequences of
// n = 576, 8 heads of 32, bias [8, 576, 576]) the forward-statistics,
// query and key passes run 8 warps a block over 128 query or key rows of
// one (sequence, head), each warp 16 rows on mma.sync with split-bf16
// scores; the dbias pass runs 4 warps over a 64 x 64 block of one head and
// sums dS over the 48 sequences in registers (no atomics). Bound on the
// H100: operations, 2 * R * (9 * n * 512 * 256 + 8 * 6 * n^2 * 32) FLOP at
// the bf16 peak (the function's products; the split scores and the passes'
// recomputation take ~2.5x the core's share of them).
#include "attn_bwd.cuh"

using namespace ctc;

// x [R*n, D] bf16; gamma [D], qs / ks [32], bias [H, n, n] fp32; wq / wk /
// wv [HD, D], wqT [D, HD], wkvT [D, 2HD], woT [HD, D], g [R*n, D] bf16;
// workspaces xn [R*n, D] bf16, stats [R*n, 2] fp32, qk [4, R*n, HD] bf16,
// unit [2, R*n, HD] fp32, norm [2, R*n, H] fp32, biasT [H, n, n] fp32, vw / dOw / Ow / dqw [R*n,
// HD] bf16, dkvw [R*n, 2HD] bf16, mld [R*H*n, 4] fp32, dxn / dxd [R*n, D]
// fp32; outputs dx [R*n, D] bf16, dgamma [D], dwq [HD, D], dwkv [2HD, D],
// dwo [D, HD], dqs / dks [32], dbias [H, n, n] fp32 (all but dx and dbias
// zeroed; dbias written whole by its pass). bias, biasT and dbias may be null.
extern "C" int ctc_attn_block_bwd(const void* x, const void* gamma, const void* wq, const void* wk,
                                  const void* wv, const void* wqT, const void* wkvT,
                                  const void* woT, const void* qs, const void* ks,
                                  const void* bias, const void* g, void* xn, void* stats, void* qk,
                                  void* unit, void* norm, void* biasT, void* vw, void* dOw,
                                  void* Ow, void* dqw, void* dkvw, void* mld, void* dxn,
                                  void* dxd, void* dx, void* dgamma, void* dwq, void* dwkv,
                                  void* dwo, void* dqs, void* dks, void* dbias, int R, int n,
                                  int D, int H, float scale, int residual, void* stream) {
  const BwdIn in{(const bf16*)x,   (const float*)gamma, (const bf16*)wq,   (const bf16*)wk,
                 (const bf16*)wv,  (const bf16*)wqT,    (const bf16*)wkvT, (const bf16*)woT,
                 (const float*)qs, (const float*)ks,    (const float*)bias, (const bf16*)g};
  const BwdWork w{(bf16*)xn,  (float2*)stats, (bf16*)qk,   (float*)unit, (float*)norm,
                  (float*)biasT, (bf16*)vw,   (bf16*)dOw,  (bf16*)Ow,    (bf16*)dqw,
                  (bf16*)dkvw, (float4*)mld,  (float*)dxn, (float*)dxd};
  const BwdOut out{(bf16*)dx,  (float*)dgamma, (float*)dwq, (float*)dwkv,
                   (float*)dwo, (float*)dqs,   (float*)dks, (float*)dbias};
  return attn_bwd_launch(in, w, out, R, n, D, H, scale, residual,
                         reinterpret_cast<cudaStream_t>(stream));
}

// Largest sequence length both backward entries take.
extern "C" int ctc_attn_bwd_max_n(void) { return attn_bwd_max_n(); }
