// Spatial cosine-attention block, backward: the port of
// ct_clip_ut_tpu/ops/pallas_attn_block.py:_backward_impl (_bwd_kernel).
//
// The chain and its design are in attn_bwd.cuh (thirteen launches). At the
// flagship spatial stack (R = 48 sequences of n = 576, 8 heads of 32, bias
// [8, 576, 576]) the core passes run 16 warps per block over 96 rows of one
// (sequence, head); dbias is summed over the 48 sequences with fp32
// atomicAdd (2.65 M values per sequence). Bound on the H100: the projection
// products on the tensor cores (2 * M * 512 * 256 * 9 FLOP) and the n^2
// core (8 * 6 * n^2 * 32 FLOP per sequence and head) on the CUDA cores.
#include "attn_bwd.cuh"

using namespace ctc;

// Arguments: see attn_bwd_launch. bias [H, n, n] fp32 and dbias likewise.
extern "C" int ctc_attn_block_bwd(const void* x, const void* gamma, const void* wq, const void* wk,
                                  const void* wv, const void* wqT, const void* wkvT,
                                  const void* woT, const void* qs, const void* ks,
                                  const void* bias, const void* g, void* xn, void* stats, void* qw,
                                  void* kw, void* vw, void* dOw, void* Ow, void* dqw, void* dkvw,
                                  void* mld, void* dxn, void* dxd, void* dx, void* dgamma,
                                  void* dwq, void* dwkv, void* dwo, void* dqs, void* dks,
                                  void* dbias, int R, int n, int D, int H, float scale,
                                  int residual, void* stream) {
  return attn_bwd_launch(
      (const bf16*)x, (const float*)gamma, (const bf16*)wq, (const bf16*)wk, (const bf16*)wv,
      (const bf16*)wqT, (const bf16*)wkvT, (const bf16*)woT, (const float*)qs, (const float*)ks,
      (const float*)bias, (const bf16*)g, (bf16*)xn, (float2*)stats, (float*)qw, (float*)kw,
      (bf16*)vw, (bf16*)dOw, (bf16*)Ow, (bf16*)dqw, (bf16*)dkvw, (float4*)mld, (float*)dxn,
      (float*)dxd, (bf16*)dx, (float*)dgamma, (float*)dwq, (float*)dwkv, (float*)dwo,
      (float*)dqs, (float*)dks, (float*)dbias, R, n, D, H, scale, residual,
      reinterpret_cast<cudaStream_t>(stream));
}

// Largest sequence length the backward's staged rows fit.
extern "C" int ctc_attn_bwd_max_n(void) { return attn_bwd_max_n(); }
