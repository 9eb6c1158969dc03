// Temporal (short-sequence) cosine-attention block: the port of
// ct_clip_ut_tpu/ops/pallas_attn_packed.py:attention_block_packed
// (_forward / _kernel).
//
// The same block as attn_block.cu with no bias, for the CT-ViT temporal
// stack (n = 24 tokens per sequence, R = B * 576 sequences). The TPU kernel
// packs (token, head) pairs into one masked [192, 192] matmul to fill its
// 128-wide MXU; that packing is a TPU artefact and is not carried over.
//
// What bounds it on the H100: the projections (tensor-core GEMMs, the same
// 2 * M * 512 * 256 * 4 FLOP as the spatial block) dominate; the core is
// 24 x 24 scores per (sequence, head), a few KB per warp. The design gives
// each (sequence, head) one warp that stages its keys and values in its own
// slice of shared memory and runs all n query rows; any number of sequences
// works.
//
// Chain of three launches: qkv_proj_kernel -> packed_core_kernel ->
// out_proj_kernel.
#include "attn_common.cuh"

namespace ctc {

constexpr int PK_WARPS = 4;

__host__ __device__ __forceinline__ size_t packed_warp_floats(int n) {
  // keys [n][KS_LD] + q row [DH] + p row [n, rounded to 4] + values [n][DH] bf16
  return (size_t)n * KS_LD + DH + ((n + 3) & ~3) + (size_t)n * DH / 2;
}

__global__ void __launch_bounds__(PK_WARPS * 32)
packed_core_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int R, int n, int H) {
  extern __shared__ __align__(128) char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x * PK_WARPS + warp;          // (sequence, head)
  if (pair >= R * H) return;
  const int r = pair / H, h = pair % H;
  const int HD = H * DH;
  float* base = reinterpret_cast<float*>(smem) + warp * packed_warp_floats(n);
  float* ks = base;
  float* qrow = ks + n * KS_LD;
  float* prow = qrow + DH;
  bf16* vs = reinterpret_cast<bf16*>(prow + ((n + 3) & ~3));
  const int64_t row0 = (int64_t)r * n;
  stage_kv(k, v, row0, n, HD, h, ks, vs, lane, 32);
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    qrow[lane] = q[(row0 + i) * HD + h * DH + lane];
    __syncwarp();
    float out = attend_row(qrow, ks, vs, n, prow, lane);
    o[(row0 + i) * HD + h * DH + lane] = __float2bfloat16(out);
  }
}

}  // namespace ctc

using namespace ctc;

// Same arguments as ctc_attn_block, without the bias.
extern "C" int ctc_attn_packed(const void* x, const void* gamma, const void* wq, const void* wk,
                               const void* wv, const void* wo, const void* qs, const void* ks,
                               void* q_ws, void* k_ws, void* v_ws, void* o_ws, void* out, int R,
                               int n, int D, int H, float scale, int residual, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = R * n, HD = H * DH;
  const int smem_proj = GEMM_SMEM + BM * (int)sizeof(float2);
  cudaFuncSetAttribute(qkv_proj_kernel<>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_proj);
  cudaFuncSetAttribute(out_proj_kernel<>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  const size_t smem_core = PK_WARPS * packed_warp_floats(n) * sizeof(float);
  cudaFuncSetAttribute(packed_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_core);

  dim3 gp(3 * HD / BN, (M + BM - 1) / BM);
  qkv_proj_kernel<><<<gp, THREADS, smem_proj, st>>>(
      (const bf16*)x, (const float*)gamma, (const bf16*)wq, (const bf16*)wk, (const bf16*)wv,
      (const float*)qs, (const float*)ks, (float*)q_ws, (float*)k_ws, (bf16*)v_ws, M, D, HD,
      scale);
  const int pairs = R * H;
  packed_core_kernel<<<(pairs + PK_WARPS - 1) / PK_WARPS, PK_WARPS * 32, smem_core, st>>>(
      (const float*)q_ws, (const float*)k_ws, (const bf16*)v_ws, (bf16*)o_ws, R, n, H);
  dim3 go((D + BN - 1) / BN, (M + BM - 1) / BM);
  out_proj_kernel<><<<go, THREADS, GEMM_SMEM, st>>>((const bf16*)o_ws, (const bf16*)wo,
                                                    (const bf16*)x, (bf16*)out, M, D, HD,
                                                    residual);
  return (int)cudaGetLastError();
}

// Largest sequence length whose per-warp staging fits the block's shared memory.
extern "C" int ctc_attn_packed_max_n(void) {
  int n = 8;
  while (PK_WARPS * packed_warp_floats(n + 8) * sizeof(float) <= 227 * 1024) n += 8;
  return n;
}
