// Spatial cosine-attention block: the port of
// ct_clip_ut_tpu/ops/pallas_attn_block.py:attention_block_fused
// (_forward_impl / _kernel).
//
// out = (softmax(l2n(LN(x) Wq^T) qs*scale . l2n(x Wk^T) ks + bias) (x Wv^T)) Wo^T (+ x)
// over R sequences of n tokens (the CT-ViT spatial stack: n = 576, 8 heads
// of 32, bias [8, 576, 576] fp32).
//
// What bounds it on the H100: the four projections are tensor-core GEMMs
// (2 * M * 512 * 256 * 4 FLOP); the core is 2 * R * 8 * n^2 * 32 * 2 FLOP
// on the CUDA cores in fp32 and is bound by shared-memory bandwidth (every
// score reads one staged 128-B key row). The design keeps q/k fp32 from the
// projection through the l2norm and the scores, as the TPU kernel does,
// and stages each head's keys (fp32) and values (bf16) in shared memory once
// per block of 96 query rows; the bias streams from L2 (10.6 MB, resident).
//
// Chain of three launches: qkv_proj_kernel -> attn_core_kernel ->
// out_proj_kernel. Workspaces are allocated by the caller.
#include "attn_common.cuh"

namespace ctc {

constexpr int CORE_THREADS = 512;
constexpr int CORE_WARPS = CORE_THREADS / 32;
constexpr int BQ = 96;

__global__ void __launch_bounds__(CORE_THREADS)
attn_core_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ o, int n, int HD) {
  extern __shared__ __align__(128) char smem[];
  const int r = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * BQ;
  float* ks = reinterpret_cast<float*>(smem);                  // [n][KS_LD]
  float* qrows = ks + n * KS_LD;                              // [warps][DH]
  float* prows = qrows + CORE_WARPS * DH;                     // [warps][n]
  bf16* vs = reinterpret_cast<bf16*>(prows + CORE_WARPS * n);  // [n][DH]
  const int64_t row0 = (int64_t)r * n;
  stage_kv(k, v, row0, n, HD, h, ks, vs, threadIdx.x, CORE_THREADS);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qrow = qrows + warp * DH;
  float* prow = prows + warp * n;
  const int q1 = min(q0 + BQ, n);
  for (int i = q0 + warp; i < q1; i += CORE_WARPS) {
    qrow[lane] = q[(row0 + i) * HD + h * DH + lane];
    __syncwarp();
    const float* brow = bias + ((int64_t)h * n + i) * n;
    float out = attend_row(qrow, ks, vs, brow, n, prow, lane);
    o[(row0 + i) * HD + h * DH + lane] = __float2bfloat16(out);
  }
}

size_t core_smem_bytes(int n) {
  return (size_t)n * KS_LD * 4 + CORE_WARPS * DH * 4 + (size_t)CORE_WARPS * n * 4 +
         (size_t)n * DH * 2;
}

}  // namespace ctc

using namespace ctc;

// x [R*n, D] bf16; gamma [D], qs/ks [32], bias [H, n, n] fp32; wq/wk/wv
// [HD, D], wo [D, HD] bf16; q_ws/k_ws [R*n, HD] fp32; v_ws/o_ws [R*n, HD]
// bf16; out [R*n, D] bf16. Returns cudaGetLastError() after the launches.
extern "C" int ctc_attn_block(const void* x, const void* gamma, const void* wq, const void* wk,
                              const void* wv, const void* wo, const void* qs, const void* ks,
                              const void* bias, void* q_ws, void* k_ws, void* v_ws, void* o_ws,
                              void* out, int R, int n, int D, int H, float scale, int residual,
                              void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = R * n, HD = H * DH;
  const int smem_proj = GEMM_SMEM + BM * (int)sizeof(float2);
  cudaFuncSetAttribute(qkv_proj_kernel<>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_proj);
  cudaFuncSetAttribute(out_proj_kernel<>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  const size_t smem_core = core_smem_bytes(n);
  cudaFuncSetAttribute(attn_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_core);

  dim3 gp(3 * HD / BN, (M + BM - 1) / BM);
  qkv_proj_kernel<><<<gp, THREADS, smem_proj, st>>>(
      (const bf16*)x, (const float*)gamma, (const bf16*)wq, (const bf16*)wk, (const bf16*)wv,
      (const float*)qs, (const float*)ks, (float*)q_ws, (float*)k_ws, (bf16*)v_ws, M, D, HD,
      scale);
  dim3 gc(R, H, (n + BQ - 1) / BQ);
  attn_core_kernel<<<gc, CORE_THREADS, smem_core, st>>>(
      (const float*)q_ws, (const float*)k_ws, (const bf16*)v_ws, (const float*)bias,
      (bf16*)o_ws, n, HD);
  dim3 go((D + BN - 1) / BN, (M + BM - 1) / BM);
  out_proj_kernel<><<<go, THREADS, GEMM_SMEM, st>>>((const bf16*)o_ws, (const bf16*)wo,
                                                    (const bf16*)x, (bf16*)out, M, D, HD,
                                                    residual);
  return (int)cudaGetLastError();
}

// Largest sequence length whose staged keys/values fit the block's shared memory.
extern "C" int ctc_attn_block_max_n(void) {
  int n = 32;
  while (core_smem_bytes(n + 32) <= 227 * 1024) n += 32;
  return n;
}
