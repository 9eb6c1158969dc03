// Bare cosine-attention core: the port of
// ct_clip_ut_tpu/ops/pallas_attention.py:cosine_attention_fused
// (_forward_impl / _kernel).
//
// o = softmax((l2n(q) q_scale scale) . (l2n(k) k_scale)^T + bias) v
// per (batch * head) slice: q [BH, n, 32], k / v [BH, m, 32] bf16; bias
// [h, n, m] fp32 shared across the batch (slice bh takes head bh % h), or
// none. The route from ops/attention.py: a cross-attention with neither null
// key/values nor a mask, after the projections.
//
// What bounds it on the H100: 4 * BH * n * m * 32 FLOP of scores and PV
// (at [384, 576, 32] with the [8, 576, 576] bias, 16.3 GFLOP: 0.016 ms at
// the bf16 tensor-core peak, 0.24 ms at the fp32 CUDA-core rate this core
// runs at) against 67 MB of q, k, v, bias and o (0.020 ms). Like the
// attention blocks' core (attn_common.cuh, attn_block.cu), q and k stay
// fp32 from their l2-norm through the scores, as the TPU kernel keeps
// them, and the core runs on the CUDA cores: the prologue of each block
// normalises the slice's keys from the bf16 input (F.normalize's
// max(||k||, 1e-12)), scales them by k_scale and stages them with the
// values in shared memory, then each warp normalises one query row at a
// time, scales it by q_scale * scale and runs `attend_row` (fp32 scores
// plus the bias row, fp32 softmax, p rounded to bf16, PV in fp32, the
// output rounded to bf16). The staged keys bound m: ctc_cosine_attention_max_m.
#include "attn_common.cuh"

namespace ctc {

constexpr int CA_THREADS = 512;
constexpr int CA_WARPS = CA_THREADS / 32;
constexpr int CA_BQ = 96;   // query rows per block

size_t cosine_smem_bytes(int m) {
  return (size_t)m * KS_LD * 4 + CA_WARPS * DH * 4 + (size_t)CA_WARPS * m * 4 +
         (size_t)m * DH * 2;
}

__global__ void __launch_bounds__(CA_THREADS)
cosine_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ q_scale,
                   const float* __restrict__ k_scale, const float* __restrict__ bias,
                   bf16* __restrict__ o, int n, int m, int heads, float scale) {
  extern __shared__ __align__(128) char smem[];
  const int bh = blockIdx.x, q0 = blockIdx.y * CA_BQ;
  float* ks = reinterpret_cast<float*>(smem);                   // [m][KS_LD]
  float* qrows = ks + m * KS_LD;                                // [warps][DH]
  float* prows = qrows + CA_WARPS * DH;                         // [warps][m]
  bf16* vs = reinterpret_cast<bf16*>(prows + CA_WARPS * m);     // [m][DH]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const bf16* kb = k + (int64_t)bh * m * DH;
  const bf16* vb = v + (int64_t)bh * m * DH;
  const float ksc = k_scale[lane];
  for (int j = warp; j < m; j += CA_WARPS) {
    const float kv = __bfloat162float(kb[(int64_t)j * DH + lane]);
    const float nrm = sqrtf(warp_sum(kv * kv));
    ks[j * KS_LD + lane] = kv / fmaxf(nrm, 1e-12f) * ksc;
    vs[j * DH + lane] = vb[(int64_t)j * DH + lane];
  }
  __syncthreads();

  const float qsc = q_scale[lane] * scale;
  float* qrow = qrows + warp * DH;
  float* prow = prows + warp * m;
  const float* bias_h = bias != nullptr ? bias + (int64_t)(bh % heads) * n * m : nullptr;
  const int q1 = min(q0 + CA_BQ, n);
  for (int i = q0 + warp; i < q1; i += CA_WARPS) {
    const int64_t row = ((int64_t)bh * n + i) * DH;
    const float qv = __bfloat162float(q[row + lane]);
    const float nrm = sqrtf(warp_sum(qv * qv));
    qrow[lane] = qv / fmaxf(nrm, 1e-12f) * qsc;
    __syncwarp();
    const float* brow = bias_h != nullptr ? bias_h + (int64_t)i * m : nullptr;
    o[row + lane] = __float2bfloat16(attend_row(qrow, ks, vs, brow, m, prow, lane));
  }
}

}  // namespace ctc

using namespace ctc;

// q [BH, n, 32], k / v [BH, m, 32] bf16; q_scale / k_scale [32] fp32; bias
// [heads, n, m] fp32 or null; out [BH, n, 32] bf16. Returns
// cudaGetLastError() after the launch.
extern "C" int ctc_cosine_attention(const void* q, const void* k, const void* v,
                                    const void* q_scale, const void* k_scale, const void* bias,
                                    void* out, int BH, int n, int m, int heads, float scale,
                                    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = cosine_smem_bytes(m);
  cudaFuncSetAttribute(cosine_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(BH, (n + CA_BQ - 1) / CA_BQ);
  cosine_attn_kernel<<<grid, CA_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)q_scale,
      (const float*)k_scale, (const float*)bias, (bf16*)out, n, m, heads, scale);
  return (int)cudaGetLastError();
}

// Largest key count whose staged keys, values and score rows fit a block's
// shared memory.
extern "C" int ctc_cosine_attention_max_m(void) {
  int m = 32;
  while (cosine_smem_bytes(m + 32) <= 227 * 1024) m += 32;
  return m;
}
