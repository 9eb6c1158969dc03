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
// the bf16 tensor-core peak; the split-bf16 scores make it 2.5x that in
// products) against 67 MB of q, k, v, bias and o (0.020 ms). Two launches:
//   cosine_prologue_kernel  each row of q and k l2-normalised in fp32
//                           (F.normalize's max(||.||, 1e-12)), times
//                           q_scale * scale or k_scale, written as bf16 hi /
//                           lo pairs (4 threads a row, two shuffles for the
//                           norm): 2 * BH * (n + m) * 64 B written;
//   cosine_core_kernel      the spatial block's two-pass split-bf16 core
//                           (attn_mma.cuh: K hi / lo and V of one slice
//                           staged in shared memory, 16 query rows a warp,
//                           running max and sum, then p = exp(s - m) / l
//                           rounded to bf16 and P.V on mma.sync) with a row
//                           stride of 32, m keys and the bias of head bh % h;
//                           the output rounded to bf16.
// The staged keys bound m: ctc_cosine_attention_max_m.
#include "attn_mma.cuh"

namespace ctc {
namespace cos_core {

using tc::bf16;
using tc::DH;

constexpr int PRO_THREADS = 256;

// rows [0, q_rows) of q and [0, k_rows) of k (32 bf16 each): y = l2n(row) *
// gain, hi = bf16(y), lo = bf16(y - hi) into the planes qhl [2][q_rows][32],
// khl [2][k_rows][32].
__global__ void __launch_bounds__(PRO_THREADS)
cosine_prologue_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const float* __restrict__ q_scale, const float* __restrict__ k_scale,
                       float scale, bf16* __restrict__ qhl, bf16* __restrict__ khl,
                       int64_t q_rows, int64_t k_rows) {
  const int64_t tid = (int64_t)blockIdx.x * PRO_THREADS + threadIdx.x;
  const int64_t row = tid >> 2;
  const int c = (int)(tid & 3) * 8;
  const bool is_q = row < q_rows;
  const int64_t r = is_q ? row : row - q_rows;
  const bool valid = is_q || r < k_rows;
  const bf16* src = is_q ? q : k;
  const int64_t rr = valid ? r : 0;
  uint4 raw = *reinterpret_cast<const uint4*>(src + rr * DH + c);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
  float y[8], ss = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    y[i] = __bfloat162float(e[i]);
    ss += y[i] * y[i];
  }
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  if (!valid) return;
  const float nrm = fmaxf(sqrtf(ss), 1e-12f);
  const float* gain = is_q ? q_scale : k_scale;
  const float mul = is_q ? scale : 1.f;
  uint4 hi, lo;
  bf16* h = reinterpret_cast<bf16*>(&hi);
  bf16* l = reinterpret_cast<bf16*>(&lo);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v = y[i] / nrm * (gain[c + i] * mul);
    h[i] = __float2bfloat16(v);
    l[i] = __float2bfloat16(v - __bfloat162float(h[i]));
  }
  bf16* dst = is_q ? qhl : khl;
  const int64_t rows = is_q ? q_rows : k_rows;
  *reinterpret_cast<uint4*>(dst + r * DH + c) = hi;
  *reinterpret_cast<uint4*>(dst + (rows + r) * DH + c) = lo;
}

// One block per (slice bh, query tile).
template <int BIAS>
__global__ void __launch_bounds__(tc::CORE_WARPS * 32, 2)
cosine_core_kernel(const bf16* __restrict__ qhl, const bf16* __restrict__ khl,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   bf16* __restrict__ o, int BH, int n, int m, int heads) {
  const int bh = blockIdx.x;
  const int64_t qoff = (int64_t)bh * n * DH, koff = (int64_t)bh * m * DH;
  const int64_t qplane = (int64_t)BH * n * DH, kplane = (int64_t)BH * m * DH;
  const tc::Slice sl{qhl + qoff, qhl + qplane + qoff, khl + koff, khl + kplane + koff, v + koff,
                     BIAS ? bias + (int64_t)(bh % heads) * n * m : nullptr, o + qoff, DH, n, m};
  tc::two_pass_core<BIAS, false>(sl, blockIdx.y * tc::QT, nullptr, nullptr);
}

}  // namespace cos_core
}  // namespace ctc

using namespace ctc::cos_core;

// q [BH, n, 32], k / v [BH, m, 32] bf16; q_scale / k_scale [32] fp32; bias
// [heads, n, m] fp32 or null; work [2 * BH * (n + m) * 32] bf16 (the hi / lo
// planes of q, then of k); out [BH, n, 32] bf16. Returns cudaGetLastError()
// after the launches.
extern "C" int ctc_cosine_attention(const void* q, const void* k, const void* v,
                                    const void* q_scale, const void* k_scale, const void* bias,
                                    void* work, void* out, int BH, int n, int m, int heads,
                                    float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int64_t q_rows = (int64_t)BH * n, k_rows = (int64_t)BH * m;
  bf16* qhl = static_cast<bf16*>(work);
  bf16* khl = qhl + 2 * q_rows * DH;
  const int64_t threads = 4 * (q_rows + k_rows);
  cosine_prologue_kernel<<<(unsigned)((threads + PRO_THREADS - 1) / PRO_THREADS), PRO_THREADS, 0,
                           st>>>((const bf16*)q, (const bf16*)k, (const float*)q_scale,
                                 (const float*)k_scale, scale, qhl, khl, q_rows, k_rows);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int smem = (int)ctc::tc::core_smem_bytes(m);
  auto core = bias == nullptr ? cosine_core_kernel<0>
              : (m % 2 == 0)  ? cosine_core_kernel<2>
                              : cosine_core_kernel<1>;
  cudaFuncSetAttribute(core, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(BH, (n + ctc::tc::QT - 1) / ctc::tc::QT);
  core<<<grid, ctc::tc::core_threads(n), smem, st>>>(qhl, khl, (const bf16*)v,
                                                     (const float*)bias, (bf16*)out, BH, n, m,
                                                     heads);
  return (int)cudaGetLastError();
}

// Largest key count whose staged keys and values fit a block's shared memory.
extern "C" int ctc_cosine_attention_max_m(void) { return ctc::tc::core_max_keys(); }
