// CT-ViT patch embed (LN-folded conv form): the port of
// ct_clip_ut_tpu/ops/pallas_patch_embed.py:patch_embed_fused
// (_forward_impl / _kernel).
//
// out = LN2(bf16((P @ Kw^T - mean * s1) * rsqrt(var + eps) + b1)) * g2 + b2
// where P [M, K] are the raw patches of a [B, 1, T, H, W] bf16 volume
// (M = B * T/tp * H/p * W/p patches of K = tp * p * p pixels: 27,648 x
// 4,000 at two flagship volumes), Kw [dim, K] is the LN1-gamma-folded
// projection cast once to bf16, and mean / var are each patch's LN1
// moments in fp32.
//
// What bounds it on the H100: tensor-core FLOPs, 2 * M * K * dim (113
// GFLOP at B = 2, 0.11 ms at the bf16 peak); the volume (221 MB at B = 2)
// is the only large read. The design is an implicit GEMM on the shared
// GEMM tile: the A loader gathers patch pixels straight from the volume,
// so no patchified copy is ever written. Column k of a patch row is
// (tv, p1, wv) with wv fastest, the order of the pixels along W; with a
// patch width that 4 divides, each 8-wide chunk the tile asks for is two
// runs of 4 contiguous, 8-B aligned pixels (a run of 20 bf16 is only 8-B
// aligned, so no 16-B load is legal there). Three launches:
//   pe_moments_kernel  one warp per patch: LN1 mean and rstd in fp32
//                      (one-pass E[x^2] - E[x]^2, the `_xla_twin` form);
//   pe_gemm_kernel     the GEMM; the epilogue applies the folded LN1 and
//                      the bias and rounds h to bf16 into `out` (the TPU
//                      kernel's rounding point before LN2);
//   pe_ln_kernel       LN2 over each 512-wide row of `out`, in place, with
//                      the two-pass variance of the `_xla_twin`.
#include "patch_common.cuh"

namespace ctc {

constexpr float PE_EPS = 1e-5f;

__global__ void __launch_bounds__(256)
pe_moments_kernel(const bf16* __restrict__ image, float2* __restrict__ stats, int M,
                  PatchGeom g) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (m >= M) return;
  const int K = g.t_patch * g.patch * g.patch;
  const bf16* p = image + g.base(m);
  float s = 0.f, s2 = 0.f;
  for (int k = lane; k < K; k += 32) {
    float f = __bfloat162float(p[g.pixel(k)]);
    s += f;
    s2 += f * f;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0) {
    float mean = s / (float)K;
    float var = fmaxf(s2 / (float)K - mean * mean, 0.f);
    stats[m] = make_float2(mean, rsqrtf(var + PE_EPS));
  }
}

__global__ void __launch_bounds__(THREADS)
pe_gemm_kernel(const bf16* __restrict__ image, const bf16* __restrict__ kwd,
               const float* __restrict__ s1, const float* __restrict__ b1,
               const float2* __restrict__ stats, bf16* __restrict__ h,
               float* __restrict__ conv, int M, int dim, PatchGeom g, int vec4) {
  extern __shared__ __align__(128) char smem[];
  int64_t* base = reinterpret_cast<int64_t*>(smem + GEMM_SMEM);   // [BM] patch offsets
  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int K = g.t_patch * g.patch * g.patch;
  for (int r = threadIdx.x; r < BM; r += THREADS) base[r] = row0 + r < M ? g.base(row0 + r) : -1;
  __syncthreads();

  auto load_a = [&](int r, int k) {
    const int64_t o = base[r];
    if (o < 0) return make_uint4(0u, 0u, 0u, 0u);
    return patch_load8(image + o, g, k, K, vec4);
  };
  const RowMajor wb{kwd + (int64_t)n0 * K, K, dim - n0, K};
  auto load_b = [&](int r, int k) { return wb.load8(r, k); };
  block_gemm(load_a, load_b, K, smem);

  const float* C = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    int r = i / BN, c = i % BN;
    int m = row0 + r, n = n0 + c;
    if (m >= M || n >= dim) continue;
    float2 st = stats[m];
    if (conv != nullptr) conv[(int64_t)m * dim + n] = C[r * LDC + c];
    float y = (C[r * LDC + c] - st.x * s1[n]) * st.y + b1[n];
    h[(int64_t)m * dim + n] = __float2bfloat16(y);
  }
}

__global__ void __launch_bounds__(256)
pe_ln_kernel(bf16* __restrict__ h, const float* __restrict__ g2, const float* __restrict__ b2,
             int M, int dim) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (m >= M) return;
  bf16* row = h + (int64_t)m * dim;
  float s = 0.f;
  for (int c = lane; c < dim; c += 32) s += __bfloat162float(row[c]);
  const float mean = warp_sum(s) / (float)dim;
  float s2 = 0.f;
  for (int c = lane; c < dim; c += 32) {
    float d = __bfloat162float(row[c]) - mean;
    s2 += d * d;
  }
  const float rstd = rsqrtf(warp_sum(s2) / (float)dim + PE_EPS);
  for (int c = lane; c < dim; c += 32) {
    float v = (__bfloat162float(row[c]) - mean) * rstd * g2[c] + b2[c];
    row[c] = __float2bfloat16(v);
  }
}

}  // namespace ctc

using namespace ctc;

// image [B, 1, T, H, W] bf16 (T, H, W multiples of t_patch, patch, patch);
// kwd [dim, t_patch * patch * patch] bf16, column (tv, p1, wv); s1/b1/g2/b2
// [dim] fp32; stats [M] float2 (each patch's LN1 mean and rstd); out [M, dim]
// bf16 with M = B * T/t_patch * H/patch * W/patch; conv [M, dim] fp32 (the
// product before the folded LN1) or null.
static int patch_embed_launch(const void* image, const void* kwd, const void* s1, const void* b1,
                              const void* g2, const void* b2, void* stats, void* out, void* conv,
                              int B, int T, int H, int W, int patch, int t_patch, int dim,
                              void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const PatchGeom g{T, H, W, patch, t_patch};
  const int M = B * (T / t_patch) * (H / patch) * (W / patch);
  const int vec4 = patch % 4 == 0 && W % 4 == 0 && (reinterpret_cast<uintptr_t>(image) & 7u) == 0;
  const int rows_per_block = 256 / 32;
  pe_moments_kernel<<<(M + rows_per_block - 1) / rows_per_block, 256, 0, st>>>(
      (const bf16*)image, (float2*)stats, M, g);
  const int smem = GEMM_SMEM + BM * (int)sizeof(int64_t);
  cudaFuncSetAttribute(pe_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((dim + BN - 1) / BN, (M + BM - 1) / BM);
  pe_gemm_kernel<<<grid, THREADS, smem, st>>>((const bf16*)image, (const bf16*)kwd,
                                              (const float*)s1, (const float*)b1,
                                              (const float2*)stats, (bf16*)out, (float*)conv, M,
                                              dim, g, vec4);
  pe_ln_kernel<<<(M + rows_per_block - 1) / rows_per_block, 256, 0, st>>>(
      (bf16*)out, (const float*)g2, (const float*)b2, M, dim);
  return (int)cudaGetLastError();
}

extern "C" int ctc_patch_embed(const void* image, const void* kwd, const void* s1,
                               const void* b1, const void* g2, const void* b2, void* stats,
                               void* out, int B, int T, int H, int W, int patch, int t_patch,
                               int dim, void* stream) {
  return patch_embed_launch(image, kwd, s1, b1, g2, b2, stats, out, nullptr, B, T, H, W, patch,
                            t_patch, dim, stream);
}

// The residual-saving forward (the port of _forward_res_impl): the same
// chain, and the pe_gemm epilogue also writes the fp32 product `conv`; with
// `stats` these are what the LayerNorm-chain backward rebuilds from.
extern "C" int ctc_patch_embed_res(const void* image, const void* kwd, const void* s1,
                                   const void* b1, const void* g2, const void* b2, void* stats,
                                   void* out, void* conv, int B, int T, int H, int W, int patch,
                                   int t_patch, int dim, void* stream) {
  return patch_embed_launch(image, kwd, s1, b1, g2, b2, stats, out, conv, B, T, H, W, patch,
                            t_patch, dim, stream);
}
