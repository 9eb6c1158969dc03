// Pieces shared by the backward chains (attn_bwd.cuh, geglu_ff_bwd.cu,
// patch_embed_dkw.cu):
//
//   gemm_nt_kernel     C = A @ B^T on the shared GEMM tile (both read along
//                      K), written as fp32 or rounded to bf16: the data
//                      gradients (dO = g Wo, dxn = dq Wq, dh = g W2, ...).
//   wgrad_kernel       out += A^T @ B over a chunk of the token rows
//                      (block_gemm_tn), the weight gradients. The TPU
//                      kernels accumulate these in one VMEM block across a
//                      sequential grid; here the rows are split into chunks
//                      (about four waves of blocks) and each block adds its
//                      128 x 128 fp32 tile into the zeroed output with fp32
//                      atomicAdd: ONE launch per weight, no partials buffer,
//                      and a summation order that varies from run to run
//                      (within fp32 rounding).
//   ln_rows_kernel     the LayerNorm forward recompute: xn = LN(x) gamma
//                      (+ beta) rounded to bf16 and each row's (mean, rstd),
//                      in the one-pass E[x^2] - E[x]^2 form of the forward
//                      kernels' LN prologue (ln_row_stats / ln_apply8).
//   ln_bwd_rows_kernel the LayerNorm backward of the TPU kernels:
//                      dx = (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) rstd
//                      (+ a direct term) (+ g under `residual`), with dgamma
//                      (and dbeta) summed over rows in shared memory, then
//                      one fp32 atomicAdd per column per block.
#pragma once

#include "gemm_tile.cuh"

namespace ctc {

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
gemm_nt_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
               OutT* __restrict__ C, int ldc, int M, int N, int K) {
  extern __shared__ __align__(128) char smem[];
  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const RowMajor a{A, lda, M, K};
  const RowMajor b{B + (int64_t)n0 * ldb, ldb, N - n0, K};
  block_gemm([&](int r, int k) { return a.load8(row0 + r, k); },
             [&](int r, int k) { return b.load8(r, k); }, K, smem);
  const float* Cs = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    int r = i / BN, c = i % BN;
    int m = row0 + r, n = n0 + c;
    if (m < M && n < N) store_out(C + (int64_t)m * ldc + n, Cs[r * LDC + c]);
  }
}

// C [M, N] (leading dimension ldc) = A [M, K] @ B [N, K]^T.
template <typename OutT>
static void launch_gemm_nt(const bf16* A, int lda, const bf16* B, int ldb, OutT* C, int ldc,
                           int M, int N, int K, cudaStream_t st) {
  cudaFuncSetAttribute(gemm_nt_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       GEMM_SMEM);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_nt_kernel<OutT><<<grid, THREADS, GEMM_SMEM, st>>>(A, lda, B, ldb, C, ldc, M, N, K);
}

// out[i, j] += sum over rows m of this block's chunk of A[m, i] * B[m, j].
// `la.load8(m, i)` / `lb.load8(m, j)` return 8 bf16 of row m from column i
// (zero outside the matrix).
template <class LA, class LB>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(LA la, LB lb, float* __restrict__ out, int ldo, int rows, int cols, int Mtot,
             int chunk) {
  extern __shared__ __align__(128) char smem[];
  const int j0 = blockIdx.x * BN;
  const int i0 = blockIdx.y * BM;
  const int kbase = blockIdx.z * chunk;
  const int K = min(chunk, Mtot - kbase);
  block_gemm_tn([&](int k, int c) { return la.load8(kbase + k, i0 + c); },
                [&](int k, int c) { return lb.load8(kbase + k, j0 + c); }, K, smem);
  const float* C = reinterpret_cast<const float*>(smem);
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    int r = idx / BN, c = idx % BN;
    int i = i0 + r, j = j0 + c;
    if (i < rows && j < cols) atomicAdd(out + (int64_t)i * ldo + j, C[r * LDC + c]);
  }
}

// out [rows, cols] (zeroed by the caller) += A^T B over Mtot token rows.
template <class LA, class LB>
static void launch_wgrad(const LA& la, const LB& lb, float* out, int ldo, int rows, int cols,
                         int Mtot, cudaStream_t st) {
  const int tiles = ((rows + BM - 1) / BM) * ((cols + BN - 1) / BN);
  int splits = (4 * 132 + tiles - 1) / tiles;          // about four waves of blocks
  splits = max(1, min(splits, (Mtot + 255) / 256));    // at least 256 rows a block
  int chunk = (Mtot + splits - 1) / splits;
  chunk = (chunk + BK - 1) / BK * BK;
  splits = (Mtot + chunk - 1) / chunk;
  cudaFuncSetAttribute(wgrad_kernel<LA, LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       GEMM_SMEM);
  dim3 grid((cols + BN - 1) / BN, (rows + BM - 1) / BM, max(splits, 1));
  wgrad_kernel<LA, LB><<<grid, THREADS, GEMM_SMEM, st>>>(la, lb, out, ldo, rows, cols, Mtot,
                                                         chunk);
}

// One warp per row; D a multiple of 8, rows 16-B aligned.
template <int Dummy = 0>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, bf16* __restrict__ xn, float2* __restrict__ stats,
               int M, int D) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (m >= M) return;
  const bf16* row = x + (int64_t)m * D;
  float s = 0.f, s2 = 0.f;
  for (int k = lane * 8; k < D; k += 256) {
    uint4 raw = *reinterpret_cast<const uint4*>(row + k);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float f = __bfloat162float(e[i]);
      s += f;
      s2 += f * f;
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / (float)D;
  const float var = fmaxf(s2 / (float)D - mean * mean, 0.f);
  const float rstd = rsqrtf(var + 1e-5f);
  if (lane == 0) stats[m] = make_float2(mean, rstd);
  for (int k = lane * 8; k < D; k += 256) {
    uint4 raw = *reinterpret_cast<const uint4*>(row + k);
    *reinterpret_cast<uint4*>(xn + (int64_t)m * D + k) =
        ln_apply8(raw, make_float2(mean, rstd), gamma, beta, k, D);
  }
}

constexpr int LNB_WARPS = 8;
constexpr int LNB_ROWS = 8;        // rows per warp

// Shared memory: 2 * D floats. Grid: ceil(M / (LNB_WARPS * LNB_ROWS)).
template <int Dummy = 0>
__global__ void __launch_bounds__(LNB_WARPS * 32)
ln_bwd_rows_kernel(const bf16* __restrict__ x, const float2* __restrict__ stats,
                   const float* __restrict__ dxn, const float* __restrict__ direct,
                   const bf16* __restrict__ g, const float* __restrict__ gamma,
                   bf16* __restrict__ dx, float* __restrict__ dgamma, float* __restrict__ dbeta,
                   int M, int D) {
  extern __shared__ __align__(16) float red[];      // [2][D]: dgamma, dbeta partials
  for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) red[c] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * LNB_WARPS * LNB_ROWS;
  const int m1 = min(m0 + LNB_WARPS * LNB_ROWS, M);
  for (int m = m0 + warp; m < m1; m += LNB_WARPS) {
    const float2 st = stats[m];
    const bf16* xr = x + (int64_t)m * D;
    const float* dr = dxn + (int64_t)m * D;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float xh = (__bfloat162float(xr[c]) - st.x) * st.y;
      const float dxh = dr[c] * gamma[c];
      s1 += dxh;
      s2 += dxh * xh;
      atomicAdd(&red[c], dr[c] * xh);
      if (dbeta != nullptr) atomicAdd(&red[D + c], dr[c]);
    }
    const float a1 = warp_sum(s1) / (float)D;
    const float a2 = warp_sum(s2) / (float)D;
    for (int c = lane; c < D; c += 32) {
      const float xh = (__bfloat162float(xr[c]) - st.x) * st.y;
      const float dxh = dr[c] * gamma[c];
      float y = (dxh - a1 - xh * a2) * st.y;
      if (direct != nullptr) y += direct[(int64_t)m * D + c];
      if (g != nullptr) y += __bfloat162float(g[(int64_t)m * D + c]);
      dx[(int64_t)m * D + c] = __float2bfloat16(y);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    atomicAdd(dgamma + c, red[c]);
    if (dbeta != nullptr) atomicAdd(dbeta + c, red[D + c]);
  }
}

static void launch_ln_bwd(const bf16* x, const float2* stats, const float* dxn, const float* direct,
                          const bf16* g, const float* gamma, bf16* dx, float* dgamma, float* dbeta,
                          int M, int D, cudaStream_t st) {
  const int rows = LNB_WARPS * LNB_ROWS;
  ln_bwd_rows_kernel<><<<(M + rows - 1) / rows, LNB_WARPS * 32, 2 * D * sizeof(float), st>>>(
      x, stats, dxn, direct, g, gamma, dx, dgamma, dbeta, M, D);
}

}  // namespace ctc
