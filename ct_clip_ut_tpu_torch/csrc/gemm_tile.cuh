// Shared block-level GEMM for the four hand-written kernels of the port.
//
// One thread block of 256 threads (8 warps, 2 x 4) computes a 128 x 128
// fp32 tile C = A @ B^T with bf16 tensor-core products (nvcuda::wmma,
// 16x16x16, fp32 accumulation). A is [M, K] row-major; B is stored [N, K]
// row-major, the nn.Linear weight layout (out, in) and the codebook layout,
// so both operands are read along K. The K loop double-buffers its shared
// tiles through registers: the next tile is fetched from global memory
// while the current one is multiplied.
//
// Operands are read through loader functors `uint4 load(int tile_row,
// int k)` that return 8 bf16 values of one tile row starting at column k,
// zero beyond the matrix edge. That is where each kernel fuses its prologue
// (the LayerNorm of the attention-q and feed-forward projections).
//
// After `block_gemm` returns, the fp32 tile sits in shared memory as
// C[BM][LDC]; each kernel runs its own epilogue over it (l2norm, GEGLU,
// residual add, running argmax) and must __syncthreads() before the next
// `block_gemm` on the same shared memory.
//
// Right and simple first: no wgmma, TMA or persistent scheduling yet.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace ctc {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int WTM = BM / WARPS_M;  // 64 rows per warp
constexpr int WTN = BN / WARPS_N;  // 32 columns per warp
constexpr int FM = WTM / 16;
constexpr int FN = WTN / 16;
constexpr int LDS = BK + 8;        // bf16 stride of the A/B tiles (80 B rows)
constexpr int LDC = BN + 4;        // fp32 stride of the C tile

constexpr int AB_BYTES = 2 * (BM + BN) * LDS * 2;  // two stages of A and B
constexpr int C_BYTES = BM * LDC * 4;
constexpr int GEMM_SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

// 8 bf16 of row r of a row-major matrix, columns [k, k + 8), zero outside
// rows [0, nrows) and columns [0, K). Vector load when aligned.
struct RowMajor {
  const bf16* ptr;
  int64_t ld;
  int nrows;
  int K;
  __device__ __forceinline__ uint4 load8(int r, int k) const {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < 0 || r >= nrows || k >= K) return v;
    const bf16* p = ptr + (int64_t)r * ld + k;
    if (k + 8 <= K && ((reinterpret_cast<uintptr_t>(p) & 15u) == 0)) {
      return *reinterpret_cast<const uint4*>(p);
    }
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (k + i < K) e[i] = p[i];
    }
    return v;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Per-row LayerNorm moments of rows [row0, row0 + BM) of x [M, D], in the
// E[x^2] - E[x]^2 form the TPU kernels use: stats[r] = (mean, rstd).
__device__ inline void ln_row_stats(const RowMajor& x, int row0, float eps, float2* stats) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += THREADS / 32) {
    float s = 0.f, s2 = 0.f;
    for (int k = lane * 8; k < x.K; k += 256) {
      uint4 v = x.load8(row0 + r, k);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float f = __bfloat162float(e[i]);
        s += f;
        s2 += f * f;
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      float mean = s / (float)x.K;
      float var = fmaxf(s2 / (float)x.K - mean * mean, 0.f);
      stats[r] = make_float2(mean, rsqrtf(var + eps));
    }
  }
}

// LayerNorm of 8 raw values at (tile row r, columns k..k+7), rounded to bf16:
// ((x - mean) * rstd) * gamma (+ beta). Columns >= K stay zero.
__device__ __forceinline__ uint4 ln_apply8(uint4 raw, float2 st, const float* gamma,
                                           const float* beta, int k, int K) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
  bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (k + i < K) {
      float y = (__bfloat162float(e[i]) - st.x) * st.y * gamma[k + i];
      if (beta != nullptr) y += beta[k + i];
      o[i] = __float2bfloat16(y);
    }
  }
  return out;
}

// C[BM][LDC] (fp32, in smem) = A_tile @ B_tile^T over K. `load_a(r, k)` and
// `load_b(r, k)` return 8 bf16 of tile row r (0..127) at column k.
template <class LoadA, class LoadB>
__device__ void block_gemm(const LoadA& load_a, const LoadB& load_b, int K, char* smem) {
  using namespace nvcuda;
  bf16* As = reinterpret_cast<bf16*>(smem);           // [2][BM][LDS]
  bf16* Bs = As + 2 * BM * LDS;                       // [2][BN][LDS]
  float* C = reinterpret_cast<float*>(smem);          // [BM][LDC], after the loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // each tile is 128 rows x 32 columns = 512 chunks of 8; two per thread
  uint4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int c = tid + i * THREADS;
      int r = c >> 2, kk = k0 + (c & 3) * 8;
      ra[i] = load_a(r, kk);
      rb[i] = load_b(r, kk);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int c = tid + i * THREADS;
      int r = c >> 2, kk = (c & 3) * 8;
      *reinterpret_cast<uint4*>(As + (buf * BM + r) * LDS + kk) = ra[i];
      *reinterpret_cast<uint4*>(Bs + (buf * BN + r) * LDS + kk) = rb[i];
    }
  };

  const int nk = (K + BK - 1) / BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (cur * BM + wm * WTM + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (cur * BN + wn * WTN + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (kt + 1 < nk) stash(cur ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(C + (wm * WTM + i * 16) * LDC + wn * WTN + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
}

}  // namespace ctc
