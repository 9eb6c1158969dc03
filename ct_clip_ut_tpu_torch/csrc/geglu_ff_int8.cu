// W8A8 GEGLU feed-forward block: the port of
// ct_clip_ut_tpu/ops/pallas_ff_int8.py:geglu_ff_int8 (_forward_impl / _kernel).
//
// xn = LN(x) (gamma, beta; fp32, one-pass moments, eps 1e-5)
// xq, rx = per-row int8 of xn          (rx = max(absmax / 127, 1e-8))
// value = (xq Wv^T) rx sv,  gate = (xq Wg^T) rx sg   (int8 x int8 -> int32)
// h = gelu_erf(gate) * value (fp32);  hq, rh = per-row int8 of h over its FULL width
// out = (hq W2^T) rh s2 (+ x in fp32)
// over N token rows (the CT-ViT FF: D = 512, inner 1365 zero-padded to 1376
// when the module is built; N = B * 13824). Weights are int8 codes in the
// nn.Linear layout (out, in), so both operands of each product are read
// along K; sv, sg, s2 are their fp32 per-output-row scales.
//
// What bounds it on the H100: int8 tensor-core operations, 2 * N * 512 *
// 1365 * 3 (at 1,979 TOP/s dense: 0.059 ms at N = 27,648), against ~28 MB
// of x and output. The TPU kernel quantises h inside one tile that holds
// the whole inner width; here a block of the first product sees 64 of its
// 1,376 columns, and a per-row scale needs the whole row. So the chain is
// four launches: (1) LN + per-row quantisation of xn, one warp a row;
// (2) the value and gate products side by side in one 128-wide tile (64
// value + 64 gate columns, int8 wmma 16x16x16, int32 accumulators), whose
// epilogue dequantises and writes h in fp32; (3) the per-row absmax of h and
// its int8 codes, one warp a row; (4) hq W2^T with the dequant and the
// residual. h in fp32 is the price of the exact per-row scale: 4 bytes a
// column written and read once more. Rounding: IEEE division (no fast
// math) and __float2int_rn, round half to even as torch.round and
// jnp.round; a code differs from the plain version's only where LN's or
// erf's last bit moves x / s across a .5 boundary. int32 sums are exact:
// 1376 * 127^2 < 2^31.
#include "gemm_tile.cuh"

namespace ctc {

constexpr int Q_BK = 64;                       // int8 K per shared tile
constexpr int Q_KC = Q_BK / 16;                // 16-byte chunks per tile row
constexpr int Q_LDC = BN + 4;                  // int32 stride of the C tile
constexpr int Q_AB = 2 * (BM + BN) * Q_BK;     // two stages of A and B, bytes
constexpr int Q_C = BM * Q_LDC * 4;
constexpr int Q_SMEM = Q_AB > Q_C ? Q_AB : Q_C;
constexpr int Q_HALF = BN / 2;

// 16 int8 of row r of a row-major [nrows, K] matrix at columns [k, k + 16),
// zero outside; K and k are multiples of 16 and rows are 16-B aligned.
struct RowMajor8 {
  const int8_t* ptr;
  int64_t ld;
  int nrows;
  int K;
  __device__ __forceinline__ uint4 load16(int r, int k) const {
    if (r < 0 || r >= nrows || k >= K) return make_uint4(0u, 0u, 0u, 0u);
    return *reinterpret_cast<const uint4*>(ptr + (int64_t)r * ld + k);
  }
};

// C[BM][Q_LDC] (int32, in smem) = A_tile @ B_tile^T over K, both int8 and
// read along K. Shared tiles are chunk-major, [stage][K chunk][row][16 B],
// so every 16 x 16 wmma operand is 256 contiguous, 32-B aligned bytes.
template <class LoadA, class LoadB>
__device__ void block_gemm_s8(const LoadA& load_a, const LoadB& load_b, int K, char* smem) {
  using namespace nvcuda;
  int8_t* As = reinterpret_cast<int8_t*>(smem);     // [2][Q_KC][BM][16]
  int8_t* Bs = As + 2 * BM * Q_BK;                  // [2][Q_KC][BN][16]
  int* C = reinterpret_cast<int*>(smem);            // [BM][Q_LDC], after the loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  // a tile is 128 rows x 4 chunks = 512 chunks; two per thread, a warp
  // taking 32 rows of one chunk (conflict-free 16-B shared stores)
  uint4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int c = tid + i * THREADS;
      int r = c % BM, kc = c / BM;
      ra[i] = load_a(r, k0 + kc * 16);
      rb[i] = load_b(r, k0 + kc * 16);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int c = tid + i * THREADS;
      int r = c % BM, kc = c / BM;
      *reinterpret_cast<uint4*>(As + ((buf * Q_KC + kc) * BM + r) * 16) = ra[i];
      *reinterpret_cast<uint4*>(Bs + ((buf * Q_KC + kc) * BN + r) * 16) = rb[i];
    }
  };

  const int nk = (K + Q_BK - 1) / Q_BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * Q_BK);
#pragma unroll
    for (int kc = 0; kc < Q_KC; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + ((cur * Q_KC + kc) * BM + wm * WTM + i * 16) * 16, 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + ((cur * Q_KC + kc) * BN + wn * WTN + j * 16) * 16, 16);
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
      wmma::store_matrix_sync(C + (wm * WTM + i * 16) * Q_LDC + wn * WTN + j * 16, acc[i][j],
                              Q_LDC, wmma::mem_row_major);
  __syncthreads();
}

// Per-row int8 codes of 16 fp32 values at scale s: __float2int_rn(v / s).
__device__ __forceinline__ void quant16(const float* v, float s, int8_t* q) {
#pragma unroll
  for (int i = 0; i < 16; ++i) q[i] = (int8_t)__float2int_rn(v[i] / s);
}

// (1) LN of each row of x [M, D] (D a multiple of 16) and its per-row
// int8 codes: one warp a row, lane l holding columns [16 l + 512 j, + 16).
// xq [M, D] int8, rx [M].
__global__ void __launch_bounds__(THREADS)
ff8_quant_x_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, int8_t* __restrict__ xq,
                   float* __restrict__ rx, int M, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * (THREADS / 32) + warp;
  if (m >= M) return;
  const bf16* xr = x + (int64_t)m * D;
  float s = 0.f, s2 = 0.f;
  for (int k = lane * 16; k < D; k += 512) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float f = __bfloat162float(xr[k + i]);
      s += f;
      s2 += f * f;
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  // the plain version's operations one by one, none contracted into an FMA
  const float mean = s / (float)D;
  const float var = fmaxf(__fsub_rn(s2 / (float)D, __fmul_rn(mean, mean)), 0.f);
  const float rstd = 1.0f / sqrtf(var + 1e-5f);
  auto ln = [&](int k) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(__bfloat162float(xr[k]), mean), rstd),
                               gamma[k]), beta[k]);
  };
  float amax = 0.f;
  for (int k = lane * 16; k < D; k += 512) {
#pragma unroll
    for (int i = 0; i < 16; ++i) amax = fmaxf(amax, fabsf(ln(k + i)));
  }
  const float sc = fmaxf(warp_max(amax) / 127.f, 1e-8f);
  for (int k = lane * 16; k < D; k += 512) {
    float y[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) y[i] = ln(k + i);
    uint4 u;
    quant16(y, sc, reinterpret_cast<int8_t*>(&u));
    *reinterpret_cast<uint4*>(xq + (int64_t)m * D + k) = u;
  }
  if (lane == 0) rx[m] = sc;
}

// (2) value and gate columns [n0, n0 + 64) of 128 rows, dequantised; h in
// fp32 into hbuf [M, ldh] (ldh = the padded inner width).
__global__ void __launch_bounds__(THREADS)
ff8_in_kernel(const int8_t* __restrict__ xq, const float* __restrict__ rx,
              const int8_t* __restrict__ wv, const int8_t* __restrict__ wg,
              const float* __restrict__ sv, const float* __restrict__ sg,
              float* __restrict__ hbuf, int M, int D, int ldh) {
  extern __shared__ __align__(128) char smem[];
  const int n0 = blockIdx.x * Q_HALF;
  const int row0 = blockIdx.y * BM;
  const RowMajor8 xa{xq, D, M, D};
  const RowMajor8 wvb{wv + (int64_t)n0 * D, D, ldh - n0, D};
  const RowMajor8 wgb{wg + (int64_t)n0 * D, D, ldh - n0, D};
  auto load_a = [&](int r, int k) { return xa.load16(row0 + r, k); };
  auto load_b = [&](int r, int k) {
    return r < Q_HALF ? wvb.load16(r, k) : wgb.load16(r - Q_HALF, k);
  };
  block_gemm_s8(load_a, load_b, D, smem);

  const int* C = reinterpret_cast<const int*>(smem);
  for (int i = threadIdx.x; i < BM * Q_HALF; i += THREADS) {
    int r = i / Q_HALF, c = i % Q_HALF;
    int m = row0 + r, n = n0 + c;
    if (m >= M || n >= ldh) continue;
    const float rs = rx[m];
    float value = (float)C[r * Q_LDC + c] * rs * sv[n];
    float gate = (float)C[r * Q_LDC + Q_HALF + c] * rs * sg[n];
    hbuf[(int64_t)m * ldh + n] = 0.5f * gate * (1.0f + erff(gate * 0.7071067811865476f)) * value;
  }
}

// (3) the per-row int8 codes of h over its full (padded) width: one warp a
// row. hq [M, ldh] int8, rh [M]. ldh is a multiple of 16.
__global__ void __launch_bounds__(THREADS)
ff8_quant_h_kernel(const float* __restrict__ hbuf, int8_t* __restrict__ hq,
                   float* __restrict__ rh, int M, int ldh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * (THREADS / 32) + warp;
  if (m >= M) return;
  const float* hr = hbuf + (int64_t)m * ldh;
  float amax = 0.f;
  for (int k = lane * 4; k < ldh; k += 128) {
    float4 v = *reinterpret_cast<const float4*>(hr + k);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  const float sc = fmaxf(warp_max(amax) / 127.f, 1e-8f);
  for (int k = lane * 16; k < ldh; k += 512) {
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; i += 4) {
      float4 t = *reinterpret_cast<const float4*>(hr + k + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
    uint4 u;
    quant16(v, sc, reinterpret_cast<int8_t*>(&u));
    *reinterpret_cast<uint4*>(hq + (int64_t)m * ldh + k) = u;
  }
  if (lane == 0) rh[m] = sc;
}

// (4) hq W2^T, dequantised, (+ x), rounded to bf16.
__global__ void __launch_bounds__(THREADS)
ff8_out_kernel(const int8_t* __restrict__ hq, const float* __restrict__ rh,
               const int8_t* __restrict__ w2, const float* __restrict__ s2,
               const bf16* __restrict__ x, bf16* __restrict__ out, int M, int D, int ldh,
               int residual) {
  extern __shared__ __align__(128) char smem[];
  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const RowMajor8 ha{hq, ldh, M, ldh};
  const RowMajor8 wb{w2 + (int64_t)n0 * ldh, ldh, D - n0, ldh};
  auto load_a = [&](int r, int k) { return ha.load16(row0 + r, k); };
  auto load_b = [&](int r, int k) { return wb.load16(r, k); };
  block_gemm_s8(load_a, load_b, ldh, smem);

  const int* C = reinterpret_cast<const int*>(smem);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    int r = i / BN, c = i % BN;
    int m = row0 + r, n = n0 + c;
    if (m >= M || n >= D) continue;
    float y = __fmul_rn((float)C[r * Q_LDC + c] * rh[m], s2[n]);
    if (residual) y = __fadd_rn(y, __bfloat162float(x[(int64_t)m * D + n]));
    out[(int64_t)m * D + n] = __float2bfloat16(y);
  }
}

}  // namespace ctc

using namespace ctc;

// x [M, D] bf16 (D a multiple of 16); gamma/beta [D] fp32; wv/wg [ldh, D]
// and w2 [D, ldh] int8 (ldh, the padded inner width, a multiple of 16;
// padded rows / columns zero); sv/sg [ldh], s2 [D] fp32; workspaces xq [M,
// D] int8, rx [M] fp32, hbuf [M, ldh] fp32, hq [M, ldh] int8, rh [M] fp32;
// out [M, D] bf16. Returns cudaGetLastError() after the launches.
extern "C" int ctc_geglu_ff_int8(const void* x, const void* gamma, const void* beta,
                                 const void* wv, const void* wg, const void* w2, const void* sv,
                                 const void* sg, const void* s2, void* xq, void* rx, void* hbuf,
                                 void* hq, void* rh, void* out, int M, int D, int ldh,
                                 int residual, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(ff8_in_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM);
  cudaFuncSetAttribute(ff8_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM);
  const int rows_per_block = THREADS / 32;
  const int grid_rows = (M + rows_per_block - 1) / rows_per_block;
  ff8_quant_x_kernel<<<grid_rows, THREADS, 0, st>>>((const bf16*)x, (const float*)gamma,
                                                    (const float*)beta, (int8_t*)xq,
                                                    (float*)rx, M, D);
  dim3 g1((ldh + Q_HALF - 1) / Q_HALF, (M + BM - 1) / BM);
  ff8_in_kernel<<<g1, THREADS, Q_SMEM, st>>>((const int8_t*)xq, (const float*)rx,
                                             (const int8_t*)wv, (const int8_t*)wg,
                                             (const float*)sv, (const float*)sg, (float*)hbuf, M,
                                             D, ldh);
  ff8_quant_h_kernel<<<grid_rows, THREADS, 0, st>>>((const float*)hbuf, (int8_t*)hq,
                                                    (float*)rh, M, ldh);
  dim3 g2((D + BN - 1) / BN, (M + BM - 1) / BM);
  ff8_out_kernel<<<g2, THREADS, Q_SMEM, st>>>((const int8_t*)hq, (const float*)rh,
                                              (const int8_t*)w2, (const float*)s2,
                                              (const bf16*)x, (bf16*)out, M, D, ldh, residual);
  return (int)cudaGetLastError();
}
