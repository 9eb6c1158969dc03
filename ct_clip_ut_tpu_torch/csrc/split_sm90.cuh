// fp32 products on the bf16 tensor cores: the split-bf16 pieces of the fp32
// chains (the fp32 BERT layer, bert_layer.cu; the fp32 variants of geglu_ff,
// vq_nearest, attn_block and attn_packed).
//
// An fp32 value a is carried as a bf16 pair hi = bf16(a), lo = bf16(a - hi);
// a product a . b is taken as a_hi b_hi + a_lo b_hi + a_hi b_lo with fp32
// sums (SplitPlan of gemm_sm90.cuh, three K passes into one accumulator),
// within ~2^-16 of the fp32 product: each bf16 x bf16 product is exact in
// fp32 and the lo . lo term left out is ~2^-16 relative. One bf16 product
// errs by ~2^-8, which misses the fp32 bands (~1e-3 on a layer). Every
// piece takes keep_lo: 0 writes its lo planes as zeros, the one-pass bf16
// control that shows a band needs the split.
//
//   split_kernel     hi / lo planes of an fp32 array (weights per call, VQ
//                    tokens and codes)
//   ln_split_kernel  LN(x) * gamma (+ beta) of fp32 rows in the one-pass
//                    E[x^2] - E[x]^2 form, written in fp32 and / or as hi /
//                    lo planes, and x's own planes where asked for (the
//                    attention block reads k and v from the pre-norm x)
//   F32OutEpi        out [M, N] fp32 = acc (+ bias) (+ res), the products
//                    that end a chain (the residual added in fp32)
//   SplitOutEpi      acc written as hi / lo planes (a product whose result
//                    is the next product's operand)
//   split_product    the SplitPlan GEMM of two operands' planes;
//   split_product_kn the same with B a [K, N] matrix read as it is stored
//                    (SplitKNPlan: a weight in a backward product)
//   split4_product_kn / split4_kn_kernel, split4_product / split4_kernel
//                    the same products with each K slice's four planes
//                    staged once and its three bf16 products issued from
//                    that stage (the backward's MN-major products; the
//                    forward chains' K-major ones, persistent)
//   split4_product32 / split4_32_kernel
//                    the same at K slices of 32, two blocks an SM (products
//                    of one to four rounds of 128 x 128 tiles)
//   split4_product64 / split4_64_kernel
//                    the same at 64-row tiles, the K slices alternating
//                    between the warpgroups (products of fewer 128-row
//                    tiles than SMs: the fp32 BERT layer's N = 768 ones at
//                    a train step's 1,024 rows)
//   ln_bwd_f32_kernel the LayerNorm backward of fp32 rows (the fp32
//                    backward chains' last launch); with GRADS also each
//                    block's partial sums of the gains' gradients
//   colsum_kernel    sums of the rows of a partial-sums matrix in a fixed
//                    order (the fp32 train step's dgamma, dbeta, dq_scale,
//                    dk_scale: no atomics, the same bits every call)
//   ff::GegluSplitPlan the GEGLU's value | gate product (the fp32 forward,
//                    on split4_kernel)
#pragma once

#include "gemm_sm90.cuh"

namespace ctc {
namespace sm90 {

// (a, b) as a bf16 pair hi and the pair of what it leaves, lo (zeros
// without keep_lo)
__device__ __forceinline__ void split2(float a, float b, bool keep_lo, __nv_bfloat162& hi,
                                       __nv_bfloat162& lo) {
  hi = __floats2bfloat162_rn(a, b);
  lo = keep_lo ? __floats2bfloat162_rn(a - __low2float(hi), b - __high2float(hi))
               : __floats2bfloat162_rn(0.f, 0.f);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// four floats' hi / lo planes at hi + off, lo + off (8-B stores)
__device__ __forceinline__ void store_split4(float4 y, bool keep_lo, bf16* hi, bf16* lo,
                                             int64_t off) {
  __nv_bfloat162 h0, l0, h1, l1;
  split2(y.x, y.y, keep_lo, h0, l0);
  split2(y.z, y.w, keep_lo, h1, l1);
  *reinterpret_cast<uint2*>(hi + off) = make_uint2(as_u32(h0), as_u32(h1));
  *reinterpret_cast<uint2*>(lo + off) = make_uint2(as_u32(l0), as_u32(l1));
}

// hi / lo planes of n4 float4s of src
template <int Dummy = 0>
__global__ void __launch_bounds__(256)
split_kernel(const float4* __restrict__ src, bf16* __restrict__ hi, bf16* __restrict__ lo,
             int64_t n4, int keep_lo) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x)
    store_split4(src[i], keep_lo, hi, lo, 4 * i);
}

// One warp a row of r [M, D] (D a multiple of 4, at most 4 * 32 *
// LNB_CHUNKS): y = LN(r) * gamma (+ beta), the moments in the one-pass form
// of the TPU kernels' LayerNorm; y to out (fp32) and / or as hi / lo planes
// where those are given; r's own planes to rhi / rlo where given; with r2
// (another [M, D] array, the backward chains' cotangent) its row's planes
// to r2hi / r2lo, one launch for both row passes. Lane l holds its float4s
// of the row (columns 4 l + 128 k) in registers, loaded at once.
constexpr int LNB_CHUNKS = 8;
template <int Dummy = 0>
__global__ void __launch_bounds__(256)
ln_split_kernel(const float* __restrict__ r, const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ out, bf16* __restrict__ hi,
                bf16* __restrict__ lo, bf16* __restrict__ rhi, bf16* __restrict__ rlo,
                const float* __restrict__ r2, bf16* __restrict__ r2hi, bf16* __restrict__ r2lo,
                int M, int D, float eps, int keep_lo) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (m >= M) return;
  const float* row = r + (int64_t)m * D;
  float4 rv[LNB_CHUNKS], r2v[LNB_CHUNKS];
#pragma unroll
  for (int k = 0; k < LNB_CHUNKS && r2 != nullptr; ++k) {
    const int c = 4 * lane + 128 * k;
    if (c < D) r2v[k] = *reinterpret_cast<const float4*>(r2 + (int64_t)m * D + c);
  }
#pragma unroll
  for (int k = 0; k < LNB_CHUNKS; ++k) {
    const int c = 4 * lane + 128 * k;
    if (c < D) rv[k] = *reinterpret_cast<const float4*>(row + c);
  }
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < LNB_CHUNKS; ++k) {
    if (4 * lane + 128 * k >= D) break;
    const float4 v = rv[k];
    s += (v.x + v.y) + (v.z + v.w);
    s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
  }
  const float mean = warp_sum(s) / (float)D;
  const float var = warp_sum(s2) / (float)D - mean * mean;
  const float rstd = rsqrtf(fmaxf(var, 0.f) + eps);
#pragma unroll
  for (int k = 0; k < LNB_CHUNKS; ++k) {
    const int c = 4 * lane + 128 * k;
    if (c >= D) break;
    const float4 v = rv[k];
    const float4 gm = *reinterpret_cast<const float4*>(gamma + c);
    float4 y = make_float4((v.x - mean) * rstd * gm.x, (v.y - mean) * rstd * gm.y,
                           (v.z - mean) * rstd * gm.z, (v.w - mean) * rstd * gm.w);
    if (beta != nullptr) {
      const float4 bt = *reinterpret_cast<const float4*>(beta + c);
      y = make_float4(y.x + bt.x, y.y + bt.y, y.z + bt.z, y.w + bt.w);
    }
    const int64_t off = (int64_t)m * D + c;
    if (out != nullptr) *reinterpret_cast<float4*>(out + off) = y;
    if (hi != nullptr) store_split4(y, keep_lo, hi, lo, off);
    if (rhi != nullptr) store_split4(v, keep_lo, rhi, rlo, off);
    if (r2 != nullptr) store_split4(r2v[k], keep_lo, r2hi, r2lo, off);
  }
}

// out [M, N] fp32 = acc (+ bias [N]) (+ res [M, N]); N even. prefetch:
// thread i of n brings the residual's 128-B lines of the tile at rows m0
// ..., columns nt * 128 ... into L2 (split4_kernel calls it as the tile's K
// loop starts).
struct F32OutEpi {
  float* out;
  const float* bias;
  const float* res;
  int M, N;
  __device__ void prefetch(int m0, int nt, int i, int n) const {
    if (res == nullptr) return;
    for (int l = i; l < BM * BN / 32; l += n) {
      const int m = m0 + l / (BN / 32), c = nt * BN + (l % (BN / 32)) * 32;
      if (m < M && c < N)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(res + (int64_t)m * N + c));
    }
  }
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = nt * BN + 8 * j + 2 * t;
        if (c >= N) continue;
        const int64_t off = (int64_t)m * N + c;
        float y0 = acc[4 * j + 2 * h], y1 = acc[4 * j + 2 * h + 1];
        if (bias != nullptr) {
          const float2 bv = *reinterpret_cast<const float2*>(bias + c);
          y0 += bv.x;
          y1 += bv.y;
        }
        if (res != nullptr) {
          const float2 rv = *reinterpret_cast<const float2*>(res + off);
          y0 += rv.x;
          y1 += rv.y;
        }
        *reinterpret_cast<float2*>(out + off) = make_float2(y0, y1);
      }
    }
  }
};

// hi / lo planes [M, ld] of acc, columns < N (N even)
struct SplitOutEpi {
  bf16* hi;
  bf16* lo;
  int M, N, ld, keep_lo;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = nt * BN + 8 * j + 2 * t;
        if (c >= N) continue;
        __nv_bfloat162 hv, lv;
        split2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], keep_lo, hv, lv);
        const int64_t off = (int64_t)m * ld + c;
        *reinterpret_cast<__nv_bfloat162*>(hi + off) = hv;
        *reinterpret_cast<__nv_bfloat162*>(lo + off) = lv;
      }
    }
  }
};

// SplitPlan with B MN-major: maps 2 / 3 hold B's planes as [K, N] matrices
// (map_mn), read as they are stored with wgmma's transpose bit
struct SplitKNPlan {
  static constexpr int PASSES = 3;
  static constexpr bool B_MN = true;
  __device__ TileSrc src(int nt, int pass) const {
    const int a = pass == 1 ? 1 : 0, b = pass == 2 ? 3 : 2;
    return {a, b, nt * BN, b, nt * BN + 64};
  }
};

// Rows a block of ln_bwd_f32_kernel<true> takes (8 a warp).
constexpr int LNG_ROWS = 64;

// dx = the LayerNorm backward of y = LN(x) * gamma (+ beta) against dxn, plus
// direct and g where given, all fp32 [M, D] (D a multiple of 4, at most 4 *
// 32 * LNB_CHUNKS), one warp a row: the moments recomputed from x in the
// one-pass form of ln_split_kernel, xhat = (x - mean) rstd, dxhat = dxn
// gamma, dx = (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) rstd. Lane l
// holds its float4s of the row's x and dxn (columns 4 l + 128 k) in
// registers, all loaded at once. The data-gradient chains take it without
// GRADS, a block of 8 rows. With GRADS a block takes LNG_ROWS rows, and its
// warps' sums of dxn xhat (dgamma) and dxn (dbeta) per column go to shared
// memory [8][2 D] (each (warp, column) one lane's: no atomics), then in warp
// order to part [gridDim.x][2 D]: colsum_kernel sums those rows.
template <bool GRADS = false>
__global__ void __launch_bounds__(256)
ln_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ dxn, const float* __restrict__ direct,
                  const float* __restrict__ g, float* __restrict__ dx, float* __restrict__ part,
                  int M, int D, float eps) {
  extern __shared__ __align__(16) float red[];
  constexpr int rows = GRADS ? LNG_ROWS / 8 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (GRADS) {
    for (int c = threadIdx.x; c < 16 * D; c += blockDim.x) red[c] = 0.f;
    __syncthreads();
  }
  for (int i = 0; i < rows; ++i) {
    const int m = (blockIdx.x * rows + i) * 8 + warp;
    if (m >= M) break;
    const int64_t base = (int64_t)m * D;
    float4 xv[LNB_CHUNKS], dv[LNB_CHUNKS];
#pragma unroll
    for (int k = 0; k < LNB_CHUNKS; ++k) {
      const int c = 4 * lane + 128 * k;
      if (c < D) {
        xv[k] = *reinterpret_cast<const float4*>(x + base + c);
        dv[k] = *reinterpret_cast<const float4*>(dxn + base + c);
      }
    }
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < LNB_CHUNKS; ++k) {
      if (4 * lane + 128 * k >= D) break;
      const float4 v = xv[k];
      s += (v.x + v.y) + (v.z + v.w);
      s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
    const float mean = warp_sum(s) / (float)D;
    const float rstd = rsqrtf(fmaxf(warp_sum(s2) / (float)D - mean * mean, 0.f) + eps);
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int k = 0; k < LNB_CHUNKS; ++k) {
      const int c = 4 * lane + 128 * k;
      if (c >= D) break;
      const float4 v = xv[k], d = dv[k];
      const float4 gm = *reinterpret_cast<const float4*>(gamma + c);
      const float e0 = d.x * gm.x, e1 = d.y * gm.y, e2 = d.z * gm.z, e3 = d.w * gm.w;
      a1 += (e0 + e1) + (e2 + e3);
      a2 += (e0 * (v.x - mean) + e1 * (v.y - mean)) + (e2 * (v.z - mean) + e3 * (v.w - mean));
      if constexpr (GRADS) {
        float* rg = red + warp * 2 * D + c;
        rg[0] += d.x * ((v.x - mean) * rstd);
        rg[1] += d.y * ((v.y - mean) * rstd);
        rg[2] += d.z * ((v.z - mean) * rstd);
        rg[3] += d.w * ((v.w - mean) * rstd);
        rg[D] += d.x;
        rg[D + 1] += d.y;
        rg[D + 2] += d.z;
        rg[D + 3] += d.w;
      }
    }
    a1 = warp_sum(a1) / (float)D;
    a2 = warp_sum(a2) * rstd / (float)D;
#pragma unroll
    for (int k = 0; k < LNB_CHUNKS; ++k) {
      const int c = 4 * lane + 128 * k;
      if (c >= D) break;
      const float4 v = xv[k], d = dv[k];
      const float4 gm = *reinterpret_cast<const float4*>(gamma + c);
      float4 y = make_float4((d.x * gm.x - a1 - (v.x - mean) * rstd * a2) * rstd,
                             (d.y * gm.y - a1 - (v.y - mean) * rstd * a2) * rstd,
                             (d.z * gm.z - a1 - (v.z - mean) * rstd * a2) * rstd,
                             (d.w * gm.w - a1 - (v.w - mean) * rstd * a2) * rstd);
      if (direct != nullptr) {
        const float4 r = *reinterpret_cast<const float4*>(direct + base + c);
        y = make_float4(y.x + r.x, y.y + r.y, y.z + r.z, y.w + r.w);
      }
      if (g != nullptr) {
        const float4 r = *reinterpret_cast<const float4*>(g + base + c);
        y = make_float4(y.x + r.x, y.y + r.y, y.z + r.z, y.w + r.w);
      }
      *reinterpret_cast<float4*>(dx + base + c) = y;
    }
  }
  if constexpr (GRADS) {
    __syncthreads();
    for (int c = threadIdx.x; c < 2 * D; c += blockDim.x) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += red[w * 2 * D + c];
      part[(int64_t)blockIdx.x * 2 * D + c] = sum;
    }
  }
}

// out[c] = mul * (sum over rows p of part[p * ld + c]) for c < C: a block of
// 32 x 32 threads takes 32 columns, thread (c, s) sums rows s, s + 32, ...
// in order, then thread (c, 0) the 32 slices in order. No atomics: the same
// bits on every call.
template <int Dummy = 0>
__global__ void __launch_bounds__(1024)
colsum_kernel(const float* __restrict__ part, float* __restrict__ out, int P, int C, int ld,
              float mul) {
  __shared__ float red[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x, s = threadIdx.y;
  float sum = 0.f;
  if (c < C)
    for (int p = s; p < P; p += 32) sum += part[(int64_t)p * ld + c];
  red[s][threadIdx.x] = sum;
  __syncthreads();
  if (s == 0 && c < C) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) total += red[i][threadIdx.x];
    out[c] = mul * total;
  }
}

// ---- host side ----------------------------------------------------------------

// hi / lo planes of `count` floats of src (count a multiple of 4, src 16-B aligned)
inline int split_to(const void* src, bf16* hi, bf16* lo, int64_t count, int keep_lo,
                    cudaStream_t st) {
  const int64_t n4 = count / 4;
  const int64_t want = (n4 + 255) / 256;
  const int blocks = want < 132 * 16 ? (int)want : 132 * 16;
  if (blocks == 0) return 0;
  split_kernel<><<<blocks, 256, 0, st>>>(static_cast<const float4*>(src), hi, lo, n4, keep_lo);
  return (int)cudaGetLastError();
}

// the same into planes [2][count] (hi, then lo)
inline int split(const void* src, bf16* planes, int64_t count, int keep_lo, cudaStream_t st) {
  return split_to(src, planes, planes + count, count, keep_lo, st);
}

inline int launch_ln_split(const float* r, const float* gamma, const float* beta, float* out,
                           bf16* hi, bf16* lo, bf16* rhi, bf16* rlo, int M, int D, float eps,
                           int keep_lo, cudaStream_t st, const float* r2 = nullptr,
                           bf16* r2hi = nullptr, bf16* r2lo = nullptr) {
  if (D > 4 * 32 * LNB_CHUNKS) return (int)cudaErrorInvalidValue;
  ln_split_kernel<><<<(M + 7) / 8, 256, 0, st>>>(r, gamma, beta, out, hi, lo, rhi, rlo, r2, r2hi,
                                                 r2lo, M, D, eps, keep_lo);
  return (int)cudaGetLastError();
}

// The SplitPlan product of A's planes (hi, lo: [M, K], row stride lda) and
// B's ([N, K], row stride ldb), every pointer 16-B aligned, strides
// multiples of 8.
template <class Epi>
inline int split_product(const bf16* a_hi, const bf16* a_lo, int64_t lda, const bf16* b_hi,
                         const bf16* b_lo, int64_t ldb, int M, int N, int K, const Epi& epi,
                         cudaStream_t st) {
  Maps maps{};
  int err = map_a(&maps.m[0], a_hi, M, K, lda);
  if (!err) err = map_a(&maps.m[1], a_lo, M, K, lda);
  if (!err) err = map_b(&maps.m[2], b_hi, N, K, ldb);
  if (!err) err = map_b(&maps.m[3], b_lo, N, K, ldb);
  if (err) return err;
  return launch_gemm(maps, SplitPlan{}, epi, (N + BN - 1) / BN, M, K, st);
}

// The SplitKNPlan product of A's planes ([M, K], row stride lda) and B's,
// [K, N] as stored (row stride ldb); the alignment of split_product.
template <class Epi>
inline int split_product_kn(const bf16* a_hi, const bf16* a_lo, int64_t lda, const bf16* b_hi,
                            const bf16* b_lo, int64_t ldb, int M, int N, int K, const Epi& epi,
                            cudaStream_t st) {
  Maps maps{};
  int err = map_a(&maps.m[0], a_hi, M, K, lda);
  if (!err) err = map_a(&maps.m[1], a_lo, M, K, lda);
  if (!err) err = map_mn(&maps.m[2], b_hi, K, N, ldb);
  if (!err) err = map_mn(&maps.m[3], b_lo, K, N, ldb);
  if (err) return err;
  return launch_gemm(maps, SplitKNPlan{}, epi, (N + BN - 1) / BN, M, K, st);
}

// The same product with each K slice's four planes staged together and
// its three bf16 products taken at once (a_hi b_lo, a_lo b_hi, a_hi b_hi):
// each plane crosses from L2 once, where SplitKNPlan's three passes read
// A's hi plane and B's twice; one slice's wgmma group stays in flight while
// the next is issued. A stage is 64 KB (three, one block an SM). For the
// long products of the fp32 backward chains (K up to 2 x 1368), which read
// at the L2's rate.
constexpr int S4_STAGES = 3;
constexpr int S4_STAGE = 2 * A_BYTES + 4 * B_HALF_BYTES;
constexpr int S4_SMEM = S4_STAGES * S4_STAGE + 1024;   // + slack to align the ring to 1 KB

template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
split4_kn_kernel(const __grid_constant__ Maps maps, const Epi epi, int K) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[S4_STAGES], empty[S4_STAGES];
  char* ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  const int nt = blockIdx.x, m0 = blockIdx.y * BM, n0 = nt * BN;
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S4_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S4_STAGES, k0 = kt * BK;
        mbar_wait(&empty[s], ((kt / S4_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], S4_STAGE);
        char* a = ring + s * S4_STAGE;
        char* b = a + 2 * A_BYTES;
        for (int lo = 0; lo < 2; ++lo) {
          tma_load_2d(a + lo * A_BYTES, &maps.m[lo], &full[s], k0, m0);
          tma_load_2d(b + 2 * lo * B_HALF_BYTES, &maps.m[2 + lo], &full[s], n0, k0);
          tma_load_2d(b + (2 * lo + 1) * B_HALF_BYTES, &maps.m[2 + lo], &full[s], n0 + 64, k0);
        }
      }
    }
    return;
  }
  const int wg = warp >> 2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S4_STAGES;
    mbar_wait(&full[s], (kt / S4_STAGES) & 1);
    const uint32_t ah = smem_u32(ring + s * S4_STAGE) + wg * (64 * BK * 2), al = ah + A_BYTES;
    const uint32_t bh = smem_u32(ring + s * S4_STAGE + 2 * A_BYTES), bl = bh + 2 * B_HALF_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t a_hi = desc_sw128(ah + kk * 32), a_lo = desc_sw128(al + kk * 32);
      const uint64_t b_hi = desc_mn_sw128(bh + kk * 2048, B_HALF_BYTES);
      wgmma_m64n128k16_kn(acc, a_hi, desc_mn_sw128(bl + kk * 2048, B_HALF_BYTES));
      wgmma_m64n128k16_kn(acc, a_lo, b_hi);
      wgmma_m64n128k16_kn(acc, a_hi, b_hi);
    }
    wgmma_commit();
    wgmma_wait_one();   // the slice before this one is read: give its stage back
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % S4_STAGES]);
  }
  wgmma_wait_all();
  fence_regs(acc);
  epi(acc, m0 + wg * 64 + (warp & 3) * 16, nt, lane);
}

// split_product_kn's product on split4_kn_kernel.
template <class Epi>
inline int split4_product_kn(const bf16* a_hi, const bf16* a_lo, int64_t lda, const bf16* b_hi,
                             const bf16* b_lo, int64_t ldb, int M, int N, int K, const Epi& epi,
                             cudaStream_t st) {
  Maps maps{};
  int err = map_a(&maps.m[0], a_hi, M, K, lda);
  if (!err) err = map_a(&maps.m[1], a_lo, M, K, lda);
  if (!err) err = map_mn(&maps.m[2], b_hi, K, N, ldb);
  if (!err) err = map_mn(&maps.m[3], b_lo, K, N, ldb);
  if (err) return err;
  auto kern = split4_kn_kernel<Epi>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S4_SMEM);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, THREADS, S4_SMEM, st>>>(maps, epi, K);
  return (int)cudaGetLastError();
}

// The forward products of the fp32 chains (rows 1f-3f: the GEGLU's value |
// gate and down products, the block's q | k | v and output projections) in
// the same form, with B K-major as the weights are stored ([N, K]): for
// each K slice of 64, one TMA stage holds A's hi / lo tiles (128 rows) and
// B's hi / lo tiles (two 64-row halves each), and a consumer warpgroup
// issues a_hi b_lo, a_lo b_hi, a_hi b_hi from that one stage into one fp32
// accumulator, one slice's wgmma group in flight while the next is issued.
// SplitPlan's three passes each walked every K slice: A's hi plane and B's
// crossed from L2 twice and the ring drained and refilled at each pass.
//   - The plan is SplitPlan or tc::QkvSplitPlan (gemm_kernel's three-pass
//     plans; pass 0's source) or ff::GegluSplitPlan: it names each
//     operand's hi plane, whose lo plane is the next map (a, a + 1; b, b +
//     1), and B's two 64-row halves (the GEGLU's value and gate rows).
//   - Persistent, one block an SM (three 64-KB stages): the block walks the
//     tiles u = blockIdx.x, + gridDim.x, ..., row-tile major (u / n_tiles
//     rows, u % n_tiles columns), so the blocks in flight share A's rows and
//     all of B from L2.
//   - PING (the FF's products): each consumer warpgroup owns whole 128 x
//     128 tiles (two m64n128 accumulators), the block's even tiles
//     warpgroup 0's and its odd tiles warpgroup 1's; their K loops take
//     turns (two named barriers), so one warpgroup's epilogue runs while
//     the other's wgmma run, and the ring's stages are consumed in the
//     order they are filled. Without PING (the block's products: QkvEpi
//     spills beside two accumulators, and the output projection's four K
//     slices ran faster so, PERF.md §6) the two warpgroups split each
//     tile's rows and the epilogue waits for both.
//   - An epilogue with a `prefetch` member (F32OutEpi: the residual) has
//     it called as its tile's K loop starts, so the epilogue's loads find
//     their lines in L2.
//   - A ragged K (the down product's 1365) and past-the-edge rows or
//     columns read TMA's zeros, as in gemm_kernel.
//   - Every sum runs in one order (slice by slice, the three products in
//     the order above): two calls give the same bits.
template <class E, class = void>
struct Prefetch {
  __device__ static void run(const E&, int, int, int, int) {}
};
template <class E>
struct Prefetch<E, std::void_t<decltype(&E::prefetch)>> {
  __device__ static void run(const E& e, int m0, int nt, int i, int n) { e.prefetch(m0, nt, i, n); }
};

template <bool PING, class Plan, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
split4_kernel(const __grid_constant__ Maps maps, const Plan plan, const Epi epi, int n_tiles,
              int tiles, int K) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[S4_STAGES], empty[S4_STAGES];
  char* ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the block's tiles: u = blockIdx.x + j gridDim.x, j < count
  const int count = blockIdx.x < tiles ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S4_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PING ? CONSUMER_WARPS / 2 : CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (lane == 0) {
      int it = 0;   // slices loaded by this block, over all its tiles
      for (int j = 0; j < count; ++j) {
        const int u = blockIdx.x + j * gridDim.x;
        const int nt = u % n_tiles, m0 = (u / n_tiles) * BM;
        const TileSrc src = plan.src(nt, 0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % S4_STAGES, k0 = kt * BK;
          mbar_wait(&empty[s], ((it / S4_STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], S4_STAGE);
          char* a = ring + s * S4_STAGE;
          char* b = a + 2 * A_BYTES;
          for (int lo = 0; lo < 2; ++lo) {
            tma_load_2d(a + lo * A_BYTES, &maps.m[src.a + lo], &full[s], k0, m0);
            tma_load_2d(b + 2 * lo * B_HALF_BYTES, &maps.m[src.b0 + lo], &full[s], k0, src.row0);
            tma_load_2d(b + (2 * lo + 1) * B_HALF_BYTES, &maps.m[src.b1 + lo], &full[s], k0,
                        src.row1);
          }
        }
      }
    }
    return;
  }
  const int wg = warp >> 2;
  // one slice's products: A rows r0 .. r0 + 63 of the stage at `ah`
  auto slice = [&](float (&acc)[64], uint32_t ah, int r0) {
    const uint32_t a = ah + r0 * BK * 2, al = a + A_BYTES;
    const uint32_t bh = ah + 2 * A_BYTES, bl = bh + 2 * B_HALF_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t a_hi = desc_sw128(a + kk * 32), b_hi = desc_sw128(bh + kk * 32);
      wgmma_m64n128k16(acc, a_hi, desc_sw128(bl + kk * 32));
      wgmma_m64n128k16(acc, desc_sw128(al + kk * 32), b_hi);
      wgmma_m64n128k16(acc, a_hi, b_hi);
    }
  };
  if constexpr (PING) {
    for (int j = wg; j < count; j += 2) {
      const int u = blockIdx.x + j * gridDim.x;
      const int nt = u % n_tiles, m0 = (u / n_tiles) * BM;
      Prefetch<Epi>::run(epi, m0, nt, threadIdx.x & 127, 128);
      float acc0[64], acc1[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
      fence_regs(acc0);
      fence_regs(acc1);
      // the other warpgroup has waited for every slice of tile j - 1
      if (j > 0)
        asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(CONSUMER_WARPS * 32) : "memory");
      int it = j * nk;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % S4_STAGES;
        mbar_wait(&full[s], (it / S4_STAGES) & 1);
        const uint32_t ah = smem_u32(ring + s * S4_STAGE);
        wgmma_fence();
        slice(acc0, ah, 0);
        slice(acc1, ah, 64);
        wgmma_commit();
        wgmma_wait_one();   // the slice before this one is read: give its stage back
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S4_STAGES]);
      }
      // tile j + 1's K loop may start: this one has waited for all its slices
      if (j + 1 < count)
        asm volatile("bar.arrive %0, %1;" ::"r"(2 - wg), "n"(CONSUMER_WARPS * 32) : "memory");
      wgmma_wait_all();
      fence_regs(acc0);
      fence_regs(acc1);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % S4_STAGES]);   // the tile's last slice
      epi(acc0, m0 + (warp & 3) * 16, nt, lane);
      epi(acc1, m0 + 64 + (warp & 3) * 16, nt, lane);
    }
  } else {
    int it = 0;
    for (int j = 0; j < count; ++j) {
      const int u = blockIdx.x + j * gridDim.x;
      const int nt = u % n_tiles, m0 = (u / n_tiles) * BM;
      Prefetch<Epi>::run(epi, m0, nt, threadIdx.x, CONSUMER_WARPS * 32);
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      fence_regs(acc);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % S4_STAGES;
        mbar_wait(&full[s], (it / S4_STAGES) & 1);
        wgmma_fence();
        slice(acc, smem_u32(ring + s * S4_STAGE), wg * 64);
        wgmma_commit();
        wgmma_wait_one();   // the slice before this one is read: give its stage back
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S4_STAGES]);
      }
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % S4_STAGES]);   // the tile's last slice
      epi(acc, m0 + wg * 64 + (warp & 3) * 16, nt, lane);
    }
  }
}

// SMs of the current device (the persistent kernels' grid).
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Launch split4_kernel over n_tiles x ceil(M / BM) tiles, one block an SM
// (or a tile, where there are fewer); returns the launch's error.
template <bool PING, class Plan, class Epi>
int launch_split4(const Maps& maps, const Plan& plan, const Epi& epi, int n_tiles, int M, int K,
                  cudaStream_t st) {
  auto kern = split4_kernel<PING, Plan, Epi>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S4_SMEM);
  const int tiles = n_tiles * ((M + BM - 1) / BM);
  if (tiles == 0) return 0;
  kern<<<tiles < sm_count() ? tiles : sm_count(), THREADS, S4_SMEM, st>>>(maps, plan, epi,
                                                                          n_tiles, tiles, K);
  return (int)cudaGetLastError();
}

// split_product's product on split4_kernel.
template <bool PING, class Epi>
inline int split4_product(const bf16* a_hi, const bf16* a_lo, int64_t lda, const bf16* b_hi,
                          const bf16* b_lo, int64_t ldb, int M, int N, int K, const Epi& epi,
                          cudaStream_t st) {
  Maps maps{};
  int err = map_a(&maps.m[0], a_hi, M, K, lda);
  if (!err) err = map_a(&maps.m[1], a_lo, M, K, lda);
  if (!err) err = map_b(&maps.m[2], b_hi, N, K, ldb);
  if (!err) err = map_b(&maps.m[3], b_lo, N, K, ldb);
  if (err) return err;
  return launch_split4<PING>(maps, SplitPlan{}, epi, (N + BN - 1) / BN, M, K, st);
}

// The same staged products at 64-row tiles, for products of fewer 128 x 128
// tiles than the card has SMs (the fp32 BERT layer's of width 768 at a
// train step's M = B n = 1,024 rows: 48 tiles of 128 x 128, 96 of 64 x
// 128). A block takes one 64 x 128 tile: one
// producer warp feeds a ring of stages, each a K slice's four planes (A's
// hi / lo 64 rows: boxes of 64 rows, map_b's; B's hi / lo as two 64-row
// halves each, K-major [N, K] as stored weights of the forward, or with
// B_MN a [K, N] weight read as stored, map_mn's); consumer warpgroup w
// takes the slices kt with kt % 2 == w into its own accumulator, a_hi b_lo,
// a_lo b_hi, a_hi b_hi from each stage, and keeps one slice's wgmma group
// in flight; at the end each warp pair (warp q of both warpgroups, the same
// 16 rows) meets in shared memory and one of the pair adds the other's
// sums (a + b: the same bits on every call) and runs the epilogue with
// gemm_kernel's interface. A stage is 48 KB, four stages.
constexpr int S64_SPLIT_STAGES = 4;
constexpr int S64_SPLIT_STAGE = 2 * A64_BYTES + 4 * B_HALF_BYTES;
constexpr int S64_SPLIT_SMEM = S64_SPLIT_STAGES * S64_SPLIT_STAGE + RED64_BYTES + 1024;

template <bool B_MN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
split4_64_kernel(const __grid_constant__ Maps maps, const Epi epi, int K) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[S64_SPLIT_STAGES], empty[S64_SPLIT_STAGES];
  char* ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  float* red = reinterpret_cast<float*>(ring + S64_SPLIT_STAGES * S64_SPLIT_STAGE);
  const int nt = blockIdx.x, m0 = blockIdx.y * 64, n0 = nt * BN;
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S64_SPLIT_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S64_SPLIT_STAGES, k0 = kt * BK;
        mbar_wait(&empty[s], ((kt / S64_SPLIT_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], S64_SPLIT_STAGE);
        char* a = ring + s * S64_SPLIT_STAGE;
        char* b = a + 2 * A64_BYTES;
        for (int lo = 0; lo < 2; ++lo) {
          tma_load_2d(a + lo * A64_BYTES, &maps.m[lo], &full[s], k0, m0);
          char* bp = b + 2 * lo * B_HALF_BYTES;
          if constexpr (B_MN) {
            tma_load_2d(bp, &maps.m[2 + lo], &full[s], n0, k0);
            tma_load_2d(bp + B_HALF_BYTES, &maps.m[2 + lo], &full[s], n0 + 64, k0);
          } else {
            tma_load_2d(bp, &maps.m[2 + lo], &full[s], k0, n0);
            tma_load_2d(bp + B_HALF_BYTES, &maps.m[2 + lo], &full[s], k0, n0 + 64);
          }
        }
      }
    }
    return;
  }
  const int wg = warp >> 2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int kt = wg; kt < nk; kt += 2) {
    const int s = kt % S64_SPLIT_STAGES;
    mbar_wait(&full[s], (kt / S64_SPLIT_STAGES) & 1);
    const uint32_t ah = smem_u32(ring + s * S64_SPLIT_STAGE), al = ah + A64_BYTES;
    const uint32_t bh = ah + 2 * A64_BYTES, bl = bh + 2 * B_HALF_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t a_hi = desc_sw128(ah + kk * 32), a_lo = desc_sw128(al + kk * 32);
      if constexpr (B_MN) {
        const uint64_t b_hi = desc_mn_sw128(bh + kk * 2048, B_HALF_BYTES);
        wgmma_m64n128k16_kn(acc, a_hi, desc_mn_sw128(bl + kk * 2048, B_HALF_BYTES));
        wgmma_m64n128k16_kn(acc, a_lo, b_hi);
        wgmma_m64n128k16_kn(acc, a_hi, b_hi);
      } else {
        const uint64_t b_hi = desc_sw128(bh + kk * 32);
        wgmma_m64n128k16(acc, a_hi, desc_sw128(bl + kk * 32));
        wgmma_m64n128k16(acc, a_lo, b_hi);
        wgmma_m64n128k16(acc, a_hi, b_hi);
      }
    }
    wgmma_commit();
    wgmma_wait_one();   // this warpgroup's slice before this one is read: give its stage back
    if (kt >= 2 && lane == 0) mbar_arrive(&empty[(kt - 2) % S64_SPLIT_STAGES]);
  }
  wgmma_wait_all();
  fence_regs(acc);
  // rows 16 q ... (q = warp % 4) finish in warpgroup 0 for q < 2 and in
  // warpgroup 1 for q >= 2: the other warp of the pair hands over its sums
  const int q = warp & 3, slot = q * 32 + lane;
  const bool finisher = (wg == 0) == (q < 2);
  if (!finisher) {
#pragma unroll
    for (int i = 0; i < 64; ++i) red[i * 128 + slot] = acc[i];
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_WARPS * 32) : "memory");
  if (finisher) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += red[i * 128 + slot];
    epi(acc, m0 + q * 16, nt, lane);
  }
}

// Shared-memory descriptor of a K-major tile of 64-B rows written by TMA with
// the 64-B swizzle: 8-row core groups 512 B apart (SBO); a 16-deep K step
// inside the row adds 32 B to the start address.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

// The map of a [rows, cols] bf16 matrix (row stride ld) in boxes of 32
// columns x box_rows rows with the 64-B swizzle; zeros outside. Returns 0
// or an ERR_ code.
inline int map_sw64(CUtensorMap* map, const void* ptr, int rows, int cols, int64_t ld,
                    int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {32u, (cuuint32_t)box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                  box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_MAP;
}

// The staged products at K slices of 32 and two blocks an SM, for products
// of one to four rounds of 128 x 128 tiles (the fp32 BERT layer's QKV, W1
// and dh1 products at a train step's 1,024 rows: 144 and 192 tiles). There
// split4_kernel's one block an SM left 12 or 60 SMs a second round, and
// 64-row tiles read as many bytes as three passes: both ran slower than
// the three-pass gemm_kernel at two blocks an SM (H100 80GB HBM3, 700 W;
// PERF.md). Here a stage holds a 32-deep K slice's four planes (A's 128
// rows hi / lo, 8 KB each, and B's two 64-row halves hi / lo, 4 KB each;
// 64-B swizzle, or B_MN: a weight [K, N] read as stored, boxes of 64
// columns x 32 K rows with the 128-B swizzle), 32 KB, three stages, so two
// blocks share an SM and every tile of such a product is in flight at once.
// The warpgroups split the tile's rows; a_hi b_lo, a_lo b_hi, a_hi b_hi
// from each stage into one accumulator, in order: the same bits every call.
constexpr int BK32 = 32;
constexpr int S32_A = BM * BK32 * 2;              // one plane of A's 128 rows: 8 KB
constexpr int S32_BH = 64 * BK32 * 2;             // one plane of a B half: 4 KB
constexpr int S32_STAGE = 2 * S32_A + 4 * S32_BH; // 32 KB
constexpr int S32_STAGES = 3;
constexpr int S32_SMEM = S32_STAGES * S32_STAGE + 1024;   // + slack to align the ring to 1 KB

template <bool B_MN, class Epi>
__global__ void __launch_bounds__(THREADS, 2)
split4_32_kernel(const __grid_constant__ Maps maps, const Epi epi, int K) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[S32_STAGES], empty[S32_STAGES];
  char* ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  const int nt = blockIdx.x, m0 = blockIdx.y * BM, n0 = nt * BN;
  const int nk = (K + BK32 - 1) / BK32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S32_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S32_STAGES, k0 = kt * BK32;
        mbar_wait(&empty[s], ((kt / S32_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], S32_STAGE);
        char* a = ring + s * S32_STAGE;
        char* b = a + 2 * S32_A;
        for (int lo = 0; lo < 2; ++lo) {
          tma_load_2d(a + lo * S32_A, &maps.m[lo], &full[s], k0, m0);
          char* bp = b + 2 * lo * S32_BH;
          if constexpr (B_MN) {
            tma_load_2d(bp, &maps.m[2 + lo], &full[s], n0, k0);
            tma_load_2d(bp + S32_BH, &maps.m[2 + lo], &full[s], n0 + 64, k0);
          } else {
            tma_load_2d(bp, &maps.m[2 + lo], &full[s], k0, n0);
            tma_load_2d(bp + S32_BH, &maps.m[2 + lo], &full[s], k0, n0 + 64);
          }
        }
      }
    }
    return;
  }
  const int wg = warp >> 2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S32_STAGES;
    mbar_wait(&full[s], (kt / S32_STAGES) & 1);
    const uint32_t ah = smem_u32(ring + s * S32_STAGE) + wg * (64 * BK32 * 2), al = ah + S32_A;
    const uint32_t bh = smem_u32(ring + s * S32_STAGE + 2 * S32_A), bl = bh + 2 * S32_BH;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK32 / 16; ++kk) {
      const uint64_t a_hi = desc_sw64(ah + kk * 32), a_lo = desc_sw64(al + kk * 32);
      if constexpr (B_MN) {
        const uint64_t b_hi = desc_mn_sw128(bh + kk * 2048, S32_BH);
        wgmma_m64n128k16_kn(acc, a_hi, desc_mn_sw128(bl + kk * 2048, S32_BH));
        wgmma_m64n128k16_kn(acc, a_lo, b_hi);
        wgmma_m64n128k16_kn(acc, a_hi, b_hi);
      } else {
        const uint64_t b_hi = desc_sw64(bh + kk * 32);
        wgmma_m64n128k16(acc, a_hi, desc_sw64(bl + kk * 32));
        wgmma_m64n128k16(acc, a_lo, b_hi);
        wgmma_m64n128k16(acc, a_hi, b_hi);
      }
    }
    wgmma_commit();
    wgmma_wait_one();   // the slice before this one is read: give its stage back
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % S32_STAGES]);
  }
  wgmma_wait_all();
  fence_regs(acc);
  epi(acc, m0 + wg * 64 + (warp & 3) * 16, nt, lane);
}

// split4_32_kernel's product of A's planes (hi, lo: [M, K], row stride lda)
// and B's (B_MN: [K, N] as stored, else [N, K]; row stride ldb); every
// pointer 16-B aligned, strides multiples of 8.
template <bool B_MN, class Epi>
inline int split4_product32(const bf16* a_hi, const bf16* a_lo, int64_t lda, const bf16* b_hi,
                            const bf16* b_lo, int64_t ldb, int M, int N, int K, const Epi& epi,
                            cudaStream_t st) {
  Maps maps{};
  int err = map_sw64(&maps.m[0], a_hi, M, K, lda, BM);
  if (!err) err = map_sw64(&maps.m[1], a_lo, M, K, lda, BM);
  if constexpr (B_MN) {
    if (!err) err = make_map(&maps.m[2], b_hi, K, N, ldb, BK32);
    if (!err) err = make_map(&maps.m[3], b_lo, K, N, ldb, BK32);
  } else {
    if (!err) err = map_sw64(&maps.m[2], b_hi, N, K, ldb, 64);
    if (!err) err = map_sw64(&maps.m[3], b_lo, N, K, ldb, 64);
  }
  if (err) return err;
  auto kern = split4_32_kernel<B_MN, Epi>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S32_SMEM);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, THREADS, S32_SMEM, st>>>(maps, epi, K);
  return (int)cudaGetLastError();
}

// 128 x 128 tiles of an M x N product
inline int64_t tiles128(int M, int N) {
  return (int64_t)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

// Whether a product of M x N takes 64-row tiles (split4_64_kernel): fewer
// 128 x 128 tiles than the card has SMs. (At 144 and 192 tiles the 64-row
// tiles ran slower than split4_32_kernel: H100 80GB HBM3, 700 W, PERF.md.)
inline bool rows64(int M, int N) { return tiles128(M, N) < sm_count(); }

// The staged split product of A's planes (hi, lo: [M, K], row stride lda)
// and B's (B_MN: [K, N] as stored, else [N, K]; row stride ldb) on 64-row
// tiles; every pointer 16-B aligned, strides multiples of 8.
template <bool B_MN, class Epi>
inline int split4_product64(const bf16* a_hi, const bf16* a_lo, int64_t lda, const bf16* b_hi,
                            const bf16* b_lo, int64_t ldb, int M, int N, int K, const Epi& epi,
                            cudaStream_t st) {
  Maps maps{};
  int err = map_b(&maps.m[0], a_hi, M, K, lda);   // boxes of 64 rows
  if (!err) err = map_b(&maps.m[1], a_lo, M, K, lda);
  if constexpr (B_MN) {
    if (!err) err = map_mn(&maps.m[2], b_hi, K, N, ldb);
    if (!err) err = map_mn(&maps.m[3], b_lo, K, N, ldb);
  } else {
    if (!err) err = map_b(&maps.m[2], b_hi, N, K, ldb);
    if (!err) err = map_b(&maps.m[3], b_lo, N, K, ldb);
  }
  if (err) return err;
  auto kern = split4_64_kernel<B_MN, Epi>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S64_SPLIT_SMEM);
  dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
  kern<<<grid, THREADS, S64_SPLIT_SMEM, st>>>(maps, epi, K);
  return (int)cudaGetLastError();
}

// The split product of planes a [2][M][ld] and b [2][N][ld] (hi, then lo;
// K columns read), each K slice's four planes staged once, on the tiling
// its 128 x 128 tiles pick: 64-row tiles where they are fewer than the SMs
// (the fp32 BERT layer's width-768 products at a train step's 1,024 rows,
// CTGenerate's first-frame patch embed), the persistent split4_kernel with
// ping-pong warpgroups where each block has four or more (the prompts'
// 18,432 rows, the fp32 train step's 27,648 patches), and between the two
// (144 to 528 tiles) 32-deep slices at two blocks an SM.
template <class Epi>
inline int split4_planes(const bf16* a, const bf16* b, int64_t ld, int M, int N, int K,
                         const Epi& epi, cudaStream_t st) {
  const bf16 *a_lo = a + (int64_t)M * ld, *b_lo = b + (int64_t)N * ld;
  if (rows64(M, N)) return split4_product64<false>(a, a_lo, ld, b, b_lo, ld, M, N, K, epi, st);
  if (tiles128(M, N) >= 4 * sm_count())
    return split4_product<true>(a, a_lo, ld, b, b_lo, ld, M, N, K, epi, st);
  return split4_product32<false>(a, a_lo, ld, b, b_lo, ld, M, N, K, epi, st);
}

// The LayerNorm backward; with `part` (not null) also the gains' partial
// sums, [ln_parts(M)][2 D].
inline int ln_parts(int M) { return (M + LNG_ROWS - 1) / LNG_ROWS; }

inline int launch_ln_bwd_f32(const float* x, const float* gamma, const float* dxn,
                             const float* direct, const float* g, float* dx, int M, int D,
                             cudaStream_t st, float* part = nullptr) {
  if (D > 4 * 32 * LNB_CHUNKS) return (int)cudaErrorInvalidValue;
  if (part == nullptr) {
    ln_bwd_f32_kernel<false><<<(M + 7) / 8, 256, 0, st>>>(x, gamma, dxn, direct, g, dx, nullptr,
                                                         M, D, 1e-5f);
  } else {
    const int smem = 16 * D * (int)sizeof(float);
    cudaFuncSetAttribute(ln_bwd_f32_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    ln_bwd_f32_kernel<true><<<ln_parts(M), 256, smem, st>>>(x, gamma, dxn, direct, g, dx, part,
                                                             M, D, 1e-5f);
  }
  return (int)cudaGetLastError();
}

// out [C] = mul * the column sums of part [P][ld] (colsum_kernel)
inline int launch_colsum(const float* part, float* out, int P, int C, int ld, float mul,
                         cudaStream_t st) {
  colsum_kernel<><<<(C + 31) / 32, dim3(32, 32), 0, st>>>(part, out, P, C, ld, mul);
  return (int)cudaGetLastError();
}

}  // namespace sm90

namespace ff {

// The GEGLU's first product in fp32, on split4_kernel: maps 0 xn_hi, 1
// xn_lo, 2 the hi plane of the stacked weight [value rows; gate rows], 3
// its lo plane (the kernel reads a map's lo plane at the next map); value
// rows nt * 64 ... and the gate rows gate + nt * 64 ... (gate = inner for
// w_in as stored). A value tile past inner reads gate (or zero) rows, a
// gate tile past the map reads TMA's zeros: both land only in columns >=
// inner, which the epilogue does not use.
struct GegluSplitPlan {
  int gate;
  __device__ sm90::TileSrc src(int nt, int) const { return {0, 2, nt * 64, 2, gate + nt * 64}; }
};

}  // namespace ff
}  // namespace ctc
