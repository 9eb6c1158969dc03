// Pieces shared by the bf16 BERT layer's forward chain (bert_layer_bf16.cu)
// and its recompute backward (bert_layer_bwd.cu): the ports of
// ct_clip_ut_tpu/ops/pallas_bert_layer.py `_fwd_impl` (bf16, train mode) and
// `_bwd_impl`.
//
//   philox4x32_10 / keep4   the dropout masks. The TPU kernel reseeds its
//                           hardware PRNG per (site, sequence, head); here a
//                           counter-based generator gives every element its
//                           own bits: counter = (position in the element's
//                           [n, n] or [n, D] slab / 4, site, sequence, head),
//                           key = (the site's seed, 0), and the four output
//                           words go to four consecutive positions. Forward,
//                           backward and the plain PyTorch version
//                           (ops/bert_layer.py:philox_keep) regenerate the
//                           same mask whatever the tiling.
//   bert_gemm_kernel<Epi>   C = A @ B^T on the shared wmma tile with an
//                           epilogue over four columns at a time (bias; bias +
//                           keep mask + residual; bias + GELU; ...).
//   bert_attn_fwd_kernel    softmax(q k^T / sqrt(dh) + mask) (x keep) @ v per
//                           (sequence, head, 32 query rows): a whole score
//                           row sits in shared memory (n <= 672), so the
//                           probabilities are normalised, then masked, then
//                           rounded to bf16, where the TPU kernel rounds.
//   bert_ln_fwd_kernel      LayerNorm rows in the one-pass E[r^2] - E[r]^2
//                           form, saving (mean, rstd).
//   bert_forward_chain      the seven launches of one layer.
//
// Rows are laid out [B, npad, ...] with npad = n rounded up to 32 (the
// wrapper pads x with zero rows and the key mask): `n` is the logical
// length, which the Philox counters and the key validity use.
#pragma once

#include "bwd_common.cuh"

namespace ctc {

constexpr int BERT_DH = 64;          // head width of the attention core
constexpr int BA_Q = 32;             // query rows per block
constexpr int BA_THREADS = 256;
constexpr int BA_SCRATCH = (BA_THREADS / 32) * 256 * 4;   // a 16 x 16 fp32 tile a warp
constexpr int BERT_MAX_NPAD = 672;   // the backward's query pass holds 320 * npad + 3072 B of shared memory

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// The keep factors (0 or scale) of positions idx..idx+3 (idx a multiple of 4)
// of the slab (site, b, h). thresh == 0 keeps everything unscaled.
__device__ __forceinline__ float4 keep4(int seed, unsigned site, unsigned b, unsigned h,
                                        unsigned idx, unsigned thresh, float scale) {
  if (thresh == 0u) return make_float4(1.f, 1.f, 1.f, 1.f);
  const uint4 r = philox4x32_10(make_uint4(idx >> 2, site, b, h), make_uint2((unsigned)seed, 0u));
  return make_float4(r.x >= thresh ? scale : 0.f, r.y >= thresh ? scale : 0.f,
                     r.z >= thresh ? scale : 0.f, r.w >= thresh ? scale : 0.f);
}

struct Dropout {
  const int* seeds;        // [3] on the device: attention, post-attention, post-FF
  unsigned thresh_attn, thresh_hidden;
  float scale_attn, scale_hidden;
};

__device__ __forceinline__ uint2 pack_bf16x4(float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 out;
  out.x = *reinterpret_cast<unsigned*>(&lo);
  out.y = *reinterpret_cast<unsigned*>(&hi);
  return out;
}

__device__ __forceinline__ float4 unpack_bf16x4(uint2 v) {
  const __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&v.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// ---- the GEMM with an epilogue --------------------------------------------

// out = bf16(v + bias): the QKV projection (q, k, v are used as bf16 operands
// only, so rounding here is rounding there).
struct EpiBiasBf16 {
  static constexpr bool kColSum = false;
  const float* bias;
  bf16* out;
  int ld;
  __device__ __forceinline__ float4 operator()(int m, int n, float4 v) const {
    const float4 b = *reinterpret_cast<const float4*>(bias + n);
    *reinterpret_cast<uint2*>(out + (int64_t)m * ld + n) =
        pack_bf16x4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
    return v;
  }
};

// r = (v + bias) * keep + residual in fp32: both hidden sites. The residual is
// x (bf16) after the attention, the fp32 LN1 output after the FF.
struct EpiHidden {
  static constexpr bool kColSum = false;
  const float* bias;
  const bf16* res_b;
  const float* res_f;
  float* out;
  int ld, n, npad;
  const int* seeds;
  unsigned site, thresh;
  float scale;
  __device__ __forceinline__ float4 operator()(int m, int c, float4 v) const {
    const float4 b = *reinterpret_cast<const float4*>(bias + c);
    const int seq = m / npad, i = m % npad;
    const float4 k = keep4(thresh ? seeds[site] : 0, site, seq, 0u, (unsigned)(i * ld + c), thresh,
                           scale);
    float4 r;
    if (res_b != nullptr) {
      r = unpack_bf16x4(*reinterpret_cast<const uint2*>(res_b + (int64_t)m * ld + c));
    } else {
      r = *reinterpret_cast<const float4*>(res_f + (int64_t)m * ld + c);
    }
    *reinterpret_cast<float4*>(out + (int64_t)m * ld + c) =
        make_float4((v.x + b.x) * k.x + r.x, (v.y + b.y) * k.y + r.y, (v.z + b.z) * k.z + r.z,
                    (v.w + b.w) * k.w + r.w);
    return v;
  }
};

__device__ __forceinline__ float gelu_cdf(float x) {
  return 0.5f * (1.0f + erff(x * 0.7071067811865476f));
}

// h1 = v + bias (fp32, kept for the backward's GELU') and g = bf16(gelu(h1)).
struct EpiGelu {
  static constexpr bool kColSum = false;
  const float* bias;
  float* h1;
  bf16* g;
  int ld;
  __device__ __forceinline__ float4 operator()(int m, int n, float4 v) const {
    const float4 b = *reinterpret_cast<const float4*>(bias + n);
    const float4 h = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
    *reinterpret_cast<float4*>(h1 + (int64_t)m * ld + n) = h;
    *reinterpret_cast<uint2*>(g + (int64_t)m * ld + n) =
        pack_bf16x4(h.x * gelu_cdf(h.x), h.y * gelu_cdf(h.y), h.z * gelu_cdf(h.z),
                    h.w * gelu_cdf(h.w));
    return v;
  }
};

template <class Epi>
__global__ void __launch_bounds__(THREADS)
bert_gemm_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb, int M,
                 int N, int K, Epi epi, float* __restrict__ colsum) {
  extern __shared__ __align__(128) char smem[];
  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const RowMajor a{A, lda, M, K};
  const RowMajor b{B + (int64_t)n0 * ldb, ldb, N - n0, K};
  block_gemm([&](int r, int k) { return a.load8(row0 + r, k); },
             [&](int r, int k) { return b.load8(r, k); }, K, smem);
  float* Cs = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < BM * (BN / 4); i += THREADS) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    const int m = row0 + r, n = n0 + c;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < M && n < N) v = epi(m, n, *reinterpret_cast<const float4*>(Cs + r * LDC + c));
    if (Epi::kColSum) *reinterpret_cast<float4*>(Cs + r * LDC + c) = v;
  }
  if (Epi::kColSum) {                    // the epilogue's values summed over the tile's rows
    __syncthreads();
    const int c = threadIdx.x;
    if (c < BN && n0 + c < N) {
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += Cs[r * LDC + c];
      atomicAdd(colsum + n0 + c, s);
    }
  }
}

// C [M, N] = A [M, K] @ B [N, K]^T through `epi`; N a multiple of 4.
template <class Epi>
static void launch_bert_gemm(const bf16* A, int lda, const bf16* B, int ldb, int M, int N, int K,
                             const Epi& epi, float* colsum, cudaStream_t st) {
  cudaFuncSetAttribute(bert_gemm_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       GEMM_SMEM);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bert_gemm_kernel<Epi><<<grid, THREADS, GEMM_SMEM, st>>>(A, lda, B, ldb, M, N, K, epi, colsum);
}

// ---- attention -------------------------------------------------------------

// S [BA_Q][lds] (fp32, shared) = Q_tile @ K^T for one (sequence, head): the
// wmma fragments are read straight from the bf16 qkv buffer (rows 3D apart).
__device__ __forceinline__ void bert_scores(const bf16* Q, const bf16* K, int ld3, int npad,
                                            float* S, int lds) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[2][4];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wmma::load_matrix_sync(fq[rt][kk], Q + (int64_t)rt * 16 * ld3 + kk * 16, ld3);
  for (int ct = warp; ct < npad / 16; ct += BA_THREADS / 32) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
      wmma::load_matrix_sync(fk, K + (int64_t)ct * 16 * ld3 + kk * 16, ld3);
      wmma::mma_sync(acc[0], fq[0][kk], fk, acc[0]);
      wmma::mma_sync(acc[1], fq[1][kk], fk, acc[1]);
    }
    wmma::store_matrix_sync(S + ct * 16, acc[0], lds, wmma::mem_row_major);
    wmma::store_matrix_sync(S + 16 * lds + ct * 16, acc[1], lds, wmma::mem_row_major);
  }
}

// One row of scores in shared memory -> its probabilities, in place:
// p = exp(s - max) / sum over the n real keys of s = S * scale + mask, 0 for
// the padding keys. A fully masked row stays uniform: the mask's
// finfo(float32).min absorbs every score and all n terms are exp(0). Called
// by one warp.
__device__ __forceinline__ void bert_softmax_row(float* srow, const float* mrow, int n, int npad,
                                                 float scale) {
  const int lane = threadIdx.x & 31;
  float mx = -CUDART_INF_F;
  for (int j = lane * 4; j < npad; j += 128) {
    float4 s = *reinterpret_cast<float4*>(srow + j);
    const float4 mk = *reinterpret_cast<const float4*>(mrow + j);
    s.x = j + 0 < n ? s.x * scale + mk.x : -CUDART_INF_F;
    s.y = j + 1 < n ? s.y * scale + mk.y : -CUDART_INF_F;
    s.z = j + 2 < n ? s.z * scale + mk.z : -CUDART_INF_F;
    s.w = j + 3 < n ? s.w * scale + mk.w : -CUDART_INF_F;
    *reinterpret_cast<float4*>(srow + j) = s;
    mx = fmaxf(mx, fmaxf(fmaxf(s.x, s.y), fmaxf(s.z, s.w)));
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane * 4; j < npad; j += 128) {
    float4 s = *reinterpret_cast<float4*>(srow + j);
    s.x = expf(s.x - mx);
    s.y = expf(s.y - mx);
    s.z = expf(s.z - mx);
    s.w = expf(s.w - mx);
    *reinterpret_cast<float4*>(srow + j) = s;
    sum += (s.x + s.y) + (s.z + s.w);
  }
  sum = warp_sum(sum);
  for (int j = lane * 4; j < npad; j += 128) {
    float4 s = *reinterpret_cast<float4*>(srow + j);
    *reinterpret_cast<float4*>(srow + j) = make_float4(s.x / sum, s.y / sum, s.z / sum, s.w / sum);
  }
}

// qkv [B * npad, 3D] bf16; mask [B, npad]; ctx [B * npad, D] bf16; pu, when
// given, [B, heads, npad, npad] bf16 receives the probabilities as used
// (after the keep mask), which the backward's dv product reads.
// Shared memory: BA_Q * (npad + 8) * 4 + BA_Q * (npad + 16) * 2 + BA_SCRATCH bytes.
template <int Dummy = 0>
__global__ void __launch_bounds__(BA_THREADS)
bert_attn_fwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask, Dropout drop,
                     bf16* __restrict__ ctx, bf16* __restrict__ pu, int n, int npad, int D,
                     int heads, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) char smem[];
  const int lds = npad + 8, ldp = npad + 16;
  float* S = reinterpret_cast<float*>(smem);
  bf16* P = reinterpret_cast<bf16*>(smem + (size_t)BA_Q * lds * 4);
  const int q0 = blockIdx.x * BA_Q, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld3 = 3 * D;
  const bf16* base = qkv + (int64_t)b * npad * ld3 + h * BERT_DH;
  bert_scores(base + (int64_t)q0 * ld3, base + D, ld3, npad, S, lds);
  __syncthreads();

  const int seed = drop.thresh_attn ? drop.seeds[0] : 0;
  for (int r = warp; r < BA_Q; r += BA_THREADS / 32) {
    float* srow = S + r * lds;
    bert_softmax_row(srow, mask + (int64_t)b * npad, n, npad, scale);
    const int i = q0 + r;
    for (int j = lane * 4; j < npad; j += 128) {
      const float4 p = *reinterpret_cast<const float4*>(srow + j);
      const float4 k = keep4(seed, 0u, b, h, (unsigned)(i * n + j), drop.thresh_attn,
                             drop.scale_attn);
      const uint2 packed = pack_bf16x4(p.x * k.x, p.y * k.y, p.z * k.z, p.w * k.w);
      *reinterpret_cast<uint2*>(P + r * ldp + j) = packed;
      if (pu != nullptr)
        *reinterpret_cast<uint2*>(pu + (((int64_t)b * heads + h) * npad + i) * npad + j) = packed;
    }
  }
  __syncthreads();

  // ctx tile [32, 64] = P [32, npad] @ V [npad, 64]: one 16 x 16 tile a warp
  const int rt = warp >> 2, ct = warp & 3;
  const bf16* V = base + 2 * D;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  for (int kk = 0; kk < npad / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
    wmma::load_matrix_sync(fp, P + rt * 16 * ldp + kk * 16, ldp);
    wmma::load_matrix_sync(fv, V + (int64_t)kk * 16 * ld3 + ct * 16, ld3);
    wmma::mma_sync(acc, fp, fv, acc);
  }
  float* scratch = reinterpret_cast<float*>(smem + (size_t)BA_Q * lds * 4 + (size_t)BA_Q * ldp * 2)
                   + warp * 256;
  wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int row = lane >> 1, col = (lane & 1) * 8;
  const float* src = scratch + row * 16 + col;
  uint4 out;
  const uint2 lo = pack_bf16x4(src[0], src[1], src[2], src[3]);
  const uint2 hi = pack_bf16x4(src[4], src[5], src[6], src[7]);
  out.x = lo.x;
  out.y = lo.y;
  out.z = hi.x;
  out.w = hi.y;
  *reinterpret_cast<uint4*>(ctx + ((int64_t)b * npad + q0 + rt * 16 + row) * D + h * BERT_DH +
                            ct * 16 + col) = out;
}

static inline size_t bert_attn_fwd_smem(int npad) {
  return (size_t)BA_Q * (npad + 8) * 4 + (size_t)BA_Q * (npad + 16) * 2 + BA_SCRATCH;
}

// ---- LayerNorm ---------------------------------------------------------------

// y = LN(r) gamma + beta per row of D, one warp a row, in the one-pass form
// of pallas_bert_layer._ln_fwd; y goes out in fp32 (yf), bf16 (yb) or both,
// and (mean, rstd) to stats.
template <int Dummy = 0>
__global__ void __launch_bounds__(256)
bert_ln_fwd_kernel(const float* __restrict__ r, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ yf, bf16* __restrict__ yb,
                   float2* __restrict__ stats, int M, int D, float eps) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (m >= M) return;
  const float* row = r + (int64_t)m * D;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = row[c];
    s += v;
    s2 += v * v;
  }
  const float mean = warp_sum(s) / (float)D;
  const float var = warp_sum(s2) / (float)D - mean * mean;
  const float rstd = rsqrtf(fmaxf(var, 0.f) + eps);
  if (lane == 0) stats[m] = make_float2(mean, rstd);
  for (int c = lane; c < D; c += 32) {
    const float y = (row[c] - mean) * rstd * gamma[c] + beta[c];
    if (yf != nullptr) yf[(int64_t)m * D + c] = y;
    if (yb != nullptr) yb[(int64_t)m * D + c] = __float2bfloat16(y);
  }
}

// ---- one layer, forward ------------------------------------------------------

struct BertWeights {
  const bf16* wqkv;     // [3D, D]
  const float* bqkv;
  const bf16* wo;       // [D, D]
  const float *bo, *g1, *be1;
  const bf16* w1;       // [F, D]
  const float* b1;
  const bf16* w2;       // [D, F]
  const float *b2, *g2, *be2;
};

// What the forward leaves behind for the recompute backward.
struct BertWork {
  bf16* qkv;            // [M, 3D]
  bf16* pu;             // [B, heads, npad, npad] or null
  bf16* ctx;            // [M, D]
  float* r1;            // [M, D] pre-LN1
  float2* stats1;       // [M]
  float* yf;            // [M, D] LN1 output
  bf16* yb;
  float* h1;            // [M, F] pre-GELU
  bf16* g;              // [M, F]
  float* r2;            // [M, D] pre-LN2
  float2* stats2;
};

static int bert_forward_chain(const bf16* x, const float* mask, const BertWeights& w,
                              const BertWork& ws, bf16* out, const Dropout& drop, int B, int n,
                              int npad, int D, int F, int heads, float eps, float scale,
                              cudaStream_t st) {
  const int M = B * npad;
  const size_t smem = bert_attn_fwd_smem(npad);
  if (npad % 32 || npad > BERT_MAX_NPAD || D != heads * BERT_DH || F % 8)
    return (int)cudaErrorInvalidValue;
  launch_bert_gemm(x, D, w.wqkv, D, M, 3 * D, D, EpiBiasBf16{w.bqkv, ws.qkv, 3 * D}, nullptr, st);
  cudaFuncSetAttribute(bert_attn_fwd_kernel<>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  bert_attn_fwd_kernel<><<<dim3(npad / BA_Q, heads, B), BA_THREADS, smem, st>>>(
      ws.qkv, mask, drop, ws.ctx, ws.pu, n, npad, D, heads, scale);
  launch_bert_gemm(ws.ctx, D, w.wo, D, M, D, D,
                   EpiHidden{w.bo, x, nullptr, ws.r1, D, n, npad, drop.seeds, 1u,
                             drop.thresh_hidden, drop.scale_hidden},
                   nullptr, st);
  const int ln_blocks = (M + 7) / 8;
  bert_ln_fwd_kernel<><<<ln_blocks, 256, 0, st>>>(ws.r1, w.g1, w.be1, ws.yf, ws.yb, ws.stats1, M,
                                                  D, eps);
  launch_bert_gemm(ws.yb, D, w.w1, D, M, F, D, EpiGelu{w.b1, ws.h1, ws.g, F}, nullptr, st);
  launch_bert_gemm(ws.g, F, w.w2, F, M, D, F,
                   EpiHidden{w.b2, nullptr, ws.yf, ws.r2, D, n, npad, drop.seeds, 2u,
                             drop.thresh_hidden, drop.scale_hidden},
                   nullptr, st);
  bert_ln_fwd_kernel<><<<ln_blocks, 256, 0, st>>>(ws.r2, w.g2, w.be2, nullptr, out, ws.stats2, M,
                                                  D, eps);
  return (int)cudaGetLastError();
}

}  // namespace ctc
