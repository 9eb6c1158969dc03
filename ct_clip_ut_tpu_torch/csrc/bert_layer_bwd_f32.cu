// One BERT encoder layer, backward in fp32: the port of
// ct_clip_ut_tpu/ops/pallas_bert_layer.py:_bwd_impl (`_kernel_bwd`) at fp32,
// where its rounding points are identities: the fp32 train step's
// 512-token reports (TrainConfig(compute_dtype="float32")).
//
// The TPU kernel saves nothing between forward and backward and recomputes
// the forward. Here the train step's forward keeps its state (KEPT: the
// planes of x, the weights, qkv, ctx, y and g; fp32 r1, y, r2 and h1; each
// attention row's (max, 1 / sum) and the attention keep bits; ~80 MB a
// layer at B = 2, n = 512), and the backward starts at LN2's backward; a
// call with nothing kept first runs the fp32 forward chain again
// (bert_f32.cuh) with the same launches and flags, which gives the same
// bits. Then the steps of bert_layer_bwd.cu:
//   LN2 backward -> do2 = dr2 keep2 -> dW2 = do2^T g, db2,
//   dh1 = (do2 W2) gelu'(h1) -> dW1 = dh1^T y, db1, dy = dr2 + dh1 W1,
//   LN1 backward -> do1 = dr1 keep1 -> dWo = do1^T ctx, dbo, dctx = do1 Wo,
//   per head: dp = (dctx v^T) keep, dv = p_used^T dctx,
//   ds = p (dp - rowsum(dp p)) / sqrt(dh) with p the pre-dropout
//   probabilities, dq = ds k, dk = ds^T q,
//   dWqkv = dqkv^T x, dbqkv, dx = dr1 + dqkv Wqkv,
// every product three bf16 products of hi / lo planes with fp32 sums, every
// other value fp32. Launches (after the forward's, where it is rerun):
//   ln_drop_bwd_kernel     dr2 = LN2'(dout) fp32 and do2 = dr2 keep2 as hi /
//                          lo planes; the block's partial sums of dgamma2,
//                          dbeta2 and db2 (no atomics); 8 rows a block (one
//                          a warp): 128 blocks at 1,024 rows
//   split4_32_kernel       dh1 = (do2 W2) gelu'(h1) as planes (W2's planes
//                          read MN-major as stored; GeluBwdSplitEpi with
//                          db1's 16-row partial sums); every backward
//                          product stages a K slice's four planes once
//                          (split_sm90.cuh: 32-deep slices at two blocks
//                          an SM here, 64-row tiles for the width-768 ones
//                          below)
//   split4_64_kernel       dy = dr2 + dh1 W1 (fp32, in place of dr2)
//   ln_drop_bwd_kernel     dr1 = LN1'(dy), do1 = dr1 keep1 as planes; dgamma1,
//                          dbeta1, dbo partials
//   split4_64_kernel       dctx = do1 Wo as planes (SplitOutEpi)
//   dq_f32_kernel<true>    each row's and head's D = c + sum_j p_ij (u_ij -
//                          c) / sum_j p_ij, u = keep dP, c the row's dP at
//                          key 0 as a kept key gives it ([CLS] is always a
//                          real key), from the same split scores and dP =
//                          dctx V^T as the query and key passes form
//                          (below): a D from another product (dctx . ctx
//                          over ctx's planes, the first design) lost the
//                          gradients whose terms cancel in dP - D, ~2^-16
//                          of those terms, and a third plane on dP alone did
//                          not bring them back; summed unshifted in key
//                          order over the forward's 1 / sum (the second
//                          design), the rounding of D over close tokens
//                          still reached the query / key weight gradients
//                          (F12, as F11 in attn_bwd_wg.cuh)
//   dq_f32_kernel<false>   per (64 queries, head, sequence): the split scores
//                          and dP = dctx V^T over the live 64-key chunks (K,
//                          V planes staged by cp.async, double-buffered), p
//                          from the saved (max, 1 / sum), the keep bits, ds,
//                          dq += ds K (split) -> dq planes and 16-row
//                          partial sums
//   dkv_f32_kernel         per (64 keys, head, sequence): S^T = K Q^T and
//                          dP^T = V dctx^T over 64-query chunks (Q, dctx
//                          planes, each query's statistics and keep words
//                          staged), dv += p_used^T dctx, dk += ds^T q (split);
//                          a chunk of keys the mask removes entirely writes
//                          zeros
//   wgrad4_kernel          dW2, dW1, dWo, dWqkv in one launch, each token
//                          slice's four planes staged once (SplitQuadPlan,
//                          144 + 144 + 36 + 108 tiles)
//   split4_64_kernel       dx = dr1 + dqkv Wqkv (fp32)
//   colsum_kernel x 8      dbqkv, db1, dgamma1, dbeta1, dbo, dgamma2, dbeta2,
//                          db2 from the partial rows, in order
// Every sum runs in a fixed order without atomics: two calls give the same
// bits. The row term, the query pass and the key pass each form the split
// S and dP: a walk fewer needs ds kept between passes (the key pass's ds
// through memory into a dq product), not built here.
//
// What bounds it on the H100: tensor-core operations. The backward's
// products, 4 B n D (3D + D + 2F) + 8 B heads n^2 dh (48.3 GFLOP at B = 2,
// n = 512, D = 768, F = 3072, every key), as three bf16 products each: 145
// GFLOP, 0.147 ms at the bf16 peak (and a rerun forward's 0.049 ms more).
// What the design loses most to: the key pass holds K and V hi / lo
// fragments and the dk and dv accumulators in registers (128 of them a
// thread before any temporary) with four warps a block; the three passes
// form the split S and dP three times; 192 blocks of four warps a pass at n
// = 512 fill the SMs' warp slots thinly (the query and key passes in one
// launch, 384 blocks, ran slower on the H100: the key pass's 247 registers
// then held every block to two an SM, PERF.md); the weight gradients' 432
// tiles take four rounds of the SMs for 3.3 rounds of work.
#include "attn_bwd_f32.cuh"
#include "bert_f32.cuh"

namespace ctc {
namespace bert {

using sm90::MapsN;
using sm90::WgradTile;

// ---- epilogues of the backward products ---------------------------------------

// dh1 = acc gelu'(h1) as hi / lo planes [M, F], and the fp32 column sums of
// the warp's 16 rows to part [ceil(M / 16), F] (db1's partial rows).
struct GeluBwdSplitEpi {
  const float* h1;
  bf16* hi;
  bf16* lo;
  float* part;
  int M, F, keep_lo;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
    auto gp = [](float x) {
      return bh::gelu_cdf(x) + x * 0.3989422804014327f * expf(-0.5f * x * x);
    };
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = nt * BN + 8 * j + 2 * t;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row + g + 8 * h;
        if (m >= M || c >= F) continue;
        const int64_t off = (int64_t)m * F + c;
        const float2 hv = *reinterpret_cast<const float2*>(h1 + off);
        const float d0 = acc[4 * j + 2 * h] * gp(hv.x), d1 = acc[4 * j + 2 * h + 1] * gp(hv.y);
        __nv_bfloat162 h2, l2;
        split2(d0, d1, keep_lo, h2, l2);
        *reinterpret_cast<__nv_bfloat162*>(hi + off) = h2;
        *reinterpret_cast<__nv_bfloat162*>(lo + off) = l2;
        s0 += d0;
        s1 += d1;
      }
      s0 = bh::col_sum16(s0);
      s1 = bh::col_sum16(s1);
      if (g == 0 && c < F && row < M)
        *reinterpret_cast<float2*>(part + (int64_t)(row / 16) * F + c) = make_float2(s0, s1);
    }
  }
};

// ---- the LayerNorm backward with a hidden dropout site --------------------------

constexpr int LND_ROWS = 8;    // rows a block (one a warp): 128 blocks at 1,024 rows

// dr = the backward of y = LN(r) gamma + beta against dout, all fp32 [M, D]
// (D a multiple of 4), the moments recomputed from r in the one-pass form of
// ln_split_kernel; do = dr keep (site `site` of the hidden outputs over the
// [n, D] slab of the row's sequence) as hi / lo planes. One warp a row, a
// block LND_ROWS rows; lane l owns columns 4 l + 128 k, and its warp's sums
// of dout xhat (dgamma), dout (dbeta) and do (the bias before the site) per
// column go to shared memory [8][3 D] (each (warp, column) one lane's), then
// in warp order to part [gridDim.x][3 D].
template <int Dummy = 0>
__global__ void __launch_bounds__(256)
ln_drop_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ r,
                   const float* __restrict__ gamma, Dropout drop, unsigned site, int n,
                   float* __restrict__ dr, bf16* __restrict__ do_hi, bf16* __restrict__ do_lo,
                   float* __restrict__ part, int M, int D, float eps, int keep_lo) {
  extern __shared__ __align__(16) float red[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned thresh = drop.thresh_hidden;
  const int seed = thresh ? drop.seeds[site] : 0;
  for (int c = threadIdx.x; c < 24 * D; c += blockDim.x) red[c] = 0.f;
  __syncthreads();
  for (int i = 0; i < LND_ROWS / 8; ++i) {
    const int m = (blockIdx.x * (LND_ROWS / 8) + i) * 8 + warp;
    if (m >= M) break;
    const int64_t base = (int64_t)m * D;
    float s = 0.f, s2 = 0.f;
    for (int c = 4 * lane; c < D; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(r + base + c);
      s += (v.x + v.y) + (v.z + v.w);
      s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
    const float mean = sm90::warp_sum(s) / (float)D;
    const float var = sm90::warp_sum(s2) / (float)D - mean * mean;
    const float rstd = rsqrtf(fmaxf(var, 0.f) + eps);
    float a1 = 0.f, a2 = 0.f;
    for (int c = 4 * lane; c < D; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(r + base + c);
      const float4 d = *reinterpret_cast<const float4*>(dout + base + c);
      const float4 gm = *reinterpret_cast<const float4*>(gamma + c);
      const float x0 = (v.x - mean) * rstd, x1 = (v.y - mean) * rstd;
      const float x2 = (v.z - mean) * rstd, x3 = (v.w - mean) * rstd;
      const float e0 = d.x * gm.x, e1 = d.y * gm.y, e2 = d.z * gm.z, e3 = d.w * gm.w;
      a1 += (e0 + e1) + (e2 + e3);
      a2 += (e0 * x0 + e1 * x1) + (e2 * x2 + e3 * x3);
      float* rg = red + warp * 3 * D + c;
      rg[0] += d.x * x0;
      rg[1] += d.y * x1;
      rg[2] += d.z * x2;
      rg[3] += d.w * x3;
      rg[D] += d.x;
      rg[D + 1] += d.y;
      rg[D + 2] += d.z;
      rg[D + 3] += d.w;
    }
    a1 = sm90::warp_sum(a1) / (float)D;
    a2 = sm90::warp_sum(a2) / (float)D;
    const unsigned seq = m / n, row = m % n;
    for (int c = 4 * lane; c < D; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(r + base + c);
      const float4 d = *reinterpret_cast<const float4*>(dout + base + c);
      const float4 gm = *reinterpret_cast<const float4*>(gamma + c);
      const float4 o = make_float4((d.x * gm.x - a1 - (v.x - mean) * rstd * a2) * rstd,
                                   (d.y * gm.y - a1 - (v.y - mean) * rstd * a2) * rstd,
                                   (d.z * gm.z - a1 - (v.z - mean) * rstd * a2) * rstd,
                                   (d.w * gm.w - a1 - (v.w - mean) * rstd * a2) * rstd);
      *reinterpret_cast<float4*>(dr + base + c) = o;
      const float4 k = bh::keep4(seed, site, seq, 0u, row * D + c, thresh, drop.scale_hidden);
      const float4 dk = make_float4(o.x * k.x, o.y * k.y, o.z * k.z, o.w * k.w);
      sm90::store_split4(dk, keep_lo, do_hi, do_lo, base + c);
      float* rg = red + warp * 3 * D + 2 * D + c;
      rg[0] += dk.x;
      rg[1] += dk.y;
      rg[2] += dk.z;
      rg[3] += dk.w;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 3 * D; c += blockDim.x) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) sum += red[w * 3 * D + c];
    part[(int64_t)blockIdx.x * 3 * D + c] = sum;
  }
}

inline int ln_drop_parts(int M) { return (M + LND_ROWS - 1) / LND_ROWS; }

template <int Dummy = 0>
int launch_ln_drop_bwd(const float* dout, const float* r, const float* gamma, const Dropout& drop,
                       unsigned site, int n, float* dr, bf16* do_planes, float* part, int M, int D,
                       float eps, int keep_lo, cudaStream_t st) {
  const int smem = 24 * D * (int)sizeof(float);
  cudaFuncSetAttribute(ln_drop_bwd_kernel<>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ln_drop_bwd_kernel<><<<ln_drop_parts(M), 256, smem, st>>>(
      dout, r, gamma, drop, site, n, dr, do_planes, do_planes + (int64_t)M * D, part, M, D, eps,
      keep_lo);
  return (int)cudaGetLastError();
}

// ---- the attention passes -------------------------------------------------------

// The 16-row partial sums of a pass's gradient rows: rows a, b of column
// pair col (values v[0..1] of row a, v[2..3] of row b, the rows past the
// sequence left out), summed over the warp's 16 rows into prow[col].
__device__ __forceinline__ void col_partial(const float (&v)[4], bool va, bool vb, float* prow,
                                            int col, int g) {
  const float s0 = bh::col_sum16((va ? v[0] : 0.f) + (vb ? v[2] : 0.f));
  const float s1 = bh::col_sum16((va ? v[1] : 0.f) + (vb ? v[3] : 0.f));
  if (g == 0) *reinterpret_cast<float2*>(prow + col) = make_float2(s0, s1);
}

// Whether a sequence's mask row keeps any key (the warp's answer).
__device__ __forceinline__ bool has_real(const float* mrow, int n, int lane) {
  bool any_real = false;
  for (int k = lane; k < n; k += 32) any_real |= mrow[k] > REAL;
  return __any_sync(0xffffffffu, any_real);
}

// The first key chunk from c on that holds a key the mask keeps, or nch: a
// sequence with a real key (any_real) skips the chunks its mask removes
// entirely, where p is exactly 0 (the forward core skips them too and
// writes no keep bits there). Every warp reaches the same answer from the
// same mask row.
__device__ __forceinline__ int next_live(const float* mrow, int n, int nch, int c, int lane,
                                         bool any_real) {
  if (!any_real) return c;
  for (; c < nch; ++c) {
    const int k0 = c * KC + lane, k1 = k0 + 32;
    const bool dead = (k0 >= n || mrow[k0] < MASKED) && (k1 >= n || mrow[k1] < MASKED);
    if (!__all_sync(0xffffffffu, dead)) break;
  }
  return c;
}

// The query pass. qkv and dctx as hi / lo planes ([2][B n][3D], [2][B n][D]),
// rowstat [B, heads, n] (max, 1 / sum, D, -), keep as attn_kernel<true, true>
// wrote it. One block per (64 query rows, head h, sequence b); the live key
// chunks' K and V planes staged by cp.async, double-buffered (ATTN_SMEM).
// dq goes to dqkv's planes [2][B n][3D] at columns h 64 ..., and the fp32
// sums of each warp's rows to part [B ceil(n / 16)][3D]. ROW_TERM: the same
// walk without dS's product, each row's D = c + sum_j p_ij (u_ij - c) / sum_j
// p_ij with u = keep dp and c = scale_attn dp at the first key walked (key 0,
// [CLS], where the mask keeps one: the quad's first lane holds it), both sums
// over the quad's columns in key order, then the quad, into rowstat's .z.
// Over close tokens u - c is small where u itself is not, and the walk's own
// sum of p is the one its summands carry (F12).
template <bool ROW_TERM>
__global__ void __launch_bounds__(WARPS * 32)
dq_f32_kernel(const bf16* __restrict__ qkv_hi, const bf16* __restrict__ qkv_lo,
              const bf16* __restrict__ dctx_hi, const bf16* __restrict__ dctx_lo,
              const float* __restrict__ mask, float4* __restrict__ rowstat,
              const unsigned* __restrict__ keep, Dropout drop, bf16* __restrict__ dq_hi,
              bf16* __restrict__ dq_lo, float* __restrict__ part, int n, int D, float scale,
              int keep_lo) {
  extern __shared__ __align__(128) char smem[];
  const int b = blockIdx.z, h = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, ld = 3 * D, nch = (n + KC - 1) / KC;
  const int words = keep_words(n);
  const int64_t seq0 = (int64_t)b * n, bhd = (int64_t)b * gridDim.y + h;
  const float* mrow = mask + seq0;
  const uint32_t sbase = sm90::smem_u32(smem);
  const bool drop_on = drop.thresh_attn != 0u;
  auto stage = [&](int c, int buf) {
    const uint32_t dst = sbase + buf * STAGE_B;
    for (int i = threadIdx.x; i < 4 * KC * 8; i += blockDim.x) {
      const int p = i / (KC * 8), j = (i >> 3) % KC, ch = i & 7, key = c * KC + j;
      const bf16* src = ((p & 1) ? qkv_lo : qkv_hi) + (seq0 + min(key, n - 1)) * ld +
                        (p < 2 ? D : 2 * D) + h * DH + ch * 8;
      cp_async16(dst + p * PLANE_B + swz(j, ch), src, key < n ? 16 : 0);
    }
  };
  const int q0 = blockIdx.x * QT + warp * 16, ra = q0 + g, rb = ra + 8;
  const bool live = q0 < n, va = ra < n, vb = rb < n;
  uint32_t qh[4][4], ql[4][4], dh[4][4], dl[4][4];
  load_a64(qh, qkv_hi + seq0 * ld + h * DH, ld, q0, n, lane);
  load_a64(ql, qkv_lo + seq0 * ld + h * DH, ld, q0, n, lane);
  load_a64(dh, dctx_hi + seq0 * D + h * DH, D, q0, n, lane);
  load_a64(dl, dctx_lo + seq0 * D + h * DH, D, q0, n, lane);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 sa = va ? rowstat[bhd * n + ra] : zero, sb = vb ? rowstat[bhd * n + rb] : zero;
  float acc[8][4], d_row[2] = {0.f, 0.f}, p_row[2] = {0.f, 0.f}, shift[2] = {0.f, 0.f};
  bool first = true;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const bool any_real = has_real(mrow, n, lane);
  int c = next_live(mrow, n, nch, 0, lane, any_real), buf = 0;
  if (c < nch) stage(c, 0);
  for (; c < nch; buf ^= 1) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // chunk c is in `buf`; every warp is done with the other buffer
    const int cur = c;
    c = next_live(mrow, n, nch, c + 1, lane, any_real);
    if (c < nch) stage(c, buf ^ 1);
    if (!live) continue;
    const uint32_t kh = sbase + buf * STAGE_B, kl = kh + PLANE_B, vh = kl + PLANE_B,
                   vl = vh + PLANE_B;
    unsigned wa[2] = {~0u, ~0u}, wb[2] = {~0u, ~0u};
    if (drop_on) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        wa[w] = va ? keep[(bhd * n + ra) * words + 2 * cur + w] : 0u;
        wb[w] = vb ? keep[(bhd * n + rb) * words + 2 * cur + w] : 0u;
      }
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jt = 2 * ks + u, key = cur * KC + 8 * jt + 2 * t;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f}, ds[4];
        split_rows8(s, qh, ql, kh, kl, 8 * jt, lane);
        split_rows8(dp, dh, dl, vh, vl, 8 * jt, lane);
        if (ROW_TERM && first) {   // the row's dP at the first key walked, kept
          first = false;
          const float ka = drop_on ? drop.scale_attn : 1.f;
          shift[0] = __shfl_sync(0xffffffffu, dp[0], lane & ~3) * ka;
          shift[1] = __shfl_sync(0xffffffffu, dp[2], lane & ~3) * ka;
        }
        const int bit = 8 * (jt & 3) + 2 * t;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = key + (i & 1);
          const float4& st = i < 2 ? sa : sb;
          const float sv = kk < n ? s[i] * scale + mrow[kk] : -CUDART_INF_F;
          const float p = expf(sv - st.x) * st.y;
          const unsigned wrd = i < 2 ? wa[jt >> 2] : wb[jt >> 2];
          const float kf = drop_on ? ((wrd >> (bit + (i & 1))) & 1u ? drop.scale_attn : 0.f) : 1.f;
          if (ROW_TERM) {
            d_row[i >> 1] += p * (dp[i] * kf - shift[i >> 1]);
            p_row[i >> 1] += p;
          } else {
            ds[i] = p * (dp[i] * kf - st.z) * scale;
          }
        }
        if (!ROW_TERM)
          tc::split_frag(ds, keep_lo, ah[2 * u], ah[2 * u + 1], al[2 * u], al[2 * u + 1]);
      }
      if (!ROW_TERM) split_cols64(acc, ah, al, kh, kl, 16 * ks, lane);
    }
  }
  if (!live) return;
  if (ROW_TERM) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      d_row[i] += __shfl_xor_sync(0xffffffffu, d_row[i], 1);
      d_row[i] += __shfl_xor_sync(0xffffffffu, d_row[i], 2);
      p_row[i] += __shfl_xor_sync(0xffffffffu, p_row[i], 1);
      p_row[i] += __shfl_xor_sync(0xffffffffu, p_row[i], 2);
    }
    if (t == 0) {
      if (va) rowstat[bhd * n + ra].z = shift[0] + d_row[0] / p_row[0];
      if (vb) rowstat[bhd * n + rb].z = shift[1] + d_row[1] / p_row[1];
    }
    return;
  }
  const int64_t ld3 = 3 * (int64_t)D;
  float* prow = part + ((int64_t)b * ((n + 15) / 16) + q0 / 16) * ld3;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = h * DH + 8 * dt + 2 * t;
    __nv_bfloat162 hv, lv;
    if (va) {
      split2(acc[dt][0], acc[dt][1], keep_lo, hv, lv);
      *reinterpret_cast<__nv_bfloat162*>(dq_hi + (seq0 + ra) * ld3 + col) = hv;
      *reinterpret_cast<__nv_bfloat162*>(dq_lo + (seq0 + ra) * ld3 + col) = lv;
    }
    if (vb) {
      split2(acc[dt][2], acc[dt][3], keep_lo, hv, lv);
      *reinterpret_cast<__nv_bfloat162*>(dq_hi + (seq0 + rb) * ld3 + col) = hv;
      *reinterpret_cast<__nv_bfloat162*>(dq_lo + (seq0 + rb) * ld3 + col) = lv;
    }
    col_partial(acc[dt], va, vb, prow, col, g);
  }
}

// A query chunk of the key pass: its q and dctx hi / lo planes (four of 64
// rows of 128 B), each query's rowstat (16 B), the two keep words of the
// block's 64 keys per query (8 B); double-buffered.
constexpr int KV_STAGE = 4 * PLANE_B + KC * 16 + KC * 8;
constexpr int KV_SMEM = 2 * KV_STAGE;

// The key pass: one block per (64 keys, head h, sequence b), warp w taking
// keys 16 w ... as the A operand of S^T = K Q^T and dP^T = V dctx^T over the
// query chunks in order. Per 16 queries: p^T from each query's (max, 1 /
// sum), the keep bits, p_used = p keep, ds as in the query pass; dv +=
// p_used^T dctx, dk += ds^T q, each split. dk and dv go to dqkv's planes at
// columns D + h 64 ... and 2D + h 64 ..., their 16-row sums to part.
__global__ void __launch_bounds__(WARPS * 32)
dkv_f32_kernel(const bf16* __restrict__ qkv_hi, const bf16* __restrict__ qkv_lo,
               const bf16* __restrict__ dctx_hi, const bf16* __restrict__ dctx_lo,
               const float* __restrict__ mask, const float4* __restrict__ rowstat,
               const unsigned* __restrict__ keep, Dropout drop, bf16* __restrict__ dkv_hi,
               bf16* __restrict__ dkv_lo, float* __restrict__ part, int n, int D, float scale,
               int keep_lo) {
  extern __shared__ __align__(128) char smem[];
  const int b = blockIdx.z, h = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, ld = 3 * D, nch = (n + KC - 1) / KC;
  const int words = keep_words(n);
  const int64_t seq0 = (int64_t)b * n, bhd = (int64_t)b * gridDim.y + h;
  const int k0 = blockIdx.x * KC + warp * 16, key_a = k0 + g, key_b = key_a + 8;
  const int kw0 = 2 * blockIdx.x;       // the keep words of the block's 64-key chunk
  const bool live = k0 < n, va = key_a < n, vb = key_b < n;
  const bool drop_on = drop.thresh_attn != 0u;
  const uint32_t sbase = sm90::smem_u32(smem);
  auto stage = [&](int c, int buf) {
    const int off = buf * KV_STAGE;
    for (int i = threadIdx.x; i < 4 * KC * 8; i += blockDim.x) {
      const int p = i / (KC * 8), j = (i >> 3) % KC, ch = i & 7, q = c * KC + j;
      const int64_t row = seq0 + min(q, n - 1);
      const bf16* src = p < 2 ? ((p & 1) ? qkv_lo : qkv_hi) + row * ld + h * DH + ch * 8
                              : ((p & 1) ? dctx_lo : dctx_hi) + row * D + h * DH + ch * 8;
      cp_async16(sbase + off + p * PLANE_B + swz(j, ch), src, q < n ? 16 : 0);
    }
    for (int i = threadIdx.x; i < KC; i += blockDim.x) {
      const int q = c * KC + i;
      cp_async16(sbase + off + 4 * PLANE_B + 16 * i, rowstat + bhd * n + min(q, n - 1),
                 q < n ? 16 : 0);
    }
    if (drop_on) {
      unsigned* kw = reinterpret_cast<unsigned*>(smem + off + 4 * PLANE_B + KC * 16);
      for (int i = threadIdx.x; i < 2 * KC; i += blockDim.x) {
        const int q = c * KC + (i >> 1);
        kw[i] = q < n ? keep[(bhd * n + q) * words + kw0 + (i & 1)] : 0u;
      }
    }
  };
  // keys the mask removes entirely (in a sequence with a real key): p is 0,
  // so dk and dv are zeros, the bits a walk over the queries would give
  if (next_live(mask + seq0, n, nch, blockIdx.x, lane, has_real(mask + seq0, n, lane)) !=
      blockIdx.x) {
    if (!live) return;
    const int64_t ld3 = 3 * (int64_t)D;
    float* prow = part + ((int64_t)b * ((n + 15) / 16) + k0 / 16) * ld3;
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat162 z2 = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const int col = (1 + which) * D + h * DH + 8 * dt + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = r ? key_b : key_a;
          if (key < n) {
            *reinterpret_cast<__nv_bfloat162*>(dkv_hi + (seq0 + key) * ld3 + col) = z2;
            *reinterpret_cast<__nv_bfloat162*>(dkv_lo + (seq0 + key) * ld3 + col) = z2;
          }
        }
        col_partial(zero, va, vb, prow, col, g);
      }
    }
    return;
  }
  uint32_t kh[4][4], kl[4][4], vh[4][4], vl[4][4];
  load_a64(kh, qkv_hi + seq0 * ld + D + h * DH, ld, k0, n, lane);
  load_a64(kl, qkv_lo + seq0 * ld + D + h * DH, ld, k0, n, lane);
  load_a64(vh, qkv_hi + seq0 * ld + 2 * D + h * DH, ld, k0, n, lane);
  load_a64(vl, qkv_lo + seq0 * ld + 2 * D + h * DH, ld, k0, n, lane);
  const float mka = va ? mask[seq0 + key_a] : 0.f, mkb = vb ? mask[seq0 + key_b] : 0.f;
  const int kla = key_a % KC, klb = key_b % KC;   // within the chunk's two keep words
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  stage(0, 0);
  for (int c = 0; c < nch; ++c) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // chunk c is in its buffer; every warp is done with the other one
    if (c + 1 < nch) stage(c + 1, (c + 1) & 1);
    if (!live) continue;
    const int off = (c & 1) * KV_STAGE;
    const uint32_t qph = sbase + off, qpl = qph + PLANE_B, dph = qpl + PLANE_B,
                   dpl = dph + PLANE_B;
    const float4* stq = reinterpret_cast<const float4*>(smem + off + 4 * PLANE_B);
    const unsigned* kw = reinterpret_cast<const unsigned*>(smem + off + 4 * PLANE_B + KC * 16);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t pah[4], pal[4], sah[4], sal[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int qb = 16 * kt + 8 * u, qi = qb + 2 * t;
        float sv[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f}, pu[4], ds[4];
        split_rows8(sv, kh, kl, qph, qpl, qb, lane);
        split_rows8(dp, vh, vl, dph, dpl, qb, lane);
        const float4 s0 = stq[qi], s1 = stq[qi + 1];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool valid = i < 2 ? va : vb;
          const int kloc = i < 2 ? kla : klb;
          const float4& st = (i & 1) ? s1 : s0;
          const float x = valid ? sv[i] * scale + (i < 2 ? mka : mkb) : -CUDART_INF_F;
          const float p = expf(x - st.x) * st.y;
          float kfac = 1.f;
          if (drop_on)
            kfac = (kw[2 * (qi + (i & 1)) + (kloc >> 5)] >> (kloc & 31)) & 1u ? drop.scale_attn
                                                                              : 0.f;
          pu[i] = p * kfac;
          ds[i] = p * (dp[i] * kfac - st.z) * scale;
        }
        tc::split_frag(pu, keep_lo, pah[2 * u], pah[2 * u + 1], pal[2 * u], pal[2 * u + 1]);
        tc::split_frag(ds, keep_lo, sah[2 * u], sah[2 * u + 1], sal[2 * u], sal[2 * u + 1]);
      }
      split_cols64(dv, pah, pal, dph, dpl, 16 * kt, lane);
      split_cols64(dk, sah, sal, qph, qpl, 16 * kt, lane);
    }
  }
  if (!live) return;
  const int64_t ld3 = 3 * (int64_t)D;
  float* prow = part + ((int64_t)b * ((n + 15) / 16) + k0 / 16) * ld3;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float(&r)[4] = which ? dv[dt] : dk[dt];
      const int col = (1 + which) * D + h * DH + 8 * dt + 2 * t;
      __nv_bfloat162 hv, lv;
      if (va) {
        split2(r[0], r[1], keep_lo, hv, lv);
        *reinterpret_cast<__nv_bfloat162*>(dkv_hi + (seq0 + key_a) * ld3 + col) = hv;
        *reinterpret_cast<__nv_bfloat162*>(dkv_lo + (seq0 + key_a) * ld3 + col) = lv;
      }
      if (vb) {
        split2(r[2], r[3], keep_lo, hv, lv);
        *reinterpret_cast<__nv_bfloat162*>(dkv_hi + (seq0 + key_b) * ld3 + col) = hv;
        *reinterpret_cast<__nv_bfloat162*>(dkv_lo + (seq0 + key_b) * ld3 + col) = lv;
      }
      col_partial(r, va, vb, prow, col, g);
    }
  }
}

// ---- the weight gradients ------------------------------------------------------

// The layer's four fp32 weight gradients in one launch of wgrad_sm90.cuh's
// staged kernel (wgrad4_kernel: each token slice's four planes at once),
// C_i = A_i^T B_i [rows_i, cols_i] for i = 0 .. 3 (dW2, dW1, dWo, dWqkv:
// maps 4 i / 4 i + 1 A_i's hi / lo planes, 4 i + 2 / 4 i + 3 B_i's; output
// i), each row-major over 128 x 128 tiles, product i on tiles [first_i,
// first_{i+1}). One launch of 432 tiles at D = 768, F = 3,072 fills four
// rounds of 132 SMs, where two launches of 288 and 144 tiles took three
// and two.
struct SplitQuadPlan {
  int rows[4], col_tiles[4], first[4];
  __device__ WgradTile tile(int t) const {
    const int i = t >= first[3] ? 3 : t >= first[2] ? 2 : t >= first[1] ? 1 : 0;
    // selected, not indexed: a runtime index would put the arrays on the stack
    const int u = t - (i == 3 ? first[3] : i == 2 ? first[2] : i == 1 ? first[1] : 0);
    const int ct = i == 3 ? col_tiles[3] : i == 2 ? col_tiles[2] : i == 1 ? col_tiles[1]
                                                                           : col_tiles[0];
    const int r = i == 3 ? rows[3] : i == 2 ? rows[2] : i == 1 ? rows[1] : rows[0];
    const int i0 = (u / ct) * sm90::BM, j0 = (u % ct) * BN;
    return {4 * i, 4 * i + 2, i0, j0, i, i0, min(sm90::BM, r - i0)};
  }
};

// out[o] [rows, cols[o]] fp32 = the tile's sums (rows orow0 + r, r < nrows;
// columns below cols[o], even), four outputs
struct Wgrad4StoreEpi {
  float* out[4];
  int cols[4];
  __device__ void operator()(const float (&acc)[64], const WgradTile& tile, int r0,
                             int lane) const {
    const int g = lane >> 2, t = lane & 3, o = tile.out;
    float* base = o == 3 ? out[3] : o == 2 ? out[2] : o == 1 ? out[1] : out[0];
    const int nc = o == 3 ? cols[3] : o == 2 ? cols[2] : o == 1 ? cols[1] : cols[0];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r >= tile.nrows) continue;
      float* row = base + (int64_t)(tile.orow0 + r) * nc;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = tile.j0 + 8 * j + 2 * t;
        if (c < nc)
          *reinterpret_cast<float2*>(row + c) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
};

// dW_i [r_i, c_i] = A_i^T B_i over M tokens for four (A_i, B_i), each
// operand hi / lo planes [2][M][cols] bf16, the outputs fp32 written whole
// (c_i even).
inline int wgrad_quad_f32(const bf16* const (&a)[4], const bf16* const (&b)[4],
                          float* const (&w)[4], const int (&r)[4], const int (&c)[4], int M,
                          cudaStream_t st) {
  MapsN<16> maps{};
  int err = 0;
  SplitQuadPlan plan{};
  Wgrad4StoreEpi epi{};
  int tiles = 0;
  for (int i = 0; i < 4 && !err; ++i) {
    const bf16* const src[2] = {a[i], b[i]};
    const int cols[2] = {r[i], c[i]};
    for (int k = 0; k < 2 && !err; ++k) {
      err = sm90::map_mn(&maps.m[4 * i + 2 * k], src[k], M, cols[k], cols[k]);
      if (!err)
        err = sm90::map_mn(&maps.m[4 * i + 2 * k + 1], src[k] + (int64_t)M * cols[k], M, cols[k],
                           cols[k]);
    }
    plan.rows[i] = r[i];
    plan.col_tiles[i] = (c[i] + BN - 1) / BN;
    plan.first[i] = tiles;
    tiles += (r[i] + sm90::BM - 1) / sm90::BM * plan.col_tiles[i];
    epi.out[i] = w[i];
    epi.cols[i] = c[i];
  }
  if (err) return err;
  return sm90::launch_wgrad4_sm90(maps, plan, epi, tiles, M, st);
}

// A product with B a weight's planes [2][K][N] read as stored, each K slice's
// four planes staged once: 64-row tiles where 128-row ones are fewer than
// the SMs (the width-768 products at a train step's 1,024 rows), else
// 32-deep slices at two blocks an SM (dh1: 192 tiles).
template <class Epi>
inline int product_kn(const bf16* a, const bf16* b, int M, int N, int K, const Epi& epi,
                      cudaStream_t st) {
  const bf16 *a_lo = a + (int64_t)M * K, *b_lo = b + (int64_t)K * N;
  if (sm90::rows64(M, N))
    return sm90::split4_product64<true>(a, a_lo, K, b, b_lo, N, M, N, K, epi, st);
  return sm90::split4_product32<true>(a, a_lo, K, b, b_lo, N, M, N, K, epi, st);
}

}  // namespace bert
}  // namespace ctc

using namespace ctc::bert;

// The inputs of ctc_bert_layer (seeds as there), dout [B*n, D] fp32.
// Workspaces: the forward's planes x_s, wqkv_s, wo_s, w1_s, w2_s, qkv_s,
// ctx_s, y_s, h_s as ctc_bert_layer's; fp32 r1, y_ws, r2 [B*n, D] and h1
// [B*n, F]; rowstat [B, heads, n] float4; keep [B, heads, n, keep_words(n)]
// u32 (used only with attention dropout); fp32 dr2 (then dy) and dr1 [B*n,
// D]; hi / lo planes do2_s, do1_s, dctx_s [2][B*n][D], dh1_s [2][B*n][F],
// dqkv_s [2][B*n][3D]; partial rows part_ln2, part_ln1 [ceil(B n / 64)][3D],
// part_b1 [ceil(B n / 16)][F], part_qkv [B ceil(n / 16)][3D] fp32. Outputs,
// written whole: dx [B*n, D]; dwqkv [3D, D], dbqkv [3D], dwo [D, D], dbo,
// dg1, dbe1 [D], dw1 [F, D], db1 [F], dw2 [D, F], db2, dg2, dbe2 [D], all
// fp32. D = heads * 64, a multiple of 128; F a multiple of 8; n a multiple
// of 4. flags: ONE_PASS (every lo plane zeroed: the control), KEPT (the
// workspaces x_s ... keep already hold the state ctc_bert_layer kept with
// the same inputs and flags: the forward is not rerun). Every pointer 16-B
// aligned.
extern "C" int ctc_bert_layer_bwd_f32(
    const void* x, const void* mask, const void* seeds, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, const void* g1, const void* be1, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* g2, const void* be2,
    const void* dout, void* x_s, void* wqkv_s, void* wo_s, void* w1_s, void* w2_s, void* qkv_s,
    void* ctx_s, void* y_s, void* h_s, void* r1, void* y_ws, void* h1, void* r2, void* rowstat,
    void* keep, void* dr2, void* do2_s, void* dh1_s, void* dr1, void* do1_s, void* dctx_s,
    void* dqkv_s, void* part_ln2, void* part_ln1, void* part_b1, void* part_qkv, void* dx,
    void* dwqkv, void* dbqkv, void* dwo, void* dbo, void* dg1, void* dbe1, void* dw1, void* db1,
    void* dw2, void* db2, void* dg2, void* dbe2, int B, int n, int D, int F, int heads, int flags,
    float eps, float scale, unsigned thresh_attn, unsigned thresh_hidden, float scale_attn,
    float scale_hidden, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * n, keep_lo = !(flags & ONE_PASS);
  if (D % 128 || n % 4 || (thresh_attn && keep == nullptr)) return (int)cudaErrorInvalidValue;
  const void* const w[12] = {wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2};
  const F32Work ws{(bf16*)x_s,   (bf16*)wqkv_s, (bf16*)wo_s,    (bf16*)w1_s,    (bf16*)w2_s,
                   (bf16*)qkv_s, (bf16*)ctx_s,  (bf16*)y_s,     (bf16*)h_s,     (float*)r1,
                   (float*)y_ws, (float*)r2,    (float*)h1,     (float4*)rowstat,
                   (unsigned*)keep};
  const Dropout drop{(const int*)seeds, thresh_attn, thresh_hidden, scale_attn, scale_hidden};
  const float* xf = static_cast<const float*>(x);
  const float* maskf = static_cast<const float*>(mask);
  int err = 0;
  if (!(flags & KEPT))
    err = forward_chain_f32(xf, maskf, w, ws, nullptr, drop, B, n, D, F, heads, flags & ONE_PASS,
                            eps, scale, st);
  if (err) return err;

  const int64_t md = (int64_t)M * D;
  bf16 *do2 = (bf16*)do2_s, *do1 = (bf16*)do1_s, *dh1 = (bf16*)dh1_s, *dctx = (bf16*)dctx_s,
       *dqkv = (bf16*)dqkv_s;
  float *dr2f = (float*)dr2, *dr1f = (float*)dr1, *pln2 = (float*)part_ln2,
        *pln1 = (float*)part_ln1, *pb1 = (float*)part_b1, *pqkv = (float*)part_qkv;
  // LN2 -> the FF -> LN1
  err = launch_ln_drop_bwd(static_cast<const float*>(dout), ws.r2, (const float*)g2, drop, 2u, n,
                           dr2f, do2, pln2, M, D, eps, keep_lo, st);
  if (!err)
    err = product_kn(do2, ws.w2_s, M, F, D, GeluBwdSplitEpi{ws.h1, dh1, dh1 + (int64_t)M * F, pb1,
                                                            M, F, keep_lo},
                     st);
  if (!err)
    err = product_kn(dh1, ws.w1_s, M, D, F, ctc::sm90::F32OutEpi{dr2f, nullptr, dr2f, M, D}, st);
  if (!err)
    err = launch_ln_drop_bwd(static_cast<const float*>(dr2f), ws.r1, (const float*)g1, drop, 1u,
                             n, dr1f, do1, pln1, M, D, eps, keep_lo, st);
  // the attention out-projection and the core
  if (!err)
    err = product_kn(do1, ws.wo_s, M, D, D,
                     ctc::sm90::SplitOutEpi{dctx, dctx + md, M, D, D, keep_lo}, st);
  if (err) return err;
  const dim3 grid((n + KC - 1) / KC, heads, B);
  cudaFuncSetAttribute(dq_f32_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       ATTN_SMEM);
  cudaFuncSetAttribute(dq_f32_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       ATTN_SMEM);
  dq_f32_kernel<true><<<grid, WARPS * 32, ATTN_SMEM, st>>>(
      ws.qkv_s, ws.qkv_s + 3 * md, dctx, dctx + md, maskf, ws.rowstat, ws.keep, drop, nullptr,
      nullptr, nullptr, n, D, scale, keep_lo);
  dq_f32_kernel<false><<<grid, WARPS * 32, ATTN_SMEM, st>>>(
      ws.qkv_s, ws.qkv_s + 3 * md, dctx, dctx + md, maskf, ws.rowstat, ws.keep, drop, dqkv,
      dqkv + 3 * md, pqkv, n, D, scale, keep_lo);
  err = (int)cudaGetLastError();
  if (err) return err;
  cudaFuncSetAttribute(dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM);
  dkv_f32_kernel<<<grid, WARPS * 32, KV_SMEM, st>>>(ws.qkv_s, ws.qkv_s + 3 * md, dctx, dctx + md,
                                                    maskf, ws.rowstat, ws.keep, drop, dqkv,
                                                    dqkv + 3 * md, pqkv, n, D, scale, keep_lo);
  err = (int)cudaGetLastError();
  // dW2, dW1, dWo, dWqkv in one launch, then dx = dr1 + dqkv Wqkv
  if (!err)
    err = wgrad_quad_f32({do2, dh1, do1, dqkv}, {ws.h_s, ws.y_s, ws.ctx_s, ws.x_s},
                         {(float*)dw2, (float*)dw1, (float*)dwo, (float*)dwqkv}, {D, F, D, 3 * D},
                         {F, D, D, D}, M, st);
  if (!err)
    err = product_kn(dqkv, ws.wqkv_s, M, D, 3 * D,
                     ctc::sm90::F32OutEpi{(float*)dx, nullptr, dr1f, M, D}, st);
  if (err) return err;
  // the column sums, each in a fixed order
  const int lp = ln_drop_parts(M), ld3 = 3 * D;
  err = ctc::sm90::launch_colsum(pqkv, (float*)dbqkv, B * ((n + 15) / 16), ld3, ld3, 1.f, st);
  if (!err) err = ctc::sm90::launch_colsum(pb1, (float*)db1, (M + 15) / 16, F, F, 1.f, st);
  float* const sums[6] = {(float*)dg1, (float*)dbe1, (float*)dbo,
                          (float*)dg2, (float*)dbe2, (float*)db2};
  for (int i = 0; i < 6 && !err; ++i)
    err = ctc::sm90::launch_colsum((i < 3 ? pln1 : pln2) + (i % 3) * D, sums[i], lp, D, ld3, 1.f, st);
  return err;
}
