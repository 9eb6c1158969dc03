// The fp32 BERT layer's forward chain, shared by bert_layer.cu (the forward:
// deterministic for the zero-shot prompts, or in train mode with dropout)
// and bert_layer_bwd_f32.cu (its recompute backward): the port of
// ct_clip_ut_tpu/ops/pallas_bert_layer.py:_fwd_body at fp32, where its
// rounding points are identities.
//
//   qkv = x Wqkv^T + bqkv;  per head: p = softmax(q k^T / sqrt(dh) + mask);
//   ctx = (p keep0) v;  y = LN1((ctx Wo^T + bo) keep1 + x);
//   g = gelu_erf(y W1^T + b1);  out = LN2((g W2^T + b2) keep2 + y)
//
// Every product is three bf16 products of hi / lo planes with fp32 sums
// (split_sm90.cuh: a . b ~ a_hi b_hi + a_lo b_hi + a_hi b_lo, within ~2^-16
// of fp32). The dropout keep factors (0 or 1 / (1 - rate)) are the bf16
// chain's Philox4x32-10 bits (bert_bf16.cuh: keep_frag, in the mma / wgmma
// D fragment layout), so this chain, the bf16 chains and
// ops/bert_layer.py:philox_keep draw the same masks. A threshold of 0
// switches a site off, and then the deterministic chain's code runs (the
// core without its Philox branch, F32OutEpi for the hidden products): the
// zero-shot prompts keep their bits.
//
//   split_kernel x 5          x and the four weight matrices as hi / lo
//                             bf16 planes (per call)
//   split4 product            qkv = x Wqkv^T + bqkv as hi / lo planes
//                             (SplitEpi); every product stages a K slice's
//                             four planes once (split_sm90.cuh's
//                             split4_kernel, split4_32_kernel or
//                             split4_64_kernel by the product's tiles:
//                             `product` below)
//   attn_kernel               per (sequence, head, 64 queries), mma.sync
//                             split-bf16 scores and P.V with an online
//                             softmax in fp32 over 64-key chunks staged by
//                             cp.async; each exp(s - m) multiplied by its
//                             keep factor before it feeds P.V, the row sum
//                             taken undropped (ctx = sum p keep v / l, the
//                             TPU kernel's p keep after normalisation); key
//                             chunks the mask removes entirely skipped (the
//                             Philox counter is the absolute position: the
//                             same bits); with STATS each row's (max, 1 /
//                             sum) and the keep mask as bits for the backward
//   split4 product            r1 = (ctx Wo^T + bo) keep1 + x (HiddenF32Epi;
//                             F32OutEpi with the hidden sites off)
//   ln_split_kernel           y = LN1(r1) in fp32 and as hi / lo planes
//   split4 product            g = gelu(y W1^T + b1) as hi / lo planes (the
//                             pre-activation in fp32 too, for the backward)
//   split4 product            r2 = (g W2^T + b2) keep2 + y (the same)
//   ln_split_kernel           out = LN2(r2) (left out by the backward's
//                             rerun)
// Where the caller keeps the chain's state for the backward (the train
// step's forward under autograd), the workspaces hold what
// bert_layer_bwd_f32.cu reads: every plane, fp32 r1, y, r2 and h1, each
// attention row's (max, 1 / sum) and the keep bits; the backward then
// starts at LN2's backward instead of rerunning this chain. A rerun (the
// backward called with nothing kept) makes the same launches with the same
// flags, so the two give the same bits.
#pragma once

#include "bert_bf16.cuh"
#include "split_sm90.cuh"

namespace ctc {
namespace bert {

using bf16 = __nv_bfloat16;
using bh::Dropout;
using bh::keep_frag;
using sm90::as_u32;
using sm90::BN;
using sm90::split;
using sm90::split2;
using tc::cp_async16;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma16816;

constexpr int ONE_PASS = 1, NO_SKIP = 2, KEPT = 4;

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// ---- epilogues of the products (registers in the wgmma D layout) ------------

// planes hi / lo [M, N] of acc + bias (GELU: of gelu(acc + bias), and the
// pre-activation acc + bias to `pre` [M, N] fp32 where it is not null); N even
template <bool GELU>
struct SplitEpi {
  bf16* hi;
  bf16* lo;
  const float* bias;
  int M, N, keep_lo;
  float* pre;
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
        const float2 bv = *reinterpret_cast<const float2*>(bias + c);
        float y0 = acc[4 * j + 2 * h] + bv.x, y1 = acc[4 * j + 2 * h + 1] + bv.y;
        const int64_t off = (int64_t)m * N + c;
        if (GELU) {
          if (pre != nullptr) *reinterpret_cast<float2*>(pre + off) = make_float2(y0, y1);
          y0 = gelu_erf(y0);
          y1 = gelu_erf(y1);
        }
        __nv_bfloat162 hv, lv;
        split2(y0, y1, keep_lo, hv, lv);
        *reinterpret_cast<__nv_bfloat162*>(hi + off) = hv;
        *reinterpret_cast<__nv_bfloat162*>(lo + off) = lv;
      }
    }
  }
};

// out [M, N] fp32 = (acc + bias) keep + res: both hidden dropout sites, the
// keep mask of `site` over the [n, N] slab of the row's sequence (rows of
// n tokens, no padding), thresh > 0. (With the sites off the chain takes
// F32OutEpi, acc + bias + res: the deterministic layer's bits.) N even.
struct HiddenF32Epi {
  float* out;
  const float* bias;
  const float* res;
  int M, N, n;
  const int* seeds;
  unsigned site, thresh;
  float scale;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const int ma = row + g, mb = ma + 8;
    const int seed = seeds[site];
    const unsigned sa = ma / n, ia = ma % n, sb = mb / n, ib = mb % n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = nt * BN + 8 * j + 2 * t;
      float k[4];
      keep_frag(k, seed, site, sa, sb, 0u, ia * N + (c & ~3), ib * N + (c & ~3), thresh, scale,
                lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = h ? mb : ma;
        if (m >= M || c >= N) continue;
        const int64_t off = (int64_t)m * N + c;
        const float2 bv = *reinterpret_cast<const float2*>(bias + c);
        const float y0 = (acc[4 * j + 2 * h] + bv.x) * k[2 * h];
        const float y1 = (acc[4 * j + 2 * h + 1] + bv.y) * k[2 * h + 1];
        const float2 rv = *reinterpret_cast<const float2*>(res + off);
        *reinterpret_cast<float2*>(out + off) = make_float2(y0 + rv.x, y1 + rv.y);
      }
    }
  }
};

// ---- the attention core -------------------------------------------------------

constexpr int DH = 64;                  // head width
constexpr int WARPS = 4;                // 16 query rows each
constexpr int QT = WARPS * 16;          // query rows a block
constexpr int KC = 64;                  // keys a staged chunk
constexpr int PLANE_B = KC * DH * 2;    // one staged plane: 64 rows of 128 B
constexpr int STAGE_B = 4 * PLANE_B;    // k_hi, k_lo, v_hi, v_lo
constexpr int ATTN_SMEM = 2 * STAGE_B;  // double-buffered
// A key whose mask lies below MASKED, in a sequence with a key above REAL,
// scores below every real key's by ~1e30: its exp is exactly 0 in fp32.
constexpr float MASKED = -1e30f, REAL = -1e20f;

// Byte offset of (row, 16-B chunk) in a staged [64][64] bf16 plane: the
// chunk index XOR the row's low three bits, so the 8 rows an ldmatrix reads
// hit 8 distinct bank groups.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// Keep-mask words a row of one (sequence, head): two per 64-key chunk, bit
// j % 32 of word j / 32 for key j.
__host__ __device__ __forceinline__ int keep_words(int n) { return (n + KC - 1) / KC * 2; }

// c (16 x 8) += the split-bf16 product of a 16 x 64 A operand (hi / lo
// fragments of its four 16-deep steps) with the staged rows kb .. kb + 7 of
// the hi and lo planes (scores q k^T, dP = dctx v^T and their transposes).
__device__ __forceinline__ void split_rows8(float (&c)[4], const uint32_t (&ah)[4][4],
                                            const uint32_t (&al)[4][4], uint32_t hi, uint32_t lo,
                                            int kb, int lane) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    uint32_t bh[4], bl[4];
    ldsm_x4(bh, hi + swz(kb + (lane & 7), 4 * hf + (lane >> 3)));
    ldsm_x4(bl, lo + swz(kb + (lane & 7), 4 * hf + (lane >> 3)));
    mma16816(c, ah[2 * hf], bl[0], bl[1]);
    mma16816(c, ah[2 * hf + 1], bl[2], bl[3]);
    mma16816(c, al[2 * hf], bh[0], bh[1]);
    mma16816(c, al[2 * hf + 1], bh[2], bh[3]);
    mma16816(c, ah[2 * hf], bh[0], bh[1]);
    mma16816(c, ah[2 * hf + 1], bh[2], bh[3]);
  }
}

// o (16 x 64, eight 16 x 8 tiles) += the split-bf16 product of a 16 x 16 A
// operand (hi / lo) with the staged rows kb .. kb + 15 of the hi and lo
// planes, read transposed (P.V-shaped products).
__device__ __forceinline__ void split_cols64(float (&o)[8][4], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], uint32_t hi, uint32_t lo,
                                             int kb, int lane) {
  const int row = kb + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
  for (int dp = 0; dp < 4; ++dp) {
    uint32_t bh[4], bl[4];
    ldsm_x4_t(bh, hi + swz(row, 2 * dp + (lane >> 4)));
    ldsm_x4_t(bl, lo + swz(row, 2 * dp + (lane >> 4)));
    mma16816(o[2 * dp], al, bh[0], bh[1]);
    mma16816(o[2 * dp], ah, bl[0], bl[1]);
    mma16816(o[2 * dp], ah, bh[0], bh[1]);
    mma16816(o[2 * dp + 1], al, bh[2], bh[3]);
    mma16816(o[2 * dp + 1], ah, bl[2], bl[3]);
    mma16816(o[2 * dp + 1], ah, bh[2], bh[3]);
  }
}

// The 16 x 64 A operand of rows r0 .. r0 + 15 (below `rows`, else zeros) of
// a row-major bf16 plane (row stride ld) as its four steps' fragments.
__device__ __forceinline__ void load_a64(uint32_t (&a)[4][4], const bf16* base, int64_t ld,
                                         int r0, int rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r0 + g + 8 * (i & 1), d = 16 * ks + 8 * (i >> 1) + 2 * t;
      a[ks][i] = rr < rows ? *reinterpret_cast<const uint32_t*>(base + (int64_t)rr * ld + d) : 0u;
    }
  }
}

// qkv planes hi / lo [B n][3D] (q, k, v of head h at columns h * 64, D +
// h * 64, 2D + h * 64); mask [B][n] additive; ctx planes [B n][D]. One
// block per (64 query rows, head, sequence). DROP: the attention keep
// factors, site 0's over the [n, n] slab of (sequence, head); without it
// the code is the deterministic core's, whose bits the zero-shot prompts
// keep (a Philox branch in the loop changes which products the compiler
// fuses into FMAs). STATS: rowstat [B, heads, n] float4 gets each row's
// (max, 1 / sum, -, -) and, with DROP, keep [B, heads, n, keep_words(n)]
// the keep mask as bits.
template <bool STATS, bool DROP>
__global__ void __launch_bounds__(WARPS * 32)
attn_kernel(const bf16* __restrict__ qkv_hi, const bf16* __restrict__ qkv_lo,
            const float* __restrict__ mask, Dropout drop, bf16* __restrict__ ctx_hi,
            bf16* __restrict__ ctx_lo, float4* __restrict__ rowstat, unsigned* __restrict__ keep,
            int n, int D, float scale, int flags) {
  extern __shared__ __align__(128) char smem[];
  const int b = blockIdx.z, h = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, ld = 3 * D, nch = (n + KC - 1) / KC;
  const bool keep_lo = !(flags & ONE_PASS);
  const int64_t seq0 = (int64_t)b * n, bhd = (int64_t)b * gridDim.y + h;
  const float* mrow = mask + seq0;
  const uint32_t sbase = sm90::smem_u32(smem);
  const int seed = DROP ? drop.seeds[0] : 0;

  // every warp reaches the same answers from the same mask row, so the
  // block agrees on which chunks it stages
  bool any_real = false;
  if (!(flags & NO_SKIP)) {
    for (int k = lane; k < n; k += 32) any_real |= mrow[k] > REAL;
    any_real = __any_sync(0xffffffffu, any_real);
  }
  auto next_live = [&](int c) {
    for (; c < nch && any_real; ++c) {
      const int k0 = c * KC + lane, k1 = k0 + 32;
      const bool dead = (k0 >= n || mrow[k0] < MASKED) && (k1 >= n || mrow[k1] < MASKED);
      if (!__all_sync(0xffffffffu, dead)) break;
    }
    return c;
  };
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
  uint32_t qh[4][4], ql[4][4];
  load_a64(qh, qkv_hi + seq0 * ld + h * DH, ld, q0, n, lane);
  load_a64(ql, qkv_lo + seq0 * ld + h * DH, ld, q0, n, lane);
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;
  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  int c = next_live(0), buf = 0;
  if (c < nch) stage(c, 0);
  while (c < nch) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // chunk c is in `buf`; every warp is done with the other buffer
    const int nx = next_live(c + 1);
    if (nx < nch) stage(nx, buf ^ 1);
    if (q0 < n) {
      const uint32_t kh = sbase + buf * STAGE_B, kl = kh + PLANE_B, vh = kl + PLANE_B,
                     vl = vh + PLANE_B;
      // scores of keys c * KC + 8 jt ..., split-bf16, then scale and mask
      float s[8][4];
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        split_rows8(acc, qh, ql, kh, kl, 8 * jt, lane);
        const int key = c * KC + 8 * jt + 2 * t;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = key + (i & 1);
          s[jt][i] = kk < n ? acc[i] * scale + mrow[kk] : -CUDART_INF_F;
        }
      }
      // online softmax: the rows' maxima over their quads, earlier sums rescaled
      float xa = m_a, xb = m_b;
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        xa = fmaxf(xa, fmaxf(s[jt][0], s[jt][1]));
        xb = fmaxf(xb, fmaxf(s[jt][2], s[jt][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, off));
        xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, off));
      }
      const float alpha_a = expf(m_a - xa), alpha_b = expf(m_b - xb);
      m_a = xa;
      m_b = xb;
      l_a *= alpha_a;
      l_b *= alpha_b;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        o[dt][0] *= alpha_a;
        o[dt][1] *= alpha_a;
        o[dt][2] *= alpha_b;
        o[dt][3] *= alpha_b;
      }
      // P.V, p = exp(s - m) keep in fp32 fed as hi / lo A fragments; the
      // row sums take the undropped exp
      unsigned bits_a[2] = {0u, 0u}, bits_b[2] = {0u, 0u};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int jt = 2 * ks + u, key = c * KC + 8 * jt + 2 * t;
          float kf[4] = {1.f, 1.f, 1.f, 1.f};
          if (DROP)
            keep_frag(kf, seed, 0u, b, b, h, ra * n + (key & ~3), rb * n + (key & ~3),
                      drop.thresh_attn, drop.scale_attn, lane);
          const float* sj = s[jt];
          const float pa0 = expf(sj[0] - m_a), pa1 = expf(sj[1] - m_a);
          const float pb0 = expf(sj[2] - m_b), pb1 = expf(sj[3] - m_b);
          l_a += pa0 + pa1;
          l_b += pb0 + pb1;
          __nv_bfloat162 hv, lv;
          split2(DROP ? pa0 * kf[0] : pa0, DROP ? pa1 * kf[1] : pa1, keep_lo, hv, lv);
          ah[2 * u] = as_u32(hv);
          al[2 * u] = as_u32(lv);
          split2(DROP ? pb0 * kf[2] : pb0, DROP ? pb1 * kf[3] : pb1, keep_lo, hv, lv);
          ah[2 * u + 1] = as_u32(hv);
          al[2 * u + 1] = as_u32(lv);
          if (STATS && DROP) {
            const int bit = 8 * (jt & 3) + 2 * t;
            bits_a[jt >> 2] |= (kf[0] != 0.f ? 1u << bit : 0u) | (kf[1] != 0.f ? 2u << bit : 0u);
            bits_b[jt >> 2] |= (kf[2] != 0.f ? 1u << bit : 0u) | (kf[3] != 0.f ? 2u << bit : 0u);
          }
        }
        split_cols64(o, ah, al, vh, vl, 16 * ks, lane);
      }
      if (STATS && DROP) {
        const int words = keep_words(n);
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          unsigned wa = bits_a[w] | __shfl_xor_sync(0xffffffffu, bits_a[w], 1);
          wa |= __shfl_xor_sync(0xffffffffu, wa, 2);
          unsigned wb = bits_b[w] | __shfl_xor_sync(0xffffffffu, bits_b[w], 1);
          wb |= __shfl_xor_sync(0xffffffffu, wb, 2);
          if (t == 0 && ra < n) keep[(bhd * n + ra) * words + 2 * c + w] = wa;
          if (t == 0 && rb < n) keep[(bhd * n + rb) * words + 2 * c + w] = wb;
        }
      }
    }
    c = nx;
    buf ^= 1;
  }
  if (q0 >= n) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  if (STATS && t == 0) {
    if (ra < n) rowstat[bhd * n + ra] = make_float4(m_a, inv_a, 0.f, 0.f);
    if (rb < n) rowstat[bhd * n + rb] = make_float4(m_b, inv_b, 0.f, 0.f);
  }
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = h * DH + 8 * dt + 2 * t;
    __nv_bfloat162 hv, lv;
    if (ra < n) {
      split2(o[dt][0] * inv_a, o[dt][1] * inv_a, keep_lo, hv, lv);
      *reinterpret_cast<__nv_bfloat162*>(ctx_hi + (seq0 + ra) * D + col) = hv;
      *reinterpret_cast<__nv_bfloat162*>(ctx_lo + (seq0 + ra) * D + col) = lv;
    }
    if (rb < n) {
      split2(o[dt][2] * inv_b, o[dt][3] * inv_b, keep_lo, hv, lv);
      *reinterpret_cast<__nv_bfloat162*>(ctx_hi + (seq0 + rb) * D + col) = hv;
      *reinterpret_cast<__nv_bfloat162*>(ctx_lo + (seq0 + rb) * D + col) = lv;
    }
  }
}

// ---- host side ------------------------------------------------------------------

// The split product of planes a [2][M][K] and b [2][N][K] (hi, then lo) on
// the staged tiling split_sm90.cuh picks (split4_planes).
template <class Epi>
inline int product(const bf16* a, const bf16* b, int M, int N, int K, const Epi& epi,
                   cudaStream_t st) {
  return sm90::split4_planes(a, b, K, M, N, K, epi, st);
}

// The chain's workspaces: bf16 hi / lo planes [2][rows][cols] of x, wqkv,
// wo, w1, w2 (as those), qkv [B n, 3D], ctx, y [B n, D] and g [B n, F]; fp32
// r1, y, r2 [B n, D] (r1 and r2 may be one buffer: LN1 reads r1 before the
// FF writes r2) and the FF's pre-activation h1 [B n, F] (null: not kept);
// rowstat and keep as attn_kernel's (rowstat null: no statistics).
struct F32Work {
  bf16 *x_s, *wqkv_s, *wo_s, *w1_s, *w2_s, *qkv_s, *ctx_s, *y_s, *h_s;
  float *r1, *y, *r2, *h1;
  float4* rowstat;
  unsigned* keep;
};

// The chain on x [B n, D], mask [B, n] and the twelve weights w (fp32, the
// nn.Linear (out, in) layout: wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2,
// g2, be2); out [B n, D] = LN2(r2), or nothing where out is null. Returns 0
// or an error.
template <int Dummy = 0>
int forward_chain_f32(const float* x, const float* mask, const void* const (&w)[12],
                      const F32Work& ws, float* out, const Dropout& drop, int B, int n, int D,
                      int F, int heads, int flags, float eps, float scale, cudaStream_t st) {
  const int M = B * n, keep = !(flags & ONE_PASS);
  if (D != heads * DH || F % 8 || ((drop.thresh_attn || drop.thresh_hidden) && n % 4) ||
      (ws.rowstat != nullptr && drop.thresh_attn && ws.keep == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t md = (int64_t)M * D;
  int err = split(x, ws.x_s, md, keep, st);
  if (!err) err = split(w[0], ws.wqkv_s, (int64_t)3 * D * D, keep, st);
  if (!err) err = split(w[2], ws.wo_s, (int64_t)D * D, keep, st);
  if (!err) err = split(w[6], ws.w1_s, (int64_t)F * D, keep, st);
  if (!err) err = split(w[8], ws.w2_s, (int64_t)D * F, keep, st);
  if (!err)
    err = product(ws.x_s, ws.wqkv_s, M, 3 * D, D,
                  SplitEpi<false>{ws.qkv_s, ws.qkv_s + md * 3, (const float*)w[1], M, 3 * D, keep,
                                  nullptr},
                  st);
  if (err) return err;
  const bool stats = ws.rowstat != nullptr, drop_attn = drop.thresh_attn != 0u;
  auto core = stats ? (drop_attn ? attn_kernel<true, true> : attn_kernel<true, false>)
                    : (drop_attn ? attn_kernel<false, true> : attn_kernel<false, false>);
  cudaFuncSetAttribute(core, cudaFuncAttributeMaxDynamicSharedMemorySize, ATTN_SMEM);
  dim3 ga((n + QT - 1) / QT, heads, B);
  core<<<ga, WARPS * 32, ATTN_SMEM, st>>>(ws.qkv_s, ws.qkv_s + md * 3, mask, drop, ws.ctx_s,
                                          ws.ctx_s + md, ws.rowstat, ws.keep, n, D, scale, flags);
  err = (int)cudaGetLastError();
  // the hidden sites: (acc + bias) keep + residual, or F32OutEpi with them off
  auto hidden = [&](const bf16* a, const bf16* b, int K, float* out, const void* bias,
                    const float* res, unsigned site) {
    if (!drop.thresh_hidden)
      return product(a, b, M, D, K, sm90::F32OutEpi{out, (const float*)bias, res, M, D}, st);
    return product(a, b, M, D, K,
                   HiddenF32Epi{out, (const float*)bias, res, M, D, n, drop.seeds, site,
                                drop.thresh_hidden, drop.scale_hidden},
                   st);
  };
  if (!err) err = hidden(ws.ctx_s, ws.wo_s, D, ws.r1, w[3], x, 1u);
  if (err) return err;
  err = sm90::launch_ln_split(ws.r1, (const float*)w[4], (const float*)w[5], ws.y, ws.y_s,
                              ws.y_s + md, nullptr, nullptr, M, D, eps, keep, st);
  if (!err)
    err = product(ws.y_s, ws.w1_s, M, F, D,
                  SplitEpi<true>{ws.h_s, ws.h_s + (int64_t)M * F, (const float*)w[7], M, F, keep,
                                 ws.h1},
                  st);
  if (!err) err = hidden(ws.h_s, ws.w2_s, F, ws.r2, w[9], ws.y, 2u);
  if (err || out == nullptr) return err;
  return sm90::launch_ln_split(ws.r2, (const float*)w[10], (const float*)w[11], out, nullptr,
                               nullptr, nullptr, nullptr, M, D, eps, keep, st);
}

}  // namespace bert
}  // namespace ctc
