// The tensor-core pieces of the cosine-attention cores (mma.sync m16n8k16,
// bf16 operands, fp32 sums), shared by the forward of the spatial and the
// temporal block (attn_block.cu, attn_packed.cu), the block backward's
// passes (attn_bwd.cuh) and the bare cosine core (cosine_attention.cu):
//
//   swz / stage_planes   keys (or queries) of one slice staged in shared
//                        memory as [rows][32] bf16 planes, 64 B a row, the
//                        16-B chunk index XOR bits 1-2 of the row, so the 8
//                        rows an ldmatrix reads hit 8 distinct bank groups;
//   ldsm_x4 / ldsm_x4_t  ldmatrix x4 (B fragments of two 16-deep steps, or
//                        transposed: the B operand of P.V-shaped products);
//   split_scores         the score step: q and k arrive as bf16 pairs hi =
//                        bf16(y), lo = bf16(y - hi) of the fp32 l2-normed,
//                        scaled rows, and q_hi.k_hi + q_hi.k_lo + q_lo.k_hi
//                        in fp32 lies within ~2^-16 of the fp32 scores the
//                        TPU kernels take (one bf16 product errs by ~1e-2 at
//                        scale 8); each bf16 x bf16 product is exact in fp32;
//   QkvEpi               the projection epilogue that writes those pairs on
//                        the Hopper GEMM core (gemm_sm90.cuh), and for the
//                        backward the unit vectors and norms as well;
//   two_pass_core        the forward core over one slice: each warp takes 16
//                        query rows; pass 1 keeps the running row max and sum
//                        over 64-key chunks, pass 2 recomputes the scores, p =
//                        exp(s - m) / l rounded to bf16 (the TPU kernels'
//                        rounding point) and P.V with p fed from the score
//                        registers; o rounded to bf16. With STATS it also
//                        writes each row's (m log2 e, 1 / l, D = rowsum(dO o))
//                        for the backward passes;
//   block_forward        the block's forward chain on the Hopper GEMM core
//                        around that core: LN pass, QkvPlan + QkvEpi, the
//                        core, the output projection (+ x);
//   QkvSplitPlan         the q | k | v product of the fp32 chains, whose
//                        forward (block_forward_f32, every product three
//                        bf16 products of hi / lo planes, the core with
//                        split P.V: F32) is in attn_fwd_packed.cuh.
#pragma once

#include <math_constants.h>

#include "split_sm90.cuh"

namespace ctc {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int DH = 32;             // head width of the cores
constexpr int CORE_WARPS = 8;      // 16 query rows each
constexpr int QT = CORE_WARPS * 16;
constexpr int KC = 64;             // keys a chunk; staged rows are padded to it
constexpr float LOG2E = 1.4426950408889634f;

// ---- the projection epilogue -------------------------------------------------

// Tiles of QkvPlan: q (which 0) and k (1) l2-normalised per 32-wide head in
// registers (a head's columns of a row sit in one quad of 4 threads: two
// shuffles give the norm), times q_scale * scale / k_scale, written as bf16
// hi / lo planes; v (2) rounded to bf16, or in the fp32 chain written as hi /
// lo planes (v_lo given). unit / norm (the backward's; null
// in the forward): the unscaled unit rows [2][M][HD] fp32 and the norms
// max(||y||, 1e-12) [2][M][H] fp32 of q and k.
struct QkvEpi {
  bf16* qk;              // [4][M][HD]: q_hi, q_lo, k_hi, k_lo
  bf16* v;               // [M][HD]
  const float* qs;
  const float* ks;
  float scale;
  int M, HD, tiles;
  float* unit;
  float* norm;
  bf16* v_lo = nullptr;  // the fp32 chain: v as hi (v) / lo (v_lo) planes
  int keep_lo = 1;       // 0: every lo plane written as zeros (one-pass bf16 control)
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    constexpr int BN = sm90::BN;
    const int g = lane >> 2, t = lane & 3;
    const int which = nt / tiles, n0 = (nt % tiles) * BN;
    const size_t plane = (size_t)M * HD;
    if (which == 2) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = row + g + 8 * hf;
        if (m < M) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const size_t off = (size_t)m * HD + n0 + 8 * j + 2 * t;
            const float y0 = acc[4 * j + 2 * hf], y1 = acc[4 * j + 2 * hf + 1];
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(y0, y1);
            *reinterpret_cast<__nv_bfloat162*>(v + off) = h2;
            if (v_lo != nullptr)
              *reinterpret_cast<__nv_bfloat162*>(v_lo + off) =
                  keep_lo ? __floats2bfloat162_rn(y0 - __low2float(h2), y1 - __high2float(h2))
                          : __floats2bfloat162_rn(0.f, 0.f);
          }
        }
      }
      return;
    }
    const float* sc = which == 0 ? qs : ks;
    const float mul = which == 0 ? scale : 1.f;
    bf16* hi = qk + 2 * which * plane;
    bf16* lo = hi + plane;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = row + g + 8 * hf;
#pragma unroll
      for (int hh = 0; hh < BN / DH; ++hh) {
        float ss = 0.f;
#pragma unroll
        for (int j = 4 * hh; j < 4 * hh + 4; ++j)
          ss += acc[4 * j + 2 * hf] * acc[4 * j + 2 * hf] +
                acc[4 * j + 2 * hf + 1] * acc[4 * j + 2 * hf + 1];
        ss += __shfl_xor_sync(0xffffffffu, ss, 1);
        ss += __shfl_xor_sync(0xffffffffu, ss, 2);
        const float nrm = fmaxf(sqrtf(ss), 1e-12f);
        if (m < M) {
          if (norm != nullptr && t == 0)
            norm[(size_t)which * M * (HD / DH) + (size_t)m * (HD / DH) + (n0 / DH + hh)] = nrm;
#pragma unroll
          for (int j = 4 * hh; j < 4 * hh + 4; ++j) {
            const int d = 8 * (j - 4 * hh) + 2 * t;
            const float u0 = acc[4 * j + 2 * hf] / nrm, u1 = acc[4 * j + 2 * hf + 1] / nrm;
            const float y0 = u0 * (sc[d] * mul);
            const float y1 = u1 * (sc[d + 1] * mul);
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(y0, y1);
            const __nv_bfloat162 l2 =
                keep_lo ? __floats2bfloat162_rn(y0 - __low2float(h2), y1 - __high2float(h2))
                        : __floats2bfloat162_rn(0.f, 0.f);
            const size_t off = (size_t)m * HD + n0 + 8 * j + 2 * t;
            *reinterpret_cast<__nv_bfloat162*>(hi + off) = h2;
            *reinterpret_cast<__nv_bfloat162*>(lo + off) = l2;
            if (unit != nullptr)
              *reinterpret_cast<float2*>(unit + which * plane + off) = make_float2(u0, u1);
          }
        }
      }
    }
  }
};

// ---- PTX wrappers and staging ------------------------------------------------

// Byte offset of (row, 16-B chunk) in a staged [rows][32] bf16 plane.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__host__ __device__ __forceinline__ int padded_keys(int n) { return (n + KC - 1) / KC * KC; }

// Threads of a block of the cores over n query (or key) rows: CORE_WARPS
// warps of 16 rows each, or one warp per 16 rows of a sequence shorter
// than a tile (at n = 24 two warps, not eight with six idle: four times the
// working warps an SM holds).
inline int core_threads(int n) { return 32 * (n >= QT ? CORE_WARPS : (n + 15) / 16); }

// Shared memory of a slice's staged planes of m rows: three (k_hi, k_lo, v,
// or their backward counterparts), four in the fp32 core (v_hi, v_lo).
__host__ __device__ __forceinline__ size_t core_smem_bytes(int m, int planes = 3) {
  return (size_t)padded_keys(m) * planes * DH * 2;
}

// Start cp.async copies of rows [0, rows_pad) of NP planes (row j of plane p
// at src[p] + j * ld, 32 bf16) into shared memory at sbase + p * rows_pad *
// 64 B, swizzled; rows at or past `rows` are zero-filled. The caller waits.
template <int NP>
__device__ __forceinline__ void stage_planes(uint32_t sbase, const bf16* const (&src)[NP],
                                             int64_t ld, int rows, int rows_pad) {
  const uint32_t pbytes = rows_pad * DH * 2;
  for (int i = threadIdx.x; i < NP * rows_pad * 4; i += blockDim.x) {
    const int p = i / (rows_pad * 4), rem = i - p * rows_pad * 4, j = rem >> 2, c = rem & 3;
    cp_async16(sbase + p * pbytes + swz(j, c), src[p] + (int64_t)min(j, rows - 1) * ld + c * 8,
               j < rows ? 16 : 0);
  }
}

// The 16 x 32 A operand of rows r0 .. r0 + 15 of a row-major bf16 matrix
// (row stride ld) as the fragments of its two 16-deep steps; rows at or
// past `rows` read as zeros.
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const bf16* base, int64_t ld, int r0,
                                       int rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r0 + g + 8 * (i & 1), d = 16 * ks + 8 * (i >> 1) + 2 * t;
      a[ks][i] = rr < rows ? *reinterpret_cast<const uint32_t*>(base + (int64_t)rr * ld + d) : 0u;
    }
  }
}

// c += the split-bf16 products of a 16-row A operand (hi / lo fragments)
// with the 8 staged rows kb .. kb + 7 of the hi and lo planes.
__device__ __forceinline__ void split_scores(float (&c)[4], const uint32_t (&ah)[2][4],
                                             const uint32_t (&al)[2][4], uint32_t hi_plane,
                                             uint32_t lo_plane, int kb, int lane) {
  uint32_t bh[4], bl[4];
  ldsm_x4(bh, hi_plane + swz(kb + (lane & 7), lane >> 3));
  ldsm_x4(bl, lo_plane + swz(kb + (lane & 7), lane >> 3));
  mma16816(c, ah[0], bl[0], bl[1]);
  mma16816(c, ah[1], bl[2], bl[3]);
  mma16816(c, al[0], bh[0], bh[1]);
  mma16816(c, al[1], bh[2], bh[3]);
  mma16816(c, ah[0], bh[0], bh[1]);
  mma16816(c, ah[1], bh[2], bh[3]);
}

// c += a (16 x 32, two steps) . the 8 staged rows kb .. kb + 7 of one plane
// (dP = dO . V^T-shaped products).
__device__ __forceinline__ void row_products(float (&c)[4], const uint32_t (&a)[2][4],
                                             uint32_t plane, int kb, int lane) {
  uint32_t b[4];
  ldsm_x4(b, plane + swz(kb + (lane & 7), lane >> 3));
  mma16816(c, a[0], b[0], b[1]);
  mma16816(c, a[1], b[2], b[3]);
}

// acc[dt] (16 x 32) += a (16 x 16 keys, e.g. bf16(p)) . the staged rows kb ..
// kb + 15 of one plane (P.V-shaped products, the plane read transposed).
__device__ __forceinline__ void col_products(float (&acc)[4][4], const uint32_t (&a)[4],
                                             uint32_t plane, int kb, int lane) {
  const int row = kb + ((lane >> 3) & 1) * 8 + (lane & 7);
  uint32_t b0[4], b1[4];
  ldsm_x4_t(b0, plane + swz(row, lane >> 4));
  ldsm_x4_t(b1, plane + swz(row, 2 + (lane >> 4)));
  mma16816(acc[0], a, b0[0], b0[1]);
  mma16816(acc[1], a, b0[2], b0[3]);
  mma16816(acc[2], a, b1[0], b1[1]);
  mma16816(acc[3], a, b1[2], b1[3]);
}

// A fragments of rows r0 .. r0 + 15 of a staged plane (ldmatrix x4).
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[2][4], uint32_t plane, int r0, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    ldsm_x4(a[ks], plane + swz(r0 + (lane & 15), 2 * ks + (lane >> 4)));
}

// The backward's dbias passes (attn_bwd.cuh, attn_bwd_f32.cuh): a block of
// DB_WARPS warps takes DB_QT query rows against one KC-key chunk.
constexpr int DB_WARPS = 4;          // 16 query rows each
constexpr int DB_QT = DB_WARPS * 16;
constexpr int DB_PLANE = KC * DH * 2;          // one staged plane of 64 rows

// The bias of rows a / b at keys key, key + 1 (BIAS 0: none; 1: any row
// length; 2: even row length, one 8-B load a pair); zero outside.
template <int BIAS>
__device__ __forceinline__ void bias_pair(float (&b)[4], const float* row_a, const float* row_b,
                                          bool va, bool vb, int key, int m) {
  b[0] = b[1] = b[2] = b[3] = 0.f;
  if (BIAS == 2) {
    if (key < m) {
      if (va) {
        const float2 w = *reinterpret_cast<const float2*>(row_a + key);
        b[0] = w.x;
        b[1] = w.y;
      }
      if (vb) {
        const float2 w = *reinterpret_cast<const float2*>(row_b + key);
        b[2] = w.x;
        b[3] = w.y;
      }
    }
  } else if (BIAS == 1) {
    if (va && key < m) b[0] = row_a[key];
    if (va && key + 1 < m) b[1] = row_a[key + 1];
    if (vb && key < m) b[2] = row_b[key];
    if (vb && key + 1 < m) b[3] = row_b[key + 1];
  }
}

// ---- the forward core ----------------------------------------------------------

// One slice: query row i of q_hi / q_lo / o (and dO) at i * ld, key row j of
// k_hi / k_lo / v at j * ld; bias [n][m] fp32 or null. The fp32 core also
// reads v's lo plane and writes o's (keep_lo 0: p and o without lo planes).
struct Slice {
  const bf16 *q_hi, *q_lo, *k_hi, *k_lo, *v;
  const float* bias;
  bf16* o;
  int64_t ld;
  int n, m;
  const bf16* v_lo = nullptr;
  bf16* o_lo = nullptr;
  int keep_lo = 1;
};

// The block stages the slice's keys and values, then warp w takes query rows
// q_tile + 16 w. STATS: stats[i] = (m log2 e, 1 / l, rowsum(dO_i o_i), 0)
// with o rounded to bf16 (flash-attention's D, sum_j P dP). F32: the fp32
// core, p and v not rounded: P.V as p_lo v_hi + p_hi v_lo + p_hi v_hi (p
// split in registers, v's planes staged), o written as hi / lo planes; with
// STATS, D from the fp32 o and dO's planes (dO, dO_lo: dO_hi + dO_lo);
// with dO null, D = 0 (the forward keeping its statistics for the backward,
// whose query pass forms D).
template <int BIAS, bool STATS, bool F32 = false>
__device__ __forceinline__ void two_pass_core(const Slice& sl, int q_tile, float4* stats,
                                              const bf16* dO, const bf16* dO_lo = nullptr) {
  extern __shared__ __align__(128) char smem[];
  const int n = sl.n, m = sl.m, m_pad = padded_keys(m);
  const uint32_t sbase = sm90::smem_u32(smem), pbytes = m_pad * DH * 2;
  if constexpr (F32) {
    const bf16* const src[4] = {sl.k_hi, sl.k_lo, sl.v, sl.v_lo};
    stage_planes<4>(sbase, src, sl.ld, m, m_pad);
  } else {
    const bf16* const src[3] = {sl.k_hi, sl.k_lo, sl.v};
    stage_planes<3>(sbase, src, sl.ld, m, m_pad);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  const int q0 = q_tile + (threadIdx.x >> 5) * 16;
  if (q0 >= n) return;

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = q0 + g, rb = q0 + g + 8;
  const bool va = ra < n, vb = rb < n;
  uint32_t qh[2][4], ql[2][4];
  load_a(qh, sl.q_hi, sl.ld, q0, n, lane);
  load_a(ql, sl.q_lo, sl.ld, q0, n, lane);
  const float* bias_a = BIAS ? sl.bias + (int64_t)(va ? ra : 0) * m : nullptr;
  const float* bias_b = BIAS ? sl.bias + (int64_t)(vb ? rb : 0) * m : nullptr;

  // s[jt] = scores (+ bias) of keys kc + 8 jt ..., -inf past m
  auto chunk_scores = [&](int kc, float (&s)[KC / 8][4]) {
#pragma unroll
    for (int jt = 0; jt < KC / 8; ++jt) {
      const int kb = kc + 8 * jt;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      split_scores(c, qh, ql, sbase, sbase + pbytes, kb, lane);
      const int key = kb + 2 * t;
      float b[4];
      bias_pair<BIAS>(b, bias_a, bias_b, va, vb, key, m);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[jt][i] = key + (i & 1) < m ? c[i] + b[i] : -CUDART_INF_F;
    }
  };

  // pass 1: the running max and sum of each row over this thread's columns
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;
  for (int kc = 0; kc < m_pad; kc += KC) {
    float s[KC / 8][4];
    chunk_scores(kc, s);
    float xa = m_a, xb = m_b;
#pragma unroll
    for (int jt = 0; jt < KC / 8; ++jt) {
      xa = fmaxf(xa, fmaxf(s[jt][0], s[jt][1]));
      xb = fmaxf(xb, fmaxf(s[jt][2], s[jt][3]));
    }
    // in log2 units; a row with no key yet keeps base 0 so no inf - inf
    const float ba = xa == -CUDART_INF_F ? 0.f : xa * LOG2E;
    const float bb = xb == -CUDART_INF_F ? 0.f : xb * LOG2E;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int jt = 0; jt < KC / 8; ++jt) {
      sa += exp2f(s[jt][0] * LOG2E - ba) + exp2f(s[jt][1] * LOG2E - ba);
      sb += exp2f(s[jt][2] * LOG2E - bb) + exp2f(s[jt][3] * LOG2E - bb);
    }
    l_a = l_a * exp2f(m_a * LOG2E - ba) + sa;
    l_b = l_b * exp2f(m_b * LOG2E - bb) + sb;
    m_a = xa;
    m_b = xb;
  }
  // the row's max and sum over its quad of threads
  auto row_stats = [&](float mx, float l, float& base, float& inv) {
    float mq = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
    float lq = l * exp2f(mx * LOG2E - mq * LOG2E);
    lq += __shfl_xor_sync(0xffffffffu, lq, 1);
    lq += __shfl_xor_sync(0xffffffffu, lq, 2);
    base = mq * LOG2E;
    inv = 1.f / lq;
  };
  float base_a, inv_a, base_b, inv_b;
  row_stats(m_a, l_a, base_a, inv_a);
  row_stats(m_b, l_b, base_b, inv_b);

  // pass 2: p = exp(s - m) / l rounded to bf16, then P.V
  float oacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
  for (int kc = 0; kc < m_pad; kc += KC) {
    float s[KC / 8][4];
    chunk_scores(kc, s);
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      if constexpr (F32) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* sj = s[2 * ks + u];
          __nv_bfloat162 hv, lv;
          sm90::split2(exp2f(sj[0] * LOG2E - base_a) * inv_a,
                       exp2f(sj[1] * LOG2E - base_a) * inv_a, sl.keep_lo, hv, lv);
          ah[2 * u] = sm90::as_u32(hv);
          al[2 * u] = sm90::as_u32(lv);
          sm90::split2(exp2f(sj[2] * LOG2E - base_b) * inv_b,
                       exp2f(sj[3] * LOG2E - base_b) * inv_b, sl.keep_lo, hv, lv);
          ah[2 * u + 1] = sm90::as_u32(hv);
          al[2 * u + 1] = sm90::as_u32(lv);
        }
        col_products(oacc, al, sbase + 2 * pbytes, kc + 16 * ks, lane);
        col_products(oacc, ah, sbase + 3 * pbytes, kc + 16 * ks, lane);
        col_products(oacc, ah, sbase + 2 * pbytes, kc + 16 * ks, lane);
      } else {
        uint32_t a[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* sj = s[2 * ks + u];
          a[2 * u] = sm90::pack_bf16(exp2f(sj[0] * LOG2E - base_a) * inv_a,
                                     exp2f(sj[1] * LOG2E - base_a) * inv_a);
          a[2 * u + 1] = sm90::pack_bf16(exp2f(sj[2] * LOG2E - base_b) * inv_b,
                                         exp2f(sj[3] * LOG2E - base_b) * inv_b);
        }
        col_products(oacc, a, sbase + 2 * pbytes, kc + 16 * ks, lane);
      }
    }
  }
  if constexpr (F32) {
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      const int col = 8 * dt + 2 * t;
      __nv_bfloat162 hv, lv;
      if (va) {
        sm90::split2(oacc[dt][0], oacc[dt][1], sl.keep_lo, hv, lv);
        *reinterpret_cast<__nv_bfloat162*>(sl.o + (int64_t)ra * sl.ld + col) = hv;
        *reinterpret_cast<__nv_bfloat162*>(sl.o_lo + (int64_t)ra * sl.ld + col) = lv;
      }
      if (vb) {
        sm90::split2(oacc[dt][2], oacc[dt][3], sl.keep_lo, hv, lv);
        *reinterpret_cast<__nv_bfloat162*>(sl.o + (int64_t)rb * sl.ld + col) = hv;
        *reinterpret_cast<__nv_bfloat162*>(sl.o_lo + (int64_t)rb * sl.ld + col) = lv;
      }
    }
    if constexpr (STATS) {
      float d_a = 0.f, d_b = 0.f;
#pragma unroll
      for (int dt = 0; dt < 4 && dO != nullptr; ++dt) {
        const int64_t ca = (int64_t)ra * sl.ld + 8 * dt + 2 * t;
        const int64_t cb = (int64_t)rb * sl.ld + 8 * dt + 2 * t;
        if (va) {
          const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dO + ca));
          const float2 l =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dO_lo + ca));
          d_a += (h.x + l.x) * oacc[dt][0] + (h.y + l.y) * oacc[dt][1];
        }
        if (vb) {
          const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dO + cb));
          const float2 l =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dO_lo + cb));
          d_b += (h.x + l.x) * oacc[dt][2] + (h.y + l.y) * oacc[dt][3];
        }
      }
      d_a += __shfl_xor_sync(0xffffffffu, d_a, 1);
      d_a += __shfl_xor_sync(0xffffffffu, d_a, 2);
      d_b += __shfl_xor_sync(0xffffffffu, d_b, 1);
      d_b += __shfl_xor_sync(0xffffffffu, d_b, 2);
      if (t == 0) {
        if (va) stats[ra] = make_float4(base_a, inv_a, d_a, 0.f);
        if (vb) stats[rb] = make_float4(base_b, inv_b, d_b, 0.f);
      }
    }
    return;
  }
  float d_a = 0.f, d_b = 0.f;
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    const int col = 8 * dt + 2 * t;
    const __nv_bfloat162 oa = __floats2bfloat162_rn(oacc[dt][0], oacc[dt][1]);
    const __nv_bfloat162 ob = __floats2bfloat162_rn(oacc[dt][2], oacc[dt][3]);
    if (va) {
      *reinterpret_cast<__nv_bfloat162*>(sl.o + (int64_t)ra * sl.ld + col) = oa;
      if (STATS) {
        const __nv_bfloat162 w =
            *reinterpret_cast<const __nv_bfloat162*>(dO + (int64_t)ra * sl.ld + col);
        d_a += __low2float(w) * __low2float(oa) + __high2float(w) * __high2float(oa);
      }
    }
    if (vb) {
      *reinterpret_cast<__nv_bfloat162*>(sl.o + (int64_t)rb * sl.ld + col) = ob;
      if (STATS) {
        const __nv_bfloat162 w =
            *reinterpret_cast<const __nv_bfloat162*>(dO + (int64_t)rb * sl.ld + col);
        d_b += __low2float(w) * __low2float(ob) + __high2float(w) * __high2float(ob);
      }
    }
  }
  if (STATS) {
    d_a += __shfl_xor_sync(0xffffffffu, d_a, 1);
    d_a += __shfl_xor_sync(0xffffffffu, d_a, 2);
    d_b += __shfl_xor_sync(0xffffffffu, d_b, 1);
    d_b += __shfl_xor_sync(0xffffffffu, d_b, 2);
    if (t == 0) {
      if (va) stats[ra] = make_float4(base_a, inv_a, d_a, 0.f);
      if (vb) stats[rb] = make_float4(base_b, inv_b, d_b, 0.f);
    }
  }
}

// The core over the attention block's layout: qk [4][M][HD] (q_hi, q_lo,
// k_hi, k_lo), v / o [M][HD] ([2][M][HD], hi then lo, in the fp32 core),
// bias [H][n][n]; one block per (sequence r, query tile, head h), sequence
// fastest, so the sequences that share a (head, query tile) read the same
// bias rows from L2 side by side. STATS: mld [R][H][n] and dO [M][HD] as in
// two_pass_core (dO [2][M][HD], hi then lo, in the fp32 core).
template <int BIAS, bool STATS, bool F32 = false>
__global__ void __launch_bounds__(CORE_WARPS * 32, 2)
block_core_kernel(const bf16* __restrict__ qk, const bf16* __restrict__ v,
                  const float* __restrict__ bias, bf16* __restrict__ o, int M, int n, int HD,
                  float4* __restrict__ mld, const bf16* __restrict__ dO, int keep_lo) {
  const int r = blockIdx.x, h = blockIdx.z;
  const size_t plane = (size_t)M * HD;
  const int64_t off = (int64_t)r * n * HD + h * DH;
  const Slice sl{qk + off, qk + plane + off, qk + 2 * plane + off, qk + 3 * plane + off, v + off,
                 BIAS ? bias + (int64_t)h * n * n : nullptr, o + off, HD, n, n,
                 F32 ? v + plane + off : nullptr, F32 ? o + plane + off : nullptr, keep_lo};
  const bool with_d = STATS && dO != nullptr;
  two_pass_core<BIAS, STATS, F32>(sl, blockIdx.y * QT,
                                  STATS ? mld + ((int64_t)r * gridDim.z + h) * n : nullptr,
                                  with_d ? dO + off : nullptr,
                                  with_d && F32 ? dO + plane + off : nullptr);
}

// Launch block_core_kernel over R sequences of n tokens, H heads.
template <bool STATS, bool F32 = false>
inline int launch_block_core(const bf16* qk, const bf16* v, const float* bias, bf16* o, int R,
                             int n, int H, float4* mld, const bf16* dO, cudaStream_t st,
                             int keep_lo = 1) {
  const int M = R * n, HD = H * DH, smem = (int)core_smem_bytes(n, F32 ? 4 : 3);
  auto core = bias == nullptr ? block_core_kernel<0, STATS, F32>
              : (n % 2 == 0)  ? block_core_kernel<2, STATS, F32>
                              : block_core_kernel<1, STATS, F32>;
  cudaFuncSetAttribute(core, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(R, (n + QT - 1) / QT, H);
  core<<<grid, core_threads(n), smem, st>>>(qk, v, bias, o, M, n, HD, mld, dO, keep_lo);
  return (int)cudaGetLastError();
}

// out[h][j][i] = in[h][i][j] for H planes of n x n fp32 (32 x 32 tiles):
// the bias as the backward's key passes read it.
template <int Dummy = 0>
__global__ void __launch_bounds__(256)
transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int n) {
  __shared__ float tile[32][33];
  const int64_t base = (int64_t)blockIdx.z * n * n;
  const int i0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
  for (int k = threadIdx.x >> 5; k < 32; k += 8) {
    const int i = i0 + k, j = j0 + (threadIdx.x & 31);
    if (i < n && j < n) tile[k][threadIdx.x & 31] = in[base + (int64_t)i * n + j];
  }
  __syncthreads();
  for (int k = threadIdx.x >> 5; k < 32; k += 8) {
    const int j = j0 + k, i = i0 + (threadIdx.x & 31);
    if (i < n && j < n) out[base + (int64_t)j * n + i] = tile[threadIdx.x & 31][k];
  }
}

// Largest key count whose staged planes (three, four in the fp32 core) fit
// a block's shared memory.
inline int core_max_keys(int planes = 3) {
  int m = KC;
  while (core_smem_bytes(m + KC, planes) <= 227 * 1024) m += KC;
  return m;
}

// ---- the block forward ---------------------------------------------------------

// The cosine-attention block's forward, the chain of attn_block.cu (bias
// [H][n][n] fp32) and attn_packed.cu (bias null): ln_rows_kernel writes xn;
// one QkvPlan GEMM writes q / k as hi / lo planes (QkvEpi) and v; the core
// writes o; a LinearPlan GEMM writes o Wo^T (+ x). x [R*n, D] bf16 (D a
// multiple of 8); gamma [D], qs / ks [32] fp32; wq / wk / wv [HD, D], wo [D,
// HD] bf16; workspaces xn [R*n, D], qk [4][R*n][HD], v_ws / o_ws [R*n, HD]
// bf16; out [R*n, D] bf16. HD = H * 32, a multiple of 128; every pointer
// 16-B aligned. A template so that only the sources that call it build its
// kernels.
template <int Dummy = 0>
int block_forward(const void* x, const void* gamma, const void* wq, const void* wk,
                         const void* wv, const void* wo, const void* qs, const void* ks,
                         const float* bias, void* xn, void* qk, void* v_ws, void* o_ws, void* out,
                         int R, int n, int D, int H, float scale, int residual,
                         cudaStream_t st) {
  using namespace sm90;
  const int M = R * n, HD = H * DH, tiles = HD / BN;
  Maps proj{}, outm{};
  int err = map_a(&proj.m[0], xn, M, D, D);
  if (!err) err = map_a(&proj.m[1], x, M, D, D);
  if (!err) err = map_b(&proj.m[2], wq, HD, D, D);
  if (!err) err = map_b(&proj.m[3], wk, HD, D, D);
  if (!err) err = map_b(&proj.m[4], wv, HD, D, D);
  if (!err) err = map_a(&outm.m[0], o_ws, M, HD, HD);
  if (!err) err = map_b(&outm.m[1], wo, D, HD, HD);
  if (err) return err;
  err = launch_ln_rows(static_cast<const bf16*>(x), static_cast<const float*>(gamma), nullptr,
                       static_cast<bf16*>(xn), M, D, st);
  if (err) return err;
  err = launch_gemm(proj, QkvPlan{tiles},
                    QkvEpi{static_cast<bf16*>(qk), static_cast<bf16*>(v_ws),
                           static_cast<const float*>(qs), static_cast<const float*>(ks), scale,
                           M, HD, tiles, nullptr, nullptr},
                    3 * tiles, M, D, st);
  if (err) return err;
  err = launch_block_core<false>(static_cast<const bf16*>(qk), static_cast<const bf16*>(v_ws),
                                 bias, static_cast<bf16*>(o_ws), R, n, H, nullptr, nullptr, st);
  if (err) return err;
  return launch_gemm(outm, LinearPlan{},
                     ResidualEpi{static_cast<bf16*>(out), static_cast<const bf16*>(x), M, D,
                                 residual},
                     (D + BN - 1) / BN, M, HD, st);
}

// The q, k and v projections of the fp32 chain as SplitPlan products: maps 0
// xn_hi, 1 xn_lo, 2 x_hi, 3 x_lo, 4 the stacked weights' hi plane [3 HD, D]
// (wq, wk, wv), 5 their lo plane; tiles [0, tiles) are q (from xn), then k,
// then v (from x), each over three passes as SplitPlan's.
struct QkvSplitPlan {
  static constexpr int PASSES = 3;
  int tiles;
  __device__ sm90::TileSrc src(int nt, int pass) const {
    const int which = nt / tiles, r = nt * sm90::BN;   // stacked weight rows
    const int a = (which == 0 ? 0 : 2) + (pass == 1 ? 1 : 0), b = pass == 2 ? 5 : 4;
    return {a, b, r, b, r + 64};
  }
};

}  // namespace tc
}  // namespace ctc
