// Pieces shared by the bf16 BERT layer's forward chain (bert_layer_bf16.cu)
// and its recompute backward (bert_layer_bwd.cu): the ports of
// ct_clip_ut_tpu/ops/pallas_bert_layer.py `_fwd_impl` (bf16, train mode) and
// `_bwd_impl`, on the Hopper pieces (sm_90a only).
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
//   keep_frag               the same bits in the mma.sync / wgmma D fragment
//                           layout, where a thread holds two adjacent
//                           columns of rows g and g + 8: the lanes t and t ^ 1
//                           share a group of four columns, so the even lane
//                           draws row g's group, the odd lane row g + 8's,
//                           and they swap the halves the other needs (one
//                           Philox call a thread, two shuffles).
//   QkvEpi ... DctxEpi      epilogues of gemm_sm90.cuh's Hopper core, from
//                           the accumulator registers: bias (qkv); bias +
//                           keep mask + residual (both hidden sites); bias +
//                           GELU; and the backward's.
//   fwd_core_kernel         softmax(q k^T / sqrt(dh) + mask) (x keep) @ v per
//                           (64 query rows, head, sequence) on mma.sync, heads
//                           of 64: pass 1 streams the key chunks for each
//                           row's max and sum, pass 2 recomputes the scores,
//                           normalises p in fp32, applies the keep mask and
//                           rounds to bf16 (the TPU kernel's rounding point,
//                           which a one-pass online softmax would move), then
//                           P.V. With STATS (the backward's recompute) it
//                           also writes each row's (max, 1 / sum) and the
//                           attention keep mask as bits.
//   ln_fwd_kernel           LayerNorm rows in the one-pass E[r^2] - E[r]^2
//                           form, saving (mean, rstd).
//   forward_chain           the seven launches of one layer.
//
// Rows are laid out [B, npad, ...] with npad = n rounded up to 64 (the
// wrapper pads x with zero rows and the key mask): `n` is the logical
// length, which the Philox counters and the key validity use.
#pragma once

#include "attn_mma.cuh"

namespace ctc {
namespace bh {

using bf16 = __nv_bfloat16;
using sm90::BN;
using tc::cp_async16;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma16816;

constexpr int DH = 64;               // head width of the attention passes
constexpr int KC = 64;               // keys (queries) a staged chunk; npad is a multiple
constexpr int FWD_RW = 8;            // 16-row groups a block of the forward core and the query pass
constexpr int KV_RW = 2;             // ... of the key pass (streamed chunks)
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

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

// The keep factors of a thread's four fragment elements: k[e] of row a,
// k[2 + e] of row b = a + 8, at columns c + e with c = 8 j + 2 t (t = lane &
// 3); idx_a / idx_b are the slab positions of (a, c & ~3) and (b, c & ~3),
// seq_* their sequences. All 32 lanes call it together.
__device__ __forceinline__ void keep_frag(float (&k)[4], int seed, unsigned site, unsigned seq_a,
                                          unsigned seq_b, unsigned head, unsigned idx_a,
                                          unsigned idx_b, unsigned thresh, float scale,
                                          int lane) {
  if (thresh == 0u) {
    k[0] = k[1] = k[2] = k[3] = 1.f;
    return;
  }
  const bool odd = lane & 1;
  const uint4 r = philox4x32_10(make_uint4((odd ? idx_b : idx_a) >> 2, site, odd ? seq_b : seq_a,
                                           head),
                                make_uint2((unsigned)seed, 0u));
  // the even lane (columns 0, 1 of the group) sends row a's words 2, 3; the odd one row b's 0, 1
  const unsigned o0 = __shfl_xor_sync(FULL, odd ? r.x : r.z, 1);
  const unsigned o1 = __shfl_xor_sync(FULL, odd ? r.y : r.w, 1);
  const unsigned w[4] = {odd ? o0 : r.x, odd ? o1 : r.y, odd ? r.z : o0, odd ? r.w : o1};
#pragma unroll
  for (int i = 0; i < 4; ++i) k[i] = w[i] >= thresh ? scale : 0.f;
}

struct Dropout {
  const int* seeds;        // [3] on the device: attention, post-attention, post-FF
  unsigned thresh_attn, thresh_hidden;
  float scale_attn, scale_hidden;
};

__device__ __forceinline__ float gelu_cdf(float x) {
  return 0.5f * (1.0f + erff(x * 0.7071067811865476f));
}

// ---- epilogues of the Hopper core (acc in the wgmma D layout) ------------------
//
// acc[4 j + 2 h + e] holds C[row + g + 8 h][nt * 128 + 8 j + 2 t + e], g =
// lane / 4, t = lane % 4; N even. An epilogue that reads memory loads EPI_J
// column tiles' operands before it stores any of them: the compiler may not
// move a load above a store to a pointer that could alias it, and one load
// waited on per tile left a launch twice its bare product's time.
constexpr int EPI_J = 4;

__device__ __forceinline__ float2 ld2(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float2*>(p) : make_float2(0.f, 0.f);
}
__device__ __forceinline__ float2 ld2(const bf16* p, bool ok) {
  return ok ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p))
            : make_float2(0.f, 0.f);
}

// out [M, N] = bf16(acc + bias): the QKV projection (q, k and v are used as
// bf16 operands only, so rounding here is rounding there).
struct QkvEpi {
  bf16* out;
  const float* bias;
  int M, N;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += EPI_J) {
      float2 bv[EPI_J];
#pragma unroll
      for (int u = 0; u < EPI_J; ++u) {
        const int c = nt * BN + 8 * (j0 + u) + 2 * t;
        bv[u] = ld2(bias + c, c < N);
      }
#pragma unroll
      for (int u = 0; u < EPI_J; ++u) {
        const int j = j0 + u, c = nt * BN + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row + g + 8 * h;
          if (m < M && c < N)
            *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)m * N + c) = __floats2bfloat162_rn(
                acc[4 * j + 2 * h] + bv[u].x, acc[4 * j + 2 * h + 1] + bv[u].y);
        }
      }
    }
  }
};

// out [M, D] = (acc + bias) keep + residual in fp32: both hidden sites. The
// residual is x (bf16, res_b) after the attention, LN1's fp32 output (res_f)
// after the FF; the keep mask of `site` over the [npad, D] slab of the row's
// sequence.
struct HiddenEpi {
  const float* bias;
  const bf16* res_b;
  const float* res_f;
  float* out;
  int M, D, npad;
  const int* seeds;
  unsigned site, thresh;
  float scale;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const int ma = row + g, mb = ma + 8;
    const int seed = thresh ? seeds[site] : 0;
    const unsigned sa = ma / npad, ia = ma % npad, sb = mb / npad, ib = mb % npad;
    // half the usual run of loads: gemm64_kernel's registers hold them; in
    // gemm_kernel (112 registers, the products of >= 132 tiles) this still
    // spills 132 B
    constexpr int J = EPI_J / 2;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += J) {
      float2 bv[J], rv[J][2];
#pragma unroll
      for (int u = 0; u < J; ++u) {
        const int c = nt * BN + 8 * (j0 + u) + 2 * t;
        bv[u] = ld2(bias + c, c < D);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = h ? mb : ma;
          const int64_t off = (int64_t)m * D + c;
          rv[u][h] = res_b != nullptr ? ld2(res_b + off, m < M && c < D)
                                      : ld2(res_f + off, m < M && c < D);
        }
      }
#pragma unroll
      for (int u = 0; u < J; ++u) {
        const int j = j0 + u, c = nt * BN + 8 * j + 2 * t;
        float k[4];
        keep_frag(k, seed, site, sa, sb, 0u, ia * D + (c & ~3), ib * D + (c & ~3), thresh, scale,
                  lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = h ? mb : ma;
          if (m < M && c < D)
            *reinterpret_cast<float2*>(out + (int64_t)m * D + c) =
                make_float2((acc[4 * j + 2 * h] + bv[u].x) * k[2 * h] + rv[u][h].x,
                            (acc[4 * j + 2 * h + 1] + bv[u].y) * k[2 * h + 1] + rv[u][h].y);
        }
      }
    }
  }
};

// h1 = acc + bias (fp32, kept for the backward's GELU') and g = bf16(gelu(h1)).
struct GeluEpi {
  const float* bias;
  float* h1;
  bf16* g;
  int M, F;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int gr = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += EPI_J) {
      float2 bv[EPI_J];
#pragma unroll
      for (int u = 0; u < EPI_J; ++u) {
        const int c = nt * BN + 8 * (j0 + u) + 2 * t;
        bv[u] = ld2(bias + c, c < F);
      }
#pragma unroll
      for (int u = 0; u < EPI_J; ++u) {
        const int j = j0 + u, c = nt * BN + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row + gr + 8 * h;
          if (m >= M || c >= F) continue;
          const float x0 = acc[4 * j + 2 * h] + bv[u].x, x1 = acc[4 * j + 2 * h + 1] + bv[u].y;
          const int64_t off = (int64_t)m * F + c;
          *reinterpret_cast<float2*>(h1 + off) = make_float2(x0, x1);
          *reinterpret_cast<__nv_bfloat162*>(g + off) =
              __floats2bfloat162_rn(x0 * gelu_cdf(x0), x1 * gelu_cdf(x1));
        }
      }
    }
  }
};

// ---- swizzled staging and the mma.sync products, heads of 64 ------------------

// Byte offset of (row, 16-B chunk) in a staged plane of 64-wide bf16 rows:
// the chunk index XOR the row's low three bits, so the 8 rows an ldmatrix reads
// hit 8 distinct bank groups.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// The 16 x 64 A operand of rows r0 .. r0 + 15 of a row-major bf16 matrix
// (row stride ld) as the fragments of its four 16-deep steps.
__device__ __forceinline__ void load_a64(uint32_t (&a)[4][4], const bf16* base, int64_t ld,
                                         int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r0 + g + 8 * (i & 1), d = 16 * ks + 8 * (i >> 1) + 2 * t;
      a[ks][i] = *reinterpret_cast<const uint32_t*>(base + (int64_t)rr * ld + d);
    }
  }
}

// c (16 x 8) += a (16 x 64) . the staged rows kb .. kb + 7 of a plane, read
// as B^T (scores q k^T, dP = dctx v^T and their transposes).
__device__ __forceinline__ void rows8(float (&c)[4], const uint32_t (&a)[4][4], uint32_t plane,
                                      int kb, int lane) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    uint32_t b[4];
    ldsm_x4(b, plane + swz(kb + (lane & 7), 4 * hf + (lane >> 3)));
    mma16816(c, a[2 * hf], b[0], b[1]);
    mma16816(c, a[2 * hf + 1], b[2], b[3]);
  }
}

// acc (16 x 64, eight 16 x 8 tiles) += a (16 x 16) . the staged rows kb ..
// kb + 15 of a plane (P.V-shaped products; the plane read transposed).
__device__ __forceinline__ void cols64(float (&acc)[8][4], const uint32_t (&a)[4], uint32_t plane,
                                       int kb, int lane) {
  const int row = kb + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
  for (int dp = 0; dp < 4; ++dp) {
    uint32_t b[4];
    ldsm_x4_t(b, plane + swz(row, 2 * dp + (lane >> 4)));
    mma16816(acc[2 * dp], a, b[0], b[1]);
    mma16816(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// The sum over the warp's 16 rows of a column value held by rows g and g +
// 8: lanes 0-3 (g = 0) end with it.
__device__ __forceinline__ float col_sum16(float v) {
  v += __shfl_xor_sync(FULL, v, 4);
  v += __shfl_xor_sync(FULL, v, 8);
  v += __shfl_xor_sync(FULL, v, 16);
  return v;
}

// ---- the attention forward core ---------------------------------------------------

// A block of the attention passes holds RW groups of 16 rows times two
// halves, half 0 walking the other side's even 64-row chunks and half 1 the
// odd ones, so each warp takes half the chunks of its rows; the halves'
// partial sums meet at the end in a fixed order (half 0's, then half 1's).
// Warp w takes row group w % RW, half w / RW. The forward core and the
// query pass stage their (head, sequence)'s keys and values whole, once:
// npad rows of 128 B a plane, 256 npad bytes for two, so they walk their
// chunks with no barrier (RW = 8: 128 rows, 512 threads, one block an SM);
// the key pass streams its query chunks (bert_layer_bwd.cu). After its last
// pass each kernel reuses that memory to hand half 1's 32 fp32 accumulators
// a thread to half 0 (32 RW 32 floats, 32 KB at RW = 8), which outgrows the
// staged planes at npad = 64: core_bytes is the larger of the two.
__host__ __device__ constexpr int staged_bytes(int npad) { return npad * 2 * DH * 2; }
__host__ __device__ constexpr int core_bytes(int npad) {
  return staged_bytes(npad) > 32 * FWD_RW * 32 * 4 ? staged_bytes(npad) : 32 * FWD_RW * 32 * 4;
}

// Start cp.async copies of rows [0, rows) of 64 bf16 (row j at src + j * ld)
// into a swizzled plane, and commit them as one group.
__device__ __forceinline__ void stage_plane(uint32_t plane, const bf16* src, int64_t ld,
                                            int rows) {
  for (int i = threadIdx.x; i < rows * 8; i += blockDim.x) {
    const int j = i >> 3, ch = i & 7;
    cp_async16(plane + swz(j, ch), src + j * ld + ch * 8, 16);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// qkv [B npad, 3D] bf16 (q, k, v of head h at columns h 64, D + h 64, 2D +
// h 64); mask [B, npad] additive; ctx [B npad, D] bf16. One block per (RW
// 16 query rows, head, sequence), K and V staged whole (K first: pass 1
// starts while V arrives). After pass 1 the halves' row maxima and sums meet
// in shared memory; after pass 2 half 1 hands its o to half 0, which adds it
// and writes ctx. STATS: rowstat [B, heads, npad] float4 gets (max, 1 / sum,
// -, -) of each row and, with dropout, keep [B, heads, npad, npad / 32] the
// attention keep mask as bits (bit j % 32 of word j / 32).
template <int RW, bool STATS>
__global__ void __launch_bounds__(RW * 64, 1)
fwd_core_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask, Dropout drop,
                bf16* __restrict__ ctx, float4* __restrict__ rowstat, unsigned* __restrict__ keep,
                int n, int npad, int D, float scale) {
  extern __shared__ __align__(128) char smem[];
  __shared__ float2 xch[2][RW][16];
  const int b = blockIdx.z, h = blockIdx.y, heads = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = warp % RW, half = warp / RW;
  const int ld = 3 * D, nch = npad / KC, words = npad / 32;
  const int64_t seq0 = (int64_t)b * npad, bh = (int64_t)b * heads + h;
  const float* mrow = mask + seq0;
  const uint32_t kp = sm90::smem_u32(smem), vp = kp + npad * 128;
  stage_plane(kp, qkv + seq0 * ld + D + h * DH, ld, npad);
  stage_plane(vp, qkv + seq0 * ld + 2 * D + h * DH, ld, npad);

  // a block's last row groups may lie past npad (RW 16 does not divide it)
  const int q0 = blockIdx.x * RW * 16 + rw * 16, ra = q0 + g, rb = ra + 8;
  const bool live = q0 < npad;
  uint32_t qf[4][4];
  if (live) load_a64(qf, qkv + seq0 * ld + h * DH, ld, q0, lane);
  const bool drop_on = drop.thresh_attn != 0u;
  const int seed = drop_on ? drop.seeds[0] : 0;
  // scores of keys k0 + 8 jt ..., scaled and masked; -inf past n
  auto scores = [&](int k0, float (&sc)[8][4]) {
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      rows8(acc, qf, kp, k0 + 8 * jt, lane);
      const int key = k0 + 8 * jt + 2 * t;
      const float2 mk = *reinterpret_cast<const float2*>(mrow + key);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sc[jt][i] = key + (i & 1) < n ? acc[i] * scale + ((i & 1) ? mk.y : mk.x) : -CUDART_INF_F;
    }
  };

  asm volatile("cp.async.wait_group 1;" ::: "memory");
  __syncthreads();
  // pass 1: the running max and sum of each row over this thread's columns
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;
  for (int c = half; live && c < nch; c += 2) {
    float sc[8][4];
    scores(c * KC, sc);
    float xa = m_a, xb = m_b;
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      xa = fmaxf(xa, fmaxf(sc[jt][0], sc[jt][1]));
      xb = fmaxf(xb, fmaxf(sc[jt][2], sc[jt][3]));
    }
    // a row with no key yet keeps base 0, so no inf - inf
    const float ba = xa == -CUDART_INF_F ? 0.f : xa, bb = xb == -CUDART_INF_F ? 0.f : xb;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      sa += exp2f((sc[jt][0] - ba) * LOG2E) + exp2f((sc[jt][1] - ba) * LOG2E);
      sb += exp2f((sc[jt][2] - bb) * LOG2E) + exp2f((sc[jt][3] - bb) * LOG2E);
    }
    l_a = l_a * exp2f((m_a - ba) * LOG2E) + sa;
    l_b = l_b * exp2f((m_b - bb) * LOG2E) + sb;
    m_a = xa;
    m_b = xb;
  }
  // each half's row max and sum over its quads, then the two halves'
  auto quad = [&](float mx, float l, int r) {
    float mq = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mq = fmaxf(mq, __shfl_xor_sync(FULL, mq, 2));
    float lq = mx == -CUDART_INF_F ? 0.f : l * exp2f((mx - mq) * LOG2E);
    lq += __shfl_xor_sync(FULL, lq, 1);
    lq += __shfl_xor_sync(FULL, lq, 2);
    if (t == 0) xch[half][rw][r] = make_float2(mq, lq);
  };
  quad(m_a, l_a, g);
  quad(m_b, l_b, g + 8);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  auto meet = [&](int r, float& base, float& inv) {
    const float2 u = xch[0][rw][r], v = xch[1][rw][r];
    const float mx = fmaxf(u.x, v.x);
    const float l = (u.x == -CUDART_INF_F ? 0.f : u.y * exp2f((u.x - mx) * LOG2E)) +
                    (v.x == -CUDART_INF_F ? 0.f : v.y * exp2f((v.x - mx) * LOG2E));
    base = mx;
    inv = 1.f / l;
  };
  float base_a, inv_a, base_b, inv_b;
  meet(g, base_a, inv_a);
  meet(g + 8, base_b, inv_b);
  if (STATS && live && half == 0 && t == 0) {
    rowstat[bh * npad + ra] = make_float4(base_a, inv_a, 0.f, 0.f);
    rowstat[bh * npad + rb] = make_float4(base_b, inv_b, 0.f, 0.f);
  }

  // pass 2: p = exp(s - max) / sum, times the keep mask, rounded to bf16; P.V
  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  for (int c = half; live && c < nch; c += 2) {
    const int k0 = c * KC;
    float sc[8][4];
    scores(k0, sc);
    unsigned bits_a[2] = {0u, 0u}, bits_b[2] = {0u, 0u};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jt = 2 * ks + u, key = k0 + 8 * jt + 2 * t;
        float kf[4];
        keep_frag(kf, seed, 0u, b, b, h, ra * n + (key & ~3), rb * n + (key & ~3),
                  drop.thresh_attn, drop.scale_attn, lane);
        const float* sj = sc[jt];
        a[2 * u] = sm90::pack_bf16(exp2f((sj[0] - base_a) * LOG2E) * inv_a * kf[0],
                                   exp2f((sj[1] - base_a) * LOG2E) * inv_a * kf[1]);
        a[2 * u + 1] = sm90::pack_bf16(exp2f((sj[2] - base_b) * LOG2E) * inv_b * kf[2],
                                       exp2f((sj[3] - base_b) * LOG2E) * inv_b * kf[3]);
        if (STATS) {
          const int bit = 8 * (jt & 3) + 2 * t;
          bits_a[jt >> 2] |= (kf[0] != 0.f ? 1u << bit : 0u) | (kf[1] != 0.f ? 2u << bit : 0u);
          bits_b[jt >> 2] |= (kf[2] != 0.f ? 1u << bit : 0u) | (kf[3] != 0.f ? 2u << bit : 0u);
        }
      }
      cols64(o, a, vp, k0 + 16 * ks, lane);
    }
    if (STATS && drop_on) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        unsigned wa = bits_a[w] | __shfl_xor_sync(FULL, bits_a[w], 1);
        wa |= __shfl_xor_sync(FULL, wa, 2);
        unsigned wb = bits_b[w] | __shfl_xor_sync(FULL, bits_b[w], 1);
        wb |= __shfl_xor_sync(FULL, wb, 2);
        if (t == 0) {
          keep[(bh * npad + ra) * words + 2 * c + w] = wa;
          keep[(bh * npad + rb) * words + 2 * c + w] = wb;
        }
      }
    }
  }
  // half 1 hands its P.V sums to half 0 through the staged planes
  __syncthreads();
  float* xo = reinterpret_cast<float*>(smem);
  const int slot = rw * 32 + lane;
  if (half == 1) {
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xo[(dt * 4 + e) * RW * 32 + slot] = o[dt][e];
  }
  __syncthreads();
  if (half == 1 || !live) return;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] += xo[(dt * 4 + e) * RW * 32 + slot];
    const int col = h * DH + 8 * dt + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(ctx + (seq0 + ra) * D + col) =
        __floats2bfloat162_rn(o[dt][0], o[dt][1]);
    *reinterpret_cast<__nv_bfloat162*>(ctx + (seq0 + rb) * D + col) =
        __floats2bfloat162_rn(o[dt][2], o[dt][3]);
  }
}

// ---- LayerNorm ---------------------------------------------------------------

// y = LN(r) gamma + beta per row of D (a multiple of 4), one warp a row, four
// columns a load, in the one-pass form of pallas_bert_layer._ln_fwd; y goes
// out in fp32 (yf), bf16 (yb) or both, and (mean, rstd) to stats.
template <int Dummy = 0>
__global__ void __launch_bounds__(256)
ln_fwd_kernel(const float* __restrict__ r, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ yf, bf16* __restrict__ yb,
              float2* __restrict__ stats, int M, int D, float eps) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (m >= M) return;
  const float* row = r + (int64_t)m * D;
  float s = 0.f, s2 = 0.f;
  for (int c = 4 * lane; c < D; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    s += (v.x + v.y) + (v.z + v.w);
    s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
  }
  const float mean = sm90::warp_sum(s) / (float)D;
  const float var = sm90::warp_sum(s2) / (float)D - mean * mean;
  const float rstd = rsqrtf(fmaxf(var, 0.f) + eps);
  if (lane == 0) stats[m] = make_float2(mean, rstd);
  for (int c = 4 * lane; c < D; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    const float4 gm = *reinterpret_cast<const float4*>(gamma + c);
    const float4 bt = *reinterpret_cast<const float4*>(beta + c);
    const float4 y = make_float4(
        (v.x - mean) * rstd * gm.x + bt.x, (v.y - mean) * rstd * gm.y + bt.y,
        (v.z - mean) * rstd * gm.z + bt.z, (v.w - mean) * rstd * gm.w + bt.w);
    const int64_t off = (int64_t)m * D + c;
    if (yf != nullptr) *reinterpret_cast<float4*>(yf + off) = y;
    if (yb != nullptr) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
      *reinterpret_cast<uint2*>(yb + off) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                                       *reinterpret_cast<const unsigned*>(&hi));
    }
  }
}

// ---- one layer, forward ------------------------------------------------------

struct Weights {
  const bf16* wqkv;     // [3D, D]
  const float* bqkv;
  const bf16* wo;       // [D, D]
  const float *bo, *g1, *be1;
  const bf16* w1;       // [F, D]
  const float* b1;
  const bf16* w2;       // [D, F]
  const float *b2, *g2, *be2;
};

// The four weight matrices rounded to bf16 (round to nearest even, as
// torch's cast) in one launch, 8 elements a thread, for a call handed fp32
// matrices (the model's leaves): matrix s is n8[s] groups of 8 at src[s].
struct CastJob {
  const float* src[4];
  bf16* dst[4];
  int64_t n8[4];
};

template <int Dummy = 0>
__global__ void __launch_bounds__(256) cast_weights_kernel(const __grid_constant__ CastJob job) {
  const int64_t total = job.n8[0] + job.n8[1] + job.n8[2] + job.n8[3];
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t j = i;
    int s = 0;
    while (s < 3 && j >= job.n8[s]) j -= job.n8[s++];
    const float4 a = reinterpret_cast<const float4*>(job.src[s])[2 * j];
    const float4 b = reinterpret_cast<const float4*>(job.src[s])[2 * j + 1];
    const __nv_bfloat162 v[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                                 __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
    reinterpret_cast<uint4*>(job.dst[s])[j] = *reinterpret_cast<const uint4*>(v);
  }
}

// The chain's weights from an entry's pointers: the matrices as they are
// (bf16), or, with f32, cast into wbf16 (3D D + D D + 2 F D bf16, in the
// order wqkv, wo, w1, w2) by cast_weights_kernel first. Returns 0 or an
// error.
template <int Dummy = 0>
int chain_weights(const void* const (&p)[12], int f32, void* wbf16, int D, int F, Weights& w,
                  cudaStream_t st) {
  const bf16* mats[4] = {(const bf16*)p[0], (const bf16*)p[2], (const bf16*)p[6],
                         (const bf16*)p[8]};
  if (f32) {
    const int64_t n[4] = {3LL * D * D, (int64_t)D * D, (int64_t)F * D, (int64_t)D * F};
    CastJob job{};
    bf16* dst = static_cast<bf16*>(wbf16);
    for (int s = 0; s < 4; ++s) {
      job.src[s] = static_cast<const float*>(p[s == 0 ? 0 : s == 1 ? 2 : s == 2 ? 6 : 8]);
      job.dst[s] = dst;
      job.n8[s] = n[s] / 8;
      mats[s] = dst;
      dst += n[s];
    }
    const int64_t total = (n[0] + n[1] + n[2] + n[3]) / 8;
    const int blocks = (int)((total + 255) / 256 < 132 * 8 ? (total + 255) / 256 : 132 * 8);
    cast_weights_kernel<><<<blocks, 256, 0, st>>>(job);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  w = Weights{mats[0], (const float*)p[1], mats[1], (const float*)p[3], (const float*)p[4],
              (const float*)p[5], mats[2], (const float*)p[7], mats[3], (const float*)p[9],
              (const float*)p[10], (const float*)p[11]};
  return 0;
}

// What the forward leaves behind for the recompute backward; rowstat and
// keep (the STATS outputs of fwd_core_kernel) null in a forward alone.
struct Work {
  bf16* qkv;            // [M, 3D]
  bf16* ctx;            // [M, D]
  float* r1;            // [M, D] pre-LN1
  float2* stats1;       // [M]
  float* yf;            // [M, D] LN1 output
  bf16* yb;
  float* h1;            // [M, F] pre-GELU
  bf16* g;              // [M, F]
  float* r2;            // [M, D] pre-LN2
  float2* stats2;
  float4* rowstat;      // [B, heads, npad]
  unsigned* keep;       // [B, heads, npad, npad / 32]
};

// The streaming multiprocessors of the current device.
inline int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  return count;
}

// C [M, N] = A [M, K] . B through epi on the Hopper core: B [N, K] K-major
// (nn.Linear's (out, in): LinearPlan) or, with KN, [K, N] as it is stored
// (LinearKNPlan). A product of fewer 128 x 128 tiles than the card has SMs
// (the N = 768 products at M = 1024: 48) takes gemm64_kernel's 64-row tiles
// with the K slices split between its warpgroups. Returns 0 or an error.
template <bool KN, class Epi>
int product(const bf16* a, const bf16* b, int M, int N, int K, const Epi& epi, cudaStream_t st) {
  using namespace sm90;
  const int n_tiles = (N + BN - 1) / BN;
  const bool narrow = n_tiles * ((M + BM - 1) / BM) < sm_count();
  Maps maps{};
  int err = narrow ? map_b(&maps.m[0], a, M, K, K) : map_a(&maps.m[0], a, M, K, K);
  if (!err) err = KN ? map_mn(&maps.m[1], b, K, N, N) : map_b(&maps.m[1], b, N, K, K);
  if (err) return err;
  using Plan = std::conditional_t<KN, LinearKNPlan, LinearPlan>;
  return narrow ? launch_gemm64(maps, Plan{}, epi, n_tiles, M, K, st)
                : launch_gemm(maps, Plan{}, epi, n_tiles, M, K, st);
}

// The layer's seven launches: the QKV product (QkvEpi), the attention core,
// the out-projection (HiddenEpi, site 1), LN1, the FF's first product
// (GeluEpi), its second (HiddenEpi, site 2), LN2. The weights are
// nn.Linear's (out, in), K-major. Returns 0 or an error.
template <int Dummy = 0>
int forward_chain(const bf16* x, const float* mask, const Weights& w, const Work& ws, bf16* out,
                  const Dropout& drop, int B, int n, int npad, int D, int F, int heads, float eps,
                  float scale, cudaStream_t st) {
  const int M = B * npad;
  if (npad % KC || n > npad || n % 4 || D != heads * DH || F % 8)
    return (int)cudaErrorInvalidValue;
  int err = product<false>(x, w.wqkv, M, 3 * D, D, QkvEpi{ws.qkv, w.bqkv, M, 3 * D}, st);
  if (err) return err;
  const bool stats = ws.rowstat != nullptr;
  auto core = stats ? fwd_core_kernel<FWD_RW, true> : fwd_core_kernel<FWD_RW, false>;
  const int smem = core_bytes(npad);
  cudaFuncSetAttribute(core, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  core<<<dim3((npad + FWD_RW * 16 - 1) / (FWD_RW * 16), heads, B), FWD_RW * 64, smem, st>>>(
      ws.qkv, mask, drop, ws.ctx, ws.rowstat, ws.keep, n, npad, D, scale);
  err = (int)cudaGetLastError();
  if (!err)
    err = product<false>(ws.ctx, w.wo, M, D, D,
                         HiddenEpi{w.bo, x, nullptr, ws.r1, M, D, npad, drop.seeds, 1u,
                                   drop.thresh_hidden, drop.scale_hidden},
                         st);
  if (err) return err;
  const int ln_blocks = (M + 7) / 8;
  ln_fwd_kernel<><<<ln_blocks, 256, 0, st>>>(ws.r1, w.g1, w.be1, ws.yf, ws.yb, ws.stats1, M, D,
                                             eps);
  err = (int)cudaGetLastError();
  if (!err) err = product<false>(ws.yb, w.w1, M, F, D, GeluEpi{w.b1, ws.h1, ws.g, M, F}, st);
  if (!err)
    err = product<false>(ws.g, w.w2, M, D, F,
                         HiddenEpi{w.b2, nullptr, ws.yf, ws.r2, M, D, npad, drop.seeds, 2u,
                                   drop.thresh_hidden, drop.scale_hidden},
                         st);
  if (err) return err;
  ln_fwd_kernel<><<<ln_blocks, 256, 0, st>>>(ws.r2, w.g2, w.be2, nullptr, out, ws.stats2, M, D,
                                             eps);
  return (int)cudaGetLastError();
}

}  // namespace bh
}  // namespace ctc
