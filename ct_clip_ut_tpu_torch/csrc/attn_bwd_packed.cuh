// The temporal block's fp32 backward attention at n <= 64 (rows 8f and 8F:
// tc::block_backward_f32 without a bias, the port of
// pallas_attn_packed._bwd_kernel at fp32): ONE fused pass over whole-row
// tiles, from the planes the chain's QKV and dO products write. Per
// (sequence, head), n <= 64 tokens, a warp does
//   S = Q K^T and dP = dO V^T as three split products each (mma.sync);
//   the softmax over the whole row in fp32, P = exp2(S log2 e - m log2 e) /
//   l, as the forward core forms it;
//   D = rowsum(P dP) from that same dP, as the JAX kernel takes it
//   (pallas_attn_packed.py:357): the split products' ~2^-16 errors in dP
//   then cancel in dP - D (F8: D from o's planes is another product, and
//   lost the cancelling query / key gradients of close tokens in 12F);
//   dS = P (dP - D), dq^ = dS K with dS split, and in the train form o = P V
//   with P split (the planes of dWo = g^T o): nothing is kept from the
//   forward and no core is rerun;
//   then, per 16 keys, S^T and dP^T again from the staged planes with each
//   query's (lse, D) from the first phase, P^T, dS^T, dV = P^T dO and dk^ =
//   dS^T Q with P^T and dS^T split;
//   the scale and l2-norm backward into dq's and dk | dv's planes, and in
//   the train form the sums of u . dq^ and u . dk^ for dq_scale / dk_scale.
//
// What bounds it on the H100: bytes. The n^2 products of an IG chunk (R =
// 2880 sequences of 24, 8 heads) take ~0.015 ms at the bf16 peak; the pass
// must read q, k, v, dO as hi / lo planes, the unit rows and norms of q and
// k, and write dq's and dk | dv's planes, ~0.64 GB or ~0.19 ms at 3.35 TB/s.
// The mma.sync passes this replaces gave each (sequence, head) a block of
// two warps that staged its planes with its keys padded to 64, each pass
// forming S and dP again, after a rerun of the forward core for o and the
// row statistics. Here:
//   - one persistent block an SM of 8 warps; TMA loads, issued by one
//     thread, fill a ring of two stages paced by full / empty mbarriers, so
//     the next stage's planes are in flight while the warps compute on this
//     one;
//   - a stage holds every plane of whole (sequence, head) items
//     (PackedGeom, attn_fwd_packed.cuh): one sequence's 8 heads at n = 24
//     (96 KB), one item a warp; a plane of an item is n rows of a head's
//     64 B, one TMA box each with the 64-B swizzle (attn_mma.cuh's swz),
//     read by ldmatrix without bank conflicts; each plane is read from
//     memory once;
//   - the keys are padded only to the mma tile (16; the rows of a region
//     past n read as zeros or as the next region's finite rows, under P = 0
//     or masked), the template NP (32 or 64) bounding the row held in
//     registers;
//   - mma.sync m16n8k16 rather than wgmma: a warp owns its (sequence, head)
//     whole, needs no warpgroup's 64-row tile (two sequences block-diagonal
//     in one would double the products and the masking), and the products
//     are not what bounds the pass;
//   - every sum runs in one order (the row sums in registers over a quad,
//     dq^ over the keys, dk^ and dV over the queries, the scale sums over
//     the item's rows), no atomics: two calls give the same bits.
#pragma once

#include <algorithm>

#include "attn_fwd_packed.cuh"

namespace ctc {
namespace tc {

constexpr int PK_STAGES = 2;
constexpr int PK_STAGE_MAX = 96 * 1024;  // the planes of a stage
// an item's region holds its 8 planes in this order (hi, then lo)
constexpr int PQ = 0, PK = 2, PV = 4, PD = 6;

// The item's sums of part[] (this thread's columns 8 dt + 2 t + e) over its
// rows into out[0 .. 31]: the eight row groups of the warp by shuffles.
__device__ __forceinline__ void warp_cols_sum(float (&part)[8], float* out, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 4);
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 8);
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 16);
  }
  if (lane < 4) {
#pragma unroll
    for (int dt = 0; dt < 4; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) out[8 * dt + 2 * lane + e] = part[2 * dt + e];
  }
}

// Where an item writes: dq [2][M][HD], dkv [2][M][2 HD] (dk at columns h 32
// ..., dv at HD + h 32 ...), o [2][M][HD] (the train form; null for dx
// alone), q_part / k_part [R H][32] (null for dx alone).
struct PackedOut {
  const float *unit, *norm, *qs, *ks;
  float scale;
  bf16 *dq, *dkv, *o;
  float *q_part, *k_part;
  int keep_lo;
};

// One (sequence r, head h) from its staged region at `base`; st: the warp's
// (lse, D) of each query row.
template <int NP, bool OUT_O>
__device__ __forceinline__ void packed_item(uint32_t base, const PackedGeom& geo, int r, int h,
                                            const PackedOut& out, float2* st, int lane) {
  const int n = geo.n, H = geo.H, HD = H * DH, M = geo.R * n;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t pb = geo.plane_bytes();
  const uint32_t qh_p = base + PQ * pb, ql_p = qh_p + pb, kh_p = base + PK * pb, kl_p = kh_p + pb;
  const uint32_t vh_p = base + PV * pb, vl_p = vh_p + pb, dh_p = base + PD * pb, dl_p = dh_p + pb;
  const int64_t row0 = (int64_t)r * n, col0 = h * DH, plane = (int64_t)M * HD;
  const int keep_lo = out.keep_lo;
  float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float gain[8];
  gain_cols(gain, out.qs, out.scale, t);

  // the query rows, 16 at a time, each row whole
  for (int q0 = 0; q0 < n; q0 += 16) {
    const int ra = q0 + g, rb = ra + 8;
    const bool va = ra < n, vb = rb < n;
    const int64_t ma = row0 + (va ? ra : 0), mb = row0 + (vb ? rb : 0);
    UnitRows u;
    load_unit_rows(u, out.unit + ma * HD + col0, out.unit + mb * HD + col0,
                   out.norm + ma * H + h, out.norm + mb * H + h, va, vb, t);
    uint32_t qh[2][4], ql[2][4], dh[2][4], dl[2][4];
    ldsm_rows(qh, qh_p, q0, va, vb, lane);
    ldsm_rows(ql, ql_p, q0, va, vb, lane);
    ldsm_rows(dh, dh_p, q0, va, vb, lane);
    ldsm_rows(dl, dl_p, q0, va, vb, lane);
    float s[NP / 8][4], dp[NP / 8][4];
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
      if (8 * j < n) {
        split_scores(s[j], qh, ql, kh_p, kl_p, 8 * j, lane);
        split_scores(dp[j], dh, dl, vh_p, vl_p, 8 * j, lane);
      }
    }
    // the softmax over the row's n keys (a quad of threads holds a row)
    float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + 2 * t + e < n) {
          mx_a = fmaxf(mx_a, s[j][e]);
          mx_b = fmaxf(mx_b, s[j][2 + e]);
        }
    const float base_a = quad_max(mx_a) * LOG2E, base_b = quad_max(mx_b) * LOG2E;
    float l_a = 0.f, l_b = 0.f;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = 8 * j + 2 * t + e < n;
        s[j][e] = in ? exp2f(s[j][e] * LOG2E - base_a) : 0.f;
        s[j][2 + e] = in ? exp2f(s[j][2 + e] * LOG2E - base_b) : 0.f;
        l_a += s[j][e];
        l_b += s[j][2 + e];
      }
    const float inv_a = 1.f / quad_sum(l_a), inv_b = 1.f / quad_sum(l_b);
    // P, then D = rowsum(P dP) from the same dP, then dS = P (dP - D) in dp
    float d_a = 0.f, d_b = 0.f;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] *= inv_a;
        s[j][2 + e] *= inv_b;
        d_a += s[j][e] * dp[j][e];
        d_b += s[j][2 + e] * dp[j][2 + e];
      }
    d_a = quad_sum(d_a);
    d_b = quad_sum(d_b);
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[j][e] = s[j][e] * (dp[j][e] - d_a);
        dp[j][2 + e] = s[j][2 + e] * (dp[j][2 + e] - d_b);
      }
    // dq^ = dS K (and o = P V), 16 keys a step, dS and P split
    float acc[4][4], oacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = oacc[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks) {
      if (16 * ks >= n) continue;
      uint32_t ah[4], al[4];
      split_frag(dp[2 * ks], keep_lo, ah[0], ah[1], al[0], al[1]);
      split_frag(dp[2 * ks + 1], keep_lo, ah[2], ah[3], al[2], al[3]);
      col_products(acc, al, kh_p, 16 * ks, lane);
      col_products(acc, ah, kl_p, 16 * ks, lane);
      col_products(acc, ah, kh_p, 16 * ks, lane);
      if constexpr (OUT_O) {
        split_frag(s[2 * ks], keep_lo, ah[0], ah[1], al[0], al[1]);
        split_frag(s[2 * ks + 1], keep_lo, ah[2], ah[3], al[2], al[3]);
        col_products(oacc, al, vh_p, 16 * ks, lane);
        col_products(oacc, ah, vl_p, 16 * ks, lane);
        col_products(oacc, ah, vh_p, 16 * ks, lane);
      }
    }
    l2norm_bwd_rows(acc, u, va, vb, gain, out.dq + ma * HD + col0, out.dq + mb * HD + col0,
                    plane, keep_lo, t, part);
    if constexpr (OUT_O) {
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        const int64_t col = col0 + 8 * dt + 2 * t;
        __nv_bfloat162 hv, lv;
        if (va) {
          sm90::split2(oacc[dt][0], oacc[dt][1], keep_lo, hv, lv);
          *reinterpret_cast<__nv_bfloat162*>(out.o + ma * HD + col) = hv;
          *reinterpret_cast<__nv_bfloat162*>(out.o + plane + ma * HD + col) = lv;
        }
        if (vb) {
          sm90::split2(oacc[dt][2], oacc[dt][3], keep_lo, hv, lv);
          *reinterpret_cast<__nv_bfloat162*>(out.o + mb * HD + col) = hv;
          *reinterpret_cast<__nv_bfloat162*>(out.o + plane + mb * HD + col) = lv;
        }
      }
    }
    // each query's (lse, D) for the key phase; rows past n: P^T and dS^T 0
    if (t == 0) {
      st[ra] = va ? make_float2(base_a - log2f(inv_a), d_a) : make_float2(CUDART_INF_F, 0.f);
      st[rb] = vb ? make_float2(base_b - log2f(inv_b), d_b) : make_float2(CUDART_INF_F, 0.f);
    }
  }
  if (out.q_part != nullptr)
    warp_cols_sum(part, out.q_part + ((int64_t)r * H + h) * DH, lane);
  __syncwarp();

  // the key rows, 16 at a time: dV = P^T dO and dk^ = dS^T Q over the queries
#pragma unroll
  for (int i = 0; i < 8; ++i) part[i] = 0.f;
  gain_cols(gain, out.ks, 1.f, t);
  const int64_t HD2 = 2 * (int64_t)HD;
  for (int k0 = 0; k0 < n; k0 += 16) {
    const int ka = k0 + g, kb = ka + 8;
    const bool va = ka < n, vb = kb < n;
    const int64_t ma = row0 + (va ? ka : 0), mb = row0 + (vb ? kb : 0);
    UnitRows u;
    load_unit_rows(u, out.unit + plane + ma * HD + col0, out.unit + plane + mb * HD + col0,
                   out.norm + (int64_t)M * H + ma * H + h, out.norm + (int64_t)M * H + mb * H + h,
                   va, vb, t);
    uint32_t kh[2][4], kl[2][4], vh[2][4], vl[2][4];
    ldsm_rows(kh, kh_p, k0, va, vb, lane);
    ldsm_rows(kl, kl_p, k0, va, vb, lane);
    ldsm_rows(vh, vh_p, k0, va, vb, lane);
    ldsm_rows(vl, vl_p, k0, va, vb, lane);
    float dk[4][4], dv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
#pragma unroll
    for (int qs = 0; qs < NP / 16; ++qs) {
      if (16 * qs >= n) continue;
      uint32_t ph[4], pl[4], sh[4], sl[4];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int qb = 16 * qs + 8 * w, qi = qb + 2 * t;
        float sc[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f}, p[4], ds[4];
        if (qb < n) {
          split_scores(sc, kh, kl, qh_p, ql_p, qb, lane);
          split_scores(dpt, vh, vl, dh_p, dl_p, qb, lane);
        }
        const float2 s0 = st[qi], s1 = st[qi + 1];   // queries qi, qi + 1
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2& sq = (i & 1) ? s1 : s0;
          p[i] = exp2f(sc[i] * LOG2E - sq.x);
          ds[i] = p[i] * (dpt[i] - sq.y);
        }
        split_frag(p, keep_lo, ph[2 * w], ph[2 * w + 1], pl[2 * w], pl[2 * w + 1]);
        split_frag(ds, keep_lo, sh[2 * w], sh[2 * w + 1], sl[2 * w], sl[2 * w + 1]);
      }
      col_products(dv, pl, dh_p, 16 * qs, lane);
      col_products(dv, ph, dl_p, 16 * qs, lane);
      col_products(dv, ph, dh_p, 16 * qs, lane);
      col_products(dk, sl, qh_p, 16 * qs, lane);
      col_products(dk, sh, ql_p, 16 * qs, lane);
      col_products(dk, sh, qh_p, 16 * qs, lane);
    }
    l2norm_bwd_rows(dk, u, va, vb, gain, out.dkv + ma * HD2 + col0, out.dkv + mb * HD2 + col0,
                    2 * plane, keep_lo, t, part);
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      const int64_t col = HD + col0 + 8 * dt + 2 * t;
      __nv_bfloat162 h2, l2;
      if (va) {
        sm90::split2(dv[dt][0], dv[dt][1], keep_lo, h2, l2);
        *reinterpret_cast<__nv_bfloat162*>(out.dkv + ma * HD2 + col) = h2;
        *reinterpret_cast<__nv_bfloat162*>(out.dkv + 2 * plane + ma * HD2 + col) = l2;
      }
      if (vb) {
        sm90::split2(dv[dt][2], dv[dt][3], keep_lo, h2, l2);
        *reinterpret_cast<__nv_bfloat162*>(out.dkv + mb * HD2 + col) = h2;
        *reinterpret_cast<__nv_bfloat162*>(out.dkv + 2 * plane + mb * HD2 + col) = l2;
      }
    }
  }
  if (out.k_part != nullptr)
    warp_cols_sum(part, out.k_part + ((int64_t)r * H + h) * DH, lane);
  __syncwarp();
}

// The pass: maps 0-7 q_hi, q_lo, k_hi, k_lo, v_hi, v_lo, dO_hi, dO_lo ([M,
// HD] bf16, boxes of 32 columns x n rows, 64-B swizzle). A persistent block
// walks units u = blockIdx.x, + gridDim.x, ... (a unit: g sequences x hg
// heads, one stage); warp w takes the unit's items w, w + 8, .... Thread 0
// loads the first two units; after each unit it waits for the eight warps
// to leave the stage (its empty barrier) and loads the unit two ahead into
// it, while the other warps go on with the next stage. No producer warp: a
// ninth warp would put three warps on one of the SM's four register files
// and cap every thread at 168 registers (the first build spilled there).
template <int NP, bool OUT_O>
__global__ void __launch_bounds__(PK_THREADS, 1)
bwd_packed_f32_kernel(const __grid_constant__ sm90::MapsN<8> maps, const PackedGeom geo,
                      const PackedOut out) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[PK_STAGES], empty[PK_STAGES];
  __shared__ float2 stats[PK_WARPS][PK_MAX_N];
  char* const ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const int stage_bytes = geo.stage_bytes();
  const int groups = geo.H / geo.hg;
  // a region's rows past n are never loaded: they, and the rows past the
  // ring, read as zeros
  for (int i = threadIdx.x; i < (PK_STAGES * stage_bytes + PK_SPILL) / 16; i += blockDim.x)
    reinterpret_cast<int4*>(ring)[i] = make_int4(0, 0, 0, 0);
  // the planes of unit u into stage s
  auto load = [&](int u, int s) {
    const int r0 = (u / groups) * geo.g, h0 = (u % groups) * geo.hg;
    const int items = min(geo.g, geo.R - r0) * geo.hg;
    sm90::mbar_expect_tx(&full[s], items * 8 * geo.n * DH * 2);
    char* stg = ring + s * stage_bytes;
    for (int it = 0; it < items; ++it) {
      const int r = r0 + it / geo.hg, h = h0 + it % geo.hg;
#pragma unroll
      for (int p = 0; p < 8; ++p)
        sm90::tma_load_2d(stg + (it * 8 + p) * geo.plane_bytes(), &maps.m[p], &full[s], h * DH,
                          r * geo.n);
    }
  };
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < PK_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], PK_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // the zeros above before any TMA write
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int s = 0; s < PK_STAGES && blockIdx.x + s * gridDim.x < geo.units; ++s)
      load(blockIdx.x + s * gridDim.x, s);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int i = 0;
  for (int u = blockIdx.x; u < geo.units; u += gridDim.x, ++i) {
    const int s = i % PK_STAGES;
    sm90::mbar_wait(&full[s], (i / PK_STAGES) & 1);
    const int r0 = (u / groups) * geo.g, h0 = (u % groups) * geo.hg;
    const int items = min(geo.g, geo.R - r0) * geo.hg;
    const uint32_t stg = sm90::smem_u32(ring + s * stage_bytes);
    for (int it = warp; it < items; it += PK_WARPS)
      packed_item<NP, OUT_O>(stg + it * geo.item_bytes(), geo, r0 + it / geo.hg,
                             h0 + it % geo.hg, out, stats[warp], lane);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
    const int next = u + PK_STAGES * gridDim.x;
    if (threadIdx.x == 0 && next < geo.units) {
      sm90::mbar_wait(&empty[s], (i / PK_STAGES) & 1);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load(next, s);
    }
    __syncwarp();
  }
}

// Launch the fused pass over R sequences of n <= PK_MAX_N tokens, H heads:
// qk [4][M][HD], v and dO [2][M][HD] (hi, lo); unit [2][M][HD], norm
// [2][M][H] fp32; out.dq [2][M][HD], out.dkv [2][M][2 HD], out.o [2][M][HD]
// or null, out.q_part / k_part [R H][32] or null. One block an SM, or one a
// unit where there are fewer.
template <int Dummy = 0>
int launch_packed_pass(const bf16* qk, const bf16* v, const bf16* dO, const PackedOut& out,
                       int R, int n, int H, cudaStream_t st) {
  const int M = R * n, HD = H * DH;
  const size_t plane = (size_t)M * HD;
  sm90::MapsN<8> maps{};
  const bf16* const src[8] = {qk, qk + plane, qk + 2 * plane, qk + 3 * plane,
                              v,  v + plane,  dO,             dO + plane};
  int err = 0;
  for (int p = 0; p < 8 && !err; ++p) err = map_sw64(&maps.m[p], src[p], M, HD, HD, n);
  if (err) return err;
  const PackedGeom geo = packed_geom(R, n, H, 8, PK_STAGE_MAX);
  const int smem = PK_STAGES * geo.stage_bytes() + PK_SPILL + 1024;
  const bool with_o = out.o != nullptr;
  auto kern = n <= 32 ? (with_o ? bwd_packed_f32_kernel<32, true> : bwd_packed_f32_kernel<32, false>)
                      : (with_o ? bwd_packed_f32_kernel<64, true> : bwd_packed_f32_kernel<64, false>);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<std::min(geo.units, sm90::sm_count()), PK_THREADS, smem, st>>>(maps, geo, out);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace ctc
