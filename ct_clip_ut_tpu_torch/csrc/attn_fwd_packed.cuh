// The fp32 block forward (tc::block_forward_f32, the chain of rows 1f and
// 2f: ctc_attn_block_f32, ctc_attn_packed_f32) and its attention core at
// n <= 64 without a bias (row 2f's: the CT-ViT temporal stack, n = 24), the
// port of pallas_attn_packed._forward at fp32.
//
// The core over whole (sequence, head) items, the forward counterpart of
// the fused temporal backward (attn_bwd_packed.cuh). Per item, a warp
// takes the query rows 16 at a time, each row whole:
//   S = Q K^T as three split products (mma.sync), q and k as the hi / lo
//   planes the QKV product writes (l2-normed and scaled);
//   the softmax over the row's n keys in fp32, P = exp2(S log2 e - m log2
//   e) / l;
//   o = P V with P split in registers (p_lo v_hi + p_hi v_lo + p_hi v_hi,
//   the order of the two-pass core), written as hi / lo planes.
// What bounds it on the H100: bytes. At an occlusion chunk (R = 4608
// sequences of 24, 8 heads) the n^2 products are ~0.01 ms at the bf16
// peak; the core must read q, k, v as hi / lo planes and write o's, ~453
// MB or ~0.135 ms at 3.35 TB/s. The two-pass core gave each (sequence,
// head) a block of two warps that staged its keys padded to 64 with
// cp.async and formed S twice (once for the row statistics, once for P).
// Here:
//   - one persistent block an SM of 8 warps; thread 0 issues the TMA loads
//     into a ring of FK_STAGES stages paced by full / empty mbarriers, so
//     two stages' planes are in flight while the warps compute on a third;
//   - a stage holds the 6 planes of whole items (one sequence's 8 heads at
//     n = 24: 72 KB), one item a warp, each plane read from memory once;
//     a plane of a sequence's heads is one 3-D TMA box (32 columns x nr
//     rows x hg heads, 64-B swizzle), so a stage takes 6 loads, not 48;
//   - keys padded only to the mma tile (16), the row held in registers
//     (NP 32 or 64), S formed once;
//   - no statistics are written: the temporal backward (the fused pass)
//     forms its own from q, k, v and dO.
// n > 64 and the biased spatial core (row 1f, n = 576) keep the two-pass
// core (attn_mma.cuh). Every sum runs in one order: two calls give the
// same bits.
#pragma once

#include <algorithm>

#include "attn_bwd_wg.cuh"
#include "wgrad_sm90.cuh"

namespace ctc {
namespace tc {

constexpr int PK_MAX_N = 64;             // the longest sequence the whole-item passes take
constexpr int PK_WARPS = 8;              // a block's warps, one item at a time each
constexpr int PK_THREADS = PK_WARPS * 32;
constexpr int PK_SPILL = 1024;           // zeros past the ring: rows read past its last region
constexpr int FK_STAGES = 3;             // the forward core's ring
constexpr int FK_STAGE_MAX = 72 * 1024;  // the planes of one of its stages

// The stages of the whole-item passes: items are (sequence, head); a stage
// holds g sequences x hg heads; each item's region is `planes` planes of nr
// rows (n up to a multiple of 8, so each plane starts on the 64-B
// swizzle's 512-B period) of 64 B (the forward core lays a stage out plane
// by plane instead: [g][planes][hg][nr rows]).
struct PackedGeom {
  int R, n, H, nr, hg, g, units, planes;
  __host__ __device__ int plane_bytes() const { return nr * DH * 2; }
  __host__ __device__ int item_bytes() const { return planes * plane_bytes(); }
  __host__ __device__ int stage_bytes() const { return g * hg * item_bytes(); }
};

// As many heads of a sequence a stage as stage_max holds (halving H), then
// as many sequences as give each warp an item.
inline PackedGeom packed_geom(int R, int n, int H, int planes, int stage_max) {
  PackedGeom p{R, n, H, (n + 7) / 8 * 8, H, 1, 0, planes};
  while (p.hg % 2 == 0 && p.hg * p.item_bytes() > stage_max) p.hg /= 2;
  p.g = std::max(1, std::min(stage_max / (p.hg * p.item_bytes()),
                             (PK_WARPS + p.hg - 1) / p.hg));
  p.units = (R + p.g - 1) / p.g * (H / p.hg);
  return p;
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The map of an [M, H * 32] bf16 plane read as [H][M][32] (a head's 32
// columns innermost, then the rows, then the heads: strides 2 H 32 B and 64
// B), in boxes of 32 columns x box_rows rows x box_heads heads with the
// 64-B swizzle, zeros past the rows: a box lands as box_heads head planes
// of box_rows rows of 64 B. Returns 0 or an sm90 ERR_ code.
inline int map_heads(CUtensorMap* map, const void* ptr, int rows, int heads, int box_rows,
                     int box_heads) {
  sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return sm90::ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)DH, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)heads * DH * 2, (cuuint64_t)DH * 2};
  const cuuint32_t box[3] = {(cuuint32_t)DH, (cuuint32_t)box_rows, (cuuint32_t)box_heads};
  const cuuint32_t estrides[3] = {1, 1, 1};
  CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                    strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : sm90::ERR_MAP;
}

// The A fragments of rows r0 .. r0 + 15 of a staged plane, rows past the
// sequence (a: g, b: g + 8) zeroed: their scores and gradients stay finite
// whatever the region's rows past n hold.
__device__ __forceinline__ void ldsm_rows(uint32_t (&a)[2][4], uint32_t plane, int r0, bool va,
                                          bool vb, int lane) {
  ldsm_a(a, plane, r0, lane);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if (!va) a[ks][0] = a[ks][2] = 0u;
    if (!vb) a[ks][1] = a[ks][3] = 0u;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One (sequence r, head h) of the forward core from its staged planes q_hi,
// q_lo, k_hi, k_lo, v_hi, v_lo at base, base + ps, ... (rows past n hold the
// next sequence's rows or zeros): o's planes [2][M][HD].
template <int NP>
__device__ __forceinline__ void fwd_item(uint32_t base, uint32_t ps, const PackedGeom& geo, int r,
                                         int h, bf16* o, int keep_lo, int lane) {
  const int n = geo.n, HD = geo.H * DH;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t qh_p = base, ql_p = base + ps, kh_p = base + 2 * ps, kl_p = base + 3 * ps;
  const uint32_t vh_p = base + 4 * ps, vl_p = base + 5 * ps;
  const int64_t row0 = (int64_t)r * n, col0 = h * DH, plane = (int64_t)geo.R * n * HD;
  for (int q0 = 0; q0 < n; q0 += 16) {
    const int ra = q0 + g, rb = ra + 8;
    const bool va = ra < n, vb = rb < n;
    uint32_t qh[2][4], ql[2][4];
    ldsm_rows(qh, qh_p, q0, va, vb, lane);
    ldsm_rows(ql, ql_p, q0, va, vb, lane);
    float s[NP / 8][4];
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
      if (8 * j < n) split_scores(s[j], qh, ql, kh_p, kl_p, 8 * j, lane);
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
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] *= inv_a;
        s[j][2 + e] *= inv_b;
      }
    // o = P V, 16 keys a step, P split
    float oacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks) {
      if (16 * ks >= n) continue;
      uint32_t ah[4], al[4];
      split_frag(s[2 * ks], keep_lo, ah[0], ah[1], al[0], al[1]);
      split_frag(s[2 * ks + 1], keep_lo, ah[2], ah[3], al[2], al[3]);
      col_products(oacc, al, vh_p, 16 * ks, lane);
      col_products(oacc, ah, vl_p, 16 * ks, lane);
      col_products(oacc, ah, vh_p, 16 * ks, lane);
    }
    const int64_t ma = row0 + (va ? ra : 0), mb = row0 + (vb ? rb : 0);
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      const int64_t col = col0 + 8 * dt + 2 * t;
      __nv_bfloat162 hv, lv;
      if (va) {
        sm90::split2(oacc[dt][0], oacc[dt][1], keep_lo, hv, lv);
        *reinterpret_cast<__nv_bfloat162*>(o + ma * HD + col) = hv;
        *reinterpret_cast<__nv_bfloat162*>(o + plane + ma * HD + col) = lv;
      }
      if (vb) {
        sm90::split2(oacc[dt][2], oacc[dt][3], keep_lo, hv, lv);
        *reinterpret_cast<__nv_bfloat162*>(o + mb * HD + col) = hv;
        *reinterpret_cast<__nv_bfloat162*>(o + plane + mb * HD + col) = lv;
      }
    }
  }
}

// The core: maps 0-5 q_hi, q_lo, k_hi, k_lo, v_hi, v_lo (map_heads: [M, HD]
// bf16 as [H][M][32], boxes of 32 columns x nr rows x hg heads, 64-B
// swizzle; a stage holds plane p of sequence i's head hh at ((i 6 + p) hg
// + hh) plane_bytes). A persistent block walks
// units u = blockIdx.x, + gridDim.x, ... (a unit: g sequences x hg heads,
// one stage); warp w takes the unit's items w, w + 8, .... Thread 0 loads
// the first FK_STAGES units; after each unit it waits for the eight warps
// to leave the stage (its empty barrier) and loads the unit FK_STAGES
// ahead into it, while the other warps go on with the next stage (no
// producer warp, as in the backward's pass).
template <int NP>
__global__ void __launch_bounds__(PK_THREADS, 1)
fwd_packed_f32_kernel(const __grid_constant__ sm90::MapsN<6> maps, const PackedGeom geo,
                      bf16* __restrict__ o, int keep_lo) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[FK_STAGES], empty[FK_STAGES];
  char* const ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const int stage_bytes = geo.stage_bytes();
  const int groups = geo.H / geo.hg;
  // the rows past the ring read as zeros
  for (int i = threadIdx.x; i < (FK_STAGES * stage_bytes + PK_SPILL) / 16; i += blockDim.x)
    reinterpret_cast<int4*>(ring)[i] = make_int4(0, 0, 0, 0);
  const int box_bytes = geo.hg * geo.plane_bytes();
  // the planes of unit u into stage s: one box a plane and sequence
  auto load = [&](int u, int s) {
    const int r0 = (u / groups) * geo.g, h0 = (u % groups) * geo.hg;
    const int seqs = min(geo.g, geo.R - r0);
    sm90::mbar_expect_tx(&full[s], seqs * 6 * box_bytes);
    char* stg = ring + s * stage_bytes;
    for (int i = 0; i < seqs; ++i)
#pragma unroll
      for (int p = 0; p < 6; ++p)
        tma_load_3d(stg + (i * 6 + p) * box_bytes, &maps.m[p], &full[s], 0, (r0 + i) * geo.n,
                    h0);
  };
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < FK_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], PK_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // the zeros above before any TMA write
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int s = 0; s < FK_STAGES && blockIdx.x + s * gridDim.x < geo.units; ++s)
      load(blockIdx.x + s * gridDim.x, s);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int i = 0;
  for (int u = blockIdx.x; u < geo.units; u += gridDim.x, ++i) {
    const int s = i % FK_STAGES;
    sm90::mbar_wait(&full[s], (i / FK_STAGES) & 1);
    const int r0 = (u / groups) * geo.g, h0 = (u % groups) * geo.hg;
    const int items = min(geo.g, geo.R - r0) * geo.hg;
    const uint32_t stg = sm90::smem_u32(ring + s * stage_bytes);
    for (int it = warp; it < items; it += PK_WARPS)
      fwd_item<NP>(stg + ((it / geo.hg) * 6 * geo.hg + it % geo.hg) * geo.plane_bytes(),
                   box_bytes, geo, r0 + it / geo.hg, h0 + it % geo.hg, o, keep_lo, lane);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
    const int next = u + FK_STAGES * gridDim.x;
    if (threadIdx.x == 0 && next < geo.units) {
      sm90::mbar_wait(&empty[s], (i / FK_STAGES) & 1);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load(next, s);
    }
    __syncwarp();
  }
}

// Launch the forward core over R sequences of n <= PK_MAX_N tokens, H
// heads: qk [4][M][HD] (q_hi, q_lo, k_hi, k_lo), v and o [2][M][HD] (hi,
// lo). One block an SM, or one a unit where there are fewer.
template <int Dummy = 0>
int launch_packed_fwd(const bf16* qk, const bf16* v, bf16* o, int R, int n, int H, int keep_lo,
                      cudaStream_t st) {
  const int M = R * n, HD = H * DH;
  const size_t plane = (size_t)M * HD;
  sm90::MapsN<6> maps{};
  const bf16* const src[6] = {qk, qk + plane, qk + 2 * plane, qk + 3 * plane, v, v + plane};
  int err = 0;
  const PackedGeom geo = packed_geom(R, n, H, 6, FK_STAGE_MAX);
  for (int p = 0; p < 6 && !err; ++p) err = map_heads(&maps.m[p], src[p], M, H, geo.nr, geo.hg);
  if (err) return err;
  const int smem = FK_STAGES * geo.stage_bytes() + PK_SPILL + 1024;
  auto kern = n <= 32 ? fwd_packed_f32_kernel<32> : fwd_packed_f32_kernel<64>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kern<<<std::min(geo.units, sm90::sm_count()), PK_THREADS, smem, st>>>(maps, geo, o, keep_lo);
  return (int)cudaGetLastError();
}

// ---- the block forward in fp32 ---------------------------------------------------

// The block's forward in fp32, the chain of the fp32 variants of
// attn_block.cu / attn_packed.cu: every fp32 product as three bf16 products
// of hi / lo planes (split_sm90.cuh). Launches: the weights' split pass
// (wq | wk | wv stacked, wo); ln_split_kernel writing xn's and x's planes;
// the q | k | v product (QkvSplitPlan on split4_kernel: each K slice's four
// planes staged once), QkvEpi writing q / k (l2-normed, scaled) and v as
// hi / lo planes; the core writing o's planes (split scores, split P.V):
// without a bias at n <= PK_MAX_N the whole-item core above, else the
// two-pass core (attn_mma.cuh); the output projection (SplitPlan on
// split4_kernel) writing o Wo^T (+ x) in fp32. x [R*n, D] fp32 (D a
// multiple of 8); gamma [D], qs / ks [32], wq / wk / wv [HD, D], wo [D, HD]
// fp32; bias [H][n][n] fp32 or null; workspaces xs [4][R*n][D] (xn_hi,
// xn_lo, x_hi, x_lo), w_s [2][3 HD][D], wo_s [2][D][HD], qk [4][R*n][HD],
// v_ws / o_ws [2][R*n][HD] bf16; out [R*n, D] fp32. keep_lo 0 zeroes every
// lo plane (the one-pass control). mld [R][H][n] float4 or null: the
// two-pass core also writes each row's (m log2 e, 1 / l, 0, 0), which with
// o's planes the spatial backward (attn_bwd_wg.cuh) takes in place of
// rerunning the core. The LN pass stays a launch of its own: the QKV
// product reads x's planes as they are, through TMA.
template <int Dummy = 0>
int block_forward_f32(const float* x, const float* gamma, const float* wq, const float* wk,
                      const float* wv, const float* wo, const float* qs, const float* ks,
                      const float* bias, bf16* xs, bf16* w_s, bf16* wo_s, bf16* qk, bf16* v_ws,
                      bf16* o_ws, float4* mld, float* out, int R, int n, int D, int H,
                      float scale, int residual, int keep_lo, cudaStream_t st) {
  using namespace sm90;
  const int M = R * n, HD = H * DH, tiles = HD / BN;
  const int64_t md = (int64_t)M * D, wsz = (int64_t)HD * D, wrows = 3 * wsz, mh = (int64_t)M * HD;
  Maps proj{};
  int err = map_a(&proj.m[0], xs, M, D, D);
  if (!err) err = map_a(&proj.m[1], xs + md, M, D, D);
  if (!err) err = map_a(&proj.m[2], xs + 2 * md, M, D, D);
  if (!err) err = map_a(&proj.m[3], xs + 3 * md, M, D, D);
  if (!err) err = map_b(&proj.m[4], w_s, 3 * HD, D, D);
  if (!err) err = map_b(&proj.m[5], w_s + wrows, 3 * HD, D, D);
  if (err) return err;
  const float* const w3[3] = {wq, wk, wv};
  for (int i = 0; i < 3 && !err; ++i)
    err = split_to(w3[i], w_s + i * wsz, w_s + wrows + i * wsz, wsz, keep_lo, st);
  if (!err) err = split(wo, wo_s, wsz, keep_lo, st);
  if (!err)
    err = launch_ln_split(x, gamma, nullptr, nullptr, xs, xs + md, xs + 2 * md, xs + 3 * md, M, D,
                          1e-5f, keep_lo, st);
  if (err) return err;
  err = launch_split4<false>(proj, QkvSplitPlan{tiles},
                      QkvEpi{qk, v_ws, qs, ks, scale, M, HD, tiles, nullptr, nullptr, v_ws + mh,
                             keep_lo},
                      3 * tiles, M, D, st);
  if (err) return err;
  if (bias == nullptr && mld == nullptr && n <= PK_MAX_N)
    err = launch_packed_fwd(qk, v_ws, o_ws, R, n, H, keep_lo, st);
  else
    err = mld != nullptr ? launch_block_core<true, true>(qk, v_ws, bias, o_ws, R, n, H, mld,
                                                         nullptr, st, keep_lo)
                         : launch_block_core<false, true>(qk, v_ws, bias, o_ws, R, n, H, nullptr,
                                                          nullptr, st, keep_lo);
  if (err) return err;
  return split4_product<false>(o_ws, o_ws + mh, HD, wo_s, wo_s + wsz, HD, M, D, HD,
                        F32OutEpi{out, nullptr, residual ? x : nullptr, M, D}, st);
}

}  // namespace tc
}  // namespace ctc
