// The cosine-attention block's backward in fp32, shared by
// attn_block_bwd_f32.cu (spatial, with a position bias) and
// attn_packed_bwd_f32.cu (temporal, no bias): the port of
// pallas_attn_block._backward_impl / pallas_attn_packed._backward_impl at
// fp32 (where their rounding points are identities). Two forms: the data
// gradient alone, for the gradient attribution methods (they differentiate
// with respect to activations and patches), and with every parameter
// gradient, for the fp32 train step (TrainConfig(compute_dtype="float32")).
//
// Given x [R*n, D] fp32, the block's weights and the output cotangent g, it
// recomputes the forward and returns dx (+ g under `residual`) and, in the
// train step's form, dgamma, dWq, dWk, dWv, dWo, dq_scale, dk_scale and
// (with a bias) dbias [H, n, n] summed over the R sequences. Every fp32
// product is three bf16 products of hi / lo planes (a_hi b_hi + a_lo b_hi +
// a_hi b_lo, within ~2^-16 of fp32): the GEMMs as SplitPlan / SplitKNPlan on
// the Hopper core (split_sm90.cuh), the attention passes on split operands
// (the spatial block's on wgmma, attn_bwd_wg.cuh; the temporal block's at n
// <= 64 one fused mma.sync pass, attn_bwd_packed.cuh), the weight gradients
// as one three-pass launch of wgrad_sm90.cuh (BlockWgradSplitPlan) over
// the planes the dx chain writes, its tokens split into chunks.
//
// What bounds it on the H100: operations, three bf16 products for each
// fp32 one. The function's products: the projections q, k, v, dO, dxn
// (2 M D HD each), dx_direct (2 M D 2 HD) and the weight gradients dWq,
// dWk | dWv, dWo (2 M D HD each, 4 in all), and per (sequence, head) S,
// P.V (o, for dWo), dP, dS.K, dS^T.Q, P^T.dO (2 n^2 32 each). The passes
// take four more n^2 products than that (the row term's walk and the key
// pass S and dP again), the dbias pass S and dP again, and the statistics
// pass S twice. The temporal fused pass is bound by bytes (its
// header). Launches:
//
//   split_kernel x 4      the planes of wq | wk | wv (stacked [3 HD, D]) and
//                         wo
//   ln_split_kernel       xn's, x's and g's planes
//   split4_kernel         q, k, v (QkvSplitPlan, tc::QkvEpi: q / k
//                         l2-normed and scaled as hi / lo planes, their unit
//                         rows and norms in fp32, v as planes), the forward
//                         chain's product (attn_fwd_packed.cuh): the same
//                         bits, so o and the statistics the forward keeps
//                         are those a rerun of the core gives
//   gemm_kernel           dO = g Wo as planes (SplitKNPlan: Wo as stored)
// the spatial block (with a bias), and the temporal block above n = 64:
//   block_core_kernel     the fp32 core with STATS: o as planes and each
//                         row's (m log2 e, 1 / l); the spatial block skips it
//                         when the forward kept both (`saved`)
//   transpose_kernel      (with a bias) the bias transposed per head
//   bwd_dq_wg_kernel      (ROWTERM) the row term's walk, the same blocks and
//                         tiles as the query pass: S, dP, P, D = c +
//                         rowsum(P (dP - c)) / rowsum(P) from the same split
//                         dP (c the row's dP at key 0), written into mld
//                         with lse (F11)
//   bwd_dq_wg_kernel      per (sequence, 64-query tile, head), the key tiles
//                         streamed: P, dP = dO V^T, dS = P (dP - D), dq^ =
//                         dS K, the scale and
//                         l2-norm backward -> dq planes; in the train form
//                         also the block's sum of u_q . dq^ per column
//                         (dq_scale)
//   bwd_dkv_wg_kernel     per (sequence, 64-key tile, head), the query tiles
//                         streamed with their (lse, D): S^T, dP^T = V dO^T,
//                         dS^T, dV = P^T dO, dk^ = dS^T Q, the l2-norm
//                         backward -> dk | dv planes (and the block's u_k .
//                         dk^ sums)
//   bwd_dbias_f32_kernel  (train form, with a bias) per (64-query tile,
//                         64-key chunk, head): S and dP recomputed from the
//                         split planes for every sequence in turn through a
//                         two-stage cp.async ring, fp32 dS summed in
//                         registers over the R sequences and written once
// the temporal block at n <= 64 (no bias):
//   bwd_packed_f32_kernel one persistent block an SM over whole (sequence,
//                         head) rows: S, dP, P, D = rowsum(P dP), dS, dq^,
//                         (train form) o's planes, then dV and dk^; the
//                         l2-norm backward -> dq and dk | dv planes (and each
//                         item's u . dq^, u . dk^ sums); no core, nothing
//                         kept from the forward
// both:
//   gemm_kernel x 2       dxn = dq Wq, dx_direct = [dk | dv] [Wk; Wv] (fp32;
//                         SplitKNPlan over the stacked weight planes)
//   ln_bwd_f32_kernel     dx = LN'(dxn) + dx_direct (+ g); in the train form
//                         each block's dgamma partial sums
//   colsum_kernel x 3     (train form) dgamma, dq_scale, dk_scale from the
//                         blocks' partial sums, in order
//   wgrad_kernel          (train form) dWq = dq^T xn, dWk | dWv = [dk | dv]^T
//                         x, dWo = g^T o: 32 tiles of 128 x 128 at D = 512,
//                         HD = 256, each tile's R n tokens split into
//                         `wg_chunk`-slice chunks (128 blocks at 27,648
//                         tokens), each chunk's fp32 partial tile written
//                         whole; wgrad_sum_kernel adds the partials in
//                         chunk order
// Every sum over tokens runs in a fixed order without atomics: two calls
// give the same bits.
#pragma once

#include "attn_bwd_packed.cuh"
#include "attn_bwd_wg.cuh"
#include "wgrad_sm90.cuh"

namespace ctc {
namespace tc {

// Workspaces of the passes: qk [4][M][HD] (q_hi, q_lo, k_hi, k_lo), v and
// dO [2][M][HD] (hi, lo), unit [2][M][HD] / norm [2][M][H] fp32 (q then
// k), mld [R][H][n] float4 (m log2 e, 1 / l, D, lse: the core writes the
// first two, the row term's walk the others; the fused temporal pass takes
// none).

// a stage of the fp32 dbias pass: k_hi, k_lo, v_hi, v_lo of the key chunk;
// q_hi, q_lo, dO_hi, dO_lo of the query tile; the tile's (m log2 e, 1 / l,
// D, 0)
constexpr int DBF_STAGE = 8 * DB_PLANE + DB_QT * 16;
constexpr int DBF_SMEM = 2 * DBF_STAGE;

// dbias [H][n][n] = sum over the R sequences of the fp32 dS: one block per
// (key chunk of KC, query tile of DB_QT, head h), the sequences in order
// through a two-stage cp.async ring (the next sequence's rows load while
// this one's are used); S = q k^T and dP = dO v^T as split products of the
// staged planes, dS = P (dP - D) summed in registers (attn_bwd.cuh's
// bwd_dbias_kernel with every operand split).
template <int Dummy = 0>
__global__ void __launch_bounds__(DB_WARPS * 32)
bwd_dbias_f32_kernel(const bf16* __restrict__ qk, const bf16* __restrict__ v,
                     const bf16* __restrict__ dO, const float* __restrict__ bias,
                     const float4* __restrict__ mld, float* __restrict__ dbias, int R, int n,
                     int HD) {
  extern __shared__ __align__(128) char smem[];
  const int key0 = blockIdx.x * KC, qt0 = blockIdx.y * DB_QT, h = blockIdx.z, H = gridDim.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = (threadIdx.x >> 5) * 16;        // within the tile
  const int ra = qt0 + q0 + g, rb = ra + 8;
  const bool va = ra < n, vb = rb < n;
  const size_t plane = (size_t)R * n * HD;
  const int keys = min(KC, n - key0), rows = min(DB_QT, n - qt0);
  const uint32_t sbase = sm90::smem_u32(smem);
  auto stage = [&](int r, int buf) {
    const uint32_t at = sbase + buf * DBF_STAGE;
    const int64_t koff = ((int64_t)r * n + key0) * HD + h * DH;
    const int64_t qoff = ((int64_t)r * n + qt0) * HD + h * DH;
    const bf16* const ksrc[4] = {qk + 2 * plane + koff, qk + 3 * plane + koff, v + koff,
                                 v + plane + koff};
    const bf16* const qsrc[4] = {qk + qoff, qk + plane + qoff, dO + qoff, dO + plane + qoff};
    stage_planes<4>(at, ksrc, HD, keys, KC);
    stage_planes<4>(at + 4 * DB_PLANE, qsrc, HD, rows, DB_QT);
    const float4* st = mld + ((int64_t)r * H + h) * n + qt0;
    for (int i = threadIdx.x; i < DB_QT; i += blockDim.x)
      cp_async16(at + 8 * DB_PLANE + 16 * i, st + min(i, rows - 1), i < rows ? 16 : 0);
  };
  float b[KC / 8][4], acc[KC / 8][4];
  {
    const float* bias_a = bias + ((int64_t)h * n + (va ? ra : 0)) * n;
    const float* bias_b = bias + ((int64_t)h * n + (vb ? rb : 0)) * n;
#pragma unroll
    for (int jt = 0; jt < KC / 8; ++jt) {
      bias_pair<1>(b[jt], bias_a, bias_b, va, vb, key0 + 8 * jt + 2 * t, n);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[jt][i] = 0.f;
    }
  }
  stage(0, 0);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int r = 0; r < R; ++r) {
    if (r + 1 < R) stage(r + 1, (r + 1) & 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    if (qt0 + q0 < n) {
      const uint32_t buf = sbase + (r & 1) * DBF_STAGE;
      uint32_t qh[2][4], ql[2][4], dh[2][4], dl[2][4];
      ldsm_a(qh, buf + 4 * DB_PLANE, q0, lane);
      ldsm_a(ql, buf + 5 * DB_PLANE, q0, lane);
      ldsm_a(dh, buf + 6 * DB_PLANE, q0, lane);
      ldsm_a(dl, buf + 7 * DB_PLANE, q0, lane);
      const float4* st =
          reinterpret_cast<const float4*>(smem + (r & 1) * DBF_STAGE + 8 * DB_PLANE);
      const float4 sa = st[q0 + g], sb = st[q0 + g + 8];   // zeros past n: p = 0
#pragma unroll
      for (int jt = 0; jt < KC / 8; ++jt) {
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
        split_scores(s, qh, ql, buf, buf + DB_PLANE, 8 * jt, lane);
        split_scores(dp, dh, dl, buf + 2 * DB_PLANE, buf + 3 * DB_PLANE, 8 * jt, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4& sr = i < 2 ? sa : sb;
          const float p = key0 + 8 * jt + 2 * t + (i & 1) < n
                              ? exp2f((s[i] + b[jt][i]) * LOG2E - sr.x) * sr.y
                              : 0.f;
          acc[jt][i] += p * (dp[i] - sr.z);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int jt = 0; jt < KC / 8; ++jt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i < 2 ? ra : rb, key = key0 + 8 * jt + 2 * t + (i & 1);
      if ((i < 2 ? va : vb) && key < n) dbias[((int64_t)h * n + row) * n + key] = acc[jt][i];
    }
  }
}

// The weight gradients of the block in one three-pass launch. Maps (hi, lo
// each): 0 / 1 dq [M, HD], 2 / 3 xn [M, D], 4 / 5 dk | dv [M, 2 HD], 6 / 7 x
// [M, D], 8 / 9 g [M, D], 10 / 11 o [M, HD]. Tiles: dWq [HD, D] = dq^T xn,
// then dWk | dWv [2 HD, D] = [dk | dv]^T x, both into output 0 (dw_qkv [3
// HD, D], rows dWq, dWk, dWv); then dWo [D, HD] = g^T o (output 1).
struct BlockWgradSplitPlan {
  static constexpr int PASSES = 3;
  int HD, D, d_tiles, h_tiles;
  __device__ sm90::WgradTile tile(int t) const {
    const int q = h_tiles * d_tiles, kv = 2 * q;
    if (t < q + kv) {
      const bool is_q = t < q;
      const int u = is_q ? t : t - q, i0 = (u / d_tiles) * sm90::BM;
      const int j0 = (u % d_tiles) * sm90::BN;
      return {is_q ? 0 : 4, is_q ? 2 : 6, i0, j0, 0, is_q ? i0 : HD + i0,
              min(sm90::BM, (is_q ? HD : 2 * HD) - i0)};
    }
    const int u = t - q - kv, i0 = (u / h_tiles) * sm90::BM, j0 = (u % h_tiles) * sm90::BN;
    return {8, 10, i0, j0, 1, i0, min(sm90::BM, D - i0)};
  }
};

// Largest sequence length the fp32 backward takes: the fp32 core's (its
// four staged planes), which the spatial chain and the temporal one above
// PK_MAX_N run for the row statistics.
inline int bwd_f32_max_n() { return core_max_keys(4); }

// The parameter gradients of the train step's form, all fp32 and written
// whole: dgamma [D], dw_qkv [3 HD][D] (dWq, dWk, dWv), dwo [D][HD], dqs / dks
// [32], dbias [H][n][n] (null without a bias); workspaces ln_part
// [ln_parts(M)][2 D], q_part / k_part [packed_parts(R, n, H, bias)][32],
// wg_part [chunks][32 tiles at D = 512][64][256] for the weight gradient's
// partial tiles (null and wg_chunk 0: each tile sums all tokens itself).
struct BlockGradsF32 {
  float *dgamma, *dw_qkv, *dwo, *dqs, *dks, *dbias, *ln_part, *q_part, *k_part, *wg_part;
  int wg_chunk;
};

// Rows of q_part / k_part: one a (sequence, head) of the fused temporal
// pass, one a (sequence, 64-row tile, head) of the wgmma passes.
inline int packed_parts(int R, int n, int H, bool bias) {
  return bias || n > PK_MAX_N ? R * ((n + WG_ROWS - 1) / WG_ROWS) * H : R * H;
}

// The chain. x [R*n, D] fp32 (D a multiple of 8); gamma [D], qs / ks [32],
// wq / wk / wv [HD, D], wo [D, HD], g [R*n, D] fp32; bias [H][n][n] fp32 or
// null; workspaces xs [4][R*n][D] (xn_hi, xn_lo, x_hi, x_lo), w_s [2][3
// HD][D], wo_s [2][D][HD], gs [2][R*n][D], qk [4][R*n][HD], v, dO, o, dq
// [2][R*n][HD] and dkv [2][R*n][2 HD] bf16; unit [2][R*n][HD], norm
// [2][R*n][H], biasT [H][n][n] (null without a bias), dxn / dxd [R*n][D]
// fp32; mld [R*n*H] float4; out dx [R*n, D] fp32; grads null (dx alone) or
// the train step's outputs. Without a bias at n <= PK_MAX_N, mld is unused
// and o is written only in the train form (both may be null otherwise). HD = H * 32, a multiple of 128; every pointer
// 16-B aligned. keep_lo 0 zeroes every lo plane (the one-pass control).
template <int Dummy = 0>
int block_backward_f32(const float* x, const float* gamma, const float* wq, const float* wk,
                       const float* wv, const float* wo, const float* qs, const float* ks,
                       const float* bias, const float* g, bf16* xs, bf16* w_s, bf16* wo_s,
                       bf16* gs, bf16* qk, float* unit, float* norm, float* biasT, bf16* v,
                       bf16* dO, bf16* o, float4* mld, bf16* dq, bf16* dkv, float* dxn,
                       float* dxd, float* dx, const BlockGradsF32* grads, int R, int n, int D,
                       int H, float scale, int residual, int keep_lo, int saved, cudaStream_t st) {
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
  MapsN<12> wg{};
  if (grads != nullptr) {
    // (hi, lo) of dq, xn, dk | dv, x, g, o: BlockWgradSplitPlan's maps
    const bf16* const src[6] = {dq, xs, dkv, xs + 2 * md, gs, o};
    const int cols[6] = {HD, D, 2 * HD, D, D, HD};
    const int64_t lo[6] = {mh, md, 2 * mh, md, md, mh};
    for (int i = 0; i < 6 && !err; ++i) {
      err = map_mn(&wg.m[2 * i], src[i], M, cols[i], cols[i]);
      if (!err) err = map_mn(&wg.m[2 * i + 1], src[i] + lo[i], M, cols[i], cols[i]);
    }
  }
  if (err) return err;
  const float* const w3[3] = {wq, wk, wv};
  for (int i = 0; i < 3 && !err; ++i)
    err = split_to(w3[i], w_s + i * wsz, w_s + wrows + i * wsz, wsz, keep_lo, st);
  if (!err) err = split(wo, wo_s, wsz, keep_lo, st);
  if (!err)
    err = launch_ln_split(x, gamma, nullptr, nullptr, xs, xs + md, xs + 2 * md, xs + 3 * md, M, D,
                          1e-5f, keep_lo, st, g, gs, gs + md);
  if (err) return err;
  err = launch_split4<false>(proj, QkvSplitPlan{tiles},
                             QkvEpi{qk, v, qs, ks, scale, M, HD, tiles, unit, norm, v + mh,
                                    keep_lo},
                             3 * tiles, M, D, st);
  if (!err)
    err = split_product_kn(gs, gs + md, D, wo_s, wo_s + wsz, HD, M, HD, D,
                           SplitOutEpi{dO, dO + mh, M, HD, HD, keep_lo}, st);
  if (err) return err;
  float* q_part = grads != nullptr ? grads->q_part : nullptr;
  float* k_part = grads != nullptr ? grads->k_part : nullptr;
  const int parts = packed_parts(R, n, H, bias != nullptr);
  if (bias == nullptr && n <= PK_MAX_N) {
    // the temporal block: one fused pass, o's planes in the train form
    const PackedOut out{unit, norm, qs, ks, scale, dq, dkv, grads != nullptr ? o : nullptr,
                        q_part, k_part, keep_lo};
    err = launch_packed_pass(qk, v, dO, out, R, n, H, st);
  } else {
    // o's planes and (m log2 e, 1 / l) from the forward (saved, with a
    // bias) or from the core rerun here; the passes on wgmma
    if (!saved)
      err = launch_block_core<true, true>(qk, v, bias, o, R, n, H, mld, nullptr, st, keep_lo);
    if (!err && bias != nullptr) {
      dim3 gt((n + 31) / 32, (n + 31) / 32, H);
      transpose_kernel<><<<gt, 256, 0, st>>>(bias, biasT, n);
    }
    if (!err)
      err = launch_wg_passes(qk, v, dO, bias, biasT, mld, unit, norm, qs, ks, scale, dq, dkv,
                             q_part, k_part, R, n, H, keep_lo, st);
  }
  if (err) return err;
  if (grads != nullptr && bias != nullptr) {
    dim3 gb((n + KC - 1) / KC, (n + DB_QT - 1) / DB_QT, H);
    cudaFuncSetAttribute(bwd_dbias_f32_kernel<>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         DBF_SMEM);
    bwd_dbias_f32_kernel<><<<gb, DB_WARPS * 32, DBF_SMEM, st>>>(qk, v, dO, bias, mld,
                                                                grads->dbias, R, n, HD);
    err = (int)cudaGetLastError();
  }
  if (!err)
    err = split_product_kn(dq, dq + mh, HD, w_s, w_s + wrows, D, M, D, HD,
                           F32OutEpi{dxn, nullptr, nullptr, M, D}, st);
  if (!err)
    err = split_product_kn(dkv, dkv + 2 * mh, 2 * HD, w_s + wsz, w_s + wrows + wsz, D, M, D,
                           2 * HD, F32OutEpi{dxd, nullptr, nullptr, M, D}, st);
  if (!err)
    err = launch_ln_bwd_f32(x, gamma, dxn, dxd, residual ? g : nullptr, dx, M, D, st,
                            grads != nullptr ? grads->ln_part : nullptr);
  if (err || grads == nullptr) return err;
  err = launch_colsum(grads->ln_part, grads->dgamma, ln_parts(M), D, 2 * D, 1.f, st);
  if (!err) err = launch_colsum(q_part, grads->dqs, parts, DH, DH, scale, st);
  if (!err) err = launch_colsum(k_part, grads->dks, parts, DH, DH, 1.f, st);
  if (err) return err;
  const int d_tiles = (D + BN - 1) / BN, h_tiles = HD / BN;
  return launch_wgrad_sm90(wg, BlockWgradSplitPlan{HD, D, d_tiles, h_tiles},
                           WgradStoreEpi{{grads->dw_qkv, grads->dwo}, {D, HD}, {D, HD}},
                           3 * d_tiles * h_tiles + d_tiles * h_tiles, M, st, grads->wg_chunk,
                           grads->wg_part);
}

}  // namespace tc
}  // namespace ctc
