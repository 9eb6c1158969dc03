// The cosine-attention block's backward in fp32, the data gradient only,
// shared by attn_block_bwd_f32.cu (spatial, with a position bias) and
// attn_packed_bwd_f32.cu (temporal, no bias): the port of
// pallas_attn_block._backward_impl / pallas_attn_packed._backward_impl at
// fp32 (where their rounding points are identities) for the gradient
// attribution methods, which differentiate with respect to activations and
// patches and need dx alone.
//
// Given x [R*n, D] fp32, the block's weights and the output cotangent g, it
// recomputes the forward and returns dx (+ g under `residual`). Every fp32
// product is three bf16 products of hi / lo planes (a_hi b_hi + a_lo b_hi +
// a_hi b_lo, within ~2^-16 of fp32): the GEMMs as SplitPlan / SplitKNPlan on
// the Hopper core (split_sm90.cuh), the attention passes on mma.sync with
// split operands (attn_mma.cuh's split_scores for S, dP and their
// transposes; P, dS split in registers against staged hi / lo planes for
// P.V-shaped products).
//
// What bounds it on the H100: operations, three bf16 products for each
// fp32 one. The function's products: the projections q, k, v, dO, dxn
// (2 M D HD each) and dx_direct (2 M D 2 HD), and per (sequence, head) S,
// P.V (for D), dP, dS.K, dS^T.Q, P^T.dO (2 n^2 32 each). The passes take
// four more n^2 products than that: the statistics pass S twice, the key
// pass S^T and dP^T again.
// A block stages one (sequence, head)'s four planes of n rows (147 KB at n
// = 576: one block an SM, as the fp32 forward core). Launches:
//
//   split_kernel x 5      the planes of wq | wk | wv (stacked [3 HD, D]),
//                         wo and g
//   ln_split_kernel       xn's and x's planes
//   gemm_kernel           q, k, v (QkvSplitPlan, tc::QkvEpi: q / k
//                         l2-normed and scaled as hi / lo planes, their unit
//                         rows and norms in fp32, v as planes)
//   gemm_kernel           dO = g Wo as planes (SplitKNPlan: Wo as stored)
//   block_core_kernel     the fp32 core with STATS: o, and each row's (m log2
//                         e, 1 / l, D = rowsum(dO o)) from the fp32 o
//   transpose_kernel      the bias transposed per head (with a bias)
//   bwd_dq_f32_kernel     per (sequence, 128-query tile, head), K and V hi /
//                         lo staged: P from the saved (m, l), dP = dO V^T, dS
//                         = P (dP - D), dq^ = dS K, the scale and l2-norm
//                         backward -> dq planes
//   bwd_dkv_f32_kernel    per (sequence, 128-key tile, head), Q and dO hi /
//                         lo and each query's (lse, D) staged: S^T, dP^T =
//                         V dO^T, dS^T, dV = P^T dO, dk^ = dS^T Q, the
//                         l2-norm backward -> dk | dv planes
//   gemm_kernel x 2       dxn = dq Wq, dx_direct = [dk | dv] [Wk; Wv] (fp32;
//                         SplitKNPlan over the stacked weight planes)
//   ln_bwd_f32_kernel     dx = LN'(dxn) + dx_direct (+ g)
// No parameter gradient is formed: dgamma, dWq, dWk, dWv, dWo, the scales'
// and the bias's gradients are the fp32 train step's (ROADMAP Queue 2 item
// 14, fourth group).
#pragma once

#include "attn_mma.cuh"

namespace ctc {
namespace tc {

// The scale and l2-norm backward of rows a, b of a 16 x 32 gradient of the
// scaled unit rows (the mma D layout, as attn_bwd.cuh's l2norm_bwd): du =
// acc * gain, out = (du - u (u . du)) / norm, written as hi / lo planes at
// hi_a / hi_b and lo_off further on.
__device__ __forceinline__ void l2norm_bwd_planes(const float (&acc)[4][4], const float* u_a,
                                                  const float* u_b, float norm_a, float norm_b,
                                                  bool va, bool vb, const float (&gain)[8],
                                                  bf16* hi_a, bf16* hi_b, int64_t lo_off,
                                                  int keep_lo, int t) {
  float ua[8], ub[8], dot_a = 0.f, dot_b = 0.f;
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    const int col = 8 * dt + 2 * t;
    const float2 x = va ? *reinterpret_cast<const float2*>(u_a + col) : make_float2(0.f, 0.f);
    const float2 y = vb ? *reinterpret_cast<const float2*>(u_b + col) : make_float2(0.f, 0.f);
    ua[2 * dt] = x.x;
    ua[2 * dt + 1] = x.y;
    ub[2 * dt] = y.x;
    ub[2 * dt + 1] = y.y;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dot_a += ua[2 * dt + e] * (acc[dt][e] * gain[2 * dt + e]);
      dot_b += ub[2 * dt + e] * (acc[dt][2 + e] * gain[2 * dt + e]);
    }
  }
  dot_a += __shfl_xor_sync(0xffffffffu, dot_a, 1);
  dot_a += __shfl_xor_sync(0xffffffffu, dot_a, 2);
  dot_b += __shfl_xor_sync(0xffffffffu, dot_b, 1);
  dot_b += __shfl_xor_sync(0xffffffffu, dot_b, 2);
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    const int col = 8 * dt + 2 * t;
    __nv_bfloat162 h2, l2;
    if (va) {
      sm90::split2((acc[dt][0] * gain[2 * dt] - ua[2 * dt] * dot_a) / norm_a,
                   (acc[dt][1] * gain[2 * dt + 1] - ua[2 * dt + 1] * dot_a) / norm_a, keep_lo, h2,
                   l2);
      *reinterpret_cast<__nv_bfloat162*>(hi_a + col) = h2;
      *reinterpret_cast<__nv_bfloat162*>(hi_a + lo_off + col) = l2;
    }
    if (vb) {
      sm90::split2((acc[dt][2] * gain[2 * dt] - ub[2 * dt] * dot_b) / norm_b,
                   (acc[dt][3] * gain[2 * dt + 1] - ub[2 * dt + 1] * dot_b) / norm_b, keep_lo, h2,
                   l2);
      *reinterpret_cast<__nv_bfloat162*>(hi_b + col) = h2;
      *reinterpret_cast<__nv_bfloat162*>(hi_b + lo_off + col) = l2;
    }
  }
}

// this thread's 8 columns 8 dt + 2 t + e of a [32] vector, times mul
__device__ __forceinline__ void gain_cols(float (&out)[8], const float* v, float mul, int t) {
#pragma unroll
  for (int dt = 0; dt < 4; ++dt)
#pragma unroll
    for (int e = 0; e < 2; ++e) out[2 * dt + e] = v[8 * dt + 2 * t + e] * mul;
}

// two A-fragment registers (rows a, b at two adjacent keys) of values y[4]
// as hi / lo pairs
__device__ __forceinline__ void split_frag(const float (&y)[4], int keep_lo, uint32_t& h_a,
                                          uint32_t& h_b, uint32_t& l_a, uint32_t& l_b) {
  __nv_bfloat162 hv, lv;
  sm90::split2(y[0], y[1], keep_lo, hv, lv);
  h_a = sm90::as_u32(hv);
  l_a = sm90::as_u32(lv);
  sm90::split2(y[2], y[3], keep_lo, hv, lv);
  h_b = sm90::as_u32(hv);
  l_b = sm90::as_u32(lv);
}

// Workspaces of the passes: qk [4][M][HD] (q_hi, q_lo, k_hi, k_lo), v and
// dO [2][M][HD] (hi, lo), unit [2][M][HD] / norm [2][M][H] fp32 (q then
// k), mld [R][H][n] float4 (m log2 e, 1 / l, D, 0).

// The query pass: one block per (sequence r, query tile of QT rows, head
// h), K and V hi / lo staged (four planes); dq [2][M][HD].
template <int BIAS>
__global__ void __launch_bounds__(CORE_WARPS * 32, 1)
bwd_dq_f32_kernel(const bf16* __restrict__ qk, const bf16* __restrict__ v,
                  const bf16* __restrict__ dO, const float* __restrict__ bias,
                  const float4* __restrict__ mld, const float* __restrict__ unit,
                  const float* __restrict__ norm, const float* __restrict__ qs, float scale,
                  bf16* __restrict__ dq, int M, int n, int HD, int keep_lo) {
  extern __shared__ __align__(128) char smem[];
  const int r = blockIdx.x, h = blockIdx.z, H = gridDim.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * QT + (threadIdx.x >> 5) * 16;
  const int n_pad = padded_keys(n);
  const size_t plane = (size_t)M * HD;
  const int64_t off = (int64_t)r * n * HD + h * DH;
  const uint32_t sbase = sm90::smem_u32(smem), pbytes = n_pad * DH * 2;
  {
    const bf16* const src[4] = {qk + 2 * plane + off, qk + 3 * plane + off, v + off,
                                v + plane + off};
    stage_planes<4>(sbase, src, HD, n, n_pad);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  if (q0 >= n) return;
  const int ra = q0 + g, rb = ra + 8;
  const bool va = ra < n, vb = rb < n;
  uint32_t qh[2][4], ql[2][4], dh[2][4], dl[2][4];
  load_a(qh, qk + off, HD, q0, n, lane);
  load_a(ql, qk + plane + off, HD, q0, n, lane);
  load_a(dh, dO + off, HD, q0, n, lane);
  load_a(dl, dO + plane + off, HD, q0, n, lane);
  const float4* st = mld + ((int64_t)r * H + h) * n;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 sa = va ? st[ra] : zero, sb = vb ? st[rb] : zero;
  const float* bias_a = BIAS ? bias + ((int64_t)h * n + (va ? ra : 0)) * n : nullptr;
  const float* bias_b = BIAS ? bias + ((int64_t)h * n + (vb ? rb : 0)) * n : nullptr;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int kc = 0; kc < n_pad; kc += KC) {
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kb = kc + 16 * ks + 8 * u, key = kb + 2 * t;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f}, b[4], ds[4];
        split_scores(s, qh, ql, sbase, sbase + pbytes, kb, lane);
        split_scores(dp, dh, dl, sbase + 2 * pbytes, sbase + 3 * pbytes, kb, lane);
        bias_pair<BIAS>(b, bias_a, bias_b, va, vb, key, n);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4& sr = i < 2 ? sa : sb;
          const float p = key + (i & 1) < n ? exp2f((s[i] + b[i]) * LOG2E - sr.x) * sr.y : 0.f;
          ds[i] = p * (dp[i] - sr.z);
        }
        split_frag(ds, keep_lo, ah[2 * u], ah[2 * u + 1], al[2 * u], al[2 * u + 1]);
      }
      col_products(acc, al, sbase, kc + 16 * ks, lane);
      col_products(acc, ah, sbase + pbytes, kc + 16 * ks, lane);
      col_products(acc, ah, sbase, kc + 16 * ks, lane);
    }
  }
  const int64_t ma = (int64_t)r * n + (va ? ra : 0), mb = (int64_t)r * n + (vb ? rb : 0);
  const int64_t col0 = h * DH;
  float gain[8];
  gain_cols(gain, qs, scale, t);
  l2norm_bwd_planes(acc, unit + ma * HD + col0, unit + mb * HD + col0, norm[ma * H + h],
                    norm[mb * H + h], va, vb, gain, dq + ma * HD + col0, dq + mb * HD + col0,
                    (int64_t)plane, keep_lo, t);
}

// Shared memory of the fp32 key pass: four planes, then (lse, D) per query.
__host__ __device__ __forceinline__ size_t dkv_f32_smem_bytes(int n) {
  return core_smem_bytes(n, 4) + (size_t)padded_keys(n) * sizeof(float2);
}

// The key pass: one block per (sequence r, key tile of QT keys, head h), Q
// and dO hi / lo staged; warp w takes keys tile + 16 w as the A operand of
// S^T and dP^T. biasT [H][key][query] as attn_bwd.cuh's key pass. dkv
// [2][M][2 HD]: dk at columns h * 32 ..., dv at HD + h * 32 ....
template <int BIAS>
__global__ void __launch_bounds__(CORE_WARPS * 32, 1)
bwd_dkv_f32_kernel(const bf16* __restrict__ qk, const bf16* __restrict__ v,
                   const bf16* __restrict__ dO, const float* __restrict__ biasT,
                   const float4* __restrict__ mld, const float* __restrict__ unit,
                   const float* __restrict__ norm, const float* __restrict__ ks,
                   bf16* __restrict__ dkv, int M, int n, int HD, int keep_lo) {
  extern __shared__ __align__(128) char smem[];
  const int r = blockIdx.x, h = blockIdx.z, H = gridDim.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * QT + (threadIdx.x >> 5) * 16;
  const int n_pad = padded_keys(n);
  const size_t plane = (size_t)M * HD;
  const int64_t off = (int64_t)r * n * HD + h * DH;
  const uint32_t sbase = sm90::smem_u32(smem), pbytes = n_pad * DH * 2;
  float2* lse_d = reinterpret_cast<float2*>(smem + 4 * pbytes);
  {
    const bf16* const src[4] = {qk + off, qk + plane + off, dO + off, dO + plane + off};
    stage_planes<4>(sbase, src, HD, n, n_pad);
  }
  const float4* st = mld + ((int64_t)r * H + h) * n;
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
    const float4 s4 = i < n ? st[i] : make_float4(0.f, 1.f, 0.f, 0.f);
    lse_d[i] = make_float2(i < n ? s4.x - log2f(s4.y) : CUDART_INF_F, s4.z);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  if (k0 >= n) return;
  const int ka = k0 + g, kb = ka + 8;
  const bool va = ka < n, vb = kb < n;
  uint32_t kh[2][4], kl[2][4], vh[2][4], vl[2][4];
  load_a(kh, qk + 2 * plane + off, HD, k0, n, lane);
  load_a(kl, qk + 3 * plane + off, HD, k0, n, lane);
  load_a(vh, v + off, HD, k0, n, lane);
  load_a(vl, v + plane + off, HD, k0, n, lane);
  const float* bias_a = BIAS ? biasT + ((int64_t)h * n + (va ? ka : 0)) * n : nullptr;
  const float* bias_b = BIAS ? biasT + ((int64_t)h * n + (vb ? kb : 0)) * n : nullptr;
  float dv[4][4], dk[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[i][e] = dk[i][e] = 0.f;
  for (int qc = 0; qc < n_pad; qc += KC) {
#pragma unroll
    for (int kt = 0; kt < KC / 16; ++kt) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int qb = qc + 16 * kt + 8 * u, qi = qb + 2 * t;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f}, b[4], p[4], ds[4];
        split_scores(s, kh, kl, sbase, sbase + pbytes, qb, lane);
        split_scores(dp, vh, vl, sbase + 2 * pbytes, sbase + 3 * pbytes, qb, lane);
        bias_pair<BIAS>(b, bias_a, bias_b, va, vb, qi, n);
        const float4 sq = *reinterpret_cast<const float4*>(lse_d + qi);   // queries qi, qi + 1
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // past n, lse is +inf and p 0
          p[i] = exp2f((s[i] + b[i]) * LOG2E - ((i & 1) ? sq.z : sq.x));
          ds[i] = p[i] * (dp[i] - ((i & 1) ? sq.w : sq.y));
        }
        split_frag(p, keep_lo, ph[2 * u], ph[2 * u + 1], pl[2 * u], pl[2 * u + 1]);
        split_frag(ds, keep_lo, sh[2 * u], sh[2 * u + 1], sl[2 * u], sl[2 * u + 1]);
      }
      const int q16 = qc + 16 * kt;
      col_products(dv, pl, sbase + 2 * pbytes, q16, lane);
      col_products(dv, ph, sbase + 3 * pbytes, q16, lane);
      col_products(dv, ph, sbase + 2 * pbytes, q16, lane);
      col_products(dk, sl, sbase, q16, lane);
      col_products(dk, sh, sbase + pbytes, q16, lane);
      col_products(dk, sh, sbase, q16, lane);
    }
  }
  const int64_t ma = (int64_t)r * n + (va ? ka : 0), mb = (int64_t)r * n + (vb ? kb : 0);
  const int64_t col0 = h * DH, HD2 = 2 * (int64_t)HD, lo_off = 2 * (int64_t)plane;
  float gain[8];
  gain_cols(gain, ks, 1.f, t);
  const float* uk = unit + plane;
  const float* nk = norm + (size_t)M * H;
  l2norm_bwd_planes(dk, uk + ma * HD + col0, uk + mb * HD + col0, nk[ma * H + h], nk[mb * H + h],
                    va, vb, gain, dkv + ma * HD2 + col0, dkv + mb * HD2 + col0, lo_off, keep_lo,
                    t);
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    const int64_t col = HD + col0 + 8 * dt + 2 * t;
    __nv_bfloat162 h2, l2;
    if (va) {
      sm90::split2(dv[dt][0], dv[dt][1], keep_lo, h2, l2);
      *reinterpret_cast<__nv_bfloat162*>(dkv + ma * HD2 + col) = h2;
      *reinterpret_cast<__nv_bfloat162*>(dkv + lo_off + ma * HD2 + col) = l2;
    }
    if (vb) {
      sm90::split2(dv[dt][2], dv[dt][3], keep_lo, h2, l2);
      *reinterpret_cast<__nv_bfloat162*>(dkv + mb * HD2 + col) = h2;
      *reinterpret_cast<__nv_bfloat162*>(dkv + lo_off + mb * HD2 + col) = l2;
    }
  }
}

// Largest sequence length the fp32 passes take: the key pass's four staged
// planes and each query's (lse, D) in one block's shared memory.
inline int bwd_f32_max_n() {
  int n = KC;
  while (dkv_f32_smem_bytes(n + KC) <= 227 * 1024) n += KC;
  return n;
}

// The chain. x [R*n, D] fp32 (D a multiple of 8); gamma [D], qs / ks [32],
// wq / wk / wv [HD, D], wo [D, HD], g [R*n, D] fp32; bias [H][n][n] fp32 or
// null; workspaces xs [4][R*n][D] (xn_hi, xn_lo, x_hi, x_lo), w_s [2][3
// HD][D], wo_s [2][D][HD], gs [2][R*n][D], qk [4][R*n][HD], v, dO, o, dq
// [2][R*n][HD] and dkv [2][R*n][2 HD] bf16; unit [2][R*n][HD], norm
// [2][R*n][H], biasT [H][n][n] (null without a bias), dxn / dxd [R*n][D]
// fp32; mld [R*n*H] float4; out dx [R*n, D] fp32. HD = H * 32, a multiple
// of 128; every pointer 16-B aligned. keep_lo 0 zeroes every lo plane (the
// one-pass control).
template <int Dummy = 0>
int block_backward_f32(const float* x, const float* gamma, const float* wq, const float* wk,
                       const float* wv, const float* wo, const float* qs, const float* ks,
                       const float* bias, const float* g, bf16* xs, bf16* w_s, bf16* wo_s,
                       bf16* gs, bf16* qk, float* unit, float* norm, float* biasT, bf16* v,
                       bf16* dO, bf16* o, float4* mld, bf16* dq, bf16* dkv, float* dxn,
                       float* dxd, float* dx, int R, int n, int D, int H, float scale,
                       int residual, int keep_lo, cudaStream_t st) {
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
  if (!err) err = split(g, gs, md, keep_lo, st);
  if (!err)
    err = launch_ln_split(x, gamma, nullptr, nullptr, xs, xs + md, xs + 2 * md, xs + 3 * md, M, D,
                          1e-5f, keep_lo, st);
  if (err) return err;
  err = launch_gemm(proj, QkvSplitPlan{tiles},
                    QkvEpi{qk, v, qs, ks, scale, M, HD, tiles, unit, norm, v + mh, keep_lo},
                    3 * tiles, M, D, st);
  if (!err)
    err = split_product_kn(gs, gs + md, D, wo_s, wo_s + wsz, HD, M, HD, D,
                           SplitOutEpi{dO, dO + mh, M, HD, HD, keep_lo}, st);
  if (!err) err = launch_block_core<true, true>(qk, v, bias, o, R, n, H, mld, dO, st, keep_lo);
  if (err) return err;

  const int smem = (int)core_smem_bytes(n, 4), smem_kv = (int)dkv_f32_smem_bytes(n);
  auto dq_pass = bias == nullptr ? bwd_dq_f32_kernel<0>
                 : (n % 2 == 0)  ? bwd_dq_f32_kernel<2>
                                 : bwd_dq_f32_kernel<1>;
  auto dkv_pass = bias == nullptr ? bwd_dkv_f32_kernel<0>
                  : (n % 2 == 0)  ? bwd_dkv_f32_kernel<2>
                                  : bwd_dkv_f32_kernel<1>;
  cudaFuncSetAttribute(dq_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(dkv_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (bias != nullptr) {
    dim3 gt((n + 31) / 32, (n + 31) / 32, H);
    transpose_kernel<><<<gt, 256, 0, st>>>(bias, biasT, n);
  }
  dim3 grid(R, (n + QT - 1) / QT, H);
  dq_pass<<<grid, core_threads(n), smem, st>>>(qk, v, dO, bias, mld, unit, norm, qs, scale, dq, M,
                                               n, HD, keep_lo);
  dkv_pass<<<grid, core_threads(n), smem_kv, st>>>(qk, v, dO, biasT, mld, unit, norm, ks, dkv, M,
                                                   n, HD, keep_lo);
  err = (int)cudaGetLastError();
  if (!err)
    err = split_product_kn(dq, dq + mh, HD, w_s, w_s + wrows, D, M, D, HD,
                           F32OutEpi{dxn, nullptr, nullptr, M, D}, st);
  if (!err)
    err = split_product_kn(dkv, dkv + 2 * mh, 2 * HD, w_s + wsz, w_s + wrows + wsz, D, M, D,
                           2 * HD, F32OutEpi{dxd, nullptr, nullptr, M, D}, st);
  if (err) return err;
  return launch_ln_bwd_f32(x, gamma, dxn, dxd, residual ? g : nullptr, dx, M, D, st);
}

}  // namespace tc
}  // namespace ctc
