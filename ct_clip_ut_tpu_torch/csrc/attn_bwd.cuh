// The cosine-attention block's backward, shared by attn_block_bwd.cu
// (spatial, with a position bias) and attn_packed_bwd.cu (temporal, short
// sequences, no bias): the port of pallas_attn_block._backward_impl /
// _bwd_kernel and pallas_attn_packed._backward_impl / _bwd_kernel.
//
// Given x [R*n, D] bf16, the block's weights and the output cotangent g, it
// recomputes the forward and returns dx (+ g under `residual`), dgamma,
// dWq, dWk | dWv, dWo, dq_scale, dk_scale and (with a bias) dbias [H, n, n]
// summed over the R sequences, at the TPU kernel's rounding points: scores
// and softmax in fp32; P rounded to bf16 before P.V and dV; dO, v and the
// per-head output in bf16; dP = dO V^T summed in fp32; dS = P (dP - D) in
// fp32, dbias summed from it; dS rounded to bf16 before dq^ = dS bf16(k^)
// and dk^ = dS^T bf16(q^); the l2-norm backward and the scale gradients in
// fp32 from the raw norms.
//
// What bounds it on the H100: at the flagship spatial stack (R = 48
// sequences of n = 576, 8 heads of 32) the n^2 core, ~122 GFLOP of mma
// work a call with the split-bf16 scores and the passes' recomputation
// (0.12 ms at the bf16 peak), then the six data-gradient products (43.5
// GFLOP) and the three weight-gradient products (21.7 GFLOP). The TPU
// kernel keeps a whole sequence's q / k / v and their gradients in VMEM
// (4.1 MB at n = 576); a block here has 227 KB. So the core is
// flash-attention-2's split into a query pass and a key pass over one
// (sequence, head) at a time, on the tensor cores (mma.sync m16n8k16 with
// split-bf16 scores, attn_mma.cuh). mma.sync rather than wgmma with A in
// registers: the passes feed p and dS from the score registers into the
// next product 16 keys at a time, as the forward core does, and a warp's
// 16-row fragments need no warpgroup-wide barriers; the register-A wgmma of
// gemm_sm90.cuh is the equal alternative. The two passes recompute S and
// S^T in different orders of the mma's sums (and the key pass takes p as
// exp2(s log2 e - lse), the query pass as exp2(s log2 e - m log2 e) / l),
// so P may differ between them in its last bits, within the band. Fourteen
// launches with a bias, twelve without:
//
//   ln_rows_kernel       xn = LN(x) gamma (bf16), per-row (mean, rstd)
//   gemm_kernel (sm90)   q, k, v (QkvPlan, tc::QkvEpi: q / k l2-normed and
//                        scaled as bf16 hi / lo planes, their unit rows and
//                        norms in fp32, v bf16); dO = g Wo (bf16)
//   block_core_kernel    the forward core (attn_mma.cuh) writing O (bf16)
//                        and each row's (m log2 e, 1 / l, D = rowsum(dO o))
//   transpose_kernel     the bias transposed per head, for the key pass
//   bwd_dq_kernel        per (sequence, 128-query tile, head), K hi / lo
//                        and V staged: P from the saved (m, l), dP = dO V^T,
//                        dS, dq^ += bf16(dS) k_hi, then the scale + l2-norm
//                        backward -> dq (bf16), dq_scale
//   bwd_dkv_kernel       per (sequence, 128-key tile, head), Q hi / lo, dO
//                        and each query's (lse, D) staged: P^T, dP^T = V
//                        dO^T, dS^T, dV += bf16(P)^T dO, dk^ += bf16(dS)^T
//                        q_hi, the l2-norm backward -> dk | dv (bf16),
//                        dk_scale
//   bwd_dbias_kernel     per (64-query tile, 64-key chunk, head): P and dS
//                        recomputed for every sequence in turn (its keys,
//                        values, queries, dO and row statistics staged
//                        through a two-stage cp.async ring), dS summed in
//                        registers over all R sequences and written once:
//                        no atomics, so dbias is the same bits on every
//                        run. Recomputing the scores and dP costs 4 of the
//                        core's 15 products; summing dS from the query pass
//                        with one fp32 atomicAdd per element would be R * H
//                        * n^2 = 127 M atomics on one 10.6 MB table at the
//                        flagship
//   gemm_kernel (sm90)   dxn = dq Wq, dxd = [dk | dv] [Wk; Wv] (fp32)
//   ln_bwd_rows_kernel   dx, dgamma
//   wgrad_kernel x 3     dWq = dq^T xn, dWk | dWv = (dk | dv)^T x, dWo = g^T O
//                        (the wmma tile of gemm_tile.cuh: its operands are
//                        MN-major, which the Hopper core's maps do not take)
//
// The temporal chain (attn_packed_bwd.cu, n = 24, no bias) takes the same
// launches but the transpose and the dbias pass. A block of the passes
// over fewer rows than a tile runs one warp per 16 of them (core_threads:
// two at n = 24, not eight with six idle), and the keys pad to one 64-row
// chunk. At R = 1152 its statistics, query and key passes take 0.068 +
// 0.104 + 0.112 ms a launch, against 0.265 + 0.358 ms for the CUDA-core
// query and key passes they replaced (H100 80GB HBM3, 700 W, `profile_train
// --sizes 2 --peg on --table`, both in one run); with eight-warp blocks
// the query and key passes alone took 0.312 + 0.317 ms (an earlier run).
#pragma once

#include "attn_mma.cuh"
#include "bwd_common.cuh"

namespace ctc {

// ---- the tensor-core passes ------------------------------------------------------

namespace tc {

// The scale and l2-norm backward of two rows (a, b) of a 16 x 32 gradient
// `acc` of the scaled unit rows (dq^ or dk^) in the mma D layout (row a
// columns 8 dt + 2 t + e at acc[dt][e], row b at acc[dt][2 + e]): du = acc *
// gain; out = (du - u (u . du)) / norm rounded to bf16; part[2 dt + e] += u
// acc, the gain's gradient before its factor. u: the unit rows (fp32).
__device__ __forceinline__ void l2norm_bwd(const float (&acc)[4][4], const float* u_a,
                                           const float* u_b, float norm_a, float norm_b, bool va,
                                           bool vb, const float (&gain)[8], bf16* out_a,
                                           bf16* out_b, float (&part)[8], int t) {
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
      part[2 * dt + e] += ua[2 * dt + e] * acc[dt][e] + ub[2 * dt + e] * acc[dt][2 + e];
    }
  }
  dot_a += __shfl_xor_sync(0xffffffffu, dot_a, 1);
  dot_a += __shfl_xor_sync(0xffffffffu, dot_a, 2);
  dot_b += __shfl_xor_sync(0xffffffffu, dot_b, 1);
  dot_b += __shfl_xor_sync(0xffffffffu, dot_b, 2);
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    const int col = 8 * dt + 2 * t;
    if (va)
      *reinterpret_cast<__nv_bfloat162*>(out_a + col) = __floats2bfloat162_rn(
          (acc[dt][0] * gain[2 * dt] - ua[2 * dt] * dot_a) / norm_a,
          (acc[dt][1] * gain[2 * dt + 1] - ua[2 * dt + 1] * dot_a) / norm_a);
    if (vb)
      *reinterpret_cast<__nv_bfloat162*>(out_b + col) = __floats2bfloat162_rn(
          (acc[dt][2] * gain[2 * dt] - ub[2 * dt] * dot_b) / norm_b,
          (acc[dt][3] * gain[2 * dt + 1] - ub[2 * dt + 1] * dot_b) / norm_b);
  }
}

// this thread's 8 columns 8 dt + 2 t + e of a [32] vector, times mul
__device__ __forceinline__ void head_cols(float (&out)[8], const float* v, float mul, int t) {
#pragma unroll
  for (int dt = 0; dt < 4; ++dt)
#pragma unroll
    for (int e = 0; e < 2; ++e) out[2 * dt + e] = v[8 * dt + 2 * t + e] * mul;
}

// part[] into red[32] (shared), this thread's columns
__device__ __forceinline__ void add_cols(float* red, const float (&part)[8], int t) {
#pragma unroll
  for (int dt = 0; dt < 4; ++dt)
#pragma unroll
    for (int e = 0; e < 2; ++e) atomicAdd(&red[8 * dt + 2 * t + e], part[2 * dt + e]);
}

// Workspaces: qk [4][M][HD] (q_hi, q_lo, k_hi,
// k_lo), unit [2][M][HD] / norm [2][M][H] fp32 (q then k), v, dO, O [M][HD]
// bf16, mld [R][H][n] float4 (m log2 e, 1 / l, D, 0).

// The query pass: one block per (sequence r, query tile of QT rows, head h).
template <int BIAS>
__global__ void __launch_bounds__(CORE_WARPS * 32, 2)
bwd_dq_kernel(const bf16* __restrict__ qk, const bf16* __restrict__ v,
              const bf16* __restrict__ dO, const float* __restrict__ bias,
              const float4* __restrict__ mld, const float* __restrict__ unit,
              const float* __restrict__ norm, const float* __restrict__ qs, float scale,
              bf16* __restrict__ dq, float* __restrict__ dqs, int M, int n, int HD) {
  extern __shared__ __align__(128) char smem[];
  __shared__ float red[DH];
  const int r = blockIdx.x, h = blockIdx.z, H = gridDim.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * QT + (threadIdx.x >> 5) * 16;
  const int n_pad = padded_keys(n);
  const size_t plane = (size_t)M * HD;
  const int64_t off = (int64_t)r * n * HD + h * DH;
  const uint32_t sbase = sm90::smem_u32(smem), pbytes = n_pad * DH * 2;
  if (threadIdx.x < DH) red[threadIdx.x] = 0.f;
  {
    const bf16* const src[3] = {qk + 2 * plane + off, qk + 3 * plane + off, v + off};
    stage_planes<3>(sbase, src, HD, n, n_pad);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  if (q0 < n) {
    const int ra = q0 + g, rb = ra + 8;
    const bool va = ra < n, vb = rb < n;
    uint32_t qh[2][4], ql[2][4], da[2][4];
    load_a(qh, qk + off, HD, q0, n, lane);
    load_a(ql, qk + plane + off, HD, q0, n, lane);
    load_a(da, dO + off, HD, q0, n, lane);
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
        uint32_t a[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int kb = kc + 16 * ks + 8 * u, key = kb + 2 * t;
          float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f}, b[4], ds[4];
          split_scores(s, qh, ql, sbase, sbase + pbytes, kb, lane);
          row_products(dp, da, sbase + 2 * pbytes, kb, lane);
          bias_pair<BIAS>(b, bias_a, bias_b, va, vb, key, n);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4& sr = i < 2 ? sa : sb;
            const float p =
                key + (i & 1) < n ? exp2f((s[i] + b[i]) * LOG2E - sr.x) * sr.y : 0.f;
            ds[i] = p * (dp[i] - sr.z);
          }
          a[2 * u] = sm90::pack_bf16(ds[0], ds[1]);
          a[2 * u + 1] = sm90::pack_bf16(ds[2], ds[3]);
        }
        col_products(acc, a, sbase, kc + 16 * ks, lane);
      }
    }
    const int64_t ma = (int64_t)r * n + (va ? ra : 0), mb = (int64_t)r * n + (vb ? rb : 0);
    const int64_t col0 = h * DH;
    float gain[8], part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    head_cols(gain, qs, scale, t);
    l2norm_bwd(acc, unit + ma * HD + col0, unit + mb * HD + col0, norm[ma * H + h],
               norm[mb * H + h], va, vb, gain, dq + ma * HD + col0, dq + mb * HD + col0, part, t);
    add_cols(red, part, t);
  }
  __syncthreads();
  if (threadIdx.x < DH) atomicAdd(dqs + threadIdx.x, red[threadIdx.x] * scale);
}

// Shared memory of the key pass: the three planes, then (lse, D) per query.
__host__ __device__ __forceinline__ size_t dkv_smem_bytes(int n) {
  return core_smem_bytes(n) + (size_t)padded_keys(n) * sizeof(float2);
}

// The key pass: one block per (sequence r, key tile of QT keys, head h);
// warp w takes keys tile + 16 w as the A operand of S^T and dP^T. biasT:
// the bias transposed per head, [H][key][query], so a thread's pair of
// queries is one 8-B load as in the query pass (BIAS 2: n even).
template <int BIAS>
__global__ void __launch_bounds__(CORE_WARPS * 32, 2)
bwd_dkv_kernel(const bf16* __restrict__ qk, const bf16* __restrict__ v,
               const bf16* __restrict__ dO, const float* __restrict__ biasT,
               const float4* __restrict__ mld, const float* __restrict__ unit,
               const float* __restrict__ norm, const float* __restrict__ ks,
               bf16* __restrict__ dkv, float* __restrict__ dks, int M, int n, int HD) {
  extern __shared__ __align__(128) char smem[];
  __shared__ float red[DH];
  const int r = blockIdx.x, h = blockIdx.z, H = gridDim.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * QT + (threadIdx.x >> 5) * 16;
  const int n_pad = padded_keys(n);
  const size_t plane = (size_t)M * HD;
  const int64_t off = (int64_t)r * n * HD + h * DH;
  const uint32_t sbase = sm90::smem_u32(smem), pbytes = n_pad * DH * 2;
  // p = exp2(s log2 e - lse), lse = m log2 e + log2 l
  float2* lse_d = reinterpret_cast<float2*>(smem + 3 * pbytes);
  if (threadIdx.x < DH) red[threadIdx.x] = 0.f;
  {
    const bf16* const src[3] = {qk + off, qk + plane + off, dO + off};
    stage_planes<3>(sbase, src, HD, n, n_pad);
  }
  const float4* st = mld + ((int64_t)r * H + h) * n;
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
    const float4 s4 = i < n ? st[i] : make_float4(0.f, 1.f, 0.f, 0.f);
    lse_d[i] = make_float2(i < n ? s4.x - log2f(s4.y) : CUDART_INF_F, s4.z);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  if (k0 < n) {
    const int ka = k0 + g, kb = ka + 8;
    const bool va = ka < n, vb = kb < n;
    uint32_t kh[2][4], kl[2][4], vf[2][4];
    load_a(kh, qk + 2 * plane + off, HD, k0, n, lane);
    load_a(kl, qk + 3 * plane + off, HD, k0, n, lane);
    load_a(vf, v + off, HD, k0, n, lane);
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
        uint32_t pa[4], sa[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int qb = qc + 16 * kt + 8 * u, qi = qb + 2 * t;
          float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f}, b[4], p[4], ds[4];
          split_scores(s, kh, kl, sbase, sbase + pbytes, qb, lane);
          row_products(dp, vf, sbase + 2 * pbytes, qb, lane);
          bias_pair<BIAS>(b, bias_a, bias_b, va, vb, qi, n);
          const float4 sq = *reinterpret_cast<const float4*>(lse_d + qi);   // queries qi, qi + 1
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // past n, lse is +inf and p 0
            p[i] = exp2f((s[i] + b[i]) * LOG2E - ((i & 1) ? sq.z : sq.x));
            ds[i] = p[i] * (dp[i] - ((i & 1) ? sq.w : sq.y));
          }
          pa[2 * u] = sm90::pack_bf16(p[0], p[1]);
          pa[2 * u + 1] = sm90::pack_bf16(p[2], p[3]);
          sa[2 * u] = sm90::pack_bf16(ds[0], ds[1]);
          sa[2 * u + 1] = sm90::pack_bf16(ds[2], ds[3]);
        }
        col_products(dv, pa, sbase + 2 * pbytes, qc + 16 * kt, lane);
        col_products(dk, sa, sbase, qc + 16 * kt, lane);
      }
    }
    const int64_t ma = (int64_t)r * n + (va ? ka : 0), mb = (int64_t)r * n + (vb ? kb : 0);
    const int64_t col0 = h * DH;
    const int64_t HD2 = 2 * (int64_t)HD;
    float gain[8], part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    head_cols(gain, ks, 1.f, t);
    const float* uk = unit + plane;
    const float* nk = norm + (size_t)M * H;
    l2norm_bwd(dk, uk + ma * HD + col0, uk + mb * HD + col0, nk[ma * H + h], nk[mb * H + h], va,
               vb, gain, dkv + ma * HD2 + col0, dkv + mb * HD2 + col0, part, t);
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      const int64_t col = HD + col0 + 8 * dt + 2 * t;
      if (va)
        *reinterpret_cast<__nv_bfloat162*>(dkv + ma * HD2 + col) =
            __floats2bfloat162_rn(dv[dt][0], dv[dt][1]);
      if (vb)
        *reinterpret_cast<__nv_bfloat162*>(dkv + mb * HD2 + col) =
            __floats2bfloat162_rn(dv[dt][2], dv[dt][3]);
    }
    add_cols(red, part, t);
  }
  __syncthreads();
  if (threadIdx.x < DH) atomicAdd(dks + threadIdx.x, red[threadIdx.x]);
}

// a stage: k_hi, k_lo, v of the key chunk; q_hi, q_lo, dO of the query
// tile; the tile's (m log2 e, 1 / l, D, 0)
constexpr int DB_STAGE = 6 * DB_PLANE + DB_QT * 16;
constexpr int DB_SMEM = 2 * DB_STAGE;

// dbias [H][n][n] = sum over the R sequences of dS: one block per (key chunk
// of KC, query tile of DB_QT, head h), the sequences in order through a
// two-stage cp.async ring (the next sequence's rows load while this one's
// are used); dS summed in registers.
template <int Dummy = 0>
__global__ void __launch_bounds__(DB_WARPS * 32)
bwd_dbias_kernel(const bf16* __restrict__ qk, const bf16* __restrict__ v,
                 const bf16* __restrict__ dO, const float* __restrict__ bias,
                 const float4* __restrict__ mld, float* __restrict__ dbias, int R, int n, int HD) {
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
    const uint32_t at = sbase + buf * DB_STAGE;
    const int64_t koff = ((int64_t)r * n + key0) * HD + h * DH;
    const int64_t qoff = ((int64_t)r * n + qt0) * HD + h * DH;
    const bf16* const ksrc[3] = {qk + 2 * plane + koff, qk + 3 * plane + koff, v + koff};
    const bf16* const qsrc[3] = {qk + qoff, qk + plane + qoff, dO + qoff};
    stage_planes<3>(at, ksrc, HD, keys, KC);
    stage_planes<3>(at + 3 * DB_PLANE, qsrc, HD, rows, DB_QT);
    const float4* st = mld + ((int64_t)r * H + h) * n + qt0;
    for (int i = threadIdx.x; i < DB_QT; i += blockDim.x)
      cp_async16(at + 6 * DB_PLANE + 16 * i, st + min(i, rows - 1), i < rows ? 16 : 0);
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
      const uint32_t buf = sbase + (r & 1) * DB_STAGE;
      uint32_t qh[2][4], ql[2][4], da[2][4];
      ldsm_a(qh, buf + 3 * DB_PLANE, q0, lane);
      ldsm_a(ql, buf + 4 * DB_PLANE, q0, lane);
      ldsm_a(da, buf + 5 * DB_PLANE, q0, lane);
      const float4* st = reinterpret_cast<const float4*>(smem + (r & 1) * DB_STAGE + 6 * DB_PLANE);
      const float4 sa = st[q0 + g], sb = st[q0 + g + 8];   // zeros past n: p = 0
#pragma unroll
      for (int jt = 0; jt < KC / 8; ++jt) {
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
        split_scores(s, qh, ql, buf, buf + DB_PLANE, 8 * jt, lane);
        row_products(dp, da, buf + 2 * DB_PLANE, 8 * jt, lane);
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

}  // namespace tc

// ---- the chain -------------------------------------------------------------------

// wqT [D, HD], wkvT [D, 2HD] (Wk^T | Wv^T) and woT [HD, D] are the
// transposed weights; bias [H, n, n] fp32 or null.
struct BwdIn {
  const bf16* x;
  const float* gamma;
  const bf16 *wq, *wk, *wv, *wqT, *wkvT, *woT;
  const float *qs, *ks, *bias;
  const bf16* g;
};

// Outputs; those summed with atomics (dgamma, dwq, dwkv, dwo, dqs, dks) are
// zeroed by the caller; dbias (null without a bias) is written whole.
struct BwdOut {
  bf16* dx;
  float *dgamma, *dwq, *dwkv, *dwo, *dqs, *dks, *dbias;
};

// Workspaces; biasT [H][n][n] only with a bias.
struct BwdWork {
  bf16* xn;
  float2* stats;
  bf16* qk;
  float *unit, *norm, *biasT;
  bf16 *v, *dO, *o, *dq, *dkv;
  float4* mld;
  float *dxn, *dxd;
};

static int attn_bwd_launch(const BwdIn& in, const BwdWork& w, const BwdOut& out, int R, int n,
                           int D, int H, float scale, int residual, cudaStream_t st) {
  using sm90::BN;
  const int M = R * n, HD = H * tc::DH, tiles = HD / BN;
  sm90::Maps proj{}, dom{}, dxnm{}, dxdm{};
  int err = sm90::map_a(&proj.m[0], w.xn, M, D, D);
  if (!err) err = sm90::map_a(&proj.m[1], in.x, M, D, D);
  if (!err) err = sm90::map_b(&proj.m[2], in.wq, HD, D, D);
  if (!err) err = sm90::map_b(&proj.m[3], in.wk, HD, D, D);
  if (!err) err = sm90::map_b(&proj.m[4], in.wv, HD, D, D);
  if (!err) err = sm90::map_a(&dom.m[0], in.g, M, D, D);
  if (!err) err = sm90::map_b(&dom.m[1], in.woT, HD, D, D);
  if (!err) err = sm90::map_a(&dxnm.m[0], w.dq, M, HD, HD);
  if (!err) err = sm90::map_b(&dxnm.m[1], in.wqT, D, HD, HD);
  if (!err) err = sm90::map_a(&dxdm.m[0], w.dkv, M, 2 * HD, 2 * HD);
  if (!err) err = sm90::map_b(&dxdm.m[1], in.wkvT, D, 2 * HD, 2 * HD);
  if (err) return err;
  ln_rows_kernel<><<<(M + 7) / 8, 256, 0, st>>>(in.x, in.gamma, nullptr, w.xn, w.stats, M, D);
  err = sm90::launch_gemm(proj, sm90::QkvPlan{tiles},
                          tc::QkvEpi{w.qk, w.v, in.qs, in.ks, scale, M, HD, tiles, w.unit, w.norm},
                          3 * tiles, M, D, st);
  if (!err)
    err = sm90::launch_gemm(dom, sm90::LinearPlan{}, sm90::ResidualEpi{w.dO, nullptr, M, HD, 0},
                            (HD + BN - 1) / BN, M, D, st);
  if (!err) err = tc::launch_block_core<true>(w.qk, w.v, in.bias, w.o, R, n, H, w.mld, w.dO, st);
  if (err) return err;

  const int smem = (int)tc::core_smem_bytes(n), smem_kv = (int)tc::dkv_smem_bytes(n);
  auto dq_pass = in.bias == nullptr ? tc::bwd_dq_kernel<0>
                 : (n % 2 == 0)     ? tc::bwd_dq_kernel<2>
                                    : tc::bwd_dq_kernel<1>;
  auto dkv_pass = in.bias == nullptr ? tc::bwd_dkv_kernel<0>
                  : (n % 2 == 0)     ? tc::bwd_dkv_kernel<2>
                                     : tc::bwd_dkv_kernel<1>;
  cudaFuncSetAttribute(dq_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(dkv_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (in.bias != nullptr) {
    dim3 gt((n + 31) / 32, (n + 31) / 32, H);
    tc::transpose_kernel<><<<gt, 256, 0, st>>>(in.bias, w.biasT, n);
  }
  dim3 grid(R, (n + tc::QT - 1) / tc::QT, H);
  dq_pass<<<grid, tc::core_threads(n), smem, st>>>(w.qk, w.v, w.dO, in.bias, w.mld, w.unit, w.norm,
                                                   in.qs, scale, w.dq, out.dqs, M, n, HD);
  dkv_pass<<<grid, tc::core_threads(n), smem_kv, st>>>(w.qk, w.v, w.dO, w.biasT, w.mld, w.unit,
                                                       w.norm, in.ks, w.dkv, out.dks, M, n, HD);
  if (out.dbias != nullptr) {
    dim3 gb((n + tc::KC - 1) / tc::KC, (n + tc::DB_QT - 1) / tc::DB_QT, H);
    cudaFuncSetAttribute(tc::bwd_dbias_kernel<>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         tc::DB_SMEM);
    tc::bwd_dbias_kernel<><<<gb, tc::DB_WARPS * 32, tc::DB_SMEM, st>>>(
        w.qk, w.v, w.dO, in.bias, w.mld, out.dbias, R, n, HD);
  }
  err = (int)cudaGetLastError();
  if (!err)
    err = sm90::launch_gemm(dxnm, sm90::LinearPlan{}, sm90::StoreF32Epi{w.dxn, M, D},
                            (D + BN - 1) / BN, M, HD, st);
  if (!err)
    err = sm90::launch_gemm(dxdm, sm90::LinearPlan{}, sm90::StoreF32Epi{w.dxd, M, D},
                            (D + BN - 1) / BN, M, 2 * HD, st);
  if (err) return err;
  launch_ln_bwd(in.x, w.stats, w.dxn, w.dxd, residual ? in.g : nullptr, in.gamma, out.dx,
                out.dgamma, nullptr, M, D, st);
  launch_wgrad(RowMajor{w.dq, HD, M, HD}, RowMajor{w.xn, D, M, D}, out.dwq, D, HD, D, M, st);
  launch_wgrad(RowMajor{w.dkv, 2 * HD, M, 2 * HD}, RowMajor{in.x, D, M, D}, out.dwkv, D, 2 * HD,
               D, M, st);
  launch_wgrad(RowMajor{in.g, D, M, D}, RowMajor{w.o, HD, M, HD}, out.dwo, HD, D, HD, M, st);
  return (int)cudaGetLastError();
}

// Largest sequence length the passes take: the key pass's three staged bf16
// planes and each query's (lse, D) in one block's shared memory.
static int attn_bwd_max_n() {
  int n = tc::KC;
  while (tc::dkv_smem_bytes(n + tc::KC) <= 227 * 1024) n += tc::KC;
  return n;
}

}  // namespace ctc
