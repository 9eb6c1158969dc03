// The cosine-attention block's backward, shared by attn_block_bwd.cu
// (spatial, with a position bias) and attn_packed_bwd.cu (temporal, short
// sequences, no bias): the port of pallas_attn_block._backward_impl /
// _bwd_kernel and pallas_attn_packed._backward_impl / _bwd_kernel.
//
// Given x [R*n, D] bf16, the block's weights and the output cotangent g, it
// recomputes the forward and returns dx (+ g under `residual`), dgamma,
// dWq, dWk | dWv, dWo, dq_scale, dk_scale and (with a bias) dbias [H, n, n]
// summed over the R sequences, at the TPU kernel's rounding points: dO, P,
// dS, the per-head output and dq / dk / dv rounded to bf16 before the
// products that use them; scores, softmax, the l2-norm backward and every
// accumulation in fp32.
//
// What bounds it on the H100: the nine [M, 512] x [512, 256]-class
// projection products (tensor cores) and the n^2 core on the CUDA cores,
// which reads its staged rows from shared memory. The TPU kernel keeps the
// whole sequence's q/k/v and their gradients in VMEM (seven [h*dh, n] fp32
// scratches, 4.1 MB at n = 576); a block here has 227 KB. So the design is
// flash-attention-2's split into a query pass and a key pass over one
// (sequence, head) at a time, with q/k/v, dO, O and dq/dk/dv in global
// workspaces (as the forward keeps q/k/v):
//
//   ln_rows_kernel        xn = LN(x) gamma (bf16), per-row (mean, rstd)
//   gemm_nt x 4           q = xn Wq^T, k = x Wk^T (fp32, raw), v = x Wv^T
//                         and dO = g Wo (bf16)
//   attn_bwd_q_kernel     per (sequence, head, query tile): keys l2-normed
//                         and staged; per query row (one warp) scores + bias,
//                         softmax (row max m and sum l saved), O = bf16(P) V,
//                         the row term D = rowsum(dO o O) (flash-attention's
//                         form of sum_j dP P), dS = P (dP - D), dbias += dS
//                         (fp32 atomicAdd: 48 sequences into one [8, 576,
//                         576] table at the flagship), dq^ = bf16(dS) bf16(k^),
//                         the scale + l2-norm backward -> dq (bf16), dq_scale
//   attn_bwd_kv_kernel    per (sequence, head, key tile): queries staged; per
//                         key row (one warp) P and dS recomputed from the
//                         saved (m, l, D) -- bit for bit the query pass's --,
//                         dV = bf16(P)^T dO, dk^ = bf16(dS)^T bf16(q^), the
//                         l2-norm backward -> dk | dv (bf16), dk_scale
//   gemm_nt x 2           dxn = dq Wq, dxd = dk Wk + dv Wv (fp32)
//   ln_bwd_rows_kernel    dx, dgamma
//   wgrad_kernel x 3      dWq = dq^T xn, dWk | dWv = (dk | dv)^T x, dWo = g^T O
//
// Thirteen launches. The scale gradients are summed per block in shared
// memory, then one fp32 atomicAdd per element per block.
#pragma once

#include "attn_common.cuh"
#include "bwd_common.cuh"

namespace ctc {

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16(v)); }

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

static size_t bwd_q_smem(int n, int warps) {
  return 4 * ((size_t)n * KS_LD + (size_t)n * DH / 2 + (size_t)warps * (round4(n) + 2 * DH) + DH);
}

static size_t bwd_kv_smem(int n, int warps) {
  return 4 * ((size_t)n * KS_LD + (size_t)n * DH / 2 + 4 * (size_t)n +
              (size_t)warps * (2 * round4(n) + 2 * DH) + DH);
}

template <int Dummy = 0>
__global__ void __launch_bounds__(512)
attn_bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dO,
                  const float* __restrict__ bias, const float* __restrict__ qs,
                  const float* __restrict__ ks, float scale, bf16* __restrict__ o_out,
                  bf16* __restrict__ dq_out, float4* __restrict__ mld, float* __restrict__ dqs,
                  float* __restrict__ dbias, int n, int H, int rows_per_block) {
  extern __shared__ __align__(128) char smem[];
  const int W = blockDim.x >> 5;
  const int r = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * rows_per_block;
  const int HD = H * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* khs = reinterpret_cast<float*>(smem);                  // [n][KS_LD]
  bf16* vs = reinterpret_cast<bf16*>(khs + n * KS_LD);          // [n][DH]
  float* wbase = khs + n * KS_LD + n * DH / 2;
  float* prow = wbase + warp * (round4(n) + 2 * DH);            // [n]
  float* qrow = prow + round4(n);                               // [DH]
  float* dorow = qrow + DH;                                     // [DH]
  float* red = wbase + W * (round4(n) + 2 * DH);                // [DH]
  const int64_t row0 = (int64_t)r * n;
  if (threadIdx.x < DH) red[threadIdx.x] = 0.f;
  for (int j = warp; j < n; j += W) {
    const int64_t gi = (row0 + j) * HD + h * DH + lane;
    const float kr = k[gi];
    const float nrm = sqrtf(warp_sum(kr * kr));
    khs[j * KS_LD + lane] = kr / fmaxf(nrm, 1e-12f) * ks[lane];
    vs[j * DH + lane] = v[gi];
  }
  __syncthreads();

  const float qsc = qs[lane] * scale;
  float dqs_acc = 0.f;
  const int q1 = min(q0 + rows_per_block, n);
  for (int i = q0 + warp; i < q1; i += W) {
    const int64_t gi = (row0 + i) * HD + h * DH + lane;
    const float qr = q[gi];
    const float qn = fmaxf(sqrtf(warp_sum(qr * qr)), 1e-12f);
    const float uq = qr / qn;
    qrow[lane] = qr / qn * qsc;
    dorow[lane] = __bfloat162float(dO[gi]);
    __syncwarp();
    float qv[DH];
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      float4 t = *reinterpret_cast<const float4*>(qrow + d);
      qv[d] = t.x; qv[d + 1] = t.y; qv[d + 2] = t.z; qv[d + 3] = t.w;
    }
    const float* brow = bias != nullptr ? bias + ((int64_t)h * n + i) * n : nullptr;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < n; j += 32) {
      const float* kr = khs + j * KS_LD;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        float4 t = *reinterpret_cast<const float4*>(kr + d);
        s = fmaf(qv[d], t.x, s);
        s = fmaf(qv[d + 1], t.y, s);
        s = fmaf(qv[d + 2], t.z, s);
        s = fmaf(qv[d + 3], t.w, s);
      }
      if (brow != nullptr) s += brow[j];
      prow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) prow[j] = prow[j] / sum;
    __syncwarp();
    // O = bf16(P) V (attend_row's PV): lanes 0-15 even keys, 16-31 odd keys
    const int half = lane >> 4, c2 = (lane & 15) * 2;
    float a0 = 0.f, a1 = 0.f;
    for (int j = half; j < n; j += 2) {
      const float p = bf16r(prow[j]);
      __nv_bfloat162 vv = *reinterpret_cast<const __nv_bfloat162*>(vs + j * DH + c2);
      a0 = fmaf(p, __low2float(vv), a0);
      a1 = fmaf(p, __high2float(vv), a1);
    }
    a0 += __shfl_xor_sync(0xffffffffu, a0, 16);
    a1 += __shfl_xor_sync(0xffffffffu, a1, 16);
    const float r0 = __shfl_sync(0xffffffffu, a0, (lane >> 1) & 15);
    const float r1 = __shfl_sync(0xffffffffu, a1, (lane >> 1) & 15);
    const float o = (lane & 1) ? r1 : r0;
    o_out[gi] = __float2bfloat16(o);
    const float drow = warp_sum(dorow[lane] * o);
    if (lane == 0) mld[((int64_t)r * H + h) * n + i] = make_float4(mx, sum, drow, 0.f);
    // dS = P (dP - D); dbias += dS; prow <- bf16(dS)
    float dov[DH];
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      float4 t = *reinterpret_cast<const float4*>(dorow + d);
      dov[d] = t.x; dov[d + 1] = t.y; dov[d + 2] = t.z; dov[d + 3] = t.w;
    }
    for (int j = lane; j < n; j += 32) {
      const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(vs + j * DH);
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH / 2; ++d) {
        const __nv_bfloat162 vv = vr[d];
        dp = fmaf(dov[2 * d], __low2float(vv), dp);
        dp = fmaf(dov[2 * d + 1], __high2float(vv), dp);
      }
      const float ds = prow[j] * (dp - drow);
      if (dbias != nullptr) atomicAdd(dbias + ((int64_t)h * n + i) * n + j, ds);
      prow[j] = bf16r(ds);
    }
    __syncwarp();
    float dqh = 0.f;
    for (int j = 0; j < n; ++j) dqh = fmaf(prow[j], bf16r(khs[j * KS_LD + lane]), dqh);
    dqs_acc = fmaf(uq, dqh, dqs_acc);
    const float duq = dqh * qsc;
    const float dot = warp_sum(uq * duq);
    dq_out[gi] = __float2bfloat16((duq - uq * dot) / qn);
    __syncwarp();
  }
  atomicAdd(&red[lane], dqs_acc);
  __syncthreads();
  if (threadIdx.x < DH) atomicAdd(dqs + threadIdx.x, red[threadIdx.x] * scale);
}

template <int Dummy = 0>
__global__ void __launch_bounds__(512)
attn_bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dO,
                   const float* __restrict__ bias, const float* __restrict__ qs,
                   const float* __restrict__ ks, float scale, const float4* __restrict__ mld,
                   bf16* __restrict__ dkv_out, float* __restrict__ dks, int n, int H,
                   int keys_per_block) {
  extern __shared__ __align__(128) char smem[];
  const int W = blockDim.x >> 5;
  const int r = blockIdx.x, h = blockIdx.y, k0 = blockIdx.z * keys_per_block;
  const int HD = H * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qhs = reinterpret_cast<float*>(smem);                  // [n][KS_LD]
  bf16* dos = reinterpret_cast<bf16*>(qhs + n * KS_LD);         // [n][DH]
  float4* ml = reinterpret_cast<float4*>(qhs + n * KS_LD + n * DH / 2);   // [n]
  float* wbase = reinterpret_cast<float*>(ml + n);
  float* prow = wbase + warp * (2 * round4(n) + 2 * DH);        // [n] bf16(P)
  float* dsrow = prow + round4(n);                              // [n] bf16(dS)
  float* krow = dsrow + round4(n);                              // [DH]
  float* vrow = krow + DH;                                      // [DH]
  float* red = wbase + W * (2 * round4(n) + 2 * DH);            // [DH]
  const int64_t row0 = (int64_t)r * n;
  if (threadIdx.x < DH) red[threadIdx.x] = 0.f;
  const float qsc = qs[lane] * scale;
  for (int i = warp; i < n; i += W) {
    const int64_t gi = (row0 + i) * HD + h * DH + lane;
    const float qr = q[gi];
    const float qn = fmaxf(sqrtf(warp_sum(qr * qr)), 1e-12f);
    qhs[i * KS_LD + lane] = qr / qn * qsc;
    dos[i * DH + lane] = dO[gi];
    if (lane == 0) ml[i] = mld[((int64_t)r * H + h) * n + i];
  }
  __syncthreads();

  float dks_acc = 0.f;
  const int k1 = min(k0 + keys_per_block, n);
  for (int j = k0 + warp; j < k1; j += W) {
    const int64_t gj = (row0 + j) * HD + h * DH + lane;
    const float kr = k[gj];
    const float kn = fmaxf(sqrtf(warp_sum(kr * kr)), 1e-12f);
    const float uk = kr / kn;
    krow[lane] = kr / kn * ks[lane];
    vrow[lane] = __bfloat162float(v[gj]);
    __syncwarp();
    float kv[DH], vv[DH];
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      float4 t = *reinterpret_cast<const float4*>(krow + d);
      kv[d] = t.x; kv[d + 1] = t.y; kv[d + 2] = t.z; kv[d + 3] = t.w;
      float4 u = *reinterpret_cast<const float4*>(vrow + d);
      vv[d] = u.x; vv[d + 1] = u.y; vv[d + 2] = u.z; vv[d + 3] = u.w;
    }
    for (int i = lane; i < n; i += 32) {
      const float* qr = qhs + i * KS_LD;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        float4 t = *reinterpret_cast<const float4*>(qr + d);
        s = fmaf(t.x, kv[d], s);
        s = fmaf(t.y, kv[d + 1], s);
        s = fmaf(t.z, kv[d + 2], s);
        s = fmaf(t.w, kv[d + 3], s);
      }
      if (bias != nullptr) s += bias[((int64_t)h * n + i) * n + j];
      const float4 st = ml[i];
      const float p = expf(s - st.x) / st.y;
      const __nv_bfloat162* dr = reinterpret_cast<const __nv_bfloat162*>(dos + i * DH);
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH / 2; ++d) {
        const __nv_bfloat162 w2 = dr[d];
        dp = fmaf(__low2float(w2), vv[2 * d], dp);
        dp = fmaf(__high2float(w2), vv[2 * d + 1], dp);
      }
      prow[i] = bf16r(p);
      dsrow[i] = bf16r(p * (dp - st.z));
    }
    __syncwarp();
    float dv = 0.f, dkh = 0.f;
    for (int i = 0; i < n; ++i) {
      dv = fmaf(prow[i], __bfloat162float(dos[i * DH + lane]), dv);
      dkh = fmaf(dsrow[i], bf16r(qhs[i * KS_LD + lane]), dkh);
    }
    dks_acc = fmaf(uk, dkh, dks_acc);
    const float duk = dkh * ks[lane];
    const float dot = warp_sum(uk * duk);
    const int64_t o = (row0 + j) * 2 * HD + h * DH + lane;
    dkv_out[o] = __float2bfloat16((duk - uk * dot) / kn);
    dkv_out[o + HD] = __float2bfloat16(dv);
    __syncwarp();
  }
  atomicAdd(&red[lane], dks_acc);
  __syncthreads();
  if (threadIdx.x < DH) atomicAdd(dks + threadIdx.x, red[threadIdx.x]);
}

// Warps per block and rows (query or key) per block of the two core passes.
static void core_geometry(int n, int* warps, int* rows) {
  if (n >= 128) {
    *warps = 16;
    *rows = 96;
  } else {
    *warps = 4;
    *rows = n;
  }
}

// The whole chain. Workspaces and outputs are allocated by the caller; the
// outputs summed with atomics (dgamma, dwq, dwkv, dwo, dqs, dks, dbias) are
// zeroed by it. wqT [D, HD], wkvT [D, 2HD] (Wk^T | Wv^T) and woT [HD, D] are
// the transposed weights.
static int attn_bwd_launch(const bf16* x, const float* gamma, const bf16* wq, const bf16* wk,
                           const bf16* wv, const bf16* wqT, const bf16* wkvT, const bf16* woT,
                           const float* qs, const float* ks, const float* bias, const bf16* g,
                           bf16* xn, float2* stats, float* qw, float* kw, bf16* vw, bf16* dOw,
                           bf16* Ow, bf16* dqw, bf16* dkvw, float4* mld, float* dxn, float* dxd,
                           bf16* dx, float* dgamma, float* dwq, float* dwkv, float* dwo,
                           float* dqs, float* dks, float* dbias, int R, int n, int D, int H,
                           float scale, int residual, cudaStream_t st) {
  const int M = R * n, HD = H * DH;
  ln_rows_kernel<><<<(M + 7) / 8, 256, 0, st>>>(x, gamma, nullptr, xn, stats, M, D);
  launch_gemm_nt<float>(xn, D, wq, D, qw, HD, M, HD, D, st);
  launch_gemm_nt<float>(x, D, wk, D, kw, HD, M, HD, D, st);
  launch_gemm_nt<bf16>(x, D, wv, D, vw, HD, M, HD, D, st);
  launch_gemm_nt<bf16>(g, D, woT, D, dOw, HD, M, HD, D, st);

  int warps, rows;
  core_geometry(n, &warps, &rows);
  const int tiles = (n + rows - 1) / rows;
  const size_t smq = bwd_q_smem(n, warps), smk = bwd_kv_smem(n, warps);
  cudaFuncSetAttribute(attn_bwd_q_kernel<>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smq);
  cudaFuncSetAttribute(attn_bwd_kv_kernel<>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smk);
  dim3 gc(R, H, tiles);
  attn_bwd_q_kernel<><<<gc, warps * 32, smq, st>>>(qw, kw, vw, dOw, bias, qs, ks, scale, Ow, dqw,
                                                   mld, dqs, dbias, n, H, rows);
  attn_bwd_kv_kernel<><<<gc, warps * 32, smk, st>>>(qw, kw, vw, dOw, bias, qs, ks, scale, mld,
                                                    dkvw, dks, n, H, rows);

  launch_gemm_nt<float>(dqw, HD, wqT, HD, dxn, D, M, D, HD, st);
  launch_gemm_nt<float>(dkvw, 2 * HD, wkvT, 2 * HD, dxd, D, M, D, 2 * HD, st);
  launch_ln_bwd(x, stats, dxn, dxd, residual ? g : nullptr, gamma, dx, dgamma, nullptr, M, D, st);
  launch_wgrad(RowMajor{dqw, HD, M, HD}, RowMajor{xn, D, M, D}, dwq, D, HD, D, M, st);
  launch_wgrad(RowMajor{dkvw, 2 * HD, M, 2 * HD}, RowMajor{x, D, M, D}, dwkv, D, 2 * HD, D, M, st);
  launch_wgrad(RowMajor{g, D, M, D}, RowMajor{Ow, HD, M, HD}, dwo, HD, D, HD, M, st);
  return (int)cudaGetLastError();
}

// Largest sequence length whose staged rows fit a block's shared memory.
static int attn_bwd_max_n() {
  int n = 8;
  for (;;) {
    int warps, rows;
    core_geometry(n + 8, &warps, &rows);
    if (bwd_kv_smem(n + 8, warps) > 227 * 1024 || bwd_q_smem(n + 8, warps) > 227 * 1024) break;
    n += 8;
  }
  return n;
}

}  // namespace ctc
