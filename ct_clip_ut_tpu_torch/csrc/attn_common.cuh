// Pieces of the short-sequence attention chain on the CUDA cores
// (attn_packed.cu, the temporal block):
//
//   qkv_proj_kernel  LN(x) @ Wq^T, x @ Wk^T, x @ Wv^T over all rows at full
//                    width (k and v from the PRE-norm x). The epilogue
//                    l2-normalises each 32-wide head of q and k and applies
//                    q_scale * scale and k_scale, keeping them fp32 as the
//                    TPU kernel does; v is rounded to bf16, the point where
//                    the TPU kernel casts it before PV.
//   attend_row       one query row of one head against keys staged in
//                    shared memory: fp32 scores, fp32 softmax,
//                    p rounded to bf16, PV with fp32 accumulation, the
//                    per-head output rounded to bf16 (the TPU kernel casts o
//                    before the output projection).
//   out_proj_kernel  O @ Wo^T (+ x in fp32) rounded to the output dtype.
//
// Layouts: x [M, D] bf16 (M = sequences * n); Wq/Wk/Wv [HD, D] and Wo
// [D, HD] bf16 (nn.Linear (out, in)); q/k workspaces [M, HD] fp32; v and
// O workspaces [M, HD] bf16; HD = heads * 32.
#pragma once

#include "gemm_tile.cuh"

namespace ctc {

constexpr int DH = 32;       // head width the attention cores take
constexpr int KS_LD = 36;    // fp32 stride of a staged key row (16-B aligned, conflict-free float4)

template <int Dummy = 0>
__global__ void __launch_bounds__(THREADS)
qkv_proj_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                const bf16* __restrict__ wq, const bf16* __restrict__ wk,
                const bf16* __restrict__ wv, const float* __restrict__ qs,
                const float* __restrict__ ks, float* __restrict__ q_out,
                float* __restrict__ k_out, bf16* __restrict__ v_out, int M, int D, int HD,
                float scale) {
  extern __shared__ __align__(128) char smem[];
  float2* stats = reinterpret_cast<float2*>(smem + GEMM_SMEM);
  const int tiles_per = HD / BN;
  const int which = blockIdx.x / tiles_per;           // 0 q, 1 k, 2 v
  const int n0 = (blockIdx.x % tiles_per) * BN;
  const int row0 = blockIdx.y * BM;

  const RowMajor xa{x, D, M, D};
  const bf16* w = which == 0 ? wq : (which == 1 ? wk : wv);
  const RowMajor wb{w + (int64_t)n0 * D, D, HD - n0, D};
  auto load_b = [&](int r, int k) { return wb.load8(r, k); };

  if (which == 0) {
    ln_row_stats(xa, row0, 1e-5f, stats);
    __syncthreads();
    auto load_a = [&](int r, int k) {
      return ln_apply8(xa.load8(row0 + r, k), stats[r], gamma, nullptr, k, D);
    };
    block_gemm(load_a, load_b, D, smem);
  } else {
    auto load_a = [&](int r, int k) { return xa.load8(row0 + r, k); };
    block_gemm(load_a, load_b, D, smem);
  }

  const float* C = reinterpret_cast<const float*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (which == 2) {
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      int r = i / BN, c = i % BN;
      if (row0 + r < M) v_out[(int64_t)(row0 + r) * HD + n0 + c] = __float2bfloat16(C[r * LDC + c]);
    }
    return;
  }
  float* out = which == 0 ? q_out : k_out;
  const float sc = which == 0 ? qs[lane] * scale : ks[lane];
  // one (row, head) pair per warp iteration, lane = position in the head
  for (int p = warp; p < BM * (BN / DH); p += THREADS / 32) {
    int r = p / (BN / DH), h = p % (BN / DH);
    if (row0 + r >= M) continue;
    float v = C[r * LDC + h * DH + lane];
    float nrm = sqrtf(warp_sum(v * v));
    out[(int64_t)(row0 + r) * HD + n0 + h * DH + lane] = v / fmaxf(nrm, 1e-12f) * sc;
  }
}

template <int Dummy = 0>
__global__ void __launch_bounds__(THREADS)
out_proj_kernel(const bf16* __restrict__ o, const bf16* __restrict__ wo,
                const bf16* __restrict__ x, bf16* __restrict__ out, int M, int D, int HD,
                int residual) {
  extern __shared__ __align__(128) char smem[];
  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const RowMajor oa{o, HD, M, HD};
  const RowMajor wb{wo + (int64_t)n0 * HD, HD, D - n0, HD};
  auto load_a = [&](int r, int k) { return oa.load8(row0 + r, k); };
  auto load_b = [&](int r, int k) { return wb.load8(r, k); };
  block_gemm(load_a, load_b, HD, smem);

  const float* C = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    int r = i / BN, c = i % BN;
    int m = row0 + r, n = n0 + c;
    if (m >= M || n >= D) continue;
    float y = C[r * LDC + c];
    if (residual) y += __bfloat162float(x[(int64_t)m * D + n]);
    out[(int64_t)m * D + n] = __float2bfloat16(y);
  }
}

// Stage the keys and values of one (sequence, head): ks[j][0..31] fp32 with
// stride KS_LD, vs[j][0..31] bf16. Called by `nthreads` threads with ids
// `t` = 0..nthreads-1.
__device__ __forceinline__ void stage_kv(const float* __restrict__ k, const bf16* __restrict__ v,
                                         int64_t row0, int n, int HD, int h, float* ks, bf16* vs,
                                         int t, int nthreads) {
  for (int i = t; i < n * DH; i += nthreads) {
    int j = i / DH, d = i % DH;
    int64_t g = (row0 + j) * HD + h * DH + d;
    ks[j * KS_LD + d] = k[g];
    vs[j * DH + d] = v[g];
  }
}

// One query row of one head, computed by one warp. q: 32 fp32 in `qrow`
// (shared, already normalised and scaled); keys/values staged by stage_kv;
// prow: n fp32 of per-warp scratch. Returns the output element for head
// position `lane`, before rounding.
__device__ __forceinline__ float attend_row(const float* qrow, const float* ks, const bf16* vs,
                                            int n, float* prow, int lane) {
  float q[DH];
#pragma unroll
  for (int d = 0; d < DH; d += 4) {
    float4 t = *reinterpret_cast<const float4*>(qrow + d);
    q[d] = t.x; q[d + 1] = t.y; q[d + 2] = t.z; q[d + 3] = t.w;
  }
  float mx = -CUDART_INF_F;
  for (int j = lane; j < n; j += 32) {
    const float* kr = ks + j * KS_LD;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      float4 t = *reinterpret_cast<const float4*>(kr + d);
      s = fmaf(q[d], t.x, s);
      s = fmaf(q[d + 1], t.y, s);
      s = fmaf(q[d + 2], t.z, s);
      s = fmaf(q[d + 3], t.w, s);
    }
    prow[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < n; j += 32) {
    float e = expf(prow[j] - mx);
    prow[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < n; j += 32) {
    prow[j] = __bfloat162float(__float2bfloat16(prow[j] / sum));
  }
  __syncwarp();
  // PV: lanes 0-15 take even keys, 16-31 odd keys; each lane owns 2 columns
  const int half = lane >> 4, c2 = (lane & 15) * 2;
  float a0 = 0.f, a1 = 0.f;
  for (int j = half; j < n; j += 2) {
    float p = prow[j];
    __nv_bfloat162 vv = *reinterpret_cast<const __nv_bfloat162*>(vs + j * DH + c2);
    a0 = fmaf(p, __low2float(vv), a0);
    a1 = fmaf(p, __high2float(vv), a1);
  }
  a0 += __shfl_xor_sync(0xffffffffu, a0, 16);
  a1 += __shfl_xor_sync(0xffffffffu, a1, 16);
  // lane d wants column d: column c2 lives in lane c2/2 (a0) and c2+1 in the same lane (a1)
  float r0 = __shfl_sync(0xffffffffu, a0, (lane >> 1) & 15);
  float r1 = __shfl_sync(0xffffffffu, a1, (lane >> 1) & 15);
  __syncwarp();
  return (lane & 1) ? r1 : r0;
}

}  // namespace ctc
