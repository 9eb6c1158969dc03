// One post-LN BERT encoder layer in fp32, deterministic: the port of
// ct_clip_ut_tpu/ops/pallas_bert_layer.py:bert_layer_fused (the forward,
// `_fwd_impl` / `_kernel_fwd` / `_fwd_body`).
//
//   qkv = x Wqkv^T + bqkv;  per head: p = softmax(q k^T / sqrt(dh) + mask);
//   ctx = p v;  y = LN1(ctx Wo^T + bo + x);  g = gelu_erf(y W1^T + b1);
//   out = LN2(g W2^T + b2 + y)
//
// over B sequences of n tokens (the zero-shot prompts: 36 x 512, D = 768,
// 12 heads of 64, F = 3072), with HF's additive key mask (0 or
// finfo(float32).min) and LayerNorm in the TPU kernel's one-pass
// E[r^2] - E[r]^2 form.
//
// What bounds it on the H100: fp32 operations. 2 * B * n * D * (3D + D + 2F)
// in the four products plus 4 * B * heads * n^2 * dh in attention: 290
// GFLOP per layer at 36 x 512, 4.3 ms at the 67 TFLOP/s fp32 (CUDA-core)
// rate; the bytes (activations and 28 MB of weights) take a hundredth of
// that. The function is fp32, so the products run as FFMA on the CUDA cores
// (no TF32, whose 10-bit mantissa is far coarser than the fp32 reference).
// The TPU kernel holds a whole layer in VMEM; one head's fp32 K and V at
// n = 512 (256 KB) do not even fit a block's 227 KB of shared memory, so the
// layer is a chain of seven launches, counted as one kernel:
//   sgemm_kernel<EpiBias>         qkv = x Wqkv^T + bqkv
//   bert_attn_kernel              per (sequence, head, 64 query rows): keys
//                                 and values streamed in tiles of 64 with an
//                                 online softmax (running max and sum), ctx
//   sgemm_kernel<EpiBiasResidual> r = ctx Wo^T + bo + x
//   bert_ln_kernel                y = LN1(r)
//   sgemm_kernel<EpiBiasGelu>     h = gelu(y W1^T + b1)   (erff, exact)
//   sgemm_kernel<EpiBiasResidual> r = h W2^T + b2 + y     (y in fp32)
//   bert_ln_kernel                out = LN2(r)
// The fp32 GEMM is a register-blocked tile: 128 x 128 per block of 256
// threads, 8 x 8 outputs per thread, K in steps of 8 double-buffered in
// shared memory through registers.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace ctc_bert {

constexpr int SG_BM = 128, SG_BN = 128, SG_BK = 8, SG_THREADS = 256;
constexpr int SG_LD = SG_BM + 4;  // 16-B aligned rows; the transposed stores hit distinct banks

struct EpiBias {
  const float* bias;
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float4 v) const {
    const float4 b = *reinterpret_cast<const float4*>(bias + n);
    *reinterpret_cast<float4*>(out + (int64_t)m * ld + n) =
        make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
  }
};

struct EpiBiasResidual {
  const float* bias;
  const float* res;
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float4 v) const {
    const float4 b = *reinterpret_cast<const float4*>(bias + n);
    const float4 r = *reinterpret_cast<const float4*>(res + (int64_t)m * ld + n);
    *reinterpret_cast<float4*>(out + (int64_t)m * ld + n) =
        make_float4((v.x + b.x) + r.x, (v.y + b.y) + r.y, (v.z + b.z) + r.z, (v.w + b.w) + r.w);
  }
};

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

struct EpiBiasGelu {
  const float* bias;
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float4 v) const {
    const float4 b = *reinterpret_cast<const float4*>(bias + n);
    *reinterpret_cast<float4*>(out + (int64_t)m * ld + n) =
        make_float4(gelu_erf(v.x + b.x), gelu_erf(v.y + b.y), gelu_erf(v.z + b.z),
                    gelu_erf(v.w + b.w));
  }
};

// C[M, N] = A[M, K] @ B[N, K]^T in fp32, handed to `epi` four columns at a
// time. K and N must be multiples of 4 and A, B 16-B aligned.
template <class Epi>
__global__ void __launch_bounds__(SG_THREADS)
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B, int M, int N, int K,
             Epi epi) {
  __shared__ __align__(16) float As[2][SG_BK][SG_LD];
  __shared__ __align__(16) float Bs[2][SG_BK][SG_LD];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * SG_BM, col0 = blockIdx.x * SG_BN;
  // each thread fetches one float4 of A and one of B per K step
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const bool a_ok = row0 + lr < M, b_ok = col0 + lr < N;
  const float* a_ptr = A + (int64_t)(a_ok ? row0 + lr : 0) * K + lk;
  const float* b_ptr = B + (int64_t)(b_ok ? col0 + lr : 0) * K + lk;
  auto fetch = [&](const float* p, bool ok, int k0) {
    if (ok && k0 + lk < K) return *reinterpret_cast<const float4*>(p + k0);
    return make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float4 ra = fetch(a_ptr, a_ok, 0), rb = fetch(b_ptr, b_ok, 0);
  auto stash = [&](int buf) {
    As[buf][lk + 0][lr] = ra.x;
    As[buf][lk + 1][lr] = ra.y;
    As[buf][lk + 2][lr] = ra.z;
    As[buf][lk + 3][lr] = ra.w;
    Bs[buf][lk + 0][lr] = rb.x;
    Bs[buf][lk + 1][lr] = rb.y;
    Bs[buf][lk + 2][lr] = rb.z;
    Bs[buf][lk + 3][lr] = rb.w;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  stash(0);
  __syncthreads();
  const int nk = (K + SG_BK - 1) / SG_BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      ra = fetch(a_ptr, a_ok, (kt + 1) * SG_BK);
      rb = fetch(b_ptr, b_ok, (kt + 1) * SG_BK);
    }
#pragma unroll
    for (int k = 0; k < SG_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) stash(cur ^ 1);
    __syncthreads();
  }
  // thread rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j and 64 + tx*4 + j
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = col0 + half * 64 + tx * 4;
      if (n < N) {
        epi(m, n, make_float4(acc[i][half * 4], acc[i][half * 4 + 1], acc[i][half * 4 + 2],
                              acc[i][half * 4 + 3]));
      }
    }
  }
}

constexpr int AT_DH = 64;       // head width the attention core takes
constexpr int AT_BQ = 64;       // query rows per block
constexpr int AT_BK = 64;       // keys per streamed tile
constexpr int AT_THREADS = 256;
constexpr int AT_LD = 68;       // fp32 stride of the shared tiles (16-B aligned rows)
constexpr int AT_SMEM = 4 * 64 * AT_LD * 4;

// Per block: one sequence, one head, AT_BQ query rows. Thread (ty, tx) owns
// query rows ty*4..+3 and, in turn, keys tx*4..+3 of the tile (scores) and
// head columns tx*4..+3 (output). The 16 threads of a query row are one half
// of a warp, so the row's max and sum reduce with shuffles.
__global__ void __launch_bounds__(AT_THREADS)
bert_attn_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                 float* __restrict__ ctx, int n, int D, float scale) {
  extern __shared__ __align__(16) float at_smem[];
  float* Qt = at_smem;                   // [dh][AT_LD]   q transposed
  float* Kt = Qt + AT_DH * AT_LD;        // [dh][AT_LD]   k transposed
  float* Vs = Kt + AT_DH * AT_LD;        // [key][AT_LD]
  float* Pt = Vs + AT_BK * AT_LD;        // [key][AT_LD]  p transposed
  const int q0 = blockIdx.x * AT_BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ld3 = 3 * D;
  const float* seq = qkv + (int64_t)b * n * ld3;
  const float* mrow = mask + (int64_t)b * n;

  // rows run fastest across threads so the transposed stores hit distinct banks
  for (int i = tid; i < AT_BQ * (AT_DH / 4); i += AT_THREADS) {
    const int r = i % AT_BQ, c = (i / AT_BQ) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < n) v = *reinterpret_cast<const float4*>(seq + (int64_t)(q0 + r) * ld3 + h * AT_DH + c);
    Qt[(c + 0) * AT_LD + r] = v.x;
    Qt[(c + 1) * AT_LD + r] = v.y;
    Qt[(c + 2) * AT_LD + r] = v.z;
    Qt[(c + 3) * AT_LD + r] = v.w;
  }

  float o[4][4], row_max[4], row_sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_max[i] = -CUDART_INF_F;
    row_sum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += AT_BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < AT_BK * (AT_DH / 4); i += AT_THREADS) {
      const int r = i % AT_BK, c = (i / AT_BK) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < n) kv = *reinterpret_cast<const float4*>(seq + (int64_t)(k0 + r) * ld3 + D + h * AT_DH + c);
      Kt[(c + 0) * AT_LD + r] = kv.x;
      Kt[(c + 1) * AT_LD + r] = kv.y;
      Kt[(c + 2) * AT_LD + r] = kv.z;
      Kt[(c + 3) * AT_LD + r] = kv.w;
    }
    for (int i = tid; i < AT_BK * (AT_DH / 4); i += AT_THREADS) {
      const int r = i / (AT_DH / 4), c = (i % (AT_DH / 4)) * 4;
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < n) vv = *reinterpret_cast<const float4*>(seq + (int64_t)(k0 + r) * ld3 + 2 * D + h * AT_DH + c);
      *reinterpret_cast<float4*>(Vs + r * AT_LD + c) = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < AT_DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * AT_LD + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(Kt + d * AT_LD + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w}, kw[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kw[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx * 4 + j;
      const float mk = key < n ? mrow[key] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = key < n ? s[i][j] * scale + mk : -CUDART_INF_F;
    }
    // online softmax: rescale what the earlier tiles summed to the new row max
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(row_max[i], mx);
      const float alpha = row_max[i] == -CUDART_INF_F ? 0.f : expf(row_max[i] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == -CUDART_INF_F ? 0.f : expf(s[i][j] - m_new);
        ls += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
      row_sum[i] = row_sum[i] * alpha + ls;
      row_max[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * AT_LD + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < AT_BK; ++k) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + k * AT_LD + ty * 4);
      const float4 vb = *reinterpret_cast<const float4*>(Vs + k * AT_LD + tx * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w}, vw[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(pv[i], vw[j], o[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    if (q >= n) continue;
    const float inv = 1.f / row_sum[i];
    *reinterpret_cast<float4*>(ctx + ((int64_t)b * n + q) * D + h * AT_DH + tx * 4) =
        make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out = LN(r) * gamma + beta per row of D, one warp per row; the moments in
// the one-pass form of pallas_bert_layer._ln_fwd.
__global__ void __launch_bounds__(256)
bert_ln_kernel(const float* __restrict__ r, const float* __restrict__ gamma,
               const float* __restrict__ beta, float* __restrict__ out, int M, int D, float eps) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (m >= M) return;
  const float* row = r + (int64_t)m * D;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = row[c];
    s += v;
    s2 += v * v;
  }
  const float mean = warp_sum(s) / (float)D;
  const float var = warp_sum(s2) / (float)D - mean * mean;
  const float rstd = rsqrtf(fmaxf(var, 0.f) + eps);
  for (int c = lane; c < D; c += 32) out[(int64_t)m * D + c] = (row[c] - mean) * rstd * gamma[c] + beta[c];
}

template <class Epi>
void sgemm(const float* A, const float* B, int M, int N, int K, Epi epi, cudaStream_t st) {
  dim3 grid((N + SG_BN - 1) / SG_BN, (M + SG_BM - 1) / SG_BM);
  sgemm_kernel<Epi><<<grid, SG_THREADS, 0, st>>>(A, B, M, N, K, epi);
}

}  // namespace ctc_bert

using namespace ctc_bert;

// x [B*n, D], mask [B, n] (additive), wqkv [3D, D], bqkv [3D], wo [D, D],
// bo/g1/be1/b2/g2/be2 [D], w1 [F, D], b1 [F], w2 [D, F], all fp32 (weights
// in the nn.Linear (out, in) layout); workspaces qkv [B*n, 3D], ctx, r, y
// [B*n, D], h [B*n, F]; out [B*n, D]. D = heads * 64; D and F multiples of 4.
extern "C" int ctc_bert_layer(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                              const void* wo, const void* bo, const void* g1, const void* be1,
                              const void* w1, const void* b1, const void* w2, const void* b2,
                              const void* g2, const void* be2, void* qkv_ws, void* ctx_ws,
                              void* r_ws, void* y_ws, void* h_ws, void* out, int B, int n, int D,
                              int F, int heads, float eps, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * n;
  const float* xf = (const float*)x;
  float* qkv = (float*)qkv_ws;
  float* ctx = (float*)ctx_ws;
  float* r = (float*)r_ws;
  float* y = (float*)y_ws;
  float* h = (float*)h_ws;
  sgemm(xf, (const float*)wqkv, M, 3 * D, D, EpiBias{(const float*)bqkv, qkv, 3 * D}, st);
  cudaFuncSetAttribute(bert_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, AT_SMEM);
  dim3 ga((n + AT_BQ - 1) / AT_BQ, heads, B);
  bert_attn_kernel<<<ga, AT_THREADS, AT_SMEM, st>>>(qkv, (const float*)mask, ctx, n, D, scale);
  sgemm((const float*)ctx, (const float*)wo, M, D, D,
        EpiBiasResidual{(const float*)bo, xf, r, D}, st);
  const int ln_blocks = (M + 7) / 8;
  bert_ln_kernel<<<ln_blocks, 256, 0, st>>>(r, (const float*)g1, (const float*)be1, y, M, D, eps);
  sgemm((const float*)y, (const float*)w1, M, F, D, EpiBiasGelu{(const float*)b1, h, F}, st);
  sgemm((const float*)h, (const float*)w2, M, D, F,
        EpiBiasResidual{(const float*)b2, (const float*)y, r, D}, st);
  bert_ln_kernel<<<ln_blocks, 256, 0, st>>>(r, (const float*)g2, (const float*)be2, (float*)out,
                                           M, D, eps);
  return (int)cudaGetLastError();
}
