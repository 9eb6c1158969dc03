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
// What bounds it on the H100: operations. 2 * B * n * D * (3D + D + 2F) in
// the four products plus 4 * B * heads * n * keys * dh in attention, 290
// GFLOP a layer at 36 x 512 with every key: 4.3 ms at the 67 TFLOP/s of
// fp32 FFMA. The tensor cores take bf16, whose one-pass products miss the
// fp32 layer by ~1e-3, so every product is made of three bf16 products
// with fp32 sums, a . b ~ a_hi b_hi + a_lo b_hi + a_hi b_lo with hi =
// bf16(a), lo = bf16(a - hi): within ~2^-16 of fp32 (the layer within
// ~5e-6 of its fp32 version on the CPU, where one-pass bf16 products miss
// by ~1e-3 and a one-pass P.V alone by ~3e-4). Bound of that route: three
// times the products at 989 TFLOP/s, 0.88 ms. The chain:
//   split_kernel x 5          x and the four weight matrices as hi / lo
//                             bf16 planes (per call)
//   gemm_kernel<SplitPlan>    qkv = x Wqkv^T + bqkv, written as hi / lo
//                             planes (SplitEpi): the Hopper core of
//                             gemm_sm90.cuh walking K three times, one pass
//                             a product
//   attn_kernel               per (sequence, head, 64 queries), mma.sync
//                             split-bf16 scores and P.V with an online
//                             softmax in fp32 over 64-key chunks staged by
//                             cp.async; key chunks whose keys the mask
//                             removes entirely (while the sequence has a
//                             real key) add exactly 0 and are skipped: a
//                             prompt of 6-14 tokens reads one chunk of 8;
//                             ctx written as hi / lo planes
//   gemm_kernel<SplitPlan>    r = ctx Wo^T + bo + x (fp32)
//   ln_split_kernel           y = LN1(r) in fp32 and as hi / lo planes
//   gemm_kernel<SplitPlan>    h = gelu(y W1^T + b1) as hi / lo planes (erff)
//   gemm_kernel<SplitPlan>    r = h W2^T + b2 + y (fp32)
//   ln_split_kernel           out = LN2(r)
// flags: ONE_PASS writes every lo plane as zeros (one-pass bf16 products:
// the control that shows the band needs the split); NO_SKIP walks every
// key chunk (the skipped chunks' sums are the same bits). The split pass,
// the LayerNorm rows and the fp32 output epilogue are split_sm90.cuh's.
#include "attn_mma.cuh"
#include "split_sm90.cuh"

namespace ctc {
namespace bert {

using bf16 = __nv_bfloat16;
using sm90::as_u32;
using sm90::BN;
using sm90::F32OutEpi;
using sm90::split;
using sm90::split2;
using tc::cp_async16;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma16816;

constexpr int ONE_PASS = 1, NO_SKIP = 2;

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// ---- epilogues of the products (registers in the wgmma D layout) ------------

// planes hi / lo [M, N] of acc + bias (GELU: of gelu(acc + bias)); N even
template <bool GELU>
struct SplitEpi {
  bf16* hi;
  bf16* lo;
  const float* bias;
  int M, N, keep_lo;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = nt * BN + 8 * j + 2 * t;
        if (c >= N) continue;
        const float2 bv = *reinterpret_cast<const float2*>(bias + c);
        float y0 = acc[4 * j + 2 * h] + bv.x, y1 = acc[4 * j + 2 * h + 1] + bv.y;
        if (GELU) {
          y0 = gelu_erf(y0);
          y1 = gelu_erf(y1);
        }
        __nv_bfloat162 hv, lv;
        split2(y0, y1, keep_lo, hv, lv);
        const int64_t off = (int64_t)m * N + c;
        *reinterpret_cast<__nv_bfloat162*>(hi + off) = hv;
        *reinterpret_cast<__nv_bfloat162*>(lo + off) = lv;
      }
    }
  }
};

// ---- the attention core -------------------------------------------------------

constexpr int DH = 64;                  // head width
constexpr int WARPS = 4;                // 16 query rows each
constexpr int QT = WARPS * 16;          // query rows a block
constexpr int KC = 64;                  // keys a staged chunk
constexpr int PLANE_B = KC * DH * 2;    // one staged plane: 64 rows of 128 B
constexpr int STAGE_B = 4 * PLANE_B;    // k_hi, k_lo, v_hi, v_lo
constexpr int ATTN_SMEM = 2 * STAGE_B;  // double-buffered
// A key whose mask lies below MASKED, in a sequence with a key above REAL,
// scores below every real key's by ~1e30: its exp is exactly 0 in fp32.
constexpr float MASKED = -1e30f, REAL = -1e20f;

// Byte offset of (row, 16-B chunk) in a staged [64][64] bf16 plane: the
// chunk index XOR the row's low three bits, so the 8 rows an ldmatrix reads
// hit 8 distinct bank groups.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// qkv planes hi / lo [B n][3D] (q, k, v of head h at columns h * 64, D +
// h * 64, 2D + h * 64); mask [B][n] additive; ctx planes [B n][D]. One
// block per (64 query rows, head, sequence).
__global__ void __launch_bounds__(WARPS * 32)
attn_kernel(const bf16* __restrict__ qkv_hi, const bf16* __restrict__ qkv_lo,
            const float* __restrict__ mask, bf16* __restrict__ ctx_hi, bf16* __restrict__ ctx_lo,
            int n, int D, float scale, int flags) {
  extern __shared__ __align__(128) char smem[];
  const int b = blockIdx.z, h = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, ld = 3 * D, nch = (n + KC - 1) / KC;
  const bool keep_lo = !(flags & ONE_PASS);
  const int64_t seq0 = (int64_t)b * n;
  const float* mrow = mask + seq0;
  const uint32_t sbase = sm90::smem_u32(smem);

  // every warp reaches the same answers from the same mask row, so the
  // block agrees on which chunks it stages
  bool any_real = false;
  if (!(flags & NO_SKIP)) {
    for (int k = lane; k < n; k += 32) any_real |= mrow[k] > REAL;
    any_real = __any_sync(0xffffffffu, any_real);
  }
  auto next_live = [&](int c) {
    for (; c < nch && any_real; ++c) {
      const int k0 = c * KC + lane, k1 = k0 + 32;
      const bool dead = (k0 >= n || mrow[k0] < MASKED) && (k1 >= n || mrow[k1] < MASKED);
      if (!__all_sync(0xffffffffu, dead)) break;
    }
    return c;
  };
  auto stage = [&](int c, int buf) {
    const uint32_t dst = sbase + buf * STAGE_B;
    for (int i = threadIdx.x; i < 4 * KC * 8; i += blockDim.x) {
      const int p = i / (KC * 8), j = (i >> 3) % KC, ch = i & 7, key = c * KC + j;
      const bf16* src = ((p & 1) ? qkv_lo : qkv_hi) + (seq0 + min(key, n - 1)) * ld +
                        (p < 2 ? D : 2 * D) + h * DH + ch * 8;
      cp_async16(dst + p * PLANE_B + swz(j, ch), src, key < n ? 16 : 0);
    }
  };

  const int q0 = blockIdx.x * QT + warp * 16, ra = q0 + g, rb = ra + 8;
  uint32_t qh[4][4], ql[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = q0 + g + 8 * (i & 1), d = 16 * ks + 8 * (i >> 1) + 2 * t;
      const int64_t off = (seq0 + rr) * ld + h * DH + d;
      qh[ks][i] = rr < n ? *reinterpret_cast<const uint32_t*>(qkv_hi + off) : 0u;
      ql[ks][i] = rr < n ? *reinterpret_cast<const uint32_t*>(qkv_lo + off) : 0u;
    }
  }
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;
  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  int c = next_live(0), buf = 0;
  if (c < nch) stage(c, 0);
  while (c < nch) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // chunk c is in `buf`; every warp is done with the other buffer
    const int nx = next_live(c + 1);
    if (nx < nch) stage(nx, buf ^ 1);
    if (q0 < n) {
      const uint32_t kh = sbase + buf * STAGE_B, kl = kh + PLANE_B, vh = kl + PLANE_B,
                     vl = vh + PLANE_B;
      // scores of keys c * KC + 8 jt ..., split-bf16, then scale and mask
      float s[8][4];
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t bh[4], bl[4];
          ldsm_x4(bh, kh + swz(8 * jt + (lane & 7), 4 * hf + (lane >> 3)));
          ldsm_x4(bl, kl + swz(8 * jt + (lane & 7), 4 * hf + (lane >> 3)));
          mma16816(acc, qh[2 * hf], bl[0], bl[1]);
          mma16816(acc, qh[2 * hf + 1], bl[2], bl[3]);
          mma16816(acc, ql[2 * hf], bh[0], bh[1]);
          mma16816(acc, ql[2 * hf + 1], bh[2], bh[3]);
          mma16816(acc, qh[2 * hf], bh[0], bh[1]);
          mma16816(acc, qh[2 * hf + 1], bh[2], bh[3]);
        }
        const int key = c * KC + 8 * jt + 2 * t;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = key + (i & 1);
          s[jt][i] = kk < n ? acc[i] * scale + mrow[kk] : -CUDART_INF_F;
        }
      }
      // online softmax: the rows' maxima over their quads, earlier sums rescaled
      float xa = m_a, xb = m_b;
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        xa = fmaxf(xa, fmaxf(s[jt][0], s[jt][1]));
        xb = fmaxf(xb, fmaxf(s[jt][2], s[jt][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, off));
        xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, off));
      }
      const float alpha_a = expf(m_a - xa), alpha_b = expf(m_b - xb);
      m_a = xa;
      m_b = xb;
      l_a *= alpha_a;
      l_b *= alpha_b;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        o[dt][0] *= alpha_a;
        o[dt][1] *= alpha_a;
        o[dt][2] *= alpha_b;
        o[dt][3] *= alpha_b;
      }
      // P.V, p = exp(s - m) in fp32 fed as hi / lo A fragments
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* sj = s[2 * ks + u];
          const float pa0 = expf(sj[0] - m_a), pa1 = expf(sj[1] - m_a);
          const float pb0 = expf(sj[2] - m_b), pb1 = expf(sj[3] - m_b);
          l_a += pa0 + pa1;
          l_b += pb0 + pb1;
          __nv_bfloat162 hv, lv;
          split2(pa0, pa1, keep_lo, hv, lv);
          ah[2 * u] = as_u32(hv);
          al[2 * u] = as_u32(lv);
          split2(pb0, pb1, keep_lo, hv, lv);
          ah[2 * u + 1] = as_u32(hv);
          al[2 * u + 1] = as_u32(lv);
        }
        const int row = 16 * ks + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t bh[4], bl[4];
          ldsm_x4_t(bh, vh + swz(row, 2 * dp + (lane >> 4)));
          ldsm_x4_t(bl, vl + swz(row, 2 * dp + (lane >> 4)));
          mma16816(o[2 * dp], al, bh[0], bh[1]);
          mma16816(o[2 * dp], ah, bl[0], bl[1]);
          mma16816(o[2 * dp], ah, bh[0], bh[1]);
          mma16816(o[2 * dp + 1], al, bh[2], bh[3]);
          mma16816(o[2 * dp + 1], ah, bl[2], bl[3]);
          mma16816(o[2 * dp + 1], ah, bh[2], bh[3]);
        }
      }
    }
    c = nx;
    buf ^= 1;
  }
  if (q0 >= n) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = h * DH + 8 * dt + 2 * t;
    __nv_bfloat162 hv, lv;
    if (ra < n) {
      split2(o[dt][0] * inv_a, o[dt][1] * inv_a, keep_lo, hv, lv);
      *reinterpret_cast<__nv_bfloat162*>(ctx_hi + (seq0 + ra) * D + col) = hv;
      *reinterpret_cast<__nv_bfloat162*>(ctx_lo + (seq0 + ra) * D + col) = lv;
    }
    if (rb < n) {
      split2(o[dt][2] * inv_b, o[dt][3] * inv_b, keep_lo, hv, lv);
      *reinterpret_cast<__nv_bfloat162*>(ctx_hi + (seq0 + rb) * D + col) = hv;
      *reinterpret_cast<__nv_bfloat162*>(ctx_lo + (seq0 + rb) * D + col) = lv;
    }
  }
}

// ---- host side ------------------------------------------------------------------

// The split product of planes a [2][M][K] and b [2][N][K] (hi, then lo).
template <class Epi>
inline int product(const bf16* a, const bf16* b, int M, int N, int K, const Epi& epi,
                   cudaStream_t st) {
  return sm90::split_product(a, a + (int64_t)M * K, K, b, b + (int64_t)N * K, K, M, N, K, epi,
                             st);
}

}  // namespace bert
}  // namespace ctc

using namespace ctc::bert;

// x [B*n, D], mask [B, n] (additive), wqkv [3D, D], bqkv [3D], wo [D, D],
// bo/g1/be1/b2/g2/be2 [D], w1 [F, D], b1 [F], w2 [D, F], all fp32 (weights
// in the nn.Linear (out, in) layout), 16-B aligned. Workspaces: bf16 hi /
// lo planes [2][rows][cols] of x, wqkv, wo, w1, w2 (as those), qkv [B*n,
// 3D], ctx [B*n, D], y [B*n, D], h [B*n, F]; fp32 r, y [B*n, D]. out [B*n,
// D]. D = heads * 64; F a multiple of 8. flags: ONE_PASS, NO_SKIP.
extern "C" int ctc_bert_layer(const void* x, const void* mask, const void* wqkv, const void* bqkv,
                              const void* wo, const void* bo, const void* g1, const void* be1,
                              const void* w1, const void* b1, const void* w2, const void* b2,
                              const void* g2, const void* be2, void* x_s, void* wqkv_s,
                              void* wo_s, void* w1_s, void* w2_s, void* qkv_s, void* ctx_s,
                              void* y_s, void* h_s, void* r_ws, void* y_ws, void* out, int B,
                              int n, int D, int F, int heads, int flags, float eps, float scale,
                              void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * n, keep = !(flags & ONE_PASS);
  bf16 *xs = (bf16*)x_s, *wqkvs = (bf16*)wqkv_s, *wos = (bf16*)wo_s, *w1s = (bf16*)w1_s,
       *w2s = (bf16*)w2_s, *qkvs = (bf16*)qkv_s, *ctxs = (bf16*)ctx_s, *ys = (bf16*)y_s,
       *hs = (bf16*)h_s;
  float *r = (float*)r_ws, *y = (float*)y_ws;
  const int64_t md = (int64_t)M * D;
  int err = split(x, xs, md, keep, st);
  if (!err) err = split(wqkv, wqkvs, (int64_t)3 * D * D, keep, st);
  if (!err) err = split(wo, wos, (int64_t)D * D, keep, st);
  if (!err) err = split(w1, w1s, (int64_t)F * D, keep, st);
  if (!err) err = split(w2, w2s, (int64_t)D * F, keep, st);
  if (!err)
    err = product(xs, wqkvs, M, 3 * D, D,
                  SplitEpi<false>{qkvs, qkvs + (int64_t)M * 3 * D, (const float*)bqkv, M, 3 * D,
                                  keep},
                  st);
  if (err) return err;
  cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ATTN_SMEM);
  dim3 ga((n + QT - 1) / QT, heads, B);
  attn_kernel<<<ga, WARPS * 32, ATTN_SMEM, st>>>(qkvs, qkvs + (int64_t)M * 3 * D,
                                                 (const float*)mask, ctxs, ctxs + md, n, D, scale,
                                                 flags);
  err = (int)cudaGetLastError();
  if (!err)
    err = product(ctxs, wos, M, D, D, F32OutEpi{r, (const float*)bo, (const float*)x, M, D},
                  st);
  if (err) return err;
  err = ctc::sm90::launch_ln_split(r, (const float*)g1, (const float*)be1, y, ys, ys + md,
                                   nullptr, nullptr, M, D, eps, keep, st);
  if (!err)
    err = product(ys, w1s, M, F, D,
                  SplitEpi<true>{hs, hs + (int64_t)M * F, (const float*)b1, M, F, keep}, st);
  if (!err)
    err = product(hs, w2s, M, D, F, F32OutEpi{r, (const float*)b2, y, M, D}, st);
  if (err) return err;
  return ctc::sm90::launch_ln_split(r, (const float*)g2, (const float*)be2, (float*)out,
                                    nullptr, nullptr, nullptr, nullptr, M, D, eps, keep, st);
}
