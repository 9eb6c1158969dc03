// Spatial cosine-attention block: the port of
// ct_clip_ut_tpu/ops/pallas_attn_block.py:attention_block_fused
// (_forward_impl / _kernel).
//
// out = (softmax(l2n(LN(x) Wq^T) qs*scale . l2n(x Wk^T) ks + bias) (x Wv^T)) Wo^T (+ x)
// over R sequences of n tokens (the CT-ViT spatial stack: n = 576, 8 heads
// of 32, bias [8, 576, 576] fp32).
//
// What bounds it on the H100: the four projections are tensor-core GEMMs
// (2 * M * 512 * 256 * 4 FLOP); the core's 2 * R * 8 * n^2 * 32 * 2 FLOP,
// one exp per score and the fp32 bias, read from L2 for every (sequence,
// head). Four launches:
//   ln_rows_kernel      xn = LN(x) * gamma (no beta), bf16;
//   gemm_kernel         q from xn, k and v from the pre-norm x, on the
//                       Hopper core of gemm_sm90.cuh (QkvPlan picks the maps
//                       a tile reads). The q / k epilogue l2-normalises each
//                       32-wide head in registers (a head's columns of a row
//                       sit in one quad of 4 threads: two shuffles give the
//                       norm), applies q_scale * scale / k_scale and writes
//                       the fp32 result as a bf16 pair hi = bf16(y), lo =
//                       bf16(y - hi), 4 B an element like an fp32
//                       workspace; v is rounded to bf16 (the TPU kernel's
//                       cast before PV);
//   attn_core_kernel    the core on the tensor cores (mma.sync m16n8k16):
//                       scores as q_hi.k_hi + q_hi.k_lo + q_lo.k_hi in fp32,
//                       within ~2^-16 of the fp32 scores the TPU kernel
//                       takes (one bf16 product would err by ~1e-2 at scale
//                       8); K hi / lo and V of one (sequence, head) staged
//                       in shared memory once a block; each warp takes 16
//                       query rows in two passes: the running row max and
//                       sum, then the scores again, p = exp(s - m) / l
//                       rounded to bf16 (the TPU kernel's rounding point)
//                       and P.V with p fed from the score registers; o
//                       rounded to bf16;
//   gemm_kernel         O . Wo^T with the residual added in fp32.
// The blocks of the core run sequence fastest, so the sequences that share
// a (head, query tile) read the same bias rows from L2 side by side.
#include <math_constants.h>

#include "gemm_sm90.cuh"

namespace ctc {
namespace ab {

using namespace sm90;

constexpr int DH = 32;             // head width of the core
constexpr int CORE_WARPS = 8;      // 16 query rows each
constexpr int QT = CORE_WARPS * 16;
constexpr int KC = 64;             // keys a chunk; staged keys are padded to it
constexpr float LOG2E = 1.4426950408889634f;

struct QkvEpi {
  bf16* qk;              // [4][M][HD]: q_hi, q_lo, k_hi, k_lo
  bf16* v;               // [M][HD]
  const float* qs;
  const float* ks;
  float scale;
  int M, HD, tiles;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const int which = nt / tiles, n0 = (nt % tiles) * BN;
    const size_t plane = (size_t)M * HD;
    if (which == 2) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = row + g + 8 * hf;
        if (m < M) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(v + (size_t)m * HD + n0 + 8 * j + 2 * t) =
                __floats2bfloat162_rn(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
        }
      }
      return;
    }
    const float* sc = which == 0 ? qs : ks;
    const float mul = which == 0 ? scale : 1.f;
    bf16* hi = qk + 2 * which * plane;
    bf16* lo = hi + plane;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = row + g + 8 * hf;
#pragma unroll
      for (int hh = 0; hh < BN / DH; ++hh) {
        float ss = 0.f;
#pragma unroll
        for (int j = 4 * hh; j < 4 * hh + 4; ++j)
          ss += acc[4 * j + 2 * hf] * acc[4 * j + 2 * hf] +
                acc[4 * j + 2 * hf + 1] * acc[4 * j + 2 * hf + 1];
        ss += __shfl_xor_sync(0xffffffffu, ss, 1);
        ss += __shfl_xor_sync(0xffffffffu, ss, 2);
        const float nrm = fmaxf(sqrtf(ss), 1e-12f);
        if (m < M) {
#pragma unroll
          for (int j = 4 * hh; j < 4 * hh + 4; ++j) {
            const int d = 8 * (j - 4 * hh) + 2 * t;
            const float y0 = acc[4 * j + 2 * hf] / nrm * (sc[d] * mul);
            const float y1 = acc[4 * j + 2 * hf + 1] / nrm * (sc[d + 1] * mul);
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(y0, y1);
            const __nv_bfloat162 l2 =
                __floats2bfloat162_rn(y0 - __low2float(h2), y1 - __high2float(h2));
            const size_t off = (size_t)m * HD + n0 + 8 * j + 2 * t;
            *reinterpret_cast<__nv_bfloat162*>(hi + off) = h2;
            *reinterpret_cast<__nv_bfloat162*>(lo + off) = l2;
          }
        }
      }
    }
  }
};

// ---- the core --------------------------------------------------------------

// Byte offset of (key, 16-B chunk) in a staged [keys][32] bf16 plane: the
// chunk index XOR bits 1-2 of the key, so the 8 rows an ldmatrix reads hit
// 8 distinct bank groups.
__device__ __forceinline__ uint32_t swz(int key, int chunk) {
  return key * 64 + ((chunk ^ ((key >> 1) & 3)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__host__ __device__ __forceinline__ int padded_keys(int n) { return (n + KC - 1) / KC * KC; }

__host__ __device__ __forceinline__ size_t core_smem_bytes(int n) {
  return (size_t)padded_keys(n) * 3 * DH * 2;
}

// One block per (sequence r, query tile, head h); EVEN: n is even, so a
// pair of bias columns (2t, 2t + 1) is one 8-B load.
template <bool EVEN>
__global__ void __launch_bounds__(CORE_WARPS * 32, 2)
attn_core_kernel(const bf16* __restrict__ qk, const bf16* __restrict__ v,
                 const float* __restrict__ bias, bf16* __restrict__ o, int M, int n, int HD) {
  extern __shared__ __align__(128) char smem[];
  const int r = blockIdx.x, q0 = blockIdx.y * QT + (threadIdx.x >> 5) * 16, h = blockIdx.z;
  const int n_pad = padded_keys(n);
  const int64_t row0 = (int64_t)r * n;
  const size_t plane = (size_t)M * HD;
  const bf16* planes[3] = {qk + 2 * plane, qk + 3 * plane, v};   // k_hi, k_lo, v
  const uint32_t sbase = smem_u32(smem), pbytes = n_pad * DH * 2;
  for (int i = threadIdx.x; i < 3 * n_pad * 4; i += blockDim.x) {
    const int p = i / (n_pad * 4), rem = i - p * n_pad * 4, j = rem >> 2, c = rem & 3;
    const bf16* src = planes[p] + (row0 + min(j, n - 1)) * HD + h * DH + c * 8;
    cp_async16(sbase + p * pbytes + swz(j, c), src, j < n ? 16 : 0);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  if (q0 >= n) return;

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = q0 + g, rb = q0 + g + 8;
  const bool va = ra < n, vb = rb < n;
  // q hi / lo as A fragments of the two 16-deep steps over the head
  uint32_t qh[2][4], ql[2][4];
  {
    const bf16* q_hi = qk + (row0 + q0) * HD + h * DH;
    const bf16* q_lo = q_hi + plane;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = g + 8 * (i & 1), d = 16 * ks + 8 * (i >> 1) + 2 * t;
        const bool ok = (i & 1) ? vb : va;
        qh[ks][i] = ok ? *reinterpret_cast<const uint32_t*>(q_hi + (int64_t)rr * HD + d) : 0u;
        ql[ks][i] = ok ? *reinterpret_cast<const uint32_t*>(q_lo + (int64_t)rr * HD + d) : 0u;
      }
    }
  }
  const float* bias_a = bias + ((int64_t)h * n + (va ? ra : 0)) * n;
  const float* bias_b = bias + ((int64_t)h * n + (vb ? rb : 0)) * n;

  // s[jt] = scores (+ bias) of keys kc + 8 jt ..., -inf past n
  auto chunk_scores = [&](int kc, float (&s)[KC / 8][4]) {
#pragma unroll
    for (int jt = 0; jt < KC / 8; ++jt) {
      const int kb = kc + 8 * jt;
      uint32_t bh[4], bl[4];
      ldsm_x4(bh, sbase + swz(kb + (lane & 7), lane >> 3));
      ldsm_x4(bl, sbase + pbytes + swz(kb + (lane & 7), lane >> 3));
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma16816(c, qh[0], bl[0], bl[1]);
      mma16816(c, qh[1], bl[2], bl[3]);
      mma16816(c, ql[0], bh[0], bh[1]);
      mma16816(c, ql[1], bh[2], bh[3]);
      mma16816(c, qh[0], bh[0], bh[1]);
      mma16816(c, qh[1], bh[2], bh[3]);
      const int key = kb + 2 * t;
      float b[4] = {0.f, 0.f, 0.f, 0.f};
      if (EVEN) {
        if (key < n) {
          if (va) {
            const float2 w = *reinterpret_cast<const float2*>(bias_a + key);
            b[0] = w.x;
            b[1] = w.y;
          }
          if (vb) {
            const float2 w = *reinterpret_cast<const float2*>(bias_b + key);
            b[2] = w.x;
            b[3] = w.y;
          }
        }
      } else {
        if (va && key < n) b[0] = bias_a[key];
        if (va && key + 1 < n) b[1] = bias_a[key + 1];
        if (vb && key < n) b[2] = bias_b[key];
        if (vb && key + 1 < n) b[3] = bias_b[key + 1];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) s[jt][i] = key + (i & 1) < n ? c[i] + b[i] : -CUDART_INF_F;
    }
  };

  // pass 1: the running max and sum of each row over this thread's columns
  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;
  for (int kc = 0; kc < n_pad; kc += KC) {
    float s[KC / 8][4];
    chunk_scores(kc, s);
    float xa = m_a, xb = m_b;
#pragma unroll
    for (int jt = 0; jt < KC / 8; ++jt) {
      xa = fmaxf(xa, fmaxf(s[jt][0], s[jt][1]));
      xb = fmaxf(xb, fmaxf(s[jt][2], s[jt][3]));
    }
    // in log2 units; a row with no key yet keeps base 0 so no inf - inf
    const float ba = xa == -CUDART_INF_F ? 0.f : xa * LOG2E;
    const float bb = xb == -CUDART_INF_F ? 0.f : xb * LOG2E;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int jt = 0; jt < KC / 8; ++jt) {
      sa += exp2f(s[jt][0] * LOG2E - ba) + exp2f(s[jt][1] * LOG2E - ba);
      sb += exp2f(s[jt][2] * LOG2E - bb) + exp2f(s[jt][3] * LOG2E - bb);
    }
    l_a = l_a * exp2f(m_a * LOG2E - ba) + sa;
    l_b = l_b * exp2f(m_b * LOG2E - bb) + sb;
    m_a = xa;
    m_b = xb;
  }
  // the row's max and sum over its quad of threads
  auto row_stats = [&](float m, float l, float& base, float& inv) {
    float mq = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
    float lq = l * exp2f(m * LOG2E - mq * LOG2E);
    lq += __shfl_xor_sync(0xffffffffu, lq, 1);
    lq += __shfl_xor_sync(0xffffffffu, lq, 2);
    base = mq * LOG2E;
    inv = 1.f / lq;
  };
  float base_a, inv_a, base_b, inv_b;
  row_stats(m_a, l_a, base_a, inv_a);
  row_stats(m_b, l_b, base_b, inv_b);

  // pass 2: p = exp(s - m) / l rounded to bf16, then P.V
  float oacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
  const uint32_t vbase = sbase + 2 * pbytes;
  for (int kc = 0; kc < n_pad; kc += KC) {
    float s[KC / 8][4];
    chunk_scores(kc, s);
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* sj = s[2 * ks + u];
        a[2 * u] = pack_bf16(exp2f(sj[0] * LOG2E - base_a) * inv_a,
                             exp2f(sj[1] * LOG2E - base_a) * inv_a);
        a[2 * u + 1] = pack_bf16(exp2f(sj[2] * LOG2E - base_b) * inv_b,
                                 exp2f(sj[3] * LOG2E - base_b) * inv_b);
      }
      const int key = kc + 16 * ks + ((lane >> 3) & 1) * 8 + (lane & 7);
      uint32_t v0[4], v1[4];
      ldsm_x4_t(v0, vbase + swz(key, lane >> 4));
      ldsm_x4_t(v1, vbase + swz(key, 2 + (lane >> 4)));
      mma16816(oacc[0], a, v0[0], v0[1]);
      mma16816(oacc[1], a, v0[2], v0[3]);
      mma16816(oacc[2], a, v1[0], v1[1]);
      mma16816(oacc[3], a, v1[2], v1[3]);
    }
  }
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    const int col = h * DH + 8 * dt + 2 * t;
    if (va)
      *reinterpret_cast<__nv_bfloat162*>(o + (row0 + ra) * HD + col) =
          __floats2bfloat162_rn(oacc[dt][0], oacc[dt][1]);
    if (vb)
      *reinterpret_cast<__nv_bfloat162*>(o + (row0 + rb) * HD + col) =
          __floats2bfloat162_rn(oacc[dt][2], oacc[dt][3]);
  }
}

}  // namespace ab
}  // namespace ctc

using namespace ctc::sm90;
using ctc::ab::core_smem_bytes;

// x [R*n, D] bf16 (D a multiple of 8); gamma [D], qs/ks [32], bias [H, n, n]
// fp32; wq/wk/wv [HD, D], wo [D, HD] bf16; xn [R*n, D], qk [4, R*n, HD]
// (q_hi, q_lo, k_hi, k_lo), v_ws / o_ws [R*n, HD] bf16 workspaces; out
// [R*n, D] bf16. HD = H * 32, a multiple of 128; every pointer 16-B aligned.
extern "C" int ctc_attn_block(const void* x, const void* gamma, const void* wq, const void* wk,
                              const void* wv, const void* wo, const void* qs, const void* ks,
                              const void* bias, void* xn, void* qk, void* v_ws, void* o_ws,
                              void* out, int R, int n, int D, int H, float scale, int residual,
                              void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = R * n, HD = H * ctc::ab::DH, tiles = HD / BN;
  Maps proj{}, outm{};
  int err = map_a(&proj.m[0], xn, M, D, D);
  if (!err) err = map_a(&proj.m[1], x, M, D, D);
  if (!err) err = map_b(&proj.m[2], wq, HD, D, D);
  if (!err) err = map_b(&proj.m[3], wk, HD, D, D);
  if (!err) err = map_b(&proj.m[4], wv, HD, D, D);
  if (!err) err = map_a(&outm.m[0], o_ws, M, HD, HD);
  if (!err) err = map_b(&outm.m[1], wo, D, HD, HD);
  if (err) return err;
  err = launch_ln_rows(static_cast<const bf16*>(x), static_cast<const float*>(gamma), nullptr,
                       static_cast<bf16*>(xn), M, D, st);
  if (err) return err;
  err = launch_gemm(proj, QkvPlan{tiles},
                    ctc::ab::QkvEpi{static_cast<bf16*>(qk), static_cast<bf16*>(v_ws),
                                    static_cast<const float*>(qs), static_cast<const float*>(ks),
                                    scale, M, HD, tiles},
                    3 * tiles, M, D, st);
  if (err) return err;
  const int smem = (int)core_smem_bytes(n);
  auto core = (n % 2 == 0) ? ctc::ab::attn_core_kernel<true> : ctc::ab::attn_core_kernel<false>;
  cudaFuncSetAttribute(core, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 gc(R, (n + ctc::ab::QT - 1) / ctc::ab::QT, H);
  core<<<gc, ctc::ab::CORE_WARPS * 32, smem, st>>>(
      static_cast<const bf16*>(qk), static_cast<const bf16*>(v_ws),
      static_cast<const float*>(bias), static_cast<bf16*>(o_ws), M, n, HD);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_gemm(outm, LinearPlan{},
                     ResidualEpi{static_cast<bf16*>(out), static_cast<const bf16*>(x), M, D,
                                 residual},
                     (D + BN - 1) / BN, M, HD, st);
}

// Largest sequence length whose staged keys and values fit a block's shared memory.
extern "C" int ctc_attn_block_max_n(void) {
  int n = ctc::ab::KC;
  while (core_smem_bytes(n + ctc::ab::KC) <= 227 * 1024) n += ctc::ab::KC;
  return n;
}
