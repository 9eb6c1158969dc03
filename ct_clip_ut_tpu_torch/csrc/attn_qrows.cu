// Query-row-stripe cosine attention with a streamed position bias: the port
// of ct_clip_ut_tpu/ops/pallas_attn_qrows.py:attention_qrows_fused
// (_forward_impl, both of its pallas_call sites: the per-item grid and the
// shared-bias kv variant).
//
// out = (softmax(l2n(LN(x) Wq^T) qs*scale . l2n(x Wk^T) ks + bias) (x Wv^T)) Wo^T (+ x)
// over B sequences of N tokens: MaskGit's self-attention over the CTGenerate
// token grid (N = 101 * 8 * 8 = 6,464, D = 512, 8 heads of 64, the layer-
// shared [8, N, N] CPB table in bf16, B = 1-4 scans).
//
// Rounding points: those of the kv variant (the bf16 serving route). LN(x)
// in fp32 (one-pass moments) rounded to bf16; q projected in fp32,
// l2-normalised, times q_scale * scale, rounded to bf16; k projected and
// rounded to bf16, then l2-normalised in fp32, times k_scale, rounded; v
// rounded; fp32 scores plus the bf16 bias; a full-row fp32 softmax; p
// normalised, then rounded to bf16 for PV; the per-head output rounded;
// the output projection in fp32 (+ x) rounded to bf16.
//
// What bounds it on the H100: bytes. The bias is 8 * N^2 * 2 B = 0.67 GB,
// read against 2 * B * N * D * 2 B of x and output (26 MB at B = 2) and
// 2 * B * (4 N D HD + 2 H N^2 64) FLOP (0.20 ms at the bf16 peak at B = 2,
// against 0.21 ms for the bytes). A 64-row score stripe of one head is
// 64 x 6464 fp32 = 1.65 MB: the TPU keeps it in VMEM, a block here has 227
// KB of shared memory. So the core makes TWO passes over the keys of each
// (query stripe, head, sequence), 64 keys at a time, with tensor-core
// (wmma, bf16 in, fp32 out) QK^T tiles: pass 1 keeps each row's running max
// and sum; pass 2 recomputes the scores, forms p = exp(s - max) / sum,
// rounds it to bf16 and accumulates PV in wmma fragments. Two passes keep
// the TPU kernel's rounding points (an online softmax would round
// unnormalised terms); the price is QK^T and the bias read twice. The
// blocks of one (stripe, head) for the B sequences are launched side by
// side (the batch is the fastest grid axis), so a bias tile read from
// device memory by one is served from L2 to the others: the kv variant's
// "one bias stripe for the whole batch", without holding the batch in one
// block. Any N works: rows and keys past N are masked.
//
// Chain of three launches: qrows_proj_kernel (LN + q, k and v projections
// with their per-head epilogues) -> qrows_core_kernel -> out_proj_kernel
// (attn_common.cuh, + x in fp32). Workspaces are allocated by the caller.
#include "attn_common.cuh"

namespace ctc {

constexpr int QR_DH = 64;                 // head width
constexpr int QR_BQ = 64;                 // query rows per block
constexpr int QR_BK = 64;                 // keys per tile
constexpr int QR_WARPS = QR_BQ / 16;      // one warp per 16 query rows
constexpr int QR_THREADS = QR_WARPS * 32;
constexpr int QR_LD = QR_DH + 8;          // bf16 stride of staged rows (144 B, 16-B aligned)
constexpr int QR_LDS = QR_BK + 4;         // fp32 stride of a warp's score tile

// LN(x) Wq^T, x Wk^T, x Wv^T over all rows at full width, with the per-head
// epilogues of the kv variant; q, k, v out as bf16 [M, HD].
template <int Dummy = 0>
__global__ void __launch_bounds__(THREADS)
qrows_proj_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                  const bf16* __restrict__ wq, const bf16* __restrict__ wk,
                  const bf16* __restrict__ wv, const float* __restrict__ qs,
                  const float* __restrict__ ks, bf16* __restrict__ q_out,
                  bf16* __restrict__ k_out, bf16* __restrict__ v_out, int M, int D, int HD,
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
  bf16* out = which == 0 ? q_out : k_out;
  const int d = 2 * lane;                             // this lane's two head positions
  const float sc0 = which == 0 ? qs[d] * scale : ks[d];
  const float sc1 = which == 0 ? qs[d + 1] * scale : ks[d + 1];
  // one (row, head) pair per warp iteration
  for (int p = warp; p < BM * (BN / QR_DH); p += THREADS / 32) {
    int r = p / (BN / QR_DH), hh = p % (BN / QR_DH);
    if (row0 + r >= M) continue;
    float v0 = C[r * LDC + hh * QR_DH + d], v1 = C[r * LDC + hh * QR_DH + d + 1];
    if (which == 1) {   // the k projection is rounded before its l2-norm
      v0 = __bfloat162float(__float2bfloat16(v0));
      v1 = __bfloat162float(__float2bfloat16(v1));
    }
    const float inv = 1.f / fmaxf(sqrtf(warp_sum(v0 * v0 + v1 * v1)), 1e-12f);
    *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)(row0 + r) * HD + n0 + hh * QR_DH + d) =
        __floats2bfloat162_rn(v0 * inv * sc0, v1 * inv * sc1);
  }
}

// Rows [r0, r0 + 64) of head columns [hc, hc + 64) of a [B*N, HD] bf16
// buffer (sequence at row `base`) into shared [64][QR_LD]; rows past N zero.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int64_t base,
                                           int r0, int N, int HD, int hc) {
  for (int c = threadIdx.x; c < 64 * (QR_DH / 8); c += QR_THREADS) {
    const int r = c / (QR_DH / 8), col = (c % (QR_DH / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N) v = *reinterpret_cast<const uint4*>(src + (base + r0 + r) * HD + hc + col);
    *reinterpret_cast<uint4*>(dst + r * QR_LD + col) = v;
  }
}

// S[16][64] = Q (this warp's 16 rows, fragments fq) . K_tile^T into sw.
__device__ __forceinline__ void score_tile(
    const nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16,
                                 nvcuda::wmma::row_major> (&fq)[QR_DH / 16],
    const bf16* ks, float* sw) {
  using namespace nvcuda;
#pragma unroll
  for (int nt = 0; nt < QR_BK / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < QR_DH / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
      wmma::load_matrix_sync(fk, ks + nt * 16 * QR_LD + kk * 16, QR_LD);
      wmma::mma_sync(acc, fq[kk], fk, acc);
    }
    wmma::store_matrix_sync(sw + nt * 16, acc, QR_LDS, wmma::mem_row_major);
  }
}

// This lane's 32 scores of tile row `r` (keys j0 + half*32 ...), plus the
// bias row of query i, keys past N at -inf.
__device__ __forceinline__ void lane_scores(float (&s)[32], const float* sw, int r, int half,
                                            const bf16* __restrict__ brow, int j0, int N) {
  const float* src = sw + r * QR_LDS + half * 32;
#pragma unroll
  for (int c = 0; c < 32; c += 4) {
    float4 t = *reinterpret_cast<const float4*>(src + c);
    s[c] = t.x; s[c + 1] = t.y; s[c + 2] = t.z; s[c + 3] = t.w;
  }
  const int jb = j0 + half * 32;
  if (brow != nullptr) {
    if (jb + 32 <= N && (N & 7) == 0) {       // 16-B aligned rows of 32 bias values
      const uint4* bp = reinterpret_cast<const uint4*>(brow + jb);
#pragma unroll
      for (int c = 0; c < 32; c += 8) {
        uint4 u = bp[c / 8];
        const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[c + i] += __bfloat162float(e[i]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (jb + c < N) s[c] += __bfloat162float(brow[jb + c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (jb + c >= N) s[c] = -CUDART_INF_F;
}

// One (sequence b, head h, stripe of 64 query rows) per block; 4 warps of
// 16 rows. Lane l of a warp owns row l % 16 of the warp's rows and key half
// l / 16 of each 64-key tile; the two halves of a row meet by one shuffle.
__global__ void __launch_bounds__(QR_THREADS)
qrows_core_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ bias,
                  bf16* __restrict__ o, int N, int HD) {
  using namespace nvcuda;
  extern __shared__ __align__(128) char smem[];
  const int b = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * QR_BQ;
  bf16* qs_ = reinterpret_cast<bf16*>(smem);                 // [64][QR_LD]
  bf16* ks_ = qs_ + QR_BQ * QR_LD;                           // [64][QR_LD]
  bf16* vs_ = ks_ + QR_BK * QR_LD;                           // [64][QR_LD]
  bf16* ps_ = vs_ + QR_BK * QR_LD;                           // [warps][16][QR_LD]
  float* ss_ = reinterpret_cast<float*>(ps_ + QR_WARPS * 16 * QR_LD);  // [warps][16][QR_LDS]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane & 15, half = lane >> 4;
  const int64_t base = (int64_t)b * N;
  const int hc = h * QR_DH;
  bf16* pw = ps_ + warp * 16 * QR_LD;
  float* sw = ss_ + warp * 16 * QR_LDS;
  const int i = q0 + warp * 16 + r;                          // this lane's query row
  const bf16* brow = (bias != nullptr && i < N) ? bias + ((int64_t)h * N + i) * N : nullptr;

  stage_rows(qs_, q, base, q0, N, HD, hc);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[QR_DH / 16];
#pragma unroll
  for (int kk = 0; kk < QR_DH / 16; ++kk)
    wmma::load_matrix_sync(fq[kk], qs_ + warp * 16 * QR_LD + kk * 16, QR_LD);

  const int ntiles = (N + QR_BK - 1) / QR_BK;
  float s[32];
  // pass 1: each row's max and sum of exp(s - max)
  float m = -CUDART_INF_F, l = 0.f;
  for (int jt = 0; jt < ntiles; ++jt) {
    const int j0 = jt * QR_BK;
    __syncthreads();
    stage_rows(ks_, k, base, j0, N, HD, hc);
    __syncthreads();
    score_tile(fq, ks_, sw);
    __syncwarp();
    lane_scores(s, sw, r, half, brow, j0, N);
    float mx = s[0];
#pragma unroll
    for (int c = 1; c < 32; ++c) mx = fmaxf(mx, s[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(m, mx);
    float e = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) e += expf(s[c] - m_new);
    e += __shfl_xor_sync(0xffffffffu, e, 16);
    l = l * expf(m - m_new) + e;
    m = m_new;
    __syncwarp();
  }

  // pass 2: p = exp(s - max) / sum rounded to bf16, O += P V
  const float inv_l = 1.f / l;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fo[QR_DH / 16];
#pragma unroll
  for (int nt = 0; nt < QR_DH / 16; ++nt) wmma::fill_fragment(fo[nt], 0.f);
  for (int jt = 0; jt < ntiles; ++jt) {
    const int j0 = jt * QR_BK;
    __syncthreads();
    stage_rows(ks_, k, base, j0, N, HD, hc);
    stage_rows(vs_, v, base, j0, N, HD, hc);
    __syncthreads();
    score_tile(fq, ks_, sw);
    __syncwarp();
    lane_scores(s, sw, r, half, brow, j0, N);
    bf16* prow = pw + r * QR_LD + half * 32;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
      uint4 u;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        e[t] = __floats2bfloat162_rn(expf(s[c + 2 * t] - m) * inv_l,
                                     expf(s[c + 2 * t + 1] - m) * inv_l);
      *reinterpret_cast<uint4*>(prow + c) = u;
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < QR_BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
      wmma::load_matrix_sync(fp, pw + kk * 16, QR_LD);
#pragma unroll
      for (int nt = 0; nt < QR_DH / 16; ++nt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, vs_ + kk * 16 * QR_LD + nt * 16, QR_LD);
        wmma::mma_sync(fo[nt], fp, fv, fo[nt]);
      }
    }
    __syncwarp();
  }

  // the per-head output, rounded to bf16
#pragma unroll
  for (int nt = 0; nt < QR_DH / 16; ++nt)
    wmma::store_matrix_sync(sw + nt * 16, fo[nt], QR_LDS, wmma::mem_row_major);
  __syncwarp();
  if (i < N) {
    const float* src = sw + r * QR_LDS + half * 32;
    bf16* dst = o + (base + i) * HD + hc + half * 32;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
      uint4 u;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int t = 0; t < 4; ++t) e[t] = __floats2bfloat162_rn(src[c + 2 * t], src[c + 2 * t + 1]);
      *reinterpret_cast<uint4*>(dst + c) = u;
    }
  }
}

constexpr size_t QR_CORE_SMEM = (size_t)(QR_BQ + 2 * QR_BK + QR_WARPS * 16) * QR_LD * 2 +
                                (size_t)QR_WARPS * 16 * QR_LDS * 4;

}  // namespace ctc

using namespace ctc;

// x [B*N, D] bf16; gamma [D], qs/ks [64] fp32; wq/wk/wv [HD, D], wo [D, HD]
// bf16; bias [H, N, N] bf16 or null; q_ws/k_ws/v_ws/o_ws [B*N, HD] bf16; out
// [B*N, D] bf16. HD = H * 64, a multiple of 128; D a multiple of 8. Returns
// cudaGetLastError() after the launches.
extern "C" int ctc_attn_qrows(const void* x, const void* gamma, const void* wq, const void* wk,
                              const void* wv, const void* wo, const void* qs, const void* ks,
                              const void* bias, void* q_ws, void* k_ws, void* v_ws, void* o_ws,
                              void* out, int B, int N, int D, int H, float scale, int residual,
                              void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * N, HD = H * QR_DH;
  const int smem_proj = GEMM_SMEM + BM * (int)sizeof(float2);
  cudaFuncSetAttribute(qrows_proj_kernel<>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_proj);
  cudaFuncSetAttribute(out_proj_kernel<>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  cudaFuncSetAttribute(qrows_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)QR_CORE_SMEM);

  dim3 gp(3 * HD / BN, (M + BM - 1) / BM);
  qrows_proj_kernel<><<<gp, THREADS, smem_proj, st>>>(
      (const bf16*)x, (const float*)gamma, (const bf16*)wq, (const bf16*)wk, (const bf16*)wv,
      (const float*)qs, (const float*)ks, (bf16*)q_ws, (bf16*)k_ws, (bf16*)v_ws, M, D, HD, scale);
  dim3 gc(B, H, (N + QR_BQ - 1) / QR_BQ);
  qrows_core_kernel<<<gc, QR_THREADS, QR_CORE_SMEM, st>>>(
      (const bf16*)q_ws, (const bf16*)k_ws, (const bf16*)v_ws, (const bf16*)bias, (bf16*)o_ws, N,
      HD);
  dim3 go((D + BN - 1) / BN, (M + BM - 1) / BM);
  out_proj_kernel<><<<go, THREADS, GEMM_SMEM, st>>>((const bf16*)o_ws, (const bf16*)wo,
                                                    (const bf16*)x, (bf16*)out, M, D, HD,
                                                    residual);
  return (int)cudaGetLastError();
}
