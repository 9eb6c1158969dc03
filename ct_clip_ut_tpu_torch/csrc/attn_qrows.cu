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
// against 0.21 ms for the bytes). A 128-row score stripe of one head is
// 128 x 6464 fp32 = 3.3 MB: the TPU keeps its stripe in VMEM, a block here
// has 227 KB of shared memory. So the core makes TWO passes over the keys:
// pass 1 keeps each row's running max and sum, pass 2 recomputes the
// scores, forms p = exp(s - max) / sum, rounds it to bf16 and runs PV. Two
// passes keep the TPU kernel's rounding points (an online softmax would
// round unnormalised terms); their price is QK^T and the bias read twice,
// a floor of 2 * 0.67 GB / 3.35 TB/s = 0.40 ms of bias bytes, and 1.5x the
// products and 2x the exponentials of one pass.
//
// Four launches:
//   ln_rows_kernel   xn = LN(x) * gamma, bf16 (gemm_sm90.cuh);
//   gemm_kernel      q from xn, k and v from the pre-norm x on the Hopper
//                    core (QkvPlan picks the maps a tile reads); the epilogue
//                    l2-normalises each 64-wide head in registers (a head's
//                    columns of a row sit in one quad: two shuffles give
//                    the norm), applies the scales and writes bf16 q and k
//                    [B*N, HD] and v transposed per head, [B, H, 64, N], so
//                    that PV reads V with the keys along its rows, as wgmma
//                    takes a K-major B;
//   core_kernel      the attention core on wgmma: TMA loads of the 64-key
//                    tiles of K, V^T and of the bf16 bias (R rows x 128
//                    B, one box) stay in flight through a ring of stages,
//                    each paced by a full mbarrier and a count of the
//                    warps yet to leave it; thread 0 issues the first
//                    loads and the last warp out of a stage refills it
//                    (no producer warp: a ninth warp would put five warps
//                    on one of the SM's four register files and cut every
//                    thread to 96 registers; eight keep 128); each
//                    warpgroup takes 64
//                    query rows, with q as wgmma's A in registers.
//                    Scores: the accumulator starts at the bias (read
//                    from the swizzled tile, no bank conflicts) and
//                    four m64n64k16 products over the head add q . k. PV:
//                    p = exp2(s log2 e - (max + log2 sum)) packed to bf16 in
//                    the A fragment layout straight from the score
//                    registers, four more products into o. A block takes
//                    R rows of one head of one sequence, the grid runs
//                    the batch fastest so that the blocks sharing a bias
//                    tile run together and L2 serves it to all but the
//                    first: R = 256 (16 warps, one block an SM) at B = 1
//                    and R = 128 (8 warps, two blocks an SM) otherwise,
//                    the faster of the two at MaskGit's shapes on the
//                    H100 (PERF.md §6). Pass 2
//                    walks the keys from the last tile to the first, so
//                    the tiles pass 1 read last may still be in L2; the
//                    loads run on from pass 1 into pass 2 with no bubble;
//   gemm_kernel      O . Wo^T with the residual added in fp32 (LinearPlan,
//                    ResidualEpi).
// Any N works: TMA zero-fills what lies past the tensors, keys past N are
// masked to -inf, rows past N are not stored. The bias may be left out.
//
// The fp32 variant (ctc_attn_qrows_f32: the per-item grid of the TPU
// kernel at fp32, CTGenerate's one-scan route, where every rounding point
// is an identity) runs the same chain with every product as three bf16
// products of hi / lo planes, within ~2^-16 of fp32 (split_sm90.cuh):
//   split_kernel     the weights' planes (wq | wk | wv stacked, wo), per call;
//   ln_split_kernel  xn = LN(x) * gamma and x itself as hi / lo planes;
//   split4_kernel    tc::QkvSplitPlan (q from xn, k and v from x, each K
//                    slice's four planes staged once); QkvEpi writes q and
//                    k (l2-normed, scaled, not rounded) and v^T as hi / lo
//                    planes;
//   core_f32_kernel  ONE pass over the 64-key tiles (where the bf16 core
//                    takes two: at fp32 every rounding point is an
//                    identity, so an online softmax computes the same
//                    function within fp32 rounding), each tile's fp32 bias
//                    (two TMA boxes of 32 keys, 128 B rows, swizzled) and
//                    K's and V^T's hi and lo planes loaded once: the scores
//                    as q_hi k_lo + q_lo k_hi + q_hi k_hi onto the bias,
//                    each row's running max, o's fp32 accumulators rescaled
//                    when it moves, p = exp(s - max) in fp32 split into hi /
//                    lo A fragments in registers, P.V as p_lo v_hi + p_hi
//                    v_lo + p_hi v_hi, o / sum at the end, written as hi /
//                    lo planes. A block takes 128 query rows (8 warps)
//                    whatever B, one block an SM; P never reaches memory;
//   split4_32_kernel o . Wo^T, the residual added in fp32.
// Its bound at MaskGit's shape: the fp32 table's 1.34 GB at 3.35 TB/s (0.40
// ms) against ~297 GFLOP as three bf16 products (0.30 ms); the one pass
// reads the table once (the first design's two passes twice, a floor of
// 0.80 ms).
#include <math_constants.h>

#include "attn_mma.cuh"

namespace ctc {
namespace qr {

using namespace sm90;

constexpr int DH = 64;                       // head width
constexpr int KT = 64;                       // keys a tile
constexpr int KV_BYTES = KT * DH * 2;        // one K or V^T tile: 8 KB
constexpr float LOG2E = 1.4426950408889634f;

// The q, k and v epilogue of the kv variant: q = bf16(l2n(acc) * qs * scale),
// k = bf16(l2n(bf16(acc)) * ks) as [M][HD]; v = bf16(acc) as vt [B][H][64][ldv],
// row m = b N + n of x going to column n. A 128-wide tile holds two heads of
// 64; a row's 16 values of a head sit in this thread and the three others
// of its quad. The fp32 chain (q_lo given): q = l2n(acc) * qs * scale, k =
// l2n(acc) * ks and v = acc, each written as hi / lo planes (q / q_lo, k /
// k_lo, vt / vt_lo; lo zeros without keep_lo).
struct QkvEpi {
  bf16 *q, *k, *vt;
  const float* qs;
  const float* ks;
  float scale;
  int M, HD, tiles, N, ldv;
  bf16 *q_lo = nullptr, *k_lo = nullptr, *vt_lo = nullptr;
  int keep_lo = 1;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const int which = nt / tiles, n0 = (nt % tiles) * BN;
    bf16* out = which == 0 ? q : k;
    const float* sc = which == 0 ? qs : ks;
    const float mul = which == 0 ? scale : 1.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = row + g + 8 * hf;
#pragma unroll
      for (int hh = 0; hh < BN / DH; ++hh) {
        float y[16];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          y[2 * jj] = acc[4 * (8 * hh + jj) + 2 * hf];
          y[2 * jj + 1] = acc[4 * (8 * hh + jj) + 2 * hf + 1];
        }
        if (which == 2) {
          if (m < M) {
            const int b = m / N, n = m - b * N;
            const int64_t off = ((int64_t)b * HD + n0 + DH * hh) * ldv + n;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int64_t r0 = off + (int64_t)(8 * jj + 2 * t) * ldv, r1 = r0 + ldv;
              __nv_bfloat162 hv, lv;
              split2(y[2 * jj], y[2 * jj + 1], keep_lo, hv, lv);
              vt[r0] = __low2bfloat16(hv);
              vt[r1] = __high2bfloat16(hv);
              if (vt_lo != nullptr) {
                vt_lo[r0] = __low2bfloat16(lv);
                vt_lo[r1] = __high2bfloat16(lv);
              }
            }
          }
          continue;
        }
        if (which == 1 && k_lo == nullptr) {   // the bf16 k is rounded before its l2-norm
#pragma unroll
          for (int i = 0; i < 16; ++i) y[i] = __bfloat162float(__float2bfloat16(y[i]));
        }
        float ss = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) ss += y[i] * y[i];
        ss += __shfl_xor_sync(0xffffffffu, ss, 1);
        ss += __shfl_xor_sync(0xffffffffu, ss, 2);
        const float nrm = fmaxf(sqrtf(ss), 1e-12f);
        if (m < M) {
          bf16* lo = which == 0 ? q_lo : k_lo;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int d = 8 * jj + 2 * t;
            const size_t off = (size_t)m * HD + n0 + DH * hh + d;
            __nv_bfloat162 hv, lv;
            split2(y[2 * jj] / nrm * (sc[d] * mul), y[2 * jj + 1] / nrm * (sc[d + 1] * mul),
                   keep_lo, hv, lv);
            *reinterpret_cast<__nv_bfloat162*>(out + off) = hv;
            if (lo != nullptr) *reinterpret_cast<__nv_bfloat162*>(lo + off) = lv;
          }
        }
      }
    }
  }
};

// ---- the core --------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// maps of the cores: 0 the bias [H*N, N] (boxes of R rows; fp32 boxes of 32
// keys), 1 k [B*N, HD], 2 v^T [B*H*64, N] (boxes of 64 rows); the fp32
// core's lo planes: 3 k_lo, 4 v^T_lo
constexpr int MAP_BIAS = 0, MAP_K = 1, MAP_V = 2, MAP_K_LO = 3, MAP_V_LO = 4;

// The bf16 core: a block takes R query rows, R / 16 warps: 8 (two blocks
// an SM) or 16 (one).
__host__ __device__ constexpr int warps(int R) { return R / 16; }
__host__ __device__ constexpr int bias_bytes(int R) { return R * KT * 2; }
__host__ __device__ constexpr int stage_bytes(int R) {
  return bias_bytes(R) + 2 * KV_BYTES;   // the bias tile, K and V^T
}
__host__ __device__ constexpr int ring(int R) { return warps(R) == 8 ? 3 : 4; }
__host__ __device__ constexpr int core_smem(int R) {
  return ring(R) * stage_bytes(R) + 1024;   // + slack to align the ring to 1 KB
}

// One block per (sequence, head, stripe of R query rows). Warp w takes rows
// 16 w ... of the stripe; the four warps 4i .. 4i+3 form a warpgroup over
// 64 rows.
template <int R, bool BIAS>
__global__ void __launch_bounds__(warps(R) * 32, 16 / warps(R))
core_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ q, bf16* __restrict__ o,
            int N, int H, int HD) {
  constexpr int WARPS = warps(R), RING = ring(R), STAGE = stage_bytes(R);
  constexpr int BIAS_BYTES = bias_bytes(R);
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[RING];
  __shared__ int left[RING];   // warps yet to leave a stage in its current step
  char* stages = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                         ~static_cast<uintptr_t>(1023));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * R;
  const int ntiles = (N + KT - 1) / KT;

  // step `it` of the loads: pass 1's tiles (bias, K) in order, then pass
  // 2's (bias, K, V^T) from the last to the first, through one ring
  auto load = [&](int it) {
    const int pass2 = it >= ntiles, tile = pass2 ? 2 * ntiles - 1 - it : it;
    const int s = it % RING;
    mbar_expect_tx(&full[s], (BIAS ? BIAS_BYTES : 0) + (pass2 ? 2 : 1) * KV_BYTES);
    char* st = stages + s * STAGE;
    if (BIAS) tma_load_2d(st, &maps.m[MAP_BIAS], &full[s], tile * KT, h * N + q0);
    char* kv = st + BIAS_BYTES;
    tma_load_2d(kv, &maps.m[MAP_K], &full[s], h * DH, item * N + tile * KT);
    if (pass2) tma_load_2d(kv + KV_BYTES, &maps.m[MAP_V], &full[s], tile * KT, (item * H + h) * DH);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      left[s] = WARPS;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int it = 0; it < RING && it < 2 * ntiles; ++it) load(it);
  }
  __syncthreads();
  // after step `it` (every lane of this warp done with its stage): the
  // last warp to leave refills the stage for step it + RING, so no warp
  // waits for another to issue its loads
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) {
      const int s = it % RING;
      if (atomicAdd(&left[s], -1) == 1) {
        atomicExch(&left[s], WARPS);
        if (it + RING < 2 * ntiles) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          load(it + RING);
        }
      }
    }
  };

  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;
  const int ra = q0 + wrow + g, rb = ra + 8;
  // q as wgmma's A in registers: the four 16-deep steps over the head
  uint32_t qf[4][4];
  {
    const bf16* qb = q + ((int64_t)item * N + q0 + wrow) * HD + h * DH;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = g + 8 * (i & 1), d = 16 * ks + 8 * (i >> 1) + 2 * t;
        qf[ks][i] = q0 + wrow + rr < N ? *reinterpret_cast<const uint32_t*>(qb + (int64_t)rr * HD + d) : 0u;
      }
    }
  }

  // step `it`'s scores, issued: s = the bias tile's rows, then four
  // m64n64k16 products over the head add q . k (not waited for);
  // s[4j + 2hf + e] is row g + 8 hf, key 8j + 2t + e of the tile
  auto issue_scores = [&](int it, float (&s)[32]) {
    const int s_ = it % RING;
    mbar_wait(&full[s_], (it / RING) & 1);
    const char* st = stages + s_ * STAGE;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float2 b = make_float2(0.f, 0.f);
        if (BIAS) {   // the TMA's 128-B swizzle: 16-B chunk c of row r at chunk c ^ (r % 8)
          const int r = wrow + g + 8 * hf;
          b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              st + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t));
        }
        s[4 * j + 2 * hf] = b.x;
        s[4 * j + 2 * hf + 1] = b.y;
      }
    }
    const uint32_t kb = smem_u32(st + BIAS_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_m64n64k16_rs(s, qf[ks], desc_sw128(kb + 32 * ks));
    wgmma_commit();
  };
  // after the wait: keys past N at -inf
  auto finish_scores = [&](int tile, float (&s)[32]) {
    fence_regs(s);
    if ((tile + 1) * KT > N) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (tile * KT + 8 * (i >> 2) + 2 * t + (i & 1) >= N) s[i] = -CUDART_INF_F;
    }
  };

  // pass 1: the running max and sum of each row over this thread's
  // columns, the exponentials of tile j beside the products of tile j + 1
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};
  auto stats = [&](const float (&s)[32]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x = m_r[hf];
#pragma unroll
      for (int j = 0; j < 8; ++j) x = fmaxf(x, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
      // in log2 units; a row with no key yet keeps base 0 so no inf - inf
      const float base = x == -CUDART_INF_F ? 0.f : x * LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sum += ex2(fmaf(s[4 * j + 2 * hf], LOG2E, -base)) +
               ex2(fmaf(s[4 * j + 2 * hf + 1], LOG2E, -base));
      l_r[hf] = l_r[hf] * ex2(fmaf(m_r[hf], LOG2E, -base)) + sum;
      m_r[hf] = x;
    }
  };
  float sa[32], sb[32];
  issue_scores(0, sa);
  wgmma_wait_all();
  finish_scores(0, sa);
  for (int it = 0; it < ntiles; it += 2) {
    const bool next = it + 1 < ntiles;
    if (next) issue_scores(it + 1, sb);
    release(it);
    stats(sa);
    wgmma_wait_all();
    if (next) {
      finish_scores(it + 1, sb);
      if (it + 2 < ntiles) issue_scores(it + 2, sa);
      release(it + 1);
      stats(sb);
      wgmma_wait_all();
      if (it + 2 < ntiles) finish_scores(it + 2, sa);
    }
  }
  // each row's max and sum over its quad; p = exp2(s log2 e - lb[hf])
  float lb[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float mq = fmaxf(m_r[hf], __shfl_xor_sync(0xffffffffu, m_r[hf], 1));
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
    float lq = l_r[hf] * ex2(m_r[hf] * LOG2E - mq * LOG2E);
    lq += __shfl_xor_sync(0xffffffffu, lq, 1);
    lq += __shfl_xor_sync(0xffffffffu, lq, 2);
    lb[hf] = mq * LOG2E + __log2f(lq);
  }

  // pass 2, from the last tile to the first: p rounded to bf16, then P . V
  // of tile j issued beside the scores of tile j + 1
  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  issue_scores(ntiles, sa);
  wgmma_wait_all();
  finish_scores(ntiles - 1, sa);
  for (int it = ntiles; it < 2 * ntiles; ++it) {
    uint32_t a[4][4];   // p of keys 16 ks ... as A fragments
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = 8 * ks + 2 * i, hf = i & 1;
        a[ks][i] = pack_bf16(ex2(fmaf(sa[idx], LOG2E, -lb[hf])),
                             ex2(fmaf(sa[idx + 1], LOG2E, -lb[hf])));
      }
    }
    const uint32_t vb = smem_u32(stages + (it % RING) * STAGE + BIAS_BYTES + KV_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_m64n64k16_rs(oacc, a[ks], desc_sw128(vb + 32 * ks));
    wgmma_commit();
    if (it + 1 < 2 * ntiles) issue_scores(it + 1, sa);
    wgmma_wait_all();
    release(it);
    if (it + 1 < 2 * ntiles) finish_scores(2 * ntiles - 2 - it, sa);
  }
  fence_regs(oacc);
  bf16* ob = o + (int64_t)item * N * HD + h * DH;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = hf ? rb : ra;
      if (r < N) {
        const int64_t off = (int64_t)r * HD + 8 * j + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(ob + off) =
            __floats2bfloat162_rn(oacc[4 * j + 2 * hf], oacc[4 * j + 2 * hf + 1]);
      }
    }
  }
}

// ---- the fp32 core: one pass over the keys ---------------------------------

// A block takes 128 query rows (8 warps, two warpgroups of 64) of one head
// of one sequence, one block an SM. Its loads run through two rings: a
// tile's fp32 bias (two TMA boxes of 32 keys, 128-B rows, swizzled) with
// K's hi and lo planes, 48 KB a stage, three stages; V^T's hi and lo
// planes, 16 KB a stage, four stages. A tile's scores read the first once
// and free it, its P.V the second, so the first ring runs two tiles ahead
// of the products (one 64-KB ring of three stages ran one ahead: ~64 KB in
// flight an SM, 25 GB/s an SM, 1.03 ms for the core on the H100 80GB HBM3,
// 700 W).
constexpr int F32_ROWS = 128;
constexpr int F32_WARPS = F32_ROWS / 16;
constexpr int F32_BIAS_BYTES = F32_ROWS * KT * 4;
constexpr int F32_SK = F32_BIAS_BYTES + 2 * KV_BYTES;   // bias, K hi / lo: 48 KB
constexpr int F32_SV = 2 * KV_BYTES;                    // V^T hi / lo: 16 KB
constexpr int F32_NK = 3, F32_NV = 4;                   // stages of the two rings
constexpr int F32_SMEM = F32_NK * F32_SK + F32_NV * F32_SV + 1024;   // + slack to align to 1 KB

// The fp32 core (ctc_attn_qrows_f32), every rounding point an identity: one
// pass over the key tiles in order, each tile loaded once. Per tile: the
// scores q_hi k_lo + q_lo k_hi + q_hi k_hi onto the bias tile; each row's
// running max (its quad agrees on it: the row's o is spread over the quad);
// alpha = exp(m_old - m_new) rescales o's fp32 accumulators and this
// thread's partial row sum; p = exp(s - m_new) in fp32 (ex2.approx, within
// ~2^-22 of exp, far inside the split's 2^-16; exp2f kept the core at 0.795
// ms against 0.753 on the H100 80GB HBM3, 700 W) split into hi / lo A
// fragments in registers; P.V as p_lo v_hi + p_hi v_lo + p_hi v_hi into o.
// o is divided by the row sum once, at the end, and written as hi / lo
// planes (q's and o's lo planes at + B N HD; keep_lo 0 zeroes p's and o's
// lo). The scores of tile j + 1 are issued before tile j's softmax, and
// tile j's P.V runs on beside tile j + 1's softmax; a stage goes back to
// its ring once its products have completed (the last warp out refills it,
// as in the bf16 core).
template <bool BIAS>
__global__ void __launch_bounds__(F32_WARPS * 32, 1)
core_f32_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ q,
                bf16* __restrict__ o, int N, int H, int HD, int keep_lo) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full_k[F32_NK], full_v[F32_NV];
  __shared__ int left_k[F32_NK], left_v[F32_NV];   // warps yet to leave a stage
  char* ring_k = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                         ~static_cast<uintptr_t>(1023));
  char* ring_v = ring_k + F32_NK * F32_SK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * F32_ROWS;
  const int ntiles = (N + KT - 1) / KT;

  auto load_k = [&](int tile) {   // the bias tile and K's planes
    const int s = tile % F32_NK;
    mbar_expect_tx(&full_k[s], (BIAS ? F32_BIAS_BYTES : 0) + 2 * KV_BYTES);
    char* st = ring_k + s * F32_SK;
    if (BIAS) {   // keys 0-31 and 32-63 of the tile: two 128-B boxes
      tma_load_2d(st, &maps.m[MAP_BIAS], &full_k[s], tile * KT, h * N + q0);
      tma_load_2d(st + F32_BIAS_BYTES / 2, &maps.m[MAP_BIAS], &full_k[s], tile * KT + KT / 2,
                  h * N + q0);
    }
    char* kp = st + F32_BIAS_BYTES;
    tma_load_2d(kp, &maps.m[MAP_K], &full_k[s], h * DH, item * N + tile * KT);
    tma_load_2d(kp + KV_BYTES, &maps.m[MAP_K_LO], &full_k[s], h * DH, item * N + tile * KT);
  };
  auto load_v = [&](int tile) {   // V^T's planes
    const int s = tile % F32_NV;
    mbar_expect_tx(&full_v[s], 2 * KV_BYTES);
    char* st = ring_v + s * F32_SV;
    tma_load_2d(st, &maps.m[MAP_V], &full_v[s], tile * KT, (item * H + h) * DH);
    tma_load_2d(st + KV_BYTES, &maps.m[MAP_V_LO], &full_v[s], tile * KT, (item * H + h) * DH);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < F32_NK; ++s) {
      mbar_init(&full_k[s], 1);
      left_k[s] = F32_WARPS;
    }
    for (int s = 0; s < F32_NV; ++s) {
      mbar_init(&full_v[s], 1);
      left_v[s] = F32_WARPS;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int tile = 0; tile < F32_NK && tile < ntiles; ++tile) load_k(tile);
    for (int tile = 0; tile < F32_NV && tile < ntiles; ++tile) load_v(tile);
  }
  __syncthreads();
  // after a tile's products (every lane of this warp done with its stage):
  // the last warp to leave refills the stage with the tile a ring later
  auto release_k = [&](int tile) {
    __syncwarp();
    if (lane == 0) {
      const int s = tile % F32_NK;
      if (atomicAdd(&left_k[s], -1) == 1) {
        atomicExch(&left_k[s], F32_WARPS);
        if (tile + F32_NK < ntiles) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          load_k(tile + F32_NK);
        }
      }
    }
  };
  auto release_v = [&](int tile) {
    __syncwarp();
    if (lane == 0) {
      const int s = tile % F32_NV;
      if (atomicAdd(&left_v[s], -1) == 1) {
        atomicExch(&left_v[s], F32_WARPS);
        if (tile + F32_NV < ntiles) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          load_v(tile + F32_NV);
        }
      }
    }
  };

  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;
  const int ra = q0 + wrow + g, rb = ra + 8;
  // q's hi and lo planes as wgmma's A in registers: four 16-deep steps
  const int64_t plane = (int64_t)gridDim.x * N * HD;
  uint32_t qf[4][4], ql[4][4];
  {
    const bf16* qb = q + ((int64_t)item * N + q0 + wrow) * HD + h * DH;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = g + 8 * (i & 1), d = 16 * ks + 8 * (i >> 1) + 2 * t;
        const bool in = q0 + wrow + rr < N;
        const int64_t off = (int64_t)rr * HD + d;
        qf[ks][i] = in ? *reinterpret_cast<const uint32_t*>(qb + off) : 0u;
        ql[ks][i] = in ? *reinterpret_cast<const uint32_t*>(qb + plane + off) : 0u;
      }
    }
  }

  // tile `tile`'s scores, issued: s = the bias tile's rows, then q_hi k_lo
  // + q_lo k_hi + q_hi k_hi over the head's four 16-deep steps (not waited
  // for); s[4j + 2hf + e] is row g + 8 hf, key 8j + 2t + e of the tile
  auto issue_scores = [&](int tile, float (&s)[32]) {
    const int s_ = tile % F32_NK;
    mbar_wait(&full_k[s_], (tile / F32_NK) & 1);
    const char* st = ring_k + s_ * F32_SK;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float2 b = make_float2(0.f, 0.f);
        if (BIAS) {   // key 8j + 2t: box j / 4, float kk of its 128-B row (swizzled)
          const int r = wrow + g + 8 * hf, kk = 8 * (j & 3) + 2 * t;
          b = *reinterpret_cast<const float2*>(st + (j >> 2) * (F32_BIAS_BYTES / 2) + r * 128 +
                                               (((kk >> 2) ^ (r & 7)) << 4) + 4 * (kk & 3));
        }
        s[4 * j + 2 * hf] = b.x;
        s[4 * j + 2 * hf + 1] = b.y;
      }
    }
    const uint32_t kb = smem_u32(st + F32_BIAS_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_m64n64k16_rs(s, qf[ks], desc_sw128(kb + KV_BYTES + 32 * ks));
      wgmma_m64n64k16_rs(s, ql[ks], desc_sw128(kb + 32 * ks));
      wgmma_m64n64k16_rs(s, qf[ks], desc_sw128(kb + 32 * ks));
    }
    wgmma_commit();
  };
  // after the wait: keys past N at -inf
  auto finish_scores = [&](int tile, float (&s)[32]) {
    fence_regs(s);
    if ((tile + 1) * KT > N) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (tile * KT + 8 * (i >> 2) + 2 * t + (i & 1) >= N) s[i] = -CUDART_INF_F;
    }
  };

  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F};   // each row's running max (quad-uniform)
  float l_r[2] = {0.f, 0.f};                       // this thread's part of each row's sum
  float oacc[32], sa[32], sb[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  // tile `tile` of the loop, its scores finished in `cur`: tile + 1's
  // scores issued into `nxt` first, then this tile's softmax beside them
  // (and beside the previous tile's P.V); then every wgmma group waited for
  // (o and nxt are written only when none is in flight: ptxas serializes
  // wgmma otherwise), o rescaled and this tile's P.V issued, left running
  // into the next step
  auto step = [&](int tile, float (&cur)[32], float (&nxt)[32]) {
    const bool next = tile + 1 < ntiles;
    if (next) issue_scores(tile + 1, nxt);
    // the rows' new maxima over their quads (every row has a real key in
    // tile 0, so no max is -inf from there on), alpha = exp(m_old - m_new)
    float mb[2], alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x = m_r[hf];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x = fmaxf(x, fmaxf(cur[4 * j + 2 * hf], cur[4 * j + 2 * hf + 1]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      mb[hf] = x * LOG2E;
      alpha[hf] = ex2(fmaf(m_r[hf], LOG2E, -mb[hf]));
      m_r[hf] = x;
    }
    // p = exp(s - m_new) in fp32: the partial row sums, hi / lo A fragments
    uint32_t a[4][4], al[4][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = 8 * ks + 2 * i, hf = i & 1;
        const float p0 = ex2(fmaf(cur[idx], LOG2E, -mb[hf]));
        const float p1 = ex2(fmaf(cur[idx + 1], LOG2E, -mb[hf]));
        sum[hf] += p0 + p1;
        __nv_bfloat162 hv, lv;
        split2(p0, p1, keep_lo, hv, lv);
        a[ks][i] = as_u32(hv);
        al[ks][i] = as_u32(lv);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l_r[hf] = l_r[hf] * alpha[hf] + sum[hf];
    wgmma_wait_all();   // the previous tile's P.V and tile + 1's scores
    if (next) release_k(tile + 1);
    if (tile > 0) release_v(tile - 1);
    if (next) finish_scores(tile + 1, nxt);
    fence_regs(oacc);
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[i] *= alpha[(i >> 1) & 1];
    mbar_wait(&full_v[tile % F32_NV], (tile / F32_NV) & 1);
    const uint32_t vb = smem_u32(ring_v + (tile % F32_NV) * F32_SV);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {   // p_lo v_hi + p_hi v_lo, then p_hi v_hi
      wgmma_m64n64k16_rs(oacc, al[ks], desc_sw128(vb + 32 * ks));
      wgmma_m64n64k16_rs(oacc, a[ks], desc_sw128(vb + KV_BYTES + 32 * ks));
      wgmma_m64n64k16_rs(oacc, a[ks], desc_sw128(vb + 32 * ks));
    }
    wgmma_commit();
  };
  issue_scores(0, sa);
  wgmma_wait_all();
  release_k(0);
  finish_scores(0, sa);
  for (int tile = 0; tile < ntiles; tile += 2) {
    step(tile, sa, sb);
    if (tile + 1 < ntiles) step(tile + 1, sb, sa);
  }
  wgmma_wait_all();
  fence_regs(oacc);
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lq = l_r[hf] + __shfl_xor_sync(0xffffffffu, l_r[hf], 1);
    lq += __shfl_xor_sync(0xffffffffu, lq, 2);
    inv[hf] = 1.f / lq;
  }
  bf16* ob = o + (int64_t)item * N * HD + h * DH;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = hf ? rb : ra;
      if (r < N) {
        const int64_t off = (int64_t)r * HD + 8 * j + 2 * t;
        __nv_bfloat162 hv, lv;
        split2(oacc[4 * j + 2 * hf] * inv[hf], oacc[4 * j + 2 * hf + 1] * inv[hf], keep_lo, hv,
               lv);
        *reinterpret_cast<__nv_bfloat162*>(ob + off) = hv;
        *reinterpret_cast<__nv_bfloat162*>(ob + plane + off) = lv;
      }
    }
  }
}

// The core's query rows a block for a batch of B (see the header).
inline int core_rows(int B) { return B == 1 ? 256 : 128; }

template <int R, bool BIAS>
int launch_core(const Maps& maps, const bf16* q, bf16* o, int B, int N, int H, int HD,
                cudaStream_t st) {
  auto kern = core_kernel<R, BIAS>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, core_smem(R));
  dim3 grid(B, H, (N + R - 1) / R);
  kern<<<grid, warps(R) * 32, core_smem(R), st>>>(maps, q, o, N, H, HD);
  return (int)cudaGetLastError();
}

template <bool BIAS>
int launch_core_f32(const Maps& maps, const bf16* q, bf16* o, int B, int N, int H, int HD,
                    int keep_lo, cudaStream_t st) {
  auto kern = core_f32_kernel<BIAS>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, F32_SMEM);
  dim3 grid(B, H, (N + F32_ROWS - 1) / F32_ROWS);
  kern<<<grid, F32_WARPS * 32, F32_SMEM, st>>>(maps, q, o, N, H, HD, keep_lo);
  return (int)cudaGetLastError();
}

}  // namespace qr
}  // namespace ctc

using namespace ctc::sm90;

// x [B*N, D] bf16; gamma [D], qs/ks [64] fp32; wq/wk/wv [HD, D], wo [D, HD]
// bf16; bias [H*N, N] bf16 with row stride ldb (a multiple of 8), or null;
// workspaces: xn [B*N, D], q_ws, k_ws and o_ws [B*N, HD], v_ws [B*H*64, ldv]
// with ldv = N rounded up to a multiple of 8, all bf16; out [B*N, D] bf16.
// HD = H * 64, a multiple of 128; D a multiple of 8; every pointer 16-B
// aligned. Returns 0, a cudaError_t or an sm90 ERR_ code.
extern "C" int ctc_attn_qrows(const void* x, const void* gamma, const void* wq, const void* wk,
                              const void* wv, const void* wo, const void* qs, const void* ks,
                              const void* bias, void* xn, void* q_ws, void* k_ws, void* v_ws,
                              void* o_ws, void* out, int B, int N, int D, int H, int ldb,
                              float scale, int residual, void* stream) {
  using namespace ctc::qr;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * N, HD = H * DH, tiles = HD / BN, ldv = (N + 7) / 8 * 8;
  const int R = core_rows(B);
  if (M == 0) return 0;
  Maps proj{}, core{}, outm{};
  int err = map_a(&proj.m[0], xn, M, D, D);
  if (!err) err = map_a(&proj.m[1], x, M, D, D);
  if (!err) err = map_b(&proj.m[2], wq, HD, D, D);
  if (!err) err = map_b(&proj.m[3], wk, HD, D, D);
  if (!err) err = map_b(&proj.m[4], wv, HD, D, D);
  if (!err && bias != nullptr)
    err = make_map(&core.m[MAP_BIAS], bias, H * N, N, ldb, R);
  if (!err) err = make_map(&core.m[MAP_K], k_ws, M, HD, HD, KT);
  if (!err) err = make_map(&core.m[MAP_V], v_ws, B * HD, N, ldv, DH);
  if (!err) err = map_a(&outm.m[0], o_ws, M, HD, HD);
  if (!err) err = map_b(&outm.m[1], wo, D, HD, HD);
  if (err) return err;
  err = launch_ln_rows(static_cast<const bf16*>(x), static_cast<const float*>(gamma), nullptr,
                       static_cast<bf16*>(xn), M, D, st);
  if (err) return err;
  const auto qb = static_cast<bf16*>(q_ws), ob = static_cast<bf16*>(o_ws);
  err = launch_gemm(proj, QkvPlan{tiles},
                    QkvEpi{qb, static_cast<bf16*>(k_ws), static_cast<bf16*>(v_ws),
                           static_cast<const float*>(qs), static_cast<const float*>(ks), scale,
                           M, HD, tiles, N, ldv},
                    3 * tiles, M, D, st);
  if (err) return err;
  typedef int (*Core)(const Maps&, const bf16*, bf16*, int, int, int, int, cudaStream_t);
  static const Core cores[2][2] = {{launch_core<128, false>, launch_core<128, true>},
                                   {launch_core<256, false>, launch_core<256, true>}};
  err = cores[R == 256][bias != nullptr](core, qb, ob, B, N, H, HD, st);
  if (err) return err;
  return launch_gemm(outm, LinearPlan{},
                     ResidualEpi{static_cast<bf16*>(out), static_cast<const bf16*>(x), M, D,
                                 residual},
                     (D + BN - 1) / BN, M, HD, st);
}

// The fp32 variant (the per-item grid of the TPU kernel at fp32): x [B*N, D]
// fp32; gamma [D], qs/ks [64], wq/wk/wv [HD, D], wo [D, HD] fp32; bias [H*N,
// N] fp32 with row stride ldb (a multiple of 4), or null; workspaces xs
// [4][B*N][D] (xn_hi, xn_lo, x_hi, x_lo), w_s [2][3 HD][D], wo_s [2][D][HD],
// q_ws, k_ws and o_ws [2][B*N][HD], v_ws [2][B*H*64][ldv] (ldv = N rounded
// up to a multiple of 8), all bf16 (hi, then lo); out [B*N, D] fp32. HD = H
// * 64, a multiple of 128; D a multiple of 8; every pointer 16-B aligned.
// flags 1: every lo plane zeroed (one bf16 product for each fp32 one, the
// control).
extern "C" int ctc_attn_qrows_f32(const void* x, const void* gamma, const void* wq,
                                  const void* wk, const void* wv, const void* wo, const void* qs,
                                  const void* ks, const void* bias, void* xs, void* w_s,
                                  void* wo_s, void* q_ws, void* k_ws, void* v_ws, void* o_ws,
                                  void* out, int B, int N, int D, int H, int ldb, float scale,
                                  int residual, int flags, void* stream) {
  using namespace ctc::qr;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * N, HD = H * DH, tiles = HD / BN, ldv = (N + 7) / 8 * 8;
  const int keep = !(flags & 1);
  if (M == 0) return 0;
  const int64_t md = (int64_t)M * D, wsz = (int64_t)HD * D, wrows = 3 * wsz;
  const int64_t mh = (int64_t)M * HD, vsz = (int64_t)B * HD * ldv;
  bf16* xp = static_cast<bf16*>(xs);
  bf16* wp = static_cast<bf16*>(w_s);
  bf16* wop = static_cast<bf16*>(wo_s);
  bf16* qp = static_cast<bf16*>(q_ws);
  bf16* kp = static_cast<bf16*>(k_ws);
  bf16* vp = static_cast<bf16*>(v_ws);
  bf16* op = static_cast<bf16*>(o_ws);
  Maps proj{}, core{};
  int err = 0;
  for (int i = 0; i < 4 && !err; ++i) err = map_a(&proj.m[i], xp + i * md, M, D, D);
  if (!err) err = map_b(&proj.m[4], wp, 3 * HD, D, D);
  if (!err) err = map_b(&proj.m[5], wp + wrows, 3 * HD, D, D);
  if (!err && bias != nullptr) err = make_map(&core.m[MAP_BIAS], bias, H * N, N, ldb, F32_ROWS, 4);
  if (!err) err = make_map(&core.m[MAP_K], kp, M, HD, HD, KT);
  if (!err) err = make_map(&core.m[MAP_K_LO], kp + mh, M, HD, HD, KT);
  if (!err) err = make_map(&core.m[MAP_V], vp, B * HD, N, ldv, DH);
  if (!err) err = make_map(&core.m[MAP_V_LO], vp + vsz, B * HD, N, ldv, DH);
  if (err) return err;
  const float* const w3[3] = {static_cast<const float*>(wq), static_cast<const float*>(wk),
                              static_cast<const float*>(wv)};
  for (int i = 0; i < 3 && !err; ++i) err = split_to(w3[i], wp + i * wsz, wp + wrows + i * wsz, wsz, keep, st);
  if (!err) err = split(wo, wop, wsz, keep, st);
  if (!err)
    err = launch_ln_split(static_cast<const float*>(x), static_cast<const float*>(gamma), nullptr,
                          nullptr, xp, xp + md, xp + 2 * md, xp + 3 * md, M, D, 1e-5f, keep, st);
  if (err) return err;
  err = launch_split4<false>(proj, ctc::tc::QkvSplitPlan{tiles},
                             QkvEpi{qp, kp, vp, static_cast<const float*>(qs),
                                    static_cast<const float*>(ks), scale, M, HD, tiles, N, ldv,
                                    qp + mh, kp + mh, vp + vsz, keep},
                             3 * tiles, M, D, st);
  if (err) return err;
  err = bias != nullptr ? launch_core_f32<true>(core, qp, op, B, N, H, HD, keep, st)
                        : launch_core_f32<false>(core, qp, op, B, N, H, HD, keep, st);
  if (err) return err;
  return split4_product32<false>(op, op + mh, HD, wop, wop + wsz, HD, M, D, HD,
                       F32OutEpi{static_cast<float*>(out), nullptr,
                                 residual ? static_cast<const float*>(x) : nullptr, M, D},
                       st);
}
