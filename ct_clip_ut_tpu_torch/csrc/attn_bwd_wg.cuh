// The spatial block's fp32 backward passes on wgmma (sm_90a): the query
// pass (dq) and the key pass (dk, dv) of tc::block_backward_f32 with a bias
// (rows 7f and 7F), and without one (BIAS 1 with a null bias) the temporal
// block's above n = 64 (at n <= 64 it takes attn_bwd_packed.cuh's fused
// pass).
//
// Per (sequence, head) the n^2 products are S = Q K^T, dP = dO V^T, dq^ =
// dS K in the query pass and S^T = K Q^T, dP^T = V dO^T, dV = P^T dO, dk^ =
// dS^T Q in the key pass, each three bf16 products of hi / lo planes (a_hi
// b_lo + a_lo b_hi + a_hi b_hi, within ~2^-16 of fp32). What bounds them on
// the H100 is the tensor cores. The mma.sync passes they replace ran one
// block of 8 warps an SM (a (sequence, head)'s four planes staged whole,
// 147 KB at n = 576, again for each of the five 128-row tiles), with S
// computed twice in the forward core the backward reran for its row
// statistics. Here:
//   - a block is one warpgroup over 64 query (or key) rows of one (sequence,
//     head), its A operands (q and dO, or k and v, hi / lo) in registers;
//     every product is wgmma m64nNk16 with A from registers: the scores
//     m64n64 against a tile's planes read K-major, dq^ / dk^ / dV m64n32
//     with P and dS split into hi / lo A fragments straight from the score
//     registers and the tile's planes read MN-major (the transpose bit),
//     so one staged tile serves both;
//   - the other operand streams in 64-row tiles (four planes of 4 KB, the
//     TMA's 64-B swizzle, which is attn_mma.cuh's swz) with the tile's fp32
//     bias (two TMA boxes of 32 keys, 128-B swizzle; where n % 4 == 0, else
//     read from global memory) through a ring of WG_RING stages paced by
//     full / empty mbarriers: thread 0 issues the loads, each warp arrives
//     on a stage's empty barrier when its products are done with it; three
//     blocks an SM (67 KB of ring each);
//   - within a tile the work overlaps the tensor cores: S and dP are two
//     wgmma groups, P's exponentials run while dP's products do, and each
//     16-row step of dS (and P^T) is split and its products issued while
//     the next step is formed;
//   - the row statistics come from the forward: (m log2 e, 1 / l) in mld,
//     written by the fp32 forward core when the forward keeps them for the
//     backward (attention._BlockFn) or by the core the chain reruns when it
//     does not; a walk of its own before the query pass (the query pass's
//     kernel with ROWTERM) forms the split S and dP over the key tiles as
//     the query pass does, D = c + rowsum(P (dP - c)) / rowsum(P) from them
//     (c the row's dP at key 0), and writes (m log2 e, 1 / l, D, lse) for
//     both passes; the key pass's stage carries its query tile's rows of it
//     (one bulk copy). Over tokens that lie close (adjacent patches of a
//     frame) dP - D is a small difference and each row of dS = P (dP - D)
//     must sum to zero far below fp32's step in D, or the query / key
//     weight gradients, sums of dS against nearly equal rows, lose it all
//     (F11). So D comes from the same split dP it is subtracted from (the
//     first design's D = rowsum(dO o), from o's and dO's planes, left them
//     2.3e-2 to 6.9e-2 off the fp32 XLA twins of two blocks in the CPU
//     emulation, tests/test_torch_port_wgrad_staged.py), over the walk's own
//     row sum of P (the forward's l comes from another kernel's S and
//     rounding), and its summands are shifted by c (unshifted, an in-order
//     fp32 sum of 576 terms near D rounds away too much of it). On the
//     H100 at 24 frames of 576 patches the three steps read 3.9e-2, 1.5e-2
//     and 2.3e-3 off a float64 block (chip_smoke.py phase 14), the plain
//     fp32 backward 5.3e-3;
//   - every sum over tokens runs in order in one accumulator (dq over the
//     key tiles, dk and dv over the query tiles), no atomics: two calls
//     give the same bits.
#pragma once

#include "attn_mma.cuh"

namespace ctc {
namespace tc {

constexpr int WG_ROWS = 64;                          // query (or key) rows a block
constexpr int WG_TILE = 64;                          // keys (or queries) a streamed tile
constexpr int WG_PLANE = WG_TILE * DH * 2;           // one plane of a tile: 4 KB
constexpr int WG_BIAS = WG_ROWS * WG_TILE * 4;       // the tile's fp32 bias: two boxes of 32 keys
constexpr int WG_RING = 2;
// four planes, the bias tile, the key pass's statistics
constexpr int WG_STAGE = 4 * WG_PLANE + WG_BIAS + WG_TILE * 16;
constexpr int WG_PASS_SMEM = WG_RING * WG_STAGE + 1024;  // + slack to align the ring to 1 KB

// ---- PTX wrappers ----------------------------------------------------------------

// K-major tiles of 64-B rows with the 64-B swizzle (split_sm90.cuh)
using sm90::desc_sw64;

// The same tile read MN-major: its 64-B rows (32 columns) run along N, 8-row
// core groups along K 512 B apart (SBO); a 16-deep K step is 1 KB.
__device__ __forceinline__ uint64_t desc_mn_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(WG_PLANE >> 4) << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// d[16] += A (64 x 16, this warp's 16 rows in registers as in
// sm90::wgmma_m64n64k16_rs) . B (16 x 32, MN-major, desc b); the transpose
// bit of B set
__device__ __forceinline__ void wgmma_m64n32k16_rs_t(float (&d)[16], const uint32_t (&a)[4],
                                                     uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bytes (a multiple of 16) from global src to shared dst, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// ---- the passes' shared pieces (also the fused temporal pass's, attn_bwd_packed.cuh) ----

// What the scale and l2-norm backward reads of rows a, b: this thread's
// columns 8 dt + 2 t + e of their fp32 unit rows and their norms (zeros
// for a row past the sequence). The fused temporal pass loads them before
// its products, so the loads are in flight while the tensor cores run.
struct UnitRows {
  float a[8], b[8], norm_a, norm_b;
};

__device__ __forceinline__ void load_unit_rows(UnitRows& u, const float* u_a, const float* u_b,
                                               const float* n_a, const float* n_b, bool va,
                                               bool vb, int t) {
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
    const int col = 8 * dt + 2 * t;
    const float2 x = va ? *reinterpret_cast<const float2*>(u_a + col) : make_float2(0.f, 0.f);
    const float2 y = vb ? *reinterpret_cast<const float2*>(u_b + col) : make_float2(0.f, 0.f);
    u.a[2 * dt] = x.x;
    u.a[2 * dt + 1] = x.y;
    u.b[2 * dt] = y.x;
    u.b[2 * dt + 1] = y.y;
  }
  u.norm_a = *n_a;
  u.norm_b = *n_b;
}

// The scale and l2-norm backward of rows a, b of a 16 x 32 gradient of the
// scaled unit rows (the mma D layout, as attn_bwd.cuh's l2norm_bwd): du =
// acc * gain, out = (du - u (u . du)) / norm, written as hi / lo planes at
// hi_a / hi_b and lo_off further on; part[2 dt + e] += u acc, the gain's
// gradient before its factor (this thread's columns 8 dt + 2 t + e).
__device__ __forceinline__ void l2norm_bwd_rows(const float (&acc)[4][4], const UnitRows& u,
                                                bool va, bool vb, const float (&gain)[8],
                                                bf16* hi_a, bf16* hi_b, int64_t lo_off,
                                                int keep_lo, int t, float (&part)[8]) {
  float dot_a = 0.f, dot_b = 0.f;
#pragma unroll
  for (int dt = 0; dt < 4; ++dt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dot_a += u.a[2 * dt + e] * (acc[dt][e] * gain[2 * dt + e]);
      dot_b += u.b[2 * dt + e] * (acc[dt][2 + e] * gain[2 * dt + e]);
      part[2 * dt + e] += u.a[2 * dt + e] * acc[dt][e] + u.b[2 * dt + e] * acc[dt][2 + e];
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
      sm90::split2((acc[dt][0] * gain[2 * dt] - u.a[2 * dt] * dot_a) / u.norm_a,
                   (acc[dt][1] * gain[2 * dt + 1] - u.a[2 * dt + 1] * dot_a) / u.norm_a, keep_lo,
                   h2, l2);
      *reinterpret_cast<__nv_bfloat162*>(hi_a + col) = h2;
      *reinterpret_cast<__nv_bfloat162*>(hi_a + lo_off + col) = l2;
    }
    if (vb) {
      sm90::split2((acc[dt][2] * gain[2 * dt] - u.b[2 * dt] * dot_b) / u.norm_b,
                   (acc[dt][3] * gain[2 * dt + 1] - u.b[2 * dt + 1] * dot_b) / u.norm_b, keep_lo,
                   h2, l2);
      *reinterpret_cast<__nv_bfloat162*>(hi_b + col) = h2;
      *reinterpret_cast<__nv_bfloat162*>(hi_b + lo_off + col) = l2;
    }
  }
}

// load_unit_rows, then l2norm_bwd_rows (rows a, b of the unit rows at u_a /
// u_b, norms norm_a / norm_b)
__device__ __forceinline__ void l2norm_bwd_planes(const float (&acc)[4][4], const float* u_a,
                                                  const float* u_b, const float* norm_a,
                                                  const float* norm_b, bool va, bool vb,
                                                  const float (&gain)[8], bf16* hi_a, bf16* hi_b,
                                                  int64_t lo_off, int keep_lo, int t,
                                                  float (&part)[8]) {
  UnitRows u;
  load_unit_rows(u, u_a, u_b, norm_a, norm_b, va, vb, t);
  l2norm_bwd_rows(acc, u, va, vb, gain, hi_a, hi_b, lo_off, keep_lo, t, part);
}

// this thread's 8 columns 8 dt + 2 t + e of a [32] vector, times mul
__device__ __forceinline__ void gain_cols(float (&out)[8], const float* v, float mul, int t) {
#pragma unroll
  for (int dt = 0; dt < 4; ++dt)
#pragma unroll
    for (int e = 0; e < 2; ++e) out[2 * dt + e] = v[8 * dt + 2 * t + e] * mul;
}

// The block's sums of part[] over its rows into out[0 .. 31] (the 32
// columns of a head), in a fixed order: the eight row groups of a warp by
// shuffles, then the warps in order through `red` (32 floats a warp of
// shared memory the block has finished with). Every thread of the block
// calls it.
__device__ __forceinline__ void head_cols_partial(float (&part)[8], float* red, float* out,
                                                  int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 4);
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 8);
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 16);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, t = lane & 3;
  if (lane < 4) {
#pragma unroll
    for (int dt = 0; dt < 4; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) red[warp * DH + 8 * dt + 2 * t + e] = part[2 * dt + e];
  }
  __syncthreads();
  if (threadIdx.x < DH) {
    float sum = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) sum += red[w * DH + threadIdx.x];
    out[threadIdx.x] = sum;
  }
}

// The block's row of a [R * tiles * H][32] partial-sums matrix.
__device__ __forceinline__ int64_t block_row() {
  return ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
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

// ---- the ring ----------------------------------------------------------------------

// The stages of a pass's block: tile j in stage j % WG_RING, its full barrier
// completed by the loads' bytes, its empty barrier by the four warps.
struct WgRing {
  char* stages;
  uint64_t* full;
  uint64_t* empty;
  __device__ char* stage(int j) const { return stages + (j % WG_RING) * WG_STAGE; }
  __device__ void wait(int j) const { sm90::mbar_wait(&full[j % WG_RING], (j / WG_RING) & 1); }
};

// Set up the ring and start the first loads (load(j) for j < WG_RING).
template <class Load>
__device__ __forceinline__ WgRing ring_start(char* smem_raw, uint64_t* full, uint64_t* empty,
                                             int tiles, const Load& load) {
  WgRing ring{reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~static_cast<uintptr_t>(1023)),
              full, empty};
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_RING; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], WG_ROWS / 16);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < WG_RING && j < tiles; ++j) load(j);
  }
  __syncthreads();
  return ring;
}

// After tile j (this warp done with its stage): the warp arrives on the
// stage's empty barrier; thread 0 waits for the four and refills the stage
// with tile j + WG_RING.
template <class Load>
__device__ __forceinline__ void ring_release(const WgRing& ring, int j, int tiles, int lane,
                                             const Load& load) {
  __syncwarp();
  const int s = j % WG_RING;
  if (lane == 0) sm90::mbar_arrive(&ring.empty[s]);
  if (threadIdx.x == 0 && j + WG_RING < tiles) {
    sm90::mbar_wait(&ring.empty[s], (j / WG_RING) & 1);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    load(j + WG_RING);
  }
  __syncwarp();
}

// The three bf16 products of a 16-row A operand's two 16-deep steps (hi /
// lo fragments) with a tile's 64 rows (hi / lo planes, K-major): c (m64n64)
// += a_hi b_lo + a_lo b_hi + a_hi b_hi.
__device__ __forceinline__ void split_scores_wg(float (&c)[32], const uint32_t (&ah)[2][4],
                                                const uint32_t (&al)[2][4], uint32_t hi,
                                                uint32_t lo) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    sm90::wgmma_m64n64k16_rs(c, ah[ks], desc_sw64(lo + 32 * ks));
    sm90::wgmma_m64n64k16_rs(c, al[ks], desc_sw64(hi + 32 * ks));
    sm90::wgmma_m64n64k16_rs(c, ah[ks], desc_sw64(hi + 32 * ks));
  }
}

// the m64n32 D layout as l2norm_bwd_planes' acc[dt][2 hf + e]
__device__ __forceinline__ void as_frag(const float (&d)[16], float (&acc)[4][4]) {
#pragma unroll
  for (int dt = 0; dt < 4; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = d[4 * dt + i];
}

// ---- the passes ----------------------------------------------------------------------

// Maps of the passes: 0-3 the planes the pass streams ([M, HD] bf16, boxes
// of 32 columns x 64 rows, 64-B swizzle; the query pass k_hi, k_lo, v_hi,
// v_lo, the key pass q_hi, q_lo, dO_hi, dO_lo), 4 the bias as the pass reads
// it ([H n, n] fp32, boxes of 32 keys x 64 rows, 128-B swizzle; BIAS 2).
constexpr int MAP_BIAS = 4;

// The bias of this thread's elements of a tile: b[4 jj + 2 hf + e] at row
// `row` + 8 hf of the block's rows, column 8 jj + 2 t + e of the tile. BIAS
// 2: from the stage's two TMA boxes (16-B chunk c of row r at chunk c ^ (r %
// 8)); 1: from global memory (any n), rows a / b of bias_a / bias_b, zeros
// past n, and zeros where bias_a is null (no bias: a no-bias variant of its
// own had ptxas serialize its wgmmas, C7520).
template <int BIAS>
__device__ __forceinline__ void tile_bias(float (&b)[32], const char* box, const float* bias_a,
                                          const float* bias_b, bool va, bool vb, int col0, int n,
                                          int row, int t) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    if constexpr (BIAS == 2) {
      const int kk = 8 * (jj & 3) + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = row + 8 * hf;
        const int at = (jj >> 2) * (WG_BIAS / 2) + r * 128 + (((kk >> 2) ^ (r & 7)) << 4) +
                       4 * (kk & 3);
        const float2 v = *reinterpret_cast<const float2*>(box + at);
        b[4 * jj + 2 * hf] = v.x;
        b[4 * jj + 2 * hf + 1] = v.y;
      }
    } else {
      float q[4];
      const bool has = bias_a != nullptr;
      bias_pair<1>(q, bias_a, bias_b, va && has, vb && has, col0 + 8 * jj + 2 * t, n);
#pragma unroll
      for (int i = 0; i < 4; ++i) b[4 * jj + i] = q[i];
    }
  }
}

// Start the loads of tile `tile` into a stage: the four planes at (h 32,
// rows row0 + 64 tile) and, with BIAS 2, the bias tile's two boxes at rows
// brow of map 4, columns 64 tile.
template <int BIAS>
__device__ __forceinline__ void load_tile(const sm90::Maps& maps, char* stg, uint64_t* bar,
                                          int extra, int h, int row0, int brow, int tile) {
  sm90::mbar_expect_tx(bar, 4 * WG_PLANE + (BIAS == 2 ? WG_BIAS : 0) + extra);
#pragma unroll
  for (int p = 0; p < 4; ++p)
    sm90::tma_load_2d(stg + p * WG_PLANE, &maps.m[p], bar, h * DH, row0 + tile * WG_TILE);
  if (BIAS == 2) {
    sm90::tma_load_2d(stg + 4 * WG_PLANE, &maps.m[MAP_BIAS], bar, tile * WG_TILE, brow);
    sm90::tma_load_2d(stg + 4 * WG_PLANE + WG_BIAS / 2, &maps.m[MAP_BIAS], bar,
                      tile * WG_TILE + WG_TILE / 2, brow);
  }
}

// The query pass: one block per (sequence r, 64-query tile, head h). mld
// [R][H][n] holds (m log2 e, 1 / l, D, lse) of each query row. Over the key
// tiles: S, then dP, in two wgmma groups; P = exp2(S log2 e - m) / l while
// dP runs; then per 16-key step dS = P (dP - D) split and its three
// products into dq^, the next step's dS formed while they run; then the
// scale and l2-norm backward into dq's planes; qs_part (null in the
// data-gradient form) [R * tiles * H][32] the block's sums of u_q dq^.
// ROWTERM: the row term's walk before it, over the same tiles: the same S,
// dP and P, D = c + rowsum(P (dP - c)) / rowsum(P) with c the row's dP at
// key 0 (each thread's elements in tile order, then the quad's four), and
// (m log2 e, 1 / l, D, m log2 e - log2(1 / l)) written into mld; no dq.
template <int BIAS, bool ROWTERM>
__global__ void __launch_bounds__(WG_ROWS * 2, 3)
bwd_dq_wg_kernel(const __grid_constant__ sm90::Maps maps, const bf16* __restrict__ qk,
                 const bf16* __restrict__ dO, const float* __restrict__ bias,
                 float4* __restrict__ mld, const float* __restrict__ unit,
                 const float* __restrict__ norm, const float* __restrict__ qs, float scale,
                 bf16* __restrict__ dq, float* __restrict__ qs_part, int M, int n, int HD,
                 int keep_lo) {
  using namespace sm90;
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_RING], empty[WG_RING];
  const int r = blockIdx.x, h = blockIdx.z, H = gridDim.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16, q0 = blockIdx.y * WG_ROWS + wrow;
  const int tiles = (n + WG_TILE - 1) / WG_TILE;
  const size_t plane = (size_t)M * HD;
  const int64_t off = (int64_t)r * n * HD + h * DH;
  char* const base = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  const int brow = h * n + blockIdx.y * WG_ROWS;
  auto load = [&](int j) {
    load_tile<BIAS>(maps, base + (j % WG_RING) * WG_STAGE, &full[j % WG_RING], 0, h, r * n, brow,
                    j);
  };
  const WgRing ring = ring_start(smem_raw, full, empty, tiles, load);

  const int ra = q0 + g, rb = ra + 8;
  const bool va = ra < n, vb = rb < n;
  uint32_t qh[2][4], ql[2][4], dh[2][4], dl[2][4];
  load_a(qh, qk + off, HD, q0, n, lane);
  load_a(ql, qk + plane + off, HD, q0, n, lane);
  load_a(dh, dO + off, HD, q0, n, lane);
  load_a(dl, dO + plane + off, HD, q0, n, lane);
  float4* st = mld + ((int64_t)r * H + h) * n;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 sa = va ? st[ra] : zero, sb = vb ? st[rb] : zero;
  const bool read = BIAS == 1 && bias != nullptr;   // the bias from global memory
  const float* bias_a = read ? bias + ((int64_t)h * n + (va ? ra : 0)) * n : nullptr;
  const float* bias_b = read ? bias + ((int64_t)h * n + (vb ? rb : 0)) * n : nullptr;
  float acc[16], rowterm[2] = {0.f, 0.f}, rowsum[2] = {0.f, 0.f}, shift[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    ring.wait(j);
    const char* stg = ring.stage(j);
    const uint32_t kb = smem_u32(stg);   // k_hi, k_lo, v_hi, v_lo
    // S starts at the tile's bias; the products add q . k
    float s[32], dp[32];
    tile_bias<BIAS>(s, stg + 4 * WG_PLANE, bias_a, bias_b, va, vb, j * WG_TILE, n, wrow + g, t);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    wgmma_fence();
    split_scores_wg(s, qh, ql, kb, kb + WG_PLANE);
    wgmma_commit();
    split_scores_wg(dp, dh, dl, kb + 2 * WG_PLANE, kb + 3 * WG_PLANE);
    wgmma_commit();
    sm90::wgmma_wait_one();
    fence_regs(s);
    // P = exp2(S log2 e - m log2 e) / l, zero past n
    const int past = n - j * WG_TILE;   // keys of the tile before n
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float4& sr = (k & 2) ? sb : sa;
      const float p = ex2(fmaf(s[k], LOG2E, -sr.x)) * sr.y;
      s[k] = past >= WG_TILE || 8 * (k >> 2) + 2 * t + (k & 1) < past ? p : 0.f;
    }
    wgmma_wait_all();
    fence_regs(dp);
    if constexpr (ROWTERM) {
      if (j == 0) {   // each row's dP at key 0, from its quad's first lane
        shift[0] = __shfl_sync(0xffffffffu, dp[0], lane & ~3);
        shift[1] = __shfl_sync(0xffffffffu, dp[2], lane & ~3);
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        rowterm[(k >> 1) & 1] += s[k] * (dp[k] - shift[(k >> 1) & 1]);
        rowsum[(k >> 1) & 1] += s[k];
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // dS of keys 16 ks ... (elements 8 ks ... 8 ks + 7) as A fragments,
        // then its three products while the next step's are formed
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = 8 * ks + 2 * i;
          const float4& sr = (i & 1) ? sb : sa;
          __nv_bfloat162 hv, lv;
          split2(s[k] * (dp[k] - sr.z), s[k + 1] * (dp[k + 1] - sr.z), keep_lo, hv, lv);
          ah[i] = as_u32(hv);
          al[i] = as_u32(lv);
        }
        const uint32_t kr = kb + 1024 * ks;
        wgmma_fence();
        wgmma_m64n32k16_rs_t(acc, al, desc_mn_sw64(kr));
        wgmma_m64n32k16_rs_t(acc, ah, desc_mn_sw64(kr + WG_PLANE));
        wgmma_m64n32k16_rs_t(acc, ah, desc_mn_sw64(kr));
        wgmma_commit();
      }
      wgmma_wait_all();
    }
    ring_release(ring, j, tiles, lane, load);
  }
  if constexpr (ROWTERM) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rowterm[i] += __shfl_xor_sync(0xffffffffu, rowterm[i], 1);
      rowterm[i] += __shfl_xor_sync(0xffffffffu, rowterm[i], 2);
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 1);
      rowsum[i] += __shfl_xor_sync(0xffffffffu, rowsum[i], 2);
    }
    if (t == 0) {
      if (va) st[ra] = make_float4(sa.x, sa.y, shift[0] + rowterm[0] / rowsum[0],
                                   sa.x - log2f(sa.y));
      if (vb) st[rb] = make_float4(sb.x, sb.y, shift[1] + rowterm[1] / rowsum[1],
                                   sb.x - log2f(sb.y));
    }
    return;
  }
  fence_regs(acc);
  float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (q0 < n) {
    float a4[4][4];
    as_frag(acc, a4);
    const int64_t ma = (int64_t)r * n + (va ? ra : 0), mb = (int64_t)r * n + (vb ? rb : 0);
    const int64_t col0 = h * DH;
    float gain[8];
    gain_cols(gain, qs, scale, t);
    l2norm_bwd_planes(a4, unit + ma * HD + col0, unit + mb * HD + col0, norm + ma * H + h,
                      norm + mb * H + h, va, vb, gain, dq + ma * HD + col0, dq + mb * HD + col0,
                      (int64_t)plane, keep_lo, t, part);
  }
  if (qs_part != nullptr)
    head_cols_partial(part, reinterpret_cast<float*>(ring.stages), qs_part + block_row() * DH,
                      lane);
}

// The key pass: one block per (sequence r, 64-key tile, head h), k and v
// (hi / lo) as the A operands; each stage holds a query tile's q and dO
// planes, its bias^T tile (BIAS 2) and its rows of mld (m log2 e, 1 / l, D,
// lse). biasT [H][key][query] (the bias transposed). Over the query tiles:
// S^T, then dP^T, in two wgmma groups; P^T = exp2(S^T log2 e - lse) while
// dP^T runs; then per 16-query step dS^T = P^T (dP^T - D) and both split,
// their six products into dV and dk^ while the next step's are formed; then
// the l2-norm backward into dkv [2][M][2 HD] (dk at columns h * 32 ..., dv
// at HD + h * 32 ...); ks_part as the query pass's qs_part, the sums of u_k
// dk^.
template <int BIAS>
__global__ void __launch_bounds__(WG_ROWS * 2, 3)
bwd_dkv_wg_kernel(const __grid_constant__ sm90::Maps maps, const bf16* __restrict__ qk,
                  const bf16* __restrict__ v, const float* __restrict__ biasT,
                  const float4* __restrict__ mld, const float* __restrict__ unit,
                  const float* __restrict__ norm, const float* __restrict__ ks,
                  bf16* __restrict__ dkv, float* __restrict__ ks_part, int M, int n, int HD,
                  int keep_lo) {
  using namespace sm90;
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_RING], empty[WG_RING];
  const int r = blockIdx.x, h = blockIdx.z, H = gridDim.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = (threadIdx.x >> 5) * 16, k0 = blockIdx.y * WG_ROWS + wrow;
  const int tiles = (n + WG_TILE - 1) / WG_TILE;
  const size_t plane = (size_t)M * HD;
  const int64_t off = (int64_t)r * n * HD + h * DH;
  const float4* st = mld + ((int64_t)r * H + h) * n;
  char* const base = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  constexpr int STATS = 4 * WG_PLANE + WG_BIAS;   // the stage's statistics rows
  const int brow = h * n + blockIdx.y * WG_ROWS;
  auto load = [&](int j) {
    char* stg = base + (j % WG_RING) * WG_STAGE;
    const int rows = min(WG_TILE, n - j * WG_TILE);
    load_tile<BIAS>(maps, stg, &full[j % WG_RING], rows * 16, h, r * n, brow, j);
    bulk_load(stg + STATS, st + j * WG_TILE, rows * 16, &full[j % WG_RING]);
  };
  const WgRing ring = ring_start(smem_raw, full, empty, tiles, load);

  const int ka = k0 + g, kb = ka + 8;
  const bool va = ka < n, vb = kb < n;
  uint32_t kh[2][4], kl[2][4], vh[2][4], vl[2][4];
  load_a(kh, qk + 2 * plane + off, HD, k0, n, lane);
  load_a(kl, qk + 3 * plane + off, HD, k0, n, lane);
  load_a(vh, v + off, HD, k0, n, lane);
  load_a(vl, v + plane + off, HD, k0, n, lane);
  const bool read = BIAS == 1 && biasT != nullptr;  // the bias from global memory
  const float* bias_a = read ? biasT + ((int64_t)h * n + (va ? ka : 0)) * n : nullptr;
  const float* bias_b = read ? biasT + ((int64_t)h * n + (vb ? kb : 0)) * n : nullptr;
  float dk[16], dv[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dk[i] = dv[i] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    ring.wait(j);
    const char* stg = ring.stage(j);
    const uint32_t qb = smem_u32(stg);   // q_hi, q_lo, dO_hi, dO_lo
    // S^T starts at the tile's bias^T; the products add k . q
    float s[32], dp[32];
    tile_bias<BIAS>(s, stg + 4 * WG_PLANE, bias_a, bias_b, va, vb, j * WG_TILE, n, wrow + g, t);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    wgmma_fence();
    split_scores_wg(s, kh, kl, qb, qb + WG_PLANE);
    wgmma_commit();
    split_scores_wg(dp, vh, vl, qb + 2 * WG_PLANE, qb + 3 * WG_PLANE);
    wgmma_commit();
    // each query's (D, lse): the stage's rows (stale past n, where P^T and dS^T are 0)
    const float4* sq = reinterpret_cast<const float4*>(stg + STATS);
    const int past = n - j * WG_TILE;   // queries of the tile before n
    sm90::wgmma_wait_one();
    fence_regs(s);
    // P^T = exp2(S^T log2 e - lse)
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int c = 8 * (k >> 2) + 2 * t + (k & 1);
      const float p = ex2(fmaf(s[k], LOG2E, -sq[c].w));
      s[k] = past >= WG_TILE || c < past ? p : 0.f;
    }
    wgmma_wait_all();
    fence_regs(dp);
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      // P^T and dS^T of queries 16 kq ... as A fragments, then their six
      // products while the next step's are formed
      uint32_t ph[4], pl[4], sh[4], sl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 8 * kq + 2 * i, c = 8 * (k >> 2) + 2 * t;
        const bool in0 = past >= WG_TILE || c < past, in1 = past >= WG_TILE || c + 1 < past;
        const float ds0 = in0 ? s[k] * (dp[k] - sq[c].z) : 0.f;
        const float ds1 = in1 ? s[k + 1] * (dp[k + 1] - sq[c + 1].z) : 0.f;
        __nv_bfloat162 hv, lv;
        split2(s[k], s[k + 1], keep_lo, hv, lv);
        ph[i] = as_u32(hv);
        pl[i] = as_u32(lv);
        split2(ds0, ds1, keep_lo, hv, lv);
        sh[i] = as_u32(hv);
        sl[i] = as_u32(lv);
      }
      const uint32_t qr = qb + 1024 * kq;
      wgmma_fence();
      wgmma_m64n32k16_rs_t(dv, pl, desc_mn_sw64(qr + 2 * WG_PLANE));
      wgmma_m64n32k16_rs_t(dv, ph, desc_mn_sw64(qr + 3 * WG_PLANE));
      wgmma_m64n32k16_rs_t(dv, ph, desc_mn_sw64(qr + 2 * WG_PLANE));
      wgmma_m64n32k16_rs_t(dk, sl, desc_mn_sw64(qr));
      wgmma_m64n32k16_rs_t(dk, sh, desc_mn_sw64(qr + WG_PLANE));
      wgmma_m64n32k16_rs_t(dk, sh, desc_mn_sw64(qr));
      wgmma_commit();
    }
    wgmma_wait_all();
    ring_release(ring, j, tiles, lane, load);
  }
  fence_regs(dk);
  fence_regs(dv);
  float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (k0 < n) {
    float a4[4][4];
    as_frag(dk, a4);
    const int64_t ma = (int64_t)r * n + (va ? ka : 0), mb = (int64_t)r * n + (vb ? kb : 0);
    const int64_t col0 = h * DH, HD2 = 2 * (int64_t)HD, lo_off = 2 * (int64_t)plane;
    float gain[8];
    gain_cols(gain, ks, 1.f, t);
    const float* uk = unit + plane;
    const float* nk = norm + (size_t)M * H;
    l2norm_bwd_planes(a4, uk + ma * HD + col0, uk + mb * HD + col0, nk + ma * H + h,
                      nk + mb * H + h, va, vb, gain, dkv + ma * HD2 + col0, dkv + mb * HD2 + col0,
                      lo_off, keep_lo, t, part);
#pragma unroll
    for (int dt = 0; dt < 4; ++dt) {
      const int64_t col = HD + col0 + 8 * dt + 2 * t;
      __nv_bfloat162 h2, l2;
      if (va) {
        split2(dv[4 * dt], dv[4 * dt + 1], keep_lo, h2, l2);
        *reinterpret_cast<__nv_bfloat162*>(dkv + ma * HD2 + col) = h2;
        *reinterpret_cast<__nv_bfloat162*>(dkv + lo_off + ma * HD2 + col) = l2;
      }
      if (vb) {
        split2(dv[4 * dt + 2], dv[4 * dt + 3], keep_lo, h2, l2);
        *reinterpret_cast<__nv_bfloat162*>(dkv + mb * HD2 + col) = h2;
        *reinterpret_cast<__nv_bfloat162*>(dkv + lo_off + mb * HD2 + col) = l2;
      }
    }
  }
  if (ks_part != nullptr)
    head_cols_partial(part, reinterpret_cast<float*>(ring.stages), ks_part + block_row() * DH,
                      lane);
}

// The map of a [rows, cols] bf16 plane (row stride ld) in boxes of 32
// columns x box_rows rows with the 64-B swizzle (sm90::map_sw64; DH = 32
// columns here).
inline int map_sw64(CUtensorMap* map, const void* ptr, int rows, int cols, int64_t ld,
                    int box_rows = WG_TILE) {
  static_assert(DH == 32, "the wgmma passes' planes are boxes of 32 columns");
  return sm90::map_sw64(map, ptr, rows, cols, ld, box_rows);
}

// Launch the row term's walk and both passes over R sequences of n tokens, H
// heads: qk [4][M][HD], v and dO [2][M][HD] (hi, lo), bias and biasT
// [H][n][n] fp32 (both null: no bias, read as zeros by BIAS 1), mld
// [R][H][n] float4 with (m log2 e, 1 / l) written;
// out dq [2][M][HD], dkv [2][M][2 HD]; q_part / k_part [R * ceil(n / 64) *
// H][32] or null.
template <int Dummy = 0>
int launch_wg_passes(const bf16* qk, const bf16* v, const bf16* dO, const float* bias,
                     const float* biasT, float4* mld, const float* unit, const float* norm,
                     const float* qs, const float* ks, float scale, bf16* dq, bf16* dkv,
                     float* q_part, float* k_part, int R, int n, int H, int keep_lo,
                     cudaStream_t st) {
  const int M = R * n, HD = H * DH;
  const size_t plane = (size_t)M * HD;
  sm90::Maps kv{}, qd{};
  const bf16* const kv_src[4] = {qk + 2 * plane, qk + 3 * plane, v, v + plane};
  const bf16* const qd_src[4] = {qk, qk + plane, dO, dO + plane};
  // the bias tiles through TMA where its rows are 16-B aligned, else read
  // from global memory
  const int kind = bias != nullptr && n % 4 == 0 ? 2 : 1;
  int err = 0;
  for (int p = 0; p < 4 && !err; ++p) err = map_sw64(&kv.m[p], kv_src[p], M, HD, HD);
  for (int p = 0; p < 4 && !err; ++p) err = map_sw64(&qd.m[p], qd_src[p], M, HD, HD);
  if (!err && kind == 2) err = sm90::make_map(&kv.m[MAP_BIAS], bias, H * n, n, n, WG_ROWS, 4);
  if (!err && kind == 2) err = sm90::make_map(&qd.m[MAP_BIAS], biasT, H * n, n, n, WG_ROWS, 4);
  if (err) return err;
  auto row_term = kind == 2 ? bwd_dq_wg_kernel<2, true> : bwd_dq_wg_kernel<1, true>;
  auto dq_pass = kind == 2 ? bwd_dq_wg_kernel<2, false> : bwd_dq_wg_kernel<1, false>;
  auto dkv_pass = kind == 2 ? bwd_dkv_wg_kernel<2> : bwd_dkv_wg_kernel<1>;
  cudaFuncSetAttribute(row_term, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_PASS_SMEM);
  cudaFuncSetAttribute(dq_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_PASS_SMEM);
  cudaFuncSetAttribute(dkv_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_PASS_SMEM);
  dim3 grid(R, (n + WG_ROWS - 1) / WG_ROWS, H);
  row_term<<<grid, WG_ROWS * 2, WG_PASS_SMEM, st>>>(kv, qk, dO, bias, mld, unit, norm, qs, scale,
                                                    dq, nullptr, M, n, HD, keep_lo);
  dq_pass<<<grid, WG_ROWS * 2, WG_PASS_SMEM, st>>>(kv, qk, dO, bias, mld, unit, norm, qs, scale,
                                                   dq, q_part, M, n, HD, keep_lo);
  dkv_pass<<<grid, WG_ROWS * 2, WG_PASS_SMEM, st>>>(qd, qk, v, biasT, mld, unit, norm, ks, dkv,
                                                    k_part, M, n, HD, keep_lo);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace ctc
