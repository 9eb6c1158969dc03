// GEGLU feed-forward block, backward in fp32: the port of
// ct_clip_ut_tpu/ops/pallas_ff.py:_backward_impl (_bwd_kernel) at fp32,
// where its rounding points are identities. Two forms: the data gradient
// alone for the gradient attribution methods (Grad-CAM, integrated
// gradients), which differentiate the score with respect to activations
// and patches, never weights; and with every parameter gradient (dgamma,
// dbeta, dWv | dWg, dW2) for the fp32 train step.
//
// dx = LN'(dxn) (+ g),  dxn = dvalue Wv + dgate Wg,  dvalue = dh gelu(gate),
// dgate = dh value gelu'(gate),  dh = g W2,  [value | gate] = xn [Wv | Wg]^T,
// dW2 = g^T h (h = gelu(gate) value),  [dWv; dWg] = [dvalue | dgate]^T xn
// over N token rows (D = 512, inner = 1365; N = 13,824 a Grad-CAM, 69,120
// an integrated-gradients chunk of 5, 27,648 a B = 2 train step).
//
// What bounds it on the H100: tensor-core operations, three fp32 products
// of 2 N D (2 inner), 2 N D inner and 2 N (2 inner) D for dx (30 N D inner
// as bf16 products at the bf16 peak, 1.47 ms at N = 69,120), two more of 2
// N D inner and 2 N D (2 inner) for the weights (48 N D inner in all: 0.94
// ms at N = 27,648). Launches:
//   split_kernel x 3      the planes of w_in (value rows, then the gate rows
//                         at row ldh of a zero-padded [2 ldh, D] plane, so
//                         dxn's K runs over [dvalue | dgate] with the same
//                         padding) and w_out (as stored, [D, ldw])
//   ln_split_kernel       xn's planes, and g's
//   gate_bwd_split_kernel per 128-row x 64-inner-column tile (one block an
//                         SM walking its tiles): [value | gate]
//                         recomputed (xn's planes against the value and gate
//                         rows' planes, m64n128, each K slice's four planes
//                         staged together), then dh = g W2 of the same 64
//                         columns in a second K loop (g's planes against
//                         W2's, read MN-major as stored, m64n64) into
//                         registers of its own; the epilogue forms dvalue | dgate (and, in
//                         the train form, h) from the three in registers and
//                         stores their hi / lo planes through shared memory
//                         as 16-B rows (dh never reaches memory)
//   split4_kn_kernel      dxn = [dvalue | dgate] [Wv; Wg] (the padded weight
//                         planes read as stored, K = 2 ldh; each K slice's
//                         four planes staged together, split_sm90.cuh)
//   ln_bwd_f32_kernel     dx (+ g); in the train form each block's dgamma
//                         and dbeta partial sums
//   colsum_kernel         (train form) dgamma | dbeta, the partials in order
//   wgrad4_kernel         (train form) dW2 = g^T h and dWv | dWg = [dvalue |
//                         dgate]^T xn in one launch (wgrad_sm90.cuh, each
//                         token slice's four planes staged once;
//                         FFWgradSplitPlan: 4 x 11 tiles of dW2, 22 x 4 of
//                         dWv | dWg, 132 in all), each tile summing all N
//                         rows in order: no atomics, the same bits every
//                         call; inner's padding stays out of the outputs.
//                         0.57-0.60 ms at N = 27,648, where wgrad_kernel's
//                         three passes over the tokens took 0.91
// The first design wrote dh to memory in fp32 (378 MB at N = 69,120) and
// read it back in the recompute's epilogue, whose 4-B stores straight from
// the fragments left the mainloop idle: that launch took 1.23 ms at N =
// 27,648 in the train form against the forward's 0.47 for the same product.
#include "split_sm90.cuh"
#include "wgrad_sm90.cuh"

namespace ctc {
namespace ff32b {

using namespace sm90;

// d[32] += A (64 x 16, K-major, desc a) . B (16 x 64, MN-major: W2 [K, N]
// read as it is stored, desc b); the transpose bit of B set
__device__ __forceinline__ void wgmma_m64n64k16_kn(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// Maps of gate_bwd_split_kernel: xn's planes [M, D], w_in's stacked planes
// [2 ldh, D] (value rows, gate rows at ldh), g's planes [M, D], W2's planes
// [D, ldw] (MN-major, boxes of 64 columns x 64 rows); each hi plane's lo
// plane is the next map.
constexpr int MAP_XN = 0, MAP_WI = 2, MAP_G = 4, MAP_WO = 6;
// a stage: A's hi and lo planes (128 rows x 64 K each), then B's hi and lo
// (64 value and 64 gate rows, or W2's 64 columns, x 64 K each)
constexpr int GATE_STAGES = 3;
constexpr int GATE_STAGE = 2 * A_BYTES + 2 * 2 * B_HALF_BYTES;
constexpr int EPI_BYTES = 2 * 16 * 128;           // a warp's hi and lo tiles of 16 x 64 bf16
constexpr int GATE_SMEM = GATE_STAGES * GATE_STAGE + CONSUMER_WARPS * EPI_BYTES + 1024;

// Store a warp's 16 x 64 tile of hi / lo pairs (y0, y1 at row g + 8 hf,
// columns 8 j + 2 t, + 1: ys[4 j + 2 hf + e]) to rows row0 ... (< M) of the
// planes hi / lo [M, ld] at column c0 (a multiple of 64; chunks of 8
// columns at or past `cols` not stored): through `buf` (the warp's 4 KB of
// shared memory, 16-B chunk c of row r at chunk c ^ (r % 8): no bank
// conflicts either way), then 16-B stores, eight lanes a 128-B row.
__device__ __forceinline__ void store_tile(const float (&ys)[32], bool keep_lo, char* buf,
                                           bf16* hi, bf16* lo, int64_t ld, int row0, int M,
                                           int c0, int cols, int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = g + 8 * hf, at = r * 128 + ((j ^ (r & 7)) << 4) + 4 * t;
      __nv_bfloat162 h2, l2;
      split2(ys[4 * j + 2 * hf], ys[4 * j + 2 * hf + 1], keep_lo, h2, l2);
      *reinterpret_cast<__nv_bfloat162*>(buf + at) = h2;
      *reinterpret_cast<__nv_bfloat162*>(buf + 2048 + at) = l2;
    }
  }
  __syncwarp();
  const int c = lane & 7, col = c0 + 8 * c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * i + (lane >> 3), m = row0 + r;
    if (m < M && col < cols) {
      const int at = r * 128 + ((c ^ (r & 7)) << 4);
      const int64_t off = (int64_t)m * ld + col;
      *reinterpret_cast<uint4*>(hi + off) = *reinterpret_cast<const uint4*>(buf + at);
      *reinterpret_cast<uint4*>(lo + off) = *reinterpret_cast<const uint4*>(buf + 2048 + at);
    }
  }
}

// [value | gate] and dh of 128-row x 64-inner-column tiles in blocks of
// gemm_sm90.cuh's shape (one producer warp, two consumer warpgroups of 64
// rows; 96 accumulator registers a thread), one block an SM walking its
// tiles, so the producer loads a tile's first slices while the consumers
// run the last one's epilogue. Each K slice
// stages both operands' hi and lo planes and takes its three products at
// once (a_hi b_lo, a_lo b_hi, a_hi b_hi), so each plane crosses from L2 once
// (three passes over K, as SplitPlan walks them, read A's hi plane and B's
// twice). Slices [0, nk): xn's planes against the 64 value rows and the 64
// gate rows of w_in's planes into acc (m64n128); slices [nk, 2 nk): g's
// planes against W2's 64 columns, MN-major, into dh (m64n64). Then
// dvalue = dh gelu(gate), dgate = dh value gelu'(gate) as hi / lo planes
// dvg [2][M][2 ldh] at columns c and ldh + c, zeros in [inner, ldh); with
// TRAIN also h = gelu(gate) value as planes h [2][M][ldh].
template <bool TRAIN>
__global__ void __launch_bounds__(THREADS, 1)
gate_bwd_split_kernel(const __grid_constant__ MapsN<8> maps, bf16* __restrict__ dvg,
                      bf16* __restrict__ h, int M, int D, int inner, int ldh, int keep_lo) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[GATE_STAGES], empty[GATE_STAGES];
  char* ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  const int col_tiles = (ldh + 63) / 64, tiles = col_tiles * ((M + BM - 1) / BM);
  const int nk = (D + BK - 1) / BK, steps = 2 * nk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GATE_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // tiles blockIdx.x, + gridDim.x, ... (the inner columns fastest: the
  // blocks running together share their rows of xn and g in L2); slices
  // numbered across them, `it`, for the ring
  if (warp == CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / col_tiles) * BM, n0 = (tile % col_tiles) * 64;
        for (int kt = 0; kt < steps; ++kt, ++it) {
          const int s = it % GATE_STAGES, dh_pass = kt >= nk, k0 = (kt - dh_pass * nk) * BK;
          mbar_wait(&empty[s], ((it / GATE_STAGES) & 1) ^ 1);
          char* a = ring + s * GATE_STAGE;
          char* b = a + 2 * A_BYTES;
          const int amap = dh_pass ? MAP_G : MAP_XN, bmap = dh_pass ? MAP_WO : MAP_WI;
          mbar_expect_tx(&full[s], dh_pass ? 2 * A_BYTES + 2 * B_HALF_BYTES : GATE_STAGE);
          for (int lo = 0; lo < 2; ++lo) {
            tma_load_2d(a + lo * A_BYTES, &maps.m[amap + lo], &full[s], k0, m0);
            char* bp = b + lo * 2 * B_HALF_BYTES;
            if (!dh_pass) {
              tma_load_2d(bp, &maps.m[bmap + lo], &full[s], k0, n0);
              tma_load_2d(bp + B_HALF_BYTES, &maps.m[bmap + lo], &full[s], k0, ldh + n0);
            } else {
              tma_load_2d(bp, &maps.m[bmap + lo], &full[s], n0, k0);
            }
          }
        }
      }
    }
    return;
  }
  const int wg = warp >> 2, t = lane & 3;
  char* buf = ring + GATE_STAGES * GATE_STAGE + warp * EPI_BYTES;
  // this warpgroup's rows of A's planes, then B's hi and lo planes
  auto planes = [&](int it, uint32_t& ah, uint32_t& al, uint32_t& bh, uint32_t& bl) {
    const int s = it % GATE_STAGES;
    mbar_wait(&full[s], (it / GATE_STAGES) & 1);
    ah = smem_u32(ring + s * GATE_STAGE) + wg * (64 * BK * 2);
    al = ah + A_BYTES;
    bh = smem_u32(ring + s * GATE_STAGE + 2 * A_BYTES);
    bl = bh + 2 * B_HALF_BYTES;
  };
  // the slice before `it` is read: give its stage back
  auto slice_done = [&](int it, bool first) {
    wgmma_wait_one();
    if (!first && lane == 0) mbar_arrive(&empty[(it - 1) % GATE_STAGES]);
  };
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / col_tiles) * BM, n0 = (tile % col_tiles) * 64;
    // the value | gate loop, then the dh loop (two loops: a wgmma of either
    // shape behind a branch in one loop made ptxas serialize them), each
    // keeping one slice's wgmma group in flight while the next is issued;
    // the zeros defined before the first wgmma (a definition of an
    // accumulator inside the pipeline also serializes it)
    float acc[64], dh[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) dh[i] = 0.f;
    fence_regs(acc);
    fence_regs(dh);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      uint32_t ah, al, bh, bl;
      planes(it, ah, al, bh, bl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_m64n128k16(acc, desc_sw128(ah + kk * 32), desc_sw128(bl + kk * 32));
        wgmma_m64n128k16(acc, desc_sw128(al + kk * 32), desc_sw128(bh + kk * 32));
        wgmma_m64n128k16(acc, desc_sw128(ah + kk * 32), desc_sw128(bh + kk * 32));
      }
      wgmma_commit();
      slice_done(it, kt == 0);
    }
    for (int kt = nk; kt < steps; ++kt, ++it) {
      uint32_t ah, al, bh, bl;
      planes(it, ah, al, bh, bl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_m64n64k16_kn(dh, desc_sw128(ah + kk * 32),
                           desc_mn_sw128(bl + kk * 2048, B_HALF_BYTES));
        wgmma_m64n64k16_kn(dh, desc_sw128(al + kk * 32),
                           desc_mn_sw128(bh + kk * 2048, B_HALF_BYTES));
        wgmma_m64n64k16_kn(dh, desc_sw128(ah + kk * 32),
                           desc_mn_sw128(bh + kk * 2048, B_HALF_BYTES));
      }
      wgmma_commit();
      slice_done(it, false);
    }
    wgmma_wait_all();
    // the tile's last stage back: the producer is loading the next tile's
    // slices while this one's epilogue runs
    if (lane == 0) mbar_arrive(&empty[(it - 1) % GATE_STAGES]);
    fence_regs(acc);
    fence_regs(dh);

    // the epilogue: value acc[4 j + 2 hf + e], gate acc[4 (j + 8) + 2 hf + e],
    // dh[4 j + 2 hf + e] at row g + 8 hf, inner column n0 + 8 j + 2 t + e
    const int row0 = m0 + wg * 64 + (warp & 3) * 16;
    float dv[32], dg[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * j + i;
        dv[k] = dg[k] = 0.f;
        if (n0 + 8 * j + 2 * t + (i & 1) < inner) {
          const float value = acc[k], gate = acc[4 * (j + 8) + i];
          const float cdf = 0.5f * (1.0f + erff(gate * 0.7071067811865476f));
          const float gprime = cdf + gate * 0.3989422804014327f * __expf(-0.5f * gate * gate);
          dv[k] = dh[k] * gate * cdf;
          dg[k] = dh[k] * value * gprime;
          acc[k] = gate * cdf * value;   // h
        } else {
          acc[k] = 0.f;
        }
      }
    }
    const int64_t mvg = (int64_t)M * 2 * ldh;
    store_tile(dv, keep_lo, buf, dvg, dvg + mvg, 2 * ldh, row0, M, n0, ldh, lane);
    store_tile(dg, keep_lo, buf, dvg + ldh, dvg + mvg + ldh, 2 * ldh, row0, M, n0, ldh, lane);
    if constexpr (TRAIN)
      store_tile(*reinterpret_cast<const float(*)[32]>(acc), keep_lo, buf, h,
                 h + (int64_t)M * ldh, ldh, row0, M, n0, ldh, lane);
  }
}

// The two weight gradients in one launch. Maps (hi, lo each): 0 / 1 g [M,
// D], 2 / 3 h [M, inner] (row stride ldh), 4 / 5 [dvalue | dgate] [M, 2
// ldh], 6 / 7 xn [M, D]. Tiles [0, d_tiles * inner_tiles): dW2 [D, inner] =
// g^T h (output 0); then dW_in [2 inner, D]: dvalue^T xn (rows [0, inner),
// columns i0 of the dvalue | dgate planes) and dgate^T xn (rows [inner, 2
// inner), columns ldh + i0) (output 1). A value tile's last columns past
// inner read gate columns, a gate tile's TMA zeros: neither lands in a
// stored row.
struct FFWgradSplitPlan {
  int D, inner, ldh, d_tiles, inner_tiles;
  __device__ WgradTile tile(int t) const {
    const int out_tiles = d_tiles * inner_tiles;
    if (t < out_tiles) {
      const int i0 = (t / inner_tiles) * BM, j0 = (t % inner_tiles) * BN;
      return {0, 2, i0, j0, 0, i0, min(BM, D - i0)};
    }
    const int u = t - out_tiles, it = u / d_tiles, j0 = (u % d_tiles) * BN;
    const int gate = it >= inner_tiles, i0 = (gate ? it - inner_tiles : it) * BM;
    return {4, 6, gate * ldh + i0, j0, 1, gate * inner + i0, min(BM, inner - i0)};
  }
};

}  // namespace ff32b
}  // namespace ctc

using namespace ctc::sm90;

// x [M, D], g [M, D] fp32 (D a multiple of 8); gamma / beta [D], w_in
// [2*inner, D] and w_out [D, inner] (row stride ldw, a multiple of 8) fp32;
// workspaces wi_s [2][2*ldh][D] bf16 ZEROED (its rows inner .. ldh - 1 and
// ldh + inner .. 2 ldh - 1 are never written), wo_s [2][D][ldw], xn_s
// [2][M][D], g_s [2][M][D], dvg_s [2][M][2*ldh] bf16 and dxn [M][D] fp32
// (ldh >= inner, a multiple of 8); out dx [M, D] fp32 (+ g with residual).
// The train step's form (dw_in not null) also takes the workspaces h_s
// [2][M][ldh] bf16 and ln_part [ln_parts(M)][2 D] fp32 and writes dgb [2][D]
// (dgamma, dbeta), dw_in [2*inner, D] and dw_out [D, inner] fp32 whole;
// with dw_in null those five are unused. Every pointer 16-B aligned. flags
// 1: every lo plane zeroed (one bf16 product for each fp32 one, the
// control).
extern "C" int ctc_geglu_ff_bwd_f32(const void* x, const void* gamma, const void* beta,
                                    const void* w_in, const void* w_out, const void* g,
                                    void* wi_s, void* wo_s, void* xn_s, void* g_s, void* dvg_s,
                                    void* dxn, void* dx, void* h_s, void* ln_part, void* dgb,
                                    void* dw_in, void* dw_out, int M, int D, int inner, int ldh,
                                    int ldw, int residual, int flags, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int keep = !(flags & 1);
  const bool train = dw_in != nullptr;
  const int64_t md = (int64_t)M * D, wrows = (int64_t)2 * ldh * D, half = (int64_t)inner * D;
  const int64_t wout = (int64_t)D * ldw, mvg = (int64_t)M * 2 * ldh, mh = (int64_t)M * ldh;
  bf16 *wi = (bf16*)wi_s, *wo = (bf16*)wo_s, *xn = (bf16*)xn_s, *gs = (bf16*)g_s;
  bf16 *dvg = (bf16*)dvg_s, *hs = (bf16*)h_s;
  const float* xf = static_cast<const float*>(x);
  const float* win = static_cast<const float*>(w_in);
  using namespace ctc::ff32b;
  MapsN<8> gate{};
  int err = map_a(&gate.m[MAP_XN], xn, M, D, D);
  if (!err) err = map_a(&gate.m[MAP_XN + 1], xn + md, M, D, D);
  if (!err) err = map_b(&gate.m[MAP_WI], wi, 2 * ldh, D, D);
  if (!err) err = map_b(&gate.m[MAP_WI + 1], wi + wrows, 2 * ldh, D, D);
  if (!err) err = map_a(&gate.m[MAP_G], gs, M, D, D);
  if (!err) err = map_a(&gate.m[MAP_G + 1], gs + md, M, D, D);
  if (!err) err = map_mn(&gate.m[MAP_WO], wo, D, inner, ldw);
  if (!err) err = map_mn(&gate.m[MAP_WO + 1], wo + wout, D, inner, ldw);
  MapsN<8> wg{};
  if (train) {
    // (hi, lo) of g, h, [dvalue | dgate], xn: FFWgradSplitPlan's maps
    const bf16* const src[4] = {gs, hs, dvg, xn};
    const int cols[4] = {D, inner, 2 * ldh, D}, ld[4] = {D, ldh, 2 * ldh, D};
    const int64_t lo[4] = {md, mh, mvg, md};
    for (int i = 0; i < 4 && !err; ++i) {
      err = map_mn(&wg.m[2 * i], src[i], M, cols[i], ld[i]);
      if (!err) err = map_mn(&wg.m[2 * i + 1], src[i] + lo[i], M, cols[i], ld[i]);
    }
  }
  if (err) return err;
  err = split_to(win, wi, wi + wrows, half, keep, st);
  if (!err)
    err = split_to(win + half, wi + (int64_t)ldh * D, wi + wrows + (int64_t)ldh * D, half, keep,
                   st);
  if (!err) err = split(w_out, wo, wout, keep, st);
  if (!err)
    err = launch_ln_split(xf, static_cast<const float*>(gamma), static_cast<const float*>(beta),
                          nullptr, xn, xn + md, nullptr, nullptr, M, D, 1e-5f, keep, st,
                          static_cast<const float*>(g), gs, gs + md);
  if (err) return err;
  {
    auto kern = train ? gate_bwd_split_kernel<true> : gate_bwd_split_kernel<false>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, GATE_SMEM);
    // persistent: one block an SM, each walking its tiles
    int sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int tiles = (ldh + 63) / 64 * ((M + BM - 1) / BM);
    kern<<<tiles < sms ? tiles : sms, THREADS, GATE_SMEM, st>>>(
        gate, dvg, train ? hs : nullptr, M, D, inner, ldh, keep);
    err = (int)cudaGetLastError();
  }
  if (err) return err;
  float* dxnf = static_cast<float*>(dxn);
  float* part = static_cast<float*>(ln_part);
  err = split4_product_kn(dvg, dvg + mvg, 2 * ldh, wi, wi + wrows, D, M, D, 2 * ldh,
                          F32OutEpi{dxnf, nullptr, nullptr, M, D}, st);
  if (!err)
    err = launch_ln_bwd_f32(xf, static_cast<const float*>(gamma), dxnf, nullptr,
                            residual ? static_cast<const float*>(g) : nullptr,
                            static_cast<float*>(dx), M, D, st, train ? part : nullptr);
  if (err || !train) return err;
  err = launch_colsum(part, static_cast<float*>(dgb), ln_parts(M), 2 * D, 2 * D, 1.f, st);
  if (err) return err;
  const int d_tiles = (D + BN - 1) / BN, inner_tiles = (inner + BN - 1) / BN;
  return launch_wgrad4_sm90(
      wg, FFWgradSplitPlan{D, inner, ldh, d_tiles, inner_tiles},
      WgradStoreEpi{{(float*)dw_out, (float*)dw_in}, {inner, D}, {inner, D}},
      d_tiles * inner_tiles * 3, M, st);
}
