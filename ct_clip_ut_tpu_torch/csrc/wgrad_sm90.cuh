// Weight gradients on the Hopper core (sm_90a only): C[i, j] = sum over
// token rows m of A[m, i] B[m, j], A and B row-major bf16 [tokens, .] as
// the backward chains hold activations and cotangents, C fp32.
//
// Both operands of such a product are MN-major (contiguous along the
// output's rows and columns, strided along the contraction), which wgmma
// reads with its transpose bits set. One block of 288 threads sums one
// 128 x 128 tile of C over ALL the token rows, in order, and stores it: no
// atomics and no partial buffers, so two calls give the same bits (the TPU
// kernels sum over a sequential grid the same way). The block is
// gemm_sm90.cuh's: one producer warp issuing TMA loads of 64-token slices
// (per operand two boxes of 64 columns x 64 tokens, 128-B swizzle) into a
// ring of WG_STAGES tiles, two consumer warpgroups of 64 output rows
// running wgmma m64n128k16 with MN-major descriptors (a 16-token step is
// 2 KB into a box; B's two 64-column boxes 8 KB apart), keeping one slice's
// wgmma group in flight while the next is issued; the epilogue from
// registers. Which operand maps, columns and output a tile takes is a plan
// functor's choice (`tile(t)`), so one launch serves several weights. A plan
// with PASSES = 3 makes an fp32 weight gradient of split-bf16 operands: its
// tiles name the hi planes' maps, each lo plane's map is the next one, and
// the block walks the tokens three times (A_hi B_hi, A_lo B_hi, A_hi B_lo,
// as gemm_sm90.cuh's SplitPlan); such plans read up to 12 maps (`MapsN`).
// wgmma's fp32 accumulator adds each 16-deep step without rounding to
// nearest: on the H100 a three-pass weight gradient over 27,648 tokens read
// 1.3e-4 of its largest entry off the fp32 sum, every entry nearer zero. So
// a three-pass block adds its accumulator into fp32 sums of its own in
// shared memory every WG_FLUSH token slices and starts it again from zero;
// the same gradient then read 1.5e-5, the split products' own error. (The
// bf16 plans' bands, 1.5e-2, do not see the drift; they keep one
// accumulator.) A plan with few tiles (BlockWgradSplitPlan's 32 at D = 512
// on 132 SMs) can split each tile's tokens into chunks of `chunk` slices:
// block c * tiles + t sums chunk c of tile t (flushing every WG_FLUSH of its
// slices) and writes its fp32 partial tile whole; wgrad_sum_kernel then adds
// each tile's partials in chunk order and stores them through the
// epilogue. No atomics either way: two calls give the same bits.
#pragma once

#include "gemm_sm90.cuh"

namespace ctc {
namespace sm90 {

constexpr int WG_STAGES = 6;   // one block an SM: a deeper ring than the K-major core's
constexpr int WG_SMEM = WG_STAGES * STAGE_BYTES + 1024;
// three-pass plans: a shorter ring beside the consumers' fp32 sums ([64][256]
// floats, each consumer thread's 64 in a column), flushed every WG_FLUSH slices
constexpr int WG_SPLIT_STAGES = 4;
constexpr int WG_FLUSH = 4;
constexpr int WG_SPLIT_SMEM = WG_SPLIT_STAGES * STAGE_BYTES + 64 * CONSUMER_WARPS * 32 * 4 + 1024;

// One output tile: A's columns i0 .. i0 + 127 from map a, B's columns j0 ..
// j0 + 127 from map b, summed into output `out` at rows orow0 ... (nrows
// of them hold data) and columns j0 ... (In a three-pass plan a and b are
// the hi planes' maps; a + 1 and b + 1 are their lo planes'.)
struct WgradTile {
  int a, b, i0, j0, out, orow0, nrows;
};

// More tensor maps than Maps holds, for the split plans (hi and lo planes
// of every operand): a kernel parameter of N * 128 B.
template <int N>
struct MapsN {
  CUtensorMap m[N];
};

// d[64] += A (64 x 16, MN-major) . B (128 x 16, MN-major)^T
__device__ __forceinline__ void wgmma_m64n128k16_mn(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// part [chunks * tiles][64][256]: a consumer thread's 64 sums of block b at
// part[(b * 64 + i) * 256 + threadIdx.x], coalesced
template <class Plan, class Epi, class MapsT>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_kernel(const __grid_constant__ MapsT maps, const Plan plan, const Epi epi, int tokens,
             int tiles, int chunk, float* __restrict__ part) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  char* ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  constexpr bool SPLIT = Passes<Plan>::value > 1;
  constexpr int NS = SPLIT ? WG_SPLIT_STAGES : WG_STAGES;
  const WgradTile tile = plan.tile(blockIdx.x % tiles);
  const int slices = (tokens + BK - 1) / BK;             // token slices of one pass
  // this block's slices [slice0, slice0 + passes_k) of each pass
  const int slice0 = chunk > 0 ? (blockIdx.x / tiles) * chunk : 0;
  const int passes_k = chunk > 0 ? min(chunk, slices - slice0) : slices;
  const int nk = Passes<Plan>::value * passes_k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % NS, pass = kt / passes_k;
        const int k0 = (slice0 + kt - pass * passes_k) * BK;
        const CUtensorMap* ma = &maps.m[tile.a + (pass == 1)];
        const CUtensorMap* mb = &maps.m[tile.b + (pass == 2)];
        mbar_wait(&empty[s], ((kt / NS) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        char* a = ring + s * STAGE_BYTES;
        char* b = a + A_BYTES;
        tma_load_2d(a, ma, &full[s], tile.i0, k0);
        tma_load_2d(a + B_HALF_BYTES, ma, &full[s], tile.i0 + 64, k0);
        tma_load_2d(b, mb, &full[s], tile.j0, k0);
        tma_load_2d(b + B_HALF_BYTES, mb, &full[s], tile.j0 + 64, k0);
      }
    }
  } else {
    const int wg = warp >> 2;
    float acc[64];
    // this thread's fp32 sums (three-pass plans), a column of [64][256]
    float* sums = reinterpret_cast<float*>(ring + NS * STAGE_BYTES) + threadIdx.x;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      if constexpr (SPLIT) sums[i * CONSUMER_WARPS * 32] = 0.f;
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % NS;
      mbar_wait(&full[s], (kt / NS) & 1);
      const uint32_t a = smem_u32(ring + s * STAGE_BYTES) + wg * B_HALF_BYTES;
      const uint32_t b = smem_u32(ring + s * STAGE_BYTES + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n128k16_mn(acc, desc_mn_sw128(a + kk * 2048, B_HALF_BYTES),
                            desc_mn_sw128(b + kk * 2048, B_HALF_BYTES));
      wgmma_commit();
      // the slice before this one is read: give its stage back
      wgmma_wait_one();
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % NS]);
      if constexpr (SPLIT) {
        if ((kt + 1) % WG_FLUSH == 0 || kt + 1 == nk) {
          wgmma_wait_all();
          fence_regs(acc);
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            sums[i * CONSUMER_WARPS * 32] += acc[i];
            acc[i] = 0.f;
          }
        }
      }
    }
    wgmma_wait_all();
    fence_regs(acc);
    if constexpr (SPLIT) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = sums[i * CONSUMER_WARPS * 32];
    }
    if (part != nullptr) {
      float* mine = part + (int64_t)blockIdx.x * 64 * CONSUMER_WARPS * 32 + threadIdx.x;
#pragma unroll
      for (int i = 0; i < 64; ++i) mine[i * CONSUMER_WARPS * 32] = acc[i];
    } else {
      epi(acc, tile, wg * 64 + (warp & 3) * 16, lane);
    }
  }
}

// The second launch of a chunked weight gradient: block t adds tile t's
// partials in chunk order, each thread its 64 sums as the consumer thread
// of the same index held them, and stores them through the epilogue.
template <class Plan, class Epi>
__global__ void __launch_bounds__(CONSUMER_WARPS * 32)
wgrad_sum_kernel(const Plan plan, const Epi epi, const float* __restrict__ part, int tiles,
                 int chunks) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const float* p = part + (int64_t)(c * tiles + blockIdx.x) * 64 * CONSUMER_WARPS * 32 +
                     threadIdx.x;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += p[i * CONSUMER_WARPS * 32];
  }
  epi(acc, plan.tile(blockIdx.x), (warp >> 2) * 64 + (warp & 3) * 16, lane);
}

// Launch wgrad_kernel over `tiles` tiles of the plan; returns the launch's
// error. chunk > 0 (with part: [ceil(slices / chunk) * tiles][64][256]
// fp32) splits each tile's token slices into chunks of `chunk`, then adds
// the partials (wgrad_sum_kernel).
template <class Plan, class Epi, class MapsT>
int launch_wgrad_sm90(const MapsT& maps, const Plan& plan, const Epi& epi, int tiles, int tokens,
                      cudaStream_t st, int chunk = 0, float* part = nullptr) {
  auto kern = wgrad_kernel<Plan, Epi, MapsT>;
  const int smem = Passes<Plan>::value > 1 ? WG_SPLIT_SMEM : WG_SMEM;
  const int slices = (tokens + BK - 1) / BK;
  const int chunks = chunk > 0 && part != nullptr ? (slices + chunk - 1) / chunk : 1;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (chunks == 1) {
    kern<<<tiles, THREADS, smem, st>>>(maps, plan, epi, tokens, tiles, 0, nullptr);
    return (int)cudaGetLastError();
  }
  kern<<<chunks * tiles, THREADS, smem, st>>>(maps, plan, epi, tokens, tiles, chunk, part);
  int err = (int)cudaGetLastError();
  if (!err) {
    wgrad_sum_kernel<Plan, Epi><<<tiles, CONSUMER_WARPS * 32, 0, st>>>(plan, epi, part, tiles,
                                                                        chunks);
    err = (int)cudaGetLastError();
  }
  return err;
}

// The split-bf16 weight gradients with each token slice's four planes
// staged once: a stage holds A's hi and lo planes and B's (each two boxes of
// 64 columns x 64 tokens, as wgrad_kernel's), 64 KB, three stages, and a
// consumer warpgroup takes a_hi b_lo, a_lo b_hi, a_hi b_hi from it into one
// accumulator, one slice's wgmma group in flight while the next is issued.
// wgrad_kernel's three-pass plans walk the tokens three times and read A's
// and B's hi planes twice from L2 (the fp32 BERT layer's weight gradients
// read at ~4 TB/s from L2 on the H100 80GB HBM3, 700 W, PERF.md). The accumulator is added
// into fp32 sums in registers every WG4_FLUSH slices (wgmma's accumulation
// drifts without; wgrad_kernel's smem sums would not fit beside the
// stages), started again from zero, and the sums go through the
// epilogue. One block a tile over every token, in order: no atomics, the
// same bits every call. The plan names each tile's hi maps (a, b); each lo
// plane's map is the next one. The fp32 weight gradients of the BERT layer,
// the patch embed and the GEGLU FF run on it. A pair of blocks in a thread
// block cluster, two tiles sharing one operand and each block multicasting
// one 64-column box of it into both blocks' stages, cut the reads from L2
// by a quarter but read slower on the H100 80GB HBM3, 700 W (PERF.md): it
// leaves the 64 KB that land in each block's shared memory a slice as they
// are, and the partners' handshake delays each stage's refill.
constexpr int WG4_STAGES = 3;
constexpr int WG4_STAGE = 2 * STAGE_BYTES;
constexpr int WG4_SMEM = WG4_STAGES * WG4_STAGE + 1024;
constexpr int WG4_FLUSH = 2;

template <class Plan, class Epi, class MapsT>
__global__ void __launch_bounds__(THREADS, 1)
wgrad4_kernel(const __grid_constant__ MapsT maps, const Plan plan, const Epi epi, int tokens) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[WG4_STAGES], empty[WG4_STAGES];
  char* ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  const WgradTile tile = plan.tile(blockIdx.x);
  const int nk = (tokens + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG4_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG4_STAGES, k0 = kt * BK;
        mbar_wait(&empty[s], ((kt / WG4_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], WG4_STAGE);
        for (int lo = 0; lo < 2; ++lo) {   // hi planes, then lo
          char* a = ring + s * WG4_STAGE + lo * STAGE_BYTES;
          char* b = a + A_BYTES;
          tma_load_2d(a, &maps.m[tile.a + lo], &full[s], tile.i0, k0);
          tma_load_2d(a + B_HALF_BYTES, &maps.m[tile.a + lo], &full[s], tile.i0 + 64, k0);
          tma_load_2d(b, &maps.m[tile.b + lo], &full[s], tile.j0, k0);
          tma_load_2d(b + B_HALF_BYTES, &maps.m[tile.b + lo], &full[s], tile.j0 + 64, k0);
        }
      }
    }
    return;
  }
  const int wg = warp >> 2;
  float acc[64], sums[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sums[i] = 0.f;
  fence_regs(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % WG4_STAGES;
    mbar_wait(&full[s], (kt / WG4_STAGES) & 1);
    const uint32_t hi = smem_u32(ring + s * WG4_STAGE), lo = hi + STAGE_BYTES;
    const uint32_t a_hi = hi + wg * B_HALF_BYTES, a_lo = lo + wg * B_HALF_BYTES;
    const uint32_t b_hi = hi + A_BYTES, b_lo = lo + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t ah = desc_mn_sw128(a_hi + kk * 2048, B_HALF_BYTES);
      const uint64_t bh = desc_mn_sw128(b_hi + kk * 2048, B_HALF_BYTES);
      wgmma_m64n128k16_mn(acc, ah, desc_mn_sw128(b_lo + kk * 2048, B_HALF_BYTES));
      wgmma_m64n128k16_mn(acc, desc_mn_sw128(a_lo + kk * 2048, B_HALF_BYTES), bh);
      wgmma_m64n128k16_mn(acc, ah, bh);
    }
    wgmma_commit();
    wgmma_wait_one();   // the slice before this one is read: give its stage back
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % WG4_STAGES]);
    if ((kt + 1) % WG4_FLUSH == 0 || kt + 1 == nk) {
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sums[i] += acc[i];
        acc[i] = 0.f;
      }
      fence_regs(acc);
    }
  }
  epi(sums, tile, wg * 64 + (warp & 3) * 16, lane);
}

// Launch wgrad4_kernel over `tiles` tiles of the plan; returns the launch's
// error.
template <class Plan, class Epi, class MapsT>
int launch_wgrad4_sm90(const MapsT& maps, const Plan& plan, const Epi& epi, int tiles, int tokens,
                       cudaStream_t st) {
  auto kern = wgrad4_kernel<Plan, Epi, MapsT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, WG4_SMEM);
  if (tiles == 0) return 0;
  kern<<<tiles, THREADS, WG4_SMEM, st>>>(maps, plan, epi, tokens);
  return (int)cudaGetLastError();
}

// out[o] [rows, cols] fp32 (row stride ld) = the tile's sums, rows orow0 +
// r for r < nrows, columns below cols[o]; pairs of columns as one 8-B store
// where cols and ld are even.
struct WgradStoreEpi {
  float* out[2];
  int ld[2], cols[2];
  __device__ void operator()(const float (&acc)[64], const WgradTile& tile, int r0,
                             int lane) const {
    const int g = lane >> 2, t = lane & 3;
    // selected, not indexed: a runtime index would put the arrays on the stack
    float* base = tile.out ? out[1] : out[0];
    const int ldo = tile.out ? ld[1] : ld[0], nc = tile.out ? cols[1] : cols[0];
    const bool pairs = ((ldo | nc) & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r >= tile.nrows) continue;
      float* row = base + (int64_t)(tile.orow0 + r) * ldo;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = tile.j0 + 8 * j + 2 * t;
        if (pairs && c + 1 < nc) {
          *reinterpret_cast<float2*>(row + c) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (c + e < nc) row[c + e] = acc[4 * j + 2 * h + e];
        }
      }
    }
  }
};

// C = A^T B over `tokens` rows for one pair of operands: maps 0 A, 1 B;
// tiles row-major over ceil(rows / 128) x ceil(cols / 128).
struct WgradPlan {
  int rows, col_tiles;
  __device__ WgradTile tile(int t) const {
    const int i0 = (t / col_tiles) * BM, j0 = (t % col_tiles) * BN;
    return {0, 1, i0, j0, 0, i0, min(BM, rows - i0)};
  }
};

}  // namespace sm90
}  // namespace ctc
