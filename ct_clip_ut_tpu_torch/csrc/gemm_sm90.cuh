// Hopper GEMM core of the port's hand-written kernels (sm_90a only).
//
// C = A . B^T with A [M, K] and B [N, K] bf16, both K-major: the nn.Linear
// (out, in) layout the port keeps its weights in, which wgmma reads without
// a transpose. fp32 accumulation in registers.
//
// One block of 288 threads computes a 128 x 128 tile of C:
//   - one producer warp (warp 8) starts TMA loads (cp.async.bulk.tensor.2d,
//     128-B swizzle) of 64-deep K slices of A (128 rows) and B (two boxes
//     of 64 rows) into a ring of STAGES shared tiles, paced by full / empty
//     mbarriers; it gives back its registers (setmaxnreg.dec);
//   - two consumer warpgroups (warps 0-3, 4-7) each take 64 rows of the tile
//     and run wgmma.mma_async m64n128k16 on every slice that has arrived,
//     the accumulator in registers;
//   - the epilogue runs from those registers through a functor (no fp32 C
//     tile in shared memory): `epi(acc, row, nt, lane)`, where `row` is the
//     first of the warp's 16 rows and acc[4j + 2h + e] holds C[row + lane/4 +
//     8h][nt-tile column 8j + 2(lane%4) + e] (the wgmma D fragment layout).
// Two blocks fit an SM (96 KB of ring each, <= 112 registers a thread), so
// one block's epilogue and first loads overlap the other's products.
//
// A plan with S8 runs the same ring on int8 operands (the W8A8 FF): a K
// slice of 128 int8 fills the same 128-B swizzle row, wgmma m64n128k32
// .s32.s8.s8 steps 32 B along it as the bf16 m64n128k16 does, the maps
// are UINT8 (map_a8 / map_b8) and the accumulator is int acc[64] in the
// same D fragment layout, handed to the epilogue as `const int (&)[64]`.
//
// Which maps a tile reads is a plan functor's choice (`src(nt)`): the GEGLU's
// first product pairs 64 value rows with 64 gate rows from two maps of the
// same weight, the attention block's projection picks q, k or v. A plan with
// PASSES > 1 walks the K slices that many times, `src(nt, pass)` naming the
// maps of each pass into the same accumulator: SplitPlan's three passes
// (A_hi B_hi, A_lo B_hi, A_hi B_lo) make an fp32 product of bf16 hi / lo
// planes (hi = bf16(a), lo = bf16(a - hi)) within ~2^-16 of fp32. TMA fills
// boxes that run past a matrix's edge with zeros, which covers a ragged M,
// N and K; epilogues mask their stores to the matrix. TMA needs 16-B aligned
// base addresses and row strides: the wrappers pad what is not
// (ops/*.py, _build.tma_rows). A plan with B_MN reads B as a [K, N] matrix
// as it is stored (a weight in a backward product, LinearKNPlan): boxes of
// 64 columns x 64 K rows and wgmma's transpose bit for B. A product of
// fewer 128 x 128 tiles than the card has SMs can take gemm64_kernel's
// 64-row tiles instead (below).
//
// The tensor maps are encoded on the host per call with cuTensorMapEncodeTiled,
// looked up in the already-loaded libcuda.so.1 (no -lcuda at link time), and
// passed by value as a __grid_constant__ parameter.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace ctc {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;                 // rows of a tile: two consumer warpgroups of 64
constexpr int BN = 128;                 // columns of a tile
constexpr int BK = 64;                  // K slice: 64 bf16 = one 128-B swizzle row
constexpr int STAGES = 3;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = CONSUMER_WARPS * 32 + 32;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_HALF_BYTES = 64 * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + 2 * B_HALF_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;   // + slack to align the ring to 1 KB
constexpr int MAX_MAPS = 6;

struct Maps {
  CUtensorMap m[MAX_MAPS];
};

// The maps and rows one tile reads: A from m[a] at the block's rows, B's
// rows 0-63 from m[b0] at row0 and rows 64-127 from m[b1] at row1.
struct TileSrc {
  int a, b0, row0, b1, row1;
};

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed. A
// wait that never ends (a fault in the ring's bookkeeping) traps after 2^26
// polls, each of which suspends the thread for a while, instead of hanging
// the card: the launch then fails with an error the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// all but the last committed group done
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major tile written by TMA with the
// 128-B swizzle: rows of 128 B, 8-row core groups 1024 B apart (SBO), the
// leading offset unused by this mode (1). Stepping K by 16 bf16 inside the
// swizzle row adds 32 B to the start address; tiles sit on 1-KB boundaries.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Shared-memory descriptor of an MN-major tile written by TMA with the
// 128-B swizzle: rows of 128 B run along MN (64 bf16), 8-row core groups
// along K 1024 B apart (SBO); 64-wide MN blocks `lbo` bytes apart (LBO).
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64] += A (64 x 16, desc a) . B (128 x 16, desc b)^T
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}"
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

// d[64] += A (64 x 16, K-major, desc a) . B (16 x 128, MN-major: a weight
// [K, N] read as it is stored, desc b); the transpose bit of B set
__device__ __forceinline__ void wgmma_m64n128k16_kn(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}"
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

// d[64] += A (64 x 32 int8, desc a) . B (128 x 32 int8, desc b)^T in int32:
// both K-major (integer wgmma has no transpose), 32 B of K a step as above
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d[32] += A (64 x 16) . B (64 x 16, desc b)^T with A in registers: this
// warp's 16 rows of A as the mma.sync m16n8k16 A fragment (a[0] rows g,
// columns 2t, 2t + 1; a[1] rows g + 8; a[2], a[3] columns + 8), d in the
// D fragment layout above. The attention core feeds q, and p straight from
// the score registers, this way.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Registers an asynchronous wgmma writes: this empty asm "modifies" them, so
// the compiler moves no read of them above the wgmma_wait before it and no
// write of them below the wgmma that follows.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Two floats rounded to bf16 and packed, the first in the low half: an A
// fragment register of p for the attention cores.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the kernel ------------------------------------------------------------

// K loops of a plan: PASSES where it declares them, else 1.
template <class P, class = void>
struct Passes {
  static constexpr int value = 1;
};
template <class P>
struct Passes<P, std::void_t<decltype(P::PASSES)>> {
  static constexpr int value = P::PASSES;
};

// Whether a plan's B operand is MN-major (B_MN = true: a [K, N] matrix read
// through map_mn in boxes of 64 columns x 64 K rows, TileSrc's row0 / row1
// naming B's first columns) rather than [N, K] K-major.
template <class P, class = void>
struct BMajor {
  static constexpr bool mn = false;
};
template <class P>
struct BMajor<P, std::void_t<decltype(P::B_MN)>> {
  static constexpr bool mn = P::B_MN;
};

// Whether a plan's operands are int8 (S8 = true: UINT8 maps, K slices of
// 128, int32 accumulators) rather than bf16.
template <class P, class = void>
struct Int8 {
  static constexpr bool value = false;
};
template <class P>
struct Int8<P, std::void_t<decltype(P::S8)>> {
  static constexpr bool value = P::S8;
};

template <class Plan>
__device__ __forceinline__ TileSrc plan_src(const Plan& plan, int nt, int pass) {
  if constexpr (Passes<Plan>::value == 1) {
    return plan.src(nt);
  } else {
    return plan.src(nt, pass);
  }
}

template <class Plan, class Epi>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const __grid_constant__ Maps maps, const Plan plan, const Epi epi, int K) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  char* ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  constexpr int passes = Passes<Plan>::value;
  constexpr bool s8 = Int8<Plan>::value;
  static_assert(!(s8 && BMajor<Plan>::mn), "int8 wgmma reads both operands K-major");
  constexpr int kslice = s8 ? 2 * BK : BK;     // elements in a 128-B swizzle row
  const int nt = blockIdx.x, m0 = blockIdx.y * BM;
  const int nk = (K + kslice - 1) / kslice, steps = nk * passes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // producer: the roles never meet again at a block barrier
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (lane == 0) {
      for (int kt = 0; kt < steps; ++kt) {
        const int pass = passes == 1 ? 0 : kt / nk, k0 = (kt - pass * nk) * kslice;
        const TileSrc src = plan_src(plan, nt, pass);
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        char* a = ring + s * STAGE_BYTES;
        char* b = a + A_BYTES;
        tma_load_2d(a, &maps.m[src.a], &full[s], k0, m0);
        if constexpr (BMajor<Plan>::mn) {
          tma_load_2d(b, &maps.m[src.b0], &full[s], src.row0, k0);
          tma_load_2d(b + B_HALF_BYTES, &maps.m[src.b1], &full[s], src.row1, k0);
        } else {
          tma_load_2d(b, &maps.m[src.b0], &full[s], k0, src.row0);
          tma_load_2d(b + B_HALF_BYTES, &maps.m[src.b1], &full[s], k0, src.row1);
        }
      }
    }
  } else {
    const int wg = warp >> 2;
    std::conditional_t<s8, int, float> acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int kt = 0; kt < steps; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint32_t a = smem_u32(ring + s * STAGE_BYTES) + wg * (64 * BK * 2);
      const uint32_t b = smem_u32(ring + s * STAGE_BYTES + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (s8) {
          wgmma_m64n128k32_s8(acc, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32));
        } else if constexpr (BMajor<Plan>::mn) {
          wgmma_m64n128k16_kn(acc, desc_sw128(a + kk * 32),
                              desc_mn_sw128(b + kk * 2048, B_HALF_BYTES));
        } else {
          wgmma_m64n128k16(acc, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    epi(acc, m0 + wg * 64 + (warp & 3) * 16, nt, lane);
  }
}

// ---- plans -----------------------------------------------------------------

// One A (map 0) and one B (map 1): B's tile rows are nt * 128 ...
struct LinearPlan {
  __device__ TileSrc src(int nt) const { return {0, 1, nt * BN, 1, nt * BN + 64}; }
};

// C = A . W with W [K, N] as it is stored (map 1 from map_mn): the backward
// products of a layer's activations' gradients with its nn.Linear weights,
// read MN-major instead of transposed per call.
struct LinearKNPlan {
  static constexpr bool B_MN = true;
  __device__ TileSrc src(int nt) const { return {0, 1, nt * BN, 1, nt * BN + 64}; }
};

// The q, k and v projections of a cosine-attention block in one launch.
// maps: 0 xn (the LayerNorm'd x), 1 x, 2 wq, 3 wk, 4 wv; tiles [0, tiles)
// are q (from xn), then k, then v (from the pre-norm x), `tiles` = HD / BN.
struct QkvPlan {
  int tiles;
  __device__ TileSrc src(int nt) const {
    const int which = nt / tiles, r = (nt % tiles) * BN;
    return {which == 0 ? 0 : 1, 2 + which, r, 2 + which, r + 64};
  }
};

// The fp32 product of split-bf16 operands: maps 0 A_hi, 1 A_lo, 2 B_hi,
// 3 B_lo; passes A_hi B_hi, A_lo B_hi, A_hi B_lo (the lo . lo term, ~2^-16
// relative, is left out).
struct SplitPlan {
  static constexpr int PASSES = 3;
  __device__ TileSrc src(int nt, int pass) const {
    const int a = pass == 1 ? 1 : 0, b = pass == 2 ? 3 : 2;
    return {a, b, nt * BN, b, nt * BN + 64};
  }
};

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Error codes the entries return besides cudaError_t values.
constexpr int ERR_NO_ENCODER = 9001;     // cuTensorMapEncodeTiled not found
constexpr int ERR_MAP = 9002;            // cuTensorMapEncodeTiled refused a map (alignment, stride)

// The map of a row-major bf16 matrix [rows, cols] with row stride `ld`
// elements, read in boxes of box_rows x 64 with the 128-B swizzle; zeros
// outside the matrix. elem_bytes = 1 maps an int8 matrix (UINT8: TMA moves
// bytes as they are) in boxes of box_rows x 128, elem_bytes = 4 an fp32
// matrix in boxes of box_rows x 32. Returns 0 or an ERR_ code.
inline int make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int64_t ld,
                    int box_rows, int elem_bytes = 2) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  CUresult r = fn(map, elem_bytes == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                       : elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  2, const_cast<void*>(ptr), dims, strides, box, estrides,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_MAP;
}

// An A operand (boxes of BM rows) and a B operand (boxes of 64 rows).
inline int map_a(CUtensorMap* m, const void* p, int rows, int cols, int64_t ld) {
  return make_map(m, p, rows, cols, ld, BM);
}
inline int map_b(CUtensorMap* m, const void* p, int rows, int cols, int64_t ld) {
  return make_map(m, p, rows, cols, ld, 64);
}

// The same for int8 operands (a plan with S8), ld in bytes.
inline int map_a8(CUtensorMap* m, const void* p, int rows, int cols, int64_t ld) {
  return make_map(m, p, rows, cols, ld, BM, 1);
}
inline int map_b8(CUtensorMap* m, const void* p, int rows, int cols, int64_t ld) {
  return make_map(m, p, rows, cols, ld, 64, 1);
}

// An MN-major operand [rows, cols] with row stride ld (activations [tokens,
// cols] of a weight gradient, a weight [K, N]), read in boxes of 64 columns
// x 64 rows.
inline int map_mn(CUtensorMap* m, const void* p, int rows, int cols, int64_t ld) {
  return make_map(m, p, rows, cols, ld, 64);
}

// Launch gemm_kernel over n_tiles x ceil(M / BM) tiles; returns the launch's error.
template <class Plan, class Epi>
int launch_gemm(const Maps& maps, const Plan& plan, const Epi& epi, int n_tiles, int M, int K,
                cudaStream_t st) {
  auto kern = gemm_kernel<Plan, Epi>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  dim3 grid(n_tiles, (M + BM - 1) / BM);
  kern<<<grid, THREADS, SMEM, st>>>(maps, plan, epi, K);
  return (int)cudaGetLastError();
}

// ---- 64-row tiles, K split between the warpgroups ---------------------------

// A product whose N is narrow (768 columns at M = 1024 rows make 48 tiles of
// 128 x 128 for 132 SMs) takes tiles of 64 rows x 128 columns, twice as
// many: one producer warp feeds a ring of 64-row A slices (boxes of 64 rows:
// map_b's, or map_mn's for an MN-major B), consumer warpgroup w takes the K
// slices kt with kt % 2 == w into its own m64n128 accumulator; at the end
// each warp pair (warp q of both warpgroups, the same 16 rows) meets in
// shared memory, and one of the pair adds the other's sums (a + b: the same
// bits on every call) and runs the epilogue with gemm_kernel's interface,
// `epi(acc, row, nt, lane)`: rows 0-31 in warpgroup 0, 32-63 in 1.
constexpr int S64_STAGES = 8;
constexpr int A64_BYTES = 64 * BK * 2;
constexpr int STAGE64_BYTES = A64_BYTES + 2 * B_HALF_BYTES;
constexpr int RED64_BYTES = 128 * 64 * 4;          // four warps' accumulators
constexpr int SMEM64 = S64_STAGES * STAGE64_BYTES + RED64_BYTES + 1024;

template <class Plan, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm64_kernel(const __grid_constant__ Maps maps, const Plan plan, const Epi epi, int K) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[S64_STAGES], empty[S64_STAGES];
  char* ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  float* red = reinterpret_cast<float*>(ring + S64_STAGES * STAGE64_BYTES);
  const int nt = blockIdx.x, m0 = blockIdx.y * 64;
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S64_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (lane == 0) {
      const TileSrc src = plan_src(plan, nt, 0);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S64_STAGES, k0 = kt * BK;
        mbar_wait(&empty[s], ((kt / S64_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE64_BYTES);
        char* a = ring + s * STAGE64_BYTES;
        char* b = a + A64_BYTES;
        tma_load_2d(a, &maps.m[src.a], &full[s], k0, m0);
        if constexpr (BMajor<Plan>::mn) {
          tma_load_2d(b, &maps.m[src.b0], &full[s], src.row0, k0);
          tma_load_2d(b + B_HALF_BYTES, &maps.m[src.b1], &full[s], src.row1, k0);
        } else {
          tma_load_2d(b, &maps.m[src.b0], &full[s], k0, src.row0);
          tma_load_2d(b + B_HALF_BYTES, &maps.m[src.b1], &full[s], k0, src.row1);
        }
      }
    }
  } else {
    const int wg = warp >> 2;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = wg; kt < nk; kt += 2) {
      const int s = kt % S64_STAGES;
      mbar_wait(&full[s], (kt / S64_STAGES) & 1);
      const uint32_t a = smem_u32(ring + s * STAGE64_BYTES);
      const uint32_t b = a + A64_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (BMajor<Plan>::mn) {
          wgmma_m64n128k16_kn(acc, desc_sw128(a + kk * 32),
                              desc_mn_sw128(b + kk * 2048, B_HALF_BYTES));
        } else {
          wgmma_m64n128k16(acc, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    fence_regs(acc);
    // rows 16 q ... (q = warp % 4) finish in warpgroup 0 for q < 2 and in
    // warpgroup 1 for q >= 2: the other warp of the pair hands over its sums
    const int q = warp & 3, slot = q * 32 + lane;
    const bool finisher = (wg == 0) == (q < 2);
    if (!finisher) {
#pragma unroll
      for (int i = 0; i < 64; ++i) red[i * 128 + slot] = acc[i];
    }
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_WARPS * 32) : "memory");
    if (finisher) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += red[i * 128 + slot];
      epi(acc, m0 + q * 16, nt, lane);
    }
  }
}

// Launch gemm64_kernel over n_tiles x ceil(M / 64) tiles (A's map in boxes
// of 64 rows); returns the launch's error.
template <class Plan, class Epi>
int launch_gemm64(const Maps& maps, const Plan& plan, const Epi& epi, int n_tiles, int M, int K,
                  cudaStream_t st) {
  auto kern = gemm64_kernel<Plan, Epi>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM64);
  dim3 grid(n_tiles, (M + 63) / 64);
  kern<<<grid, THREADS, SMEM64, st>>>(maps, plan, epi, K);
  return (int)cudaGetLastError();
}

// ---- the LayerNorm pre-pass --------------------------------------------------

constexpr int LN_WARPS = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// xn = LN(x) * gamma (+ beta) rounded to bf16, one warp a row of x [M, D]
// (D a multiple of 8): one-pass moments E[x^2] - E[x]^2 in the lane order of
// gemm_tile.cuh's ln_row_stats and ln_apply8's arithmetic, the TPU kernels'
// LayerNorm. TMA copies tiles as they are, so the projections that read a
// normalised x take it from here.
template <int Dummy = 0>
__global__ void __launch_bounds__(LN_WARPS * 32)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, bf16* __restrict__ xn, int M, int D, float eps) {
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (int64_t)row * D;
  bf16* yr = xn + (int64_t)row * D;
  float s = 0.f, s2 = 0.f;
  for (int k = lane * 8; k < D; k += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float f = __bfloat162float(e[i]);
      s += f;
      s2 += f * f;
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / (float)D;
  const float rstd = rsqrtf(fmaxf(s2 / (float)D - mean * mean, 0.f) + eps);
  for (int k = lane * 8; k < D; k += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    uint4 out;
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float y = (__bfloat162float(e[i]) - mean) * rstd * gamma[k + i];
      if (beta != nullptr) y += beta[k + i];
      o[i] = __float2bfloat16(y);
    }
    *reinterpret_cast<uint4*>(yr + k) = out;
  }
}

inline int launch_ln_rows(const bf16* x, const float* gamma, const float* beta, bf16* xn, int M,
                          int D, cudaStream_t st) {
  ln_rows_kernel<><<<(M + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, st>>>(x, gamma, beta, xn, M,
                                                                         D, 1e-5f);
  return (int)cudaGetLastError();
}

// ---- epilogues shared by several kernels -------------------------------------

// out [M, N] bf16 = acc (+ x [M, N] in fp32), columns nt * 128 ...; pairs
// of columns go as one 4-B store where N is even.
struct ResidualEpi {
  bf16* out;
  const bf16* x;
  int M, N, residual;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + g + 8 * h;
      if (m < M) {
        const int64_t base = (int64_t)m * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = nt * BN + 8 * j + 2 * t;
          float y0 = acc[4 * j + 2 * h], y1 = acc[4 * j + 2 * h + 1];
          if (c + 1 < N && (N & 1) == 0) {
            if (residual) {
              __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + base + c);
              y0 += __low2float(xv);
              y1 += __high2float(xv);
            }
            *reinterpret_cast<__nv_bfloat162*>(out + base + c) = __floats2bfloat162_rn(y0, y1);
          } else if (c < N) {
            if (residual) y0 += __bfloat162float(x[base + c]);
            out[base + c] = __float2bfloat16(y0);
          }
        }
      }
    }
  }
};

// c [M, N] fp32 = acc, columns nt * 128 ...; pairs of columns go as one 8-B
// store where N is even.
struct StoreF32Epi {
  float* c;
  int M, N;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + g + 8 * h;
      if (m < M) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = nt * BN + 8 * j + 2 * t;
          if (col + 1 < N && (N & 1) == 0) {
            *reinterpret_cast<float2*>(c + (int64_t)m * N + col) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (col + e < N) c[(int64_t)m * N + col + e] = acc[4 * j + 2 * h + e];
          }
        }
      }
    }
  }
};

}  // namespace sm90
}  // namespace ctc
