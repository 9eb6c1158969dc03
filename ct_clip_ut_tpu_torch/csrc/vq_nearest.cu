// Cosine-codebook nearest neighbour: the port of
// ct_clip_ut_tpu/ops/pallas_vq.py:vq_nearest_pallas (_kernel).
//
// idx[i] = argmax_j <tok_i, cb_j>, fp32 accumulation, the FIRST maximum
// wins; only the int32 indices are written.
//
// What bounds it on the H100: tensor-core FLOPs, 2 * M * C * D (116 GFLOP
// per volume at M = 13824 tokens, C = 8192 codes, D = 512); the [M, C]
// similarity matrix (453 MB fp32 per volume) is never written.
//
// The design: the product runs on the Hopper core of gemm_sm90.cuh (TMA
// ring, wgmma, two blocks an SM) over its usual grid of 128-code x 128-token
// tiles, code tiles fastest, so the 8 MB codebook stays in L2 while the
// blocks of one token tile pass over it. The epilogue reduces the tile
// from the registers that hold it, with no C tile in shared memory:
//   - each thread walks its 32 columns of each of its two rows in
//     increasing order from -inf, keeping (max, column) on a strict >;
//   - two quad shuffles combine the four threads of a row, the lower column
//     winning equal maxima;
//   - one 64-bit atomicMax a (row, tile) into a [M] workspace, the key
//     (orderable(sim) << 32) | (0xFFFFFFFF - column): the largest sim wins,
//     then the lowest column, which is the first maximum whatever order the
//     atomics land in, so the result is deterministic. -0.0 is taken as
//     +0.0 first (torch.argmax counts them equal).
// NaN follows torch.argmax too: it ranks above every number (key 0xFFFFFFFF
// above the inverted column), so a row with a NaN sim, a diverged one,
// gets its first NaN; a row of -inf gets index 0.
// A second launch turns the keys into int32 indices.
//
// The fp32 variant (ctc_vq_nearest_f32: the TPU kernel on fp32 tokens and
// codes) splits both into hi / lo bf16 planes (split_sm90.cuh) and runs the
// product as SplitPlan's three bf16 passes into the same ArgmaxEpi, sims
// within ~2^-16 of fp32; the planes cost 4 B an element of each operand,
// written once a call. Its bound: three times the bf16 operations.
#include <math_constants.h>

#include "split_sm90.cuh"

namespace ctc {
namespace vq {

using namespace sm90;

typedef unsigned long long u64;

// torch.argmax's order, strict: a above b when a > b, or when a is NaN and
// b is not. !(a <= b) is one unordered compare: a > b, or either NaN.
__device__ __forceinline__ bool above(float a, float b) { return b == b && !(a <= b); }

// Order-preserving map of a float to 32 unsigned bits (every NaN to the
// top), packed above the inverted column.
__device__ __forceinline__ u64 argmax_key(float sim, int col) {
  uint32_t u = __float_as_uint(sim == 0.f ? 0.f : sim);
  u = sim != sim ? 0xFFFFFFFFu : (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (u64)(0xFFFFFFFFu - (uint32_t)col);
}

struct ArgmaxEpi {
  u64* best;   // [M], zeroed before the launch
  int M, C;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float bv = -CUDART_INF_F;
      int bc = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * BN + 8 * j + 2 * t + e;   // increasing in (j, e)
          const float v = acc[4 * j + 2 * h + e];
          if (c < C && above(v, bv)) {
            bv = v;
            bc = c;
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
        if (above(ov, bv) || (!above(bv, ov) && oc < bc)) {
          bv = ov;
          bc = oc;
        }
      }
      const int m = row + g + 8 * h;
      if (t == 0 && m < M && bc != 0x7fffffff) atomicMax(best + m, argmax_key(bv, bc));
    }
  }
};

// A row whose every sim is -inf kept no column (nothing lies above the
// scan's -inf start): its key is still the zero of the memset, and its
// index 0, torch.argmax's first maximum.
__global__ void finish_kernel(const u64* __restrict__ best, int* __restrict__ idx, int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < M) idx[i] = best[i] ? (int)(0xFFFFFFFFu - (uint32_t)(best[i] & 0xFFFFFFFFull)) : 0;
}

}  // namespace vq
}  // namespace ctc

using namespace ctc::sm90;

// tok [M, D] bf16 with row stride ldt, cb [C, D] bf16 with row stride ldc
// (strides multiples of 8, pointers 16-B aligned: the wrapper's TMA plan);
// best [M] u64 workspace; idx [M] int32.
extern "C" int ctc_vq_nearest(const void* tok, const void* cb, void* best, void* idx, int M,
                              int C, int D, int ldt, int ldc, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (M == 0) return 0;
  Maps maps{};
  int err = map_a(&maps.m[0], tok, M, D, ldt);
  if (!err) err = map_b(&maps.m[1], cb, C, D, ldc);
  if (err) return err;
  auto* keys = static_cast<ctc::vq::u64*>(best);
  err = (int)cudaMemsetAsync(keys, 0, (size_t)M * sizeof(ctc::vq::u64), st);
  if (err) return err;
  err = launch_gemm(maps, LinearPlan{}, ctc::vq::ArgmaxEpi{keys, M, C}, (C + BN - 1) / BN, M, D,
                    st);
  if (err) return err;
  ctc::vq::finish_kernel<<<(M + 255) / 256, 256, 0, st>>>(keys, static_cast<int*>(idx), M);
  return (int)cudaGetLastError();
}

// The fp32 variant: tok [M, D] and cb [C, D] fp32 (D a multiple of 8,
// pointers 16-B aligned); workspaces tok_s [2][M][D] and cb_s [2][C][D]
// bf16, best [M] u64; idx [M] int32. flags 1: lo planes zeroed (one bf16
// product, the control).
extern "C" int ctc_vq_nearest_f32(const void* tok, const void* cb, void* tok_s, void* cb_s,
                                  void* best, void* idx, int M, int C, int D, int flags,
                                  void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (M == 0) return 0;
  const int keep = !(flags & 1);
  const int64_t md = (int64_t)M * D, cd = (int64_t)C * D;
  bf16 *ts = static_cast<bf16*>(tok_s), *cs = static_cast<bf16*>(cb_s);
  auto* keys = static_cast<ctc::vq::u64*>(best);
  int err = split(tok, ts, md, keep, st);
  if (!err) err = split(cb, cs, cd, keep, st);
  if (!err) err = (int)cudaMemsetAsync(keys, 0, (size_t)M * sizeof(ctc::vq::u64), st);
  if (!err)
    err = split_product(ts, ts + md, D, cs, cs + cd, D, M, C, D, ctc::vq::ArgmaxEpi{keys, M, C},
                        st);
  if (err) return err;
  ctc::vq::finish_kernel<<<(M + 255) / 256, 256, 0, st>>>(keys, static_cast<int*>(idx), M);
  return (int)cudaGetLastError();
}
