// The bare Hopper GEMM core (gemm_sm90.cuh) behind a C entry of its own, for
// the card tests: C = A . B^T in fp32, with no prologue or epilogue of a
// kernel around it, so a fault of the core (descriptors, swizzle, the
// ring's phases, ragged edges) shows on its own.
#include "gemm_sm90.cuh"

namespace ctc {
namespace gemm_check {

using namespace sm90;

// c [M, N] fp32, columns nt * 128 ...
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
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nt * BN + 8 * j + 2 * t + e;
            if (col < N) c[(int64_t)m * N + col] = acc[4 * j + 2 * h + e];
          }
        }
      }
    }
  }
};

}  // namespace gemm_check
}  // namespace ctc

using namespace ctc::sm90;

// a [M, K] with row stride lda, b [N, K] with row stride ldb (bf16; strides
// multiples of 8, pointers 16-B aligned); c [M, N] fp32.
extern "C" int ctc_gemm_sm90_check(const void* a, const void* b, void* c, int M, int N, int K,
                                   int lda, int ldb, void* stream) {
  Maps maps{};
  int err = map_a(&maps.m[0], a, M, K, lda);
  if (!err) err = map_b(&maps.m[1], b, N, K, ldb);
  if (err) return err;
  return launch_gemm(maps, LinearPlan{},
                     ctc::gemm_check::StoreF32Epi{static_cast<float*>(c), M, N},
                     (N + BN - 1) / BN, M, K, reinterpret_cast<cudaStream_t>(stream));
}
