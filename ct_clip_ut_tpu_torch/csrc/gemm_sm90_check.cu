// The bare Hopper GEMM core (gemm_sm90.cuh) behind a C entry of its own, for
// the card tests: C = A . B^T in fp32, with no prologue or epilogue of a
// kernel around it, so a fault of the core (descriptors, swizzle, the
// ring's phases, ragged edges) shows on its own.
#include "gemm_sm90.cuh"

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
                     StoreF32Epi{static_cast<float*>(c), M, N},
                     (N + BN - 1) / BN, M, K, reinterpret_cast<cudaStream_t>(stream));
}
