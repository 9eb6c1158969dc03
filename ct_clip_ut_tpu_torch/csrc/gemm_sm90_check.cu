// The bare Hopper GEMM cores (gemm_sm90.cuh, wgrad_sm90.cuh) behind C
// entries of their own, for the card tests, with no prologue or epilogue of
// a kernel around them, so a fault of a core (descriptors, swizzle, the
// ring's phases, ragged edges, the split plan's passes) shows on its own.
#include "wgrad_sm90.cuh"

using namespace ctc::sm90;

// C = A . B^T in fp32: a [M, K] with row stride lda, b [N, K] with row
// stride ldb (bf16; strides multiples of 8, pointers 16-B aligned); c [M, N]
// fp32. mode: 0 gemm_kernel with LinearPlan; 1 SplitPlan's three passes
// over hi / lo planes [2][rows][ld] of a and b; 2 gemm64_kernel (64-row
// tiles, K split between the warpgroups); 3, 4 gemm_kernel and
// gemm64_kernel with b [K, N] read as it is stored (LinearKNPlan: C = A .
// B).
extern "C" int ctc_gemm_sm90_check(const void* a, const void* b, void* c, int M, int N, int K,
                                   int lda, int ldb, int mode, void* stream) {
  Maps maps{};
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* bb = static_cast<const bf16*>(b);
  const bool split = mode == 1, kn = mode >= 3, rows64 = mode == 2 || mode == 4;
  const int bi = split ? 2 : 1;       // LinearPlan reads B from map 1, SplitPlan from 2 and 3
  int err = rows64 ? map_b(&maps.m[0], ab, M, K, lda) : map_a(&maps.m[0], ab, M, K, lda);
  if (!err) err = kn ? map_mn(&maps.m[bi], bb, K, N, ldb) : map_b(&maps.m[bi], bb, N, K, ldb);
  if (!err && split) err = map_a(&maps.m[1], ab + (int64_t)M * lda, M, K, lda);
  if (!err && split) err = map_b(&maps.m[3], bb + (int64_t)N * ldb, N, K, ldb);
  if (err) return err;
  const StoreF32Epi epi{static_cast<float*>(c), M, N};
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int nt = (N + BN - 1) / BN;
  switch (mode) {
    case 0: return launch_gemm(maps, LinearPlan{}, epi, nt, M, K, st);
    case 1: return launch_gemm(maps, SplitPlan{}, epi, nt, M, K, st);
    case 2: return launch_gemm64(maps, LinearPlan{}, epi, nt, M, K, st);
    case 3: return launch_gemm(maps, LinearKNPlan{}, epi, nt, M, K, st);
    case 4: return launch_gemm64(maps, LinearKNPlan{}, epi, nt, M, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// C = A^T B in fp32 over `tokens` rows on the MN-major core: a [tokens,
// rows] with row stride lda, b [tokens, cols] with row stride ldb (bf16;
// strides multiples of 8, pointers 16-B aligned); c [rows, cols] fp32.
extern "C" int ctc_wgrad_sm90_check(const void* a, const void* b, void* c, int tokens, int rows,
                                    int cols, int lda, int ldb, void* stream) {
  Maps maps{};
  int err = map_mn(&maps.m[0], a, tokens, rows, lda);
  if (!err) err = map_mn(&maps.m[1], b, tokens, cols, ldb);
  if (err) return err;
  float* cf = static_cast<float*>(c);
  const int col_tiles = (cols + BN - 1) / BN;
  return launch_wgrad_sm90(maps, WgradPlan{rows, col_tiles},
                           WgradStoreEpi{{cf, cf}, {cols, cols}, {cols, cols}},
                           ((rows + BM - 1) / BM) * col_tiles, tokens,
                           reinterpret_cast<cudaStream_t>(stream));
}
