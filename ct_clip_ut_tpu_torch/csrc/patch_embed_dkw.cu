// CT-ViT patch embed, projection weight gradient: the port of
// ct_clip_ut_tpu/ops/pallas_patch_embed.py:_dkw_impl (_dkw_kernel).
//
// dkw[k, n] = sum over patches m of P[m, k] * dconv[m, n]: P [M, K] are the
// raw patches of a [B, 1, T, H, W] bf16 volume (M = 27,648 patches of K =
// 4,000 pixels at two flagship volumes, column k = (tv, p1, wv)) and dconv
// [M, dim] bf16 the cotangent of the fp32 product. The caller reshapes
// [K, dim] to the kernel-weight layout [wv, cin, dim].
//
// What bounds it on the H100: tensor-core FLOPs, 2 * M * K * dim (113 GFLOP
// at B = 2, 0.11 ms at the bf16 peak); the volume (221 MB) is the only large
// read. The TPU kernel rearranges each frame in VMEM and accumulates over a
// sequential grid; here the transposed product (block_gemm_tn) gathers the
// patch pixels straight from the volume, as the forward's implicit GEMM does
// (two aligned 4-pixel runs per 8-pixel chunk), and the reduction over the
// 27,648 rows is split into chunks whose [128 x 128] fp32 tiles are added
// into the zeroed output with fp32 atomicAdd (bwd_common.cuh's
// wgrad_kernel): one launch.
#include "bwd_common.cuh"
#include "patch_common.cuh"

namespace ctc {

// Row m of P: 8 pixels of patch m from column k.
struct PatchRows {
  const bf16* image;
  PatchGeom g;
  int M, K, vec4;
  __device__ __forceinline__ uint4 load8(int m, int k) const {
    if (m >= M) return make_uint4(0u, 0u, 0u, 0u);
    return patch_load8(image + g.base(m), g, k, K, vec4);
  }
};

}  // namespace ctc

using namespace ctc;

// image [B, 1, T, H, W] bf16; dconv [M, dim] bf16; out [K, dim] fp32, zeroed
// by the caller.
extern "C" int ctc_patch_embed_dkw(const void* image, const void* dconv, void* out, int B, int T,
                                   int H, int W, int patch, int t_patch, int dim, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const PatchGeom g{T, H, W, patch, t_patch};
  const int M = B * (T / t_patch) * (H / patch) * (W / patch);
  const int K = t_patch * patch * patch;
  const int vec4 = patch % 4 == 0 && W % 4 == 0 && (reinterpret_cast<uintptr_t>(image) & 7u) == 0;
  launch_wgrad(PatchRows{(const bf16*)image, g, M, K, vec4},
               RowMajor{(const bf16*)dconv, dim, M, dim}, (float*)out, dim, K, dim, M, st);
  return (int)cudaGetLastError();
}
