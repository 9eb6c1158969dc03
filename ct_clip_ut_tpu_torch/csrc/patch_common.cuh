// The patch geometry of the CT-ViT patch embed, shared by its forward
// (patch_embed.cu) and its weight gradient (patch_embed_dkw.cu): patch m,
// ordered (b, t, hp, wp), of a [B, 1, T, H, W] volume holds K = t_patch *
// patch^2 pixels, column k = (tv, p1, wv) with wv fastest, the order of the
// pixels along W.
#pragma once

#include "gemm_tile.cuh"

namespace ctc {

struct PatchGeom {
  int T, H, W, patch, t_patch;
  // element offset of patch m's first pixel in the volume, m ordered (b, t, hp, wp)
  __device__ __forceinline__ int64_t base(int m) const {
    const int wp = W / patch, hp = H / patch, tt = T / t_patch;
    int wi = m % wp, r = m / wp;
    int hi = r % hp;
    r /= hp;
    int ti = r % tt, b = r / tt;
    return ((int64_t)(b * T + ti * t_patch) * H + hi * patch) * W + wi * patch;
  }
  // offset of pixel k = (tv, p1, wv) within a patch
  __device__ __forceinline__ int64_t pixel(int k) const {
    int wv = k % patch, r = k / patch;
    return ((int64_t)(r / patch) * H + r % patch) * W + wv;
  }
};

// 8 pixels [k, k + 8) of the patch whose first pixel is at `p`, zero past
// K. With vec4 (k % 8 == 0, a patch width and W that 4 divides, an 8-B
// aligned volume) they are two aligned runs of 4 along W: a run of 20 bf16
// is only 8-B aligned, so no 16-B load is legal there.
__device__ __forceinline__ uint4 patch_load8(const bf16* p, const PatchGeom& g, int k, int K,
                                             int vec4) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (k >= K) return v;
  if (vec4) {
    uint2* half = reinterpret_cast<uint2*>(&v);
    half[0] = *reinterpret_cast<const uint2*>(p + g.pixel(k));
    if (k + 4 < K) half[1] = *reinterpret_cast<const uint2*>(p + g.pixel(k + 4));
    return v;
  }
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (k + i < K) e[i] = p[g.pixel(k + i)];
  }
  return v;
}

}  // namespace ctc
