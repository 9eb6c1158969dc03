// The patch geometry of the CT-ViT patch embed and its patchify pass, shared
// by its forward (patch_embed.cu) and its weight gradient
// (patch_embed_dkw.cu): patch m, ordered (b, t, hp, wp), of a [B, 1, T, H, W]
// volume holds K = t_patch * patch^2 pixels, column k = (tv, p1, wv) with wv
// fastest, the order of the pixels along W. Both run their products on the
// Hopper core over the patch matrix P [M, K] that patchify_kernel writes
// (TMA cannot fetch a 40-B patch run: a box's inner extent is a multiple of
// 16 B).
#pragma once

#include "gemm_sm90.cuh"

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
  __host__ __device__ __forceinline__ int K() const { return t_patch * patch * patch; }
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
__device__ __forceinline__ uint4 patch_load8(const __nv_bfloat16* p, const PatchGeom& g, int k,
                                             int K, int vec4) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (k >= K) return v;
  if (vec4) {
    uint2* half = reinterpret_cast<uint2*>(&v);
    half[0] = *reinterpret_cast<const uint2*>(p + g.pixel(k));
    if (k + 4 < K) half[1] = *reinterpret_cast<const uint2*>(p + g.pixel(k + 4));
    return v;
  }
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (k + i < K) e[i] = p[g.pixel(k + i)];
  }
  return v;
}

namespace pe {

constexpr float EPS = 1e-5f;
constexpr int ROW_WARPS = 8;        // rows (patches) a block of the row passes

// One warp a patch: 8-pixel chunks gathered from the volume, stored as one
// 16-B store each into P's row (zeros past K: ldp >= K rounded to 8), and,
// where stats is not null, the LN1 mean and rstd summed on the way
// (one-pass E[x^2] - E[x]^2 in fp32, the `_xla_twin` form): the volume is
// read once. (A template, so that both sources may include it.)
template <int Dummy = 0>
__global__ void __launch_bounds__(ROW_WARPS * 32)
patchify_kernel(const sm90::bf16* __restrict__ image, sm90::bf16* __restrict__ patches,
                float2* __restrict__ stats, int M, int ldp, PatchGeom g, int vec4) {
  const int m = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (m >= M) return;
  const int K = g.K();
  const sm90::bf16* src = image + g.base(m);
  sm90::bf16* dst = patches + (int64_t)m * ldp;
  float s = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 v = patch_load8(src, g, k, K, vec4);
    *reinterpret_cast<uint4*>(dst + k) = v;
    const sm90::bf16* e = reinterpret_cast<const sm90::bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = __bfloat162float(e[i]);
      s += f;
      s2 += f * f;
    }
  }
  if (stats == nullptr) return;
  s = sm90::warp_sum(s);
  s2 = sm90::warp_sum(s2);
  if (lane == 0) {
    const float mean = s / (float)K;
    const float var = fmaxf(s2 / (float)K - mean * mean, 0.f);
    stats[m] = make_float2(mean, rsqrtf(var + EPS));
  }
}

// P [M, ldp] (and each patch's LN1 moments where stats is not null) of the
// volume image [B, 1, T, H, W] bf16; returns the launch's error.
inline int launch_patchify(const void* image, void* patches, void* stats, int M, int ldp,
                           const PatchGeom& g, cudaStream_t st) {
  const int vec4 =
      g.patch % 4 == 0 && g.W % 4 == 0 && (reinterpret_cast<uintptr_t>(image) & 7u) == 0;
  patchify_kernel<><<<(M + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, st>>>(
      static_cast<const sm90::bf16*>(image), static_cast<sm90::bf16*>(patches),
      static_cast<float2*>(stats), M, ldp, g, vec4);
  return (int)cudaGetLastError();
}

}  // namespace pe
}  // namespace ctc
