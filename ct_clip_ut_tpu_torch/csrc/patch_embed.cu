// CT-ViT patch embed (LN-folded conv form): the port of
// ct_clip_ut_tpu/ops/pallas_patch_embed.py:patch_embed_fused
// (_forward_impl / _kernel, and _forward_res_impl for the residual-saving
// variant).
//
// out = LN2(bf16((P @ Kw^T - mean * s1) * rsqrt(var + eps) + b1)) * g2 + b2
// where P [M, K] are the raw patches of a [B, 1, T, H, W] bf16 volume
// (M = B * T/tp * H/p * W/p patches of K = tp * p * p pixels: 27,648 x
// 4,000 at two flagship volumes; CTGenerate's 512 and 256), Kw [dim, K] is
// the LN1-gamma-folded projection cast once to bf16, and mean / var are each
// patch's LN1 moments in fp32.
//
// What bounds it on the H100: tensor-core FLOPs, 2 * M * K * dim (113
// GFLOP at B = 2, 0.11 ms at the bf16 peak); the volume (221 MB at B = 2)
// is the only large read. TMA cannot fetch a patch row (a 20-pixel run is
// 40 B, and a box's inner extent must be a multiple of 16 B), so one pass
// writes the patches out as a matrix the Hopper GEMM core reads through
// TMA. Three launches:
//   patchify_kernel  (patch_common.cuh) one warp a patch: 8-pixel chunks
//                    (two aligned 4-pixel runs along W) gathered from the
//                    volume, stored as one 16-B store each into P's row
//                    (column (tv, p1, wv)), and the LN1 mean and rstd
//                    summed on the way (one-pass E[x^2] - E[x]^2 in fp32,
//                    the `_xla_twin` form): the volume is read once;
//   gemm_kernel      P . Kw^T on gemm_sm90.cuh (LinearPlan: TMA ring,
//                    wgmma, the 128-B swizzle; K = 4,000 leaves a ragged
//                    last slice that TMA zero-fills). The 128-wide column
//                    tiles of a row block sit next to each other in the
//                    grid, so P's rows come from L2 after their first read.
//                    PatchEpi applies the folded LN1 and b1 and rounds h to
//                    bf16 into `out` (the TPU kernel's rounding point
//                    before LN2); with `conv` it also stores the fp32
//                    product (the residual-saving variant);
//   pe_ln_kernel     LN2 over each row of `out`, in place, one warp a row,
//                    with the two-pass variance of the `_xla_twin`.
// P is a workspace of M x ldp bf16 (221 MB at B = 2), written and read once.
// A GEMM that gathers its A tiles from the volume itself (8-B cp.async
// copies of 4-pixel runs into the swizzled tile, no P) measured slower on
// the H100: each 128-wide column tile gathers its rows again, in 8-B pieces
// that fetch whole 32-B sectors, where TMA streams P in dense lines.
//
// The fp32 variant (ctc_patch_embed_f32: the TPU kernel on an fp32 volume,
// CTGenerate's one-scan route, where every rounding point is an identity)
// runs the same three steps with the product as three bf16 products of hi
// / lo planes (split_sm90.cuh), within ~2^-16 of fp32:
//   patchify_f32_kernel  the volume read once, P written as hi / lo bf16
//                        planes [2][M][ldp] and each patch's LN1 moments
//                        summed in fp32 from the fp32 pixels;
//   split4_planes        P . Kw^T over P's planes and the folded weight's
//                        (split per call from the fp32 [dim, ldk] fold),
//                        each K slice's four planes staged once and its
//                        three bf16 products issued from that stage (the
//                        ragged last slice zero-filled by TMA), on the
//                        tiling the product's size picks;
//                        PatchF32Epi applies the folded LN1 and b1 in fp32
//                        and writes h fp32 into `out`;
//   pe_ln_f32_kernel     LN2 over each fp32 row of `out`, in place, with
//                        the two-pass variance.
// Its bound at CTGenerate's shapes (K = 256 for the first frame, 512 for
// the other 200 frames, 6,464 patches of dim 512): 10 GFLOP as three bf16
// products (0.010 ms at the bf16 peak) against 26 MB of volume and output
// (0.008 ms). The first frame's 64 patches are 4 tiles of 64 rows
// (split4_64_kernel), the other frames' 6,400 are 200 tiles of 128 rows
// on 32-deep slices at two blocks an SM (split4_32_kernel).
//
// The fp32 residual-saving variant (ctc_patch_embed_res_f32: the port of
// _forward_res_impl on an fp32 volume, the fp32 train step's patch embed)
// is the same chain with PatchF32Epi also storing the fp32 product conv
// [M, dim]; with the LN1 moments these are what the LayerNorm chain's
// backward rebuilds from, and the wrapper keeps P's planes (442 MB at B =
// 2) for the weight gradient (patch_embed_dkw.cu's fp32 entry), as the
// bf16 train step keeps P. At B = 2 (27,648 patches of 4,000 pixels into
// 512) it is 340 GFLOP as bf16 products, 0.34 ms at the bf16 peak, against
// 442 MB of volume and 113 MB of out and conv (0.17 ms): operations bound.
// Its 864 tiles take split4_kernel: persistent, one block an SM, the
// warpgroups owning whole tiles in turn (one's epilogue, which writes h and
// conv, runs under the other's products), 62.5 K slices of 64 a tile.
// ctc_patchify_f32 is its patchify pass alone (P's planes of a volume, for
// a weight gradient called from the volume).
#include "gemm_sm90.cuh"
#include "patch_common.cuh"
#include "split_sm90.cuh"

namespace ctc {
namespace pe {

using namespace sm90;

// h [M, N] bf16 = (acc - mean * s1) * rstd + b1, and conv [M, N] fp32 =
// acc where conv is not null; columns nt * 128 ...; pairs of columns go as
// one store where N is even.
struct PatchEpi {
  bf16* h;
  float* conv;
  const float2* stats;
  const float* s1;
  const float* b1;
  int M, N;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = row + g + 8 * hf;
      if (m < M) {
        const float2 st = stats[m];
        const int64_t base = (int64_t)m * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = nt * BN + 8 * j + 2 * t;
          const float a0 = acc[4 * j + 2 * hf], a1 = acc[4 * j + 2 * hf + 1];
          if (c + 1 < N && (N & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(h + base + c) =
                __floats2bfloat162_rn((a0 - st.x * s1[c]) * st.y + b1[c],
                                      (a1 - st.x * s1[c + 1]) * st.y + b1[c + 1]);
            if (conv != nullptr)
              *reinterpret_cast<float2*>(conv + base + c) = make_float2(a0, a1);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (c + e < N) {
                const float a = e ? a1 : a0;
                h[base + c + e] = __float2bfloat16((a - st.x * s1[c + e]) * st.y + b1[c + e]);
                if (conv != nullptr) conv[base + c + e] = a;
              }
            }
          }
        }
      }
    }
  }
};

// LN2 in place over each row of h [M, dim], one warp a row, with the
// two-pass variance.
__global__ void __launch_bounds__(ROW_WARPS * 32)
pe_ln_kernel(bf16* __restrict__ h, const float* __restrict__ g2, const float* __restrict__ b2,
             int M, int dim) {
  const int m = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (m >= M) return;
  bf16* row = h + (int64_t)m * dim;
  float s = 0.f;
  for (int c = lane; c < dim; c += 32) s += __bfloat162float(row[c]);
  const float mean = warp_sum(s) / (float)dim;
  float s2 = 0.f;
  for (int c = lane; c < dim; c += 32) {
    float d = __bfloat162float(row[c]) - mean;
    s2 += d * d;
  }
  const float rstd = rsqrtf(warp_sum(s2) / (float)dim + EPS);
  for (int c = lane; c < dim; c += 32) {
    float v = (__bfloat162float(row[c]) - mean) * rstd * g2[c] + b2[c];
    row[c] = __float2bfloat16(v);
  }
}

// ---- the fp32 variant -----------------------------------------------------------

// One warp a patch of an fp32 volume: 8-pixel chunks (two 16-B loads of 4
// pixels along W where vec4: a patch width and W that 4 divides, a 16-B
// aligned volume) stored as one 16-B store each into P's hi and lo planes
// (zeros past K, lo zeros without keep_lo), the LN1 moments summed on the
// way from the fp32 pixels in the one-pass form.
__global__ void __launch_bounds__(ROW_WARPS * 32)
patchify_f32_kernel(const float* __restrict__ image, bf16* __restrict__ p_hi,
                    bf16* __restrict__ p_lo, float2* __restrict__ stats, int M, int ldp,
                    PatchGeom g, int vec4, int keep_lo) {
  const int m = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (m >= M) return;
  const int K = g.K();
  const float* src = image + g.base(m);
  const int64_t row = (int64_t)m * ldp;
  float s = 0.f, s2 = 0.f;
  for (int k = lane * 8; k < ldp; k += 256) {
    float v[8];
    if (vec4 && k + 8 <= K) {
      const float4 a = *reinterpret_cast<const float4*>(src + g.pixel(k));
      const float4 b = *reinterpret_cast<const float4*>(src + g.pixel(k + 4));
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
      v[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = k + i < K ? src[g.pixel(k + i)] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += v[i];
      s2 += v[i] * v[i];
    }
    store_split4(make_float4(v[0], v[1], v[2], v[3]), keep_lo, p_hi, p_lo, row + k);
    store_split4(make_float4(v[4], v[5], v[6], v[7]), keep_lo, p_hi, p_lo, row + k + 4);
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0 && stats != nullptr) {
    const float mean = s / (float)K;
    const float var = fmaxf(s2 / (float)K - mean * mean, 0.f);
    stats[m] = make_float2(mean, rsqrtf(var + EPS));
  }
}

// h [M, N] fp32 = (acc - mean * s1) * rstd + b1, and conv [M, N] fp32 = acc
// where conv is not null (N even)
struct PatchF32Epi {
  float* h;
  const float2* stats;
  const float* s1;
  const float* b1;
  int M, N;
  float* conv;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = row + g + 8 * hf;
      if (m >= M) continue;
      const float2 st = stats[m];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = nt * BN + 8 * j + 2 * t;
        if (c >= N) continue;
        const float a0 = acc[4 * j + 2 * hf], a1 = acc[4 * j + 2 * hf + 1];
        *reinterpret_cast<float2*>(h + (int64_t)m * N + c) = make_float2(
            (a0 - st.x * s1[c]) * st.y + b1[c], (a1 - st.x * s1[c + 1]) * st.y + b1[c + 1]);
        if (conv != nullptr)
          *reinterpret_cast<float2*>(conv + (int64_t)m * N + c) = make_float2(a0, a1);
      }
    }
  }
};

// LN2 in place over each fp32 row of h [M, dim] (dim a multiple of 4), one
// warp a row, with the two-pass variance.
__global__ void __launch_bounds__(ROW_WARPS * 32)
pe_ln_f32_kernel(float* __restrict__ h, const float* __restrict__ g2,
                 const float* __restrict__ b2, int M, int dim) {
  const int m = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (m >= M) return;
  float* row = h + (int64_t)m * dim;
  float s = 0.f;
  for (int c = 4 * lane; c < dim; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = warp_sum(s) / (float)dim;
  float s2 = 0.f;
  for (int c = 4 * lane; c < dim; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    const float a = v.x - mean, b = v.y - mean, d = v.z - mean, e = v.w - mean;
    s2 += (a * a + b * b) + (d * d + e * e);
  }
  const float rstd = rsqrtf(warp_sum(s2) / (float)dim + EPS);
  for (int c = 4 * lane; c < dim; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    const float4 gm = *reinterpret_cast<const float4*>(g2 + c);
    const float4 bt = *reinterpret_cast<const float4*>(b2 + c);
    *reinterpret_cast<float4*>(row + c) =
        make_float4((v.x - mean) * rstd * gm.x + bt.x, (v.y - mean) * rstd * gm.y + bt.y,
                    (v.z - mean) * rstd * gm.z + bt.z, (v.w - mean) * rstd * gm.w + bt.w);
  }
}

// image [B, 1, T, H, W] fp32; kwd [dim, ldk] fp32, the folded weight with
// column (tv, p1, wv) and zeros past K; s1/b1/g2/b2 [dim] fp32; workspaces
// patches [2][M][ldp] and kw_s [2][dim][ldk] bf16 (hi, then lo), stats [M]
// float2; out [M, dim] fp32; conv [M, dim] fp32 (the product before the
// folded LN1) or null. ldp == ldk, a multiple of 8 at least K; dim a
// multiple of 4; every pointer 16-B aligned. keep_lo 0 zeroes every lo
// plane (the one-pass control).
inline int launch_f32(const float* image, const float* kwd, const float* s1, const float* b1,
                      const float* g2, const float* b2, bf16* patches, bf16* kw_s, void* stats,
                      float* out, float* conv, int B, int T, int H, int W, int patch,
                      int t_patch, int dim, int ldp, int keep_lo, cudaStream_t st) {
  const PatchGeom g{T, H, W, patch, t_patch};
  const int M = B * (T / t_patch) * (H / patch) * (W / patch), K = g.K();
  const int64_t pm = (int64_t)M * ldp, pw = (int64_t)dim * ldp;
  if (M == 0) return 0;
  int err = split(kwd, kw_s, pw, keep_lo, st);
  if (err) return err;
  const int vec4 =
      patch % 4 == 0 && W % 4 == 0 && (reinterpret_cast<uintptr_t>(image) & 15u) == 0;
  patchify_f32_kernel<<<(M + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, st>>>(
      image, patches, patches + pm, static_cast<float2*>(stats), M, ldp, g, vec4, keep_lo);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = split4_planes(patches, kw_s, ldp, M, dim, K,
                      PatchF32Epi{out, static_cast<const float2*>(stats), s1, b1, M, dim, conv},
                      st);
  if (err) return err;
  pe_ln_f32_kernel<<<(M + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, st>>>(out, g2, b2, M,
                                                                              dim);
  return (int)cudaGetLastError();
}

// image [B, 1, T, H, W] bf16 (T, H, W multiples of t_patch, patch, patch);
// kwd [dim, K] bf16 with row stride ldk, column (tv, p1, wv); s1/b1/g2/b2
// [dim] fp32; patches [M, ldp] bf16 workspace; stats [M] float2 (each
// patch's LN1 mean and rstd); out [M, dim] bf16 with M = B * T/t_patch *
// H/patch * W/patch; conv [M, dim] fp32 (the product before the folded LN1)
// or null. ldp and ldk multiples of 8 at least K; patches, kwd 16-B
// aligned.
inline int launch(const void* image, const void* kwd, const void* s1, const void* b1,
                  const void* g2, const void* b2, void* patches, void* stats, void* out,
                  void* conv, int B, int T, int H, int W, int patch, int t_patch, int dim,
                  int ldp, int ldk, cudaStream_t st) {
  const PatchGeom g{T, H, W, patch, t_patch};
  const int M = B * (T / t_patch) * (H / patch) * (W / patch), K = g.K();
  Maps maps{};
  int err = map_a(&maps.m[0], patches, M, K, ldp);
  if (!err) err = map_b(&maps.m[1], kwd, dim, K, ldk);
  if (!err) err = launch_patchify(image, patches, stats, M, ldp, g, st);
  if (err) return err;
  err = launch_gemm(maps, LinearPlan{},
                    PatchEpi{static_cast<bf16*>(out), static_cast<float*>(conv),
                             static_cast<const float2*>(stats), static_cast<const float*>(s1),
                             static_cast<const float*>(b1), M, dim},
                    (dim + BN - 1) / BN, M, K, st);
  if (err) return err;
  pe_ln_kernel<<<(M + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, st>>>(
      static_cast<bf16*>(out), static_cast<const float*>(g2), static_cast<const float*>(b2), M,
      dim);
  return (int)cudaGetLastError();
}

}  // namespace pe
}  // namespace ctc

extern "C" int ctc_patch_embed(const void* image, const void* kwd, const void* s1,
                               const void* b1, const void* g2, const void* b2, void* patches,
                               void* stats, void* out, int B, int T, int H, int W, int patch,
                               int t_patch, int dim, int ldp, int ldk, void* stream) {
  return ctc::pe::launch(image, kwd, s1, b1, g2, b2, patches, stats, out, nullptr, B, T, H, W,
                         patch, t_patch, dim, ldp, ldk, reinterpret_cast<cudaStream_t>(stream));
}

// The residual-saving forward (the port of _forward_res_impl): the same
// chain, and the GEMM's epilogue also writes the fp32 product `conv`; with
// `stats` these are what the LayerNorm-chain backward rebuilds from.
extern "C" int ctc_patch_embed_res(const void* image, const void* kwd, const void* s1,
                                   const void* b1, const void* g2, const void* b2, void* patches,
                                   void* stats, void* out, void* conv, int B, int T, int H, int W,
                                   int patch, int t_patch, int dim, int ldp, int ldk,
                                   void* stream) {
  return ctc::pe::launch(image, kwd, s1, b1, g2, b2, patches, stats, out, conv, B, T, H, W, patch,
                         t_patch, dim, ldp, ldk, reinterpret_cast<cudaStream_t>(stream));
}

// The fp32 variant, pe::launch_f32: image [B, 1, T, H, W] fp32, kwd [dim,
// ld] fp32 (zeros past K), s1/b1/g2/b2 [dim] fp32, workspaces patches
// [2][M][ld] and kw_s [2][dim][ld] bf16, stats [M, 2] fp32, out [M, dim]
// fp32; ld a multiple of 8 at least K. flags 1: every lo plane zeroed (one
// bf16 product for each fp32 one, the control).
extern "C" int ctc_patch_embed_f32(const void* image, const void* kwd, const void* s1,
                                   const void* b1, const void* g2, const void* b2, void* patches,
                                   void* kw_s, void* stats, void* out, int B, int T, int H, int W,
                                   int patch, int t_patch, int dim, int ld, int flags,
                                   void* stream) {
  using ctc::sm90::bf16;
  return ctc::pe::launch_f32(
      (const float*)image, (const float*)kwd, (const float*)s1, (const float*)b1,
      (const float*)g2, (const float*)b2, (bf16*)patches, (bf16*)kw_s, stats, (float*)out,
      nullptr, B, T, H, W, patch, t_patch, dim, ld, !(flags & 1),
      reinterpret_cast<cudaStream_t>(stream));
}

// The fp32 residual-saving forward (the port of _forward_res_impl on an
// fp32 volume): ctc_patch_embed_f32's arguments and conv [M, dim] fp32, the
// product before the folded LN1; `patches` keeps P's planes for the weight
// gradient.
extern "C" int ctc_patch_embed_res_f32(const void* image, const void* kwd, const void* s1,
                                       const void* b1, const void* g2, const void* b2,
                                       void* patches, void* kw_s, void* stats, void* out,
                                       void* conv, int B, int T, int H, int W, int patch,
                                       int t_patch, int dim, int ld, int flags, void* stream) {
  using ctc::sm90::bf16;
  return ctc::pe::launch_f32(
      (const float*)image, (const float*)kwd, (const float*)s1, (const float*)b1,
      (const float*)g2, (const float*)b2, (bf16*)patches, (bf16*)kw_s, stats, (float*)out,
      (float*)conv, B, T, H, W, patch, t_patch, dim, ld, !(flags & 1),
      reinterpret_cast<cudaStream_t>(stream));
}

// P's hi / lo planes [2][M][ld] bf16 of an fp32 volume [B, 1, T, H, W] (ld
// a multiple of 8 at least K, zeros past K): the fp32 chain's patchify pass
// without the LN1 moments. flags 1: lo plane zeroed.
extern "C" int ctc_patchify_f32(const void* image, void* patches, int B, int T, int H, int W,
                                int patch, int t_patch, int ld, int flags, void* stream) {
  using ctc::pe::ROW_WARPS;
  const ctc::PatchGeom g{T, H, W, patch, t_patch};
  const int M = B * (T / t_patch) * (H / patch) * (W / patch);
  if (M == 0) return 0;
  const int vec4 =
      patch % 4 == 0 && W % 4 == 0 && (reinterpret_cast<uintptr_t>(image) & 15u) == 0;
  ctc::sm90::bf16* p = static_cast<ctc::sm90::bf16*>(patches);
  ctc::pe::patchify_f32_kernel<<<(M + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                                 reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(image), p, p + (int64_t)M * ld, nullptr, M, ld, g, vec4,
      !(flags & 1));
  return (int)cudaGetLastError();
}
