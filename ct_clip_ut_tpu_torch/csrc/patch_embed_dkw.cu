// CT-ViT patch embed, projection weight gradient: the port of
// ct_clip_ut_tpu/ops/pallas_patch_embed.py:_dkw_impl (_dkw_kernel).
//
// dkw[k, n] = sum over patches m of P[m, k] * dconv[m, n]: P [M, K] are the
// raw patches of a [B, 1, T, H, W] bf16 volume (M = 27,648 patches of K =
// 4,000 pixels at two flagship volumes, column k = (tv, p1, wv)) and dconv
// [M, dim] bf16 the cotangent of the fp32 product. Row k = (cin, wv) of
// [K, dim] is stored as row (wv, cin) of the kernel-weight layout [wv,
// cin, dim].
//
// What bounds it on the H100: tensor-core FLOPs, 2 * M * K * dim (113 GFLOP
// at B = 2, 0.11 ms at the bf16 peak); P (221 MB) is the only large read.
// The TPU kernel rearranges each frame in VMEM and accumulates over a
// sequential grid. Here it is a weight gradient over token rows, C = P^T
// dconv with both operands MN-major, on wgrad_sm90.cuh: one block sums one
// 128 x 128 tile of [K, dim] over all M rows in order (PatchWgradPlan: 32
// row tiles x 4 column tiles = 128 blocks at dim 512, one wave on 132 SMs;
// the last row tile holds 32 rows, and TMA zero-fills P's columns past K)
// and stores it: no atomics, the output is written whole, two calls give
// the same bits. The four column tiles of a row tile are neighbours in the
// grid and walk the same P columns together, so P streams from HBM about
// once. P comes from the forward (patch_embed_res's workspace, which the
// training path keeps) or, for a call from the volume alone, from
// ctc_patchify (the forward's patchify_kernel, patch_common.cuh, without
// the LN1 moments): a launch of its own, 221 MB read and written more.
//
// The fp32 entry (ctc_patch_embed_dkw_f32, the fp32 train step's: the
// volume and dconv fp32, as JAX's _pe_bwd keeps dconv in the image dtype)
// takes P as the fp32 forward's hi / lo planes (patch_embed.cu's
// ctc_patch_embed_res_f32, or ctc_patchify_f32 from the volume), splits
// dconv into planes by a row pass, and runs the same tiles as split
// products (PatchWgradSplitPlan: P_hi dconv_lo, P_lo dconv_hi, P_hi
// dconv_hi into one fp32 accumulator, within ~2^-16 of the fp32 product).
// Its bound at B = 2: 340 GFLOP as bf16 products, 0.34 ms at the bf16 peak
// (the planes of P, 442 MB, 0.13 ms). Walking the tokens three times
// (wgrad_kernel's three passes) read 128 x 3 x 432 x 32 KB = 5.3 GB from L2,
// 0.89 ms on the H100; here each 64-token slice's four planes are staged
// once (wgrad4_kernel, 3.6 GB, 0.48 ms).
#include "patch_common.cuh"
#include "split_sm90.cuh"
#include "wgrad_sm90.cuh"

namespace ctc {
namespace pe {

// Tile t of dkw [K, dim]: P's columns i0 .. i0 + 127 (map 0) against dconv's
// j0 .. j0 + 127 (map 1), rows-major over ceil(K / 128) x col_tiles.
struct PatchWgradPlan {
  int K, col_tiles;
  __device__ sm90::WgradTile tile(int t) const {
    const int i0 = (t / col_tiles) * sm90::BM, j0 = (t % col_tiles) * sm90::BN;
    return {0, 1, i0, j0, 0, i0, min(sm90::BM, K - i0)};
  }
};

// PatchWgradPlan over split planes: maps 0 / 1 P's hi / lo, 2 / 3 dconv's.
struct PatchWgradSplitPlan {
  int K, col_tiles;
  __device__ sm90::WgradTile tile(int t) const {
    const int i0 = (t / col_tiles) * sm90::BM, j0 = (t % col_tiles) * sm90::BN;
    return {0, 2, i0, j0, 0, i0, min(sm90::BM, K - i0)};
  }
};

// The tile's sums into dkw [patch (wv), cin, dim] fp32: row k = c * patch +
// wv of [K, dim] is row wv * cin + c; dim even, so pairs of columns go as
// one 8-B store.
struct DkwStoreEpi {
  float* out;
  int dim, patch, cin;
  __device__ void operator()(const float (&acc)[64], const sm90::WgradTile& tile, int r0,
                             int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r >= tile.nrows) continue;
      const int k = tile.orow0 + r;
      float* row = out + ((int64_t)(k % patch) * cin + k / patch) * dim;
#pragma unroll
      for (int j = 0; j < sm90::BN / 8; ++j) {
        const int c = tile.j0 + 8 * j + 2 * t;
        if (c < dim)
          *reinterpret_cast<float2*>(row + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
};

}  // namespace pe
}  // namespace ctc

using namespace ctc;

// P [M, ldp] bf16 of the volume image [B, 1, T, H, W] bf16 (T, H, W
// multiples of t_patch, patch, patch; ldp a multiple of 8 at least K,
// zeros past K): the patchify pass of the forward, without the LN1 moments.
extern "C" int ctc_patchify(const void* image, void* patches, int B, int T, int H, int W,
                            int patch, int t_patch, int ldp, void* stream) {
  const PatchGeom g{T, H, W, patch, t_patch};
  const int M = B * (T / t_patch) * (H / patch) * (W / patch);
  return pe::launch_patchify(image, patches, nullptr, M, ldp, g,
                             reinterpret_cast<cudaStream_t>(stream));
}

// patches P [M, ldp] bf16 of a [B, 1, T, H, W] volume (ldp a multiple of 8
// at least K: the forward's workspace or ctc_patchify's); dconv [M, dim]
// bf16 (dim a multiple of 8); out [patch, t_patch * patch, dim] fp32,
// written whole. Pointers 16-B aligned.
extern "C" int ctc_patch_embed_dkw(const void* patches, const void* dconv, void* out, int B,
                                   int T, int H, int W, int patch, int t_patch, int dim, int ldp,
                                   void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const PatchGeom g{T, H, W, patch, t_patch};
  const int M = B * (T / t_patch) * (H / patch) * (W / patch), K = g.K();
  sm90::Maps maps{};
  int err = sm90::map_mn(&maps.m[0], patches, M, K, ldp);
  if (!err) err = sm90::map_mn(&maps.m[1], dconv, M, dim, dim);
  if (err) return err;
  const int col_tiles = (dim + sm90::BN - 1) / sm90::BN;
  return sm90::launch_wgrad_sm90(maps, pe::PatchWgradPlan{K, col_tiles},
                                 pe::DkwStoreEpi{static_cast<float*>(out), dim, patch, K / patch},
                                 ((K + sm90::BM - 1) / sm90::BM) * col_tiles, M, st);
}

// patches [2][M][ldp] bf16, P's hi / lo planes of a [B, 1, T, H, W] fp32
// volume (the fp32 forward's workspace or ctc_patchify_f32's); dconv [M,
// dim] fp32 (dim a multiple of 8); workspace dconv_s [2][M][dim] bf16; out
// [patch, t_patch * patch, dim] fp32, written whole. flags 1: dconv's lo
// plane zeroed (the one-pass control, with P's from a one-pass patchify).
extern "C" int ctc_patch_embed_dkw_f32(const void* patches, const void* dconv, void* dconv_s,
                                       void* out, int B, int T, int H, int W, int patch,
                                       int t_patch, int dim, int ldp, int flags, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const PatchGeom g{T, H, W, patch, t_patch};
  const int M = B * (T / t_patch) * (H / patch) * (W / patch), K = g.K();
  const int64_t pm = (int64_t)M * ldp, dm = (int64_t)M * dim;
  const sm90::bf16* p = static_cast<const sm90::bf16*>(patches);
  sm90::bf16* ds = static_cast<sm90::bf16*>(dconv_s);
  sm90::Maps maps{};
  int err = sm90::map_mn(&maps.m[0], p, M, K, ldp);
  if (!err) err = sm90::map_mn(&maps.m[1], p + pm, M, K, ldp);
  if (!err) err = sm90::map_mn(&maps.m[2], ds, M, dim, dim);
  if (!err) err = sm90::map_mn(&maps.m[3], ds + dm, M, dim, dim);
  if (!err) err = sm90::split(dconv, ds, dm, !(flags & 1), st);
  if (err) return err;
  const int col_tiles = (dim + sm90::BN - 1) / sm90::BN;
  return sm90::launch_wgrad4_sm90(maps, pe::PatchWgradSplitPlan{K, col_tiles},
                                  pe::DkwStoreEpi{static_cast<float*>(out), dim, patch, K / patch},
                                  ((K + sm90::BM - 1) / sm90::BM) * col_tiles, M, st);
}
