// GEGLU feed-forward block, backward in fp32: the port of
// ct_clip_ut_tpu/ops/pallas_ff.py:_backward_impl (_bwd_kernel) at fp32,
// where its rounding points are identities. Two forms: the data gradient
// alone for the gradient attribution methods (Grad-CAM, integrated
// gradients), which differentiate the score with respect to activations
// and patches, never weights; and with every parameter gradient (dgamma,
// dbeta, dWv | dWg, dW2) for the fp32 train step.
//
// dx = LN'(dxn) (+ g),  dxn = dvalue Wv + dgate Wg,  dvalue = dh gelu(gate),
// dgate = dh value gelu'(gate),  dh = g W2,  [value | gate] = xn [Wv | Wg]^T,
// dW2 = g^T h (h = gelu(gate) value),  [dWv; dWg] = [dvalue | dgate]^T xn
// over N token rows (D = 512, inner = 1365; N = 13,824 a Grad-CAM, 69,120
// an integrated-gradients chunk of 5, 27,648 a B = 2 train step).
//
// What bounds it on the H100: tensor-core operations, three fp32 products
// of 2 N D (2 inner), 2 N D inner and 2 N (2 inner) D for dx (30 N D inner
// as bf16 products at the bf16 peak, 1.47 ms at N = 69,120), two more of 2
// N D inner and 2 N D (2 inner) for the weights (48 N D inner in all: 0.94
// ms at N = 27,648). The design is the fp32 forward's pieces around the
// products (launches):
//   split_kernel x 4      the planes of w_in (value rows, then the gate rows
//                         at row ldh of a zero-padded [2 ldh, D] plane, so
//                         dxn's K runs over [dvalue | dgate] with the same
//                         padding), w_out (as stored, [D, ldw]) and g
//   ln_split_kernel       xn's planes
//   gemm_kernel           dh = g W2 [N, ldh] fp32 (SplitKNPlan: W2 read
//                         MN-major as stored; zeros in the padded columns)
//   gemm_kernel           [value | gate] recomputed (GegluSplitPlan), the
//                         epilogue reading dh and writing dvalue | dgate as
//                         hi / lo planes [N, 2 ldh], zeros in the padding
//                         (and, in the train form, h's planes [N, ldh])
//   gemm_kernel           dxn = [dvalue | dgate] [Wv; Wg] (SplitKNPlan,
//                         the padded weight planes as stored, K = 2 ldh)
//   ln_bwd_f32_kernel     dx (+ g); in the train form each block's dgamma
//                         and dbeta partial sums
//   colsum_kernel         (train form) dgamma | dbeta, the partials in order
//   wgrad_kernel          (train form) dW2 = g^T h and dWv | dWg = [dvalue |
//                         dgate]^T xn in one three-pass launch on
//                         wgrad_sm90.cuh (FFWgradSplitPlan: 4 x 11 tiles of
//                         dW2, 22 x 4 of dWv | dWg, 132 in all), each tile
//                         summing all N rows in order: no atomics, the same
//                         bits every call; inner's padding stays out of the
//                         outputs
// dh goes through memory in fp32 (the bf16 chain's gate_bwd_kernel keeps it
// in registers by a second K loop; that is for a later PR to make fast).
#include "split_sm90.cuh"
#include "wgrad_sm90.cuh"

namespace ctc {
namespace ff32b {

using namespace sm90;

// From value (acc[4 j + 2 hf + e]) and gate (acc[4 (j + 8) + 2 hf + e]) of
// inner columns nt * 64 ... and dh [M, ldh] fp32: dvalue = dh gelu(gate)
// and dgate = dh value gelu'(gate) as hi / lo planes [M, 2 ldh] at columns
// c and ldh + c; zeros in [inner, ldh). Where h_hi is not null, also h =
// gelu(gate) value as hi / lo planes [M, ldh] (dW2's operand).
struct GateBwdSplitEpi {
  const float* dh;
  bf16* hi;
  bf16* lo;
  int M, inner, ldh, keep_lo;
  bf16* h_hi;
  bf16* h_lo;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = row + g + 8 * hf;
      if (m >= M) continue;
      const int64_t drow = (int64_t)m * 2 * ldh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = nt * 64 + 8 * j + 2 * t;     // even; ldh a multiple of 8
        if (c >= ldh) continue;
        float dv[2] = {0.f, 0.f}, dg[2] = {0.f, 0.f}, hv[2] = {0.f, 0.f};
        const float2 d = *reinterpret_cast<const float2*>(dh + (int64_t)m * ldh + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e < inner) {
            const float value = acc[4 * j + 2 * hf + e];
            const float gate = acc[4 * (j + 8) + 2 * hf + e];
            const float cdf = 0.5f * (1.0f + erff(gate * 0.7071067811865476f));
            const float gprime = cdf + gate * 0.3989422804014327f * expf(-0.5f * gate * gate);
            const float de = e ? d.y : d.x;
            dv[e] = de * gate * cdf;
            dg[e] = de * value * gprime;
            hv[e] = gate * cdf * value;
          }
        }
        __nv_bfloat162 h2, l2;
        if (h_hi != nullptr) {
          split2(hv[0], hv[1], keep_lo, h2, l2);
          *reinterpret_cast<__nv_bfloat162*>(h_hi + (int64_t)m * ldh + c) = h2;
          *reinterpret_cast<__nv_bfloat162*>(h_lo + (int64_t)m * ldh + c) = l2;
        }
        split2(dv[0], dv[1], keep_lo, h2, l2);
        *reinterpret_cast<__nv_bfloat162*>(hi + drow + c) = h2;
        *reinterpret_cast<__nv_bfloat162*>(lo + drow + c) = l2;
        split2(dg[0], dg[1], keep_lo, h2, l2);
        *reinterpret_cast<__nv_bfloat162*>(hi + drow + ldh + c) = h2;
        *reinterpret_cast<__nv_bfloat162*>(lo + drow + ldh + c) = l2;
      }
    }
  }
};

// The two weight gradients in one three-pass launch. Maps (hi, lo each): 0
// / 1 g [M, D], 2 / 3 h [M, inner] (row stride ldh), 4 / 5 [dvalue |
// dgate] [M, 2 ldh], 6 / 7 xn [M, D]. Tiles [0, d_tiles * inner_tiles): dW2
// [D, inner] = g^T h (output 0); then dW_in [2 inner, D]: dvalue^T xn (rows
// [0, inner), columns i0 of the dvalue | dgate planes) and dgate^T xn (rows
// [inner, 2 inner), columns ldh + i0) (output 1). A value tile's last
// columns past inner read gate columns, a gate tile's TMA zeros: neither
// lands in a stored row.
struct FFWgradSplitPlan {
  static constexpr int PASSES = 3;
  int D, inner, ldh, d_tiles, inner_tiles;
  __device__ WgradTile tile(int t) const {
    const int out_tiles = d_tiles * inner_tiles;
    if (t < out_tiles) {
      const int i0 = (t / inner_tiles) * BM, j0 = (t % inner_tiles) * BN;
      return {0, 2, i0, j0, 0, i0, min(BM, D - i0)};
    }
    const int u = t - out_tiles, it = u / d_tiles, j0 = (u % d_tiles) * BN;
    const int gate = it >= inner_tiles, i0 = (gate ? it - inner_tiles : it) * BM;
    return {4, 6, gate * ldh + i0, j0, 1, gate * inner + i0, min(BM, inner - i0)};
  }
};

}  // namespace ff32b
}  // namespace ctc

using namespace ctc::sm90;

// x [M, D], g [M, D] fp32 (D a multiple of 8); gamma / beta [D], w_in
// [2*inner, D] and w_out [D, inner] (row stride ldw, a multiple of 8) fp32;
// workspaces wi_s [2][2*ldh][D] bf16 ZEROED (its rows inner .. ldh - 1 and
// ldh + inner .. 2 ldh - 1 are never written), wo_s [2][D][ldw], xn_s
// [2][M][D], g_s [2][M][D], dvg_s [2][M][2*ldh] bf16, dh [M][ldh] and dxn
// [M][D] fp32 (ldh >= inner, a multiple of 8); out dx [M, D] fp32 (+ g with
// residual). The train step's form (dw_in not null) also takes the
// workspaces h_s [2][M][ldh] bf16 and ln_part [ln_parts(M)][2 D] fp32 and
// writes dgb [2][D] (dgamma, dbeta), dw_in [2*inner, D] and dw_out [D,
// inner] fp32 whole; with dw_in null those five are unused. Every pointer
// 16-B aligned. flags 1: every lo plane zeroed (one bf16 product for each
// fp32 one, the control).
extern "C" int ctc_geglu_ff_bwd_f32(const void* x, const void* gamma, const void* beta,
                                    const void* w_in, const void* w_out, const void* g,
                                    void* wi_s, void* wo_s, void* xn_s, void* g_s, void* dh,
                                    void* dvg_s, void* dxn, void* dx, void* h_s, void* ln_part,
                                    void* dgb, void* dw_in, void* dw_out, int M, int D,
                                    int inner, int ldh, int ldw, int residual, int flags,
                                    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int keep = !(flags & 1);
  const bool train = dw_in != nullptr;
  const int64_t md = (int64_t)M * D, wrows = (int64_t)2 * ldh * D, half = (int64_t)inner * D;
  const int64_t wout = (int64_t)D * ldw, mvg = (int64_t)M * 2 * ldh, mh = (int64_t)M * ldh;
  bf16 *wi = (bf16*)wi_s, *wo = (bf16*)wo_s, *xn = (bf16*)xn_s, *gs = (bf16*)g_s;
  bf16 *dvg = (bf16*)dvg_s, *hs = (bf16*)h_s;
  const float* xf = static_cast<const float*>(x);
  const float* win = static_cast<const float*>(w_in);
  Maps vg{};
  int err = map_a(&vg.m[0], xn, M, D, D);
  if (!err) err = map_a(&vg.m[1], xn + md, M, D, D);
  if (!err) err = map_b(&vg.m[2], wi, 2 * ldh, D, D);
  if (!err) err = map_b(&vg.m[3], wi + wrows, 2 * ldh, D, D);
  MapsN<8> wg{};
  if (train) {
    // (hi, lo) of g, h, [dvalue | dgate], xn: FFWgradSplitPlan's maps
    const bf16* const src[4] = {gs, hs, dvg, xn};
    const int cols[4] = {D, inner, 2 * ldh, D}, ld[4] = {D, ldh, 2 * ldh, D};
    const int64_t lo[4] = {md, mh, mvg, md};
    for (int i = 0; i < 4 && !err; ++i) {
      err = map_mn(&wg.m[2 * i], src[i], M, cols[i], ld[i]);
      if (!err) err = map_mn(&wg.m[2 * i + 1], src[i] + lo[i], M, cols[i], ld[i]);
    }
  }
  if (err) return err;
  err = split_to(win, wi, wi + wrows, half, keep, st);
  if (!err)
    err = split_to(win + half, wi + (int64_t)ldh * D, wi + wrows + (int64_t)ldh * D, half, keep,
                   st);
  if (!err) err = split(w_out, wo, wout, keep, st);
  if (!err) err = split(g, gs, md, keep, st);
  if (!err)
    err = launch_ln_split(xf, static_cast<const float*>(gamma), static_cast<const float*>(beta),
                          nullptr, xn, xn + md, nullptr, nullptr, M, D, 1e-5f, keep, st);
  if (err) return err;
  float* dhf = static_cast<float*>(dh);
  err = split_product_kn(gs, gs + md, D, wo, wo + wout, ldw, M, inner, D,
                         F32OutEpi{dhf, nullptr, nullptr, M, ldh}, st);
  if (err) return err;
  err = launch_gemm(vg, ctc::ff::GegluSplitPlan{ldh},
                    ctc::ff32b::GateBwdSplitEpi{dhf, dvg, dvg + mvg, M, inner, ldh, keep,
                                                train ? hs : nullptr, train ? hs + mh : nullptr},
                    (inner + 63) / 64, M, D, st);
  if (err) return err;
  float* dxnf = static_cast<float*>(dxn);
  float* part = static_cast<float*>(ln_part);
  err = split_product_kn(dvg, dvg + mvg, 2 * ldh, wi, wi + wrows, D, M, D, 2 * ldh,
                         F32OutEpi{dxnf, nullptr, nullptr, M, D}, st);
  if (!err)
    err = launch_ln_bwd_f32(xf, static_cast<const float*>(gamma), dxnf, nullptr,
                            residual ? static_cast<const float*>(g) : nullptr,
                            static_cast<float*>(dx), M, D, st, train ? part : nullptr);
  if (err || !train) return err;
  err = launch_colsum(part, static_cast<float*>(dgb), ln_parts(M), 2 * D, 2 * D, 1.f, st);
  if (err) return err;
  const int d_tiles = (D + BN - 1) / BN, inner_tiles = (inner + BN - 1) / BN;
  return launch_wgrad_sm90(
      wg, ctc::ff32b::FFWgradSplitPlan{D, inner, ldh, d_tiles, inner_tiles},
      WgradStoreEpi{{(float*)dw_out, (float*)dw_in}, {inner, D}, {inner, D}},
      d_tiles * inner_tiles * 3, M, st);
}
