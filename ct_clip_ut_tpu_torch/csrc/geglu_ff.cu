// GEGLU feed-forward block: the port of
// ct_clip_ut_tpu/ops/pallas_ff.py:geglu_ff_fused (_forward_impl / _kernel).
//
// out = (gelu_erf(xn Wg^T) * (xn Wv^T)) W2^T (+ x),  xn = LN(x) (gamma, beta)
// over N token rows (the CT-ViT and MaskGit FF: D = 512, inner = 1365,
// N = B * 13824 or B * 6464).
//
// What bounds it on the H100: tensor-core FLOPs, 2 * N * 512 * 1365 * 3
// (58 GFLOP per volume per layer); the [N, 1365] hidden tensor is the only
// large intermediate. The design runs both products on the Hopper core of
// gemm_sm90.cuh (TMA ring, wgmma, register epilogues), in three launches:
//   (1) ln_rows_kernel writes xn bf16 [N, D] (TMA copies tiles as they are,
//       so the LayerNorm cannot ride on the loads);
//   (2) xn . [Wv; Wg]^T: each 128-wide tile of the product takes 64 value
//       rows and the 64 gate rows of the same columns from two maps of w_in,
//       so a thread holds value column c and gate column c in acc[j], acc[j
//       + 32]; the epilogue writes h = gelu(gate) * value rounded to bf16
//       (the TPU kernel's rounding point before W2) into hbuf [N, ldh];
//   (3) h . W2^T with the residual added in fp32.
// inner = 1365 is not a multiple of 64: the maps read hbuf and w_out as
// [., inner] matrices and TMA zero-fills the ragged K slice. w_out's rows
// (2730 B) are not 16-B strided, so the wrapper hands a zero-padded copy
// with row stride ldw. gelu uses erff, the exact erf (the TPU kernel's A&S
// polynomial exists because Mosaic has no erf).
//
// The fp32 variant (ctc_geglu_ff_f32, the TPU kernel at fp32: its rounding
// points are identities) runs the same three steps with every product as
// three bf16 products of hi / lo planes (split_sm90.cuh), within ~2^-16 of
// fp32: a split pass of the weights (per call), ln_split_kernel writing
// xn's planes, xn . [Wv; Wg]^T as GegluSplitPlan (one map of each stacked
// weight plane, the gate rows at row `inner` on) with h = gelu(gate) *
// value written as hi / lo planes, h . W2^T as SplitPlan with the residual
// added in fp32 (F32OutEpi). Both products run on split4_kernel: each K
// slice's four planes staged once and its three bf16 products issued from
// that stage, one persistent block an SM. Its bound: three times the bf16
// operations at the bf16 peak.
#include "split_sm90.cuh"

namespace ctc {
namespace ff {

using namespace sm90;

// A = xn (map 0); value rows nt * 64 ... of map 1, gate rows of map 2
struct GegluPlan {
  __device__ TileSrc src(int nt) const { return {0, 1, nt * 64, 2, nt * 64}; }
};

// h [M, ldh] bf16 = gelu(gate) * value, inner columns nt * 64 ...
struct GegluEpi {
  bf16* h;
  int M, inner, ldh;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = row + g + 8 * hf;
      if (m < M) {
        bf16* hr = h + (int64_t)m * ldh;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = nt * 64 + 8 * j + 2 * t;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float value = acc[4 * j + 2 * hf + e];
            const float gate = acc[4 * (j + 8) + 2 * hf + e];
            y[e] = 0.5f * gate * (1.0f + erff(gate * 0.7071067811865476f)) * value;
          }
          if (c + 1 < inner) {
            *reinterpret_cast<__nv_bfloat162*>(hr + c) = __floats2bfloat162_rn(y[0], y[1]);
          } else if (c < inner) {
            hr[c] = __float2bfloat16(y[0]);
          }
        }
      }
    }
  }
};

// h = gelu(gate) * value in fp32, written as hi / lo planes [M, ldh]
// (columns nt * 64 ... below inner)
struct GegluSplitEpi {
  bf16* hi;
  bf16* lo;
  int M, inner, ldh, keep_lo;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = row + g + 8 * hf;
      if (m >= M) continue;
      const int64_t base = (int64_t)m * ldh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = nt * 64 + 8 * j + 2 * t;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float value = acc[4 * j + 2 * hf + e];
          const float gate = acc[4 * (j + 8) + 2 * hf + e];
          y[e] = 0.5f * gate * (1.0f + erff(gate * 0.7071067811865476f)) * value;
        }
        __nv_bfloat162 hv, lv;
        split2(y[0], y[1], keep_lo, hv, lv);
        if (c + 1 < inner) {
          *reinterpret_cast<__nv_bfloat162*>(hi + base + c) = hv;
          *reinterpret_cast<__nv_bfloat162*>(lo + base + c) = lv;
        } else if (c < inner) {
          hi[base + c] = __low2bfloat16(hv);
          lo[base + c] = __low2bfloat16(lv);
        }
      }
    }
  }
};

}  // namespace ff
}  // namespace ctc

using namespace ctc::sm90;

// x [M, D] bf16 (D a multiple of 8); gamma/beta [D] fp32; w_in [2*inner, D]
// bf16 (value rows then gate rows); w_out [D, inner] bf16 with row stride ldw
// (a multiple of 8); xn [M, D] and hbuf [M, ldh] bf16 workspaces (ldh >=
// inner, a multiple of 8); out [M, D] bf16. Every pointer 16-B aligned.
extern "C" int ctc_geglu_ff(const void* x, const void* gamma, const void* beta, const void* w_in,
                            const void* w_out, void* xn, void* hbuf, void* out, int M, int D,
                            int inner, int ldh, int ldw, int residual, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Maps in{}, outm{};
  const bf16* w = static_cast<const bf16*>(w_in);
  int err = map_a(&in.m[0], xn, M, D, D);
  if (!err) err = map_b(&in.m[1], w, inner, D, D);
  if (!err) err = map_b(&in.m[2], w + (int64_t)inner * D, inner, D, D);
  if (!err) err = map_a(&outm.m[0], hbuf, M, inner, ldh);
  if (!err) err = map_b(&outm.m[1], w_out, D, inner, ldw);
  if (err) return err;
  err = launch_ln_rows(static_cast<const bf16*>(x), static_cast<const float*>(gamma),
                       static_cast<const float*>(beta), static_cast<bf16*>(xn), M, D, st);
  if (err) return err;
  err = launch_gemm(in, ctc::ff::GegluPlan{},
                    ctc::ff::GegluEpi{static_cast<bf16*>(hbuf), M, inner, ldh},
                    (inner + 63) / 64, M, D, st);
  if (err) return err;
  return launch_gemm(outm, LinearPlan{},
                     ResidualEpi{static_cast<bf16*>(out), static_cast<const bf16*>(x), M, D,
                                 residual},
                     (D + BN - 1) / BN, M, inner, st);
}

// The fp32 variant: x [M, D] fp32 (D a multiple of 8); gamma / beta [D], w_in
// [2*inner, D] and w_out [D, inner] (row stride ldw, a multiple of 8) fp32;
// workspaces xn_s [2][M][D], w_in_s [2][2*inner][D], w_out_s [2][D][ldw]
// and h_s [2][M][ldh] bf16 (ldh >= inner, a multiple of 8); out [M, D]
// fp32. Every pointer 16-B aligned. flags 1: every lo plane zeroed (one
// bf16 product for each fp32 one, the control).
extern "C" int ctc_geglu_ff_f32(const void* x, const void* gamma, const void* beta,
                                const void* w_in, const void* w_out, void* xn_s, void* w_in_s,
                                void* w_out_s, void* h_s, void* out, int M, int D, int inner,
                                int ldh, int ldw, int residual, int flags, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int keep = !(flags & 1);
  const int64_t md = (int64_t)M * D, win = (int64_t)2 * inner * D, wout = (int64_t)D * ldw;
  bf16 *xn = (bf16*)xn_s, *wi = (bf16*)w_in_s, *wo = (bf16*)w_out_s, *h = (bf16*)h_s;
  const int64_t mh = (int64_t)M * ldh;
  Maps in{};
  int err = map_a(&in.m[0], xn, M, D, D);
  if (!err) err = map_a(&in.m[1], xn + md, M, D, D);
  if (!err) err = map_b(&in.m[2], wi, 2 * inner, D, D);
  if (!err) err = map_b(&in.m[3], wi + win, 2 * inner, D, D);
  if (err) return err;
  err = split(w_in, wi, win, keep, st);
  if (!err) err = split(w_out, wo, wout, keep, st);
  if (!err)
    err = launch_ln_split(static_cast<const float*>(x), static_cast<const float*>(gamma),
                          static_cast<const float*>(beta), nullptr, xn, xn + md, nullptr, nullptr,
                          M, D, 1e-5f, keep, st);
  if (err) return err;
  err = launch_split4<true>(in, ctc::ff::GegluSplitPlan{inner},
                      ctc::ff::GegluSplitEpi{h, h + mh, M, inner, ldh, keep}, (inner + 63) / 64, M,
                      D, st);
  if (err) return err;
  return split4_product<true>(h, h + mh, ldh, wo, wo + wout, ldw, M, D, inner,
                        F32OutEpi{static_cast<float*>(out), nullptr,
                                  residual ? static_cast<const float*>(x) : nullptr, M, D},
                        st);
}
