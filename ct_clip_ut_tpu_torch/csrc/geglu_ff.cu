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
#include "gemm_sm90.cuh"

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
