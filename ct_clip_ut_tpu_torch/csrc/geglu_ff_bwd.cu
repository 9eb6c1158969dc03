// GEGLU feed-forward block, backward: the port of
// ct_clip_ut_tpu/ops/pallas_ff.py:_backward_impl (_bwd_kernel).
//
// Given x [M, D] bf16, the block's weights and the output cotangent g, it
// recomputes xn, value and gate and returns dx (+ g under `residual`),
// dgamma, dbeta, dWv | dWg and dW2, at the TPU kernel's rounding points: xn,
// h = gelu(gate) value, dvalue = dh gelu(gate) and dgate = dh value
// gelu'(gate) rounded to bf16 before the products that use them; dh, the
// LayerNorm backward and every accumulation in fp32. gelu is the exact erf
// form (erff) and gelu'(u) = Phi(u) + u phi(u) in closed form (the TPU
// kernel's Abramowitz-Stegun polynomial exists only because Mosaic has no
// erf).
//
// What bounds it on the H100: tensor-core FLOPs, 2 * M * 512 * 1365 * 8
// (309 GFLOP at B = 2: the value / gate recompute, dh, dxn and three weight
// products). The TPU kernel recomputes per row tile in VMEM and accumulates
// the weight gradients across its sequential grid; here the bf16
// intermediates (h, dvalue | dgate, xn; 75 MB each at B = 2) go through
// global memory between launches, and the weight gradients are split over
// the 27,648 rows with fp32 atomicAdd (bwd_common.cuh). Seven launches:
//   ln_rows_kernel       xn = LN(x) gamma + beta (bf16), (mean, rstd)
//   gemm_nt              dh = g W2 (fp32 [M, ldh])
//   ff_bwd_gate_kernel   [value | gate] = xn [Wv | Wg]^T on the shared tile
//                        (64 value + 64 gate columns, as ff_in_kernel); the
//                        epilogue writes h and dvalue | dgate (bf16)
//   gemm_nt              dxn = dvalue Wv + dgate Wg (fp32)
//   ln_bwd_rows_kernel   dx, dgamma, dbeta
//   wgrad_kernel x 2     dW2 = g^T h, dWv | dWg = (dvalue | dgate)^T xn
#include "bwd_common.cuh"

namespace ctc {

constexpr int FF_HALF = BN / 2;

__global__ void __launch_bounds__(THREADS)
ff_bwd_gate_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ w_in,
                   const float* __restrict__ dh, bf16* __restrict__ hbuf,
                   bf16* __restrict__ dvg, int M, int D, int inner, int ldh) {
  extern __shared__ __align__(128) char smem[];
  const int n0 = blockIdx.x * FF_HALF;
  const int row0 = blockIdx.y * BM;
  const RowMajor xa{xn, D, M, D};
  const RowMajor wv{w_in + (int64_t)n0 * D, D, inner - n0, D};
  const RowMajor wg{w_in + (int64_t)(inner + n0) * D, D, inner - n0, D};
  block_gemm([&](int r, int k) { return xa.load8(row0 + r, k); },
             [&](int r, int k) { return r < FF_HALF ? wv.load8(r, k) : wg.load8(r - FF_HALF, k); },
             D, smem);

  const float* C = reinterpret_cast<const float*>(smem);
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < BM * FF_HALF; i += THREADS) {
    int r = i / FF_HALF, c = i % FF_HALF;
    int m = row0 + r, n = n0 + c;
    if (m >= M || n >= ldh) continue;
    bf16* dv = dvg + (int64_t)m * 2 * ldh;
    if (n >= inner) {                       // zero the padding the later products read
      hbuf[(int64_t)m * ldh + n] = zero;
      dv[n] = zero;
      dv[ldh + n] = zero;
      continue;
    }
    const float value = C[r * LDC + c];
    const float gate = C[r * LDC + FF_HALF + c];
    const float cdf = 0.5f * (1.0f + erff(gate * 0.7071067811865476f));
    const float gel = gate * cdf;
    const float gprime = cdf + gate * 0.3989422804014327f * expf(-0.5f * gate * gate);
    const float d = dh[(int64_t)m * ldh + n];
    hbuf[(int64_t)m * ldh + n] = __float2bfloat16(gel * value);
    dv[n] = __float2bfloat16(d * gel);
    dv[ldh + n] = __float2bfloat16(d * value * gprime);
  }
}

}  // namespace ctc

using namespace ctc;

// x [M, D] bf16; gamma/beta [D] fp32; w_in [2*inner, D] bf16 (value rows,
// then gate rows); w2T [inner, D] bf16 (W2 transposed); wvgT [D, 2*ldh] bf16
// (Wv^T in columns [0, inner), Wg^T in [ldh, ldh + inner), zeros elsewhere);
// g [M, D] bf16. Workspaces: xn [M, D] bf16, stats [M] float2, dh [M, ldh]
// fp32, hbuf [M, ldh] bf16, dvg [M, 2*ldh] bf16, dxn [M, D] fp32. Outputs:
// dx [M, D] bf16; dgamma, dbeta [D], dw_vg [2*ldh, D] and dw_out [D, inner]
// fp32, zeroed by the caller (atomic sums). ldh >= inner, a multiple of 8.
extern "C" int ctc_geglu_ff_bwd(const void* x, const void* gamma, const void* beta,
                                const void* w_in, const void* w2T, const void* wvgT, const void* g,
                                void* xn, void* stats, void* dh, void* hbuf, void* dvg, void* dxn,
                                void* dx, void* dgamma, void* dbeta, void* dw_vg, void* dw_out,
                                int M, int D, int inner, int ldh, int residual, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xb = (const bf16*)x;
  const bf16* gb = (const bf16*)g;
  ln_rows_kernel<><<<(M + 7) / 8, 256, 0, st>>>(xb, (const float*)gamma, (const float*)beta,
                                                (bf16*)xn, (float2*)stats, M, D);
  launch_gemm_nt<float>(gb, D, (const bf16*)w2T, D, (float*)dh, ldh, M, inner, D, st);
  cudaFuncSetAttribute(ff_bwd_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  dim3 g1((ldh + FF_HALF - 1) / FF_HALF, (M + BM - 1) / BM);
  ff_bwd_gate_kernel<<<g1, THREADS, GEMM_SMEM, st>>>((const bf16*)xn, (const bf16*)w_in,
                                                     (const float*)dh, (bf16*)hbuf, (bf16*)dvg, M,
                                                     D, inner, ldh);
  launch_gemm_nt<float>((const bf16*)dvg, 2 * ldh, (const bf16*)wvgT, 2 * ldh, (float*)dxn, D, M,
                        D, 2 * ldh, st);
  launch_ln_bwd(xb, (const float2*)stats, (const float*)dxn, nullptr, residual ? gb : nullptr,
                (const float*)gamma, (bf16*)dx, (float*)dgamma, (float*)dbeta, M, D, st);
  launch_wgrad(RowMajor{gb, D, M, D}, RowMajor{(const bf16*)hbuf, ldh, M, inner},
               (float*)dw_out, inner, D, inner, M, st);
  launch_wgrad(RowMajor{(const bf16*)dvg, 2 * ldh, M, 2 * ldh}, RowMajor{(const bf16*)xn, D, M, D},
               (float*)dw_vg, D, 2 * ldh, D, M, st);
  return (int)cudaGetLastError();
}
