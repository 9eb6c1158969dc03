// GEGLU feed-forward block: the port of
// ct_clip_ut_tpu/ops/pallas_ff.py:geglu_ff_fused (_forward_impl / _kernel).
//
// out = (gelu_erf(xn Wg^T) * (xn Wv^T)) W2^T (+ x),  xn = LN(x) (gamma, beta)
// over N token rows (the CT-ViT FF: D = 512, inner = 1365, N = B * 13824).
//
// What bounds it on the H100: tensor-core FLOPs, 2 * N * 512 * 1365 * 3
// (58 GFLOP per volume per layer); the [N, 1365] hidden tensor is the only
// large intermediate. The design is two launches around the shared GEMM
// tile: (1) the LN prologue feeds the value and gate halves of the first
// projection side by side in one 128-wide tile (64 value + 64 gate columns),
// and the epilogue writes h = gelu(gate) * value rounded to bf16 (the TPU
// kernel's rounding point before W2); (2) h @ W2^T with the residual added
// in fp32. inner = 1365 is not a multiple of 16: the loaders zero the
// ragged tile edge in both GEMMs. gelu uses erff, the exact erf.
#include "gemm_tile.cuh"

namespace ctc {

constexpr int HALF = BN / 2;

__global__ void __launch_bounds__(THREADS)
ff_in_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
             const float* __restrict__ beta, const bf16* __restrict__ w_in,
             bf16* __restrict__ hbuf, int M, int D, int inner, int ldh) {
  extern __shared__ __align__(128) char smem[];
  float2* stats = reinterpret_cast<float2*>(smem + GEMM_SMEM);
  const int n0 = blockIdx.x * HALF;
  const int row0 = blockIdx.y * BM;
  const RowMajor xa{x, D, M, D};
  // tile rows 0..63 -> value rows n0.., 64..127 -> gate rows inner + n0..
  const RowMajor wv{w_in + (int64_t)n0 * D, D, inner - n0, D};
  const RowMajor wg{w_in + (int64_t)(inner + n0) * D, D, inner - n0, D};
  ln_row_stats(xa, row0, 1e-5f, stats);
  __syncthreads();
  auto load_a = [&](int r, int k) {
    return ln_apply8(xa.load8(row0 + r, k), stats[r], gamma, beta, k, D);
  };
  auto load_b = [&](int r, int k) { return r < HALF ? wv.load8(r, k) : wg.load8(r - HALF, k); };
  block_gemm(load_a, load_b, D, smem);

  const float* C = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < BM * HALF; i += THREADS) {
    int r = i / HALF, c = i % HALF;
    int m = row0 + r, n = n0 + c;
    if (m >= M || n >= inner) continue;
    float value = C[r * LDC + c];
    float gate = C[r * LDC + HALF + c];
    float g = 0.5f * gate * (1.0f + erff(gate * 0.7071067811865476f));
    hbuf[(int64_t)m * ldh + n] = __float2bfloat16(g * value);
  }
}

__global__ void __launch_bounds__(THREADS)
ff_out_kernel(const bf16* __restrict__ hbuf, const bf16* __restrict__ w_out,
              const bf16* __restrict__ x, bf16* __restrict__ out, int M, int D, int inner,
              int ldh, int residual) {
  extern __shared__ __align__(128) char smem[];
  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const RowMajor ha{hbuf, ldh, M, inner};
  const RowMajor wb{w_out + (int64_t)n0 * inner, inner, D - n0, inner};
  auto load_a = [&](int r, int k) { return ha.load8(row0 + r, k); };
  auto load_b = [&](int r, int k) { return wb.load8(r, k); };
  block_gemm(load_a, load_b, inner, smem);

  const float* C = reinterpret_cast<const float*>(smem);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    int r = i / BN, c = i % BN;
    int m = row0 + r, n = n0 + c;
    if (m >= M || n >= D) continue;
    float y = C[r * LDC + c];
    if (residual) y += __bfloat162float(x[(int64_t)m * D + n]);
    out[(int64_t)m * D + n] = __float2bfloat16(y);
  }
}

}  // namespace ctc

using namespace ctc;

// x [M, D] bf16; gamma/beta [D] fp32; w_in [2*inner, D] bf16 (value rows
// then gate rows); w_out [D, inner] bf16; hbuf [M, ldh] bf16 workspace
// (ldh >= inner, a multiple of 8); out [M, D] bf16.
extern "C" int ctc_geglu_ff(const void* x, const void* gamma, const void* beta, const void* w_in,
                            const void* w_out, void* hbuf, void* out, int M, int D, int inner,
                            int ldh, int residual, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem_in = GEMM_SMEM + BM * (int)sizeof(float2);
  cudaFuncSetAttribute(ff_in_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_in);
  cudaFuncSetAttribute(ff_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  dim3 g1((inner + HALF - 1) / HALF, (M + BM - 1) / BM);
  ff_in_kernel<<<g1, THREADS, smem_in, st>>>((const bf16*)x, (const float*)gamma,
                                             (const float*)beta, (const bf16*)w_in, (bf16*)hbuf,
                                             M, D, inner, ldh);
  dim3 g2((D + BN - 1) / BN, (M + BM - 1) / BM);
  ff_out_kernel<<<g2, THREADS, GEMM_SMEM, st>>>((const bf16*)hbuf, (const bf16*)w_out,
                                                (const bf16*)x, (bf16*)out, M, D, inner, ldh,
                                                residual);
  return (int)cudaGetLastError();
}
