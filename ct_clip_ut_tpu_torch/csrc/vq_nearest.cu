// Cosine-codebook nearest neighbour: the port of
// ct_clip_ut_tpu/ops/pallas_vq.py:vq_nearest_pallas (_kernel).
//
// idx[i] = argmax_j <tok_i, cb_j>, fp32 accumulation, the FIRST maximum
// wins; only the int32 indices are written.
//
// What bounds it on the H100: tensor-core FLOPs, 2 * M * C * D (116 GFLOP
// per volume at M = 13824 tokens, C = 8192 codes, D = 512); the [M, C]
// similarity matrix (453 MB fp32 per volume) is never written. The design
// gives each block a tile of 128 token rows and lets it loop over every
// 128-code tile itself, keeping a running (max, argmax) per row in shared
// memory: the loop replaces the TPU kernel's sequential grid axis, so no
// cross-block reduction is needed. Within a tile the lowest index among
// equal maxima wins; across tiles only a strict > replaces the running
// maximum.
#include "gemm_tile.cuh"

namespace ctc {

__global__ void __launch_bounds__(THREADS)
vq_nearest_kernel(const bf16* __restrict__ tok, const bf16* __restrict__ cb,
                  int* __restrict__ idx, int M, int C, int D) {
  extern __shared__ __align__(128) char smem[];
  float* run_max = reinterpret_cast<float*>(smem + GEMM_SMEM);
  int* run_arg = reinterpret_cast<int*>(run_max + BM);
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    run_max[r] = -CUDART_INF_F;
    run_arg[r] = 0;
  }
  const RowMajor ta{tok, D, M, D};
  auto load_a = [&](int r, int k) { return ta.load8(row0 + r, k); };
  const float* Ct = reinterpret_cast<const float*>(smem);

  for (int c0 = 0; c0 < C; c0 += BN) {
    const RowMajor cbt{cb + (int64_t)c0 * D, D, C - c0, D};
    auto load_b = [&](int r, int k) { return cbt.load8(r, k); };
    block_gemm(load_a, load_b, D, smem);
    const int ncol = min(BN, C - c0);
    for (int r = warp; r < BM; r += THREADS / 32) {
      float best = -CUDART_INF_F;
      int arg = 0x7fffffff;
      for (int c = lane; c < ncol; c += 32) {   // increasing c: strict > keeps the first
        float s = Ct[r * LDC + c];
        if (s > best) {
          best = s;
          arg = c;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        float ob = __shfl_xor_sync(0xffffffffu, best, o);
        int oa = __shfl_xor_sync(0xffffffffu, arg, o);
        if (ob > best || (ob == best && oa < arg)) {
          best = ob;
          arg = oa;
        }
      }
      if (lane == 0 && best > run_max[r]) {
        run_max[r] = best;
        run_arg[r] = c0 + arg;
      }
    }
    __syncthreads();  // the next tile's GEMM reuses the shared memory of C
  }
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    if (row0 + r < M) idx[row0 + r] = run_arg[r];
  }
}

}  // namespace ctc

using namespace ctc;

// tok [M, D] bf16, cb [C, D] bf16, idx [M] int32.
extern "C" int ctc_vq_nearest(const void* tok, const void* cb, void* idx, int M, int C, int D,
                              void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem = GEMM_SMEM + BM * 8;
  cudaFuncSetAttribute(vq_nearest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  vq_nearest_kernel<<<(M + BM - 1) / BM, THREADS, smem, st>>>((const bf16*)tok, (const bf16*)cb,
                                                              (int*)idx, M, C, D);
  return (int)cudaGetLastError();
}
