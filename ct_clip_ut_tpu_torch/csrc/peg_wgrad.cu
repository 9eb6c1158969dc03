// PEG weight and bias gradients: the port of
// ct_clip_ut_tpu/ops/pallas_peg_bwd.py:peg_weight_grads.
//
//   dw[dt, dh, dw, c] = sum over (b, t, y, x) of
//       x[b, t + dt - front, y + dh - 1, x + dw - 1, c] * g[b, t, y, x, c]
//   db[c] = sum over (b, t, y, x) of g[b, t, y, x, c]
//
// with zeros outside the video, products and sums in fp32 from bf16 (or fp32)
// x and g, both [b, t, h, w, c] channels last.
//
// What bounds it on the H100: about even, bytes (x and g once: 57 MB at
// [2, 24, 24, 24, 512] bf16, 17 us) against 0.79 GFLOP of fp32 FMAs (12 us).
// It is a reduction over all 27,648 positions for each of 28 x c outputs.
// The TPU kernel accumulates [32, c] in one VMEM block across its sequential
// (batch, frame) grid. Here a thread owns 4 channels and a contiguous chunk
// of positions and keeps its 27 x 4 + 4 sums in registers (the 27 shifted
// reads of x hit L1 / L2: neighbouring positions share them); each chunk
// writes its sums to a partials buffer [chunks, 28, c], and a second kernel
// adds the chunks in a fixed order. No atomics: the sums are the same from
// run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ctc_pegw {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// grid (ceil(C / 4 / 128), chunks); partial [chunks, 28, C]: rows 0..26 the
// taps in (dt, dh, dw) order, row 27 the bias.
template <typename T>
__global__ void __launch_bounds__(128)
peg_wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         float* __restrict__ partial, int B, int Tn, int H, int W, int C,
                         int front, int chunk) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (c >= C) return;
  const int64_t npos = (int64_t)B * Tn * H * W;
  const int64_t p0 = (int64_t)blockIdx.y * chunk;
  const int64_t p1 = p0 + chunk < npos ? p0 + chunk : npos;
  float4 acc[28];
#pragma unroll
  for (int i = 0; i < 28; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t p = p0; p < p1; ++p) {
    int64_t pos = p;
    const int xx = (int)(pos % W);
    pos /= W;
    const int yy = (int)(pos % H);
    pos /= H;
    const int tt = (int)(pos % Tn);
    const int b = (int)(pos / Tn);
    const float4 gv = load4(g + p * C + c);
    acc[27].x += gv.x;
    acc[27].y += gv.y;
    acc[27].z += gv.z;
    acc[27].w += gv.w;
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
      const int ti = tt + dt - front;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const int yi = yy + dh - 1;
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const int xi = xx + dw - 1;
          if (ti < 0 || ti >= Tn || yi < 0 || yi >= H || xi < 0 || xi >= W) continue;
          const float4 xv = load4(x + ((((int64_t)b * Tn + ti) * H + yi) * W + xi) * C + c);
          float4& a = acc[dt * 9 + dh * 3 + dw];
          a.x = fmaf(xv.x, gv.x, a.x);
          a.y = fmaf(xv.y, gv.y, a.y);
          a.z = fmaf(xv.z, gv.z, a.z);
          a.w = fmaf(xv.w, gv.w, a.w);
        }
      }
    }
  }
  float* out = partial + (int64_t)blockIdx.y * 28 * C + c;
#pragma unroll
  for (int i = 0; i < 28; ++i) *reinterpret_cast<float4*>(out + (int64_t)i * C) = acc[i];
}

// dwb [28, C] = the partials summed over the chunks, in order.
__global__ void __launch_bounds__(256)
peg_wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dwb, int chunks,
                        int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += partial[(int64_t)k * n + i];
  dwb[i] = s;
}

}  // namespace ctc_pegw

using namespace ctc_pegw;

// x, g [B, T, H, W, C] bf16 (fp32 with is_fp32), contiguous, 16-B aligned;
// partial [chunks, 28, C] fp32 workspace; dwb [28, C] fp32 (rows 0..26 dw in
// (dt, dh, dw) order, row 27 db). C a multiple of 4; chunks * chunk >= B T H W.
extern "C" int ctc_peg_wgrad(const void* x, const void* g, void* partial, void* dwb, int B, int T,
                             int H, int W, int C, int front, int chunks, int chunk, int is_fp32,
                             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (C % 4 || front < 0 || front > 2 || (int64_t)chunks * chunk < (int64_t)B * T * H * W)
    return (int)cudaErrorInvalidValue;
  dim3 grid((C / 4 + 127) / 128, chunks);
  if (is_fp32) {
    peg_wgrad_partial_kernel<float><<<grid, 128, 0, st>>>(
        (const float*)x, (const float*)g, (float*)partial, B, T, H, W, C, front, chunk);
  } else {
    peg_wgrad_partial_kernel<bf16><<<grid, 128, 0, st>>>(
        (const bf16*)x, (const bf16*)g, (float*)partial, B, T, H, W, C, front, chunk);
  }
  const int n = 28 * C;
  peg_wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>((const float*)partial, (float*)dwb,
                                                           chunks, n);
  return (int)cudaGetLastError();
}
