// PEG: depthwise 3 x 3 x 3 convolution + bias + residual over the token video,
// the port of ct_clip_ut_tpu/ops/pallas_peg.py:peg_fused (`_forward_impl`).
//
//   out[b, t, y, x, c] = round(sum over (dt, dh, dw) of
//       w[dt, dh, dw, c] * x[b, t + dt - front, y + dh - 1, x + dw - 1, c]
//       + bias[c] + x[b, t, y, x, c])
//
// with zeros outside the video, on x [b, t, h, w, c] as the token buffer
// lies in memory (channels last): no NCDHW copy in or out. The 27 products
// and the sum are fp32 from x cast to fp32, the taps [27, c] and the bias are
// fp32, and the result is rounded to x's type once. The frame padding is
// (front, 2 - front): (2, 0) is the causal forward, (1, 1) the centred one,
// (0, 2) the causal form's input gradient (with flipped taps and no bias).
//
// What bounds it on the H100: bytes. One read and one write of the video
// (57 MB at [2, 24, 24, 24, 512] bf16: 17 us at 3.35 TB/s) against 0.76 GFLOP
// of fp32 FMAs (11 us). The TPU kernel pads each frame in VMEM and shifts it
// with sublane rolls; here one thread owns 8 channels of one output position
// and reads its 27 neighbours with 16-B loads (32-B for fp32), which its
// neighbours in the block share through L1 / L2: the channels run fastest
// across threads, so every load and the store coalesce.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ctc_pegk {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(e[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__global__ void __launch_bounds__(256)
peg_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
           T* __restrict__ out, int B, int Tn, int H, int W, int C, int front) {
  const int c8 = C / 8;
  const int64_t total = (int64_t)B * Tn * H * W * c8;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % c8) * 8;
    int64_t pos = idx / c8;
    const int xx = (int)(pos % W);
    pos /= W;
    const int yy = (int)(pos % H);
    pos /= H;
    const int tt = (int)(pos % Tn);
    const int b = (int)(pos / Tn);
    float v[8], wt[8];
    float conv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int dt = 0; dt < 3; ++dt) {
      const int ti = tt + dt - front;
      if (ti < 0 || ti >= Tn) continue;
      for (int dh = 0; dh < 3; ++dh) {
        const int yi = yy + dh - 1;
        if (yi < 0 || yi >= H) continue;
        for (int dw = 0; dw < 3; ++dw) {
          const int xi = xx + dw - 1;
          if (xi < 0 || xi >= W) continue;
          load8(x + ((((int64_t)b * Tn + ti) * H + yi) * W + xi) * C + c, v);
          load8(w + (dt * 9 + dh * 3 + dw) * C + c, wt);
#pragma unroll
          for (int i = 0; i < 8; ++i) conv[i] = fmaf(v[i], wt[i], conv[i]);
        }
      }
    }
    if (bias != nullptr) {
      load8(bias + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) conv[i] += v[i];
    }
    // the centre input is the residual
    load8(x + ((((int64_t)b * Tn + tt) * H + yy) * W + xx) * C + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) conv[i] += v[i];
    store8(out + ((((int64_t)b * Tn + tt) * H + yy) * W + xx) * C + c, conv);
  }
}

}  // namespace ctc_pegk

using namespace ctc_pegk;

// x, out [B, T, H, W, C] bf16 (fp32 with is_fp32), contiguous and 16-B
// aligned; w [27, C] and bias [C] fp32 (bias may be null); C a multiple of 8;
// front in {0, 1, 2} frames of zero padding before the first frame.
extern "C" int ctc_peg(const void* x, const void* w, const void* bias, void* out, int B, int T,
                       int H, int W, int C, int front, int is_fp32, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (C % 8 || front < 0 || front > 2) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * T * H * W * (C / 8);
  const int blocks = (int)((total + 255) / 256 < 132 * 64 ? (total + 255) / 256 : 132 * 64);
  if (is_fp32) {
    peg_kernel<float><<<blocks, 256, 0, st>>>((const float*)x, (const float*)w,
                                              (const float*)bias, (float*)out, B, T, H, W, C, front);
  } else {
    peg_kernel<bf16><<<blocks, 256, 0, st>>>((const bf16*)x, (const float*)w, (const float*)bias,
                                             (bf16*)out, B, T, H, W, C, front);
  }
  return (int)cudaGetLastError();
}
