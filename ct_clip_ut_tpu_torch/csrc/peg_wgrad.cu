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
// What bounds it on the H100: bytes, x and g once (57 MB at [2, 24, 24, 24,
// 512] bf16, 17 us), against 0.79 GFLOP of fp32 FMAs (12 us at 67 TFLOP/s).
// It is a depthwise reduction (no tensor-core product computes it) over all
// 27,648 positions for each of 28 x c outputs. The TPU kernel accumulates
// [32, c] in one VMEM block across its sequential (batch, frame) grid. Here
// the 27 shifted reads of a position come from shared memory, and each x
// value is read there once for its three horizontal taps:
//   - a block owns a slab of 64 channels, one video b, a band of ROWS rows,
//     a segment of at most MAX_SEG columns and a chunk of tc frames: one
//     warp a row of the band, one lane a channel pair;
//   - for each frame t of its chunk it stages with cp.async the x rows its
//     band reads (frames t - front .. t - front + 2, rows and columns with a
//     one-wide halo, zeros outside the video and past C) in a ring of three
//     frame slots, so that moving to t + 1 loads one frame, and g's rows of
//     frame t;
//   - a lane walks its row along x keeping the three columns of its nine
//     (dt, dh) neighbours in registers as a sliding window: 9 shared reads a
//     position for 27 x 2 FMAs, its 28 x 2 sums in fp32 registers across the
//     chunk's frames;
//   - the block adds its warps' sums in row order and writes one partial
//     [28, 64] per slab; a second kernel adds the partials [P, 28, c] in
//     order. No atomics: the same bits on every call.
// At the main shape that is 8 slabs x 32 partials = 256 blocks of 192
// threads, two an SM (96 KB of shared memory each in bf16); the partition
// (tc, the segment width, P) is the wrapper's (ops/peg.py:wgrad_partition).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ctc_pegw {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 6;          // rows of a band: one warp each
constexpr int SLAB = 64;         // channels of a block: a channel pair a lane
constexpr int MAX_SEG = 24;      // columns of a segment at most (fp32: 192 KB staged)
constexpr int TAPS = 28;         // 27 taps in (dt, dh, dw) order, then the bias
constexpr int THREADS = ROWS * 32;

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

// Shared bytes of a block: the x ring [3][ROWS + 2][wseg + 2][SLAB] and g
// [ROWS][wseg][SLAB] in T, or the warps' sums [TAPS][ROWS][SLAB] in fp32
// after the frames, whichever is larger.
inline int smem_bytes(int wseg, int elem) {
  const int stage = (3 * (ROWS + 2) * (wseg + 2) + ROWS * wseg) * SLAB * elem;
  const int red = TAPS * ROWS * SLAB * 4;
  return stage > red ? stage : red;
}

// One position x of a lane's walk: column xi + 2 of the nine neighbour rows
// into window slot (P + 2) % 3, then the 27 products with g and its sum.
// Window slot s holds staged column c with c % 3 == s; xi % 3 == P.
template <int P, typename T>
__device__ __forceinline__ void step(float2 (&win)[3][9], float2 (&acc)[TAPS],
                                     const T* const (&rowp)[9], const T* gp, int xi) {
#pragma unroll
  for (int k = 0; k < 9; ++k) win[(P + 2) % 3][k] = load2(rowp[k] + (xi + 2) * SLAB);
  const float2 gv = load2(gp + xi * SLAB);
  acc[27].x += gv.x;
  acc[27].y += gv.y;
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const float2 xv = win[(P + dw) % 3][k];
      acc[3 * k + dw].x = fmaf(xv.x, gv.x, acc[3 * k + dw].x);
      acc[3 * k + dw].y = fmaf(xv.y, gv.y, acc[3 * k + dw].y);
    }
}

// grid (slabs, P): blockIdx.y = ((b * tchunks + chunk) * bands + band) * segs
// + seg. partial [P, TAPS, C].
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_slab_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partial,
                  int Tn, int H, int W, int C, int front, int tc, int wseg) {
  extern __shared__ __align__(16) char smem[];
  constexpr int CPC = 16 / sizeof(T);              // channels a 16-B copy
  constexpr int CHUNKS = SLAB / CPC;               // 16-B copies a slab
  const int wcols = wseg + 2;
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = xs + 3 * (ROWS + 2) * wcols * SLAB;

  const int segs = (W + wseg - 1) / wseg, bands = (H + ROWS - 1) / ROWS;
  const int tchunks = (Tn + tc - 1) / tc;
  int p = blockIdx.y;
  const int seg = p % segs;
  p /= segs;
  const int band = p % bands;
  p /= bands;
  const int chunk = p % tchunks;
  const int b = p / tchunks;
  const int c0 = blockIdx.x * SLAB, y0 = band * ROWS, x0 = seg * wseg;
  const int ws = min(wseg, W - x0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = chunk * tc, t1 = min(Tn, t0 + tc);

  // x frame fi (zeros outside the video) into ring slot (fi + 3) % 3
  auto stage_x = [&](int fi) {
    T* dst = xs + ((fi + 3) % 3) * (ROWS + 2) * wcols * SLAB;
    const bool frame = fi >= 0 && fi < Tn;
    for (int i = tid; i < (ROWS + 2) * wcols * CHUNKS; i += THREADS) {
      const int ch = i % CHUNKS, col = (i / CHUNKS) % wcols, r = i / (CHUNKS * wcols);
      const int y = y0 - 1 + r, xg = x0 - 1 + col, c = c0 + ch * CPC;
      const bool ok = frame && y >= 0 && y < H && xg >= 0 && xg < W && c < C;
      const T* src = ok ? x + ((((int64_t)b * Tn + fi) * H + y) * W + xg) * C + c : x;
      cp_async16(dst + (r * wcols + col) * SLAB + ch * CPC, src, ok ? 16 : 0);
    }
  };
  auto stage_g = [&](int t) {
    for (int i = tid; i < ROWS * wseg * CHUNKS; i += THREADS) {
      const int ch = i % CHUNKS, col = (i / CHUNKS) % wseg, r = i / (CHUNKS * wseg);
      const int y = y0 + r, xg = x0 + col, c = c0 + ch * CPC;
      const bool ok = y < H && xg < W && c < C;
      const T* src = ok ? g + ((((int64_t)b * Tn + t) * H + y) * W + xg) * C + c : g;
      cp_async16(gs + (r * wseg + col) * SLAB + ch * CPC, src, ok ? 16 : 0);
    }
  };

  float2 acc[TAPS];
#pragma unroll
  for (int i = 0; i < TAPS; ++i) acc[i] = make_float2(0.f, 0.f);

  for (int t = t0; t < t1; ++t) {
    if (t == t0) {
      for (int dt = 0; dt < 3; ++dt) stage_x(t - front + dt);
    } else {
      stage_x(t - front + 2);
    }
    stage_g(t);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (y0 + warp < H) {
      const T* rowp[9];
#pragma unroll
      for (int dt = 0; dt < 3; ++dt)
#pragma unroll
        for (int dh = 0; dh < 3; ++dh)
          rowp[3 * dt + dh] = xs + ((((t - front + dt + 3) % 3) * (ROWS + 2) + warp + dh) * wcols)
                                       * SLAB + 2 * lane;
      const T* gp = gs + warp * wseg * SLAB + 2 * lane;
      float2 win[3][9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        win[0][k] = load2(rowp[k]);
        win[1][k] = load2(rowp[k] + SLAB);
      }
      for (int xi = 0; xi < ws; xi += 3) {
        step<0>(win, acc, rowp, gp, xi);
        if (xi + 1 < ws) step<1>(win, acc, rowp, gp, xi + 1);
        if (xi + 2 < ws) step<2>(win, acc, rowp, gp, xi + 2);
      }
    }
    __syncthreads();
  }

  // the warps' sums added in row order: one partial [TAPS, SLAB] of this slab
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < TAPS; ++i)
    *reinterpret_cast<float2*>(red + (i * ROWS + warp) * SLAB + 2 * lane) = acc[i];
  __syncthreads();
  float* out = partial + (int64_t)blockIdx.y * TAPS * C;
  for (int i = tid; i < TAPS * SLAB; i += THREADS) {
    const int tap = i / SLAB, ch = i % SLAB;
    if (c0 + ch >= C) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < ROWS; ++w) s += red[(tap * ROWS + w) * SLAB + ch];
    out[(int64_t)tap * C + c0 + ch] = s;
  }
}

// dwb [28, C] = the partials summed over P, in order.
__global__ void __launch_bounds__(256)
peg_wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dwb, int P,
                        int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < P; ++k) s += partial[(int64_t)k * n + i];
  dwb[i] = s;
}

template <typename T>
int launch(const void* x, const void* g, float* partial, int B, int T_, int H, int W, int C,
           int front, int tc, int wseg, int P, cudaStream_t st) {
  const int smem = smem_bytes(wseg, sizeof(T));
  cudaFuncSetAttribute(wgrad_slab_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((C + SLAB - 1) / SLAB, P);
  wgrad_slab_kernel<T><<<grid, THREADS, smem, st>>>(static_cast<const T*>(x),
                                                    static_cast<const T*>(g), partial, T_, H, W,
                                                    C, front, tc, wseg);
  return (int)cudaGetLastError();
}

}  // namespace ctc_pegw

using namespace ctc_pegw;

// x, g [B, T, H, W, C] bf16 (fp32 with is_fp32), contiguous, 16-B aligned;
// C a multiple of 8; tc frames a block, columns in segments of wseg <=
// MAX_SEG; partial [P, 28, C] fp32 workspace with P = B ceil(T / tc)
// ceil(H / ROWS) ceil(W / wseg); dwb [28, C] fp32 (rows 0..26 dw in (dt,
// dh, dw) order, row 27 db).
extern "C" int ctc_peg_wgrad(const void* x, const void* g, void* partial, void* dwb, int B, int T,
                             int H, int W, int C, int front, int tc, int wseg, int is_fp32,
                             void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (C % 8 || front < 0 || front > 2 || tc < 1 || wseg < 1 || wseg > MAX_SEG)
    return (int)cudaErrorInvalidValue;
  const int P = B * ((T + tc - 1) / tc) * ((H + ROWS - 1) / ROWS) * ((W + wseg - 1) / wseg);
  float* part = static_cast<float*>(partial);
  int err = is_fp32 ? launch<float>(x, g, part, B, T, H, W, C, front, tc, wseg, P, st)
                    : launch<bf16>(x, g, part, B, T, H, W, C, front, tc, wseg, P, st);
  if (err) return err;
  const int n = TAPS * C;
  peg_wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, static_cast<float*>(dwb), P, n);
  return (int)cudaGetLastError();
}
