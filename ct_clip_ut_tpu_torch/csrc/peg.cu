// PEG: depthwise 3 x 3 x 3 convolution + bias + residual over the token video,
// the port of ct_clip_ut_tpu/ops/pallas_peg.py:peg_fused (`_forward_impl`).
//
//   out[b, t, y, x, c] = round(sum over (dt, dh, dw) of
//       w[dt, dh, dw, c] * x[b, t + dt - front, y + dh - 1, x + dw - 1, c]
//       + bias[c] + x[b, t, y, x, c])
//
// with zeros outside the video, on x [b, t, h, w, c] as the token buffer
// lies in memory (channels last): no NCDHW copy in or out. The 27 products
// and the sum are fp32 from x cast to fp32, in tap order, the taps [27, c]
// and the bias are fp32, and the result is rounded to x's type once. The
// frame padding is (front, 2 - front): (2, 0) is the causal forward, (1, 1)
// the centred one, (0, 2) the causal form's input gradient (with flipped
// taps and no bias).
//
// What bounds it on the H100: bytes. One read and one write of the video
// (57 MB at [2, 24, 24, 24, 512] bf16: 17 us at 3.35 TB/s) against 0.76 GFLOP
// of fp32 FMAs (11 us at 67 TFLOP/s), to which the bf16 -> fp32 conversions
// and the shared-memory reads add instructions of their own. The TPU kernel
// pads each frame in VMEM and shifts it with sublane rolls. Here, as in
// peg_wgrad.cu:
//   - a block owns a slab of 64 channels, one video b, a band of `rows` rows
//     (one warp each, one lane a channel pair; 12 in bf16), a segment of at
//     most MAX_SEG columns and a chunk of tc output frames, and walks the
//     frames in order;
//   - it stages each input frame's (rows + 2) x (segment + 2) x 64 tile once
//     with cp.async (a zero source size fills the halo, the frames outside
//     the video and the channels past C with zeros) into a ring of SLOTS
//     frame slots: the three frames an output frame reads and the next one,
//     whose copy overlaps this frame's products. A chunk starts with a
//     three-frame warm-up, so each frame of x is read from HBM about once
//     and from L2 (rows + 2) / rows times (7/6 at 12 rows);
//   - the lane's 27 x 2 taps and its bias sit in registers for the whole
//     block;
//   - a lane walks its row along x keeping the three columns of its nine
//     (dt, dh) neighbour rows in registers as a sliding window: 9 shared
//     reads a position for 27 x 2 FMAs; the centre input (the residual) is
//     in the window; a warp stores 128 B of a position at once.
// The partition (rows, tc, the segment width) is the wrapper's
// (ops/peg.py:stencil_partition): at the main shape 8 slabs x 2 videos x 2
// bands x 4 chunks of 6 frames = 128 blocks of 384 threads, one an SM (182
// KB of shared memory in bf16). Two blocks an SM of 6-row bands (104 KB
// each) ran slower on the H100: the taller band stages fewer halo rows and
// its warm-up fewer bytes, with as many warps an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace ctc_pegk {

using bf16 = __nv_bfloat16;

constexpr int SLAB = 64;         // channels of a block: a channel pair a lane
constexpr int MAX_SEG = 24;      // columns of a segment at most
constexpr int SLOTS = 4;         // frame slots of the ring
constexpr int THREADS = 12 * 32; // the most a block has: a warp a row
// Rows of a band at most: 12 in bf16, 6 in fp32, whose staged frames take
// twice the bytes.
template <typename T>
__host__ __device__ constexpr int max_rows() {
  return sizeof(T) == 2 ? 12 : 6;
}
// A slot's tile rows are ROW elements apart and the slots SLOT<T>()
// elements, whatever the band and segment: the nine neighbour rows of a
// lane then lie at compile-time offsets from three bases, one a frame.
constexpr int ROW = (MAX_SEG + 2) * SLAB;
template <typename T>
__host__ __device__ constexpr int SLOT() {
  return (max_rows<T>() + 2) * ROW;
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

// 182 KB in bf16, 208 KB in fp32: one block an SM
template <typename T>
constexpr int smem_bytes() {
  return SLOTS * SLOT<T>() * (int)sizeof(T);
}

// Output column x + P of a lane's walk, col[dt] pointing at staged column x
// (a multiple of 3) of frame dt's slot in the lane's top neighbour row:
// column x + P + 2 of the nine neighbour rows into window slot (P + 2) % 3,
// the 27 products in tap order, the bias, the centre input, one store to
// `outp`. Window slot s holds the staged column c with c % 3 == s.
template <int P, int FRONT, typename T>
__device__ __forceinline__ void step(float2 (&win)[3][9], const float2 (&tap)[27], float2 bv,
                                     bool has_bias, const T* const (&col)[3], T* outp) {
#pragma unroll
  for (int dt = 0; dt < 3; ++dt)
#pragma unroll
    for (int dh = 0; dh < 3; ++dh)
      win[(P + 2) % 3][3 * dt + dh] = load2(col[dt] + dh * ROW + (P + 2) * SLAB);
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const float2 xv = win[(P + dw) % 3][k];
      acc.x = fmaf(xv.x, tap[3 * k + dw].x, acc.x);
      acc.y = fmaf(xv.y, tap[3 * k + dw].y, acc.y);
    }
  if (has_bias) {
    acc.x += bv.x;
    acc.y += bv.y;
  }
  const float2 centre = win[(P + 1) % 3][3 * FRONT + 1];
  acc.x += centre.x;
  acc.y += centre.y;
  store2(outp, acc);
}

// grid (slabs, B * tchunks * bands * segs): blockIdx.y = ((b * tchunks +
// chunk) * bands + band) * segs + seg; blockDim rows * 32.
template <typename T, int FRONT>
__global__ void __launch_bounds__(THREADS, 1)
peg_slab_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, T* __restrict__ out, int Tn, int H, int W, int C,
                int rows, int tc, int wseg) {
  extern __shared__ __align__(16) char smem[];
  constexpr int CPC = 16 / sizeof(T);              // channels a 16-B copy
  constexpr int CHUNKS = SLAB / CPC;               // 16-B copies a slab
  const int wcols = wseg + 2;
  T* xs = reinterpret_cast<T*>(smem);

  const int segs = (W + wseg - 1) / wseg, bands = (H + rows - 1) / rows;
  const int tchunks = (Tn + tc - 1) / tc;
  int p = blockIdx.y;
  const int seg = p % segs;
  p /= segs;
  const int band = p % bands;
  p /= bands;
  const int chunk = p % tchunks;
  const int b = p / tchunks;
  const int c0 = blockIdx.x * SLAB, y0 = band * rows, x0 = seg * wseg;
  const int ws = min(wseg, W - x0);
  const int tid = threadIdx.x, nthreads = rows * 32, warp = tid >> 5, lane = tid & 31;
  const int t0 = chunk * tc, t1 = min(Tn, t0 + tc);

  // x frame fi (zeros outside the video) into ring slot (fi + SLOTS) % SLOTS:
  // a thread copies one 16-B piece of each of its tile positions, walking
  // (row, column) by nthreads / CHUNKS positions at a time
  const int ch = tid % CHUNKS, pstep = nthreads / CHUNKS, c = c0 + ch * CPC;
  auto stage = [&](int fi) {
    T* dst = xs + ((fi + SLOTS) % SLOTS) * SLOT<T>() + ch * CPC;
    const bool ok_tc = fi >= 0 && fi < Tn && c < C;
    const T* frame = x + (((int64_t)b * Tn + fi) * H) * W * C + c;
    int r = (tid / CHUNKS) / wcols, col = (tid / CHUNKS) % wcols;
    for (int pos = tid / CHUNKS; pos < (rows + 2) * wcols; pos += pstep) {
      const int y = y0 - 1 + r, xg = x0 - 1 + col;
      const bool ok = ok_tc && y >= 0 && y < H && xg >= 0 && xg < W;
      cp_async16(dst + r * ROW + col * SLAB, ok ? frame + ((int64_t)y * W + xg) * C : x,
                 ok ? 16 : 0);
      col += pstep;
      while (col >= wcols) {
        col -= wcols;
        ++r;
      }
    }
  };
  auto commit = [] { asm volatile("cp.async.commit_group;" ::: "memory"); };

  // the lane's channel pair: taps and bias for the whole block
  const int cl = c0 + 2 * lane;
  const bool live = cl < C;
  float2 tap[27];
#pragma unroll
  for (int k = 0; k < 27; ++k)
    tap[k] = live ? *reinterpret_cast<const float2*>(w + k * C + cl) : make_float2(0.f, 0.f);
  const bool has_bias = bias != nullptr;
  const float2 bv = has_bias && live ? *reinterpret_cast<const float2*>(bias + cl)
                                     : make_float2(0.f, 0.f);

  // warm-up: the three frames output frame t0 reads, then the next one
  for (int dt = 0; dt < 3; ++dt) stage(t0 - FRONT + dt);
  commit();
  if (t0 + 1 < t1) stage(t0 - FRONT + 3);
  commit();
  const int y = y0 + warp;
  for (int t = t0; t < t1; ++t) {
    // every group but the newest (frame t - FRONT + 3, in flight) is here
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    if (y < H && live) {
      // col[dt]: the lane's row `warp` of frame t - FRONT + dt, at the walk's
      // column; the rows below it are ROW and 2 ROW further
      const T* col[3];
#pragma unroll
      for (int dt = 0; dt < 3; ++dt)
        col[dt] = xs + ((t - FRONT + dt + SLOTS) % SLOTS) * SLOT<T>() + warp * ROW + 2 * lane;
      T* outp = out + ((((int64_t)b * Tn + t) * H + y) * W + x0) * C + cl;
      float2 win[3][9];
#pragma unroll
      for (int dt = 0; dt < 3; ++dt)
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          win[0][3 * dt + dh] = load2(col[dt] + dh * ROW);
          win[1][3 * dt + dh] = load2(col[dt] + dh * ROW + SLAB);
        }
      for (int xi = 0; xi < ws; xi += 3) {
        step<0, FRONT>(win, tap, bv, has_bias, col, outp);
        if (xi + 1 < ws) step<1, FRONT>(win, tap, bv, has_bias, col, outp + C);
        if (xi + 2 < ws) step<2, FRONT>(win, tap, bv, has_bias, col, outp + 2 * C);
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) col[dt] += 3 * SLAB;
        outp += 3 * C;
      }
    }
    __syncthreads();
    // frame t - FRONT is read: its slot takes frame t - FRONT + 4 (read
    // from output frame t + 2 on)
    if (t + 2 < t1) stage(t - FRONT + 4);
    commit();
  }
}

template <typename T, int FRONT>
int launch(const void* x, const float* w, const float* bias, void* out, int B, int T_, int H,
           int W, int C, int rows, int tc, int wseg, cudaStream_t st) {
  const int smem = smem_bytes<T>();
  // the shared-memory attribute is set once a device for each instance, not
  // on every launch (a train step launches the stencil 16 times)
  static std::atomic<uint64_t> set_on{0};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(set_on.load(std::memory_order_relaxed) & bit)) {
    err = (int)cudaFuncSetAttribute(peg_slab_kernel<T, FRONT>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    set_on.fetch_or(bit, std::memory_order_relaxed);
  }
  const int parts = B * ((T_ + tc - 1) / tc) * ((H + rows - 1) / rows) * ((W + wseg - 1) / wseg);
  dim3 grid((C + SLAB - 1) / SLAB, parts);
  peg_slab_kernel<T, FRONT><<<grid, rows * 32, smem, st>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(out), T_, H, W, C, rows, tc, wseg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_front(const void* x, const float* w, const float* bias, void* out, int B, int T_,
                 int H, int W, int C, int front, int rows, int tc, int wseg, cudaStream_t st) {
  switch (front) {
    case 0: return launch<T, 0>(x, w, bias, out, B, T_, H, W, C, rows, tc, wseg, st);
    case 1: return launch<T, 1>(x, w, bias, out, B, T_, H, W, C, rows, tc, wseg, st);
    default: return launch<T, 2>(x, w, bias, out, B, T_, H, W, C, rows, tc, wseg, st);
  }
}

}  // namespace ctc_pegk

using namespace ctc_pegk;

// x, out [B, T, H, W, C] bf16 (fp32 with is_fp32), contiguous and 16-B
// aligned; w [27, C] and bias [C] fp32 (bias may be null); C a multiple of 8;
// front in {0, 1, 2} frames of zero padding before the first frame; bands
// of rows <= max_rows rows (12 in bf16, 6 in fp32), chunks of tc frames,
// column segments of wseg <= MAX_SEG (ops/peg.py:stencil_partition).
extern "C" int ctc_peg(const void* x, const void* w, const void* bias, void* out, int B, int T,
                       int H, int W, int C, int front, int rows, int tc, int wseg, int is_fp32,
                       void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (C % 8 || front < 0 || front > 2 || rows < 1 || rows > (is_fp32 ? 6 : 12) || tc < 1 ||
      wseg < 1 || wseg > MAX_SEG)
    return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  return is_fp32 ? launch_front<float>(x, wf, bf, out, B, T, H, W, C, front, rows, tc, wseg, st)
                 : launch_front<bf16>(x, wf, bf, out, B, T, H, W, C, front, rows, tc, wseg, st);
}
