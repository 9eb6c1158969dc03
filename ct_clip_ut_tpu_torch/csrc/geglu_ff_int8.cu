// W8A8 GEGLU feed-forward block: the port of
// ct_clip_ut_tpu/ops/pallas_ff_int8.py:geglu_ff_int8 (_forward_impl / _kernel).
//
// xn = LN(x) (gamma, beta; fp32, one-pass moments, eps 1e-5)
// xq, rx = per-row int8 of xn          (rx = max(absmax / 127, 1e-8))
// value = (xq Wv^T) rx sv,  gate = (xq Wg^T) rx sg   (int8 x int8 -> int32)
// h = gelu_erf(gate) * value (fp32);  hq, rh = per-row int8 of h over its FULL width
// out = (hq W2^T) rh s2 (+ x in fp32)
// over N token rows (the CT-ViT FF: D = 512, inner 1365 zero-padded to 1376
// when the module is built; N = B * 13824). Weights are int8 codes in the
// nn.Linear layout (out, in), so both operands of each product are read
// along K, the only layout integer wgmma takes; sv, sg, s2 are their fp32
// per-output-row scales.
//
// What bounds it on the H100: int8 tensor-core operations, 2 * N * 512 *
// 1365 * 3 (at 1,979 TOP/s dense: 0.059 ms at N = 27,648), against ~28 MB
// of x and output. Both products run on the int8 path of the Hopper core
// (gemm_sm90.cuh: TMA ring, wgmma m64n128k32 .s32.s8.s8, epilogues from
// registers). The TPU kernel quantises h inside one tile that holds the
// whole inner width; here a tile of the first product sees 64 of its 1,376
// columns, and h's per-row scale needs the whole row. So h goes to memory
// in fp32 and back (304 MB at N = 27,648), four launches:
//   (1) LN + per-row int8 codes of xn, one warp a row held in registers;
//   (2) xq . [Wv; Wg]^T, 64 value and 64 gate columns a tile (the bf16
//       GEGLU's plan): the epilogue computes h in registers and writes it
//       in fp32, hbuf [N, ldh];
//   (3) h's row absmax and int8 codes, one warp a row held in registers;
//   (4) hq . W2^T with the dequant and the residual.
// A chain that keeps no h in memory (the first product run twice, its
// epilogue writing each row's partial absmax, then h's codes) was built
// and measured slower: the product with its erf epilogue costs more than
// the round trip's bytes (PERF.md). Rounding: h in the plain version's
// operation order with every operation rounded on its own (no
// contraction); codes round half to even, as torch.round and jnp.round,
// of the IEEE quotient (code_of); a code differs from the plain version's
// only where LN's or erf's last bit moves x / s across a .5 boundary.
// int32 sums are exact: 1376 * 127^2 < 2^31.
//
// x and out are bf16 (the zero-shot serving path, `ctc_geglu_ff_int8`) or
// fp32 (the fp32 attribution forward on a quantised model,
// `ctc_geglu_ff_int8_f32`): the activation type reaches only the row loads
// of (1) and the residual and store of (4). LN, the codes and both
// products are the same fp32 / int8 math for either type, so an fp32 row's
// codes are those of the plain version's fp32 LN; its residual is added in
// fp32 and stored unrounded.
#include "gemm_sm90.cuh"

namespace ctc {
namespace q8 {

using namespace sm90;

constexpr int HALF = 64;                 // value (and gate) columns of a first-product tile
constexpr int ROW_WARPS = 8;             // rows a block of the row passes

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Two consecutive activations as fp32, and two fp32 values stored as the
// activation type (bf16 rounded to nearest even); c is even.
__device__ __forceinline__ float2 load2(const bf16* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__low2float(v), __high2float(v));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Eight consecutive activations as fp32: one 16-B load of bf16, two of fp32.
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(p);
  *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(p + 4);
}

// The int8 code of v at row scale s (inv = 1 / s): round half to even of
// the IEEE quotient v / s. v * inv lies within 2^-22 |q| of that quotient,
// so it rounds to the same integer unless it falls within 2^-20 (|q| + 1)
// of a .5 boundary; there the quotient itself is taken.
__device__ __forceinline__ int8_t code_of(float v, float s, float inv) {
  const float q = __fmul_rn(v, inv), n = rintf(q);
  if (fabsf(fabsf(q - n) - 0.5f) > 9.5367431640625e-07f * (fabsf(q) + 1.0f)) return (int8_t)n;
  return (int8_t)__float2int_rn(v / s);
}

// h = gelu_erf(gate) * value of one value / gate pair of int32 sums, each
// operation rounded on its own: the plain version's (C rx) sv, 0.5 gate
// (1 + erf(gate / sqrt 2)) value.
__device__ __forceinline__ float geglu_h(int cv, int cg, float rs, float svn, float sgn) {
  const float value = __fmul_rn(__fmul_rn((float)cv, rs), svn);
  const float gate = __fmul_rn(__fmul_rn((float)cg, rs), sgn);
  const float e = erff(__fmul_rn(gate, 0.7071067811865476f));
  return __fmul_rn(__fmul_rn(__fmul_rn(0.5f, gate), __fadd_rn(1.0f, e)), value);
}

// The first product: A = xq (map 0); value rows nt * 64 ... of map 1, gate
// rows of map 2. A thread holds value column c in acc[4j + 2hf + e] and gate
// column c in acc[4(j + 8) + 2hf + e].
struct GegluPlan8 {
  static constexpr bool S8 = true;
  __device__ TileSrc src(int nt) const { return {0, 1, nt * HALF, 2, nt * HALF}; }
};

// The second product: A = hq (map 0), B = w2 (map 1).
struct LinearPlan8 {
  static constexpr bool S8 = true;
  __device__ TileSrc src(int nt) const { return {0, 1, nt * BN, 1, nt * BN + 64}; }
};

// (2) h [M, ldh] in fp32, columns nt * 64 ..., two a store (c is even and
// ldh a multiple of 16).
struct HEpi {
  const float* rx;
  const float* sv;
  const float* sg;
  float* h;
  int M, ldh;
  __device__ void operator()(const int (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
    float rs[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) rs[hf] = row + g + 8 * hf < M ? rx[row + g + 8 * hf] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = nt * HALF + 8 * j + 2 * t;
      if (c >= ldh) continue;
      const float2 svn = *reinterpret_cast<const float2*>(sv + c);
      const float2 sgn = *reinterpret_cast<const float2*>(sg + c);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = row + g + 8 * hf;
        if (m >= M) continue;
        const int* av = acc + 4 * j + 2 * hf;
        const int* ag = acc + 4 * (j + 8) + 2 * hf;
        *reinterpret_cast<float2*>(h + (int64_t)m * ldh + c) =
            make_float2(geglu_h(av[0], ag[0], rs[hf], svn.x, sgn.x),
                        geglu_h(av[1], ag[1], rs[hf], svn.y, sgn.y));
      }
    }
  }
};

// (4) out = (C rh) s2 (+ x in fp32), stored as T (bf16 rounded, fp32 as
// it is), two columns a store: c is even and D a multiple of 16, so each
// store is 4-B (bf16) or 8-B (fp32) aligned whatever the row.
template <class T>
struct OutEpi {
  const float* rh;
  const float* s2;
  const T* x;
  T* out;
  int M, D, residual;
  __device__ void operator()(const int (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = row + g + 8 * hf;
      if (m >= M) continue;
      const float r = rh[m];
      const int64_t base = (int64_t)m * D;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = nt * BN + 8 * j + 2 * t;
        if (c >= D) continue;
        float y0 = __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * hf], r), s2[c]);
        float y1 = __fmul_rn(__fmul_rn((float)acc[4 * j + 2 * hf + 1], r), s2[c + 1]);
        if (residual) {
          const float2 xv = load2(x + base + c);
          y0 = __fadd_rn(y0, xv.x);
          y1 = __fadd_rn(y1, xv.y);
        }
        store2(out + base + c, y0, y1);
      }
    }
  }
};

// (1) LN of each row of x [M, D] (D a multiple of 16, at most 256 XCH)
// and its per-row int8 codes: one warp a row, lane l holding columns [256 i
// + 8 l, + 8) in registers (16-B loads, 8-B stores, a warp's 512 B of bf16
// or 1 KB of fp32 in a row). xq [M, D] int8, rx [M]. XCH, the 256-column
// chunks of a row, is a template argument so that a row takes the
// registers it needs; T, the activation type, changes only the loads.
constexpr int MAX_XCH = 8;               // D <= 2048
template <class T, int XCH>
__global__ void __launch_bounds__(ROW_WARPS * 32)
quant_x_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, int8_t* __restrict__ xq, float* __restrict__ rx,
               int M, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * ROW_WARPS + warp;
  if (m >= M) return;
  const T* xr = x + (int64_t)m * D;
  float v[XCH][8];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < XCH; ++c) {
    const int k = c * 256 + lane * 8;
    if (k < D) {
      load8(xr + k, v[c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s += v[c][i];
        s2 += v[c][i] * v[c][i];
      }
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  // the plain version's operations one by one, none contracted into an FMA
  const float mean = s / (float)D;
  const float var = fmaxf(__fsub_rn(s2 / (float)D, __fmul_rn(mean, mean)), 0.f);
  const float rstd = 1.0f / sqrtf(var + 1e-5f);
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < XCH; ++c) {
    const int k = c * 256 + lane * 8;
    if (k < D) {
      float gm[8], bt[8];
      *reinterpret_cast<float4*>(gm) = *reinterpret_cast<const float4*>(gamma + k);
      *reinterpret_cast<float4*>(gm + 4) = *reinterpret_cast<const float4*>(gamma + k + 4);
      *reinterpret_cast<float4*>(bt) = *reinterpret_cast<const float4*>(beta + k);
      *reinterpret_cast<float4*>(bt + 4) = *reinterpret_cast<const float4*>(beta + k + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[c][i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[c][i], mean), rstd), gm[i]), bt[i]);
        amax = fmaxf(amax, fabsf(v[c][i]));
      }
    }
  }
  const float sc = fmaxf(warp_max(amax) / 127.f, 1e-8f), inv = 1.0f / sc;
#pragma unroll
  for (int c = 0; c < XCH; ++c) {
    const int k = c * 256 + lane * 8;
    if (k < D) {
      uint2 u;
      int8_t* q = reinterpret_cast<int8_t*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = code_of(v[c][i], sc, inv);
      *reinterpret_cast<uint2*>(xq + (int64_t)m * D + k) = u;
    }
  }
  if (lane == 0) rx[m] = sc;
}

// (3) h's row absmax and int8 codes: one warp a row of hbuf [M, ldh]
// (ldh a multiple of 16, at most 128 HCH), lane l holding columns [128 i +
// 4 l, + 4) in registers. hq [M, ldh] int8, rh [M].
constexpr int MAX_HCH = 32;              // ldh <= 4096
template <int HCH>
__global__ void __launch_bounds__(ROW_WARPS * 32)
quant_h_kernel(const float* __restrict__ h, int8_t* __restrict__ hq, float* __restrict__ rh,
               int M, int ldh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * ROW_WARPS + warp;
  if (m >= M) return;
  const float* hr = h + (int64_t)m * ldh;
  float4 v[HCH];
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < HCH; ++c) {
    const int k = c * 128 + lane * 4;
    if (k < ldh) {
      v[c] = *reinterpret_cast<const float4*>(hr + k);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[c].x), fabsf(v[c].y)),
                               fmaxf(fabsf(v[c].z), fabsf(v[c].w))));
    }
  }
  const float sc = fmaxf(warp_max(amax) / 127.f, 1e-8f), inv = 1.0f / sc;
#pragma unroll
  for (int c = 0; c < HCH; ++c) {
    const int k = c * 128 + lane * 4;
    if (k < ldh) {
      char4 q;
      q.x = code_of(v[c].x, sc, inv);
      q.y = code_of(v[c].y, sc, inv);
      q.z = code_of(v[c].z, sc, inv);
      q.w = code_of(v[c].w, sc, inv);
      *reinterpret_cast<char4*>(hq + (int64_t)m * ldh + k) = q;
    }
  }
  if (lane == 0) rh[m] = sc;
}

// A row pass over M rows, ROW_WARPS a block; returns the launch's error.
template <class... Params, class... Args>
int launch_rows(void (*kernel)(Params...), int M, cudaStream_t st, Args... args) {
  kernel<<<(M + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace q8
}  // namespace ctc

using namespace ctc::sm90;
namespace q8 = ctc::q8;

namespace {

// The four launches of either activation type T (see the C entries).
template <class T>
int geglu_ff_int8_chain(const void* x, const void* gamma, const void* beta, const void* wv,
                        const void* wg, const void* w2, const void* sv, const void* sg,
                        const void* s2, void* xq, void* rx, void* hbuf, void* hq, void* rh,
                        void* out, int M, int D, int ldh, int residual, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D % 16 || D > q8::MAX_XCH * 256 || ldh % 16 || ldh > q8::MAX_HCH * 128)
    return (int)cudaErrorInvalidValue;
  Maps in{}, outm{};
  int err = map_a8(&in.m[0], xq, M, D, D);
  if (!err) err = map_b8(&in.m[1], wv, ldh, D, D);
  if (!err) err = map_b8(&in.m[2], wg, ldh, D, D);
  if (!err) err = map_a8(&outm.m[0], hq, M, ldh, ldh);
  if (!err) err = map_b8(&outm.m[1], w2, D, ldh, ldh);
  if (err) return err;
  const int xch = (D + 255) / 256, hch = (ldh + 127) / 128;
  err = q8::launch_rows(xch <= 1   ? q8::quant_x_kernel<T, 1>
                        : xch <= 2 ? q8::quant_x_kernel<T, 2>
                        : xch <= 4 ? q8::quant_x_kernel<T, 4>
                                   : q8::quant_x_kernel<T, q8::MAX_XCH>,
                        M, st, static_cast<const T*>(x), static_cast<const float*>(gamma),
                        static_cast<const float*>(beta), static_cast<int8_t*>(xq),
                        static_cast<float*>(rx), M, D);
  if (err) return err;
  err = launch_gemm(in, q8::GegluPlan8{},
                    q8::HEpi{static_cast<const float*>(rx), static_cast<const float*>(sv),
                             static_cast<const float*>(sg), static_cast<float*>(hbuf), M, ldh},
                    (ldh + q8::HALF - 1) / q8::HALF, M, D, st);
  if (err) return err;
  err = q8::launch_rows(hch <= 8    ? q8::quant_h_kernel<8>
                        : hch <= 12 ? q8::quant_h_kernel<12>
                        : hch <= 16 ? q8::quant_h_kernel<16>
                                    : q8::quant_h_kernel<q8::MAX_HCH>,
                        M, st, static_cast<const float*>(hbuf), static_cast<int8_t*>(hq),
                        static_cast<float*>(rh), M, ldh);
  if (err) return err;
  return launch_gemm(outm, q8::LinearPlan8{},
                     q8::OutEpi<T>{static_cast<const float*>(rh), static_cast<const float*>(s2),
                                   static_cast<const T*>(x), static_cast<T*>(out), M, D,
                                   residual},
                     (D + BN - 1) / BN, M, ldh, st);
}

}  // namespace

// x [M, D] bf16 (D a multiple of 16, at most 2048); gamma/beta [D] fp32;
// wv/wg [ldh, D] and w2 [D, ldh] int8 (ldh, the padded inner width, a
// multiple of 16, at most 4096; padded rows / columns zero); sv/sg [ldh],
// s2 [D] fp32; workspaces xq [M, D] int8, rx [M] fp32, hbuf [M, ldh] fp32,
// hq [M, ldh] int8, rh [M] fp32; out [M, D] bf16. Every pointer 16-B
// aligned. Returns 0, an ERR_ code of gemm_sm90.cuh, or cudaGetLastError()
// after the launches.
extern "C" int ctc_geglu_ff_int8(const void* x, const void* gamma, const void* beta,
                                 const void* wv, const void* wg, const void* w2, const void* sv,
                                 const void* sg, const void* s2, void* xq, void* rx, void* hbuf,
                                 void* hq, void* rh, void* out, int M, int D, int ldh,
                                 int residual, void* stream) {
  return geglu_ff_int8_chain<bf16>(x, gamma, beta, wv, wg, w2, sv, sg, s2, xq, rx, hbuf, hq, rh,
                                   out, M, D, ldh, residual, stream);
}

// The same with x and out [M, D] fp32.
extern "C" int ctc_geglu_ff_int8_f32(const void* x, const void* gamma, const void* beta,
                                     const void* wv, const void* wg, const void* w2,
                                     const void* sv, const void* sg, const void* s2, void* xq,
                                     void* rx, void* hbuf, void* hq, void* rh, void* out, int M,
                                     int D, int ldh, int residual, void* stream) {
  return geglu_ff_int8_chain<float>(x, gamma, beta, wv, wg, w2, sv, sg, s2, xq, rx, hbuf, hq,
                                    rh, out, M, D, ldh, residual, stream);
}
