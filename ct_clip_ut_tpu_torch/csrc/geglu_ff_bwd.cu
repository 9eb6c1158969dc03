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
// intermediates (h, dvalue | dgate, xn; 75 MB each at B = 2) and fp32 dh go
// through global memory between launches, and every product runs on the
// Hopper core (gemm_sm90.cuh, wgmma from TMA-fed rings). Five launches:
//   ln_rows_kernel       xn = LN(x) gamma + beta (bf16), (mean, rstd)
//   gate_bwd_kernel      [value | gate] = xn [Wv | Wg]^T, 64 value columns
//                        paired with the 64 gate columns of the same inner
//                        columns (as geglu_ff.cu's forward pairs them), and
//                        dh = g W2 of those columns in a second K loop of
//                        the same block; the epilogue writes h and dvalue |
//                        dgate (bf16) from the registers (dh is never
//                        stored: an epilogue that read it back from memory
//                        took 0.51 ms of a 1.33 ms call)
//   gemm_kernel          dxn = dvalue Wv + dgate Wg (fp32; K = 2 ldh)
//   ln_bwd_rows_kernel   dx, dgamma, dbeta
//   wgrad_kernel         dW2 = g^T h and dWv | dWg = (dvalue | dgate)^T xn in
//                        one launch (wgrad_sm90.cuh: MN-major operands, one
//                        block a 128 x 128 tile summing all M rows in order:
//                        4 x 11 tiles of dW2, 22 x 4 of dWv | dWg, 132 in
//                        all; no atomics, the same bits every call)
#include "bwd_common.cuh"
#include "wgrad_sm90.cuh"

namespace ctc {
namespace ffb {

// the Hopper core's pieces, named one by one: a using-directive would make
// them clash with gemm_tile.cuh's tile constants in namespace ctc
using sm90::A_BYTES;
using sm90::B_HALF_BYTES;
using sm90::BK;
using sm90::BM;
using sm90::CONSUMER_WARPS;
using sm90::Maps;
using sm90::STAGE_BYTES;
using sm90::THREADS;
using sm90::desc_sw128;
using sm90::fence_regs;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::tma_load_2d;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_m64n128k16;
using sm90::wgmma_wait_all;

// d[32] += A (64 x 16, desc a) . B (64 x 16, desc b)^T, both K-major
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// From value (acc[j], j < 32), gate (acc[j + 32]) and dh (dh[j]) of inner
// columns nt * 64 ... (one wgmma D layout): h = gelu(gate) value into hbuf
// [M, ldh], dvalue = dh gelu(gate) and dgate = dh value gelu'(gate) into
// dvg [M, 2 ldh] at columns c and ldh + c, bf16; columns in [inner, ldh)
// get zeros (the later products read them).
struct GateBwdEpi {
  bf16* hbuf;
  bf16* dvg;
  int M, inner, ldh;
  __device__ void operator()(const float (&acc)[64], const float (&dh)[32], int row, int nt,
                             int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = row + g + 8 * hf;
      if (m >= M) continue;
      const int64_t hrow = (int64_t)m * ldh, drow = (int64_t)m * 2 * ldh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = nt * 64 + 8 * j + 2 * t;     // even; ldh a multiple of 8
        if (c >= ldh) continue;
        float hv[2] = {0.f, 0.f}, dv[2] = {0.f, 0.f}, dg[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e < inner) {
            const float value = acc[4 * j + 2 * hf + e];
            const float gate = acc[4 * (j + 8) + 2 * hf + e];
            const float d = dh[4 * j + 2 * hf + e];
            const float cdf = 0.5f * (1.0f + erff(gate * 0.7071067811865476f));
            const float gel = gate * cdf;
            const float gprime = cdf + gate * 0.3989422804014327f * expf(-0.5f * gate * gate);
            hv[e] = gel * value;
            dv[e] = d * gel;
            dg[e] = d * value * gprime;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(hbuf + hrow + c) = __floats2bfloat162_rn(hv[0], hv[1]);
        *reinterpret_cast<__nv_bfloat162*>(dvg + drow + c) = __floats2bfloat162_rn(dv[0], dv[1]);
        *reinterpret_cast<__nv_bfloat162*>(dvg + drow + ldh + c) =
            __floats2bfloat162_rn(dg[0], dg[1]);
      }
    }
  }
};

constexpr int GATE_STAGES = 4;
constexpr int GATE_SMEM = GATE_STAGES * STAGE_BYTES + 1024;

// The value / gate recompute and dh in one block of gemm_sm90.cuh's shape
// (one producer warp, two consumer warpgroups of 64 rows), a 128-row x 64
// inner-column tile: the first nk slices are xn (map 0) against 64 value
// rows (map 1) and 64 gate rows (map 2) of w_in into acc (m64n128), the next
// nk are g (map 3) against 64 rows of W2^T (map 4) into dh (m64n64), so the
// epilogue has all three in registers and dh never goes through memory.
// 96 accumulator registers a thread: one block an SM.
__global__ void __launch_bounds__(THREADS, 1)
gate_bwd_kernel(const __grid_constant__ Maps maps, const GateBwdEpi epi, int K) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[GATE_STAGES], empty[GATE_STAGES];
  char* ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  const int nt = blockIdx.x, m0 = blockIdx.y * BM, n0 = nt * 64;
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GATE_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (lane == 0) {
      for (int kt = 0; kt < 2 * nk; ++kt) {
        const int s = kt % GATE_STAGES, dh_pass = kt >= nk, k0 = (kt - dh_pass * nk) * BK;
        mbar_wait(&empty[s], ((kt / GATE_STAGES) & 1) ^ 1);
        char* a = ring + s * STAGE_BYTES;
        char* b = a + A_BYTES;
        if (!dh_pass) {
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load_2d(a, &maps.m[0], &full[s], k0, m0);
          tma_load_2d(b, &maps.m[1], &full[s], k0, n0);
          tma_load_2d(b + B_HALF_BYTES, &maps.m[2], &full[s], k0, n0);
        } else {
          mbar_expect_tx(&full[s], A_BYTES + B_HALF_BYTES);
          tma_load_2d(a, &maps.m[3], &full[s], k0, m0);
          tma_load_2d(b, &maps.m[4], &full[s], k0, n0);
        }
      }
    }
  } else {
    const int wg = warp >> 2;
    float acc[64], dh[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) dh[i] = 0.f;
    for (int kt = 0; kt < 2 * nk; ++kt) {
      const int s = kt % GATE_STAGES;
      mbar_wait(&full[s], (kt / GATE_STAGES) & 1);
      const uint32_t a = smem_u32(ring + s * STAGE_BYTES) + wg * (64 * BK * 2);
      const uint32_t b = smem_u32(ring + s * STAGE_BYTES + A_BYTES);
      wgmma_fence();
      if (kt < nk) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n128k16(acc, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32));
      } else {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n64k16(dh, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32));
      }
      wgmma_commit();
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    fence_regs(acc);
    fence_regs(dh);
    epi(acc, dh, m0 + wg * 64 + (warp & 3) * 16, nt, lane);
  }
}

// The two weight gradients in one launch. Maps: 0 g [M, D], 1 h [M, inner],
// 2 dvalue [M, inner], 3 dgate [M, inner], 4 xn [M, D]. Tiles [0, 4 * 11):
// dW2 [D, inner] = g^T h (output 0); then dW_in [2 inner, D] = dvalue^T xn
// (rows [0, inner)) and dgate^T xn (rows [inner, 2 inner)) (output 1).
struct FFWgradPlan {
  int D, inner, d_tiles, inner_tiles;
  __device__ sm90::WgradTile tile(int t) const {
    const int out_tiles = d_tiles * inner_tiles;
    if (t < out_tiles) {
      const int i0 = (t / inner_tiles) * 128, j0 = (t % inner_tiles) * 128;
      return {0, 1, i0, j0, 0, i0, min(128, D - i0)};
    }
    const int u = t - out_tiles, it = u / d_tiles, j0 = (u % d_tiles) * 128;
    const int gate = it >= inner_tiles, i0 = (gate ? it - inner_tiles : it) * 128;
    return {2 + gate, 4, i0, j0, 1, gate * inner + i0, min(128, inner - i0)};
  }
};

}  // namespace ffb
}  // namespace ctc

using namespace ctc;

// x [M, D] bf16; gamma/beta [D] fp32; w_in [2*inner, D] bf16 (value rows,
// then gate rows); w2T [inner, D] bf16 (W2 transposed); wvgT [D, 2*ldh] bf16
// (Wv^T in columns [0, inner), Wg^T in [ldh, ldh + inner), zeros elsewhere);
// g [M, D] bf16. Workspaces: xn [M, D] bf16, stats [M] float2, hbuf [M,
// ldh] bf16, dvg [M, 2*ldh] bf16, dxn [M, D] fp32. Outputs:
// dx [M, D] bf16; dgamma, dbeta [D] fp32, zeroed by the caller (atomic
// sums); dw_in [2*inner, D] and dw_out [D, inner] fp32, written whole. ldh
// >= inner, a multiple of 8; D a multiple of 8; every pointer 16-B aligned.
extern "C" int ctc_geglu_ff_bwd(const void* x, const void* gamma, const void* beta,
                                const void* w_in, const void* w2T, const void* wvgT, const void* g,
                                void* xn, void* stats, void* hbuf, void* dvg, void* dxn,
                                void* dx, void* dgamma, void* dbeta, void* dw_in, void* dw_out,
                                int M, int D, int inner, int ldh, int residual, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xb = (const bf16*)x;
  const bf16* gb = (const bf16*)g;
  const bf16* w = (const bf16*)w_in;
  const bf16* dvgb = (const bf16*)dvg;
  sm90::Maps gate{}, dxm{}, wg{};
  int err = sm90::map_a(&gate.m[0], xn, M, D, D);
  if (!err) err = sm90::map_b(&gate.m[1], w, inner, D, D);
  if (!err) err = sm90::map_b(&gate.m[2], w + (int64_t)inner * D, inner, D, D);
  if (!err) err = sm90::map_a(&gate.m[3], gb, M, D, D);
  if (!err) err = sm90::map_b(&gate.m[4], w2T, inner, D, D);
  if (!err) err = sm90::map_a(&dxm.m[0], dvg, M, 2 * ldh, 2 * ldh);
  if (!err) err = sm90::map_b(&dxm.m[1], wvgT, D, 2 * ldh, 2 * ldh);
  if (!err) err = sm90::map_mn(&wg.m[0], gb, M, D, D);
  if (!err) err = sm90::map_mn(&wg.m[1], hbuf, M, inner, ldh);
  if (!err) err = sm90::map_mn(&wg.m[2], dvgb, M, inner, 2 * ldh);
  if (!err) err = sm90::map_mn(&wg.m[3], dvgb + ldh, M, inner, 2 * ldh);
  if (!err) err = sm90::map_mn(&wg.m[4], xn, M, D, D);
  if (err) return err;
  ln_rows_kernel<><<<(M + 7) / 8, 256, 0, st>>>(xb, (const float*)gamma, (const float*)beta,
                                                (bf16*)xn, (float2*)stats, M, D);
  err = (int)cudaGetLastError();
  if (!err) {
    cudaFuncSetAttribute(ffb::gate_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         ffb::GATE_SMEM);
    dim3 grid((ldh + 63) / 64, (M + sm90::BM - 1) / sm90::BM);
    ffb::gate_bwd_kernel<<<grid, sm90::THREADS, ffb::GATE_SMEM, st>>>(
        gate, ffb::GateBwdEpi{(bf16*)hbuf, (bf16*)dvg, M, inner, ldh}, D);
    err = (int)cudaGetLastError();
  }
  if (!err)
    err = sm90::launch_gemm(dxm, sm90::LinearPlan{}, sm90::StoreF32Epi{(float*)dxn, M, D},
                            (D + sm90::BN - 1) / sm90::BN, M, 2 * ldh, st);
  if (err) return err;
  launch_ln_bwd(xb, (const float2*)stats, (const float*)dxn, nullptr, residual ? gb : nullptr,
                (const float*)gamma, (bf16*)dx, (float*)dgamma, (float*)dbeta, M, D, st);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int d_tiles = (D + 127) / 128, inner_tiles = (inner + 127) / 128;
  const sm90::WgradStoreEpi epi{{(float*)dw_out, (float*)dw_in}, {inner, D}, {inner, D}};
  return sm90::launch_wgrad_sm90(wg, ffb::FFWgradPlan{D, inner, d_tiles, inner_tiles}, epi,
                                 d_tiles * inner_tiles * 3, M, st);
}
