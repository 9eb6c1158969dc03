// One bf16 BERT encoder layer, backward: the port of
// ct_clip_ut_tpu/ops/pallas_bert_layer.py:_bwd_impl (`_kernel_bwd`).
//
// Like the TPU kernel it saves nothing between forward and backward: given x,
// the key mask, the seeds, the weights and the output cotangent it first runs
// the forward chain again (bert_bf16.cuh; the dropout masks come out the same,
// being functions of the seeds and positions only), then
//   LN2 backward -> do2 = dr2 keep2 (bf16) -> dW2 = do2^T g, db2,
//   dh1 = (do2 W2) gelu'(h1) (closed form, erff) -> dW1 = dh1^T y, db1,
//   dy = dr2 + dh1 W1 (fp32) -> LN1 backward -> do1 = dr1 keep1 (bf16)
//   -> dWo = do1^T ctx, dbo, dctx = do1 Wo (bf16),
//   per head: dp = (dctx v^T) keep, dv = p_used^T dctx,
//   ds = p (dp - rowsum(dp p)) / sqrt(dh) with p the pre-dropout
//   probabilities, rounded to bf16, dq = ds k, dk = ds^T q,
//   dWqkv = dqkv^T x, dbqkv, dx = dr1 + dqkv Wqkv (bf16),
// at the TPU kernel's rounding points; every accumulation is fp32.
//
// What bounds it on the H100: tensor-core operations, 6 B n D (3D + D + 2F)
// + 12 B heads n^2 dh (48 GFLOP at B = 2, n = 512: 49 us at the bf16 peak)
// plus the forward again. The TPU kernel accumulates the twelve parameter
// gradients across its sequential grid; here every sum runs in a fixed
// order, so two calls give the same bits:
//   - the data-gradient products on the Hopper core (gemm_sm90.cuh), the
//     weights read MN-major as they are stored ([K, N]: LinearKNPlan, no
//     per-call transposes), epilogues from the registers: dh1 with db1's
//     per-warp column sums (GeluBwdEpi), dy (AddF32Epi), dctx with each
//     row's D = rowsum(dctx ctx) per head (DctxEpi), dx (AddBf16Epi);
//   - the weight gradients on wgrad_sm90.cuh (one block a 128 x 128 tile
//     over every token in order, no atomics) in two launches: dW2 | dW1
//     (144 + 144 tiles at D = 768, F = 3072) and dWo | dWqkv (36 + 108);
//   - the attention core flash-attention-2 style on mma.sync, heads of 64:
//     a query pass (dq) and a key pass (dk, dv) over 64-row chunks staged
//     by cp.async, p recomputed from the recompute forward's row
//     statistics, the keep mask read from the bits that forward wrote, and
//     the row term D = rowsum(dctx ctx) = rowsum(dp p) up to ctx's bf16
//     rounding; no [B, heads, n, n] workspace;
//   - the LayerNorm backward with one warp a row, each lane's columns'
//     sums in registers, a block's warps summed in order;
//   - the column sums (dgamma, dbeta, the biases) as per-block or per-warp
//     partial rows that one last launch sums in order.
#include "bert_bf16.cuh"
#include "wgrad_sm90.cuh"

namespace ctc {
namespace bh {

// ---- epilogues of the backward products --------------------------------------

// dh1 = acc gelu'(h1), rounded to bf16 for the products that use it; the
// fp32 column sums of the warp's 16 rows go to part [M / 16, F] (db1's
// partial rows).
struct GeluBwdEpi {
  const float* h1;
  bf16* dh1;
  float* part;
  int M, F;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int gr = lane >> 2, t = lane & 3;
    auto gp = [](float x) { return gelu_cdf(x) + x * 0.3989422804014327f * expf(-0.5f * x * x); };
    // half the usual run of loads: with EPI_J, gemm_kernel's 112 registers spilled 192 B
    constexpr int J = EPI_J / 2;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += J) {
      float2 hv[J][2];
#pragma unroll
      for (int u = 0; u < J; ++u) {
        const int c = nt * BN + 8 * (j0 + u) + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row + gr + 8 * h;
          hv[u][h] = ld2(h1 + (int64_t)m * F + c, m < M && c < F);
        }
      }
#pragma unroll
      for (int u = 0; u < J; ++u) {
        const int j = j0 + u, c = nt * BN + 8 * j + 2 * t;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row + gr + 8 * h;
          if (m < M && c < F) {
            const float d0 = acc[4 * j + 2 * h] * gp(hv[u][h].x);
            const float d1 = acc[4 * j + 2 * h + 1] * gp(hv[u][h].y);
            *reinterpret_cast<__nv_bfloat162*>(dh1 + (int64_t)m * F + c) =
                __floats2bfloat162_rn(d0, d1);
            s0 += d0;
            s1 += d1;
          }
        }
        s0 = col_sum16(s0);
        s1 = col_sum16(s1);
        if (gr == 0 && c < F && row < M)
          *reinterpret_cast<float2*>(part + (int64_t)(row / 16) * F + c) = make_float2(s0, s1);
      }
    }
  }
};

// io [M, N] += acc in fp32: dy = dr2 + dh1 W1.
struct AddF32Epi {
  float* io;
  int M, N;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += EPI_J) {
      float2 rv[EPI_J][2];
#pragma unroll
      for (int u = 0; u < EPI_J; ++u) {
        const int c = nt * BN + 8 * (j0 + u) + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row + g + 8 * h;
          rv[u][h] = ld2(io + (int64_t)m * N + c, m < M && c < N);
        }
      }
#pragma unroll
      for (int u = 0; u < EPI_J; ++u) {
        const int j = j0 + u, c = nt * BN + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row + g + 8 * h;
          if (m < M && c < N)
            *reinterpret_cast<float2*>(io + (int64_t)m * N + c) =
                make_float2(acc[4 * j + 2 * h] + rv[u][h].x, acc[4 * j + 2 * h + 1] + rv[u][h].y);
        }
      }
    }
  }
};

// out [M, N] = bf16(acc + res): dx = dr1 + dqkv Wqkv.
struct AddBf16Epi {
  const float* res;
  bf16* out;
  int M, N;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += EPI_J) {
      float2 rv[EPI_J][2];
#pragma unroll
      for (int u = 0; u < EPI_J; ++u) {
        const int c = nt * BN + 8 * (j0 + u) + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row + g + 8 * h;
          rv[u][h] = ld2(res + (int64_t)m * N + c, m < M && c < N);
        }
      }
#pragma unroll
      for (int u = 0; u < EPI_J; ++u) {
        const int j = j0 + u, c = nt * BN + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row + g + 8 * h;
          if (m < M && c < N)
            *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)m * N + c) = __floats2bfloat162_rn(
                acc[4 * j + 2 * h] + rv[u][h].x, acc[4 * j + 2 * h + 1] + rv[u][h].y);
        }
      }
    }
  }
};

// dctx [M, D] = bf16(acc), and for each row and each of the tile's two
// heads the row term D = sum over the head's 64 columns of dctx ctx (both
// bf16), into rowstat[(seq, head, i)].z: sum_j dP_ij keep_ij p_ij is dctx_i
// . sum_j p_used_ij v_j, which is ctx_i before its rounding.
struct DctxEpi {
  bf16* dctx;
  const bf16* ctx;
  float4* rowstat;
  int M, D, npad;
  __device__ void operator()(const float (&acc)[64], int row, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3, heads = D / DH;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float dot[2] = {0.f, 0.f};
#pragma unroll
      for (int j0 = 8 * hh; j0 < 8 * hh + 8; j0 += EPI_J) {
        float2 cx[EPI_J][2];
#pragma unroll
        for (int u = 0; u < EPI_J; ++u) {
          const int c = nt * BN + 8 * (j0 + u) + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = row + g + 8 * h;
            cx[u][h] = ld2(ctx + (int64_t)m * D + c, m < M && c < D);
          }
        }
#pragma unroll
        for (int u = 0; u < EPI_J; ++u) {
          const int j = j0 + u, c = nt * BN + 8 * j + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = row + g + 8 * h;
            if (m < M && c < D) {
              const __nv_bfloat162 v =
                  __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
              *reinterpret_cast<__nv_bfloat162*>(dctx + (int64_t)m * D + c) = v;
              dot[h] += __low2float(v) * cx[u][h].x + __high2float(v) * cx[u][h].y;
            }
          }
        }
      }
      const int head = (nt * BN + 64 * hh) / DH;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float d = dot[h] + __shfl_xor_sync(FULL, dot[h], 1);
        d += __shfl_xor_sync(FULL, d, 2);
        const int m = row + g + 8 * h;
        if (t == 0 && m < M && head < heads)
          rowstat[((int64_t)(m / npad) * heads + head) * npad + m % npad].z = d;
      }
    }
  }
};

// ---- the attention passes ------------------------------------------------------

// The query pass: one block per (RW 16 query rows, head h, sequence b), K
// and V staged whole, the halves walking the even and the odd key chunks.
// Per 16 keys: the scores and dP = dctx V^T, p from the row's (max, 1 /
// sum), dp = dP keep (the bits fwd_core_kernel<., true> wrote), ds = bf16(p
// (dp - D) scale), dq += ds K. Half 1 hands its dq to half 0, which writes
// it to dqkv [M, 3D] (bf16, columns h 64 ...) and the fp32 sums of its 16
// rows to part [M / 16, 3D] (dbqkv's partial rows).
template <int RW>
__global__ void __launch_bounds__(RW * 64, 1)
dq_pass_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
               const float* __restrict__ mask, const float4* __restrict__ rowstat,
               const unsigned* __restrict__ keep, Dropout drop, bf16* __restrict__ dqkv,
               float* __restrict__ part, int n, int npad, int D, float scale) {
  extern __shared__ __align__(128) char smem[];
  const int b = blockIdx.z, h = blockIdx.y, heads = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = warp % RW, half = warp / RW;
  const int ld = 3 * D, nch = npad / KC, words = npad / 32;
  const int64_t seq0 = (int64_t)b * npad, bh = (int64_t)b * heads + h;
  const float* mrow = mask + seq0;
  const uint32_t kp = sm90::smem_u32(smem), vp = kp + npad * 128;
  stage_plane(kp, qkv + seq0 * ld + D + h * DH, ld, npad);
  stage_plane(vp, qkv + seq0 * ld + 2 * D + h * DH, ld, npad);
  const int q0 = blockIdx.x * RW * 16 + rw * 16, ra = q0 + g, rb = ra + 8;
  const bool live = q0 < npad;
  uint32_t qf[4][4], df[4][4];
  float4 sta = make_float4(0.f, 0.f, 0.f, 0.f), stb = sta;
  if (live) {
    load_a64(qf, qkv + seq0 * ld + h * DH, ld, q0, lane);
    load_a64(df, dctx + seq0 * D + h * DH, D, q0, lane);
    sta = rowstat[bh * npad + ra];
    stb = rowstat[bh * npad + rb];
  }
  const bool drop_on = drop.thresh_attn != 0u;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  for (int c = half; live && c < nch; c += 2) {
    unsigned wa[2] = {FULL, FULL}, wb[2] = {FULL, FULL};
    if (drop_on) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        wa[w] = keep[(bh * npad + ra) * words + 2 * c + w];
        wb[w] = keep[(bh * npad + rb) * words + 2 * c + w];
      }
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jt = 2 * ks + u, kb = c * KC + 8 * jt, key = kb + 2 * t;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f}, ds[4];
        rows8(s, qf, kp, kb, lane);
        rows8(dp, df, vp, kb, lane);
        const float2 mk = *reinterpret_cast<const float2*>(mrow + key);
        const int bit = 8 * (jt & 3) + 2 * t;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4& st = i < 2 ? sta : stb;
          const float sv =
              key + (i & 1) < n ? s[i] * scale + ((i & 1) ? mk.y : mk.x) : -CUDART_INF_F;
          const float p = exp2f((sv - st.x) * LOG2E) * st.y;
          const unsigned wrd = i < 2 ? wa[jt >> 2] : wb[jt >> 2];
          const float kf = drop_on ? ((wrd >> (bit + (i & 1))) & 1u ? drop.scale_attn : 0.f) : 1.f;
          ds[i] = p * (dp[i] * kf - st.z) * scale;
        }
        a[2 * u] = sm90::pack_bf16(ds[0], ds[1]);
        a[2 * u + 1] = sm90::pack_bf16(ds[2], ds[3]);
      }
      cols64(acc, a, kp, c * KC + 16 * ks, lane);
    }
  }
  __syncthreads();
  float* xo = reinterpret_cast<float*>(smem);
  const int slot = rw * 32 + lane;
  if (half == 1) {
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xo[(dt * 4 + e) * RW * 32 + slot] = acc[dt][e];
  }
  __syncthreads();
  if (half == 1 || !live) return;
  const int64_t ld3 = 3 * (int64_t)D;
  float* prow = part + ((seq0 + q0) / 16) * ld3;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] += xo[(dt * 4 + e) * RW * 32 + slot];
    const int col = h * DH + 8 * dt + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(dqkv + (seq0 + ra) * ld3 + col) =
        __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<__nv_bfloat162*>(dqkv + (seq0 + rb) * ld3 + col) =
        __floats2bfloat162_rn(acc[dt][2], acc[dt][3]);
    const float s0 = col_sum16(acc[dt][0] + acc[dt][2]), s1 = col_sum16(acc[dt][1] + acc[dt][3]);
    if (g == 0) *reinterpret_cast<float2*>(prow + col) = make_float2(s0, s1);
  }
}

// A query chunk of the key pass: its Q and dctx rows (two 64-row planes of
// 128-B rows), each query's rowstat (16 B), the two keep words of the
// block's keys per query (8 B; the block's RW 16 <= 64 keys lie in one
// 64-key chunk). The key pass streams its chunks: staged whole (as the
// query pass does) its shared memory left one block an SM, 192 blocks on
// 132 SMs, 0.031 ms a call at [2, 512, 768] against 0.022 streamed (H100
// 80GB HBM3, 700 W, profile_layers).
constexpr int KV_CHUNK = 2 * KC * 128 + KC * 16 + KC * 8;
constexpr int KV_SMEM = 4 * KV_CHUNK;    // the two halves' chunks, double-buffered

// The key pass: one block per (RW 16 keys, head h, sequence b), warp w
// taking keys 16 (w % RW) ... as the A operand of S^T = K Q^T and dP^T = V
// dctx^T, the halves walking the even and the odd query chunks (staged a
// pair a step, double-buffered). Per 16 queries: p^T from each query's
// (max, 1 / sum), the keep bits, p_used = p keep and ds as in the query
// pass; dv += bf16(p_used)^T dctx, dk += ds^T q. Half 1 hands dk and dv to
// half 0, which writes them to dqkv (columns D + h 64 ..., 2D + h 64 ...)
// and their 16-row sums to part.
template <int RW>
__global__ void __launch_bounds__(RW * 64, 3)
dkv_pass_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                const float* __restrict__ mask, const float4* __restrict__ rowstat,
                const unsigned* __restrict__ keep, Dropout drop, bf16* __restrict__ dqkv,
                float* __restrict__ part, int n, int npad, int D, float scale) {
  extern __shared__ __align__(128) char smem[];
  const int b = blockIdx.z, h = blockIdx.y, heads = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = warp % RW, half = warp / RW;
  const int ld = 3 * D, nch = npad / KC, nsteps = (nch + 1) / 2, words = npad / 32;
  const int64_t seq0 = (int64_t)b * npad, bh = (int64_t)b * heads + h;
  const int kt0 = blockIdx.x * RW * 16, k0 = kt0 + rw * 16, key_a = k0 + g, key_b = key_a + 8;
  const int kw0 = kt0 / KC * 2;          // the keep words of the block's 64-key chunk
  const bool drop_on = drop.thresh_attn != 0u;
  const uint32_t sbase = sm90::smem_u32(smem);
  auto stage = [&](int s, int buf) {
    for (int hf = 0; hf < 2; ++hf) {
      const int c = 2 * s + hf;
      if (c >= nch) continue;
      const int off = (buf * 2 + hf) * KV_CHUNK;
      for (int i = threadIdx.x; i < KC * 8; i += blockDim.x) {
        const int j = i >> 3, ch = i & 7;
        cp_async16(sbase + off + swz(j, ch), qkv + (seq0 + c * KC + j) * ld + h * DH + ch * 8,
                   16);
        cp_async16(sbase + off + KC * 128 + swz(j, ch),
                   dctx + (seq0 + c * KC + j) * D + h * DH + ch * 8, 16);
      }
      for (int i = threadIdx.x; i < KC; i += blockDim.x)
        cp_async16(sbase + off + 2 * KC * 128 + 16 * i, rowstat + bh * npad + c * KC + i, 16);
      if (drop_on) {
        unsigned* kw = reinterpret_cast<unsigned*>(smem + off + 2 * KC * 128 + KC * 16);
        for (int i = threadIdx.x; i < 2 * KC; i += blockDim.x)
          kw[i] = keep[(bh * npad + c * KC + (i >> 1)) * words + kw0 + (i & 1)];
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  uint32_t kf[4][4], vf[4][4];
  load_a64(kf, qkv + seq0 * ld + D + h * DH, ld, k0, lane);
  load_a64(vf, qkv + seq0 * ld + 2 * D + h * DH, ld, k0, lane);
  const float mka = key_a < n ? mask[seq0 + key_a] : 0.f;
  const float mkb = key_b < n ? mask[seq0 + key_b] : 0.f;
  const int kla = key_a % KC, klb = key_b % KC;   // within the chunk's two keep words
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  stage(0, 0);
  for (int s = 0; s < nsteps; ++s) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // step s is in its buffer; every warp is done with the other one
    if (s + 1 < nsteps) stage(s + 1, (s + 1) & 1);
    if (2 * s + half >= nch) continue;
    const int off = ((s & 1) * 2 + half) * KV_CHUNK;
    const uint32_t qp = sbase + off, dop = qp + KC * 128;
    const float4* stq = reinterpret_cast<const float4*>(smem + off + 2 * KC * 128);
    const unsigned* kw = reinterpret_cast<const unsigned*>(smem + off + 2 * KC * 128 + KC * 16);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t pa[4], sa[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int qb = 16 * kt + 8 * u, qi = qb + 2 * t;
        float sv[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f}, pu[4], ds[4];
        rows8(sv, kf, qp, qb, lane);
        rows8(dp, vf, dop, qb, lane);
        const float4 s0 = stq[qi], s1 = stq[qi + 1];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = i < 2 ? key_a : key_b, kl = i < 2 ? kla : klb;
          const float4& st = (i & 1) ? s1 : s0;
          const float x = key < n ? sv[i] * scale + (i < 2 ? mka : mkb) : -CUDART_INF_F;
          const float p = exp2f((x - st.x) * LOG2E) * st.y;
          float kfac = 1.f;
          if (drop_on)
            kfac = (kw[2 * (qi + (i & 1)) + (kl >> 5)] >> (kl & 31)) & 1u ? drop.scale_attn : 0.f;
          pu[i] = p * kfac;
          ds[i] = p * (dp[i] * kfac - st.z) * scale;
        }
        pa[2 * u] = sm90::pack_bf16(pu[0], pu[1]);
        pa[2 * u + 1] = sm90::pack_bf16(pu[2], pu[3]);
        sa[2 * u] = sm90::pack_bf16(ds[0], ds[1]);
        sa[2 * u + 1] = sm90::pack_bf16(ds[2], ds[3]);
      }
      cols64(dv, pa, dop, 16 * kt, lane);
      cols64(dk, sa, qp, 16 * kt, lane);
    }
  }
  __syncthreads();
  float* xo = reinterpret_cast<float*>(smem);
  const int slot = rw * 32 + lane;
  if (half == 1) {
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xo[(dt * 4 + e) * RW * 32 + slot] = dk[dt][e];
        xo[(32 + dt * 4 + e) * RW * 32 + slot] = dv[dt][e];
      }
  }
  __syncthreads();
  if (half == 1) return;
  const int64_t ld3 = 3 * (int64_t)D;
  float* prow = part + ((seq0 + k0) / 16) * ld3;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[dt][e] += xo[(dt * 4 + e) * RW * 32 + slot];
      dv[dt][e] += xo[(32 + dt * 4 + e) * RW * 32 + slot];
    }
    const int col = D + h * DH + 8 * dt + 2 * t;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float(&r)[4] = which ? dv[dt] : dk[dt];
      const int cc = col + which * D;
      *reinterpret_cast<__nv_bfloat162*>(dqkv + (seq0 + key_a) * ld3 + cc) =
          __floats2bfloat162_rn(r[0], r[1]);
      *reinterpret_cast<__nv_bfloat162*>(dqkv + (seq0 + key_b) * ld3 + cc) =
          __floats2bfloat162_rn(r[2], r[3]);
      const float s0 = col_sum16(r[0] + r[2]), s1 = col_sum16(r[1] + r[3]);
      if (g == 0) *reinterpret_cast<float2*>(prow + cc) = make_float2(s0, s1);
    }
  }
}

// ---- the LayerNorm backward --------------------------------------------------------

constexpr int LNB_WARPS = 8;
constexpr int LNB_ROWS = 1;          // rows a warp
constexpr int LNB_CMAX = 8;          // float4 columns a lane: D <= 1024

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The LayerNorm backward of pallas_bert_layer._ln_bwd on rows r [M, D] with
// their saved (mean, rstd): dr = (dxhat - mean(dxhat) - xhat mean(dxhat
// xhat)) rstd in fp32, and behind it the hidden dropout site's do = dr keep
// rounded to bf16. Lane l owns columns 4 l + 128 k and sums dgamma = dout
// xhat, dbeta = dout and dbias = do over its warp's rows in registers; the
// block's warps are summed in order into part [gridDim.x, 3, D]. D a
// multiple of 4; shared memory LNB_WARPS * 3 * D floats.
template <typename TIn>
__global__ void __launch_bounds__(LNB_WARPS * 32)
ln_bwd_kernel(const TIn* __restrict__ dout, const float* __restrict__ r,
              const float2* __restrict__ stats, const float* __restrict__ gamma,
              const int* __restrict__ seeds, unsigned site, unsigned thresh, float scale,
              int npad, float* __restrict__ dr, bf16* __restrict__ dob, float* __restrict__ part,
              int M, int D) {
  extern __shared__ __align__(16) float red[];      // [LNB_WARPS][3][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (blockIdx.x * LNB_WARPS + warp) * LNB_ROWS;
  const int seed = thresh ? seeds[site] : 0;
  float4 sg[LNB_CMAX], sb[LNB_CMAX], sd[LNB_CMAX];
#pragma unroll
  for (int k = 0; k < LNB_CMAX; ++k)
    sg[k] = sb[k] = sd[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m = m0; m < min(m0 + LNB_ROWS, M); ++m) {
    const float2 st = stats[m];
    const float* rr = r + (int64_t)m * D;
    const TIn* dd = dout + (int64_t)m * D;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < LNB_CMAX; ++k) {
      const int c = lane * 4 + 128 * k;
      if (c < D) {
        const float4 rv = load4(rr + c), dv = load4(dd + c), gv = load4(gamma + c);
        const float4 xh = make_float4((rv.x - st.x) * st.y, (rv.y - st.x) * st.y,
                                      (rv.z - st.x) * st.y, (rv.w - st.x) * st.y);
        s1 += dv.x * gv.x + dv.y * gv.y + dv.z * gv.z + dv.w * gv.w;
        s2 += dv.x * gv.x * xh.x + dv.y * gv.y * xh.y + dv.z * gv.z * xh.z + dv.w * gv.w * xh.w;
        sg[k].x += dv.x * xh.x;
        sg[k].y += dv.y * xh.y;
        sg[k].z += dv.z * xh.z;
        sg[k].w += dv.w * xh.w;
        sb[k].x += dv.x;
        sb[k].y += dv.y;
        sb[k].z += dv.z;
        sb[k].w += dv.w;
      }
    }
    const float a1 = sm90::warp_sum(s1) / (float)D;
    const float a2 = sm90::warp_sum(s2) / (float)D;
    const unsigned seq = m / npad, i = m % npad;
#pragma unroll
    for (int k = 0; k < LNB_CMAX; ++k) {
      const int c = lane * 4 + 128 * k;
      if (c < D) {
        const float4 rv = load4(rr + c), dv = load4(dd + c), gv = load4(gamma + c);
        const float4 kp = keep4(seed, site, seq, 0u, i * D + c, thresh, scale);
        const float4 o = make_float4(
            (dv.x * gv.x - a1 - (rv.x - st.x) * st.y * a2) * st.y,
            (dv.y * gv.y - a1 - (rv.y - st.x) * st.y * a2) * st.y,
            (dv.z * gv.z - a1 - (rv.z - st.x) * st.y * a2) * st.y,
            (dv.w * gv.w - a1 - (rv.w - st.x) * st.y * a2) * st.y);
        const int64_t off = (int64_t)m * D + c;
        *reinterpret_cast<float4*>(dr + off) = o;
        const float4 dk = make_float4(o.x * kp.x, o.y * kp.y, o.z * kp.z, o.w * kp.w);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(dk.x, dk.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(dk.z, dk.w);
        *reinterpret_cast<uint2*>(dob + off) = make_uint2(
            *reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
        sd[k].x += dk.x;
        sd[k].y += dk.y;
        sd[k].z += dk.z;
        sd[k].w += dk.w;
      }
    }
  }
  float* mine = red + warp * 3 * D;
#pragma unroll
  for (int k = 0; k < LNB_CMAX; ++k) {
    const int c = lane * 4 + 128 * k;
    if (c < D) {
      *reinterpret_cast<float4*>(mine + c) = sg[k];
      *reinterpret_cast<float4*>(mine + D + c) = sb[k];
      *reinterpret_cast<float4*>(mine + 2 * D + c) = sd[k];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 3 * D; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < LNB_WARPS; ++w) s += red[w * 3 * D + c];
    part[(int64_t)blockIdx.x * 3 * D + c] = s;
  }
}

template <typename TIn>
static int launch_ln_bwd(const TIn* dout, const float* r, const float2* stats, const float* gamma,
                         const Dropout& drop, unsigned site, int npad, float* dr, bf16* dob,
                         float* part, int M, int D, cudaStream_t st) {
  const int rows = LNB_WARPS * LNB_ROWS, smem = LNB_WARPS * 3 * D * (int)sizeof(float);
  cudaFuncSetAttribute(ln_bwd_kernel<TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ln_bwd_kernel<TIn><<<(M + rows - 1) / rows, LNB_WARPS * 32, smem, st>>>(
      dout, r, stats, gamma, drop.seeds, site, drop.thresh_hidden, drop.scale_hidden, npad, dr,
      dob, part, M, D);
  return (int)cudaGetLastError();
}

// ---- the column sums and the weight gradients ----------------------------------------

// out[c / seg][c % seg] = the sum over p < P of part[p][c], c < N, in a
// fixed order: a block takes 32 columns, its 8 warps the P rows in 8
// consecutive segments, and the segments' sums are added in order.
struct SumJob {
  const float* part;
  float* out[3];
  int P, N, seg;
};
struct SumJobs {
  SumJob j[4];
};
constexpr int SUM_SEGS = 8;

__global__ void __launch_bounds__(SUM_SEGS * 32)
colsum_kernel(const __grid_constant__ SumJobs jobs) {
  __shared__ float seg_sums[SUM_SEGS][32];
  const SumJob& job = jobs.j[blockIdx.y];
  const int lane = threadIdx.x & 31, sg = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  if (blockIdx.x * 32 >= job.N) return;
  const int per = (job.P + SUM_SEGS - 1) / SUM_SEGS, p0 = sg * per, p1 = min(p0 + per, job.P);
  float s = 0.f;
  if (c < job.N)
    for (int p = p0; p < p1; ++p) s += job.part[(int64_t)p * job.N + c];
  seg_sums[sg][lane] = s;
  __syncthreads();
  if (sg != 0 || c >= job.N) return;
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < SUM_SEGS; ++k) total += seg_sums[k][lane];
  const int o = c / job.seg;
  float* dst = o == 0 ? job.out[0] : o == 1 ? job.out[1] : job.out[2];
  dst[c - o * job.seg] = total;
}

// Two weight gradients in one launch of wgrad_sm90.cuh's kernel: C0 = A0^T
// B0 [rows0, cols0] (maps 0, 1; output 0) on tiles [0, tiles0), then C1 =
// A1^T B1 [rows1, cols1] (maps 2, 3; output 1); each row-major over 128 x
// 128 tiles.
struct BertWgradPlan {
  int rows0, col_tiles0, tiles0, rows1, col_tiles1;
  __device__ sm90::WgradTile tile(int t) const {
    const bool second = t >= tiles0;
    const int u = second ? t - tiles0 : t, ct = second ? col_tiles1 : col_tiles0;
    const int rows = second ? rows1 : rows0;
    const int i0 = (u / ct) * sm90::BM, j0 = (u % ct) * BN;
    return {second ? 2 : 0, second ? 3 : 1, i0, j0, second ? 1 : 0, i0, min(sm90::BM, rows - i0)};
  }
};

// dW0 [r0, c0] = A0^T B0 and dW1 [r1, c1] = A1^T B1 over M tokens, the
// operands row-major bf16 [M, r] / [M, c], the outputs fp32 written whole.
static int wgrad_pair(const bf16* a0, const bf16* b0, float* w0, int r0, int c0, const bf16* a1,
                      const bf16* b1, float* w1, int r1, int c1, int M, cudaStream_t st) {
  sm90::Maps maps{};
  int err = sm90::map_mn(&maps.m[0], a0, M, r0, r0);
  if (!err) err = sm90::map_mn(&maps.m[1], b0, M, c0, c0);
  if (!err) err = sm90::map_mn(&maps.m[2], a1, M, r1, r1);
  if (!err) err = sm90::map_mn(&maps.m[3], b1, M, c1, c1);
  if (err) return err;
  const int ct0 = (c0 + BN - 1) / BN, ct1 = (c1 + BN - 1) / BN;
  const int tiles0 = (r0 + sm90::BM - 1) / sm90::BM * ct0;
  const int tiles1 = (r1 + sm90::BM - 1) / sm90::BM * ct1;
  const sm90::WgradStoreEpi epi{{w0, w1}, {c0, c1}, {c0, c1}};
  return sm90::launch_wgrad_sm90(maps, BertWgradPlan{r0, ct0, tiles0, r1, ct1}, epi,
                                 tiles0 + tiles1, M, st);
}

}  // namespace bh
}  // namespace ctc

using namespace ctc::bh;

// The inputs of ctc_bert_layer_bf16 (wbf16 and weights_f32 as there) and
// dout [B * npad, D] bf16.
// Workspaces: the forward's, rowstat [B, heads, npad] float4 and keep [B,
// heads, npad, npad / 32] u32 (read and written only with attention
// dropout), out_ws [M, D] bf16 for the forward's output; dr2 (then dy) and
// dr1 [M, D] fp32; do2, do1, dctx [M, D] bf16; dh1 [M, F] bf16; dqkv [M,
// 3D] bf16; partial column sums part_qkv [M / 16, 3D], part_b1 [M / 16, F],
// part_ln [2, M / 8, 3D] fp32. Outputs, written whole: dx [M, D] bf16;
// dwqkv [3D, D], dbqkv [3D], dwo [D, D], dbo, dg1, dbe1 [D], dw1 [F, D],
// db1 [F], dw2 [D, F], db2, dg2, dbe2 [D] fp32. M = B * npad.
extern "C" int ctc_bert_layer_bwd(
    const void* x, const void* mask, const void* seeds, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, const void* g1, const void* be1, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* g2, const void* be2,
    const void* dout, void* wbf16, void* qkv, void* ctx, void* r1, void* stats1, void* yf,
    void* yb, void* h1, void* g, void* r2, void* stats2, void* rowstat, void* keep, void* out_ws,
    void* dr2, void* dr1, void* do2, void* do1, void* dctx, void* dh1, void* dqkv, void* part_qkv,
    void* part_b1, void* part_ln, void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
    void* dg1, void* dbe1, void* dw1, void* db1, void* dw2, void* db2, void* dg2, void* dbe2,
    int weights_f32, int B, int n, int npad, int D, int F, int heads, float eps, float scale,
    unsigned thresh_attn, unsigned thresh_hidden, float scale_attn, float scale_hidden,
    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const void* const p[12] = {wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2};
  Weights w;
  int err = chain_weights(p, weights_f32, wbf16, D, F, w, st);
  if (err) return err;
  const Work ws{(bf16*)qkv, (bf16*)ctx, (float*)r1, (float2*)stats1, (float*)yf, (bf16*)yb,
                (float*)h1, (bf16*)g, (float*)r2, (float2*)stats2, (float4*)rowstat,
                (unsigned*)keep};
  const Dropout drop{(const int*)seeds, thresh_attn, thresh_hidden, scale_attn, scale_hidden};
  const bf16* xb = (const bf16*)x;
  const int M = B * npad;
  if (rowstat == nullptr || (thresh_attn && keep == nullptr) || D > 128 * LNB_CMAX)
    return (int)cudaErrorInvalidValue;
  err = forward_chain(xb, (const float*)mask, w, ws, (bf16*)out_ws, drop, B, n, npad, D, F, heads,
                      eps, scale, st);
  if (err) return err;

  bf16 *do2p = (bf16*)do2, *do1p = (bf16*)do1, *dh1p = (bf16*)dh1, *dctxp = (bf16*)dctx,
       *dqkvp = (bf16*)dqkv;
  float *dr2p = (float*)dr2, *dr1p = (float*)dr1, *pqkv = (float*)part_qkv,
        *pb1 = (float*)part_b1, *pln2 = (float*)part_ln;
  const int ln_parts = (M + LNB_WARPS * LNB_ROWS - 1) / (LNB_WARPS * LNB_ROWS);
  float* pln1 = pln2 + (int64_t)ln_parts * 3 * D;
  // LN2 -> FF -> LN1
  err = launch_ln_bwd((const bf16*)dout, ws.r2, ws.stats2, w.g2, drop, 2u, npad, dr2p, do2p, pln2,
                      M, D, st);
  if (!err) err = product<true>(do2p, w.w2, M, F, D, GeluBwdEpi{ws.h1, dh1p, pb1, M, F}, st);
  if (!err)
    err = wgrad_pair(do2p, ws.g, (float*)dw2, D, F, dh1p, ws.yb, (float*)dw1, F, D, M, st);
  if (!err) err = product<true>(dh1p, w.w1, M, D, F, AddF32Epi{dr2p, M, D}, st);
  if (!err)
    err = launch_ln_bwd((const float*)dr2p, ws.r1, ws.stats1, w.g1, drop, 1u, npad, dr1p, do1p,
                        pln1, M, D, st);
  // the attention out-projection and the core
  if (!err)
    err = product<true>(do1p, w.wo, M, D, D, DctxEpi{dctxp, ws.ctx, ws.rowstat, M, D, npad}, st);
  if (err) return err;
  const int smem_q = core_bytes(npad);
  cudaFuncSetAttribute(dq_pass_kernel<FWD_RW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  dq_pass_kernel<FWD_RW>
      <<<dim3((npad + FWD_RW * 16 - 1) / (FWD_RW * 16), heads, B), FWD_RW * 64, smem_q, st>>>(
          ws.qkv, dctxp, (const float*)mask, ws.rowstat, ws.keep, drop, dqkvp, pqkv, n, npad, D,
          scale);
  cudaFuncSetAttribute(dkv_pass_kernel<KV_RW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       KV_SMEM);
  dkv_pass_kernel<KV_RW><<<dim3(npad / (KV_RW * 16), heads, B), KV_RW * 64, KV_SMEM, st>>>(
      ws.qkv, dctxp, (const float*)mask, ws.rowstat, ws.keep, drop, dqkvp, pqkv, n, npad, D,
      scale);
  err = (int)cudaGetLastError();
  // dWo | dWqkv, then dx = dr1 + dqkv Wqkv
  if (!err)
    err = wgrad_pair(do1p, ws.ctx, (float*)dwo, D, D, dqkvp, xb, (float*)dwqkv, 3 * D, D, M, st);
  if (!err)
    err = product<true>(dqkvp, w.wqkv, M, D, 3 * D, AddBf16Epi{dr1p, (bf16*)dx, M, D}, st);
  if (err) return err;
  SumJobs jobs{};
  jobs.j[0] = SumJob{pqkv, {(float*)dbqkv, nullptr, nullptr}, M / 16, 3 * D, 3 * D};
  jobs.j[1] = SumJob{pb1, {(float*)db1, nullptr, nullptr}, M / 16, F, F};
  jobs.j[2] = SumJob{pln1, {(float*)dg1, (float*)dbe1, (float*)dbo}, ln_parts, 3 * D, D};
  jobs.j[3] = SumJob{pln2, {(float*)dg2, (float*)dbe2, (float*)db2}, ln_parts, 3 * D, D};
  const int widest = 3 * D > F ? 3 * D : F;
  colsum_kernel<<<dim3((widest + 31) / 32, 4), SUM_SEGS * 32, 0, st>>>(jobs);
  return (int)cudaGetLastError();
}
