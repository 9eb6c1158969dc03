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
// gradients across its sequential grid; here each weight gradient is one
// reduction over all B n rows (wgrad_kernel: fp32 atomicAdd of 128 x 128
// tiles into zeroed outputs, so the order of the sums varies between runs),
// and the bias / LN gradients are column sums with one atomicAdd per column
// and block. The attention core is two kernels: a query pass (32 query rows
// a block: scores, dp, the row term, ds, dq; the bf16 ds goes to a global
// [B, heads, n, n] workspace) and a key pass (32 keys a block: dv from the
// forward's saved p_used, dk from ds), wmma operands read straight from the
// global buffers.
#include "bert_bf16.cuh"

namespace ctc {

// dh1 = v gelu'(h1), rounded to bf16 for the products that use it; its fp32
// column sums are db1.
struct EpiGeluBwd {
  static constexpr bool kColSum = true;
  const float* h1;
  bf16* dh1;
  int ld;
  __device__ __forceinline__ float4 operator()(int m, int n, float4 v) const {
    const float4 h = *reinterpret_cast<const float4*>(h1 + (int64_t)m * ld + n);
    auto gp = [](float x) {
      return gelu_cdf(x) + x * 0.3989422804014327f * expf(-0.5f * x * x);
    };
    const float4 d = make_float4(v.x * gp(h.x), v.y * gp(h.y), v.z * gp(h.z), v.w * gp(h.w));
    *reinterpret_cast<uint2*>(dh1 + (int64_t)m * ld + n) = pack_bf16x4(d.x, d.y, d.z, d.w);
    return d;
  }
};

// io += v in fp32: dy = dr2 + dh1 W1.
struct EpiAddF32 {
  static constexpr bool kColSum = false;
  float* io;
  int ld;
  __device__ __forceinline__ float4 operator()(int m, int n, float4 v) const {
    float4* p = reinterpret_cast<float4*>(io + (int64_t)m * ld + n);
    const float4 r = *p;
    *p = make_float4(v.x + r.x, v.y + r.y, v.z + r.z, v.w + r.w);
    return v;
  }
};

// out = bf16(v + res): dx = dr1 + dqkv Wqkv.
struct EpiAddToBf16 {
  static constexpr bool kColSum = false;
  const float* res;
  bf16* out;
  int ld;
  __device__ __forceinline__ float4 operator()(int m, int n, float4 v) const {
    const float4 r = *reinterpret_cast<const float4*>(res + (int64_t)m * ld + n);
    *reinterpret_cast<uint2*>(out + (int64_t)m * ld + n) =
        pack_bf16x4(v.x + r.x, v.y + r.y, v.z + r.z, v.w + r.w);
    return v;
  }
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  return unpack_bf16x4(*reinterpret_cast<const uint2*>(p));
}

constexpr int BLN_WARPS = 8;
constexpr int BLN_ROWS = 4;          // rows per warp

// The LayerNorm backward of pallas_bert_layer._ln_bwd on rows r [M, D] with
// their saved (mean, rstd): dr = (dxhat - mean(dxhat) - xhat mean(dxhat xhat))
// rstd in fp32, and behind it the hidden dropout site's do = dr keep rounded
// to bf16. dgamma, dbeta and dbias = colsum(do) are summed per block in
// shared memory, then one atomicAdd per column. D a multiple of 4; shared
// memory 3 * D floats.
template <typename TIn>
__global__ void __launch_bounds__(BLN_WARPS * 32)
bert_ln_bwd_kernel(const TIn* __restrict__ dout, const float* __restrict__ r,
                   const float2* __restrict__ stats, const float* __restrict__ gamma,
                   const int* __restrict__ seeds, unsigned site, unsigned thresh, float scale,
                   int n, int npad, float* __restrict__ dr, bf16* __restrict__ dob,
                   float* __restrict__ dgamma, float* __restrict__ dbeta,
                   float* __restrict__ dbias, int M, int D) {
  extern __shared__ __align__(16) float red[];      // [3][D]
  for (int c = threadIdx.x; c < 3 * D; c += blockDim.x) red[c] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * BLN_WARPS * BLN_ROWS;
  const int m1 = min(m0 + BLN_WARPS * BLN_ROWS, M);
  const int seed = thresh ? seeds[site] : 0;
  for (int m = m0 + warp; m < m1; m += BLN_WARPS) {
    const float2 st = stats[m];
    const float* rr = r + (int64_t)m * D;
    const TIn* dd = dout + (int64_t)m * D;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * 4; c < D; c += 128) {
      const float4 rv = load4(rr + c), dv = load4(dd + c), gv = load4(gamma + c);
      const float xh[4] = {(rv.x - st.x) * st.y, (rv.y - st.x) * st.y, (rv.z - st.x) * st.y,
                           (rv.w - st.x) * st.y};
      const float d[4] = {dv.x, dv.y, dv.z, dv.w}, g[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dxh = d[e] * g[e];
        s1 += dxh;
        s2 += dxh * xh[e];
        atomicAdd(&red[c + e], d[e] * xh[e]);
        atomicAdd(&red[D + c + e], d[e]);
      }
    }
    const float a1 = warp_sum(s1) / (float)D;
    const float a2 = warp_sum(s2) / (float)D;
    const int seq = m / npad, i = m % npad;
    for (int c = lane * 4; c < D; c += 128) {
      const float4 rv = load4(rr + c), dv = load4(dd + c), gv = load4(gamma + c);
      const float4 k = keep4(seed, site, seq, 0u, (unsigned)(i * D + c), thresh, scale);
      const float4 o = make_float4(
          (dv.x * gv.x - a1 - (rv.x - st.x) * st.y * a2) * st.y,
          (dv.y * gv.y - a1 - (rv.y - st.x) * st.y * a2) * st.y,
          (dv.z * gv.z - a1 - (rv.z - st.x) * st.y * a2) * st.y,
          (dv.w * gv.w - a1 - (rv.w - st.x) * st.y * a2) * st.y);
      *reinterpret_cast<float4*>(dr + (int64_t)m * D + c) = o;
      const float4 dk = make_float4(o.x * k.x, o.y * k.y, o.z * k.z, o.w * k.w);
      *reinterpret_cast<uint2*>(dob + (int64_t)m * D + c) = pack_bf16x4(dk.x, dk.y, dk.z, dk.w);
      atomicAdd(&red[2 * D + c + 0], dk.x);
      atomicAdd(&red[2 * D + c + 1], dk.y);
      atomicAdd(&red[2 * D + c + 2], dk.z);
      atomicAdd(&red[2 * D + c + 3], dk.w);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    atomicAdd(dgamma + c, red[c]);
    atomicAdd(dbeta + c, red[D + c]);
    atomicAdd(dbias + c, red[2 * D + c]);
  }
}

template <typename TIn>
static void launch_bert_ln_bwd(const TIn* dout, const float* r, const float2* stats,
                               const float* gamma, const Dropout& drop, unsigned site, int n,
                               int npad, float* dr, bf16* dob, float* dgamma, float* dbeta,
                               float* dbias, int M, int D, cudaStream_t st) {
  const int rows = BLN_WARPS * BLN_ROWS;
  bert_ln_bwd_kernel<TIn><<<(M + rows - 1) / rows, BLN_WARPS * 32, 3 * D * sizeof(float), st>>>(
      dout, r, stats, gamma, drop.seeds, site, drop.thresh_hidden, drop.scale_hidden, n, npad, dr,
      dob, dgamma, dbeta, dbias, M, D);
}

// The query pass of the attention backward, per (sequence, head, 32 query
// rows): S and dP = dctx v^T as whole rows in shared memory; p = softmax(S);
// dp = dP keep; ds = bf16(p (dp - rowsum(dp p)) scale) to shared memory and
// to the global ds workspace; dq = ds k into the fp32 dqkv buffer.
// Shared memory: 2 * BA_Q * (npad + 8) * 4 + BA_Q * (npad + 16) * 2 bytes.
__global__ void __launch_bounds__(BA_THREADS)
bert_attn_bwd_q_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                       const bf16* __restrict__ dctx, Dropout drop, bf16* __restrict__ ds,
                       float* __restrict__ dqkv, int n, int npad, int D, int heads, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) char smem[];
  const int lds = npad + 8, ldp = npad + 16;
  float* S = reinterpret_cast<float*>(smem);
  float* dP = S + BA_Q * lds;
  bf16* dS = reinterpret_cast<bf16*>(smem + (size_t)2 * BA_Q * lds * 4);
  const int q0 = blockIdx.x * BA_Q, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld3 = 3 * D;
  const bf16* base = qkv + (int64_t)b * npad * ld3 + h * BERT_DH;
  bert_scores(base + (int64_t)q0 * ld3, base + D, ld3, npad, S, lds);
  // dP = dctx_tile @ V^T: the same product with dctx for q (rows D apart) and v for k
  {
    const bf16* dc = dctx + ((int64_t)b * npad + q0) * D + h * BERT_DH;
    const bf16* V = base + 2 * D;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fd[2][4];
#pragma unroll
    for (int rt = 0; rt < 2; ++rt)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wmma::load_matrix_sync(fd[rt][kk], dc + (int64_t)rt * 16 * D + kk * 16, D);
    for (int ct = warp; ct < npad / 16; ct += BA_THREADS / 32) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
      wmma::fill_fragment(acc[0], 0.f);
      wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fv;
        wmma::load_matrix_sync(fv, V + (int64_t)ct * 16 * ld3 + kk * 16, ld3);
        wmma::mma_sync(acc[0], fd[0][kk], fv, acc[0]);
        wmma::mma_sync(acc[1], fd[1][kk], fv, acc[1]);
      }
      wmma::store_matrix_sync(dP + ct * 16, acc[0], lds, wmma::mem_row_major);
      wmma::store_matrix_sync(dP + 16 * lds + ct * 16, acc[1], lds, wmma::mem_row_major);
    }
  }
  __syncthreads();

  const int seed = drop.thresh_attn ? drop.seeds[0] : 0;
  for (int r = warp; r < BA_Q; r += BA_THREADS / 32) {
    float* srow = S + r * lds;
    float* drow = dP + r * lds;
    bert_softmax_row(srow, mask + (int64_t)b * npad, n, npad, scale);
    const int i = q0 + r;
    float dot = 0.f;
    for (int j = lane * 4; j < npad; j += 128) {
      const float4 p = *reinterpret_cast<const float4*>(srow + j);
      float4 d = *reinterpret_cast<const float4*>(drow + j);
      const float4 k = keep4(seed, 0u, b, h, (unsigned)(i * n + j), drop.thresh_attn,
                             drop.scale_attn);
      d = make_float4(d.x * k.x, d.y * k.y, d.z * k.z, d.w * k.w);
      *reinterpret_cast<float4*>(drow + j) = d;
      dot += (d.x * p.x + d.y * p.y) + (d.z * p.z + d.w * p.w);
    }
    dot = warp_sum(dot);
    for (int j = lane * 4; j < npad; j += 128) {
      const float4 p = *reinterpret_cast<const float4*>(srow + j);
      const float4 d = *reinterpret_cast<const float4*>(drow + j);
      const uint2 packed = pack_bf16x4(p.x * (d.x - dot) * scale, p.y * (d.y - dot) * scale,
                                       p.z * (d.z - dot) * scale, p.w * (d.w - dot) * scale);
      *reinterpret_cast<uint2*>(dS + r * ldp + j) = packed;
      *reinterpret_cast<uint2*>(ds + (((int64_t)b * heads + h) * npad + i) * npad + j) = packed;
    }
  }
  __syncthreads();

  // dq tile [32, 64] = dS [32, npad] @ K [npad, 64]: one 16 x 16 tile a warp
  const int rt = warp >> 2, ct = warp & 3;
  const bf16* K = base + D;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  for (int kk = 0; kk < npad / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fs;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fk;
    wmma::load_matrix_sync(fs, dS + rt * 16 * ldp + kk * 16, ldp);
    wmma::load_matrix_sync(fk, K + (int64_t)kk * 16 * ld3 + ct * 16, ld3);
    wmma::mma_sync(acc, fs, fk, acc);
  }
  wmma::store_matrix_sync(dqkv + ((int64_t)b * npad + q0 + rt * 16) * ld3 + h * BERT_DH + ct * 16,
                          acc, ld3, wmma::mem_row_major);
}

// The key pass, per (sequence, head, 32 keys): dv = p_used^T dctx and
// dk = ds^T q, reductions over the query rows, into the fp32 dqkv buffer.
// Warp w owns key rows (w % 2) * 16 and head columns (w / 2) * 16 .. + 16.
__global__ void __launch_bounds__(BA_THREADS)
bert_attn_bwd_kv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                        const bf16* __restrict__ pu, const bf16* __restrict__ ds,
                        float* __restrict__ dqkv, int npad, int D, int heads) {
  using namespace nvcuda;
  const int j0 = blockIdx.x * 32, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int rt = warp & 1, c0 = (warp >> 1) * 16;
  const int ld3 = 3 * D;
  const int64_t slab = ((int64_t)b * heads + h) * npad * npad;
  const bf16* P = pu + slab + j0 + rt * 16;          // column-major A: (key, query) at [query][key]
  const bf16* S = ds + slab + j0 + rt * 16;
  const bf16* Q = qkv + (int64_t)b * npad * ld3 + h * BERT_DH + c0;
  const bf16* dc = dctx + (int64_t)b * npad * D + h * BERT_DH + c0;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dv, dk;
  wmma::fill_fragment(dv, 0.f);
  wmma::fill_fragment(dk, 0.f);
  for (int kk = 0; kk < npad / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fp, fs;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fd, fq;
    wmma::load_matrix_sync(fp, P + (int64_t)kk * 16 * npad, npad);
    wmma::load_matrix_sync(fs, S + (int64_t)kk * 16 * npad, npad);
    wmma::load_matrix_sync(fd, dc + (int64_t)kk * 16 * D, D);
    wmma::load_matrix_sync(fq, Q + (int64_t)kk * 16 * ld3, ld3);
    wmma::mma_sync(dv, fp, fd, dv);
    wmma::mma_sync(dk, fs, fq, dk);
  }
  float* out = dqkv + ((int64_t)b * npad + j0 + rt * 16) * ld3 + h * BERT_DH + c0;
  wmma::store_matrix_sync(out + D, dk, ld3, wmma::mem_row_major);
  wmma::store_matrix_sync(out + 2 * D, dv, ld3, wmma::mem_row_major);
}

// dst = bf16(src) and colsum[c] += sum over this block's rows of src[:, c].
__global__ void __launch_bounds__(256)
bert_cast_colsum_kernel(const float* __restrict__ src, bf16* __restrict__ dst,
                        float* __restrict__ colsum, int M, int N, int rows) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  const int m0 = blockIdx.y * rows, m1 = min(m0 + rows, M);
  float s = 0.f;
  for (int m = m0; m < m1; ++m) {
    const float v = src[(int64_t)m * N + c];
    dst[(int64_t)m * N + c] = __float2bfloat16(v);
    s += v;
  }
  atomicAdd(colsum + c, s);
}

}  // namespace ctc

using namespace ctc;

// The inputs of ctc_bert_layer_bf16, the four weight matrices transposed
// (wqkvT [D, 3D], woT [D, D], w1T [D, F], w2T [F, D], bf16), and dout
// [B * npad, D] bf16. Workspaces: the forward's (pu required) and out_ws
// [M, D] bf16 for its output; dr2 (then dy) and dr1 [M, D] fp32; dob [M, D]
// bf16 (do2, then do1); dh1 [M, F] bf16; dctx [M, D] bf16; ds [B, heads, npad,
// npad] bf16; dqkv_f [M, 3D] fp32; dqkv_b [M, 3D] bf16. Outputs: dx [M, D]
// bf16 and, fp32 and zeroed by the caller (atomic sums), dwqkv [3D, D],
// dbqkv [3D], dwo [D, D], dbo, dg1, dbe1 [D], dw1 [F, D], db1 [F], dw2 [D, F],
// db2, dg2, dbe2 [D].
extern "C" int ctc_bert_layer_bwd(
    const void* x, const void* mask, const void* seeds, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, const void* g1, const void* be1, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* g2, const void* be2,
    const void* wqkvT, const void* woT, const void* w1T, const void* w2T, const void* dout,
    void* qkv, void* pu, void* ctx, void* r1, void* stats1, void* yf, void* yb, void* h1, void* g,
    void* r2, void* stats2, void* out_ws, void* dr2, void* dr1, void* dob, void* dh1, void* dctx,
    void* ds, void* dqkv_f, void* dqkv_b, void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
    void* dg1, void* dbe1, void* dw1, void* db1, void* dw2, void* db2, void* dg2, void* dbe2,
    int B, int n, int npad, int D, int F, int heads, float eps, float scale, unsigned thresh_attn,
    unsigned thresh_hidden, float scale_attn, float scale_hidden, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const BertWeights w{(const bf16*)wqkv, (const float*)bqkv, (const bf16*)wo, (const float*)bo,
                      (const float*)g1, (const float*)be1, (const bf16*)w1, (const float*)b1,
                      (const bf16*)w2, (const float*)b2, (const float*)g2, (const float*)be2};
  const BertWork ws{(bf16*)qkv, (bf16*)pu, (bf16*)ctx, (float*)r1, (float2*)stats1, (float*)yf,
                    (bf16*)yb, (float*)h1, (bf16*)g, (float*)r2, (float2*)stats2};
  const Dropout drop{(const int*)seeds, thresh_attn, thresh_hidden, scale_attn, scale_hidden};
  const bf16* xb = (const bf16*)x;
  const int M = B * npad;
  if (pu == nullptr) return (int)cudaErrorInvalidValue;
  int err = bert_forward_chain(xb, (const float*)mask, w, ws, (bf16*)out_ws, drop, B, n, npad, D,
                               F, heads, eps, scale, st);
  if (err != 0) return err;

  bf16* dobp = (bf16*)dob;
  bf16* dh1p = (bf16*)dh1;
  bf16* dctxp = (bf16*)dctx;
  // LN2 -> FF -> LN1
  launch_bert_ln_bwd((const bf16*)dout, ws.r2, ws.stats2, w.g2, drop, 2u, n, npad, (float*)dr2,
                     dobp, (float*)dg2, (float*)dbe2, (float*)db2, M, D, st);
  launch_wgrad(RowMajor{dobp, D, M, D}, RowMajor{ws.g, F, M, F}, (float*)dw2, F, D, F, M, st);
  launch_bert_gemm(dobp, D, (const bf16*)w2T, D, M, F, D, EpiGeluBwd{ws.h1, dh1p, F},
                   (float*)db1, st);
  launch_wgrad(RowMajor{dh1p, F, M, F}, RowMajor{ws.yb, D, M, D}, (float*)dw1, D, F, D, M, st);
  launch_bert_gemm(dh1p, F, (const bf16*)w1T, F, M, D, F, EpiAddF32{(float*)dr2, D}, nullptr, st);
  launch_bert_ln_bwd((const float*)dr2, ws.r1, ws.stats1, w.g1, drop, 1u, n, npad, (float*)dr1,
                     dobp, (float*)dg1, (float*)dbe1, (float*)dbo, M, D, st);
  // the attention out-projection
  launch_wgrad(RowMajor{dobp, D, M, D}, RowMajor{ws.ctx, D, M, D}, (float*)dwo, D, D, D, M, st);
  launch_gemm_nt<bf16>(dobp, D, (const bf16*)woT, D, dctxp, D, M, D, D, st);
  // the attention core
  const size_t smem = (size_t)2 * BA_Q * (npad + 8) * 4 + (size_t)BA_Q * (npad + 16) * 2;
  cudaFuncSetAttribute(bert_attn_bwd_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  bert_attn_bwd_q_kernel<<<dim3(npad / BA_Q, heads, B), BA_THREADS, smem, st>>>(
      ws.qkv, (const float*)mask, dctxp, drop, (bf16*)ds, (float*)dqkv_f, n, npad, D, heads,
      scale);
  bert_attn_bwd_kv_kernel<<<dim3(npad / 32, heads, B), BA_THREADS, 0, st>>>(
      ws.qkv, dctxp, ws.pu, (const bf16*)ds, (float*)dqkv_f, npad, D, heads);
  // the QKV projection
  const int rows = 64;
  bert_cast_colsum_kernel<<<dim3((3 * D + 255) / 256, (M + rows - 1) / rows), 256, 0, st>>>(
      (const float*)dqkv_f, (bf16*)dqkv_b, (float*)dbqkv, M, 3 * D, rows);
  launch_wgrad(RowMajor{(const bf16*)dqkv_b, 3 * D, M, 3 * D}, RowMajor{xb, D, M, D},
               (float*)dwqkv, D, 3 * D, D, M, st);
  launch_bert_gemm((const bf16*)dqkv_b, 3 * D, (const bf16*)wqkvT, 3 * D, M, D, 3 * D,
                   EpiAddToBf16{(const float*)dr1, (bf16*)dx, D}, nullptr, st);
  return (int)cudaGetLastError();
}
