// The fast-PPO minibatch gradient for Hopper (sm_90a).
//
// Replaces the Pallas kernels of gym_craftingworld_tpu/ops/fused_update.py:
// _kernel (:57, behind fused_minibatch_grads) and _kernel_prefetched (:270,
// behind fused_minibatch_grads_indexed). Both forms are the one entry point
// cw_ppo_grads below; the indexed form passes the minibatch's block ids, and
// row r of the minibatch then reads feature row ids[r / blk] * blk + r % blk.
// Plain version and rounding points: ops/fused_update.py.
//
// What bounds it: tensor-core products. At N = 131,072 rows, F = 67 and
// H = 512 a minibatch is ~2.3e11 FLOP in five products (x w1^T, h1 w2^T,
// dz2 w2, dz2^T h1, dz1^T x), all bf16 operands with f32 accumulation.
//
// Hopper differs from the TPU in two places, and the design answers both:
//
// * No sequential grid. The TPU summed the weight gradients in an output
//   block carried across grid steps. Blocks here run in parallel and in no
//   order, so each weight gradient is a split-K product: every split writes
//   its own f32 partial, and cw_reduce_kernel sums the partials in split
//   order. No atomics anywhere, so two launches give the same bits.
// * 227 KB of shared memory, not 100 MB of VMEM. The TPU kept a [2048, 512]
//   tile's activations and cotangents resident (~24 MB). Here the work is
//   split into passes that go through device memory: the forward writes
//   h1, h2 (bf16); a warp-per-row pass computes the heads, the loss, the
//   head cotangents and dz2; the backward writes dz1; then the weight
//   gradients read them back. At N = 131,072, H = 512 that is ~0.5 GB of
//   scratch traffic a minibatch which the TPU kernel never paid: the first
//   thing for a later version to remove (fuse the forward into the head
//   pass, keep h1/h2 tiles in shared memory).
//
// The products are one tiled kernel, cw_gemm: 64x64 output tiles, k-steps
// of 32, four warps each holding 2x2 wmma 16x16x16 bf16 fragments with f32
// accumulators; operand tiles are staged through shared memory with 16-byte
// loads where rows are 16-byte aligned (the F = 67 feature rows are not, and
// go element by element). The two 7-wide head products are SIMT: they are
// ~1% of the FLOP. wgmma, TMA and pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define CW_GM 64
#define CW_GN 64
#define CW_GK 32
#define CW_PAD 8
#define CW_GTHREADS 128
#define CW_TILE_ELEMS (CW_GM * (CW_GK + CW_PAD))  // >= CW_GK * (CW_GM + CW_PAD)
#define CW_NA 6     // actions; head row CW_NA is the value
#define CW_NH 7     // heads
#define CW_HSTRIDE 8  // f32 words per row of dheads

enum { EPI_RELU = 0, EPI_MASK = 1, EPI_PART = 2 };

// Operand element (o, i) = p[row(o) * stride + i], with i the contiguous
// index; row(o) = ids[o / blk] * blk + o % blk when ids is set, else o.
struct Operand {
  const bf16* p;
  long long stride;
  const int32_t* ids;
  int blk;
  int outer_lim, inner_lim;
};

struct Epilogue {
  bf16* out;          // EPI_RELU, EPI_MASK: bf16 [M, ldo]
  const float* bias;  // EPI_RELU
  const bf16* mask;   // EPI_MASK: keep where mask > 0
  float* part;        // EPI_PART: f32 [splits, M, N]
  int ldo;
};

__device__ __forceinline__ long long row_of(const Operand& op, int o) {
  return op.ids ? (long long)op.ids[o / op.blk] * op.blk + o % op.blk : (long long)o;
}

// Shared tile dst[O][I + PAD] <- operand (o0 + o, i0 + i), zero outside.
template <int O, int I>
__device__ __forceinline__ void load_tile(bf16* dst, const Operand& op, int o0, int i0) {
  constexpr int LD = I + CW_PAD;
  const bool vec = (op.stride % 8 == 0) && ((reinterpret_cast<uintptr_t>(op.p) & 15) == 0) &&
                   (i0 + I <= op.inner_lim);
  if (vec) {
    constexpr int CH = I / 8;
    for (int c = threadIdx.x; c < O * CH; c += CW_GTHREADS) {
      const int o = c / CH, i = (c % CH) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (o0 + o < op.outer_lim)
        v = *reinterpret_cast<const uint4*>(op.p + row_of(op, o0 + o) * op.stride + i0 + i);
      *reinterpret_cast<uint4*>(dst + o * LD + i) = v;
    }
  } else {
    for (int c = threadIdx.x; c < O * I; c += CW_GTHREADS) {
      const int o = c / I, i = c % I;
      bf16 v = __float2bfloat16(0.f);
      if (o0 + o < op.outer_lim && i0 + i < op.inner_lim)
        v = op.p[row_of(op, o0 + o) * op.stride + i0 + i];
      dst[o * LD + i] = v;
    }
  }
}

// C[M, N] = A[M, K] B[K, N] over the k-range of split blockIdx.z.
// A_K: A's contiguous index is k (else m). B_N: B's contiguous index is n
// (else k).
template <bool A_K, bool B_N, int EPI>
__global__ void __launch_bounds__(CW_GTHREADS)
    cw_gemm(Operand a, Operand b, int M, int N, int K, int kchunk, Epilogue e) {
  __shared__ __align__(32) bf16 As[CW_TILE_ELEMS];
  __shared__ __align__(32) bf16 Bs[CW_TILE_ELEMS];
  __shared__ __align__(32) float Cs[CW_GM][CW_GN + 4];
  using ALayout = typename std::conditional<A_K, wmma::row_major, wmma::col_major>::type;
  using BLayout = typename std::conditional<B_N, wmma::row_major, wmma::col_major>::type;

  const int m0 = blockIdx.x * CW_GM, n0 = blockIdx.y * CW_GN;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(K, kb + kchunk);
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = kb; k0 < ke; k0 += CW_GK) {
    if (A_K) load_tile<CW_GM, CW_GK>(As, a, m0, k0);
    else load_tile<CW_GK, CW_GM>(As, a, k0, m0);
    if (B_N) load_tile<CW_GK, CW_GN>(Bs, b, k0, n0);
    else load_tile<CW_GN, CW_GK>(Bs, b, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < CW_GK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (A_K) wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * (CW_GK + CW_PAD) + kk, CW_GK + CW_PAD);
        else wmma::load_matrix_sync(fa[i], As + kk * (CW_GM + CW_PAD) + wm + 16 * i, CW_GM + CW_PAD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (B_N) wmma::load_matrix_sync(fb[j], Bs + kk * (CW_GN + CW_PAD) + wn + 16 * j, CW_GN + CW_PAD);
        else wmma::load_matrix_sync(fb[j], Bs + (wn + 16 * j) * (CW_GK + CW_PAD) + kk, CW_GK + CW_PAD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j], CW_GN + 4, wmma::mem_row_major);
  __syncthreads();

  for (int c = threadIdx.x; c < CW_GM * CW_GN; c += CW_GTHREADS) {
    const int r = c / CW_GN, cc = c % CW_GN;
    const int m = m0 + r, n = n0 + cc;
    if (m >= M || n >= N) continue;
    const float v = Cs[r][cc];
    const size_t at = (size_t)m * e.ldo + n;
    if (EPI == EPI_RELU) {
      e.out[at] = __float2bfloat16(fmaxf(v + e.bias[n], 0.f));
    } else if (EPI == EPI_MASK) {
      e.out[at] = __bfloat162float(e.mask[at]) > 0.f ? __float2bfloat16(v) : __float2bfloat16(0.f);
    } else {
      e.part[((size_t)blockIdx.z * M + m) * N + n] = v;
    }
  }
}

// One warp per row: the 7 heads from h2, the clipped-surrogate loss terms,
// the head cotangents (f32, to dheads) and dz2 = mask(h2) * bf16(bf16(dheads) wlv).
__global__ void __launch_bounds__(256)
    cw_heads_kernel(const bf16* __restrict__ h2, const bf16* __restrict__ wlv,
                    const float* __restrict__ blv, const int32_t* __restrict__ action,
                    const float* __restrict__ old_lp, const float* __restrict__ old_v,
                    const float* __restrict__ adv_n, const float* __restrict__ ret,
                    float* __restrict__ dheads, bf16* __restrict__ dz2,
                    float* __restrict__ pg_row, float* __restrict__ v_row,
                    float* __restrict__ ent_row, int n, int h, float clip_eps,
                    float vf_coef, float ent_coef, float inv_n) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= n) return;
  const bf16* hr = h2 + (size_t)row * h;

  float acc[CW_NH];
#pragma unroll
  for (int a = 0; a < CW_NH; ++a) acc[a] = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float x = __bfloat162float(hr[c]);
#pragma unroll
    for (int a = 0; a < CW_NH; ++a) acc[a] += x * __bfloat162float(wlv[a * h + c]);
  }
#pragma unroll
  for (int a = 0; a < CW_NH; ++a)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[a] += __shfl_xor_sync(0xffffffffu, acc[a], off);
  // the xor butterfly leaves the same sums in every lane

  float lg[CW_NA], lsm[CW_NA], p[CW_NA];
#pragma unroll
  for (int a = 0; a < CW_NA; ++a) lg[a] = acc[a] + blv[a];
  float m = lg[0];
#pragma unroll
  for (int a = 1; a < CW_NA; ++a) m = fmaxf(m, lg[a]);
  const float value = acc[CW_NA] + blv[CW_NA];
  float s = 0.f;
#pragma unroll
  for (int a = 0; a < CW_NA; ++a) s += expf(lg[a] - m);
  const float lse = m + logf(s);
  const int act = action[row];
  float logp = 0.f, ent = 0.f;
#pragma unroll
  for (int a = 0; a < CW_NA; ++a) {
    lsm[a] = lg[a] - lse;
    p[a] = expf(lsm[a]);
    if (a == act) logp = lsm[a];
    ent += p[a] * lsm[a];
  }
  ent = -ent;
  const float advn = adv_n[row], ov = old_v[row], rt = ret[row];
  const float ratio = expf(logp - old_lp[row]);
  const float clipped = fminf(fmaxf(ratio, 1.f - clip_eps), 1.f + clip_eps);
  const float un = ratio * advn, cl = clipped * advn;
  const float pg = -fminf(un, cl);
  const float e = value - rt;
  const float dv = value - ov;
  const float ec = ov + fminf(fmaxf(dv, -clip_eps), clip_eps) - rt;
  const float vl = 0.5f * fmaxf(e * e, ec * ec);

  // backward; ties as autodiff of min/max takes them: the first argument
  const float dlogp = (un <= cl ? -advn * ratio : 0.f) * inv_n;
  const float dent = -ent_coef * inv_n;
  float dh[CW_NH];
#pragma unroll
  for (int a = 0; a < CW_NA; ++a)
    dh[a] = dlogp * ((a == act ? 1.f : 0.f) - p[a]) + dent * (-p[a] * (lsm[a] + ent));
  dh[CW_NA] = vf_coef * inv_n * (e * e >= ec * ec ? e : (fabsf(dv) < clip_eps ? ec : 0.f));

  if (lane < CW_HSTRIDE) {
    float mine = 0.f;
#pragma unroll
    for (int a = 0; a < CW_NH; ++a)
      if (lane == a) mine = dh[a];
    dheads[(size_t)row * CW_HSTRIDE + lane] = mine;
  }
  if (lane == 0) {
    pg_row[row] = pg;
    v_row[row] = vl;
    ent_row[row] = ent;
  }
  float dhb[CW_NH];
#pragma unroll
  for (int a = 0; a < CW_NH; ++a) dhb[a] = __bfloat162float(__float2bfloat16(dh[a]));
  bf16* dr = dz2 + (size_t)row * h;
  for (int c = lane; c < h; c += 32) {
    float g = 0.f;
#pragma unroll
    for (int a = 0; a < CW_NH; ++a) g += dhb[a] * __bfloat162float(wlv[a * h + c]);
    dr[c] = __bfloat162float(hr[c]) > 0.f ? __float2bfloat16(g) : __float2bfloat16(0.f);
  }
}

// Split s of the rows: partials of the head weight gradient bf16(dheads)^T h2
// [7, h], the head bias gradient sum(dheads) [7, padded to 8], and the
// bias gradients sum(dz1) [h] and sum(dz2) [h], laid out in that order.
__global__ void __launch_bounds__(256)
    cw_head_partial_kernel(const bf16* __restrict__ h2, const bf16* __restrict__ dz1,
                           const bf16* __restrict__ dz2, const float* __restrict__ dheads,
                           float* __restrict__ part, int n, int h, int chunk) {
  const int s = blockIdx.x;
  const int c = blockIdx.y * 256 + threadIdx.x;
  const int r0 = s * chunk, r1 = min(n, r0 + chunk);
  const bool col = c < h;
  const bool bias_lane = blockIdx.y == 0 && threadIdx.x < CW_NH;
  float g[CW_NH];
#pragma unroll
  for (int a = 0; a < CW_NH; ++a) g[a] = 0.f;
  float gb1 = 0.f, gb2 = 0.f, gbl = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float* dh = dheads + (size_t)r * CW_HSTRIDE;
    if (col) {
      const size_t at = (size_t)r * h + c;
      const float x = __bfloat162float(h2[at]);
#pragma unroll
      for (int a = 0; a < CW_NH; ++a) g[a] += __bfloat162float(__float2bfloat16(dh[a])) * x;
      gb1 += __bfloat162float(dz1[at]);
      gb2 += __bfloat162float(dz2[at]);
    }
    if (bias_lane) gbl += dh[threadIdx.x];
  }
  float* out = part + (size_t)s * (9 * h + CW_HSTRIDE);
  if (col) {
#pragma unroll
    for (int a = 0; a < CW_NH; ++a) out[a * h + c] = g[a];
    out[7 * h + CW_HSTRIDE + c] = gb1;
    out[8 * h + CW_HSTRIDE + c] = gb2;
  }
  if (blockIdx.y == 0 && threadIdx.x < CW_HSTRIDE) out[7 * h + threadIdx.x] = bias_lane ? gbl : 0.f;
}

// out[i] = sum over s in order of part[s][i]
__global__ void __launch_bounds__(256)
    cw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int splits,
                     long long len) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * len + i];
  out[i] = s;
}

static int kchunk_for(int K, int splits) {
  const int per = (K + splits - 1) / splits;
  return (per + CW_GK - 1) / CW_GK * CW_GK;
}

static Operand operand(const void* p, long long stride, int outer_lim, int inner_lim,
                       const void* ids = nullptr, int blk = 1) {
  return Operand{(const bf16*)p, stride, (const int32_t*)ids, blk, outer_lim, inner_lim};
}

static void launch_reduce(const float* part, float* out, int splits, long long len, cudaStream_t s) {
  cw_reduce_kernel<<<(unsigned)((len + 255) / 256), 256, 0, s>>>(part, out, splits, len);
}

// in:   x bf16 [rows, f], ids int32 [n / blk] or null, action int32 [n],
//       old_lp, old_v, adv_n, ret f32 [n], w1 bf16 [h, f], b1 f32 [h],
//       w2 bf16 [h, h], b2 f32 [h], wlv bf16 [7, h], blv f32 [7]
// work: h1, h2, dz1, dz2 bf16 [n, h], dheads f32 [n, 8],
//       part_w1 f32 [s_w1, h, f], part_w2 f32 [s_w2, h, h],
//       part_head f32 [s_head, 9h + 8]
// out:  gw1 f32 [h, f], gw2 f32 [h, h], ghead f32 [9h + 8] (gwlv [7, h],
//       gblv [8], gb1 [h], gb2 [h]), pg_row, v_row, ent_row f32 [n]
extern "C" int cw_ppo_grads(const void* const* in, void* const* work, void* const* out,
                            int n, int f, int h, int blk, int s_w1, int s_w2, int s_head,
                            float clip_eps, float vf_coef, float ent_coef, void* stream) {
  cudaGetLastError();
  if (n <= 0 || h <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const void *x = in[0], *ids = in[1];
  bf16 *h1 = (bf16*)work[0], *h2 = (bf16*)work[1], *dz1 = (bf16*)work[2], *dz2 = (bf16*)work[3];
  float* dheads = (float*)work[4];
  const dim3 blk_g(CW_GTHREADS);
  const unsigned mt = (n + CW_GM - 1) / CW_GM, ht = (h + CW_GN - 1) / CW_GN;
  const unsigned ft = (f + CW_GN - 1) / CW_GN;

  // forward: h1 = bf16(relu(x w1^T + b1)), h2 = bf16(relu(h1 w2^T + b2))
  Epilogue e{};
  e.out = h1; e.bias = (const float*)in[8]; e.ldo = h;
  cw_gemm<true, false, EPI_RELU><<<dim3(mt, ht, 1), blk_g, 0, st>>>(
      operand(x, f, n, f, ids, blk), operand(in[7], f, h, f), n, h, f, kchunk_for(f, 1), e);
  e.out = h2; e.bias = (const float*)in[10];
  cw_gemm<true, false, EPI_RELU><<<dim3(mt, ht, 1), blk_g, 0, st>>>(
      operand(h1, h, n, h), operand(in[9], h, h, h), n, h, h, kchunk_for(h, 1), e);

  // heads, loss terms, head cotangents, dz2
  cw_heads_kernel<<<(n + 7) / 8, 256, 0, st>>>(
      h2, (const bf16*)in[11], (const float*)in[12], (const int32_t*)in[2],
      (const float*)in[3], (const float*)in[4], (const float*)in[5], (const float*)in[6],
      dheads, dz2, (float*)out[3], (float*)out[4], (float*)out[5], n, h, clip_eps,
      vf_coef, ent_coef, (float)(1.0 / n));

  // dz1 = mask(h1) * bf16(dz2 w2)
  e = Epilogue{};
  e.out = dz1; e.mask = h1; e.ldo = h;
  cw_gemm<true, true, EPI_MASK><<<dim3(mt, ht, 1), blk_g, 0, st>>>(
      operand(dz2, h, n, h), operand(in[9], h, h, h), n, h, h, kchunk_for(h, 1), e);

  // weight gradients, split over rows: dz2^T h1 and dz1^T x
  e = Epilogue{};
  e.part = (float*)work[6];
  cw_gemm<false, true, EPI_PART><<<dim3(ht, ht, s_w2), blk_g, 0, st>>>(
      operand(dz2, h, n, h), operand(h1, h, n, h), h, h, n, kchunk_for(n, s_w2), e);
  e.part = (float*)work[5];
  cw_gemm<false, true, EPI_PART><<<dim3(ht, ft, s_w1), blk_g, 0, st>>>(
      operand(dz1, h, n, h), operand(x, f, n, f, ids, blk), h, f, n, kchunk_for(n, s_w1), e);
  cw_head_partial_kernel<<<dim3(s_head, (h + 255) / 256), 256, 0, st>>>(
      h2, dz1, dz2, dheads, (float*)work[7], n, h, (n + s_head - 1) / s_head);

  launch_reduce((const float*)work[6], (float*)out[1], s_w2, (long long)h * h, st);
  launch_reduce((const float*)work[5], (float*)out[0], s_w1, (long long)h * f, st);
  launch_reduce((const float*)work[7], (float*)out[2], s_head, 9LL * h + CW_HSTRIDE, st);
  return (int)cudaGetLastError();
}
