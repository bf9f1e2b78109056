// The fast-PPO minibatch gradient for Hopper (sm_90a).
//
// Replaces the Pallas kernels of gym_craftingworld_tpu/ops/fused_update.py:
// _kernel (:57, behind fused_minibatch_grads) and _kernel_prefetched (:270,
// behind fused_minibatch_grads_indexed). Both forms are the one entry point
// cw_ppo_grads below; the indexed form passes the minibatch's block ids, and
// row r of the minibatch then reads feature row ids[r / blk] * blk + r % blk,
// with an out-of-range id wrapped and clamped as JAX's gather does (cw_pad_kernel).
// Plain version and rounding points: ops/fused_update.py.
//
// What bounds it: tensor-core products. At N = 131,072 rows, F = 67 and
// H = 512 a minibatch is ~2.3e11 FLOP in five products (x w1^T, h1 w2^T,
// dz2 w2, dz2^T h1, dz1^T x), all bf16 operands with f32 accumulation: 0.23 ms
// at the H100's 989 TFLOP/s. The bytes it must move (~22 MB) take ~7 us.
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
//   gradients read them back. At N = 131,072, H = 512 that is ~1 GB of
//   scratch traffic a minibatch which the TPU kernel never paid: the first
//   thing for a later version to remove (fuse the forward into the head
//   pass, keep h1/h2 tiles in shared memory).
//
// All five products are one routine, cw_wgmma_gemm (wgmma_gemm.cuh):
// C = A B^T with both operands K-major, fed by cp.async into a ring of
// 128-byte-swizzled stages. The operands that are not K-major as the
// passes produce them get a K-major copy: the z1 and dz1 epilogues also
// write h1^T and dz1^T, a transpose kernel writes dz2^T and w2^T, and a pad
// pass gathers the minibatch's feature rows (by block id in the indexed
// form) into x_pad [n, 128] and x_pad^T [128, ldt], zero beyond column F,
// beside w1_pad [H, 128]. Transposed copies have ldt = n rounded up to 8
// columns, the ones past n zero, so the weight gradients sum over ldt rows.
// The two 7-wide head products are SIMT: they are ~1% of the FLOP.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_gemm.cuh"

typedef __nv_bfloat16 bf16;

#define CW_FPAD 128   // feature columns padded for the products
#define CW_NA 6     // actions; head row CW_NA is the value
#define CW_NH 7     // heads
#define CW_HSTRIDE 8  // f32 words per row of dheads
#define CW_PAD_ROWS 64  // rows a block of cw_pad_kernel

// dst[r, c] = src[row(r), c] for c < f, 0 for f <= c < CW_FPAD, r < rows, with
// row(r) = id(r / blk) * blk + r % blk when ids is set, else r; and, when
// dst_t is set, dst_t[c, r] the same for r < ldt (0 for r >= rows). id(i) is
// block ids[i] of src's nb blocks as featb[ids] gathers it in JAX: a negative
// id wraps once, then the id clamps into [0, nb - 1].
__global__ void __launch_bounds__(256)
    cw_pad_kernel(const bf16* __restrict__ src, const int32_t* __restrict__ ids, int blk, int nb,
                  int rows, int f, bf16* __restrict__ dst, bf16* __restrict__ dst_t, int ldt) {
  __shared__ bf16 tile[CW_PAD_ROWS][CW_FPAD + 2];
  const int r0 = blockIdx.x * CW_PAD_ROWS;
  for (int i = threadIdx.x; i < CW_PAD_ROWS * CW_FPAD; i += 256) {
    const int r = i / CW_FPAD, c = i % CW_FPAD, row = r0 + r;
    bf16 v = __float2bfloat16(0.f);
    if (row < rows && c < f) {
      long long at = row;
      if (ids) {
        int id = ids[row / blk];
        id = id < 0 ? id + nb : id;
        id = min(max(id, 0), nb - 1);
        at = (long long)id * blk + row % blk;
      }
      v = src[at * f + c];
    }
    tile[r][c] = v;
    if (row < rows) dst[(size_t)row * CW_FPAD + c] = v;
  }
  if (dst_t == nullptr) return;
  __syncthreads();
  for (int i = threadIdx.x; i < CW_PAD_ROWS * CW_FPAD; i += 256) {
    const int c = i / CW_PAD_ROWS, r = i % CW_PAD_ROWS;
    if (r0 + r < ldt) dst_t[(size_t)c * ldt + r0 + r] = tile[r][c];
  }
}

// dst[c, r] = src[r, c] for r < rows, 0 for rows <= r < ldd; src is [rows, cols].
__global__ void __launch_bounds__(256)
    cw_transpose_kernel(const bf16* __restrict__ src, int rows, int cols,
                        bf16* __restrict__ dst, int ldd) {
  __shared__ bf16 t[32][34];
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    t[i][threadIdx.x] = (r < rows && c < cols) ? src[(size_t)r * cols + c] : __float2bfloat16(0.f);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (c < cols && r < ldd) dst[(size_t)c * ldd + r] = t[threadIdx.x][i];
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

// out[r, c] = sum over s in order of part[s, r, c], for c < ow; part is
// f32 [splits, rows, pw].
__global__ void __launch_bounds__(256)
    cw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int splits,
                     int rows, int pw, int ow) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)rows * ow) return;
  const float* p = part + (i / ow) * pw + i % ow;
  const size_t len = (size_t)rows * pw;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += p[k * len];
  out[i] = s;
}

static void launch_reduce(const float* part, float* out, int splits, int rows, int pw, int ow,
                          cudaStream_t s) {
  const long long len = (long long)rows * ow;
  cw_reduce_kernel<<<(unsigned)((len + 255) / 256), 256, 0, s>>>(part, out, splits, rows, pw, ow);
}

static void launch_transpose(const bf16* src, int rows, int cols, bf16* dst, int ldd,
                             cudaStream_t s) {
  cw_transpose_kernel<<<dim3((ldd + 31) / 32, (cols + 31) / 32), dim3(32, 8), 0, s>>>(
      src, rows, cols, dst, ldd);
}

// True when s splits of kc rows each cover k rows exactly: the last split
// holds at least one row.
static bool covers(int k, int s, int kc) {
  return s > 0 && kc > 0 && (long long)(s - 1) * kc < k && (long long)s * kc >= k;
}

#define CW_TRY(x)                              \
  do {                                         \
    const cudaError_t err_ = (x);              \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

// in:   x bf16 [rows, f] (nb blocks of blk rows), ids int32 [n / blk] or null,
//       action int32 [n],
//       old_lp, old_v, adv_n, ret f32 [n], w1 bf16 [h, f], b1 f32 [h],
//       w2 bf16 [h, h], b2 f32 [h], wlv bf16 [7, h], blv f32 [7]
// work: h1, h2, dz1, dz2 bf16 [n, h], dheads f32 [n, 8],
//       part_w1 f32 [s_w1, h, 128], part_w2 f32 [s_w2, h, h],
//       part_head f32 [s_head, 9h + 8], h1_t, dz1_t, dz2_t bf16 [h, ldt],
//       x_pad bf16 [n, 128], x_pad_t bf16 [128, ldt], w1_pad bf16 [h, 128],
//       w2_t bf16 [h, h]
// plan: ldt (n rounded up to a multiple of 8), s_w* splits of kc_w* rows
//       over ldt, s_head: the caller's plan (ops/fused_update.py ppo_plan),
//       which sized the work buffers; it is checked here, not remade
// out:  gw1 f32 [h, f], gw2 f32 [h, h], ghead f32 [9h + 8] (gwlv [7, h],
//       gblv [8], gb1 [h], gb2 [h]), pg_row, v_row, ent_row f32 [n]
// inv_n: 1 / the rows of the whole minibatch, of which these n rows may be a
//       shard (1 / n when they are all of it)
extern "C" int cw_ppo_grads(const void* const* in, void* const* work, void* const* out,
                            int n, int f, int h, int blk, int nb, int ldt, int s_w1, int kc_w1,
                            int s_w2, int kc_w2, int s_head, float clip_eps, float vf_coef,
                            float ent_coef, float inv_n, void* stream) {
  cudaGetLastError();
  if (n <= 0 || h <= 0 || f <= 0 || f > CW_FPAD || h % 8 || ldt < n || ldt % 8 || nb <= 0 ||
      ldt - n >= 8 || !covers(ldt, s_w1, kc_w1) || !covers(ldt, s_w2, kc_w2) || s_head <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int kc_h = (h + CW_BK - 1) / CW_BK * CW_BK;  // one split
  const bf16 *x = (const bf16*)in[0], *w1 = (const bf16*)in[7], *w2 = (const bf16*)in[9];
  bf16 *h1 = (bf16*)work[0], *h2 = (bf16*)work[1], *dz1 = (bf16*)work[2], *dz2 = (bf16*)work[3];
  float* dheads = (float*)work[4];
  bf16 *h1_t = (bf16*)work[8], *dz1_t = (bf16*)work[9], *dz2_t = (bf16*)work[10];
  bf16 *x_pad = (bf16*)work[11], *x_pad_t = (bf16*)work[12], *w1_pad = (bf16*)work[13];
  bf16* w2_t = (bf16*)work[14];

  // K-major operands: the minibatch's padded features and their transpose,
  // w1 padded, w2 transposed
  cw_pad_kernel<<<(ldt + CW_PAD_ROWS - 1) / CW_PAD_ROWS, 256, 0, st>>>(
      x, (const int32_t*)in[1], blk, nb, n, f, x_pad, x_pad_t, ldt);
  cw_pad_kernel<<<(h + CW_PAD_ROWS - 1) / CW_PAD_ROWS, 256, 0, st>>>(
      w1, nullptr, 1, 1, h, f, w1_pad, nullptr, 0);
  launch_transpose(w2, h, h, w2_t, h, st);

  // forward: h1 = bf16(relu(x w1^T + b1)) and h1^T, h2 = bf16(relu(h1 w2^T + b2))
  Epilogue e{};
  e.out = h1; e.out_t = h1_t; e.bias = (const float*)in[8]; e.ldo = h; e.ldt = ldt;
  CW_TRY(cw_launch_gemm<EPI_RELU>(x_pad, CW_FPAD, w1_pad, CW_FPAD, n, h, CW_FPAD, CW_FPAD, e, st));
  e = Epilogue{};
  e.out = h2; e.bias = (const float*)in[10]; e.ldo = h;
  CW_TRY(cw_launch_gemm<EPI_RELU>(h1, h, w2, h, n, h, h, kc_h, e, st));

  // heads, loss terms, head cotangents, dz2; then dz2^T
  cw_heads_kernel<<<(n + 7) / 8, 256, 0, st>>>(
      h2, (const bf16*)in[11], (const float*)in[12], (const int32_t*)in[2],
      (const float*)in[3], (const float*)in[4], (const float*)in[5], (const float*)in[6],
      dheads, dz2, (float*)out[3], (float*)out[4], (float*)out[5], n, h, clip_eps,
      vf_coef, ent_coef, inv_n);
  launch_transpose(dz2, n, h, dz2_t, ldt, st);

  // dz1 = mask(h1) * bf16(dz2 w2) and dz1^T
  e = Epilogue{};
  e.out = dz1; e.out_t = dz1_t; e.mask = h1; e.ldo = h; e.ldt = ldt;
  CW_TRY(cw_launch_gemm<EPI_MASK>(dz2, h, w2_t, h, n, h, h, kc_h, e, st));

  // weight gradients, split over rows: dz2^T h1 and dz1^T x_pad
  e = Epilogue{};
  e.part = (float*)work[6];
  CW_TRY(cw_launch_gemm<EPI_PART>(dz2_t, ldt, h1_t, ldt, h, h, ldt, kc_w2, e, st));
  e.part = (float*)work[5];
  CW_TRY(cw_launch_gemm<EPI_PART>(dz1_t, ldt, x_pad_t, ldt, h, CW_FPAD, ldt, kc_w1, e, st));
  cw_head_partial_kernel<<<dim3(s_head, (h + 255) / 256), 256, 0, st>>>(
      h2, dz1, dz2, dheads, (float*)work[7], n, h, (n + s_head - 1) / s_head);

  launch_reduce((const float*)work[6], (float*)out[1], s_w2, 1, h * h, h * h, st);
  launch_reduce((const float*)work[5], (float*)out[0], s_w1, h, CW_FPAD, f, st);
  launch_reduce((const float*)work[7], (float*)out[2], s_head, 1, 9 * h + CW_HSTRIDE,
                9 * h + CW_HSTRIDE, st);
  return (int)cudaGetLastError();
}

// The product core alone: out f32 [M, N] = a [M, K] b [N, K]^T (bf16, K-major),
// split over K into `splits` chunks of kchunk; part f32 [splits, M, N], or out
// itself when there is one split.
extern "C" int cw_gemm_bf16(const void* a, const void* b, void* part, void* out, int M, int N,
                            int K, int splits, int kchunk, void* stream) {
  cudaGetLastError();
  if (!covers(K, splits, kchunk) || (splits == 1) != (part == out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Epilogue e{};
  e.part = (float*)part;
  CW_TRY(cw_launch_gemm<EPI_PART>((const bf16*)a, K, (const bf16*)b, K, M, N, K, kchunk, e, st));
  if (part != out) launch_reduce((const float*)part, (float*)out, splits, 1, M * N, M * N, st);
  return (int)cudaGetLastError();
}
