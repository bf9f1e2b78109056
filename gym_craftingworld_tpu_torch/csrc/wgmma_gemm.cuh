// One bf16 product routine for Hopper (sm_90a): C[M, N] = A[M, K] B[N, K]^T
// with f32 accumulation on wgmma, both operands K-major (row-major, K
// contiguous, rows 16-byte aligned).
//
// Block tile 128 (M) x 128 (N), k-step 64 (128 bytes of bf16: one 128-byte
// swizzle row). Two warpgroups (256 threads); warpgroup g owns rows
// 64g .. 64g + 63 and runs wgmma m64n128k16 four times a k-step, its 64 x 128
// f32 sum in 64 registers a thread. No warp specialisation and no TMA: every
// thread makes 16-byte cp.async copies into a ring of CW_STAGES stages of
// 32 KB (A 16 KB, B 16 KB), each 1024-byte aligned, in the 128-byte swizzled
// layout that the descriptors name: chunk c (0-7) of tile row r lands at byte
// r * 128 + ((c ^ (r & 7)) * 16). Rows past M or N and chunks past K are
// zero-filled through cp.async's source size.
//
// Split-K: blockIdx.z is a split of the k-range (kchunk rows each, a multiple
// of CW_BK); EPI_PART writes each split's own f32 partial, summed later in
// split order (no atomics, so two launches give the same bits).
//
// Epilogues stage the tile's sums through shared memory (reusing the ring),
// then store coalesced: EPI_PART f32; EPI_RELU bf16(relu(v + bias[n])) and
// EPI_MASK (mask[m, n] > 0 ? bf16(v) : 0), 16 bytes a store (N a multiple of
// 8). RELU and MASK may also write the transposed copy out_t[n, m] that a
// later product reads K-major; its columns M <= m < ldt are written as zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CW_BM 128
#define CW_BN 128
#define CW_BK 64
#define CW_STAGES 3
#define CW_GEMM_THREADS 256
#define CW_TILE_BYTES (CW_BM * CW_BK * 2)      // 16 KB; CW_BN == CW_BM
#define CW_STAGE_BYTES (2 * CW_TILE_BYTES)     // A tile then B tile
#define CW_CS_LD (CW_BN + 1)                   // f32 words a row of the staged tile
#define CW_GEMM_SMEM (CW_STAGES * CW_STAGE_BYTES + 1024)  // + slack to align to 1024

static_assert(CW_BM == CW_BN, "A and B tiles share one size");
static_assert(CW_BM * CW_CS_LD * 4 <= CW_STAGES * CW_STAGE_BYTES,
              "the epilogue's staged tile fits in the ring");

enum { EPI_RELU = 0, EPI_MASK = 1, EPI_PART = 2 };

struct Epilogue {
  __nv_bfloat16* out;          // RELU, MASK: bf16 [M, ldo]
  __nv_bfloat16* out_t;        // optional: bf16 [N, ldt], out transposed
  const float* bias;           // RELU: f32 [N]
  const __nv_bfloat16* mask;   // MASK: bf16 [M, ldo]
  float* part;                 // PART: f32 [splits, M, N]
  int ldo, ldt;
};

__device__ __forceinline__ void cw_cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cw_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cw_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's generic-proxy writes to shared memory (cp.async
// included) visible to the async proxy, which wgmma reads through.
__device__ __forceinline__ void cw_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accesses to the accumulators across the
// wgmma fence and wait: wgmma writes them asynchronously.
__device__ __forceinline__ void cw_fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// K-major operand, 128-byte swizzle: start address >> 4 (bits 0-13), leading
// byte offset 1 (unused for this layout, bits 16-29), stride byte offset
// 1024 >> 4 between 8-row groups (bits 32-45), layout type 1 = 128B swizzle
// (bits 62-63).
__device__ __forceinline__ uint64_t cw_sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64] += A (64 x 16, desc a) B^T (128 x 16, desc b); both K-major.
__device__ __forceinline__ void cw_wgmma_m64n128k16(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Copies k-step [k0, k0 + CW_BK) of the A rows m0.. and B rows n0.. into the
// stage at shared address st: 1024 16-byte chunks an operand, 4 a thread.
__device__ __forceinline__ void cw_load_stage(uint32_t st, const __nv_bfloat16* a, int lda,
                                              const __nv_bfloat16* b, int ldb, int M, int N,
                                              int K, int m0, int n0, int k0) {
#pragma unroll
  for (int i = 0; i < CW_BM * 8 / CW_GEMM_THREADS; ++i) {
    const int q = threadIdx.x + i * CW_GEMM_THREADS, r = q >> 3, c = q & 7;
    const int k = k0 + c * 8;
    const uint32_t off = r * 128 + ((c ^ (r & 7)) << 4);
    const bool va = k < K && m0 + r < M, vb = k < K && n0 + r < N;
    cw_cp_async16(st + off, va ? a + (size_t)(m0 + r) * lda + k : a, va ? 16 : 0);
    cw_cp_async16(st + CW_TILE_BYTES + off, vb ? b + (size_t)(n0 + r) * ldb + k : b,
                  vb ? 16 : 0);
  }
}

// Two blocks an SM: 128 registers a thread, 2 x 97 KB of shared memory.
template <int EPI>
__global__ void __launch_bounds__(CW_GEMM_THREADS, 2)
    cw_wgmma_gemm(const __nv_bfloat16* __restrict__ a, int lda,
                  const __nv_bfloat16* __restrict__ b, int ldb, int M, int N, int K,
                  int kchunk, Epilogue e) {
  extern __shared__ uint8_t cw_smem_raw[];
  uint8_t* smem = (uint8_t*)(((uintptr_t)cw_smem_raw + 1023) & ~(uintptr_t)1023);
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * CW_BM, n0 = blockIdx.x * CW_BN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  const int nk = (ke - kb + CW_BK - 1) / CW_BK;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < CW_STAGES - 1; ++s) {
    if (s < nk) cw_load_stage(sbase + s * CW_STAGE_BYTES, a, lda, b, ldb, M, N, K, m0, n0,
                              kb + s * CW_BK);
    cw_cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = 0; kt < nk; ++kt) {
    cw_cp_async_wait<CW_STAGES - 2>();  // this thread's copies of step kt landed
    cw_fence_proxy_async();
    __syncthreads();  // everyone's copies landed; slot (kt - 1) % CW_STAGES is free
    cw_fence_proxy_async();
    const int nxt = kt + CW_STAGES - 1;
    if (nxt < nk) cw_load_stage(sbase + (nxt % CW_STAGES) * CW_STAGE_BYTES, a, lda, b, ldb,
                                M, N, K, m0, n0, kb + nxt * CW_BK);
    cw_cp_async_commit();
    const uint32_t sa = sbase + (kt % CW_STAGES) * CW_STAGE_BYTES + wg * (64 * 128);
    const uint32_t sb = sbase + (kt % CW_STAGES) * CW_STAGE_BYTES + CW_TILE_BYTES;
    cw_fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < CW_BK / 16; ++kk)  // 32 bytes along the swizzled row a k16
      cw_wgmma_m64n128k16(acc, cw_sw128_desc(sa + kk * 32), cw_sw128_desc(sb + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    cw_fence_acc(acc);
  }
  cw_cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the tile there

  // wgmma's f32 accumulator layout: warp w of the warpgroup holds rows
  // 16w .. 16w + 15; lane l rows l / 4 and l / 4 + 8, columns 8j + 2(l % 4) + {0, 1}.
  float* cs = reinterpret_cast<float*>(smem);
  {
    const int lane = tid & 31, row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < CW_BN / 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      cs[row * CW_CS_LD + col] = acc[4 * j];
      cs[row * CW_CS_LD + col + 1] = acc[4 * j + 1];
      cs[(row + 8) * CW_CS_LD + col] = acc[4 * j + 2];
      cs[(row + 8) * CW_CS_LD + col + 1] = acc[4 * j + 3];
    }
  }
  __syncthreads();

  if (EPI == EPI_PART) {
    float* part = e.part + (size_t)blockIdx.z * M * N;
    for (int i = tid; i < CW_BM * CW_BN; i += CW_GEMM_THREADS) {
      const int r = i / CW_BN, c = i % CW_BN, m = m0 + r, n = n0 + c;
      if (m < M && n < N) part[(size_t)m * N + n] = cs[r * CW_CS_LD + c];
    }
    return;
  }
  // 8 bf16 along n a thread: out[m, n .. n + 7] (N, ldo and n multiples of 8).
  // A warp takes 8 rows x 4 groups of 8 columns, so its cs accesses hit 32
  // banks. The finished values go back into cs for the transposed pass.
  for (int i = tid; i < CW_BM * CW_BN / 8; i += CW_GEMM_THREADS) {
    const int w = i >> 5, lane = i & 31;
    const int r = (w >> 2) * 8 + (lane & 7), c = ((w & 3) * 4 + (lane >> 3)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float* row = cs + r * CW_CS_LD + c;
    __align__(16) __nv_bfloat16 v[8];
    if (EPI == EPI_RELU) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(fmaxf(row[j] + e.bias[n + j], 0.f));
    } else {
      __align__(16) __nv_bfloat16 mk[8];
      *reinterpret_cast<uint4*>(mk) =
          *reinterpret_cast<const uint4*>(e.mask + (size_t)m * e.ldo + n);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = __bfloat162float(mk[j]) > 0.f ? __float2bfloat16(row[j]) : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) row[j] = __bfloat162float(v[j]);
    *reinterpret_cast<uint4*>(e.out + (size_t)m * e.ldo + n) = *reinterpret_cast<uint4*>(v);
  }
  if (e.out_t == nullptr) return;
  __syncthreads();
  // 8 bf16 along m a thread: out_t[n, m .. m + 7] (ldt and m multiples of 8).
  // A warp takes 8 columns x 4 groups of 8 rows: 32 banks again.
  for (int i = tid; i < CW_BN * CW_BM / 8; i += CW_GEMM_THREADS) {
    const int w = i >> 5, lane = i & 31;
    const int c = (w & 15) * 8 + (lane & 7), r = ((w >> 4) * 4 + (lane >> 3)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (n >= N || m >= e.ldt) continue;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = __float2bfloat16(m + j < M ? cs[(r + j) * CW_CS_LD + c] : 0.f);
    *reinterpret_cast<uint4*>(e.out_t + (size_t)n * e.ldt + m) = *reinterpret_cast<uint4*>(v);
  }
}

// Launches the product over a grid of (N, M) tiles x ceil(K / kchunk) splits.
// N tiles run fastest, so the blocks that read one A row block run together
// and A comes from device memory once, not once per N tile.
template <int EPI>
static cudaError_t cw_launch_gemm(const __nv_bfloat16* a, int lda, const __nv_bfloat16* b,
                                  int ldb, int M, int N, int K, int kchunk, const Epilogue& e,
                                  cudaStream_t st) {
  // cp.async and the bf16 epilogues move 16 bytes at a time: every row they
  // touch starts on a 16-byte boundary
  const uintptr_t misaligned = ((uintptr_t)a | (uintptr_t)b) & 15;
  const uintptr_t misaligned_epi =
      ((uintptr_t)e.out | (uintptr_t)e.out_t | (uintptr_t)e.mask) & 15;
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || lda % 8 || ldb % 8 || kchunk <= 0 ||
      kchunk % CW_BK || misaligned ||
      (EPI != EPI_PART && (N % 8 || e.ldo % 8 || (e.out_t && e.ldt % 8) || misaligned_epi)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cw_wgmma_gemm<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, CW_GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + CW_BN - 1) / CW_BN, (M + CW_BM - 1) / CW_BM, (K + kchunk - 1) / kchunk);
  cw_wgmma_gemm<EPI><<<grid, CW_GEMM_THREADS, CW_GEMM_SMEM, st>>>(a, lda, b, ldb, M, N, K,
                                                                 kchunk, e);
  return cudaGetLastError();
}
