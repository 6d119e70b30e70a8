// Register-resident pieces of the bf16 flash kernels for Hopper
// (flash_fwd_mma_kernel in flash_attention_fwd.cu, flash_bwd_dq_mma_kernel
// and flash_bwd_dkv_mma_kernel in flash_attention_bwd.cu): tensor-core
// fragments of mma.sync.m16n8k16 (bf16 in, fp32 accumulators), ldmatrix
// loads of them from shared memory, and row staging by 16-byte cp.async for
// a ring of tiles.
//
// Each warp owns 16 rows of the block's resident tile. Its m16n8
// accumulator fragment gives thread (lane) the rows lane/4 and lane/4 + 8
// and the columns 2 (lane % 4) + {0, 1} of every 8-column block: c[0], c[1]
// on the first row, c[2], c[3] on the second. Two neighbouring 8-column blocks of an accumulator, rounded to
// bf16, are the A fragment of the next product over those 16 columns, so
// probabilities never leave registers.
//
// Shared tiles are row-major with a row stride of DP + 8 elements (DP, the
// staged head dim, a multiple of 16): 16-byte rows for cp.async and
// ldmatrix, and eight ldmatrix row addresses fall on distinct banks.

#pragma once

#include "flash_attention_common.cuh"

namespace flash {
namespace mma {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lanes 8m..8m+7 give the row addresses of matrix m.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: a 16x16 (row-major A fragment), b 16x8 (b0, b1), d 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of 16 rows x 16 columns at (row0, col0) of a row-major
// tile with row stride ld (elements).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int row0,
                                       int col0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, smem_addr(tile + (row0 + lane % 16) * ld + col0 + (lane / 16) * 8));
}

// B fragments of two 8-column blocks of B = T^T for a row-major tile T:
// B's columns are T's rows row0..row0+15, B's depth T's columns
// col0..col0+15. b[0], b[1] for the first block, b[2], b[3] the second.
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* tile, int ld,
                                            int row0, int col0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, smem_addr(tile + (row0 + lane % 8 + (lane / 16) * 8) * ld + col0 +
                       ((lane / 8) % 2) * 8));
}

// B fragments of two 8-column blocks of B = T for a row-major tile T: B's
// depth is T's rows row0..row0+15, B's columns T's columns col0..col0+15.
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* tile, int ld,
                                            int row0, int col0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(b, smem_addr(tile + (row0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + col0 +
                             (lane / 16) * 8));
}

// acc[NB][4] (16 x 8 NB) += A (16 x 16 KS, A fragments a[KS]) times B =
// the tile's rows 0..16 KS (the depth), columns 0..8 NB (load_b_cols).
template <int KS, int NB>
__device__ __forceinline__ void mma_a_cols(float (&acc)[NB][4], const uint32_t (&a)[KS][4],
                                           const bf16* tile, int ld) {
  static_assert(NB % 2 == 0, "B fragments load in pairs of 8-column blocks");
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t b[4];
      load_b_cols(b, tile, ld, kk * 16, np * 16);
      mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// acc[NB][4] (16 x 8 NB) += A (16 x 16 KS, A fragments a[KS]) times the
// transpose of the tile's rows 0..8 NB: the product over the tile's
// columns 0..16 KS (the head dim) of two row-major tiles (load_b_rows).
template <int KS, int NB>
__device__ __forceinline__ void mma_a_rows(float (&acc)[NB][4], const uint32_t (&a)[KS][4],
                                           const bf16* tile, int ld) {
  static_assert(NB % 2 == 0, "B fragments load in pairs of 8-column blocks");
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t b[4];
      load_b_rows(b, tile, ld, np * 16, kk * 16);
      mma_bf16(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// The A fragments of rows row0..row0+15, columns 0..16 KS of a row-major
// tile.
template <int KS>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[KS][4], const bf16* tile, int ld,
                                            int row0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a(a[kk], tile, ld, row0, kk * 16);
}

template <int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
}

// The A fragments (16 rows x 8 NB columns, NB / 2 steps of 16) of an fp32
// accumulator of NB 8-column blocks, rounded to bf16.
template <int NB>
__device__ __forceinline__ void to_a(uint32_t (&a)[NB / 2][4], const float (&c)[NB][4]) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// 2^x on the special-function unit, denormal results flushed to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's committed cp.async groups
// are still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

template <int W, int ROWS, int NT>
__device__ __forceinline__ void stage_words(bf16* dst, int ld, int cols_pad, const bf16* src,
                                            int rows_valid, int cols) {
  constexpr int E = sizeof(bf16);
  const int w = cols * E / W;          // words per source row
  const int w_pad = cols_pad * E / W;  // words per staged row
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  for (int idx = threadIdx.x; idx < ROWS * w_pad; idx += NT) {
    const int r = idx / w_pad;
    const int c = idx - r * w_pad;
    const bool valid = r < rows_valid && c < w;
    cp_async<W>(d + ((size_t)r * ld * E + (size_t)W * c),
                valid ? s + ((size_t)r * cols * E + (size_t)W * c) : s, valid ? W : 0);
  }
}

// Stage src rows [0, rows_valid) ([*, cols] row-major bf16) into
// dst[ROWS][ld] columns [0, cols_pad), zero-filling rows >= rows_valid and
// columns >= cols, with NT threads: 16-byte (else 4-byte) asynchronous
// words where the row length and the address allow it, committed by the
// caller; else element by element. dst rows are 16-byte aligned and
// cols_pad is a multiple of 16.
template <int ROWS, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, int cols_pad,
                                           const bf16* __restrict__ src, int rows_valid,
                                           int cols) {
  constexpr int E = sizeof(bf16);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  if ((cols * E) % 16 == 0 && addr % 16 == 0) {
    stage_words<16, ROWS, NT>(dst, ld, cols_pad, src, rows_valid, cols);
  } else if ((cols * E) % 4 == 0 && addr % 4 == 0) {
    stage_words<4, ROWS, NT>(dst, ld, cols_pad, src, rows_valid, cols);
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int idx = threadIdx.x; idx < ROWS * cols_pad; idx += NT) {
      const int r = idx / cols_pad;
      const int c = idx - r * cols_pad;
      dst[r * ld + c] = (r < rows_valid && c < cols) ? src[(size_t)r * cols + c] : zero;
    }
  }
}

// Stage count fp32 values of src into dst, zero past `valid`, as 4-byte
// asynchronous words committed by the caller.
template <int NT>
__device__ __forceinline__ void stage_floats(float* dst, const float* src, int count,
                                             int valid) {
  for (int idx = threadIdx.x; idx < count; idx += NT)
    cp_async<4>(dst + idx, idx < valid ? src + idx : src, idx < valid ? 4 : 0);
}

// out[r, c] = round(acc) for this thread's elements of a warp's 16 x 8 NB
// accumulator at rows row0.. of a [rows, D] row-major tile (rows past
// `rows`, columns past D skipped), each multiplied by factor[0] (first
// row) or factor[1] (second row).
template <int NB>
__device__ __forceinline__ void store_rows(bf16* out, int D, int rows, int row0,
                                           const float (&acc)[NB][4], const float (&factor)[2]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + lane / 4 + 8 * half;
    if (r >= rows) continue;
    bf16* o = out + (size_t)r * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int c = nb * 8 + 2 * (lane % 4);
      const float x0 = acc[nb][2 * half] * factor[half];
      const float x1 = acc[nb][2 * half + 1] * factor[half];
      if ((D % 2) == 0 && c + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < D) o[c] = __float2bfloat16(x0);
        if (c + 1 < D) o[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// Padded head dims the bf16 kernels are built for: 80 (SAM's ViT-H heads)
// is five 16-wide steps, whose rows of 88 elements keep eight ldmatrix row
// addresses on distinct banks.
__host__ __device__ constexpr int staged_dim(int D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 80 ? 80 : 128;
}

// v rounded to bf16 and back, as a product's operand takes it.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two one-hot bf16 values, the lower column in the low half.
__device__ __forceinline__ uint32_t one_hot_pair(bool lo, bool hi) {
  return (lo ? 0x3F80u : 0u) | (hi ? 0x3F800000u : 0u);
}

// info[0..6] of a kernel launched with `threads` threads and `bytes` of
// dynamic shared memory, each block covering `rows` rows: rows, threads,
// bytes, resident blocks per SM, registers per thread, local (spilled)
// bytes per thread, and is_mma (1 for an mma.sync kernel, 0 for a staged
// one). Returns the CUDA error code.
inline int launch_info(const void* kernel, int rows, int threads, size_t bytes, bool is_mma,
                       int* info) {
  int err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  info[0] = rows;
  info[1] = threads;
  info[2] = static_cast<int>(bytes);
  info[3] = blocks;
  info[4] = attr.numRegs;
  info[5] = static_cast<int>(attr.localSizeBytes);
  info[6] = is_mma ? 1 : 0;
  return cudaSuccess;
}

}  // namespace mma
}  // namespace flash
