// Shared pieces of the flash softmax attention kernels for Hopper
// (flash_attention_fwd.cu, flash_attention_bwd.cu): tile geometry, the
// shared-memory arena, cp.async tile staging, the two tile products (WMMA
// bf16 on the tensor cores, fp32 FMA loops for fp32) and the counter hash
// of attention-probability dropout.
//
// Every block works on 64-row query tiles against 64-row key/value tiles of
// one (batch, head), with head dims up to 128 staged whole. Rows and columns
// past the sequence length are zero-filled when staged and masked by index.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace flash {

constexpr int TILE = 64;          // rows per query tile and per key/value tile
constexpr int THREADS = 256;      // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 128;        // largest head dim a launch takes
constexpr int MAX_SMEM = 232448;  // dynamic shared memory one block may use on sm_90
// The JAX package's finite mask value, -0.7 * float32 max, rounded to fp32:
// the forward's online recurrence stays NaN-free on a fully masked tile.
constexpr float MASK_VALUE = static_cast<float>(-0.7 * 3.4028234663852886e38);

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <typename T>
__host__ __device__ constexpr bool is_bf16() { return std::is_same<T, bf16>::value; }

// Staged widths and row strides (elements) for head dim D.
template <typename T>
struct Geometry {
  int dp;   // head-dim columns staged per row (bf16: zero-filled to a multiple of 16)
  int ld;   // row stride of [TILE, dp] q/k/v/g tiles
  int lds;  // row stride of fp32 [TILE, TILE] score tiles
  int ldw;  // row stride of [TILE, TILE] probability tiles in the input dtype
  int lda;  // row stride of fp32 [*, dp] accumulators
  __host__ __device__ explicit Geometry(int D) {
    if (is_bf16<T>()) {
      // WMMA fragments are 16 wide and start 32-byte aligned: element
      // strides stay multiples of 8 (fp32: of 4), and the padding staggers
      // rows across banks.
      dp = round_up(D, 16);
      ld = dp + 8;
      ldw = TILE + 8;
      lds = TILE + 4;
      lda = dp + 4;
    } else {
      // FMA loops read a column across 16 rows: odd strides spread them
      // over distinct banks, and keep the fp32 dkv block at D=128 within
      // shared memory. fp32 probability tiles overwrite the score tiles in
      // place, so they share their stride.
      dp = D;
      ld = D | 1;
      lds = TILE + 1;
      ldw = lds;
      lda = D | 1;
    }
  }
};

// Bump allocator over the dynamic shared memory, run identically on the
// host (launch size) and the device (offsets).
struct Arena {
  size_t top = 0;
  template <typename U>
  __host__ __device__ size_t take(size_t count) {
    const size_t at = top;
    top = align128(top + sizeof(U) * count);
    return at;
  }
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// W-byte asynchronous global -> shared copy (W = 4 or 16); src_bytes 0
// writes zeros.
template <int W>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* gmem_src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(gmem_src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(gmem_src), "r"(src_bytes) : "memory");
  }
}

// Wait for every cp.async this thread started.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int W>
__device__ __forceinline__ void load_words(T* dst, int ld, int cols_pad, const T* src,
                                           int rows_valid, int cols) {
  constexpr int E = sizeof(T);
  const int w = cols * E / W;          // words per source row
  const int w_pad = cols_pad * E / W;  // words per staged row
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  for (int idx = threadIdx.x; idx < TILE * w_pad; idx += THREADS) {
    const int r = idx / w_pad;
    const int c = idx - r * w_pad;
    const bool valid = r < rows_valid && c < w;
    cp_async<W>(d + ((size_t)r * ld * E + (size_t)W * c),
                valid ? s + ((size_t)r * cols * E + (size_t)W * c) : s, valid ? W : 0);
  }
}

// dst[r * ld + c] = src[r * cols + c] for r < rows_valid, c < cols; zero for
// the rest of the [TILE, cols_pad] tile. Rows whose lengths, strides and
// addresses allow it move as 16-byte (else 4-byte) asynchronous words, all
// in flight at once; the caller waits with cp_async_wait_all. Other rows are
// copied element by element.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, int cols_pad, const T* __restrict__ src,
                                          int rows_valid, int cols) {
  constexpr int E = sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  const auto fits = [&](int w) {
    return (cols * E) % w == 0 && (cols_pad * E) % w == 0 && (ld * E) % w == 0 &&
           (addr % w) == 0;
  };
  if (fits(16)) {
    load_words<T, 16>(dst, ld, cols_pad, src, rows_valid, cols);
  } else if (fits(4)) {
    load_words<T, 4>(dst, ld, cols_pad, src, rows_valid, cols);
  } else {
    const T zero = from_float<T>(0.f);
    for (int idx = threadIdx.x; idx < TILE * cols_pad; idx += THREADS) {
      const int r = idx / cols_pad;
      const int c = idx - r * cols_pad;
      dst[r * ld + c] = (r < rows_valid && c < cols) ? src[(size_t)r * cols + c] : zero;
    }
  }
}

// C[TILE, TILE] (fp32, row stride ldc) = A[TILE, K] B[TILE, K]^T, A and B
// row-major in shared memory. bf16: K is a multiple of 16 (zero-filled).
template <typename T>
__device__ __forceinline__ void scores(float* C, int ldc, const T* A, int lda,
                                       const T* B, int ldb, int K) {
  if constexpr (is_bf16<T>()) {
    using namespace nvcuda;
    constexpr int NF = TILE / 16;
    static_assert((NF * NF) % WARPS == 0, "fragments must divide over the warps");
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < NF * NF / WARPS; ++i) {
      const int f = warp + WARPS * i;
      const int fm = f / NF;
      const int fn = f % NF;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::load_matrix_sync(fa, A + (fm * 16) * lda + k0, lda);
        wmma::load_matrix_sync(fb, B + (fn * 16) * ldb + k0, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(C + (fm * 16) * ldc + fn * 16, acc, ldc, wmma::mem_row_major);
    }
  } else {
    constexpr int R = TILE / 16;
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    float s[R][R];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) s[r][c] = 0.f;
    for (int f = 0; f < K; ++f) {
      float a[R], b[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = A[(ty + 16 * r) * lda + f];
#pragma unroll
      for (int c = 0; c < R; ++c) b[c] = B[(tx + 16 * c) * ldb + f];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) C[(ty + 16 * r) * ldc + tx + 16 * c] = s[r][c];
  }
}

// C[TILE, ncols] (fp32, row stride ldc) += op(A) B with op(A) = A or A^T,
// A a [TILE, TILE] tile (row stride lda) and B a row-major [TILE, ncols]
// tile (row stride ldb), all in shared memory. bf16: ncols is a multiple of 16.
template <typename T, bool TRANS_A>
__device__ __forceinline__ void accumulate(float* C, int ldc, const T* A, int lda,
                                           const T* B, int ldb, int ncols) {
  if constexpr (is_bf16<T>()) {
    using namespace nvcuda;
    using LayoutA = typename std::conditional<TRANS_A, wmma::col_major, wmma::row_major>::type;
    constexpr int NM = TILE / 16;
    const int nn = ncols / 16;
    const int warp = threadIdx.x / 32;
    for (int f = warp; f < NM * nn; f += WARPS) {
      const int fm = f / nn;
      const int fn = f % nn;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* c = C + (fm * 16) * ldc + fn * 16;
      wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
#pragma unroll
      for (int k0 = 0; k0 < TILE; k0 += 16) {
        // A^T's (row, col) = A[col][row]: a col-major view of A.
        const T* pa = TRANS_A ? A + k0 * lda + fm * 16 : A + (fm * 16) * lda + k0;
        wmma::load_matrix_sync(fa, pa, lda);
        wmma::load_matrix_sync(fb, B + k0 * ldb + fn * 16, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
    }
  } else {
    constexpr int R = TILE / 16;
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    for (int c0 = 0; c0 < ncols; c0 += 64) {
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + tx + 16 * c;
          acc[r][c] = col < ncols ? C[(ty + 16 * r) * ldc + col] : 0.f;
        }
      for (int kk = 0; kk < TILE; ++kk) {
        float a[R], b[4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = ty + 16 * r;
          a[r] = TRANS_A ? A[kk * lda + row] : A[row * lda + kk];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + tx + 16 * c;
          b[c] = col < ncols ? B[kk * ldb + col] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + tx + 16 * c;
          if (col < ncols) C[(ty + 16 * r) * ldc + col] = acc[r][c];
        }
    }
  }
}

// ─── attention-probability dropout ──────────────────────────────────────
// The keep decision of cell (b, h, i, j) is a hash of (seed, b, h, i, j) in
// global indices, bit for bit the JAX package's `dropout_keep`
// (attention_kernels.py:118-163): splitmix32 finalisers on wrapping 32-bit
// arithmetic, keep when x < round((1 - rate) * 2^32) unsigned. The forward
// and every backward pass rebuild the same mask at any tiling.

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Per (batch, head): hb = mix32(seed + b * SEED_B + h * SEED_H).
__device__ __forceinline__ uint32_t head_hash(uint32_t seed, uint32_t b, uint32_t h) {
  return mix32(seed + b * 0x9E3779B1u + h * 0x7F4A7C15u);
}

// Per row: mix32(i * ROW_C + hb).
__device__ __forceinline__ uint32_t row_hash(uint32_t hb, uint32_t i) {
  return mix32(i * 0x9E3779B9u + hb);
}

__device__ __forceinline__ bool keep_cell(uint32_t row_h, uint32_t j, uint32_t threshold) {
  return mix32(row_h + j * 0x6C62272Eu) < threshold;
}

// What every launch takes besides its tensors.
struct Params {
  int B, H, N, D;
  int mask_heads;       // 1 or H when a mask is given
  float scale;          // applied to q.k before the softmax
  int has_dropout;      // attention-probability dropout on
  uint32_t threshold;   // keep when hash < threshold (unsigned)
  float inv_keep;       // 1 / (1 - rate)
};

__host__ inline bool bad_params(const Params& p) {
  return p.B <= 0 || p.H <= 0 || p.N <= 0 || p.D <= 0 || p.D > MAX_D ||
         (p.mask_heads != 1 && p.mask_heads != p.H);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  (void)cudaGetLastError();  // start from a clean error state
  if (bytes > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Row i of mask [B, mask_heads, N, N] (nonzero keeps), or null.
__device__ __forceinline__ const uint8_t* mask_row(const uint8_t* mask, const Params& p,
                                                   int b, int h, int i) {
  if (mask == nullptr) return nullptr;
  const int hm = p.mask_heads == 1 ? 0 : h;
  return mask + (((size_t)b * p.mask_heads + hm) * p.N + i) * p.N;
}

}  // namespace flash
