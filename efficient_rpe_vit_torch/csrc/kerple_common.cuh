// Shared pieces of the KERPLE kernels for Hopper (masked_linear_coeffs_fwd.cu,
// masked_linear_coeffs_bwd.cu, kerple_fused_phi_fwd.cu): the shared-memory
// arena, cp.async tile staging, the coefficient window of a tile pair, and
// the tile products (WMMA bf16 on the tensor cores, fp32 FMA loops for fp32)
// over square [TILE, TILE] tiles of 16, 32 or 64 rows.
//
// Toeplitz convention: with T[i, j] = c[h, j - i + N - 1], a block working on
// the q tile starting at row i0 and the kv tile starting at row j0 reads the
// 2 * TILE - 1 coefficients w[t] = c[j0 - i0 + N - TILE + t] and indexes its
// tile as T[a, b] = w[b - a + TILE - 1]; T never reaches device memory.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace kerple {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory one block may use on sm_90

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <typename T>
__host__ __device__ constexpr bool is_bf16() { return std::is_same<T, bf16>::value; }

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
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// 4-byte asynchronous global -> shared copy; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(gmem_src), "r"(src_bytes) : "memory");
}

// Wait for every cp.async this thread started.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// dst[r * ld + c] = src[r * cols + c] for r < rows_valid, c < cols; zero for
// the rest of the [ROWS, cols_pad] tile. src rows are contiguous, so
// consecutive threads read consecutive addresses. Rows whose byte length
// and addresses are multiples of 4 (fp32, and bf16 with even F: F = 266
// rows are 4-byte but not 16-byte aligned) move as asynchronous 4-byte
// words, all in flight at once; the caller waits with cp_async_wait_all.
// Other rows are copied element by element.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, int ld, int cols_pad,
                                          const T* __restrict__ src,
                                          int rows_valid, int cols) {
  constexpr int E = sizeof(T);
  const bool words = (cols * E) % 4 == 0 && (cols_pad * E) % 4 == 0 &&
                     (ld * E) % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(dst) & 3) == 0;
  if (words) {
    const int w = cols * E / 4;          // words per source row
    const int w_pad = cols_pad * E / 4;  // words per staged row
    const char* s = reinterpret_cast<const char*>(src);
    char* d = reinterpret_cast<char*>(dst);
    // walk idx = r * w_pad + c in steps of THREADS without a division per step
    int r = threadIdx.x / w_pad;
    int c = threadIdx.x - r * w_pad;
    const int dr = THREADS / w_pad;
    const int dc = THREADS - dr * w_pad;
    for (int idx = threadIdx.x; idx < ROWS * w_pad; idx += THREADS) {
      const bool valid = r < rows_valid && c < w;
      cp_async4(d + ((size_t)r * ld * E + 4 * c),
                valid ? s + ((size_t)r * cols * E + 4 * c) : s, valid ? 4 : 0);
      c += dc;
      r += dr;
      if (c >= w_pad) {
        c -= w_pad;
        ++r;
      }
    }
  } else {
    const T zero = from_float<T>(0.f);
    for (int idx = threadIdx.x; idx < ROWS * cols_pad; idx += THREADS) {
      const int r = idx / cols_pad;
      const int c = idx - r * cols_pad;
      dst[r * ld + c] = (r < rows_valid && c < cols) ? src[(size_t)r * cols + c] : zero;
    }
  }
}

// Coefficient window of the tile pair (i0, j0): w[t] = c[j0 - i0 + N - TILE + t],
// zero outside [0, 2N - 1).
template <int TILE>
__device__ __forceinline__ void load_window(float* cw, const float* __restrict__ cb,
                                            int i0, int j0, int N) {
  const long long base = (long long)j0 - i0 + N - TILE;
  for (int t = threadIdx.x; t < 2 * TILE - 1; t += THREADS) {
    const long long m = base + t;
    cw[t] = (m >= 0 && m < 2LL * N - 1) ? cb[m] : 0.f;
  }
}

// One 16 x 16 fragment (fm, fn) of C = A B^T over K columns (bf16, WMMA).
template <typename T>
__device__ __forceinline__ void score_fragment(float* C, int ldc, const T* A, int lda,
                                               const T* B, int ldb, int K, int fm, int fn) {
  using namespace nvcuda;
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

// C[TILE, TILE] (fp32, row stride ldc) = A[TILE, K] B[TILE, K]^T, A and B
// row-major in shared memory. bf16: K is a multiple of 16 (zero-filled).
template <typename T, int TILE>
__device__ __forceinline__ void scores(float* C, int ldc, const T* A, int lda,
                                       const T* B, int ldb, int K) {
  if constexpr (is_bf16<T>()) {
    constexpr int NF = TILE / 16;
    const int warp = threadIdx.x / 32;
    if constexpr ((NF * NF) % WARPS == 0) {
#pragma unroll
      for (int i = 0; i < NF * NF / WARPS; ++i) {
        const int f = warp + WARPS * i;
        score_fragment(C, ldc, A, lda, B, ldb, K, f / NF, f % NF);
      }
    } else {  // fewer fragments than warps (tiles under 64 rows)
      for (int f = warp; f < NF * NF; f += WARPS)
        score_fragment(C, ldc, A, lda, B, ldb, K, f / NF, f % NF);
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
template <typename T, int TILE, bool TRANS_A>
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

// dst[a, b] = round(w(a, b) * window[b - a + TILE - 1]) for a < rows, b < cols,
// zero elsewhere; w(a, b) = src[a, b] - (sub ? sub[a] : 0).
template <typename T, int TILE>
__device__ __forceinline__ void weigh(T* dst, int ldw, const float* src, int lds,
                                      const float* sub, const float* cw,
                                      int rows, int cols) {
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
    const int a = idx / TILE;
    const int b = idx % TILE;
    float w = 0.f;
    if (a < rows && b < cols) {
      const float x = sub ? src[a * lds + b] - sub[a] : src[a * lds + b];
      w = x * cw[b - a + TILE - 1];
    }
    dst[a * ldw + b] = from_float<T>(w);
  }
}

}  // namespace kerple
