// Shared pieces of the KERPLE kernels for Hopper (masked_linear_coeffs_fwd.cu,
// masked_linear_coeffs_bwd.cu, kerple_fused_phi_fwd.cu, and the
// materialised-T masked_linear_fwd.cu and masked_linear_bwd.cu): the
// shared-memory arena, cp.async tile staging (and, for the mma.sync
// kernels, 4-byte-word row staging and the store of an accumulator
// fragment), the Toeplitz mask of a tile pair (from a coefficient window or
// a staged tile of T), the tile products (WMMA bf16 on the tensor cores,
// fp32 FMA loops for fp32) over square [TILE, TILE] tiles of 16, 32 or 64
// rows, and the batch sum of dW * A that both dcoeffs and dT are made of.
//
// Toeplitz convention: with T[i, j] = c[h, j - i + N - 1], a block working on
// the q tile starting at row i0 and the kv tile starting at row j0 reads the
// 2 * TILE - 1 coefficients w[t] = c[j0 - i0 + N - TILE + t] and indexes its
// tile as T[a, b] = w[b - a + TILE - 1]; T never reaches device memory. The
// materialised-T kernels instead stage the [TILE, TILE] tile T[h, i0 + a,
// j0 + b] of a given [H, N, N] fp32 T.

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

// dst[r * ld + c] = src[r * src_ld + c] for r < rows_valid, c < cols; zero
// for the rest of the [ROWS, cols_pad] tile. Consecutive threads read
// consecutive addresses of a row. Rows whose byte length, stride and
// addresses are multiples of 4 (fp32, and bf16 with even F: F = 266 rows
// are 4-byte but not 16-byte aligned, nor are fp32 rows of T at odd N)
// move as asynchronous 4-byte words, all in flight at once; the caller
// waits with cp_async_wait_all. Other rows are copied element by element.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile_strided(T* dst, int ld, int cols_pad,
                                                  const T* __restrict__ src, int src_ld,
                                                  int rows_valid, int cols) {
  constexpr int E = sizeof(T);
  const bool words = (cols * E) % 4 == 0 && (cols_pad * E) % 4 == 0 &&
                     (ld * E) % 4 == 0 && (src_ld * E) % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(src) & 3) == 0 &&
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
                valid ? s + ((size_t)r * src_ld * E + 4 * c) : s, valid ? 4 : 0);
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
      dst[r * ld + c] = (r < rows_valid && c < cols) ? src[(size_t)r * src_ld + c] : zero;
    }
  }
}

// A tile of contiguous rows: load_tile_strided with src_ld = cols.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, int ld, int cols_pad,
                                          const T* __restrict__ src,
                                          int rows_valid, int cols) {
  load_tile_strided<T, ROWS>(dst, ld, cols_pad, src, cols, rows_valid, cols);
}

// Stage src rows [0, rows_valid) ([*, cols] row-major bf16, cols even and
// src 4-byte aligned) into dst[ROWS][ld] columns [0, cols_pad), zero-filling
// the rest, as 4-byte cp.async words (rows of F = 266 are 4-byte but not
// 16-byte aligned), committed by the caller. Each of the NT / 32 warps
// takes whole rows and its lanes consecutive words, so a lane's words of a
// row sit 128 bytes apart and its addresses advance by a constant.
template <int ROWS, int NT>
__device__ __forceinline__ void stage_words4(bf16* dst, int ld, int cols_pad,
                                             const bf16* __restrict__ src, int rows_valid,
                                             int cols) {
  const int w = cols / 2;          // words per source row
  const int w_pad = cols_pad / 2;  // words per staged row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const char* sp = reinterpret_cast<const char*>(src);
  for (int r = warp; r < ROWS; r += NT / 32) {
    const char* s_row = sp + (size_t)r * cols * 2;
    char* d_row = reinterpret_cast<char*>(dst + (size_t)r * ld);
    const int w_row = r < rows_valid ? w : 0;  // words of the row to copy, the rest zeros
    for (int c = lane; c < w_pad; c += 32) {
      const bool valid = c < w_row;
      cp_async4(d_row + 4 * c, valid ? s_row + 4 * c : sp, valid ? 4 : 0);
    }
  }
}

// The [TILE, TILE] tile of T[h] (tb, [N, N] fp32) at rows i0.., columns
// j0.., zero past N in either direction; row stride ldt in shared memory.
template <int TILE>
__device__ __forceinline__ void load_t_tile(float* dst, int ldt, const float* __restrict__ tb,
                                            int i0, int j0, int N) {
  load_tile_strided<float, TILE>(dst, ldt, TILE, tb + (size_t)i0 * N + j0, N,
                                 min(TILE, N - i0), min(TILE, N - j0));
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

// The Toeplitz mask of a tile pair, T[a, b] for a q row a and a kv row b of
// the tile: from its coefficient window (WindowMask: w[b - a + TILE - 1]) or
// from a staged [TILE, TILE] fp32 tile of T (TileMask, row stride ld).
template <int TILE>
struct WindowMask {
  const float* w;
  __device__ __forceinline__ float operator()(int a, int b) const { return w[b - a + TILE - 1]; }
};

struct TileMask {
  const float* t;
  int ld;
  __device__ __forceinline__ float operator()(int a, int b) const { return t[a * ld + b]; }
};

// dst[a, b] = round(w(a, b) * mask(a, b)) for a < rows, b < cols, zero
// elsewhere; w(a, b) = src[a, b] - (sub ? sub[a] : 0).
template <typename T, int TILE, typename Mask>
__device__ __forceinline__ void weigh_by(T* dst, int ldw, const float* src, int lds,
                                         const float* sub, Mask mask, int rows, int cols) {
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
    const int a = idx / TILE;
    const int b = idx % TILE;
    float w = 0.f;
    if (a < rows && b < cols) {
      const float x = sub ? src[a * lds + b] - sub[a] : src[a * lds + b];
      w = x * mask(a, b);
    }
    dst[a * ldw + b] = from_float<T>(w);
  }
}

// weigh_by with the mask of the coefficient window cw.
template <typename T, int TILE>
__device__ __forceinline__ void weigh(T* dst, int ldw, const float* src, int lds,
                                      const float* sub, const float* cw,
                                      int rows, int cols) {
  weigh_by<T, TILE>(dst, ldw, src, lds, sub, WindowMask<TILE>{cw}, rows, cols);
}

// out[r, c] = round(acc) for this thread's elements of a warp's 16 x 16 NP
// accumulator at rows row0.. and columns col0.. of a [rows, ld] row-major
// bf16 array; rows >= `rows`, columns >= `cols` and 16-column blocks from
// np_valid on skipped. Column pairs move as 4-byte words where ld is even.
template <int NP>
__device__ __forceinline__ void store_block(bf16* out, int ld, int rows, int cols, int row0,
                                            int col0, int np_valid, const float (&acc)[2 * NP][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + lane / 4 + 8 * half;
    if (r >= rows) continue;
#pragma unroll
    for (int nb = 0; nb < 2 * NP; ++nb) {
      const int c = col0 + nb * 8 + 2 * (lane % 4);
      if (nb / 2 >= np_valid || c >= cols) continue;
      const float x0 = acc[nb][2 * half], x1 = acc[nb][2 * half + 1];
      bf16* o = out + (size_t)r * ld + c;
      if (ld % 2 == 0 && c + 1 < cols) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x0, x1);
      } else {
        o[0] = __float2bfloat16(x0);
        if (c + 1 < cols) o[1] = __float2bfloat16(x1);
      }
    }
  }
}

// Per input dtype and tile: staged widths and row strides (elements) of the
// backward kernels' tiles.
template <typename T, int TILE>
struct Geometry {
  static constexpr bool kBf16 = is_bf16<T>();
  static constexpr int WIN = 2 * TILE - 1;  // coefficient window of a tile pair
  int fp;    // feature columns staged per q'/k' row (bf16: zero-filled to 16)
  int dp;    // value columns staged per v/gn row (bf16: zero-filled to 16)
  int ldf;   // row stride of q'/k' tiles
  int ldd;   // row stride of v/gn tiles
  int lds;   // row stride of fp32 [TILE, TILE] tiles
  int ldw;   // row stride of rounded [TILE, TILE] weight tiles (T)
  int ldaf;  // row stride of fp32 [TILE, fp] accumulators
  int ldad;  // row stride of fp32 [TILE, dp] accumulators
  __host__ __device__ Geometry(int F, int D) {
    if (kBf16) {
      // WMMA fragments are 16 wide; strides stay multiples of 8 elements (4
      // for fp32) so every fragment starts 32-byte aligned, and the padding
      // staggers rows across shared-memory banks.
      fp = round_up(F, 16);
      dp = round_up(D, 16);
      ldf = fp + 8;
      ldd = dp + 8;
      ldw = TILE + 8;
    } else {
      // FMA loops read a column across 16 rows: odd strides spread them
      // over distinct banks.
      fp = F;
      dp = D;
      ldf = F | 1;
      ldd = D | 1;
      ldw = TILE + 1;
    }
    lds = TILE + 4;
    ldaf = fp + 4;
    ldad = dp + 4;
  }
};

// Shared memory of a block that sums dW * A over the batch for one tile
// pair (the dcoeffs and dT kernels).
template <typename T, int TILE>
struct BatchSumLayout {
  size_t q, k, gn, v, sa, sm, acc, s, bytes;
  __host__ __device__ BatchSumLayout(int F, int D) {
    const Geometry<T, TILE> g(F, D);
    Arena a;
    q = a.take<T>(TILE * g.ldf);
    k = a.take<T>(TILE * g.ldf);
    gn = a.take<T>(TILE * g.ldd);
    v = a.take<T>(TILE * g.ldd);
    sa = a.take<float>(TILE * g.lds);
    sm = a.take<float>(TILE * g.lds);
    acc = a.take<float>(TILE * g.lds);
    s = a.take<float>(TILE);
    bytes = a.top;
  }
};

// acc[a, c] (fp32, row stride g.lds, in the arena of L) = sum over b = 0..B-1
// of (M - s)[a, c] * A[a, c] for the q tile at i0 and the kv tile at j0 of
// head h, with M = gn v^T and A = q' k'^T; zero past the ragged edges. Each
// thread owns the same elements for every b and adds the batches in order:
// a fixed summation order, no atomics.
template <typename T, int TILE>
__device__ __forceinline__ float* batch_sum_dw_a(
    unsigned char* smem, const T* __restrict__ gn, const float* __restrict__ s,
    const T* __restrict__ v, const T* __restrict__ q, const T* __restrict__ k,
    int B, int H, int N, int F, int D, int h, int i0, int j0) {
  const Geometry<T, TILE> g(F, D);
  const BatchSumLayout<T, TILE> L(F, D);
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* GNs = reinterpret_cast<T*>(smem + L.gn);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Sa = reinterpret_cast<float*>(smem + L.sa);
  float* Sm = reinterpret_cast<float*>(smem + L.sm);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  const int rows_q = min(TILE, N - i0);
  const int rows_kv = min(TILE, N - j0);

  for (int idx = threadIdx.x; idx < TILE * g.lds; idx += THREADS) acc[idx] = 0.f;
  for (int b = 0; b < B; ++b) {
    const size_t bh = (size_t)b * H + h;
    __syncthreads();  // the previous batch's readers are done
    load_tile<T, TILE>(Qs, g.ldf, g.fp, q + (bh * N + i0) * F, rows_q, F);
    load_tile<T, TILE>(Ks, g.ldf, g.fp, k + (bh * N + j0) * F, rows_kv, F);
    load_tile<T, TILE>(GNs, g.ldd, g.dp, gn + (bh * N + i0) * D, rows_q, D);
    load_tile<T, TILE>(Vs, g.ldd, g.dp, v + (bh * N + j0) * D, rows_kv, D);
    for (int a = threadIdx.x; a < TILE; a += THREADS)
      s_s[a] = a < rows_q ? s[bh * N + i0 + a] : 0.f;
    cp_async_wait_all();
    __syncthreads();
    scores<T, TILE>(Sa, g.lds, Qs, g.ldf, Ks, g.ldf, g.fp);    // A = q' k'^T
    scores<T, TILE>(Sm, g.lds, GNs, g.ldd, Vs, g.ldd, g.dp);   // M = gn v^T
    __syncthreads();
    for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
      const int a = idx / TILE;
      const int c = idx % TILE;
      if (a < rows_q && c < rows_kv)
        acc[a * g.lds + c] += (Sm[a * g.lds + c] - s_s[a]) * Sa[a * g.lds + c];
    }
  }
  __syncthreads();
  return acc;
}

}  // namespace kerple
