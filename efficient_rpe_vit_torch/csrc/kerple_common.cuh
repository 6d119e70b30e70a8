// Shared pieces of the KERPLE kernels for Hopper (masked_linear_coeffs_fwd.cu,
// masked_linear_coeffs_bwd.cu, kerple_fused_phi_fwd.cu, and the
// materialised-T masked_linear_fwd.cu and masked_linear_bwd.cu): the
// shared-memory arena, cp.async tile staging (and, for the mma.sync
// kernels, 4-byte-word row staging, the staging of a tile of T and the
// store of an accumulator fragment), the mask of a tile pair, the staged
// kernels' tile products (WMMA bf16 on the tensor cores, fp32 FMA loops for
// fp32) over square [TILE, TILE] tiles of 16, 32 or 64 rows, the batch sum
// of dW * A that the staged dcoeffs and dT kernels are made of, and the
// register-resident stages of the bf16 mma.sync kernels on
// flash_attention_mma.cuh's fragments: the forward's key/value stage and
// epilogue (fwd_mma_stage, fwd_mma_store: the KERPLE forwards over c and
// over T and the fused-phi forward) and the dk' / dv stage (dkv_mma_stage),
// each shared by the coefficient kernel and the materialised-T one.
//
// The mask is each stage's template policy: WindowMask reads the Toeplitz
// coefficient window of a tile pair, TileMask a staged tile of T, FragMask
// T held in registers. With T[i, j] = c[h, j - i + N - 1], a block working
// on the q tile starting at row i0 and the kv tile starting at row j0 reads
// the 2 * TILE - 1 coefficients w[t] = c[j0 - i0 + N - TILE + t] and
// indexes its tile as T[a, b] = w[b - a + TILE - 1]; T never reaches device
// memory. The materialised-T kernels instead stage the tile T[h, i0 + a,
// j0 + b] of a given [H, N, N] fp32 T (zero past N).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include "flash_attention_mma.cuh"

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

// The mask of a tile pair, T[a, b] for a q row a and a kv row b of the
// tile: from its Toeplitz coefficient window (WindowMask: w[b - a + TILE -
// 1]) or from a staged fp32 tile of T (TileMask, row stride ld). weigh_by
// and the mma.sync stages (fwd_mma_stage, dkv_mma_stage, and the
// materialised-T dq' kernel's dq_mma_stage) take either (the stages also
// FragMask below) as their template policy and read T[a, b] as at(a, b,
// nb, e), nb and e naming the thread's 8-column block and fragment element
// of it; a TileMask (kPairs) gives the pair T[a, b], T[a, b + 1] of
// fragment elements e, e + 1 (b even) as one 8-byte word, pair(a, b).
template <int TILE>
struct WindowMask {
  static constexpr bool kPairs = false;
  const float* w;
  __device__ __forceinline__ float at(int a, int b, int, int) const { return w[b - a + TILE - 1]; }
};

struct TileMask {
  static constexpr bool kPairs = true;
  const float* t;
  int ld;
  __device__ __forceinline__ float at(int a, int b, int, int) const { return t[a * ld + b]; }
  __device__ __forceinline__ float2 pair(int a, int b) const {
    return *reinterpret_cast<const float2*>(t + a * ld + b);
  }
};

// T held in registers in the m16n8 accumulator layout of a warp's 16 rows
// against 8 NB columns: element e of 8-column block nb is v[nb][e]
// (load_t_frag fills it).
template <int NB>
struct FragMask {
  static constexpr bool kPairs = false;
  const float (&v)[NB][4];
  __device__ __forceinline__ float at(int, int, int nb, int e) const { return v[nb][e]; }
};

// A stage's hook that does nothing (see fwd_mma_stage).
struct NoHook {
  __device__ __forceinline__ void operator()() const {}
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
      w = x * mask.at(a, b, 0, 0);
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

// ─── the bf16 forward's key/value stage on mma.sync ────────────────────

constexpr float FWD_EPS = 1e-6f;  // denominator stabiliser of the forward

// One key/value stage of the bf16 forward for a warp's 16 query rows row0..
// of a BM-row block at i0 against the stage's 8 NB rows at j0: S = q' k'^T
// over the kf 16-steps F needs (q' as A fragments qf, else QREG false: read
// by ldmatrix from the row-major tile Qs at every 16-step; k' the stage's
// row-major [8 NB, *] tile Kt, row stride ldf), then per fragment element,
// with T[a, b] from the mask for the block's row a and the stage's row b (a
// WindowMask<BM> over the stage's coefficient window, a TileMask over its
// staged tile of T or a FragMask over T in registers), W = S * T (exactly 0
// past N in either direction: row_ok holds this thread's rows r, r + 8
// below N), added to this thread's fp32 row sums rs and rounded to bf16 as
// the A fragments of acc += round(W) v (v the stage's row-major
// [8 NB, 8 DB] tile Vt, row stride ldd). after_mask() runs once the mask
// has been read (a FragMask's registers may then be refilled for the next
// stage).
template <int KF, int NB, int DB, int BM, bool QREG, typename Mask, typename Hook = NoHook>
__device__ __forceinline__ void fwd_mma_stage(float (&acc)[DB][4], float (&rs)[2],
                                              uint32_t (&qf)[QREG ? KF : 1][4], const bf16* Qs,
                                              int ldf, int kf, const bf16* Kt, const bf16* Vt,
                                              int ldd, const Mask& mask, int row0,
                                              const bool (&row_ok)[2], int i0, int j0, int N,
                                              Hook after_mask = Hook{}) {
  namespace fm = flash::mma;
  const int lane = threadIdx.x % 32;
  const int r = lane / 4;         // this thread's fragment rows r, r + 8
  const int qc = 2 * (lane % 4);  // and columns qc, qc + 1 of each 8-column block
  float s[NB][4];
  fm::zero_acc(s);
#pragma unroll
  for (int kk = 0; kk < KF; ++kk) {
    if (kk >= kf) break;
    uint32_t(&a)[4] = qf[QREG ? kk : 0];
    if constexpr (!QREG) fm::load_a(a, Qs, ldf, row0, kk * 16);
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t b[4];
      fm::load_b_rows(b, Kt, ldf, np * 16, kk * 16);
      fm::mma_bf16(s[2 * np], a, b[0], b[1]);
      fm::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
  const bool ragged = j0 + 8 * NB > N || i0 + BM > N;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    float2 tp;  // kPairs: T of this thread's element pair
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int a = row0 + r + 8 * (e / 2);
      const int c = nb * 8 + qc + (e & 1);
      float t;
      if constexpr (Mask::kPairs) {
        if ((e & 1) == 0) tp = mask.pair(a, c);
        t = (e & 1) ? tp.y : tp.x;
      } else {
        t = mask.at(a, c, nb, e);
      }
      float w = s[nb][e] * t;
      if (ragged && !(row_ok[e / 2] && j0 + c < N)) w = 0.f;
      rs[e / 2] += w;
      s[nb][e] = w;
    }
  }
  after_mask();
  uint32_t wa[NB / 2][4];
  fm::to_a(wa, s);                          // round(W) as A fragments
  fm::mma_a_cols<NB / 2, DB>(acc, wa, Vt, ldd);  // acc += round(W) v
}

// The forward's epilogue for a warp's 16 rows at `row` of a (batch, head)'s
// [N, D] output out_bh and [N] den_bh: den over the four lanes of a
// fragment row in a fixed shuffle order, out = acc / (den + eps) rounded to
// bf16, both written for the rows below N.
template <int DB>
__device__ __forceinline__ void fwd_mma_store(float (&acc)[DB][4], const float (&rs)[2],
                                              const bool (&row_ok)[2], bf16* out_bh,
                                              float* den_bh, int N, int D, int row) {
  const int lane = threadIdx.x % 32;
  float dn[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float x = rs[half];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    dn[half] = x;
  }
#pragma unroll
  for (int nb = 0; nb < DB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = acc[nb][e] / (dn[e / 2] + FWD_EPS);
  store_block<DB / 2>(out_bh, D, N, D, row, 0, DB / 2, acc);
  if (lane % 4 == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (row_ok[half]) den_bh[row + lane / 4 + 8 * half] = dn[half];
  }
}

// ─── the bf16 backward's dk'/dv stage on mma.sync ──────────────────────

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// B fragments of one 8-column block of B = T^T for a row-major tile T: B's
// columns are T's rows row0..row0+7, B's depth T's columns col0..col0+31 in
// two 16-steps (b[0], b[1] the first, b[2], b[3] the second).
__device__ __forceinline__ void load_b8_rows2(uint32_t (&b)[4], const bf16* tile, int ld,
                                              int row0, int col0) {
  namespace fm = flash::mma;
  const int lane = threadIdx.x % 32;
  fm::ldsm_x4(b, fm::smem_addr(tile + (row0 + lane % 8) * ld + col0 + (lane / 8) * 8));
}

// The same over one 16-step of depth.
__device__ __forceinline__ void load_b8_rows1(uint32_t (&b)[2], const bf16* tile, int ld,
                                              int row0, int col0) {
  namespace fm = flash::mma;
  const int lane = threadIdx.x % 32;
  ldsm_x2(b, fm::smem_addr(tile + (row0 + lane % 8) * ld + col0 + ((lane / 8) % 2) * 8));
}

// A thread's place in the bf16 dk' / dv kernels: its warp and lane, the
// row group of four warps and this warp's quarter of it, the group's first
// key/value row in the block, this warp's 8 query columns q8.. in the score
// products, this thread's key/value rows jr (of the block at j0) and its
// query columns c, c + 1 of a tile. Made once, before the sweep.
struct DkvThread {
  int warp, lane, group, quarter, row0, q8, jr[2], c;
  __device__ __forceinline__ explicit DkvThread(int j0)
      : warp(threadIdx.x / 32), lane(threadIdx.x % 32), group(warp / 4), quarter(warp % 4),
        row0(group * 16), q8(quarter * 8),
        jr{j0 + row0 + lane / 4, j0 + row0 + lane / 4 + 8}, c(q8 + 2 * (lane % 4)) {}
};

// One query tile of the bf16 dk' / dv kernels (mlc_bwd_dkv_mma_kernel and
// mlt_bwd_dkv_mma_kernel, geometry C: BN = 32 query rows a tile, four warps
// per 16 key/value rows of the block at j0, features staged up to FMAX,
// values to DP). k' (Ks) and v (Vs) are the block's resident row-major
// tiles; q' (Qt), gn (Gt) and s (s_t) the tile's, at query row i0. Each
// warp computes, for its 8 query columns, A^T = k' q'^T over all of F (even
// and odd 16-steps in two chains, added once) and M^T = v gn^T over D in
// registers, then per cell, with T^T[j, i] = mask(i - i0, j - j0) (a
// WindowMask<BN> over the tile pair's coefficient window or a TileMask over
// its staged [BN, BM] tile of T), Wk^T = round((M^T - s_i) T^T) and Wv^T =
// round(A^T T^T), packed as bf16 pairs: exactly the four registers of an mma
// A fragment that its 8 columns fill. The four warps of a row group swap
// these through xch (a named barrier of the four), so each holds the
// rounded Wk^T and Wv^T of all 32 columns as the A operands of dk' += Wk^T
// q' (feature blocks p_begin.. p_begin + p_count - 1) and dv += Wv^T gn
// (its DV_PAIRS 16-column blocks of dv; at DP < 64 only the first DP / 16
// warps of a group hold any), accumulated in dka and dva.
template <typename C, typename Mask>
__device__ __forceinline__ void dkv_mma_stage(float (&dka)[2 * C::PAIRS][4],
                                              float (&dva)[2 * C::DV_PAIRS][4], const bf16* Ks,
                                              const bf16* Vs, const bf16* Qt, const bf16* Gt,
                                              const float* s_t, const Mask& mask, uint4* xch,
                                              const DkvThread& th, int i0, int j0, int N, int kf,
                                              int p_begin, int p_count) {
  namespace fm = flash::mma;
  const int lane = th.lane, group = th.group, quarter = th.quarter, row0 = th.row0, q8 = th.q8;
  const int c = th.c;

  // A^T and M^T for this warp's 8 query columns
  float a[4] = {0.f, 0.f, 0.f, 0.f}, a_odd[4] = {0.f, 0.f, 0.f, 0.f};
  float m[4] = {0.f, 0.f, 0.f, 0.f};
  int kk = 0;
  for (; kk + 2 <= kf; kk += 2) {
    uint32_t b[4], af[4], af2[4];
    load_b8_rows2(b, Qt, C::LDF, q8, kk * 16);
    fm::load_a(af, Ks, C::LDF, row0, kk * 16);
    fm::load_a(af2, Ks, C::LDF, row0, kk * 16 + 16);
    fm::mma_bf16(a, af, b[0], b[1]);
    fm::mma_bf16(a_odd, af2, b[2], b[3]);
  }
  if (kk < kf) {
    uint32_t b[2], af[4];
    load_b8_rows1(b, Qt, C::LDF, q8, kk * 16);
    fm::load_a(af, Ks, C::LDF, row0, kk * 16);
    fm::mma_bf16(a, af, b[0], b[1]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] += a_odd[e];
#pragma unroll
  for (int kd = 0; kd + 2 <= C::DP / 16; kd += 2) {
    uint32_t b[4], af[4], af2[4];
    load_b8_rows2(b, Gt, C::LDD, q8, kd * 16);
    fm::load_a(af, Vs, C::LDD, row0, kd * 16);
    fm::load_a(af2, Vs, C::LDD, row0, kd * 16 + 16);
    fm::mma_bf16(m, af, b[0], b[1]);
    fm::mma_bf16(m, af2, b[2], b[3]);
  }
  if constexpr ((C::DP / 16) % 2 == 1) {
    uint32_t b[2], af[4];
    load_b8_rows1(b, Gt, C::LDD, q8, C::DP - 16);
    fm::load_a(af, Vs, C::LDD, row0, C::DP - 16);
    fm::mma_bf16(m, af, b[0], b[1]);
  }
  // per cell (key/value row j, query row i): rounded Wk^T and Wv^T
  const float2 s_c = *reinterpret_cast<const float2*>(s_t + c);
  float wk[4], wv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = th.jr[e / 2];
    const int i = i0 + c + (e & 1);
    wk[e] = wv[e] = 0.f;
    if (j < N && i < N) {
      const float t = mask.at(c + (e & 1), j - j0, 0, e);
      wv[e] = a[e] * t;
      wk[e] = (m[e] - ((e & 1) ? s_c.y : s_c.x)) * t;
    }
  }
  xch[th.warp * 32 + lane] = make_uint4(fm::pack_bf16(wk[0], wk[1]), fm::pack_bf16(wk[2], wk[3]),
                                     fm::pack_bf16(wv[0], wv[1]), fm::pack_bf16(wv[2], wv[3]));
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
  // the A fragments over all 32 query columns: 16-step kk takes the words
  // of the warps owning columns 16 kk.. (registers 0, 1) and 16 kk + 8..
  // (registers 2, 3)
  uint32_t atk[2][4], atv[2][4];
#pragma unroll
  for (int step = 0; step < 2; ++step)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint4 w4 = xch[(group * 4 + 2 * step + hh) * 32 + lane];
      atk[step][2 * hh] = w4.x;
      atk[step][2 * hh + 1] = w4.y;
      atv[step][2 * hh] = w4.z;
      atv[step][2 * hh + 1] = w4.w;
    }
#pragma unroll
  for (int step = 0; step < 2; ++step)
#pragma unroll
    for (int lp = 0; lp < C::PAIRS; ++lp) {
      if (lp >= p_count) continue;
      uint32_t b[4];
      fm::load_b_cols(b, Qt, C::LDF, step * 16, (p_begin + lp) * 16);
      fm::mma_bf16(dka[2 * lp], atk[step], b[0], b[1]);
      fm::mma_bf16(dka[2 * lp + 1], atk[step], b[2], b[3]);
    }
  if constexpr (4 * C::DV_PAIRS * 16 > C::DP) {
    if (quarter * C::DV_PAIRS * 16 >= C::DP) return;  // this warp holds no dv block
  }
#pragma unroll
  for (int step = 0; step < 2; ++step)
#pragma unroll
    for (int lp = 0; lp < C::DV_PAIRS; ++lp) {
      uint32_t b[4];
      fm::load_b_cols(b, Gt, C::LDD, step * 16, (quarter * C::DV_PAIRS + lp) * 16);
      fm::mma_bf16(dva[2 * lp], atv[step], b[0], b[1]);
      fm::mma_bf16(dva[2 * lp + 1], atv[step], b[2], b[3]);
    }
}

// Stage rows i0.. i0 + ROWS - 1, columns j0.. j0 + COLS - 1 of T[h] (tb,
// [N, N] fp32) into dst[ROWS][ld] (16-byte aligned rows), zero past N in
// either direction, as cp.async words committed by the caller: 16-byte
// words where N % 4 == 0 (T's rows, and j0, a multiple of 4: a word lies
// wholly below or past N), else 4-byte words (rows of an odd N are 4-byte
// aligned only). Consecutive threads take consecutive words of a row.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage_t_tile(float* dst, int ld, const float* __restrict__ tb,
                                             int i0, int j0, int N) {
  const int rows = min(ROWS, N - i0);
  const int cols = min(COLS, N - j0);
  const float* src = tb + (size_t)i0 * N + j0;
  if (N % 4 == 0 && (reinterpret_cast<uintptr_t>(tb) & 15) == 0) {
    constexpr int W = COLS / 4;  // 16-byte words of a row
    for (int idx = threadIdx.x; idx < ROWS * W; idx += NT) {
      const int r = idx / W;
      const int c = 4 * (idx % W);
      const bool valid = r < rows && c < cols;
      flash::cp_async<16>(dst + r * ld + c, valid ? src + (size_t)r * N + c : tb, valid ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * COLS; idx += NT) {
      const int r = idx / COLS;
      const int c = idx % COLS;
      const bool valid = r < rows && c < cols;
      cp_async4(dst + r * ld + c, valid ? src + (size_t)r * N + c : tb, valid ? 4 : 0);
    }
  }
}

// This thread's elements of T[h] (tb, [N, N] fp32) in the m16n8
// accumulator layout of the 16 rows i.. against the 8 NB columns j0..
// (FragMask's v), zero past N in either direction: 8-byte loads where N is
// even (the column pair and the row start 8-byte aligned), else 4-byte ones.
template <int NB>
__device__ __forceinline__ void load_t_frag(float (&v)[NB][4], const float* __restrict__ tb,
                                            int i, int j0, int N) {
  const int lane = threadIdx.x % 32;
  const int c0 = j0 + 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = i + lane / 4 + 8 * half;
    const float* src = tb + (size_t)min(row, N - 1) * N;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int c = c0 + nb * 8;
      float2 x = make_float2(0.f, 0.f);
      if (row < N && c < N) {
        if (N % 2 == 0) {
          x = __ldg(reinterpret_cast<const float2*>(src + c));
        } else {
          x.x = __ldg(src + c);
          if (c + 1 < N) x.y = __ldg(src + c + 1);
        }
      }
      v[nb][2 * half] = x.x;
      v[nb][2 * half + 1] = x.y;
    }
  }
}

}  // namespace kerple
