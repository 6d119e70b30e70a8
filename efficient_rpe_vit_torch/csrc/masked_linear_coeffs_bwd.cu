// Coeffs-native KERPLE (Toeplitz-masked linear attention) backward for Hopper.
//
// Replaces the TPU kernels of efficient_rpe_vit_tpu/ops/pallas/masked_linear_coeffs.py
// `_bwd_impl`: `_dq_kernel`, `_dkv_kernel`, `_dc_kernel` and the XLA epilogue
// `_scatter_windows`. With T[i, j] = c[h, j - i + N - 1] and the residuals
// gn = g / (den + 1e-6) (g's dtype) and s = sum(g * out) / (den + 1e-6) (fp32),
// computed by the caller:
//
//   M  = gn v^T,  A = q' k'^T              (fp32 accumulation)
//   dW = M - s                             (fp32, s broadcast over columns)
//   dq' = round(dW * T) k'                 (mlc_bwd_dq_*)
//   dk' = round(dW * T)^T q'               (mlc_bwd_dkv_*)
//   dv  = round(A * T)^T gn                (mlc_bwd_dkv_*)
//   dcoeffs[h, d] = sum over b and the diagonal j - i + N - 1 = d of dW * A
//                                          (mlc_bwd_dc_* then mlc_bwd_dc_reduce)
//
// round() is to the input dtype (bf16 products on the tensor cores, fp32
// accumulation), exactly where the Pallas bodies round; dW * A stays fp32.
// Neither T, dW nor dT reaches device memory: each block reads the
// 2 * TILE - 1 coefficients its tile pair needs and indexes them as
// T[a, b] = w[b - a + TILE - 1], the forward's window convention.
//
// dcoeffs: the dc kernel sums dW * A over the batch for one (head, q tile,
// kv tile) in shared memory (each thread owns fixed elements, adding batch
// by batch in order), then folds the tile's diagonals into a window of
// 2 * TILE - 1 values with index m = b - a + TILE - 1, one thread per
// diagonal summing its rows in order. The reduce kernel adds the windows of
// all tile pairs into dcoeffs[h, :], one thread per coefficient, in a fixed
// order. No float atomics: dcoeffs are bitwise the same run to run.
//
// What bounds it on an H100: bytes. At the ViT-B/16 training shape (B=64,
// H=12, N=197, F=266, D=64, bf16) dq must move ~200 MB against ~19.7 GFLOP
// (60 us vs 20 us), dkv ~300 MB against ~39 GFLOP (89 us vs 40 us), dc
// ~200 MB against ~19.7 GFLOP. This first version is simple rather than
// fast: one block per (tile, head, batch) for dq and dkv and per (tile pair,
// head) for dc, tiles staged by 4-byte cp.async copies (rows of F=266 bf16
// values are 4-byte but not 16-byte aligned), WMMA bf16 products for bf16
// inputs and fp32 FMA loops for fp32 inputs, fp32 accumulators in shared
// memory. bf16 uses 64-row tiles; fp32 uses 32-row tiles so that the dkv
// block (q', k', v, gn tiles plus [TILE, F] and [TILE, D] accumulators)
// fits in the 227 KB a block may use. Loads do not overlap products, and
// dc recomputes M and A instead of sharing them with dkv: double
// buffering, wgmma, TMA and fusing the three passes are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory one block may use on sm_90

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Per input dtype: tile rows, staged widths and row strides (elements).
template <typename T>
struct Geometry {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int TILE = kBf16 ? 64 : 32;  // rows per q tile and per kv tile
  static constexpr int WIN = 2 * TILE - 1;      // coefficient window of a tile pair
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

template <typename T>
struct DqLayout {
  size_t gn, v, k, sc, w, cw, s, acc, bytes;
  __host__ __device__ DqLayout(const Geometry<T>& g) {
    constexpr int TILE = Geometry<T>::TILE;
    Arena a;
    gn = a.take<T>(TILE * g.ldd);
    v = a.take<T>(TILE * g.ldd);
    k = a.take<T>(TILE * g.ldf);
    sc = a.take<float>(TILE * g.lds);
    w = a.take<T>(TILE * g.ldw);
    cw = a.take<float>(Geometry<T>::WIN);
    s = a.take<float>(TILE);
    acc = a.take<float>(TILE * g.ldaf);
    bytes = a.top;
  }
};

template <typename T>
struct DkvLayout {
  size_t k, v, q, gn, sc, wk, wv, cw, s, acck, accv, bytes;
  __host__ __device__ DkvLayout(const Geometry<T>& g) {
    constexpr int TILE = Geometry<T>::TILE;
    Arena a;
    k = a.take<T>(TILE * g.ldf);
    v = a.take<T>(TILE * g.ldd);
    q = a.take<T>(TILE * g.ldf);
    gn = a.take<T>(TILE * g.ldd);
    sc = a.take<float>(TILE * g.lds);
    wk = a.take<T>(TILE * g.ldw);
    wv = a.take<T>(TILE * g.ldw);
    cw = a.take<float>(Geometry<T>::WIN);
    s = a.take<float>(TILE);
    acck = a.take<float>(TILE * g.ldaf);
    accv = a.take<float>(TILE * g.ldad);
    bytes = a.top;
  }
};

template <typename T>
struct DcLayout {
  size_t q, k, gn, v, sa, sm, acc, s, bytes;
  __host__ __device__ DcLayout(const Geometry<T>& g) {
    constexpr int TILE = Geometry<T>::TILE;
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

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

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
// the rest of the [ROWS, cols_pad] tile (the forward kernel's staging).
// Rows whose byte length and addresses are multiples of 4 move as
// asynchronous 4-byte words, all in flight at once; the caller waits with
// cp_async_wait_all. Other rows are copied element by element.
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

// C[TILE, TILE] (fp32, row stride ldc) = A[TILE, K] B[TILE, K]^T, A and B
// row-major in shared memory. bf16: K is a multiple of 16 (zero-filled).
template <typename T, int TILE>
__device__ __forceinline__ void scores(float* C, int ldc, const T* A, int lda,
                                       const T* B, int ldb, int K) {
  if constexpr (std::is_same<T, bf16>::value) {
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
template <typename T, int TILE, bool TRANS_A>
__device__ __forceinline__ void accumulate(float* C, int ldc, const T* A, int lda,
                                           const T* B, int ldb, int ncols) {
  if constexpr (std::is_same<T, bf16>::value) {
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

// dq' for one (q tile, head, batch): loop over kv tiles.
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlc_bwd_dq_kernel(const T* __restrict__ gn, const float* __restrict__ s,
                  const T* __restrict__ v, const T* __restrict__ k,
                  const float* __restrict__ coeffs, T* __restrict__ dq,
                  int H, int N, int F, int D) {
  constexpr int TILE = Geometry<T>::TILE;
  const Geometry<T> g(F, D);
  const DqLayout<T> L(g);
  extern __shared__ __align__(128) unsigned char smem[];
  T* GNs = reinterpret_cast<T*>(smem + L.gn);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  float* Ss = reinterpret_cast<float*>(smem + L.sc);
  T* Ws = reinterpret_cast<T*>(smem + L.w);
  float* cw = reinterpret_cast<float*>(smem + L.cw);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* acc = reinterpret_cast<float*>(smem + L.acc);

  const int i0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const int rows_q = min(TILE, N - i0);
  const float* cb = coeffs + (size_t)h * (2 * N - 1);

  load_tile<T, TILE>(GNs, g.ldd, g.dp, gn + (bh * N + i0) * D, rows_q, D);
  for (int a = threadIdx.x; a < TILE; a += THREADS)
    s_s[a] = a < rows_q ? s[bh * N + i0 + a] : 0.f;
  for (int idx = threadIdx.x; idx < TILE * g.ldaf; idx += THREADS) acc[idx] = 0.f;

  const int n_kv = (N + TILE - 1) / TILE;
  for (int jt = 0; jt < n_kv; ++jt) {
    const int j0 = jt * TILE;
    const int rows_kv = min(TILE, N - j0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, TILE>(Ks, g.ldf, g.fp, k + (bh * N + j0) * F, rows_kv, F);
    load_tile<T, TILE>(Vs, g.ldd, g.dp, v + (bh * N + j0) * D, rows_kv, D);
    load_window<TILE>(cw, cb, i0, j0, N);
    cp_async_wait_all();
    __syncthreads();
    scores<T, TILE>(Ss, g.lds, GNs, g.ldd, Vs, g.ldd, g.dp);  // M = gn v^T
    __syncthreads();
    weigh<T, TILE>(Ws, g.ldw, Ss, g.lds, s_s, cw, rows_q, rows_kv);  // dA = round(dW * T)
    __syncthreads();
    accumulate<T, TILE, false>(acc, g.ldaf, Ws, g.ldw, Ks, g.ldf, g.fp);  // dq += dA k'
  }
  __syncthreads();
  T* out = dq + (bh * N + i0) * F;
  for (int idx = threadIdx.x; idx < rows_q * F; idx += THREADS) {
    const int a = idx / F;
    const int f = idx - a * F;
    out[idx] = from_float<T>(acc[a * g.ldaf + f]);
  }
}

// dk' and dv for one (kv tile, head, batch): loop over q tiles.
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlc_bwd_dkv_kernel(const T* __restrict__ gn, const float* __restrict__ s,
                   const T* __restrict__ v, const T* __restrict__ q,
                   const T* __restrict__ k, const float* __restrict__ coeffs,
                   T* __restrict__ dk, T* __restrict__ dv,
                   int H, int N, int F, int D) {
  constexpr int TILE = Geometry<T>::TILE;
  const Geometry<T> g(F, D);
  const DkvLayout<T> L(g);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* GNs = reinterpret_cast<T*>(smem + L.gn);
  float* Ss = reinterpret_cast<float*>(smem + L.sc);
  T* Wk = reinterpret_cast<T*>(smem + L.wk);
  T* Wv = reinterpret_cast<T*>(smem + L.wv);
  float* cw = reinterpret_cast<float*>(smem + L.cw);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* acck = reinterpret_cast<float*>(smem + L.acck);
  float* accv = reinterpret_cast<float*>(smem + L.accv);

  const int j0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const int rows_kv = min(TILE, N - j0);
  const float* cb = coeffs + (size_t)h * (2 * N - 1);

  load_tile<T, TILE>(Ks, g.ldf, g.fp, k + (bh * N + j0) * F, rows_kv, F);
  load_tile<T, TILE>(Vs, g.ldd, g.dp, v + (bh * N + j0) * D, rows_kv, D);
  for (int idx = threadIdx.x; idx < TILE * g.ldaf; idx += THREADS) acck[idx] = 0.f;
  for (int idx = threadIdx.x; idx < TILE * g.ldad; idx += THREADS) accv[idx] = 0.f;

  const int n_q = (N + TILE - 1) / TILE;
  for (int it = 0; it < n_q; ++it) {
    const int i0 = it * TILE;
    const int rows_q = min(TILE, N - i0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, TILE>(Qs, g.ldf, g.fp, q + (bh * N + i0) * F, rows_q, F);
    load_tile<T, TILE>(GNs, g.ldd, g.dp, gn + (bh * N + i0) * D, rows_q, D);
    for (int a = threadIdx.x; a < TILE; a += THREADS)
      s_s[a] = a < rows_q ? s[bh * N + i0 + a] : 0.f;
    load_window<TILE>(cw, cb, i0, j0, N);
    cp_async_wait_all();
    __syncthreads();
    scores<T, TILE>(Ss, g.lds, Qs, g.ldf, Ks, g.ldf, g.fp);  // A = q' k'^T
    __syncthreads();
    weigh<T, TILE>(Wv, g.ldw, Ss, g.lds, nullptr, cw, rows_q, rows_kv);  // round(A * T)
    __syncthreads();
    scores<T, TILE>(Ss, g.lds, GNs, g.ldd, Vs, g.ldd, g.dp);  // M = gn v^T
    __syncthreads();
    weigh<T, TILE>(Wk, g.ldw, Ss, g.lds, s_s, cw, rows_q, rows_kv);  // round(dW * T)
    __syncthreads();
    accumulate<T, TILE, true>(acck, g.ldaf, Wk, g.ldw, Qs, g.ldf, g.fp);   // dk += dA^T q'
    accumulate<T, TILE, true>(accv, g.ldad, Wv, g.ldw, GNs, g.ldd, g.dp);  // dv += W^T gn
  }
  __syncthreads();
  T* outk = dk + (bh * N + j0) * F;
  for (int idx = threadIdx.x; idx < rows_kv * F; idx += THREADS) {
    const int b = idx / F;
    const int f = idx - b * F;
    outk[idx] = from_float<T>(acck[b * g.ldaf + f]);
  }
  T* outv = dv + (bh * N + j0) * D;
  for (int idx = threadIdx.x; idx < rows_kv * D; idx += THREADS) {
    const int b = idx / D;
    const int d = idx - b * D;
    outv[idx] = from_float<T>(accv[b * g.ldad + d]);
  }
}

// Diagonal windows of sum_b dW * A for one (q tile, kv tile) pair and head:
// windows[h, iq, jk, m] = sum over a, b with b - a + TILE - 1 = m.
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlc_bwd_dc_kernel(const T* __restrict__ gn, const float* __restrict__ s,
                  const T* __restrict__ v, const T* __restrict__ q,
                  const T* __restrict__ k, float* __restrict__ windows,
                  int B, int H, int N, int F, int D) {
  constexpr int TILE = Geometry<T>::TILE;
  constexpr int WIN = Geometry<T>::WIN;
  const Geometry<T> g(F, D);
  const DcLayout<T> L(g);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* GNs = reinterpret_cast<T*>(smem + L.gn);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Sa = reinterpret_cast<float*>(smem + L.sa);
  float* Sm = reinterpret_cast<float*>(smem + L.sm);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* s_s = reinterpret_cast<float*>(smem + L.s);

  const int n_t = (N + TILE - 1) / TILE;
  const int iq = blockIdx.x / n_t;
  const int jk = blockIdx.x - iq * n_t;
  const int h = blockIdx.y;
  const int i0 = iq * TILE;
  const int j0 = jk * TILE;
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
    // each thread owns the same elements for every b: a fixed summation order
    for (int idx = threadIdx.x; idx < TILE * TILE; idx += THREADS) {
      const int a = idx / TILE;
      const int c = idx % TILE;
      if (a < rows_q && c < rows_kv)
        acc[a * g.lds + c] += (Sm[a * g.lds + c] - s_s[a]) * Sa[a * g.lds + c];
    }
  }
  __syncthreads();
  float* out = windows + (((size_t)h * n_t + iq) * n_t + jk) * WIN;
  for (int m = threadIdx.x; m < WIN; m += THREADS) {
    // column b = a + m - (TILE - 1); entries past the ragged edge stayed 0
    const int a_lo = max(0, TILE - 1 - m);
    const int a_hi = min(TILE, 2 * TILE - 1 - m);
    float sum = 0.f;
    for (int a = a_lo; a < a_hi; ++a) sum += acc[a * g.lds + a + m - (TILE - 1)];
    out[m] = sum;
  }
}

// dcoeffs[h, m] = sum over tile pairs (iq, jk) of windows[h, iq, jk, m - base],
// base = (jk - iq) * tile + N - tile, in the order of (jk - iq) then iq.
__global__ void __launch_bounds__(THREADS)
mlc_bwd_dc_reduce_kernel(const float* __restrict__ windows, float* __restrict__ dcoeffs,
                         int H, int N, int tile) {
  const int m = blockIdx.x * THREADS + threadIdx.x;
  const int h = blockIdx.y;
  if (m >= 2 * N - 1) return;
  const int n_t = (N + tile - 1) / tile;
  const int win = 2 * tile - 1;
  float sum = 0.f;
  for (int delta = -(n_t - 1); delta <= n_t - 1; ++delta) {
    const int t = m - (delta * tile + N - tile);
    if (t < 0 || t >= win) continue;
    for (int iq = max(0, -delta); iq < min(n_t, n_t - delta); ++iq) {
      const int jk = iq + delta;
      sum += windows[(((size_t)h * n_t + iq) * n_t + jk) * win + t];
    }
  }
  dcoeffs[(size_t)h * (2 * N - 1) + m] = sum;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  (void)cudaGetLastError();  // start from a clean error state
  if (bytes > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_dims(int B, int H, int N, int F, int D) {
  return B <= 0 || H <= 0 || N <= 0 || F <= 0 || D <= 0;
}

template <typename T>
int launch_dq(const void* gn, const void* s, const void* v, const void* k,
              const void* coeffs, void* dq, int B, int H, int N, int F, int D,
              void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  constexpr int TILE = Geometry<T>::TILE;
  const DqLayout<T> L(Geometry<T>(F, D));
  const int err = prepare(mlc_bwd_dq_kernel<T>, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  mlc_bwd_dq_kernel<T><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gn), static_cast<const float*>(s), static_cast<const T*>(v),
      static_cast<const T*>(k), static_cast<const float*>(coeffs), static_cast<T*>(dq),
      H, N, F, D);
  return cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* gn, const void* s, const void* v, const void* q,
               const void* k, const void* coeffs, void* dk, void* dv,
               int B, int H, int N, int F, int D, void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  constexpr int TILE = Geometry<T>::TILE;
  const DkvLayout<T> L(Geometry<T>(F, D));
  const int err = prepare(mlc_bwd_dkv_kernel<T>, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  mlc_bwd_dkv_kernel<T><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gn), static_cast<const float*>(s), static_cast<const T*>(v),
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const float*>(coeffs),
      static_cast<T*>(dk), static_cast<T*>(dv), H, N, F, D);
  return cudaGetLastError();
}

template <typename T>
int launch_dc(const void* gn, const void* s, const void* v, const void* q,
              const void* k, void* windows, int B, int H, int N, int F, int D,
              void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  constexpr int TILE = Geometry<T>::TILE;
  const DcLayout<T> L(Geometry<T>(F, D));
  const int err = prepare(mlc_bwd_dc_kernel<T>, L.bytes);
  if (err != cudaSuccess) return err;
  const int n_t = (N + TILE - 1) / TILE;
  const dim3 grid(n_t * n_t, H);
  mlc_bwd_dc_kernel<T><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gn), static_cast<const float*>(s), static_cast<const T*>(v),
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<float*>(windows),
      B, H, N, F, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per q / kv tile for bf16 (is_bf16 = 1) or fp32 (0) inputs: the
// windows of mlc_bwd_dc_* are [H, n_t, n_t, 2 * tile - 1], n_t = ceil(N / tile).
int mlc_bwd_tile(int is_bf16) {
  return is_bf16 ? Geometry<bf16>::TILE : Geometry<float>::TILE;
}

// gn, v [B, H, N, D], k' and dq [B, H, N, F] in bf16; s [B, H, N] and coeffs
// [H, 2N-1] in fp32; all contiguous. Every launch below runs on `stream`,
// does not synchronise, allocates nothing, and returns the CUDA error code
// (0 = launched; cudaErrorInvalidValue for tiles that exceed shared memory).
int mlc_bwd_dq_bf16(const void* gn, const void* s, const void* v, const void* k,
                    const void* coeffs, void* dq, int B, int H, int N, int F, int D,
                    void* stream) {
  return launch_dq<bf16>(gn, s, v, k, coeffs, dq, B, H, N, F, D, stream);
}

int mlc_bwd_dq_f32(const void* gn, const void* s, const void* v, const void* k,
                   const void* coeffs, void* dq, int B, int H, int N, int F, int D,
                   void* stream) {
  return launch_dq<float>(gn, s, v, k, coeffs, dq, B, H, N, F, D, stream);
}

// dk' [B, H, N, F] and dv [B, H, N, D] in the input dtype.
int mlc_bwd_dkv_bf16(const void* gn, const void* s, const void* v, const void* q,
                     const void* k, const void* coeffs, void* dk, void* dv,
                     int B, int H, int N, int F, int D, void* stream) {
  return launch_dkv<bf16>(gn, s, v, q, k, coeffs, dk, dv, B, H, N, F, D, stream);
}

int mlc_bwd_dkv_f32(const void* gn, const void* s, const void* v, const void* q,
                    const void* k, const void* coeffs, void* dk, void* dv,
                    int B, int H, int N, int F, int D, void* stream) {
  return launch_dkv<float>(gn, s, v, q, k, coeffs, dk, dv, B, H, N, F, D, stream);
}

// windows [H, n_t, n_t, 2 * tile - 1] fp32.
int mlc_bwd_dc_bf16(const void* gn, const void* s, const void* v, const void* q,
                    const void* k, void* windows, int B, int H, int N, int F, int D,
                    void* stream) {
  return launch_dc<bf16>(gn, s, v, q, k, windows, B, H, N, F, D, stream);
}

int mlc_bwd_dc_f32(const void* gn, const void* s, const void* v, const void* q,
                   const void* k, void* windows, int B, int H, int N, int F, int D,
                   void* stream) {
  return launch_dc<float>(gn, s, v, q, k, windows, B, H, N, F, D, stream);
}

// windows [H, n_t, n_t, 2 * tile - 1] -> dcoeffs [H, 2N-1], both fp32.
int mlc_bwd_dc_reduce(const void* windows, void* dcoeffs, int H, int N, int tile,
                      void* stream) {
  (void)cudaGetLastError();
  if (H <= 0 || N <= 0 || tile <= 0) return cudaErrorInvalidValue;
  const dim3 grid((2 * N - 1 + THREADS - 1) / THREADS, H);
  mlc_bwd_dc_reduce_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(windows), static_cast<float*>(dcoeffs), H, N, tile);
  return cudaGetLastError();
}

const char* mlc_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
