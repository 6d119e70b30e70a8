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
// fits in the 227 KB a block may use at F = 266. At larger F (favor_hyper's
// F = 532) the [TILE, F] tiles and accumulators outgrow that, so dq and dkv
// halve their tile until the block fits (bf16 32 rows, fp32 dkv 16); dc
// keeps its tile, since its windows' shape depends on it, and fits at
// F = 532 in both dtypes. Loads do not overlap products, and
// dc recomputes M and A instead of sharing them with dkv: double
// buffering, wgmma, TMA and fusing the three passes are later work.

#include "kerple_common.cuh"

namespace {

using namespace kerple;

// Rows per tile of the dc kernel, whose windows are [H, n_t, n_t, 2 * tile - 1]
// (n_t = ceil(N / tile)): 64 for bf16, 32 for fp32. dq and dkv start from the
// same tile and halve it, down to 16 rows, until their block fits in shared
// memory (at D = 64: bf16 dq and dkv take 32 rows at F = 532, fp32 dkv 16).
template <typename T>
__host__ __device__ constexpr int dc_tile() { return is_bf16<T>() ? 64 : 32; }
constexpr int MIN_TILE = 16;

// Per input dtype and tile: staged widths and row strides (elements).
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

template <typename T, int TILE>
struct DqLayout {
  size_t gn, v, k, sc, w, cw, s, acc, bytes;
  __host__ __device__ DqLayout(int F, int D) {
    const Geometry<T, TILE> g(F, D);
    Arena a;
    gn = a.take<T>(TILE * g.ldd);
    v = a.take<T>(TILE * g.ldd);
    k = a.take<T>(TILE * g.ldf);
    sc = a.take<float>(TILE * g.lds);
    w = a.take<T>(TILE * g.ldw);
    cw = a.take<float>(Geometry<T, TILE>::WIN);
    s = a.take<float>(TILE);
    acc = a.take<float>(TILE * g.ldaf);
    bytes = a.top;
  }
};

template <typename T, int TILE>
struct DkvLayout {
  size_t k, v, q, gn, sc, wk, wv, cw, s, acck, accv, bytes;
  __host__ __device__ DkvLayout(int F, int D) {
    const Geometry<T, TILE> g(F, D);
    Arena a;
    k = a.take<T>(TILE * g.ldf);
    v = a.take<T>(TILE * g.ldd);
    q = a.take<T>(TILE * g.ldf);
    gn = a.take<T>(TILE * g.ldd);
    sc = a.take<float>(TILE * g.lds);
    wk = a.take<T>(TILE * g.ldw);
    wv = a.take<T>(TILE * g.ldw);
    cw = a.take<float>(Geometry<T, TILE>::WIN);
    s = a.take<float>(TILE);
    acck = a.take<float>(TILE * g.ldaf);
    accv = a.take<float>(TILE * g.ldad);
    bytes = a.top;
  }
};

template <typename T, int TILE>
struct DcLayout {
  size_t q, k, gn, v, sa, sm, acc, s, bytes;
  __host__ __device__ DcLayout(int F, int D) {
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

// dq' for one (q tile, head, batch): loop over kv tiles.
template <typename T, int TILE>
__global__ void __launch_bounds__(THREADS)
mlc_bwd_dq_kernel(const T* __restrict__ gn, const float* __restrict__ s,
                  const T* __restrict__ v, const T* __restrict__ k,
                  const float* __restrict__ coeffs, T* __restrict__ dq,
                  int H, int N, int F, int D) {
  const Geometry<T, TILE> g(F, D);
  const DqLayout<T, TILE> L(F, D);
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
template <typename T, int TILE>
__global__ void __launch_bounds__(THREADS)
mlc_bwd_dkv_kernel(const T* __restrict__ gn, const float* __restrict__ s,
                   const T* __restrict__ v, const T* __restrict__ q,
                   const T* __restrict__ k, const float* __restrict__ coeffs,
                   T* __restrict__ dk, T* __restrict__ dv,
                   int H, int N, int F, int D) {
  const Geometry<T, TILE> g(F, D);
  const DkvLayout<T, TILE> L(F, D);
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
  constexpr int TILE = dc_tile<T>();
  constexpr int WIN = Geometry<T, TILE>::WIN;
  const Geometry<T, TILE> g(F, D);
  const DcLayout<T, TILE> L(F, D);
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

// dq and dkv launch with the largest tile, from dc_tile<T>() down to
// MIN_TILE, whose block fits in shared memory: the default tile wherever it
// fits (F = 266), a smaller one only where it does not (large F).
template <typename T, int TILE = dc_tile<T>()>
int launch_dq(const void* gn, const void* s, const void* v, const void* k,
              const void* coeffs, void* dq, int B, int H, int N, int F, int D,
              void* stream) {
  const DqLayout<T, TILE> L(F, D);
  if constexpr (TILE > MIN_TILE) {
    if (L.bytes > (size_t)MAX_SMEM)
      return launch_dq<T, TILE / 2>(gn, s, v, k, coeffs, dq, B, H, N, F, D, stream);
  }
  const int err = prepare(mlc_bwd_dq_kernel<T, TILE>, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  mlc_bwd_dq_kernel<T, TILE><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gn), static_cast<const float*>(s), static_cast<const T*>(v),
      static_cast<const T*>(k), static_cast<const float*>(coeffs), static_cast<T*>(dq),
      H, N, F, D);
  return cudaGetLastError();
}

template <typename T, int TILE = dc_tile<T>()>
int launch_dkv(const void* gn, const void* s, const void* v, const void* q,
               const void* k, const void* coeffs, void* dk, void* dv,
               int B, int H, int N, int F, int D, void* stream) {
  const DkvLayout<T, TILE> L(F, D);
  if constexpr (TILE > MIN_TILE) {
    if (L.bytes > (size_t)MAX_SMEM)
      return launch_dkv<T, TILE / 2>(gn, s, v, q, k, coeffs, dk, dv, B, H, N, F, D, stream);
  }
  const int err = prepare(mlc_bwd_dkv_kernel<T, TILE>, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  mlc_bwd_dkv_kernel<T, TILE><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gn), static_cast<const float*>(s), static_cast<const T*>(v),
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const float*>(coeffs),
      static_cast<T*>(dk), static_cast<T*>(dv), H, N, F, D);
  return cudaGetLastError();
}

template <typename T>
int launch_dc(const void* gn, const void* s, const void* v, const void* q,
              const void* k, void* windows, int B, int H, int N, int F, int D,
              void* stream) {
  constexpr int TILE = dc_tile<T>();
  const DcLayout<T, TILE> L(F, D);
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

// Rows per q / kv tile of the dc kernel for bf16 (is_bf16 = 1) or fp32 (0)
// inputs: the windows of mlc_bwd_dc_* are [H, n_t, n_t, 2 * tile - 1],
// n_t = ceil(N / tile).
int mlc_bwd_tile(int is_bf16) {
  return is_bf16 ? dc_tile<bf16>() : dc_tile<float>();
}

// gn, v [B, H, N, D], k' and dq [B, H, N, F] in bf16; s [B, H, N] and coeffs
// [H, 2N-1] in fp32; all contiguous. Every launch below runs on `stream`,
// does not synchronise, allocates nothing, and returns the CUDA error code
// (0 = launched; cudaErrorInvalidValue for empty dims or tiles that exceed
// shared memory even at MIN_TILE rows).
int mlc_bwd_dq_bf16(const void* gn, const void* s, const void* v, const void* k,
                    const void* coeffs, void* dq, int B, int H, int N, int F, int D,
                    void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dq<bf16>(gn, s, v, k, coeffs, dq, B, H, N, F, D, stream);
}

int mlc_bwd_dq_f32(const void* gn, const void* s, const void* v, const void* k,
                   const void* coeffs, void* dq, int B, int H, int N, int F, int D,
                   void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dq<float>(gn, s, v, k, coeffs, dq, B, H, N, F, D, stream);
}

// dk' [B, H, N, F] and dv [B, H, N, D] in the input dtype.
int mlc_bwd_dkv_bf16(const void* gn, const void* s, const void* v, const void* q,
                     const void* k, const void* coeffs, void* dk, void* dv,
                     int B, int H, int N, int F, int D, void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dkv<bf16>(gn, s, v, q, k, coeffs, dk, dv, B, H, N, F, D, stream);
}

int mlc_bwd_dkv_f32(const void* gn, const void* s, const void* v, const void* q,
                    const void* k, const void* coeffs, void* dk, void* dv,
                    int B, int H, int N, int F, int D, void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dkv<float>(gn, s, v, q, k, coeffs, dk, dv, B, H, N, F, D, stream);
}

// windows [H, n_t, n_t, 2 * tile - 1] fp32.
int mlc_bwd_dc_bf16(const void* gn, const void* s, const void* v, const void* q,
                    const void* k, void* windows, int B, int H, int N, int F, int D,
                    void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dc<bf16>(gn, s, v, q, k, windows, B, H, N, F, D, stream);
}

int mlc_bwd_dc_f32(const void* gn, const void* s, const void* v, const void* q,
                   const void* k, void* windows, int B, int H, int N, int F, int D,
                   void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
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
