// Toeplitz-masked linear attention (KERPLE) backward from a materialised T,
// for Hopper.
//
// Replaces the TPU kernels of efficient_rpe_vit_tpu/ops/pallas/masked_linear_bwd.py
// `masked_linear_bwd`: `_dq_kernel`, `_dkv_kernel` and `_dt_kernel`. With T
// [H, N, N] fp32 given and the residuals gn = g / (den + 1e-6) (g's dtype)
// and s = sum(g * out) / (den + 1e-6) (fp32), computed by the caller:
//
//   M  = gn v^T,  A = q' k'^T              (fp32 accumulation)
//   dW = M - s                             (fp32, s broadcast over columns)
//   dq' = round(dW * T) k'                 (mlt_bwd_dq_*)
//   dk' = round(dW * T)^T q'               (mlt_bwd_dkv_*)
//   dv  = round(A * T)^T gn                (mlt_bwd_dkv_*)
//   dT  = sum over b of dW * A             (mlt_bwd_dt_*, fp32, not times T)
//
// round() is to the input dtype (bf16 products on the tensor cores, fp32
// accumulation), where the Pallas bodies round. The dq and dkv kernels are
// those of the coefficient backward (masked_linear_coeffs_bwd.cu) with the
// coefficient window replaced by a staged [TILE, TILE] fp32 tile of T
// (4-byte cp.async words: rows of T are not 16-byte aligned; zero past N).
// dT: one block per (head, q tile, kv tile) sums dW * A over the batch
// b = 0..B-1 in order in shared memory (batch_sum_dw_a, the dcoeffs kernel's
// sum, which the JAX grid runs as its innermost axis) and writes its tile of
// dT once. No float atomics: every output is bitwise the same run to run.
//
// What bounds it on an H100: at the long-N shape (B=4, H=12, N=4097, F=266,
// D=64, bf16) operations: dq 2 B H N^2 (D + F) = 5.3e11 (0.54 ms at the bf16
// peak, T's 0.81 GB 0.24 ms), dkv twice that, dT as dq with 0.81 GB of dT
// written. This first version is simple rather than fast: 64-row tiles in
// bf16 and 32 in fp32 (dq and dkv halved where a large F outgrows shared
// memory), no load/compute overlap, dkv recomputing A and M, dT recomputing
// both again.

#include "kerple_common.cuh"

namespace {

using namespace kerple;

template <typename T>
__host__ __device__ constexpr int first_tile() { return is_bf16<T>() ? 64 : 32; }
constexpr int MIN_TILE = 16;

template <typename T, int TILE>
struct DqLayout {
  size_t gn, v, k, t, sc, w, s, acc, bytes;
  __host__ __device__ DqLayout(int F, int D) {
    const Geometry<T, TILE> g(F, D);
    Arena a;
    gn = a.take<T>(TILE * g.ldd);
    v = a.take<T>(TILE * g.ldd);
    k = a.take<T>(TILE * g.ldf);
    t = a.take<float>(TILE * TILE);
    sc = a.take<float>(TILE * g.lds);
    w = a.take<T>(TILE * g.ldw);
    s = a.take<float>(TILE);
    acc = a.take<float>(TILE * g.ldaf);
    bytes = a.top;
  }
};

template <typename T, int TILE>
struct DkvLayout {
  size_t k, v, q, gn, t, sc, wk, wv, s, acck, accv, bytes;
  __host__ __device__ DkvLayout(int F, int D) {
    const Geometry<T, TILE> g(F, D);
    Arena a;
    k = a.take<T>(TILE * g.ldf);
    v = a.take<T>(TILE * g.ldd);
    q = a.take<T>(TILE * g.ldf);
    gn = a.take<T>(TILE * g.ldd);
    t = a.take<float>(TILE * TILE);
    sc = a.take<float>(TILE * g.lds);
    wk = a.take<T>(TILE * g.ldw);
    wv = a.take<T>(TILE * g.ldw);
    s = a.take<float>(TILE);
    acck = a.take<float>(TILE * g.ldaf);
    accv = a.take<float>(TILE * g.ldad);
    bytes = a.top;
  }
};

// dq' for one (q tile, head, batch): loop over kv tiles.
template <typename T, int TILE>
__global__ void __launch_bounds__(THREADS)
mlc_t_bwd_dq_kernel(const T* __restrict__ gn, const float* __restrict__ s,
                    const T* __restrict__ v, const T* __restrict__ k,
                    const float* __restrict__ t, T* __restrict__ dq,
                    int H, int N, int F, int D) {
  const Geometry<T, TILE> g(F, D);
  const DqLayout<T, TILE> L(F, D);
  extern __shared__ __align__(128) unsigned char smem[];
  T* GNs = reinterpret_cast<T*>(smem + L.gn);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  float* Ts = reinterpret_cast<float*>(smem + L.t);
  float* Ss = reinterpret_cast<float*>(smem + L.sc);
  T* Ws = reinterpret_cast<T*>(smem + L.w);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* acc = reinterpret_cast<float*>(smem + L.acc);

  const int i0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const int rows_q = min(TILE, N - i0);
  const float* tb = t + (size_t)h * N * N;

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
    load_t_tile<TILE>(Ts, TILE, tb, i0, j0, N);
    cp_async_wait_all();
    __syncthreads();
    scores<T, TILE>(Ss, g.lds, GNs, g.ldd, Vs, g.ldd, g.dp);  // M = gn v^T
    __syncthreads();
    weigh_by<T, TILE>(Ws, g.ldw, Ss, g.lds, s_s, TileMask{Ts, TILE}, rows_q,
                      rows_kv);  // dA = round(dW * T)
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
mlc_t_bwd_dkv_kernel(const T* __restrict__ gn, const float* __restrict__ s,
                     const T* __restrict__ v, const T* __restrict__ q,
                     const T* __restrict__ k, const float* __restrict__ t,
                     T* __restrict__ dk, T* __restrict__ dv,
                     int H, int N, int F, int D) {
  const Geometry<T, TILE> g(F, D);
  const DkvLayout<T, TILE> L(F, D);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* GNs = reinterpret_cast<T*>(smem + L.gn);
  float* Ts = reinterpret_cast<float*>(smem + L.t);
  float* Ss = reinterpret_cast<float*>(smem + L.sc);
  T* Wk = reinterpret_cast<T*>(smem + L.wk);
  T* Wv = reinterpret_cast<T*>(smem + L.wv);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* acck = reinterpret_cast<float*>(smem + L.acck);
  float* accv = reinterpret_cast<float*>(smem + L.accv);

  const int j0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const int rows_kv = min(TILE, N - j0);
  const float* tb = t + (size_t)h * N * N;

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
    load_t_tile<TILE>(Ts, TILE, tb, i0, j0, N);
    for (int a = threadIdx.x; a < TILE; a += THREADS)
      s_s[a] = a < rows_q ? s[bh * N + i0 + a] : 0.f;
    cp_async_wait_all();
    __syncthreads();
    const TileMask mask{Ts, TILE};
    scores<T, TILE>(Ss, g.lds, Qs, g.ldf, Ks, g.ldf, g.fp);  // A = q' k'^T
    __syncthreads();
    weigh_by<T, TILE>(Wv, g.ldw, Ss, g.lds, nullptr, mask, rows_q, rows_kv);  // round(A * T)
    __syncthreads();
    scores<T, TILE>(Ss, g.lds, GNs, g.ldd, Vs, g.ldd, g.dp);  // M = gn v^T
    __syncthreads();
    weigh_by<T, TILE>(Wk, g.ldw, Ss, g.lds, s_s, mask, rows_q, rows_kv);  // round(dW * T)
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

// dT[h, i0 + a, j0 + c] = sum over b of dW * A for one (q tile, kv tile)
// pair (blockIdx.x = iq * n_t + jk) and head, in fp32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlc_t_bwd_dt_kernel(const T* __restrict__ gn, const float* __restrict__ s,
                    const T* __restrict__ v, const T* __restrict__ q,
                    const T* __restrict__ k, float* __restrict__ dt,
                    int B, int H, int N, int F, int D) {
  constexpr int TILE = first_tile<T>();
  const Geometry<T, TILE> g(F, D);
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_t = (N + TILE - 1) / TILE;
  const int iq = blockIdx.x / n_t;
  const int jk = blockIdx.x - iq * n_t;
  const int h = blockIdx.y;
  const int i0 = iq * TILE;
  const int j0 = jk * TILE;
  const float* acc = batch_sum_dw_a<T, TILE>(smem, gn, s, v, q, k, B, H, N, F, D, h, i0, j0);
  const int rows_q = min(TILE, N - i0);
  const int rows_kv = min(TILE, N - j0);
  float* out = dt + ((size_t)h * N + i0) * N + j0;
  for (int idx = threadIdx.x; idx < rows_q * TILE; idx += THREADS) {
    const int a = idx / TILE;
    const int c = idx % TILE;
    if (c < rows_kv) out[(size_t)a * N + c] = acc[a * g.lds + c];
  }
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

// dq and dkv launch with the largest tile, from first_tile<T>() down to
// MIN_TILE, whose block fits in shared memory.
template <typename T, int TILE = first_tile<T>()>
int launch_dq(const void* gn, const void* s, const void* v, const void* k, const void* t,
              void* dq, int B, int H, int N, int F, int D, void* stream) {
  const DqLayout<T, TILE> L(F, D);
  if constexpr (TILE > MIN_TILE) {
    if (L.bytes > (size_t)MAX_SMEM)
      return launch_dq<T, TILE / 2>(gn, s, v, k, t, dq, B, H, N, F, D, stream);
  }
  const int err = prepare(mlc_t_bwd_dq_kernel<T, TILE>, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  mlc_t_bwd_dq_kernel<T, TILE><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gn), static_cast<const float*>(s), static_cast<const T*>(v),
      static_cast<const T*>(k), static_cast<const float*>(t), static_cast<T*>(dq),
      H, N, F, D);
  return cudaGetLastError();
}

template <typename T, int TILE = first_tile<T>()>
int launch_dkv(const void* gn, const void* s, const void* v, const void* q, const void* k,
               const void* t, void* dk, void* dv, int B, int H, int N, int F, int D,
               void* stream) {
  const DkvLayout<T, TILE> L(F, D);
  if constexpr (TILE > MIN_TILE) {
    if (L.bytes > (size_t)MAX_SMEM)
      return launch_dkv<T, TILE / 2>(gn, s, v, q, k, t, dk, dv, B, H, N, F, D, stream);
  }
  const int err = prepare(mlc_t_bwd_dkv_kernel<T, TILE>, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  mlc_t_bwd_dkv_kernel<T, TILE><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gn), static_cast<const float*>(s), static_cast<const T*>(v),
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const float*>(t),
      static_cast<T*>(dk), static_cast<T*>(dv), H, N, F, D);
  return cudaGetLastError();
}

template <typename T>
int launch_dt(const void* gn, const void* s, const void* v, const void* q, const void* k,
              void* dt, int B, int H, int N, int F, int D, void* stream) {
  constexpr int TILE = first_tile<T>();
  const BatchSumLayout<T, TILE> L(F, D);
  const int err = prepare(mlc_t_bwd_dt_kernel<T>, L.bytes);
  if (err != cudaSuccess) return err;
  const int n_t = (N + TILE - 1) / TILE;
  const dim3 grid(n_t * n_t, H);
  mlc_t_bwd_dt_kernel<T><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gn), static_cast<const float*>(s), static_cast<const T*>(v),
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<float*>(dt),
      B, H, N, F, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// gn, v [B, H, N, D], k' and dq [B, H, N, F] in bf16; s [B, H, N] and t
// [H, N, N] in fp32; all contiguous. Every launch below runs on `stream`,
// does not synchronise, allocates nothing, and returns the CUDA error code
// (0 = launched; cudaErrorInvalidValue for empty dims or tiles that exceed
// shared memory even at MIN_TILE rows).
int mlt_bwd_dq_bf16(const void* gn, const void* s, const void* v, const void* k,
                    const void* t, void* dq, int B, int H, int N, int F, int D,
                    void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dq<bf16>(gn, s, v, k, t, dq, B, H, N, F, D, stream);
}

int mlt_bwd_dq_f32(const void* gn, const void* s, const void* v, const void* k,
                   const void* t, void* dq, int B, int H, int N, int F, int D,
                   void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dq<float>(gn, s, v, k, t, dq, B, H, N, F, D, stream);
}

// dk' [B, H, N, F] and dv [B, H, N, D] in the input dtype.
int mlt_bwd_dkv_bf16(const void* gn, const void* s, const void* v, const void* q,
                     const void* k, const void* t, void* dk, void* dv,
                     int B, int H, int N, int F, int D, void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dkv<bf16>(gn, s, v, q, k, t, dk, dv, B, H, N, F, D, stream);
}

int mlt_bwd_dkv_f32(const void* gn, const void* s, const void* v, const void* q,
                    const void* k, const void* t, void* dk, void* dv,
                    int B, int H, int N, int F, int D, void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dkv<float>(gn, s, v, q, k, t, dk, dv, B, H, N, F, D, stream);
}

// dt [H, N, N] fp32, the batch sum of dW * A.
int mlt_bwd_dt_bf16(const void* gn, const void* s, const void* v, const void* q,
                    const void* k, void* dt, int B, int H, int N, int F, int D,
                    void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dt<bf16>(gn, s, v, q, k, dt, B, H, N, F, D, stream);
}

int mlt_bwd_dt_f32(const void* gn, const void* s, const void* v, const void* q,
                   const void* k, void* dt, int B, int H, int N, int F, int D,
                   void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dt<float>(gn, s, v, q, k, dt, B, H, N, F, D, stream);
}

const char* mlt_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
