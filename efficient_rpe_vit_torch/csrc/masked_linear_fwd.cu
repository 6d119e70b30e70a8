// Toeplitz-masked linear attention (KERPLE) forward from a materialised T,
// for Hopper.
//
// Replaces the TPU kernel efficient_rpe_vit_tpu/ops/pallas/attention_kernels.py
// `_masked_linear_kernel` (launched by `_masked_linear_fwd_impl`, public
// `fused_masked_linear_attention`). Per (batch b, head h), with T [H, N, N]
// fp32 given:
//
//   S   = q' k'^T                      (fp32 accumulation)
//   W   = S * T                        (fp32)
//   den = rowsum(W)                    (fp32)
//   num = round_to_input_dtype(W) v    (fp32 accumulation)
//   out = num / (den + 1e-6)           (written in v's dtype), den written in fp32
//
// The arithmetic is that of the coefficient kernel (masked_linear_coeffs_fwd.cu);
// only the mask differs: each block stages the [TILE, TILE] tile of T its tile
// pair needs instead of indexing a coefficient window. A row of T is N * 4
// bytes (788 at N = 197), never 16-byte aligned in general, so the tile moves
// as 4-byte cp.async words; rows and columns past N are zero-filled, and
// nothing is written past N.
//
// What bounds it on an H100: at the long-N shape (B=4, H=12, N=4097, F=266,
// D=64, bf16) operations, 2 B H N^2 (F + D) = 5.3e11, 0.54 ms at the bf16
// tensor-core peak, against 0.81 GB of T (0.24 ms); at the JAX script's
// ViT head dims (F=44, D=16) bytes, T's [H, N, N] and the q', k', v rows.
// This first version is simple rather than fast: one block per (q tile,
// head, batch) looping over kv tiles with the shared tile products of
// kerple_common.cuh (WMMA bf16, fp32 FMA), 64-row tiles in bf16 and 32 in
// fp32 (halved where a large F outgrows shared memory), no load/compute
// overlap, and T re-read by every batch element (mostly from L2 at small N).

#include "kerple_common.cuh"

namespace {

using namespace kerple;

constexpr int MIN_TILE = 16;
constexpr float EPS = 1e-6f;

template <typename T>
__host__ __device__ constexpr int first_tile() { return is_bf16<T>() ? 64 : 32; }

template <typename T, int TILE>
struct FwdLayout {
  size_t q, k, v, t, sc, w, acc, den, bytes;
  __host__ __device__ FwdLayout(int F, int D) {
    const Geometry<T, TILE> g(F, D);
    Arena a;
    q = a.take<T>(TILE * g.ldf);
    k = a.take<T>(TILE * g.ldf);
    v = a.take<T>(TILE * g.ldd);
    t = a.take<float>(TILE * TILE);
    sc = a.take<float>(TILE * g.lds);
    w = a.take<T>(TILE * g.ldw);
    acc = a.take<float>(TILE * g.ldad);
    den = a.take<float>(TILE);
    bytes = a.top;
  }
};

template <typename T, int TILE>
__global__ void __launch_bounds__(THREADS)
mlc_t_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ t,
                 T* __restrict__ out, float* __restrict__ den,
                 int H, int N, int F, int D) {
  const Geometry<T, TILE> g(F, D);
  const FwdLayout<T, TILE> L(F, D);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Ts = reinterpret_cast<float*>(smem + L.t);
  float* Ss = reinterpret_cast<float*>(smem + L.sc);
  T* Ws = reinterpret_cast<T*>(smem + L.w);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* den_s = reinterpret_cast<float*>(smem + L.den);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const int rows_q = min(TILE, N - i0);
  const float* tb = t + (size_t)h * N * N;

  load_tile<T, TILE>(Qs, g.ldf, g.fp, q + (bh * N + i0) * F, rows_q, F);
  for (int a = threadIdx.x; a < TILE; a += THREADS) den_s[a] = 0.f;
  for (int idx = threadIdx.x; idx < TILE * g.ldad; idx += THREADS) acc[idx] = 0.f;

  const int n_kv = (N + TILE - 1) / TILE;
  for (int jt = 0; jt < n_kv; ++jt) {
    const int j0 = jt * TILE;
    const int rows_kv = min(TILE, N - j0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, TILE>(Ks, g.ldf, g.fp, k + (bh * N + j0) * F, rows_kv, F);
    load_tile<T, TILE>(Vs, g.ldd, g.dp, v + (bh * N + j0) * D, rows_kv, D);
    load_t_tile<TILE>(Ts, TILE, tb, i0, j0, N);
    cp_async_wait_all();  // this tile's (and, first time round, Q's) copies
    __syncthreads();
    scores<T, TILE>(Ss, g.lds, Qs, g.ldf, Ks, g.ldf, g.fp);  // S = q' k'^T
    __syncthreads();
    // den += rowsum(S * T) in fp32: one warp per row, lanes over columns,
    // then a butterfly; row a always falls to the same warp.
    for (int a = warp; a < TILE; a += WARPS) {
      float rs = 0.f;
      for (int b = lane; b < TILE; b += 32) rs += Ss[a * g.lds + b] * Ts[a * TILE + b];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      if (lane == 0) den_s[a] += rs;
    }
    // W = round(S * T), zero past the ragged edges
    weigh_by<T, TILE>(Ws, g.ldw, Ss, g.lds, nullptr, TileMask{Ts, TILE}, rows_q, rows_kv);
    __syncthreads();
    accumulate<T, TILE, false>(acc, g.ldad, Ws, g.ldw, Vs, g.ldd, g.dp);  // num += W v
  }
  __syncthreads();
  T* ob = out + (bh * N + i0) * D;
  for (int idx = threadIdx.x; idx < rows_q * D; idx += THREADS) {
    const int a = idx / D;
    const int d = idx - a * D;
    ob[idx] = from_float<T>(acc[a * g.ldad + d] / (den_s[a] + EPS));
  }
  for (int a = threadIdx.x; a < rows_q; a += THREADS) den[bh * N + i0 + a] = den_s[a];
}

// The largest tile, from first_tile<T>() down to MIN_TILE, whose block fits
// in shared memory.
template <typename T, int TILE = first_tile<T>()>
int launch(const void* q, const void* k, const void* v, const void* t, void* out,
           void* den, int B, int H, int N, int F, int D, void* stream) {
  const FwdLayout<T, TILE> L(F, D);
  if constexpr (TILE > MIN_TILE) {
    if (L.bytes > (size_t)MAX_SMEM)
      return launch<T, TILE / 2>(q, k, v, t, out, den, B, H, N, F, D, stream);
  }
  if (L.bytes > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlc_t_fwd_kernel<T, TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  mlc_t_fwd_kernel<T, TILE><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(t), static_cast<T*>(out), static_cast<float*>(den),
      H, N, F, D);
  return cudaGetLastError();
}

template <typename T>
int checked_launch(const void* q, const void* k, const void* v, const void* t, void* out,
                   void* den, int B, int H, int N, int F, int D, void* stream) {
  (void)cudaGetLastError();  // start from a clean error state
  if (B <= 0 || H <= 0 || N <= 0 || F <= 0 || D <= 0) return cudaErrorInvalidValue;
  return launch<T>(q, k, v, t, out, den, B, H, N, F, D, stream);
}

}  // namespace

extern "C" {

// q', k' [B, H, N, F], v and out [B, H, N, D] in bf16; t [H, N, N] and den
// [B, H, N] in fp32; all contiguous. Runs on `stream`, does not synchronise,
// allocates nothing. Returns the CUDA error code (0 = launched;
// cudaErrorInvalidValue for empty dims or tiles that exceed shared memory
// even at MIN_TILE rows).
int mlt_fwd_bf16(const void* q, const void* k, const void* v, const void* t, void* out,
                 void* den, int B, int H, int N, int F, int D, void* stream) {
  return checked_launch<bf16>(q, k, v, t, out, den, B, H, N, F, D, stream);
}

// As mlt_fwd_bf16 with q', k', v and out in fp32.
int mlt_fwd_f32(const void* q, const void* k, const void* v, const void* t, void* out,
                void* den, int B, int H, int N, int F, int D, void* stream) {
  return checked_launch<float>(q, k, v, t, out, den, B, H, N, F, D, stream);
}

const char* mlt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
