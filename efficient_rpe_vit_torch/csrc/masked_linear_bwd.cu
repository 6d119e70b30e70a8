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
// accumulation), where the Pallas bodies round. T may be any [H, N, N] fp32
// matrix, not only a Toeplitz one. No float atomics: every output is
// bitwise the same run to run.
//
// What bounds it on an H100: at the long-N shape (B=4, H=12, N=4097, F=266,
// D=64, bf16) operations: dq 2 B H N^2 (D + F) = 5.3e11 (0.54 ms at the bf16
// peak, T's 0.81 GB 0.24 ms), dkv twice that, dT as dq with 0.81 GB of dT
// written; at the JAX A/B's head dims (F=44, D=16) bytes.
//
// bf16 at even F <= 272, D <= 64 (the coefficient kernels' rule) runs the
// register-resident mma.sync kernels; launch_info reports which:
// - dq (mlt_bwd_dq_mma_kernel) and dkv (mlt_bwd_dkv_mma_kernel) are #2's
//   mainloops with the mask as their template policy: dkv runs
//   kerple_common.cuh's dkv_mma_stage, which #2's dkv kernel runs too; dq
//   runs dq_mma_stage below, #2's dq stage body as a template (#2's own dq
//   kernel keeps its body as written: taking the template moved its ptxas
//   spill counts and its long-N time by 2%). dq: one block per (batch,
//   128 query rows, head), two warps per 16 rows swapping rounded weights
//   as mma A fragments; T's [128, 64] tile rides the ring beside k' and v
//   as 16-byte words where N % 4 == 0, and elsewhere each thread loads its
//   16 elements of a stage into registers a stage ahead. dkv: one block per
//   (batch, 64 key/value rows, head), four warps per 16 rows; the [32, 64]
//   tile of T of each 32-row query tile rides the ring beside q', gn and s
//   and is read transposed (row stride 68 floats: a warp's reads of 4
//   query rows 2 apart x 8 consecutive key/value columns fall on distinct
//   banks). The batch is the fastest grid axis of both, so the blocks that
//   read one slab of T run together.
// - dT (mlt_bwd_dt_mma_kernel) is new: one block per (batch group, 64
//   key/value rows, 128 query rows, head), one warp per 16 query rows. Each
//   ring stage holds one batch element's k', v, gn and s; q' has one buffer,
//   read by every warp as mma A fragments at the start of the element and
//   refilled for the next after a second barrier. A = q' k'^T and M = gn v^T
//   are formed in registers as the dc kernel's warps form them, and each
//   warp adds (M - s) * A to its 16 x 64 fp32 sum in registers, elements in
//   batch order. The batch groups (groups of ceil(B / groups) elements, no
//   group empty) are the fewest that minimise waves x elements per group
//   (dt_groups; a wave is blocks per SM x 132 blocks): 16 at (256, 2, 197,
//   44, 16), one at long N. With one group the sums are dT; with more they
//   go to a scratch of partial sums [groups, H, N, N] fp32, at most
//   DT_SCRATCH_CAP values (32 MiB), that the wrapper allocates (the size
//   from mlt_bwd_dt_scratch_floats; a launch that needs it and lacks it is
//   refused) and mlt_bwd_dt_group_sum_kernel sums in group order.
// Each comes in three instantiations by (F, D): features to 272 and values
// to 64, F <= 128 with D <= 64, and F <= 64 with D <= 16 (the JAX A/B's
// F = 44, D = 16; dT's at two blocks per SM). Shapes, the ways of reading
// T and the groups were picked by trial (experiments/tile_trial.py,
// PERF.md).
//
// fp32 and the other shapes keep the first version, simple rather than
// fast: 64-row tiles in bf16 and 32 in fp32 (dq and dkv halved where a
// large F outgrows shared memory), no load/compute overlap, dkv recomputing
// A and M, dT recomputing both again and summing the batch in order in
// shared memory (batch_sum_dw_a) with one block per (tile pair, head).

#include "kerple_common.cuh"

#include <algorithm>

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

// ─── bf16: register-resident tiles on mma.sync, T through the ring ─────

namespace fm = flash::mma;

// A thread's place in mlt_bwd_dq_mma_kernel: its warp and lane, the SPLIT
// warps' row group and this warp's part of it, the group's first query row
// in the block, this warp's first key/value column in a stage, and its
// fragment rows r, r + 8 and columns qc, qc + 1 of each 8-column block.
// Filled once, before the sweep, from the kernel's own values.
struct DqThread {
  int warp, lane, group, part, row0, c0, r, qc;
};

// One key/value stage of mlt_bwd_dq_mma_kernel (geometry C: BM query rows
// a block, SPLIT warps per 16 of them, BN key/value rows a stage): the
// stage body of mlc_bwd_dq_mma_kernel (masked_linear_coeffs_bwd.cu), kept
// there as written, with the mask a template policy, for the stage's k'
// (Kt) and v (Vt) at key/value row j0. Each warp computes M = gn v^T for
// its BN / SPLIT columns from gn's A fragments gf, then per cell, with
// T[i, j] = mask(i - i0, j - j0) (a TileMask over the stage's staged
// [BM, BN] tile of T, or a FragMask over T in registers), dA = round((M -
// s_i) T),
// zero for cells past N in either direction (row_ok: this thread's rows r,
// r + 8 below N), packed as bf16 pairs: exactly the registers of an mma A
// fragment that its 8-column blocks fill. The warps of the row group swap
// these through xch (a named barrier of the group), so each holds the
// rounded dA of all BN columns as the A operands of dq' += dA k' over
// feature blocks p_begin.. p_begin + p_count - 1, accumulated in acc.
// after_mask() runs once the mask has been read, as in fwd_mma_stage.
template <typename C, typename Mask, typename Hook = NoHook>
__device__ __forceinline__ void dq_mma_stage(float (&acc)[2 * C::PAIRS][4],
                                             const uint32_t (&gf)[C::DP / 16][4],
                                             const float (&s_r)[2], const bool (&row_ok)[2],
                                             const bf16* Kt, const bf16* Vt, const Mask& mask,
                                             uint2* xch, const DqThread& th, int j0, int N,
                                             int p_begin, int p_count, Hook after_mask = Hook{}) {
  namespace fm = flash::mma;
  // M = gn v^T for this warp's NBW 8-column blocks
  float m[C::NBW][4];
  fm::zero_acc(m);
  fm::mma_a_rows<C::DP / 16, C::NBW>(m, gf, Vt + th.c0 * C::LDD, C::LDD);
  // per cell (query row i, key/value row j): dA = round((M - s_i) T)
#pragma unroll
  for (int nb = 0; nb < C::NBW; ++nb) {
    float wd[4];
    float2 tp;  // kPairs: T of this thread's element pair
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int a = th.row0 + th.r + 8 * (e / 2);      // query row in the block
      const int c = th.c0 + nb * 8 + th.qc + (e & 1);  // key/value row in the stage
      if constexpr (Mask::kPairs) {
        if ((e & 1) == 0) tp = mask.pair(a, c);
      }
      wd[e] = 0.f;
      if (row_ok[e / 2] && j0 + c < N) {
        float t;
        if constexpr (Mask::kPairs) {
          t = (e & 1) ? tp.y : tp.x;
        } else {
          t = mask.at(a, c, nb, e);
        }
        wd[e] = (m[nb][e] - s_r[e / 2]) * t;
      }
    }
    xch[(th.warp * C::NBW + nb) * 32 + th.lane] =
        make_uint2(fm::pack_bf16(wd[0], wd[1]), fm::pack_bf16(wd[2], wd[3]));
  }
  after_mask();
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + th.group), "n"(32 * C::SPLIT) : "memory");
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
    // the A fragment of 16-step ks: 8-column blocks 2 ks (registers 0, 1)
    // and 2 ks + 1 (registers 2, 3), each from the warp that computed it
    uint32_t da[4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int blk = 2 * ks + hh;
      const uint2 w2 = xch[((th.group * C::SPLIT + blk / C::NBW) * C::NBW + blk % C::NBW) * 32 +
                           th.lane];
      da[2 * hh] = w2.x;
      da[2 * hh + 1] = w2.y;
    }
#pragma unroll
    for (int lp = 0; lp < C::PAIRS; ++lp) {
      if (lp >= p_count) continue;
      uint32_t b[4];
      fm::load_b_cols(b, Kt, C::LDF, ks * 16, (p_begin + lp) * 16);
      fm::mma_bf16(acc[2 * lp], da, b[0], b[1]);
      fm::mma_bf16(acc[2 * lp + 1], da, b[2], b[3]);
    }
  }
}

// Geometry of mlt_bwd_dq_mma_kernel: DqMma (masked_linear_coeffs_bwd.cu)
// with each ring stage's coefficient window replaced by the block's tile of
// T [BM, LDT] fp32. Shared memory: gn [BM, LDD] bf16 and s [BM] fp32
// resident; a ring of two stages, each k' [BN, LDF] and v [BN, LDD] bf16
// and, unless TREG, the tile of T; and per warp and 8-column block of its
// score columns one 8-byte word a lane of rounded weights. TREG: each
// thread loads its own elements of T straight from device memory into
// registers in the accumulator layout, a stage ahead, instead.
template <int FMAX_, int DP_, int BM_, int SPLIT_, int BN_, bool TREG_>
struct TDqMma {
  static constexpr int FMAX = FMAX_, DP = DP_, BM = BM_, SPLIT = SPLIT_, BN = BN_;
  static constexpr bool TREG = TREG_;
  static constexpr int WARPS = BM / 16 * SPLIT, NT = 32 * WARPS;
  static constexpr int NBW = BN / (8 * SPLIT);  // 8-column blocks of M a warp computes
  static constexpr int KS = BN / 16;            // 16-steps of the dq' product a stage
  static constexpr int LDF = FMAX + 8, LDD = DP + 8;
  // fp32 row stride of the T tile: a warp's 8-byte reads of a fragment
  // element pair (8 rows x 4 lanes) fall on distinct banks
  static constexpr int LDT = BN + 8;
  static constexpr int PAIRS = (FMAX / 16 + SPLIT - 1) / SPLIT;  // most dq' blocks a warp holds
  static constexpr size_t G = (size_t)BM * LDD * sizeof(bf16);
  static constexpr size_t S = (size_t)BM * sizeof(float);
  static constexpr size_t KV = (size_t)BN * (LDF + LDD) * sizeof(bf16);
  static constexpr size_t STAGE = KV + (TREG ? 0 : (size_t)BM * LDT * sizeof(float));
  static constexpr size_t XCH = (size_t)WARPS * NBW * 32 * sizeof(uint2);
  static constexpr size_t BYTES = G + S + 2 * STAGE + XCH;
  static_assert(FMAX % 16 == 0 && DP % 16 == 0 && BM % 16 == 0 && BN % (16 * SPLIT) == 0,
                "tile shapes: each warp's score columns load in 16-column pairs");
  static_assert(BM / 16 <= 15, "one named barrier (1..15) per row group");
  static_assert(G % 16 == 0 && S % 16 == 0 && KV % 16 == 0 && STAGE % 16 == 0 &&
                    (BN * LDF * sizeof(bf16)) % 16 == 0, "regions start 16-byte aligned");
};

// dq' for one (batch, BM-row query block, head), bf16, even F <= FMAX,
// D <= DP: mlc_bwd_dq_mma_kernel with the coefficient window replaced by
// the block's [BM, BN] tile of T, which rides the ring beside k' and v
// (16-byte words where N % 4 == 0, else 4-byte ones; zero past N), and the
// batch as the fastest grid axis, so that the blocks sharing a tile of T
// run together. gn and s stay resident, gn's A fragments over D in
// registers for the sweep; per stage dq_mma_stage
// forms dA = round((gn v^T - s) T) in registers (the T pair read as one
// 8-byte word), swaps it between the SPLIT warps of a row group as mma A
// fragments and accumulates dq' += dA k'. No float atomics.
template <typename C>
__global__ void __launch_bounds__(C::NT, C::NT <= 256 ? 2 : 1)
mlt_bwd_dq_mma_kernel(const bf16* __restrict__ gn, const float* __restrict__ s,
                      const bf16* __restrict__ v, const bf16* __restrict__ k,
                      const float* __restrict__ t, bf16* __restrict__ dq, int H, int N, int F,
                      int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Gs = reinterpret_cast<bf16*>(smem);
  float* s_s = reinterpret_cast<float*>(smem + C::G);
  unsigned char* ring = smem + C::G + C::S;
  uint2* xch = reinterpret_cast<uint2*>(ring + 2 * C::STAGE);

  const size_t bh = (size_t)blockIdx.x * H + blockIdx.z;
  const int i0 = blockIdx.y * C::BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = warp / C::SPLIT;
  const int part = warp % C::SPLIT;
  const int row0 = group * 16;       // the group's first query row in the block
  const int c0 = part * C::NBW * 8;  // this warp's key/value columns in a stage
  const int fp = (F + 15) / 16 * 16;
  const int kf = fp / 16;  // 16-column blocks of dq'
  const int p_count = kf / C::SPLIT + (part < kf % C::SPLIT ? 1 : 0);
  const int p_begin = part * (kf / C::SPLIT) + min(part, kf % C::SPLIT);
  const int rows_q = min(C::BM, N - i0);
  const bf16* kh = k + bh * N * F;
  const bf16* vh = v + bh * N * D;
  const float* tb = t + (size_t)blockIdx.z * N * N;

  const auto stage_of = [&](int js) {
    return reinterpret_cast<bf16*>(ring + (js & 1) * C::STAGE);
  };
  const auto stage_kv = [&](int js) {
    bf16* Kt = stage_of(js);
    bf16* Vt = Kt + C::BN * C::LDF;
    const int j0 = js * C::BN;
    const int rows = min(C::BN, N - j0);
    stage_words4<C::BN, C::NT>(Kt, C::LDF, fp, kh + (size_t)j0 * F, rows, F);
    fm::stage_rows<C::BN, C::NT>(Vt, C::LDD, C::DP, vh + (size_t)j0 * D, rows, D);
    if constexpr (!C::TREG)
      stage_t_tile<C::BM, C::BN, C::NT>(reinterpret_cast<float*>(Vt + C::BN * C::LDD), C::LDT,
                                        tb, i0, j0, N);
  };
  fm::stage_rows<C::BM, C::NT>(Gs, C::LDD, C::DP, gn + (bh * N + i0) * D, rows_q, D);
  fm::stage_floats<C::NT>(s_s, s + bh * N + i0, C::BM, rows_q);
  stage_kv(0);
  fm::cp_async_commit();

  float acc[2 * C::PAIRS][4];
  fm::zero_acc(acc);
  uint32_t gf[C::DP / 16][4];  // gn's A fragments, loaded once stage 0 has landed
  float s_r[2] = {0.f, 0.f};   // s of this thread's rows
  const int r = lane / 4;         // this thread's fragment rows r, r + 8
  const int qc = 2 * (lane % 4);  // and columns qc, qc + 1 of each 8-column block
  const bool row_ok[2] = {row0 + r < rows_q, row0 + r + 8 < rows_q};
  const DqThread th{warp, lane, group, part, row0, c0, r, qc};
  float tf[C::TREG ? C::NBW : 1][4];  // TREG: this thread's elements of the stage's T
  if constexpr (C::TREG) {
    if (row0 < rows_q) load_t_frag(tf, tb, i0 + row0, c0, N);
  }

  const int n_kv = (N + C::BN - 1) / C::BN;
  for (int js = 0; js < n_kv; ++js) {
    fm::cp_async_wait<0>();
    __syncthreads();  // stage js staged by every thread; stage js - 1's ring slot and words free
    if (js + 1 < n_kv) {
      stage_kv(js + 1);
      fm::cp_async_commit();
    }
    if (row0 >= rows_q) continue;  // the warps of a group skip together
    if (js == 0) {
      fm::load_a_rows<C::DP / 16>(gf, Gs, C::LDD, row0);
      s_r[0] = s_s[row0 + r];
      s_r[1] = s_s[row0 + r + 8];
    }
    const bf16* Kt = stage_of(js);
    const bf16* Vt = Kt + C::BN * C::LDF;
    const int j0 = js * C::BN;
    if constexpr (C::TREG) {
      // T's registers refilled for stage js + 1 once stage js has read them
      dq_mma_stage<C>(acc, gf, s_r, row_ok, Kt, Vt, FragMask<C::NBW>{tf}, xch, th, j0, N,
                      p_begin, p_count, [&] {
                        if (js + 1 < n_kv) load_t_frag(tf, tb, i0 + row0, j0 + C::BN + c0, N);
                      });
    } else {
      const float* Tt = reinterpret_cast<const float*>(Vt + C::BN * C::LDD);
      dq_mma_stage<C>(acc, gf, s_r, row_ok, Kt, Vt, TileMask{Tt, C::LDT}, xch, th, j0, N,
                      p_begin, p_count);
    }
  }
  store_block<C::PAIRS>(dq + bh * N * F, F, N, F, i0 + row0, p_begin * 16, p_count, acc);
}

// Geometry of mlt_bwd_dkv_mma_kernel: DkvMma (masked_linear_coeffs_bwd.cu)
// with each ring stage's coefficient window replaced by the tile of T
// [BN query rows, LDT] fp32 that the block's BM key/value rows need, read
// transposed (a thread's T[i, j] for its query column i and key/value row
// j). Below 64 value columns (DP = 16) the first DP / 16 warps of a row
// group hold dv's blocks and the others none.
template <int FMAX_, int DP_, int BM_>
struct TDkvMma {
  static constexpr int FMAX = FMAX_, DP = DP_, BM = BM_, BN = 32, WARPS = BM / 4, NT = 32 * WARPS;
  static constexpr int LDF = FMAX + 8, LDD = DP + 8;
  // fp32 row stride of the T tile: 2 LDT = 8 (mod 32) words, so a warp's
  // reads (4 query rows 2 apart x 8 consecutive key/value columns) fall on
  // distinct banks
  static constexpr int LDT = BM + 4;
  static constexpr int PAIRS = (FMAX / 16 + 3) / 4;        // most 16-column dk' blocks a warp holds
  static constexpr int DV_PAIRS = DP >= 64 ? DP / 64 : 1;  // 16-column dv blocks per warp
  static constexpr size_t KV = (size_t)BM * (LDF + LDD) * sizeof(bf16);
  static constexpr size_t QG = (size_t)BN * (LDF + LDD) * sizeof(bf16);
  static constexpr size_t STAGE = QG + (size_t)BN * sizeof(float) + (size_t)BN * LDT * sizeof(float);
  static constexpr size_t XCH = (size_t)WARPS * 32 * sizeof(uint4);
  static constexpr size_t BYTES = KV + 2 * STAGE + XCH;
  static_assert(FMAX % 16 == 0 && DP % 16 == 0 && (DP % 64 == 0 || DP == 16) && BM % 16 == 0,
                "tile shapes");
  static_assert(KV % 16 == 0 && QG % 16 == 0 && STAGE % 16 == 0 && (LDT * 4) % 16 == 0,
                "regions and T's rows start 16-byte aligned");
};

// dk' and dv for one (batch, BM-row key/value block, head), bf16, even
// F <= FMAX, D <= DP: mlc_bwd_dkv_mma_kernel with the coefficient window
// replaced by the [32, BM] tile of T of each query tile, which rides the
// ring beside q', gn and s, and the batch as the fastest grid axis. k' and
// v stay resident; per query tile kerple_common.cuh's dkv_mma_stage forms
// A^T and M^T in registers, weighs them by T^T, swaps the rounded weights
// between the four warps of a row group as mma A fragments and accumulates
// dk' += Wk^T q' and dv += Wv^T gn. No float atomics.
template <typename C>
__global__ void __launch_bounds__(C::NT, C::NT <= 256 ? 2 : 1)
mlt_bwd_dkv_mma_kernel(const bf16* __restrict__ gn, const float* __restrict__ s,
                       const bf16* __restrict__ v, const bf16* __restrict__ q,
                       const bf16* __restrict__ k, const float* __restrict__ t,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int N, int F, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + C::BM * C::LDF;
  uint4* xch = reinterpret_cast<uint4*>(smem + C::KV + 2 * C::STAGE);

  const size_t bh = (size_t)blockIdx.x * H + blockIdx.z;
  const int j0 = blockIdx.y * C::BM;
  const int warp = threadIdx.x / 32;
  const int quarter = warp % 4;
  const int row0 = warp / 4 * 16;  // the row group's first key/value row in the block
  const int fp = (F + 15) / 16 * 16;
  const int kf = fp / 16;  // 16-column steps of the A^T sum and blocks of dk'
  const int p_count = kf / 4 + (quarter < kf % 4 ? 1 : 0);
  const int p_begin = quarter * (kf / 4) + min(quarter, kf % 4);
  const bf16* qh = q + bh * N * F;
  const bf16* gnh = gn + bh * N * D;
  const float* sh = s + bh * N;
  const float* tb = t + (size_t)blockIdx.z * N * N;

  const auto tile_q = [&](int it) {
    return reinterpret_cast<bf16*>(smem + C::KV + (it & 1) * C::STAGE);
  };
  const auto stage_q = [&](int it) {
    bf16* Qt = tile_q(it);
    bf16* Gt = Qt + C::BN * C::LDF;
    float* s_t = reinterpret_cast<float*>(Gt + C::BN * C::LDD);
    const int i0 = it * C::BN;
    const int rows = min(C::BN, N - i0);
    stage_words4<C::BN, C::NT>(Qt, C::LDF, fp, qh + (size_t)i0 * F, rows, F);
    fm::stage_rows<C::BN, C::NT>(Gt, C::LDD, C::DP, gnh + (size_t)i0 * D, rows, D);
    fm::stage_floats<C::NT>(s_t, sh + i0, C::BN, rows);
    stage_t_tile<C::BN, C::BM, C::NT>(s_t + C::BN, C::LDT, tb, i0, j0, N);
  };
  const int rows_kv = min(C::BM, N - j0);
  stage_words4<C::BM, C::NT>(Ks, C::LDF, fp, k + (bh * N + j0) * F, rows_kv, F);
  fm::stage_rows<C::BM, C::NT>(Vs, C::LDD, C::DP, v + (bh * N + j0) * D, rows_kv, D);
  stage_q(0);
  fm::cp_async_commit();

  float dka[2 * C::PAIRS][4], dva[2 * C::DV_PAIRS][4];
  fm::zero_acc(dka);
  fm::zero_acc(dva);
  const DkvThread th(j0);

  const int n_q = (N + C::BN - 1) / C::BN;
  for (int it = 0; it < n_q; ++it) {
    fm::cp_async_wait<0>();
    __syncthreads();  // tile it staged by every thread; tile it - 1's stage and words free
    if (it + 1 < n_q) {
      stage_q(it + 1);
      fm::cp_async_commit();
    }
    if (row0 >= rows_kv) continue;  // the four warps of a group skip together
    const bf16* Qt = tile_q(it);
    const bf16* Gt = Qt + C::BN * C::LDF;
    const float* s_t = reinterpret_cast<const float*>(Gt + C::BN * C::LDD);
    dkv_mma_stage<C>(dka, dva, Ks, Vs, Qt, Gt, s_t, TileMask{s_t + C::BN, C::LDT}, xch,
                     th, it * C::BN, j0, N, kf, p_begin, p_count);
  }
  store_block<C::PAIRS>(dk + bh * N * F, F, N, F, j0 + row0, p_begin * 16, p_count, dka);
  store_block<C::DV_PAIRS>(dv + bh * N * D, D, N, D, j0 + row0, quarter * C::DV_PAIRS * 16,
                           C::DV_PAIRS, dva);
}

// Geometry of mlt_bwd_dt_mma_kernel: blocks of BM query rows (one warp per
// 16) against BN key/value rows, features staged up to FMAX, values to DP.
// Shared memory: q' [BM, LDF] bf16, one buffer, read into registers as mma
// A fragments at the start of each batch element; a ring of two stages,
// each k' [BN, LDF], v [BN, LDD] and gn [BM, LDD] bf16 and s [BM] fp32 of
// one batch element. MINB blocks per SM: registers capped to fit them.
template <int FMAX_, int DP_, int BM_, int BN_, int MINB_>
struct TDtMma {
  static constexpr int FMAX = FMAX_, DP = DP_, BM = BM_, BN = BN_;
  static constexpr int MINB = MINB_;  // blocks per SM the registers are capped for
  static constexpr int WARPS = BM / 16, NT = 32 * WARPS;
  static constexpr int KF = FMAX / 16;  // 16-steps of A's sum over F
  static constexpr int NB = BN / 8;     // 8-column blocks of a warp's tile
  static constexpr int LDF = FMAX + 8, LDD = DP + 8;
  static constexpr size_t Q = (size_t)BM * LDF * sizeof(bf16);
  static constexpr size_t KV = (size_t)BN * (LDF + LDD) * sizeof(bf16);
  static constexpr size_t G = (size_t)BM * LDD * sizeof(bf16);
  static constexpr size_t STAGE = KV + G + (size_t)BM * sizeof(float);
  static constexpr size_t BYTES = Q + 2 * STAGE;
  static_assert(FMAX % 16 == 0 && DP % 16 == 0 && BM % 16 == 0 && BN % 16 == 0, "tile shapes");
  static_assert(Q % 16 == 0 && KV % 16 == 0 && G % 16 == 0 && STAGE % 16 == 0 &&
                    (BN * LDF * sizeof(bf16)) % 16 == 0, "regions start 16-byte aligned");
};

// The sum over batch elements b_begin.. b_end - 1 of dW * A for one (tile
// pair, head, batch group): blockIdx.x = group + groups * (kv block),
// blockIdx.y the query block, blockIdx.z the head; groups of
// ceil(B / groups) batch elements, the last possibly shorter. Each ring
// stage is one batch element's q', gn, s, k' and v rows. Warp w owns query
// rows 16 w.. 16 w + 15 against all BN key/value columns: per batch element
// it reads its q' rows as A fragments (then the block's second barrier
// frees q''s buffer for the next element's copy), computes A = q' k'^T over
// F and M = gn v^T over D (16 columns at a time) on mma.sync in registers,
// as mlc_bwd_dc_mma_kernel's warps do, and adds (M - s) * A to its 16 x BN
// fp32 sum in registers, elements in batch order. The sum goes to
// out[group, h] ([groups, H, N, N] fp32; with one group, dT itself), rows
// and columns below N. No float atomics.
template <typename C>
__global__ void __launch_bounds__(C::NT, C::MINB)
mlt_bwd_dt_mma_kernel(const bf16* __restrict__ gn, const float* __restrict__ s,
                      const bf16* __restrict__ v, const bf16* __restrict__ q,
                      const bf16* __restrict__ k, float* __restrict__ out, int B, int H, int N,
                      int F, int D, int groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + C::Q;

  const int group = blockIdx.x % groups;
  const int j0 = blockIdx.x / groups * C::BN;
  const int i0 = blockIdx.y * C::BM;
  const int h = blockIdx.z;
  const int per = (B + groups - 1) / groups;
  const int b_begin = group * per;
  const int b_end = min(B, b_begin + per);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // the warp's first query row in the block
  const int fp = (F + 15) / 16 * 16;
  const int kf = fp / 16;  // 16-column steps of A's sum over F
  const int rows_q = min(C::BM, N - i0);
  const int rows_kv = min(C::BN, N - j0);

  const auto stage = [&](int b, int slot) {
    bf16* Kt = reinterpret_cast<bf16*>(ring + slot * C::STAGE);
    bf16* Vt = Kt + C::BN * C::LDF;
    bf16* Gt = Vt + C::BN * C::LDD;
    float* St = reinterpret_cast<float*>(Gt + C::BM * C::LDD);
    const size_t bh = (size_t)b * H + h;
    stage_words4<C::BM, C::NT>(Qs, C::LDF, fp, q + (bh * N + i0) * F, rows_q, F);
    stage_words4<C::BN, C::NT>(Kt, C::LDF, fp, k + (bh * N + j0) * F, rows_kv, F);
    fm::stage_rows<C::BN, C::NT>(Vt, C::LDD, C::DP, v + (bh * N + j0) * D, rows_kv, D);
    fm::stage_rows<C::BM, C::NT>(Gt, C::LDD, C::DP, gn + (bh * N + i0) * D, rows_q, D);
    fm::stage_floats<C::NT>(St, s + bh * N + i0, C::BM, rows_q);
  };
  stage(b_begin, 0);
  fm::cp_async_commit();

  const bool warp_live = row0 < rows_q;  // the warp holds a query row below N
  const int r = lane / 4;                // this thread's fragment rows r, r + 8
  const int qc = 2 * (lane % 4);         // and columns qc, qc + 1 of each 8-column block
  float acc[C::NB][4];                   // this warp's sum over the group of dW * A
  fm::zero_acc(acc);
  for (int b = b_begin; b < b_end; ++b) {
    const int slot = (b - b_begin) & 1;
    fm::cp_async_wait<0>();
    __syncthreads();  // element b staged by every thread; the other slot free
    uint32_t qf[C::KF][4];
#pragma unroll
    for (int kk = 0; kk < C::KF; ++kk)
      if (warp_live && kk < kf) fm::load_a(qf[kk], Qs, C::LDF, row0, kk * 16);
    __syncthreads();  // every warp holds its q' fragments: q''s buffer free
    if (b + 1 < b_end) {
      stage(b + 1, slot ^ 1);
      fm::cp_async_commit();
    }
    if (!warp_live) continue;
    const bf16* Kt = reinterpret_cast<const bf16*>(ring + slot * C::STAGE);
    const bf16* Vt = Kt + C::BN * C::LDF;
    const bf16* Gt = Vt + C::BN * C::LDD;
    const float* St = reinterpret_cast<const float*>(Gt + C::BM * C::LDD);
    float a[C::NB][4];  // A = q' k'^T
    fm::zero_acc(a);
#pragma unroll
    for (int kk = 0; kk < C::KF; ++kk) {
      if (kk >= kf) break;
#pragma unroll
      for (int np = 0; np < C::NB / 2; ++np) {
        uint32_t bf[4];
        fm::load_b_rows(bf, Kt, C::LDF, np * 16, kk * 16);
        fm::mma_bf16(a[2 * np], qf[kk], bf[0], bf[1]);
        fm::mma_bf16(a[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }
    uint32_t gf[C::DP / 16][4];
    fm::load_a_rows<C::DP / 16>(gf, Gt, C::LDD, row0);
    const float s0 = St[row0 + r], s1 = St[row0 + r + 8];
#pragma unroll
    for (int np = 0; np < C::NB / 2; ++np) {  // M = gn v^T, 16 columns at a time
      float mm[2][4];
      fm::zero_acc(mm);
#pragma unroll
      for (int kd = 0; kd < C::DP / 16; ++kd) {
        uint32_t bf[4];
        fm::load_b_rows(bf, Vt, C::LDD, np * 16, kd * 16);
        fm::mma_bf16(mm[0], gf[kd], bf[0], bf[1]);
        fm::mma_bf16(mm[1], gf[kd], bf[2], bf[3]);
      }
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const float(&x)[4] = a[2 * np + hb];
        float(&y)[4] = acc[2 * np + hb];
        y[0] += (mm[hb][0] - s0) * x[0];
        y[1] += (mm[hb][1] - s0) * x[1];
        y[2] += (mm[hb][2] - s1) * x[2];
        y[3] += (mm[hb][3] - s1) * x[3];
      }
    }
  }
  if (!warp_live) return;
  float* dst = out + ((size_t)group * H + h) * N * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + row0 + r + 8 * half;
    if (i >= N) continue;
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = j0 + nb * 8 + qc + j;
        if (c < N) dst[(size_t)i * N + c] = acc[nb][2 * half + j];
      }
  }
}

// dt[i] = sum over groups of part[group][i], groups in order (no atomics).
__global__ void __launch_bounds__(THREADS)
mlt_bwd_dt_group_sum_kernel(const float* __restrict__ part, float* __restrict__ dt, size_t n,
                            int groups) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    float sum = 0.f;
    for (int g = 0; g < groups; ++g) sum += part[g * n + i];
    dt[i] = sum;
  }
}

// The bf16 instantiations, by (F, D), picked by trial on an H100
// (experiments/tile_trial.py, numbers in PERF.md): features up to 272
// (F = 266) and values up to 64, F <= 128 with D <= 64, and F <= 64 with
// D <= 16 (the JAX A/B's F = 44, D = 16); dq with T in registers where N
// is not a multiple of 4 (dq_t_in_registers), else staged in the ring; the
// narrow dT at two blocks per SM.
template <bool TREG> using DqWide = TDqMma<272, 64, 128, 2, 64, TREG>;
template <bool TREG> using DqMid = TDqMma<128, 64, 128, 2, 64, TREG>;
template <bool TREG> using DqNarrow = TDqMma<64, 16, 128, 2, 64, TREG>;
using DkvWide = TDkvMma<272, 64, 64>;
using DkvMid = TDkvMma<128, 64, 64>;
using DkvNarrow = TDkvMma<64, 16, 64>;
using DtWide = TDtMma<272, 64, 128, 64, 1>;
using DtMid = TDtMma<128, 64, 128, 64, 1>;
using DtNarrow = TDtMma<64, 16, 128, 64, 2>;

// Where the dq kernel holds T in registers: where T's rows are not 16-byte
// aligned and its ring stages would move T as 4-byte words.
bool dq_t_in_registers(int N) { return N % 4 != 0; }

// dT's batch groups hold at most DT_SCRATCH_CAP fp32 values of partial sums
// (32 MiB); one group writes dT directly.
constexpr long long DT_SCRATCH_CAP = 8LL << 20;
constexpr int SMS = 132;  // the H100's streaming multiprocessors

// Whether a bf16 launch at (F, D) runs the mma.sync dq, dkv and dT kernels
// (at even F <= 272, D <= 64, the rule of the coefficient kernels); the
// staged kernels run the rest (fp32, F > 272, odd F, D > 64).
bool mma_takes(int F, int D) { return F <= 272 && F % 2 == 0 && D <= 64; }

// 0: narrow (F <= 64, D <= 16), 1: mid (F <= 128, D <= 64), 2: wide.
int width_of(int F, int D) { return F <= 64 && D <= 16 ? 0 : F <= 128 ? 1 : 2; }

// The instantiation a launch runs: its kernel, rows per block (the dT
// kernel's key/value rows in cols), threads, shared memory and (dT) the
// blocks per SM its registers are capped for.
struct MmaChoice {
  const void* kernel;
  int rows, cols, threads;
  size_t bytes;
  int min_blocks;
};

template <typename C, typename Kernel>
MmaChoice choice(Kernel kernel, int cols = 0, int min_blocks = 1) {
  return {reinterpret_cast<const void*>(kernel), C::BM, cols, C::NT, C::BYTES, min_blocks};
}

template <typename C>
MmaChoice dt_choice() {
  return choice<C>(mlt_bwd_dt_mma_kernel<C>, C::BN, C::MINB);
}

template <template <bool> class C>
MmaChoice dq_choice(int N) {
  return dq_t_in_registers(N) ? choice<C<true>>(mlt_bwd_dq_mma_kernel<C<true>>)
                              : choice<C<false>>(mlt_bwd_dq_mma_kernel<C<false>>);
}

// kind 0: dq, 1: dkv, 2: dT.
MmaChoice mma_choice(int kind, int N, int F, int D) {
  const int w = width_of(F, D);
  if (kind == 0)
    return w == 0 ? dq_choice<DqNarrow>(N) : w == 1 ? dq_choice<DqMid>(N) : dq_choice<DqWide>(N);
  if (kind == 1)
    return w == 0 ? choice<DkvNarrow>(mlt_bwd_dkv_mma_kernel<DkvNarrow>)
         : w == 1 ? choice<DkvMid>(mlt_bwd_dkv_mma_kernel<DkvMid>)
                  : choice<DkvWide>(mlt_bwd_dkv_mma_kernel<DkvWide>);
  return w == 0 ? dt_choice<DtNarrow>() : w == 1 ? dt_choice<DtMid>() : dt_choice<DtWide>();
}

// The batch groups of a bf16 dT launch the mma.sync kernel takes: of the
// counts that leave no group empty (groups of ceil(B / groups) elements),
// the fewest that minimise waves x elements per group, where a wave is
// min_blocks x SMS blocks of the (key/value block, query block, head,
// group) grid and a block sums its group's elements one after another;
// at most DT_SCRATCH_CAP values of partial sums when there is more than
// one.
int dt_groups(int B, int H, int N, int F, int D) {
  const MmaChoice c = mma_choice(2, N, F, D);
  const long long blocks =
      (long long)((N + c.rows - 1) / c.rows) * ((N + c.cols - 1) / c.cols) * H;
  const long long slots = (long long)c.min_blocks * SMS;
  int best = 1;
  long long best_cost = (blocks + slots - 1) / slots * B;
  for (int groups = 2; groups <= B; ++groups) {
    if ((long long)groups * H * N * N > DT_SCRATCH_CAP) break;
    const int per = (B + groups - 1) / groups;
    if ((B + per - 1) / per != groups) continue;  // a group would be empty
    const long long cost = (blocks * groups + slots - 1) / slots * per;
    if (cost < best_cost) {
      best = groups;
      best_cost = cost;
    }
  }
  return best;
}

int launch_mma(int kind, void** args, int B, int H, int N, int F, int D, int groups,
               void* stream) {
  const MmaChoice c = mma_choice(kind, N, F, D);
  const int err = flash::prepare(c.kernel, c.bytes);
  if (err != cudaSuccess) return err;
  const int n_rows = (N + c.rows - 1) / c.rows;
  // dq, dkv: the batch fastest; dT: the batch groups fastest, then the key/value blocks
  const dim3 grid = kind == 2 ? dim3(groups * ((N + c.cols - 1) / c.cols), n_rows, H)
                              : dim3(B, n_rows, H);
  return cudaLaunchKernel(c.kernel, grid, dim3(c.threads), args, c.bytes,
                          static_cast<cudaStream_t>(stream));
}

int launch_dt_mma(const void* gn, const void* s, const void* v, const void* q, const void* k,
                  void* dt, void* scratch, int B, int H, int N, int F, int D, void* stream) {
  int groups = dt_groups(B, H, N, F, D);
  if (groups > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  void* out = groups > 1 ? scratch : dt;
  void* args[] = {&gn, &s, &v, &q, &k, &out, &B, &H, &N, &F, &D, &groups};
  int err = launch_mma(2, args, B, H, N, F, D, groups, stream);
  if (err != cudaSuccess || groups == 1) return err;
  const size_t n = (size_t)H * N * N;
  const unsigned blocks = (unsigned)std::min<size_t>((n + THREADS - 1) / THREADS, 4 * 132 * 8);
  mlt_bwd_dt_group_sum_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scratch), static_cast<float*>(dt), n, groups);
  return cudaGetLastError();
}

// The staged kernels' instantiation, tile rows and shared memory (what
// launch_dq / launch_dkv / launch_dt pick).
template <typename T, int TILE = first_tile<T>()>
MmaChoice dq_staged(int F, int D) {
  const DqLayout<T, TILE> L(F, D);
  if constexpr (TILE > MIN_TILE) {
    if (L.bytes > (size_t)MAX_SMEM) return dq_staged<T, TILE / 2>(F, D);
  }
  return {reinterpret_cast<const void*>(mlc_t_bwd_dq_kernel<T, TILE>), TILE, 0, THREADS,
          L.bytes, 1};
}

template <typename T, int TILE = first_tile<T>()>
MmaChoice dkv_staged(int F, int D) {
  const DkvLayout<T, TILE> L(F, D);
  if constexpr (TILE > MIN_TILE) {
    if (L.bytes > (size_t)MAX_SMEM) return dkv_staged<T, TILE / 2>(F, D);
  }
  return {reinterpret_cast<const void*>(mlc_t_bwd_dkv_kernel<T, TILE>), TILE, 0, THREADS,
          L.bytes, 1};
}

template <typename T>
MmaChoice staged_choice(int kind, int F, int D) {
  if (kind == 0) return dq_staged<T>(F, D);
  if (kind == 1) return dkv_staged<T>(F, D);
  return {reinterpret_cast<const void*>(mlc_t_bwd_dt_kernel<T>), first_tile<T>(), 0, THREADS,
          BatchSumLayout<T, first_tile<T>()>(F, D).bytes, 1};
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
  if (mma_takes(F, D)) {
    (void)cudaGetLastError();  // start from a clean error state
    void* args[] = {&gn, &s, &v, &k, &t, &dq, &H, &N, &F, &D};
    return launch_mma(0, args, B, H, N, F, D, 1, stream);
  }
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
  if (mma_takes(F, D)) {
    (void)cudaGetLastError();  // start from a clean error state
    void* args[] = {&gn, &s, &v, &q, &k, &t, &dk, &dv, &H, &N, &F, &D};
    return launch_mma(1, args, B, H, N, F, D, 1, stream);
  }
  return launch_dkv<bf16>(gn, s, v, q, k, t, dk, dv, B, H, N, F, D, stream);
}

int mlt_bwd_dkv_f32(const void* gn, const void* s, const void* v, const void* q,
                    const void* k, const void* t, void* dk, void* dv,
                    int B, int H, int N, int F, int D, void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dkv<float>(gn, s, v, q, k, t, dk, dv, B, H, N, F, D, stream);
}

// fp32 values of the scratch a dT launch at these dims needs: the partial
// sums [groups, H, N, N] of mlt_bwd_dt_mma_kernel's batch groups for a
// bf16 launch it takes with more than one group, else 0; -1 for empty dims.
long long mlt_bwd_dt_scratch_floats(int B, int H, int N, int F, int D, int is_bf16) {
  if (bad_dims(B, H, N, F, D)) return -1;
  if (!is_bf16 || !mma_takes(F, D)) return 0;
  const int groups = dt_groups(B, H, N, F, D);
  return groups > 1 ? (long long)groups * H * N * N : 0;
}

// The batch groups of a dT launch at these dims: dt_groups for a bf16
// launch the mma.sync kernel takes, else 1 (the staged kernel sums the
// whole batch in one block); -1 for empty dims.
int mlt_bwd_dt_groups(int B, int H, int N, int F, int D, int is_bf16) {
  if (bad_dims(B, H, N, F, D)) return -1;
  return is_bf16 && mma_takes(F, D) ? dt_groups(B, H, N, F, D) : 1;
}

// dt [H, N, N] fp32, the batch sum of dW * A; scratch holds
// mlt_bwd_dt_scratch_floats(...) fp32 values (null where that is 0). The
// bf16 launch at even F <= 272, D <= 64 runs mlt_bwd_dt_mma_kernel (into
// the scratch when it takes more than one batch group, then
// mlt_bwd_dt_group_sum_kernel into dt); a scratch it needs and lacks is
// refused (cudaErrorInvalidValue).
int mlt_bwd_dt_bf16(const void* gn, const void* s, const void* v, const void* q,
                    const void* k, void* dt, void* scratch, int B, int H, int N, int F, int D,
                    void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  if (mma_takes(F, D)) {
    (void)cudaGetLastError();  // start from a clean error state
    return launch_dt_mma(gn, s, v, q, k, dt, scratch, B, H, N, F, D, stream);
  }
  return launch_dt<bf16>(gn, s, v, q, k, dt, B, H, N, F, D, stream);
}

int mlt_bwd_dt_f32(const void* gn, const void* s, const void* v, const void* q,
                   const void* k, void* dt, void* scratch, int B, int H, int N, int F, int D,
                   void* stream) {
  (void)scratch;
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dt<float>(gn, s, v, q, k, dt, B, H, N, F, D, stream);
}

// What a bf16 (is_bf16 = 1) or fp32 launch of kind 0 (dq), 1 (dkv) or 2
// (dT) at (N, F, D) runs, in info[0..6]: rows per block (per tile for the
// staged kernels), threads, dynamic shared memory bytes, resident blocks
// per SM, registers per thread, local (spilled) bytes per thread, and 1
// for mlt_bwd_dq_mma_kernel, mlt_bwd_dkv_mma_kernel or
// mlt_bwd_dt_mma_kernel (0 for a staged kernel). Returns the CUDA error
// code (cudaErrorInvalidValue for bad arguments or a block that exceeds
// shared memory).
int mlt_bwd_launch_info(int kind, int N, int F, int D, int is_bf16, int* info) {
  if (bad_dims(1, 1, N, F, D) || kind < 0 || kind > 2) return cudaErrorInvalidValue;
  const bool mma = is_bf16 && mma_takes(F, D);
  const MmaChoice c = mma ? mma_choice(kind, N, F, D)
                          : is_bf16 ? staged_choice<bf16>(kind, F, D)
                                    : staged_choice<float>(kind, F, D);
  return fm::launch_info(c.kernel, c.rows, c.threads, c.bytes, mma, info);
}

const char* mlt_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
