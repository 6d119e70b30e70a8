// Flash softmax attention backward for Hopper.
//
// Replaces the TPU kernels of efficient_rpe_vit_tpu/ops/pallas/flash_bwd.py
// (`flash_attention_bwd`): the fused single pass `_flash_bwd_fused_kernel`
// and the two-pass split `_flash_dq_kernel` / `_flash_dkv_kernel`. From the
// forward's inputs, its lse [B, H, N] and delta = sum(g * out) [B, H, N]
// (fp32, computed by the caller), per (batch b, head h):
//
//   P   = exp(scale * q k^T - lse)      (masked cells and columns >= N: 0)
//   dP  = g v^T                          (fp32 accumulation)
//   under dropout: P' = P * keep / (1 - rate), dP <- dP * keep / (1 - rate);
//   else P' = P
//   dS  = P * (dP - delta)               (the undropped P)
//   dv  = round(P')^T g
//   dk  = scale * round(dS)^T q
//   dq  = scale * round(dS) k
//
// round() is to the input dtype (bf16 tensor-core products, fp32
// accumulation), where the Pallas bodies round; dq and dk are scaled once at
// the end. The keep-mask is the forward's counter hash of (seed, b, h, i, j).
// Query rows >= N contribute nothing (their P is 0).
//
//   flash_bwd_fused_*: one block per (head, batch) sweeps every (kv tile,
//     q tile) pair, building S and dP once per pair for all three gradients;
//     dk, dv accumulate per kv tile and dq for the whole row of the head in
//     shared memory ([N rounded up to 64, D] fp32), written once at the end.
//     It launches only where that row fits (flash_bwd_fused_fits).
//   flash_bwd_dq_*:  one block per (q tile, head, batch), looping over kv tiles.
//   flash_bwd_dkv_*: one block per (kv tile, head, batch), looping over q tiles.
//
// No float atomics: every sum runs in a fixed order, so gradients are
// bitwise the same run to run.
//
// What bounds it on an H100: bytes at N=197 (fused, B=64, H=12, D=64, bf16:
// ~137 MB of q, k, v, g, lse, delta in and dq, dk, dv out, against 12 GFLOP;
// 41 us vs 12 us), operations at long N (B=4, H=12, N=4097: the dq pass
// ~310 GFLOP, the dkv pass ~412 GFLOP). This first version is simple rather
// than fast: tiles staged by cp.async, WMMA bf16 products for bf16 inputs,
// fp32 FMA products for fp32 inputs, scores and accumulators in shared
// memory, one warp per 8 rows for the elementwise pass; loads do not overlap
// products. Double buffering, wgmma, TMA and register-resident accumulators
// are later work.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

// What each kernel keeps: kv-side tiles (k, v) and q-side tiles (q, g), the
// two fp32 score tiles (scale * q k^T, then P' in place for fp32; g v^T,
// then dS in place for fp32), bf16 probability tiles, the accumulators.
template <typename T>
struct BwdLayout {
  size_t q, g, k, v, s, dp, pe, ds, lse, delta, acc_a, acc_b, dq_row, bytes;
  // kind 0: dq pass (acc_a = dq tile); 1: dkv pass (acc_a = dk, acc_b = dv);
  // 2: fused (acc_a = dk, acc_b = dv, dq_row = [n_pad, lda] for the head)
  __host__ __device__ BwdLayout(const Geometry<T>& g_, int kind, int N) {
    Arena a;
    q = a.take<T>(TILE * g_.ld);
    g = a.take<T>(TILE * g_.ld);
    k = a.take<T>(TILE * g_.ld);
    v = a.take<T>(TILE * g_.ld);
    s = a.take<float>(TILE * g_.lds);
    dp = a.take<float>(TILE * g_.lds);
    pe = is_bf16<T>() && kind != 0 ? a.take<T>(TILE * g_.ldw) : s;
    ds = is_bf16<T>() ? a.take<T>(TILE * g_.ldw) : dp;
    lse = a.take<float>(TILE);
    delta = a.take<float>(TILE);
    acc_a = a.take<float>(TILE * g_.lda);
    acc_b = kind != 0 ? a.take<float>(TILE * g_.lda) : acc_a;
    dq_row = kind == 2 ? a.take<float>((size_t)round_up(N, TILE) * g_.lda) : acc_a;
    bytes = a.top;
  }
};

struct Operands {
  const void *q, *k, *v, *g, *lse, *delta, *mask, *seed;
  void *dq, *dk, *dv;
};

template <typename T>
struct Tiles {
  T *Qs, *Gs, *Ks, *Vs, *Pe, *dS;
  float *Ss, *dPs, *lse_s, *delta_s, *acc_a, *acc_b, *dq_row;
  __device__ Tiles(unsigned char* smem, const BwdLayout<T>& L)
      : Qs(reinterpret_cast<T*>(smem + L.q)), Gs(reinterpret_cast<T*>(smem + L.g)),
        Ks(reinterpret_cast<T*>(smem + L.k)), Vs(reinterpret_cast<T*>(smem + L.v)),
        Pe(reinterpret_cast<T*>(smem + L.pe)), dS(reinterpret_cast<T*>(smem + L.ds)),
        Ss(reinterpret_cast<float*>(smem + L.s)), dPs(reinterpret_cast<float*>(smem + L.dp)),
        lse_s(reinterpret_cast<float*>(smem + L.lse)),
        delta_s(reinterpret_cast<float*>(smem + L.delta)),
        acc_a(reinterpret_cast<float*>(smem + L.acc_a)),
        acc_b(reinterpret_cast<float*>(smem + L.acc_b)),
        dq_row(reinterpret_cast<float*>(smem + L.dq_row)) {}
};

// Stage the q-side tile i0 (q, g, lse, delta) of head bh; the caller waits.
template <typename T>
__device__ __forceinline__ void load_q_side(const Tiles<T>& t, const Geometry<T>& g,
                                            const T* q, const T* gr, const float* lse,
                                            const float* delta, size_t bh, int i0, int N,
                                            int D) {
  const int rows = min(TILE, N - i0);
  load_tile<T>(t.Qs, g.ld, g.dp, q + (bh * N + i0) * D, rows, D);
  load_tile<T>(t.Gs, g.ld, g.dp, gr + (bh * N + i0) * D, rows, D);
  for (int a = threadIdx.x; a < TILE; a += THREADS) {
    t.lse_s[a] = a < rows ? lse[bh * N + i0 + a] : 0.f;
    t.delta_s[a] = a < rows ? delta[bh * N + i0 + a] : 0.f;
  }
}

// Stage the kv-side tile j0 (k, v) of head bh; the caller waits.
template <typename T>
__device__ __forceinline__ void load_kv_side(const Tiles<T>& t, const Geometry<T>& g,
                                             const T* k, const T* v, size_t bh, int j0,
                                             int N, int D) {
  const int rows = min(TILE, N - j0);
  load_tile<T>(t.Ks, g.ld, g.dp, k + (bh * N + j0) * D, rows, D);
  load_tile<T>(t.Vs, g.ld, g.dp, v + (bh * N + j0) * D, rows, D);
}

// For the staged tile pair (i0, j0): S = q k^T and dP = g v^T, then per cell
// P, P' (when WANT_P) and dS, rounded to T; one warp per row.
template <typename T, bool WANT_P>
__device__ __forceinline__ void tile_pair(const Tiles<T>& t, const Geometry<T>& g,
                                          const Params& p, const uint8_t* mask,
                                          uint32_t hb, int b, int h, int i0, int j0) {
  scores<T>(t.Ss, g.lds, t.Qs, g.ld, t.Ks, g.ld, g.dp);
  scores<T>(t.dPs, g.lds, t.Gs, g.ld, t.Vs, g.ld, g.dp);
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < TILE; r += WARPS) {
    const int i = i0 + r;
    const bool row_ok = i < p.N;
    const uint8_t* mrow = row_ok ? mask_row(mask, p, b, h, i) : nullptr;
    const float lse_r = t.lse_s[r];
    const float delta_r = t.delta_s[r];
    const uint32_t rh = p.has_dropout ? row_hash(hb, i) : 0u;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = lane + 32 * c;
      const int j = j0 + col;
      float pe = 0.f, ds = 0.f;
      if (row_ok && j < p.N && (mrow == nullptr || mrow[j] != 0)) {
        const float prob = expf(t.Ss[r * g.lds + col] * p.scale - lse_r);
        float dpv = t.dPs[r * g.lds + col];
        pe = prob;
        if (p.has_dropout) {
          const bool keep = keep_cell(rh, j, p.threshold);
          pe = keep ? prob * p.inv_keep : 0.f;
          dpv = keep ? dpv * p.inv_keep : 0.f;
        }
        ds = prob * (dpv - delta_r);
      }
      if (WANT_P) t.Pe[r * g.ldw + col] = from_float<T>(pe);
      t.dS[r * g.ldw + col] = from_float<T>(ds);
    }
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void zero(float* acc, int count) {
  for (int idx = threadIdx.x; idx < count; idx += THREADS) acc[idx] = 0.f;
}

// out[r, d] = round(acc[r, d] * factor) for r < rows, d < D.
template <typename T>
__device__ __forceinline__ void store(T* out, const float* acc, int lda, int rows, int D,
                                      float factor) {
  for (int idx = threadIdx.x; idx < rows * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    out[idx] = from_float<T>(acc[r * lda + d] * factor);
  }
}

// dq for one (q tile, head, batch): loop over kv tiles.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const Operands o, const Params p) {
  const Geometry<T> g(p.D);
  const BwdLayout<T> L(g, 0, p.N);
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<T> t(smem, L);
  const int N = p.N, D = p.D;
  const int i0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + h;
  const uint8_t* mask = static_cast<const uint8_t*>(o.mask);
  const uint32_t hb =
      p.has_dropout ? head_hash((uint32_t)*static_cast<const int*>(o.seed), b, h) : 0u;

  load_q_side<T>(t, g, static_cast<const T*>(o.q), static_cast<const T*>(o.g),
                 static_cast<const float*>(o.lse), static_cast<const float*>(o.delta), bh, i0,
                 N, D);
  zero<T>(t.acc_a, TILE * g.lda);
  const int n_kv = (N + TILE - 1) / TILE;
  for (int jt = 0; jt < n_kv; ++jt) {
    const int j0 = jt * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_kv_side<T>(t, g, static_cast<const T*>(o.k), static_cast<const T*>(o.v), bh, j0, N, D);
    cp_async_wait_all();
    __syncthreads();
    tile_pair<T, false>(t, g, p, mask, hb, b, h, i0, j0);
    accumulate<T, false>(t.acc_a, g.lda, t.dS, g.ldw, t.Ks, g.ld, g.dp);  // dq += dS k
  }
  __syncthreads();
  store<T>(static_cast<T*>(o.dq) + (bh * N + i0) * D, t.acc_a, g.lda, min(TILE, N - i0), D,
           p.scale);
}

// dk, dv for one (kv tile, head, batch): loop over q tiles.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const Operands o, const Params p) {
  const Geometry<T> g(p.D);
  const BwdLayout<T> L(g, 1, p.N);
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<T> t(smem, L);
  const int N = p.N, D = p.D;
  const int j0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + h;
  const uint8_t* mask = static_cast<const uint8_t*>(o.mask);
  const uint32_t hb =
      p.has_dropout ? head_hash((uint32_t)*static_cast<const int*>(o.seed), b, h) : 0u;

  load_kv_side<T>(t, g, static_cast<const T*>(o.k), static_cast<const T*>(o.v), bh, j0, N, D);
  zero<T>(t.acc_a, TILE * g.lda);
  zero<T>(t.acc_b, TILE * g.lda);
  const int n_q = (N + TILE - 1) / TILE;
  for (int it = 0; it < n_q; ++it) {
    const int i0 = it * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_q_side<T>(t, g, static_cast<const T*>(o.q), static_cast<const T*>(o.g),
                   static_cast<const float*>(o.lse), static_cast<const float*>(o.delta), bh,
                   i0, N, D);
    cp_async_wait_all();
    __syncthreads();
    tile_pair<T, true>(t, g, p, mask, hb, b, h, i0, j0);
    accumulate<T, true>(t.acc_b, g.lda, t.Pe, g.ldw, t.Gs, g.ld, g.dp);  // dv += P'^T g
    accumulate<T, true>(t.acc_a, g.lda, t.dS, g.ldw, t.Qs, g.ld, g.dp);  // dk += dS^T q
  }
  __syncthreads();
  const int rows = min(TILE, N - j0);
  store<T>(static_cast<T*>(o.dk) + (bh * N + j0) * D, t.acc_a, g.lda, rows, D, p.scale);
  store<T>(static_cast<T*>(o.dv) + (bh * N + j0) * D, t.acc_b, g.lda, rows, D, 1.f);
}

// dq, dk, dv for one (head, batch): kv tiles outer, q tiles inner.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_fused_kernel(const Operands o, const Params p) {
  const Geometry<T> g(p.D);
  const BwdLayout<T> L(g, 2, p.N);
  extern __shared__ __align__(128) unsigned char smem[];
  const Tiles<T> t(smem, L);
  const int N = p.N, D = p.D;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t bh = (size_t)b * p.H + h;
  const uint8_t* mask = static_cast<const uint8_t*>(o.mask);
  const uint32_t hb =
      p.has_dropout ? head_hash((uint32_t)*static_cast<const int*>(o.seed), b, h) : 0u;
  const int n_t = (N + TILE - 1) / TILE;

  zero<T>(t.dq_row, n_t * TILE * g.lda);
  for (int jt = 0; jt < n_t; ++jt) {
    const int j0 = jt * TILE;
    __syncthreads();  // the previous kv tile's readers and writers are done
    load_kv_side<T>(t, g, static_cast<const T*>(o.k), static_cast<const T*>(o.v), bh, j0, N, D);
    zero<T>(t.acc_a, TILE * g.lda);
    zero<T>(t.acc_b, TILE * g.lda);
    for (int it = 0; it < n_t; ++it) {
      const int i0 = it * TILE;
      __syncthreads();  // the previous q tile's readers are done
      load_q_side<T>(t, g, static_cast<const T*>(o.q), static_cast<const T*>(o.g),
                     static_cast<const float*>(o.lse), static_cast<const float*>(o.delta), bh,
                     i0, N, D);
      cp_async_wait_all();
      __syncthreads();
      tile_pair<T, true>(t, g, p, mask, hb, b, h, i0, j0);
      // three products into three disjoint accumulators
      accumulate<T, true>(t.acc_b, g.lda, t.Pe, g.ldw, t.Gs, g.ld, g.dp);   // dv += P'^T g
      accumulate<T, true>(t.acc_a, g.lda, t.dS, g.ldw, t.Qs, g.ld, g.dp);   // dk += dS^T q
      accumulate<T, false>(t.dq_row + (size_t)i0 * g.lda, g.lda, t.dS, g.ldw, t.Ks, g.ld,
                           g.dp);                                            // dq += dS k
    }
    __syncthreads();
    const int rows = min(TILE, N - j0);
    store<T>(static_cast<T*>(o.dk) + (bh * N + j0) * D, t.acc_a, g.lda, rows, D, p.scale);
    store<T>(static_cast<T*>(o.dv) + (bh * N + j0) * D, t.acc_b, g.lda, rows, D, 1.f);
  }
  __syncthreads();
  store<T>(static_cast<T*>(o.dq) + bh * N * D, t.dq_row, g.lda, N, D, p.scale);
}

template <typename T>
size_t fused_bytes(int N, int D) {
  return BwdLayout<T>(Geometry<T>(D), 2, N).bytes;
}

// kind 0: dq pass, 1: dkv pass, 2: fused.
template <typename T>
int launch(int kind, const Operands& o, const Params& p, void* stream) {
  if (bad_params(p) || (p.has_dropout && o.seed == nullptr)) return cudaErrorInvalidValue;
  const BwdLayout<T> L(Geometry<T>(p.D), kind, p.N);
  const int n_t = (p.N + TILE - 1) / TILE;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (kind == 0) {
    if ((err = prepare(flash_bwd_dq_kernel<T>, L.bytes)) != cudaSuccess) return err;
    flash_bwd_dq_kernel<T><<<dim3(n_t, p.H, p.B), THREADS, L.bytes, s>>>(o, p);
  } else if (kind == 1) {
    if ((err = prepare(flash_bwd_dkv_kernel<T>, L.bytes)) != cudaSuccess) return err;
    flash_bwd_dkv_kernel<T><<<dim3(n_t, p.H, p.B), THREADS, L.bytes, s>>>(o, p);
  } else {
    if ((err = prepare(flash_bwd_fused_kernel<T>, L.bytes)) != cudaSuccess) return err;
    flash_bwd_fused_kernel<T><<<dim3(p.H, p.B), THREADS, L.bytes, s>>>(o, p);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_kind(int kind, const void* q, const void* k, const void* v, const void* g,
                const void* lse, const void* delta, const void* mask, const void* seed,
                void* dq, void* dk, void* dv, int B, int H, int N, int D, int mask_heads,
                float scale, int has_dropout, unsigned threshold, float inv_keep,
                void* stream) {
  const Operands o{q, k, v, g, lse, delta, mask, seed, dq, dk, dv};
  const Params p{B, H, N, D, mask_heads, scale, has_dropout, threshold, inv_keep};
  return launch<T>(kind, o, p, stream);
}

}  // namespace

extern "C" {

// 1 when the fused kernel's shared memory (its dq row of round_up(N, 64) x D
// fp32 plus its tiles) fits one block on this card, else 0.
int flash_bwd_fused_fits(int N, int D, int is_bf16) {
  if (N <= 0 || D <= 0 || D > MAX_D) return 0;
  const size_t bytes = is_bf16 ? fused_bytes<bf16>(N, D) : fused_bytes<float>(N, D);
  return bytes <= (size_t)MAX_SMEM;
}

// Every launcher takes q, k, v, g [B, H, N, D] (bf16 or fp32, D <= 128),
// lse and delta [B, H, N] fp32, all contiguous; mask [B, mask_heads, N, N] of
// bytes (nonzero keeps) or null; seed one int32 in device memory, read when
// has_dropout; and writes the gradients named in its name, each of q's shape
// and dtype. Runs on `stream`, does not synchronise, allocates nothing;
// returns the CUDA error code (0 = launched, cudaErrorInvalidValue for
// arguments or shared memory it refuses).
#define FLASH_BWD_LAUNCHER(NAME, T, KIND, DQ, DK, DV)                                        \
  int NAME(const void* q, const void* k, const void* v, const void* g, const void* lse,     \
           const void* delta, const void* mask, const void* seed, void* dq, void* dk,       \
           void* dv, int B, int H, int N, int D, int mask_heads, float scale,               \
           int has_dropout, unsigned threshold, float inv_keep, void* stream) {             \
    if ((DQ && dq == nullptr) || (DK && dk == nullptr) || (DV && dv == nullptr))           \
      return cudaErrorInvalidValue;                                                          \
    return launch_kind<T>(KIND, q, k, v, g, lse, delta, mask, seed, dq, dk, dv, B, H, N, D, \
                          mask_heads, scale, has_dropout, threshold, inv_keep, stream);      \
  }

FLASH_BWD_LAUNCHER(flash_bwd_dq_bf16, bf16, 0, true, false, false)
FLASH_BWD_LAUNCHER(flash_bwd_dq_f32, float, 0, true, false, false)
FLASH_BWD_LAUNCHER(flash_bwd_dkv_bf16, bf16, 1, false, true, true)
FLASH_BWD_LAUNCHER(flash_bwd_dkv_f32, float, 1, false, true, true)
FLASH_BWD_LAUNCHER(flash_bwd_fused_bf16, bf16, 2, true, true, true)
FLASH_BWD_LAUNCHER(flash_bwd_fused_f32, float, 2, true, true, true)

#undef FLASH_BWD_LAUNCHER

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
