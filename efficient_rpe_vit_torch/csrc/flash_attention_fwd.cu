// Flash softmax attention forward for Hopper.
//
// Replaces the TPU kernel efficient_rpe_vit_tpu/ops/pallas/attention_kernels.py
// `_flash_kernel` (launched by `_flash_fwd_impl`, public
// `flash_softmax_attention`). Per (batch b, head h), with q, k, v [N, D]:
//
//   S   = scale * q k^T                      (fp32 accumulation)
//   S[i, j] = MASK_VALUE where j >= N or mask[b, h|0, i, j] == 0
//   online over 64-column tiles: m = running row max, l = running sum of
//   p = exp(S - m) (undropped), acc = acc * exp(m_old - m) + round(p') v
//   with p' = p * keep / (1 - rate) under dropout, else p'
//   out = acc / l (l == 0 -> acc), lse = m + log(l) (l == 0 -> MASK_VALUE)
//
// round() is to v's dtype (bf16 tensor-core products, fp32 accumulation),
// where the Pallas body rounds. The dropout keep-mask is the counter hash of
// (seed, b, h, i, j) in flash_attention_common.cuh, read from a device seed.
//
// What bounds it on an H100: bytes at N=197 (B=32, H=12, D=64, bf16: 39 MB
// of q, k, v, out and lse against 2.4 GFLOP, 11.7 us vs 2.4 us), operations
// at long N (B=4, H=12, N=4097: 206 GFLOP against 5 MB). The [N, N] scores
// stay in shared memory. This first version is simple rather than fast: one
// block per (64-row query tile, head, batch) looping over 64-row key/value
// tiles staged by cp.async; WMMA bf16 products for bf16 inputs, fp32 FMA
// products for fp32 inputs; scores and the output accumulator round-trip
// through shared memory, one warp per 8 rows for the softmax. Loads do not
// overlap products: double buffering, wgmma, TMA and register-resident
// accumulators are later work.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <typename T>
struct FwdLayout {
  size_t q, k, v, s, p, acc, m, l, bytes;
  __host__ __device__ explicit FwdLayout(const Geometry<T>& g) {
    Arena a;
    q = a.take<T>(TILE * g.ld);
    k = a.take<T>(TILE * g.ld);
    v = a.take<T>(TILE * g.ld);
    s = a.take<float>(TILE * g.lds);
    p = is_bf16<T>() ? a.take<T>(TILE * g.ldw) : s;  // fp32: p overwrites s
    acc = a.take<float>(TILE * g.lda);
    m = a.take<float>(TILE);
    l = a.take<float>(TILE);
    bytes = a.top;
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const uint8_t* __restrict__ mask, const int* __restrict__ seed,
                 T* __restrict__ out, float* __restrict__ lse, const Params p) {
  static_assert(TILE == 64, "the softmax row pass gives each lane two columns");
  const Geometry<T> g(p.D);
  const FwdLayout<T> L(g);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  T* Ps = reinterpret_cast<T*>(smem + L.p);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);

  const int N = p.N, D = p.D;
  const int i0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + h;
  const int rows_q = min(TILE, N - i0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t hb = p.has_dropout ? head_hash((uint32_t)*seed, b, h) : 0u;

  load_tile<T>(Qs, g.ld, g.dp, q + (bh * N + i0) * D, rows_q, D);
  for (int idx = threadIdx.x; idx < TILE * g.lda; idx += THREADS) acc[idx] = 0.f;
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int n_kv = (N + TILE - 1) / TILE;
  for (int jt = 0; jt < n_kv; ++jt) {
    const int j0 = jt * TILE;
    const int rows_kv = min(TILE, N - j0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T>(Ks, g.ld, g.dp, k + (bh * N + j0) * D, rows_kv, D);
    load_tile<T>(Vs, g.ld, g.dp, v + (bh * N + j0) * D, rows_kv, D);
    cp_async_wait_all();
    __syncthreads();
    scores<T>(Ss, g.lds, Qs, g.ld, Ks, g.ld, g.dp);  // q k^T
    __syncthreads();
    // online softmax, one warp per row, two columns per lane
    for (int r = warp; r < TILE; r += WARPS) {
      const int i = i0 + r;
      const uint8_t* mrow = i < N ? mask_row(mask, p, b, h, i) : nullptr;
      float s[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        const int j = j0 + col;
        float x = Ss[r * g.lds + col] * p.scale;
        if (j >= N || (mrow != nullptr && mrow[j] == 0)) x = MASK_VALUE;
        s[c] = x;
      }
      const float m_prev = m_s[r];
      const float m_next = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
      const float alpha = expf(m_prev - m_next);
      const float e0 = expf(s[0] - m_next);
      const float e1 = expf(s[1] - m_next);
      const float l_next = alpha * l_s[r] + warp_sum(e0 + e1);
      const uint32_t rh = p.has_dropout ? row_hash(hb, i) : 0u;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        float e = c == 0 ? e0 : e1;
        // the normaliser sums undropped p; only the value side drops
        if (p.has_dropout) e = keep_cell(rh, j0 + col, p.threshold) ? e * p.inv_keep : 0.f;
        Ps[r * g.ldw + col] = from_float<T>(e);
      }
      for (int d = lane; d < g.dp; d += 32) acc[r * g.lda + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_next;
        l_s[r] = l_next;
      }
    }
    __syncthreads();
    accumulate<T, false>(acc, g.lda, Ps, g.ldw, Vs, g.ld, g.dp);  // acc += p v
  }
  __syncthreads();
  T* o = out + (bh * N + i0) * D;
  for (int idx = threadIdx.x; idx < rows_q * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    const float l = l_s[r];
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
    o[idx] = from_float<T>(acc[r * g.lda + d] * l_inv);
  }
  for (int r = threadIdx.x; r < rows_q; r += THREADS) {
    const float l = l_s[r];
    lse[bh * N + i0 + r] = l == 0.f ? MASK_VALUE : m_s[r] + logf(fmaxf(l, 1e-37f));
  }
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask,
               const void* seed, void* out, void* lse, const Params& p, void* stream) {
  if (bad_params(p) || (p.has_dropout && seed == nullptr)) return cudaErrorInvalidValue;
  const FwdLayout<T> L{Geometry<T>(p.D)};
  const int err = prepare(flash_fwd_kernel<T>, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + TILE - 1) / TILE, p.H, p.B);
  flash_fwd_kernel<T><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(seed),
      static_cast<T*>(out), static_cast<float*>(lse), p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out [B, H, N, D] (bf16 or fp32, D <= 128) and lse [B, H, N] fp32,
// contiguous; mask [B, mask_heads, N, N] of bytes (nonzero keeps) or null;
// seed one int32 in device memory, read when has_dropout. Runs on `stream`,
// does not synchronise, allocates nothing; returns the CUDA error code
// (0 = launched, cudaErrorInvalidValue for arguments it refuses).
int flash_fwd_bf16(const void* q, const void* k, const void* v, const void* mask,
                   const void* seed, void* out, void* lse, int B, int H, int N, int D,
                   int mask_heads, float scale, int has_dropout, unsigned threshold,
                   float inv_keep, void* stream) {
  const Params p{B, H, N, D, mask_heads, scale, has_dropout, threshold, inv_keep};
  return launch_fwd<bf16>(q, k, v, mask, seed, out, lse, p, stream);
}

int flash_fwd_f32(const void* q, const void* k, const void* v, const void* mask,
                  const void* seed, void* out, void* lse, int B, int H, int N, int D,
                  int mask_heads, float scale, int has_dropout, unsigned threshold,
                  float inv_keep, void* stream) {
  const Params p{B, H, N, D, mask_heads, scale, has_dropout, threshold, inv_keep};
  return launch_fwd<float>(q, k, v, mask, seed, out, lse, p, stream);
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
