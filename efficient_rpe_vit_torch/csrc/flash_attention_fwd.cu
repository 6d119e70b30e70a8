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
// at long N (B=4, H=12, N=4097: 206 GFLOP against 5 MB); under dropout the
// per-cell hash (~10 integer ops a cell) and exp come near the products.
// The [N, N] scores never leave the chip.
//
// bf16 (flash_fwd_mma_kernel, the served and trained path): FlashAttention-2's
// register-resident scheme on mma.sync.m16n8k16 tensor-core fragments (see
// flash_attention_mma.cuh). One block per (query tile, head, batch),
// 16 query rows a warp, against 64-row key/value tiles: 64 rows (4 warps)
// below N = 512, 128 rows (8 warps) from N = 512. Q is loaded once into
// registers; S = q k^T, the online softmax (expf(scale s - m) in natural
// units as the JAX kernel computes it, masks and the keep test per
// fragment element from global (i, j), each row's hash once), P' rounded
// to bf16 in registers as the A operand of P' v, and the output
// accumulator rescaled in registers (skipped once the row maxima settle)
// and written once. K and V tiles move through a two-stage ring of 16-byte
// cp.async: tile j + 1 is copied while tile j is computed, one barrier per
// tile.
//
// With the decomposed relative-position bias (flash_fwd_rel_mma_kernel, bf16
// only): the same kernel built with REL, each score plus h[i, j / kw] +
// w[i, j % kw] from the fp32 rows (Rel in flash_attention_common.cuh), read
// through the read-only cache after the scale and before the mask; the
// kernels without it compile as before. On a grid of 64-key rows
// (REL_ROWS, the global blocks) a key tile is one grid row: one h value per
// row and tile, and w's pairs of columns as 8-byte loads, the same values
// the general path (REL_SMALL) reads key by key.
//
// fp32 (flash_fwd_kernel, a parity path): one block per (64-row query tile,
// head, batch) looping over 64-row key/value tiles staged by cp.async; FMA
// products; scores and the output accumulator in shared memory, one warp
// per 8 rows for the softmax; loads do not overlap products.

#include "flash_attention_mma.cuh"

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

// ─── bf16: register-resident tiles on mma.sync ──────────────────────────

// Geometry of flash_fwd_mma_kernel: WARPS warps of 16 query rows (BM per
// block), BN key/value rows per tile, staged head dim DP, at least MINB
// resident blocks per SM asked of the register allocator.
// Shared memory (bf16 elements): Q [BM, LD], then a ring of two stages,
// each K [BN, LD] and V [BN, LD].
template <int DP, int WARPS, int BN_, int MINB>
struct FwdMma {
  static constexpr int BM = 16 * WARPS, BN = BN_, NT = 32 * WARPS, LD = DP + 8;
  static constexpr int KS = DP / 16;   // 16-wide steps over the head dim
  static constexpr int NB_S = BN / 8;  // 8-column blocks of a score row
  static constexpr int NB_O = DP / 8;  // 8-column blocks of an output row
  static constexpr int R = 2;          // rows per thread: lane / 4 and lane / 4 + 8
  static constexpr size_t RING = (size_t)BM * LD, STAGE = (size_t)2 * BN * LD;
  static constexpr size_t BYTES = (RING + 2 * STAGE) * sizeof(bf16);
};

// One block per (BM-row query tile, head, batch); warp w owns rows
// 16 w..16 w + 15. Q sits in registers as A fragments for the
// whole sweep; K and V tiles arrive through the two-stage cp.async ring,
// tile jt + 1 copied while tile jt is computed. S, P' and the output
// accumulator stay in registers; row maxima and sums reduce over the four
// threads of a quad. REL (REL_ROWS or REL_SMALL) adds the
// relative-position bias to the scores.
template <int DP, int WARPS, int BN_, int MINB, int REL>
__device__ __forceinline__ void fwd_mma_body(const bf16* __restrict__ q,
                                             const bf16* __restrict__ k,
                                             const bf16* __restrict__ v,
                                             const uint8_t* __restrict__ mask,
                                             const int* __restrict__ seed,
                                             bf16* __restrict__ out, float* __restrict__ lse,
                                             const Params& p, const Rel& rel) {
  using C = FwdMma<DP, WARPS, BN_, MINB>;
  using namespace mma;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + C::RING;  // stage s: K at ring + s STAGE, V BN LD further

  const int N = p.N, D = p.D;
  const int i0 = blockIdx.x * C::BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = i0 + warp * 16;  // the warp's first row
  const bf16* kh = k + bh * N * D;
  const bf16* vh = v + bh * N * D;
  const auto stage_kv = [&](int jt) {
    bf16* Kt = ring + (jt & 1) * C::STAGE;
    const int rows = min(C::BN, N - jt * C::BN);
    stage_rows<C::BN, C::NT>(Kt, C::LD, DP, kh + (size_t)jt * C::BN * D, rows, D);
    stage_rows<C::BN, C::NT>(Kt + C::BN * C::LD, C::LD, DP, vh + (size_t)jt * C::BN * D,
                             rows, D);
  };
  stage_rows<C::BM, C::NT>(Qs, C::LD, DP, q + (bh * N + i0) * D, min(C::BM, N - i0), D);
  stage_kv(0);
  cp_async_commit();

  // this thread's rows
  const uint32_t hb = p.has_dropout ? head_hash((uint32_t)*seed, b, h) : 0u;
  const uint8_t* mrow[C::R];
  uint32_t rh[C::R];
  int row[C::R];
#pragma unroll
  for (int r = 0; r < C::R; ++r) {
    row[r] = row0 + lane / 4 + 8 * r;
    mrow[r] = row[r] < N ? mask_row(mask, p, b, h, row[r]) : nullptr;
    rh[r] = p.has_dropout ? row_hash(hb, row[r]) : 0u;
  }
  // this thread's rows of the bias (rows past N read row N - 1)
  const float* hrow[C::R];
  const float* wrow[C::R];
  if constexpr (REL != 0) {
#pragma unroll
    for (int r = 0; r < C::R; ++r) {
      const size_t at = bh * N + min(row[r], N - 1);
      hrow[r] = rel.h + at * rel.kh;
      wrow[r] = rel.w + at * rel.kw;
    }
  }
  // the JAX kernel's arithmetic: expf(scale s - m) in natural units
  float o[C::NB_O][4];
  zero_acc(o);
  float m[C::R], l[C::R];  // l: this thread's share of the row sums
#pragma unroll
  for (int r = 0; r < C::R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  uint32_t qf[C::KS][4];

  const int n_kv = (N + C::BN - 1) / C::BN;
  for (int jt = 0; jt < n_kv; ++jt) {
    cp_async_wait<0>();
    __syncthreads();  // tile jt staged by every thread; tile jt - 1's stage is free
    if (jt + 1 < n_kv) {
      stage_kv(jt + 1);
      cp_async_commit();
    }
    if (jt == 0) load_a_rows(qf, Qs, C::LD, row0 - i0);
    const bf16* Kt = ring + (jt & 1) * C::STAGE;
    const bf16* Vt = Kt + C::BN * C::LD;
    const int j0 = jt * C::BN;

    float s[C::NB_S][4];
    zero_acc(s);
    mma_a_rows(s, qf, Kt, C::LD);  // q k^T
    float mx[C::R];
#pragma unroll
    for (int r = 0; r < C::R; ++r) mx[r] = m[r];
    const bool masked = mask != nullptr || j0 + C::BN > N;
    float hv[C::R];  // REL_ROWS: the tile's grid row's h
    if constexpr (REL == REL_ROWS) {
      static_assert(C::BN == 64, "REL_ROWS: a key tile is one grid row of 64");
#pragma unroll
      for (int r = 0; r < C::R; ++r) hv[r] = __ldg(hrow[r] + jt);
    }
#pragma unroll
    for (int nb = 0; nb < C::NB_S; ++nb) {
      float2 wv[C::R];  // REL_ROWS: w at this thread's two columns of the block
      if constexpr (REL == REL_ROWS) {
#pragma unroll
        for (int r = 0; r < C::R; ++r)
          wv[r] = __ldg(reinterpret_cast<const float2*>(wrow[r] + nb * 8 + 2 * (lane % 4)));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        // rounded where the JAX kernel rounds: scale s, then scale s - m
        float x = __fmul_rn(s[nb][e], p.scale);
        if constexpr (REL == REL_ROWS) {
          x = __fadd_rn(__fadd_rn(x, hv[r]), (e & 1) ? wv[r].y : wv[r].x);
        } else if constexpr (REL == REL_SMALL) {
          int kr, kc;
          key_cell(rel, min(j0 + nb * 8 + 2 * (lane % 4) + (e & 1), N - 1), kr, kc);
          x = __fadd_rn(__fadd_rn(x, __ldg(hrow[r] + kr)), __ldg(wrow[r] + kc));
        }
        if (masked) {
          const int j = j0 + nb * 8 + 2 * (lane % 4) + (e & 1);
          if (j >= N || (mrow[r] != nullptr && mrow[r][j] == 0)) x = MASK_VALUE;
        }
        s[nb][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[C::R];
#pragma unroll
    for (int r = 0; r < C::R; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(__fsub_rn(m[r], mx[r]));
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // once the row maxima settle, alpha is exactly 1: skip the rescale
    bool moved = false;
#pragma unroll
    for (int r = 0; r < C::R; ++r) moved |= alpha[r] != 1.f;
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int nb = 0; nb < C::NB_O; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nb][e] *= alpha[e / 2];
    }
#pragma unroll
    for (int nb = 0; nb < C::NB_S; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float x = expf(__fsub_rn(s[nb][e], m[r]));
        l[r] += x;
        // the normaliser sums undropped p; only the value side drops
        if (p.has_dropout) {
          const int j = j0 + nb * 8 + 2 * (lane % 4) + (e & 1);
          x = keep_cell(rh[r], j, p.threshold) ? x * p.inv_keep : 0.f;
        }
        s[nb][e] = x;
      }
    uint32_t pf[C::NB_S / 2][4];
    to_a(pf, s);                   // P' rounded to bf16
    mma_a_cols(o, pf, Vt, C::LD);  // acc += P' v
  }

  float inv[C::R];
#pragma unroll
  for (int r = 0; r < C::R; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
  }
  store_rows(out + bh * N * D, D, N, row0, o, inv);
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < C::R; ++r) {
      if (row[r] >= N) continue;
      // m is MASK_VALUE exactly when every cell of the row is masked
      lse[bh * N + row[r]] = l[r] == 0.f || m[r] == MASK_VALUE
                                 ? MASK_VALUE
                                 : m[r] + logf(fmaxf(l[r], 1e-37f));
    }
  }
}

template <int DP, int WARPS, int BN_, int MINB>
__global__ void __launch_bounds__(32 * WARPS, MINB)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                     const int* __restrict__ seed, bf16* __restrict__ out,
                     float* __restrict__ lse, const Params p) {
  fwd_mma_body<DP, WARPS, BN_, MINB, 0>(q, k, v, mask, seed, out, lse, p, Rel{});
}

template <int DP, int WARPS, int BN_, int MINB, int REL>
__global__ void __launch_bounds__(32 * WARPS, MINB)
flash_fwd_rel_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                         const int* __restrict__ seed, bf16* __restrict__ out,
                         float* __restrict__ lse, const Params p, const Rel rel) {
  fwd_mma_body<DP, WARPS, BN_, MINB, REL>(q, k, v, mask, seed, out, lse, p, rel);
}

// The bf16 kernel instantiation for (N, D) as a function pointer, its
// geometry and its launcher: what launches and what flash_fwd_launch_info
// reports.
struct FwdChoice {
  const void* kernel;
  int rows, threads;
  size_t bytes;
  int (*launch)(const void*, const void*, const void*, const void*, const void*, void*, void*,
                const Params&, const Rel&, void*);
};

template <int DP, int WARPS, int BN, int MINB, int REL>
int launch_fwd_mma(const void* q, const void* k, const void* v, const void* mask,
                   const void* seed, void* out, void* lse, const Params& p, const Rel& rel,
                   void* stream) {
  using C = FwdMma<DP, WARPS, BN, MINB>;
  const dim3 grid((p.N + C::BM - 1) / C::BM, p.H, p.B);
  const auto qp = static_cast<const bf16*>(q), kp = static_cast<const bf16*>(k),
             vp = static_cast<const bf16*>(v);
  const auto mp = static_cast<const uint8_t*>(mask);
  const auto sp = static_cast<const int*>(seed);
  const auto op = static_cast<bf16*>(out);
  const auto lp = static_cast<float*>(lse);
  const auto st = static_cast<cudaStream_t>(stream);
  if constexpr (REL != 0) {
    const auto kernel = flash_fwd_rel_mma_kernel<DP, WARPS, BN, MINB, REL>;
    const int err = prepare(kernel, C::BYTES);
    if (err != cudaSuccess) return err;
    kernel<<<grid, C::NT, C::BYTES, st>>>(qp, kp, vp, mp, sp, op, lp, p, rel);
  } else {
    const auto kernel = flash_fwd_mma_kernel<DP, WARPS, BN, MINB>;
    const int err = prepare(kernel, C::BYTES);
    if (err != cudaSuccess) return err;
    kernel<<<grid, C::NT, C::BYTES, st>>>(qp, kp, vp, mp, sp, op, lp, p);
  }
  return cudaGetLastError();
}

template <int DP, int WARPS, int BN, int MINB, int REL = 0>
FwdChoice fwd_choice() {
  using C = FwdMma<DP, WARPS, BN, MINB>;
  const void* kernel;
  if constexpr (REL != 0) {
    kernel = reinterpret_cast<const void*>(flash_fwd_rel_mma_kernel<DP, WARPS, BN, MINB, REL>);
  } else {
    kernel = reinterpret_cast<const void*>(flash_fwd_mma_kernel<DP, WARPS, BN, MINB>);
  }
  return {kernel, C::BM, C::NT, C::BYTES, launch_fwd_mma<DP, WARPS, BN, MINB, REL>};
}

// Tiles by sequence length, chosen by timing on an H100. Key/value tiles
// stay 64 rows, as in the first version: the running row maxima, and with
// them the values P' is rounded at, do not move. From N = 512, 128-row
// blocks of 8 warps (half the blocks' K and V traffic of 64-row blocks),
// registers capped for 2 resident blocks per SM; below, 64-row blocks of 4
// warps (N = 197 wastes less of a ragged tile), capped for 4. DP = 128
// caps less, so that its wider accumulators stay in registers; DP = 80 and
// the kernels with the bias (which hold the bias rows' addresses and the
// keys' grid cells besides) cap at one 8-warp block per SM from N = 512.
template <int DP>
FwdChoice fwd_choice_n(int N) {
  if constexpr (DP <= 64) {
    if (N >= 512) return fwd_choice<DP, 8, 64, 2>();
    return fwd_choice<DP, 4, 64, 4>();
  } else if constexpr (DP == 80) {
    if (N >= 512) return fwd_choice<DP, 8, 64, 1>();
    return fwd_choice<DP, 4, 64, 2>();
  } else {
    if (N >= 512) return fwd_choice<DP, 4, 64, 1>();
    return fwd_choice<DP, 4, 64, 2>();
  }
}

// From N = 512 only REL_ROWS grids occur (REL_SMALL holds at most 256 keys).
template <int DP>
FwdChoice fwd_rel_choice_n(int N, int mode) {
  if (N >= 512) return fwd_choice<DP, 8, 64, 1, REL_ROWS>();
  if (mode == REL_ROWS) return fwd_choice<DP, 4, 64, 2, REL_ROWS>();
  return fwd_choice<DP, 4, 64, 2, REL_SMALL>();
}

FwdChoice fwd_choice_bf16(int N, int D) {
  switch (mma::staged_dim(D)) {
    case 16: return fwd_choice_n<16>(N);
    case 32: return fwd_choice_n<32>(N);
    case 64: return fwd_choice_n<64>(N);
    case 80: return fwd_choice_n<80>(N);
    default: return fwd_choice_n<128>(N);
  }
}

// The bias kernels are built for head dims staged to 80 (SAM ViT-H's);
// false elsewhere.
bool fwd_rel_takes(int D) { return D <= MAX_D && mma::staged_dim(D) == 80; }

FwdChoice fwd_rel_choice_bf16(int N, int mode) { return fwd_rel_choice_n<80>(N, mode); }

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
  if (bad_params(p) || (has_dropout && seed == nullptr)) return cudaErrorInvalidValue;
  return fwd_choice_bf16(N, D).launch(q, k, v, mask, seed, out, lse, p, Rel{}, stream);
}

// flash_fwd_bf16 with the decomposed relative-position bias: rel_h
// [B, H, N, Kh] and rel_w [B, H, N, Kw] fp32, contiguous, with N = Kh Kw
// and the grid one that flash_rel_mode takes; head dims staged to 80.
int flash_fwd_rel_bf16(const void* q, const void* k, const void* v, const void* rel_h,
                       const void* rel_w, const void* mask, const void* seed, void* out,
                       void* lse, int B, int H, int N, int D, int Kh, int Kw, int mask_heads,
                       float scale, int has_dropout, unsigned threshold, float inv_keep,
                       void* stream) {
  const Params p{B, H, N, D, mask_heads, scale, has_dropout, threshold, inv_keep};
  if (bad_params(p) || (has_dropout && seed == nullptr) || rel_mode(N, Kh, Kw) == 0 ||
      !fwd_rel_takes(D) || rel_h == nullptr || rel_w == nullptr)
    return cudaErrorInvalidValue;
  const Rel rel{static_cast<const float*>(rel_h), static_cast<const float*>(rel_w), nullptr,
                nullptr, Kh, Kw, 1.f / static_cast<float>(Kw)};
  return fwd_rel_choice_bf16(N, rel_mode(N, Kh, Kw))
      .launch(q, k, v, mask, seed, out, lse, p, rel, stream);
}

int flash_fwd_f32(const void* q, const void* k, const void* v, const void* mask,
                  const void* seed, void* out, void* lse, int B, int H, int N, int D,
                  int mask_heads, float scale, int has_dropout, unsigned threshold,
                  float inv_keep, void* stream) {
  const Params p{B, H, N, D, mask_heads, scale, has_dropout, threshold, inv_keep};
  return launch_fwd<float>(q, k, v, mask, seed, out, lse, p, stream);
}

// What a launch at (N, D) runs, in info[0..6]: rows per block, threads,
// dynamic shared memory bytes, resident blocks per SM, registers per
// thread, local (spilled) bytes per thread, 1 for the mma.sync kernel (0:
// the staged fp32 one). Returns the CUDA error code.
int flash_fwd_launch_info(int N, int D, int is_bf16, int* info) {
  if (N <= 0 || D <= 0 || D > MAX_D) return cudaErrorInvalidValue;
  if (is_bf16) {
    const FwdChoice c = fwd_choice_bf16(N, D);
    return mma::launch_info(c.kernel, c.rows, c.threads, c.bytes, true, info);
  }
  const FwdLayout<float> L{Geometry<float>(D)};
  return mma::launch_info(reinterpret_cast<const void*>(flash_fwd_kernel<float>), TILE, THREADS,
                          L.bytes, false, info);
}

// flash_fwd_launch_info of the bias kernel at (N, D) on a Kh x Kw grid.
int flash_fwd_rel_launch_info(int N, int D, int Kh, int Kw, int* info) {
  if (N <= 0 || D <= 0 || !fwd_rel_takes(D) || rel_mode(N, Kh, Kw) == 0)
    return cudaErrorInvalidValue;
  const FwdChoice c = fwd_rel_choice_bf16(N, rel_mode(N, Kh, Kw));
  return mma::launch_info(c.kernel, c.rows, c.threads, c.bytes, true, info);
}

// 1 (REL_ROWS) or 2 (REL_SMALL) where the bias kernels take a grid of
// Kh x Kw keys at (N, D), else 0.
int flash_rel_mode(int N, int D, int Kh, int Kw) {
  return D > 0 && fwd_rel_takes(D) ? rel_mode(N, Kh, Kw) : 0;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
