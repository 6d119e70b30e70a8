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
//   flash_bwd_fused_*: one block per (head, batch) builds S and dP once per
//     (kv rows, q tile) pair for all three gradients (5 products, against
//     the split's 7). bf16 with head dims staged to 64 and N <= 208 runs
//     flash_bwd_fused_mma_kernel (below); the rest runs the staged
//     flash_bwd_fused_kernel, whose dq for the whole head sits in shared
//     memory ([N rounded up to 64, D] fp32, written once at the end). The
//     fused pass launches only where that row fits (flash_bwd_fused_fits:
//     bf16 D=64 up to N=384).
//   flash_bwd_dq_*:  one block per (q tile, head, batch), looping over kv tiles.
//   flash_bwd_dkv_*: one block per (kv tile, head, batch), looping over q tiles.
//
// No float atomics: every sum runs in a fixed order, so gradients are
// bitwise the same run to run.
//
// What bounds it on an H100: bytes at N=197 (fused, B=64, H=12, D=64, bf16:
// ~137 MB of q, k, v, g, lse, delta in and dq, dk, dv out, against 12 GFLOP;
// 41 us vs 12 us), operations at long N (B=4, H=12, N=4097: the dq pass
// ~310 GFLOP, the dkv pass ~412 GFLOP); under dropout the per-cell hash and
// exp2 come near the products.
//
// bf16 dq and dkv (flash_bwd_dq_mma_kernel, flash_bwd_dkv_mma_kernel, the
// long-N path): FlashAttention-2's register-resident scheme on mma.sync
// (flash_attention_mma.cuh), without its atomic dq. Blocks of 64 rows (4
// warps, 16 rows each) against 32-row streamed tiles, registers capped for
// 3 (dkv) or 4 (dq) resident blocks per SM. dq keeps q, g (shared) and lse,
// delta (registers) resident and streams K, V tiles; dkv keeps k, v
// resident and streams q, g, lse, delta and the tile's row hashes (one
// mix32 per row, not per cell), its per-warp products transposed (S^T =
// k q^T, dP^T = v g^T). P = exp2(log2(e) (scale s - lse)) with log2(e)
// folded into the scale. Scores, P', dS and dq / dk / dv stay in registers;
// P' and dS are rounded to bf16 there as the A operands of the gradient
// products. Bounds and mask tests run only on edge tiles. Tiles move
// through a two-stage ring of 16-byte cp.async, tile t + 1 copied while
// tile t is computed.
//
// The bf16 fused pass (flash_bwd_fused_mma_kernel, the N=197 training
// path): the dkv kernel's scheme with the block holding every key/value row
// of the head, 13 warps of 16 rows, K and V resident, q, g, lse, delta and
// the row hashes streamed in 32-row tiles through the same two-stage ring,
// dk and dv in registers. dq needs no atomics: with the whole head in the
// block a tile's dq = dS k is complete there, so each warp also writes its
// rounded dS^T into a shared [32, 208] bf16 tile and 8 warps each sum one
// 16 x 16 unit of dq over the key/value rows in a fixed order, written once
// per tile. That runs a tile behind the products (two dS buffers), so one
// barrier per tile suffices. What held the first version back was one
// block per SM on ~190 KB of shared fp32 score tiles and a dq row, five
// barriers per tile pair and no overlap of copies with products; this one
// takes 106,752 bytes and keeps scores in registers. 13 warps allocate as
// 16, so registers are capped at 128 (112 bytes spill). Its time beside
// the first version's, the split's and SDPA's is in PERF.md
// (chip_smoke.py phase 3c).
//
// With the decomposed relative-position bias (flash_bwd_dq_rel_mma_kernel,
// flash_bwd_dkv_rel_mma_kernel, bf16 only; the fused pass has none): the
// dq and dkv kernels built with REL recompute P from the score plus
// h[i, j / kw] + w[i, j % kw] (Rel in flash_attention_common.cuh), and
// the dq pass also sums dS, rounded to bf16 as the products take it, into
// dh [N, kh] and dw [N, kw] per query row, without atomics: each query row
// lives in one block. REL_ROWS (kw = 64, the global blocks' 64 x 64 grid):
// a 32-key tile lies in one grid row, so its dS row sum, reduced over a
// quad, is half of dh[i, j0 / 64], written once after the second half;
// dw[i, 0..63] stays in 32 accumulator registers per thread across the
// sweep. REL_SMALL (kh, kw <= 16, the 14 x 14 windows): dh += dS E_h and
// dw += dS E_w on mma.sync, E the one-hot [keys, 16] matrices of the keys'
// grid rows and columns built in registers, four more products per 16
// keys. Both write dh and dw once, from registers, in a fixed order.
//
// The staged fused pass and the fp32 dq / dkv passes are the first, simple
// version: tiles staged by cp.async, WMMA bf16 or fp32 FMA products, scores
// and accumulators in shared memory, one warp per 8 rows for the
// elementwise pass, loads not overlapping products.

#include "flash_attention_mma.cuh"

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

// ─── bf16 dq and dkv: register-resident tiles on mma.sync ───────────────

// Geometry of flash_bwd_dq_mma_kernel: WARPS warps of 16 query rows (BM
// per block), BN key/value rows per tile, at least MINB resident blocks per
// SM asked of the register allocator. Shared memory (bf16 elements):
// Q [BM, LD], g [BM, LD], then a ring of two stages, each K [BN, LD] and
// V [BN, LD].
template <int DP, int WARPS, int BN_, int MINB>
struct DqMma {
  static constexpr int BM = 16 * WARPS, BN = BN_, NT = 32 * WARPS, LD = DP + 8;
  static constexpr int KS = DP / 16, NB_S = BN / 8, NB_O = DP / 8, R = 2;  // R: rows per thread
  static constexpr size_t RING = (size_t)2 * BM * LD, STAGE = (size_t)2 * BN * LD;
  static constexpr size_t BYTES = (RING + 2 * STAGE) * sizeof(bf16);
};

// dq for one (BM-row query tile, head, batch). Q, g (shared memory) and
// lse, delta (registers) stay resident; K and V tiles arrive through the
// two-stage cp.async ring. Per warp and tile, S = q k^T and dP = g v^T in
// registers, dS rounded to bf16 in registers as the A operand of
// dq += dS k; dq scaled once at the end. REL (REL_ROWS or REL_SMALL) adds
// the relative-position bias and writes its gradient.
template <int DP, int WARPS, int BN_, int MINB, int REL>
__device__ __forceinline__ void dq_mma_body(const Operands& o, const Params& p, const Rel& rel) {
  using C = DqMma<DP, WARPS, BN_, MINB>;
  static_assert(REL != REL_ROWS || C::BN == 32, "REL_ROWS: two key tiles per grid row of 64");
  using namespace mma;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + C::BM * C::LD;
  bf16* ring = Qs + C::RING;

  const int N = p.N, D = p.D;
  const int i0 = blockIdx.x * C::BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = i0 + warp * 16;  // the warp's first row
  const bf16* kh = static_cast<const bf16*>(o.k) + bh * N * D;
  const bf16* vh = static_cast<const bf16*>(o.v) + bh * N * D;
  const uint8_t* mask = static_cast<const uint8_t*>(o.mask);
  const auto stage_kv = [&](int jt) {
    bf16* Kt = ring + (jt & 1) * C::STAGE;
    const int rows = min(C::BN, N - jt * C::BN);
    stage_rows<C::BN, C::NT>(Kt, C::LD, DP, kh + (size_t)jt * C::BN * D, rows, D);
    stage_rows<C::BN, C::NT>(Kt + C::BN * C::LD, C::LD, DP, vh + (size_t)jt * C::BN * D,
                             rows, D);
  };
  const int rows_q = min(C::BM, N - i0);
  stage_rows<C::BM, C::NT>(Qs, C::LD, DP, static_cast<const bf16*>(o.q) + (bh * N + i0) * D,
                           rows_q, D);
  stage_rows<C::BM, C::NT>(Gs, C::LD, DP, static_cast<const bf16*>(o.g) + (bh * N + i0) * D,
                           rows_q, D);
  stage_kv(0);
  cp_async_commit();

  const uint32_t hb =
      p.has_dropout ? head_hash((uint32_t)*static_cast<const int*>(o.seed), b, h) : 0u;
  const float* lse = static_cast<const float*>(o.lse) + bh * N;
  const float* delta = static_cast<const float*>(o.delta) + bh * N;
  const float sl2 = p.scale * LOG2E;
  // this thread's rows: lane / 4 and lane / 4 + 8 of its warp's 16
  bool ok[C::R];
  float lse2[C::R], dlt[C::R];
  uint32_t rh[C::R];
  const uint8_t* mrow[C::R];
#pragma unroll
  for (int r = 0; r < C::R; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    ok[r] = row < N;
    lse2[r] = ok[r] ? lse[row] * LOG2E : 0.f;
    dlt[r] = ok[r] ? delta[row] : 0.f;
    rh[r] = p.has_dropout ? row_hash(hb, row) : 0u;
    mrow[r] = ok[r] ? mask_row(mask, p, b, h, row) : nullptr;
  }
  float dq[C::NB_O][4];
  zero_acc(dq);
  // the bias: this thread's rows of it (rows past N read row N - 1), and
  // its gradient's accumulators: REL_ROWS dw over the 64 grid columns and
  // a row sum per grid row, REL_SMALL dh and dw over 16 columns each
  constexpr int NB_DW = REL == REL_ROWS ? 8 : 2;
  const float* hrow[C::R];
  const float* wrow[C::R];
  float dwa[NB_DW][4], dha[2][4], hsum[C::R];
  if constexpr (REL != 0) {
#pragma unroll
    for (int r = 0; r < C::R; ++r) {
      const size_t at = bh * N + min(row0 + lane / 4 + 8 * r, N - 1);
      hrow[r] = rel.h + at * rel.kh;
      wrow[r] = rel.w + at * rel.kw;
      hsum[r] = 0.f;
    }
    zero_acc(dwa);
    zero_acc(dha);
  }

  const int n_kv = (N + C::BN - 1) / C::BN;
  for (int jt = 0; jt < n_kv; ++jt) {
    cp_async_wait<0>();
    __syncthreads();  // tile jt staged by every thread; tile jt - 1's stage is free
    if (jt + 1 < n_kv) {
      stage_kv(jt + 1);
      cp_async_commit();
    }
    const bf16* Kt = ring + (jt & 1) * C::STAGE;
    const bf16* Vt = Kt + C::BN * C::LD;
    const int j0 = jt * C::BN;

    uint32_t af[C::KS][4];
    float s[C::NB_S][4], dp[C::NB_S][4];
    zero_acc(s);
    zero_acc(dp);
    load_a_rows(af, Qs, C::LD, row0 - i0);
    mma_a_rows(s, af, Kt, C::LD);  // q k^T
    load_a_rows(af, Gs, C::LD, row0 - i0);
    mma_a_rows(dp, af, Vt, C::LD);  // g v^T
    // REL_ROWS: the tile's grid row and its bias value per row
    float hv[C::R];
    if constexpr (REL == REL_ROWS) {
#pragma unroll
      for (int r = 0; r < C::R; ++r) hv[r] = __ldg(hrow[r] + j0 / 64);
    }
    // dS per cell; the bounds and mask tests only on edge tiles
    const auto cells = [&](auto edge) {
#pragma unroll
      for (int nb = 0; nb < C::NB_S; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const int j = j0 + nb * 8 + 2 * (lane % 4) + (e & 1);
          float ds = 0.f;
          if (!decltype(edge)::value ||
              (ok[r] && j < N && (mrow[r] == nullptr || mrow[r][j] != 0))) {
            float arg = -lse2[r];
            if constexpr (REL == REL_ROWS) {
              const float2 wv = __ldg(reinterpret_cast<const float2*>(wrow[r] + (j & 62)));
              arg = fmaf(hv[r] + ((e & 1) ? wv.y : wv.x), LOG2E, arg);
            } else if constexpr (REL == REL_SMALL) {
              int kr, kc;
              key_cell(rel, min(j, N - 1), kr, kc);
              arg = fmaf(__ldg(hrow[r] + kr) + __ldg(wrow[r] + kc), LOG2E, arg);
            }
            const float prob = ex2(fmaf(s[nb][e], sl2, arg));
            float dpv = dp[nb][e];
            if (p.has_dropout)
              dpv = keep_cell(rh[r], j, p.threshold) ? dpv * p.inv_keep : 0.f;
            ds = prob * (dpv - dlt[r]);
          }
          s[nb][e] = ds;
        }
    };
    if (mask != nullptr || j0 + C::BN > N || row0 + 16 > N) {
      cells(std::true_type());
    } else {
      cells(std::false_type());
    }
    uint32_t dsf[C::NB_S / 2][4];
    to_a(dsf, s);                    // dS rounded to bf16
    mma_a_cols(dq, dsf, Kt, C::LD);  // dq += dS k
    if constexpr (REL == REL_ROWS) {
      // dw[i, j0 % 64 + c] += dS, this half of the grid row's dS into hsum
      const auto add = [&](auto half) {
#pragma unroll
        for (int nb = 0; nb < C::NB_S; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = round_bf16(s[nb][e]);
            dwa[decltype(half)::value * C::NB_S + nb][e] += x;
            hsum[e / 2] += x;
          }
      };
      if (jt & 1) {
        add(std::integral_constant<int, 1>());
      } else {
        add(std::integral_constant<int, 0>());
      }
      if (jt & 1) {  // the grid row j0 / 64 is complete: its dh, once
#pragma unroll
        for (int r = 0; r < C::R; ++r) {
          float x = hsum[r];
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          hsum[r] = 0.f;
          const int row = row0 + lane / 4 + 8 * r;
          if (lane % 4 == 0 && row < N) rel.dh[(bh * N + row) * rel.kh + j0 / 64] = x;
        }
      }
    } else if constexpr (REL == REL_SMALL) {
      // dh += dS E_h, dw += dS E_w: E's B fragments hold keys 2 (lane % 4)
      // + {0, 1} (first register) and + {8, 9} (second) of each 16, column
      // lane / 4 of each 8-column block
#pragma unroll
      for (int kk = 0; kk < C::NB_S / 2; ++kk) {
        int kr[4], kc[4];
        bool kv[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = j0 + kk * 16 + 2 * (lane % 4) + (t & 1) + 8 * (t >> 1);
          kv[t] = j < N;
          key_cell(rel, min(j, N - 1), kr[t], kc[t]);
        }
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const int c = nb * 8 + lane / 4;
          mma_bf16(dha[nb], dsf[kk], one_hot_pair(kv[0] && kr[0] == c, kv[1] && kr[1] == c),
                   one_hot_pair(kv[2] && kr[2] == c, kv[3] && kr[3] == c));
          mma_bf16(dwa[nb], dsf[kk], one_hot_pair(kv[0] && kc[0] == c, kv[1] && kc[1] == c),
                   one_hot_pair(kv[2] && kc[2] == c, kv[3] && kc[3] == c));
        }
      }
    }
  }
  float factor[C::R];
#pragma unroll
  for (int r = 0; r < C::R; ++r) factor[r] = p.scale;
  store_rows(static_cast<bf16*>(o.dq) + bh * N * D, D, N, row0, dq, factor);
  if constexpr (REL != 0) {
    // dh (REL_SMALL) and dw from the accumulators: rows lane / 4 (+ 8),
    // columns 2 (lane % 4) + {0, 1} of each 8-column block
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + lane / 4 + 8 * half;
      if (row >= N) continue;
      float* dw = rel.dw + (bh * N + row) * rel.kw;
      float* dh = rel.dh + (bh * N + row) * rel.kh;
#pragma unroll
      for (int nb = 0; nb < NB_DW; ++nb) {
        const int c = nb * 8 + 2 * (lane % 4);
        if (c < rel.kw) dw[c] = dwa[nb][2 * half];
        if (c + 1 < rel.kw) dw[c + 1] = dwa[nb][2 * half + 1];
        if constexpr (REL == REL_SMALL) {
          if (c < rel.kh) dh[c] = dha[nb][2 * half];
          if (c + 1 < rel.kh) dh[c + 1] = dha[nb][2 * half + 1];
        }
      }
    }
  }
}

template <int DP, int WARPS, int BN_, int MINB>
__global__ void __launch_bounds__(32 * WARPS, MINB)
flash_bwd_dq_mma_kernel(const Operands o, const Params p) {
  dq_mma_body<DP, WARPS, BN_, MINB, 0>(o, p, Rel{});
}

template <int DP, int WARPS, int BN_, int MINB, int REL>
__global__ void __launch_bounds__(32 * WARPS, MINB)
flash_bwd_dq_rel_mma_kernel(const Operands o, const Params p, const Rel rel) {
  dq_mma_body<DP, WARPS, BN_, MINB, REL>(o, p, rel);
}

// Geometry of flash_bwd_dkv_mma_kernel: WARPS warps of 16 key/value rows
// (BM per block), BN query rows per tile, at least MINB resident blocks per
// SM asked of the register allocator. Shared memory: K [BM, LD] and
// V [BM, LD] bf16, then a ring of two stages, each Q [BN, LD] and g
// [BN, LD] bf16 and lse, delta and the rows' dropout hashes [BN] (4 bytes
// each).
template <int DP, int WARPS, int BN_, int MINB>
struct DkvMma {
  static constexpr int BM = 16 * WARPS, BN = BN_, NT = 32 * WARPS, LD = DP + 8;
  static constexpr int KS = DP / 16, NB_S = BN / 8, NB_O = DP / 8, R = 2;  // R: rows per thread
  static constexpr size_t RING = (size_t)2 * BM * LD * sizeof(bf16);
  static constexpr size_t STAGE = (size_t)2 * BN * LD * sizeof(bf16) + 3 * BN * sizeof(float);
  static constexpr size_t BYTES = RING + 2 * STAGE;
  static_assert(STAGE % 16 == 0, "stages start 16-byte aligned");
};

// dk, dv for one (BM-row key/value tile, head, batch). K and V stay
// resident; query tiles (q, g, lse, delta, row hashes) arrive through the
// two-stage cp.async ring. Per warp and tile, S^T = k q^T and dP^T = v g^T
// in registers; P'^T and dS^T rounded to bf16 in registers as the A
// operands of dv += P'^T g and dk += dS^T q; dk scaled once at the end.
// REL adds the relative-position bias to the recomputed scores; on a grid
// of 64-key rows (REL_ROWS) the block's 64 keys are one grid row, so h is
// read once per query row of the tile for both of the thread's keys.
template <int DP, int WARPS, int BN_, int MINB, int REL>
__device__ __forceinline__ void dkv_mma_body(const Operands& o, const Params& p,
                                             const Rel& rel) {
  using C = DkvMma<DP, WARPS, BN_, MINB>;
  using namespace mma;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + C::BM * C::LD;

  const int N = p.N, D = p.D;
  const int j0 = blockIdx.x * C::BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * p.H + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = j0 + warp * 16;  // the warp's first key/value row
  const bf16* qh = static_cast<const bf16*>(o.q) + bh * N * D;
  const bf16* gh = static_cast<const bf16*>(o.g) + bh * N * D;
  const float* lse = static_cast<const float*>(o.lse) + bh * N;
  const float* delta = static_cast<const float*>(o.delta) + bh * N;
  const uint8_t* mask = static_cast<const uint8_t*>(o.mask);
  const uint32_t hb =
      p.has_dropout ? head_hash((uint32_t)*static_cast<const int*>(o.seed), b, h) : 0u;
  // stage s of the ring: Q, g [BN, LD], then lse, delta, row hashes [BN]
  const auto tile_q = [&](int it) {
    return reinterpret_cast<bf16*>(smem + C::RING + (it & 1) * C::STAGE);
  };
  const auto stage_q = [&](int it) {
    bf16* Qt = tile_q(it);
    float* rows_f = reinterpret_cast<float*>(Qt + 2 * C::BN * C::LD);
    uint32_t* rh = reinterpret_cast<uint32_t*>(rows_f + 2 * C::BN);
    const int i0 = it * C::BN;
    const int rows = min(C::BN, N - i0);
    stage_rows<C::BN, C::NT>(Qt, C::LD, DP, qh + (size_t)i0 * D, rows, D);
    stage_rows<C::BN, C::NT>(Qt + C::BN * C::LD, C::LD, DP, gh + (size_t)i0 * D, rows, D);
    stage_floats<C::NT>(rows_f, lse + i0, C::BN, rows);
    stage_floats<C::NT>(rows_f + C::BN, delta + i0, C::BN, rows);
    for (int a = threadIdx.x; a < C::BN; a += C::NT)
      rh[a] = p.has_dropout ? row_hash(hb, i0 + a) : 0u;  // one mix32 per row, not per cell
  };
  const int rows_kv = min(C::BM, N - j0);
  stage_rows<C::BM, C::NT>(Ks, C::LD, DP, static_cast<const bf16*>(o.k) + (bh * N + j0) * D,
                           rows_kv, D);
  stage_rows<C::BM, C::NT>(Vs, C::LD, DP, static_cast<const bf16*>(o.v) + (bh * N + j0) * D,
                           rows_kv, D);
  stage_q(0);
  cp_async_commit();

  const float sl2 = p.scale * LOG2E;
  int col[C::R];  // this thread's key/value rows: the columns of P
  bool ok[C::R];
#pragma unroll
  for (int r = 0; r < C::R; ++r) {
    col[r] = row0 + lane / 4 + 8 * r;
    ok[r] = col[r] < N;
  }
  // the bias: this thread's keys' grid cells, the head's bias rows
  int key_row[C::R], key_col[C::R];
  const float* hh = nullptr;
  const float* wh = nullptr;
  if constexpr (REL != 0) {
    static_assert(REL != REL_ROWS || C::BM == 64, "REL_ROWS: a block's keys are one grid row");
#pragma unroll
    for (int r = 0; r < C::R; ++r) key_cell(rel, min(col[r], N - 1), key_row[r], key_col[r]);
    hh = rel.h + bh * N * rel.kh;
    wh = rel.w + bh * N * rel.kw;
  }
  float dk[C::NB_O][4], dv[C::NB_O][4];
  zero_acc(dk);
  zero_acc(dv);

  const int n_q = (N + C::BN - 1) / C::BN;
  for (int it = 0; it < n_q; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it staged by every thread; tile it - 1's stage is free
    if (it + 1 < n_q) {
      stage_q(it + 1);
      cp_async_commit();
    }
    const bf16* Qt = tile_q(it);
    const bf16* Gt = Qt + C::BN * C::LD;
    const float* lse_t = reinterpret_cast<const float*>(Gt + C::BN * C::LD);
    const float* delta_t = lse_t + C::BN;
    const uint32_t* rh_t = reinterpret_cast<const uint32_t*>(delta_t + C::BN);
    const int i0 = it * C::BN;

    uint32_t af[C::KS][4];
    float s[C::NB_S][4], dp[C::NB_S][4];
    zero_acc(s);
    zero_acc(dp);
    load_a_rows(af, Ks, C::LD, row0 - j0);
    mma_a_rows(s, af, Qt, C::LD);  // k q^T
    load_a_rows(af, Vs, C::LD, row0 - j0);
    mma_a_rows(dp, af, Gt, C::LD);  // v g^T
    // P'^T and dS^T per cell; the bounds and mask tests only on edge tiles
    const auto cells = [&](auto edge) {
#pragma unroll
      for (int nb = 0; nb < C::NB_S; ++nb) {
        const int c = nb * 8 + 2 * (lane % 4);
        const float2 lse_c = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 delta_c = *reinterpret_cast<const float2*>(delta_t + c);
        const uint2 rh_c = *reinterpret_cast<const uint2*>(rh_t + c);
        const float nl2[2] = {-lse_c.x * LOG2E, -lse_c.y * LOG2E};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const int i = i0 + c + (e & 1);
          float pe = 0.f, ds = 0.f;
          if (!decltype(edge)::value ||
              (ok[r] && i < N &&
               (mask == nullptr || mask_row(mask, p, b, h, i)[col[r]] != 0))) {
            float arg = nl2[e & 1];
            if constexpr (REL == REL_ROWS) {
              const size_t ii = min(i, N - 1);
              arg = fmaf(__ldg(hh + ii * rel.kh + j0 / 64) + __ldg(wh + ii * 64 + key_col[r]),
                         LOG2E, arg);
            } else if constexpr (REL == REL_SMALL) {
              const size_t ii = min(i, N - 1);
              arg = fmaf(__ldg(hh + ii * rel.kh + key_row[r]) + __ldg(wh + ii * rel.kw + key_col[r]),
                         LOG2E, arg);
            }
            const float prob = ex2(fmaf(s[nb][e], sl2, arg));
            float dpv = dp[nb][e];
            pe = prob;
            if (p.has_dropout) {
              const bool keep = keep_cell((e & 1) ? rh_c.y : rh_c.x, col[r], p.threshold);
              pe = keep ? prob * p.inv_keep : 0.f;
              dpv = keep ? dpv * p.inv_keep : 0.f;
            }
            ds = prob * (dpv - ((e & 1) ? delta_c.y : delta_c.x));
          }
          s[nb][e] = pe;
          dp[nb][e] = ds;
        }
      }
    };
    if (mask != nullptr || i0 + C::BN > N || row0 + 16 > N) {
      cells(std::true_type());
    } else {
      cells(std::false_type());
    }
    uint32_t at[C::NB_S / 2][4];
    to_a(at, s);                    // P'^T rounded to bf16
    mma_a_cols(dv, at, Gt, C::LD);  // dv += P'^T g
    to_a(at, dp);                   // dS^T rounded to bf16
    mma_a_cols(dk, at, Qt, C::LD);  // dk += dS^T q
  }
  float dk_factor[C::R], dv_factor[C::R];
#pragma unroll
  for (int r = 0; r < C::R; ++r) {
    dk_factor[r] = p.scale;
    dv_factor[r] = 1.f;
  }
  store_rows(static_cast<bf16*>(o.dk) + bh * N * D, D, N, row0, dk, dk_factor);
  store_rows(static_cast<bf16*>(o.dv) + bh * N * D, D, N, row0, dv, dv_factor);
}

template <int DP, int WARPS, int BN_, int MINB>
__global__ void __launch_bounds__(32 * WARPS, MINB)
flash_bwd_dkv_mma_kernel(const Operands o, const Params p) {
  dkv_mma_body<DP, WARPS, BN_, MINB, 0>(o, p, Rel{});
}

template <int DP, int WARPS, int BN_, int MINB, int REL>
__global__ void __launch_bounds__(32 * WARPS, MINB)
flash_bwd_dkv_rel_mma_kernel(const Operands o, const Params p, const Rel rel) {
  dkv_mma_body<DP, WARPS, BN_, MINB, REL>(o, p, rel);
}

// Geometry of flash_bwd_fused_mma_kernel: one block per (head, batch) of
// WARPS warps, warp w owning key/value rows 16 w .. 16 w + 15 of the head
// (BM = 16 WARPS rows: the launch takes N <= BM), BN query rows per
// streamed tile. Shared memory: K [BM, LD] and V [BM, LD] bf16 resident, a
// ring of two stages as DkvMma's (Q, g [BN, LD] bf16, lse, delta, row
// hashes [BN]), and two dS tiles [BN, LDS] bf16, query rows by key/value
// columns. dq of a tile is DQ_UNITS units of 16 rows x 16 columns, one per
// warp.
template <int DP, int WARPS, int BN_>
struct FusedMma {
  static constexpr int BM = 16 * WARPS, BN = BN_, NT = 32 * WARPS, LD = DP + 8, LDS = BM + 8;
  static constexpr int KS = DP / 16, NB_S = BN / 8, NB_O = DP / 8, R = 2;  // R: rows per thread
  static constexpr int DQ_UNITS = (BN / 16) * (DP / 16);
  static constexpr size_t KV = (size_t)2 * BM * LD * sizeof(bf16);
  static constexpr size_t STAGE = (size_t)2 * BN * LD * sizeof(bf16) + 3 * BN * sizeof(float);
  static constexpr size_t DS = (size_t)BN * LDS * sizeof(bf16);
  static constexpr size_t BYTES = KV + 2 * STAGE + 2 * DS;
  static_assert(DQ_UNITS <= WARPS, "one dq unit per warp");
  static_assert(KV % 16 == 0 && STAGE % 16 == 0 && DS % 16 == 0, "regions start 16-byte aligned");
};

// dq, dk, dv for one (head, batch), N <= BM. K and V of the whole head stay
// resident; query tiles (q, g, lse, delta, row hashes) arrive through the
// two-stage cp.async ring. Per warp and tile, as flash_bwd_dkv_mma_kernel:
// S^T = k q^T and dP^T = v g^T in registers, P'^T and dS^T rounded to bf16
// there as the A operands of dv += P'^T g and dk += dS^T q, dk and dv held
// in registers across the sweep. Each warp also writes its rounded dS^T
// into the tile's shared dS [BN, BM]; since the block holds every key/value
// row, the tile's dq = dS k is then complete within the block: DQ_UNITS
// warps each sum one 16 x 16 unit over the key/value rows in a fixed order
// and write it once. That runs one tile behind (tile t's dq beside tile
// t + 1's products, after the barrier that opens tile t + 1), so one
// barrier per tile suffices. dq and dk scaled once at the end.
template <int DP, int WARPS, int BN_>
__global__ void __launch_bounds__(32 * WARPS, 1)
flash_bwd_fused_mma_kernel(const Operands o, const Params p) {
  using C = FusedMma<DP, WARPS, BN_>;
  using namespace mma;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + C::BM * C::LD;

  const int N = p.N, D = p.D;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t bh = (size_t)b * p.H + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // the warp's first key/value row
  const bool active = row0 < N;
  const bf16* qh = static_cast<const bf16*>(o.q) + bh * N * D;
  const bf16* gh = static_cast<const bf16*>(o.g) + bh * N * D;
  const float* lse = static_cast<const float*>(o.lse) + bh * N;
  const float* delta = static_cast<const float*>(o.delta) + bh * N;
  const uint8_t* mask = static_cast<const uint8_t*>(o.mask);
  const uint32_t hb =
      p.has_dropout ? head_hash((uint32_t)*static_cast<const int*>(o.seed), b, h) : 0u;
  const auto tile_q = [&](int it) {
    return reinterpret_cast<bf16*>(smem + C::KV + (it & 1) * C::STAGE);
  };
  const auto tile_ds = [&](int it) {
    return reinterpret_cast<bf16*>(smem + C::KV + 2 * C::STAGE + (it & 1) * C::DS);
  };
  const auto stage_q = [&](int it) {
    bf16* Qt = tile_q(it);
    float* rows_f = reinterpret_cast<float*>(Qt + 2 * C::BN * C::LD);
    uint32_t* rh = reinterpret_cast<uint32_t*>(rows_f + 2 * C::BN);
    const int i0 = it * C::BN;
    const int rows = min(C::BN, N - i0);
    stage_rows<C::BN, C::NT>(Qt, C::LD, DP, qh + (size_t)i0 * D, rows, D);
    stage_rows<C::BN, C::NT>(Qt + C::BN * C::LD, C::LD, DP, gh + (size_t)i0 * D, rows, D);
    stage_floats<C::NT>(rows_f, lse + i0, C::BN, rows);
    stage_floats<C::NT>(rows_f + C::BN, delta + i0, C::BN, rows);
    for (int a = threadIdx.x; a < C::BN; a += C::NT)
      rh[a] = p.has_dropout ? row_hash(hb, i0 + a) : 0u;  // one mix32 per row, not per cell
  };
  stage_rows<C::BM, C::NT>(Ks, C::LD, DP, static_cast<const bf16*>(o.k) + bh * N * D, N, D);
  stage_rows<C::BM, C::NT>(Vs, C::LD, DP, static_cast<const bf16*>(o.v) + bh * N * D, N, D);
  stage_q(0);
  cp_async_commit();

  // dq of the tile at `it`, unit `warp`: rows 16 mt.., columns 16 np.. of
  // dS [BN, N] k [N, DP], over the key/value rows in order (two chains of
  // alternate 16-row steps, added once at the end)
  const int kv_steps = (N + 15) / 16;
  bf16* dq_out = static_cast<bf16*>(o.dq) + bh * N * D;
  const auto dq_unit = [&](int it) {
    const bf16* dS = tile_ds(it);
    const int mt = warp / (DP / 16);
    const int np = warp % (DP / 16);
    float acc[2][2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c) zero_acc(acc[c]);
    for (int kk = 0; kk < kv_steps; ++kk) {
      uint32_t a[4], bf[4];
      load_a(a, dS, C::LDS, mt * 16, kk * 16);
      load_b_cols(bf, Ks, C::LD, kk * 16, np * 16);
      mma_bf16(acc[kk & 1][0], a, bf[0], bf[1]);
      mma_bf16(acc[kk & 1][1], a, bf[2], bf[3]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = it * C::BN + mt * 16 + lane / 4 + 8 * half;
      if (r >= N) continue;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int c = np * 16 + nb * 8 + 2 * (lane % 4);
        const float x0 = (acc[0][nb][2 * half] + acc[1][nb][2 * half]) * p.scale;
        const float x1 = (acc[0][nb][2 * half + 1] + acc[1][nb][2 * half + 1]) * p.scale;
        bf16* out = dq_out + (size_t)r * D + c;
        if (D % 2 == 0 && c + 1 < D) {
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (c < D) out[0] = __float2bfloat16(x0);
          if (c + 1 < D) out[1] = __float2bfloat16(x1);
        }
      }
    }
  };

  const float sl2 = p.scale * LOG2E;
  int col[C::R];  // this thread's key/value rows: the columns of P
  bool ok[C::R];
#pragma unroll
  for (int r = 0; r < C::R; ++r) {
    col[r] = row0 + lane / 4 + 8 * r;
    ok[r] = col[r] < N;
  }
  float dk[C::NB_O][4], dv[C::NB_O][4];
  zero_acc(dk);
  zero_acc(dv);

  const int n_q = (N + C::BN - 1) / C::BN;
  for (int it = 0; it < n_q; ++it) {
    cp_async_wait<0>();
    // tile it staged by every thread; tile it - 1's stage and dS written;
    // tile it - 2's dS read
    __syncthreads();
    if (it + 1 < n_q) {
      stage_q(it + 1);
      cp_async_commit();
    }
    if (it > 0 && warp < C::DQ_UNITS) dq_unit(it - 1);
    if (!active) continue;
    const bf16* Qt = tile_q(it);
    const bf16* Gt = Qt + C::BN * C::LD;
    const float* lse_t = reinterpret_cast<const float*>(Gt + C::BN * C::LD);
    const float* delta_t = lse_t + C::BN;
    const uint32_t* rh_t = reinterpret_cast<const uint32_t*>(delta_t + C::BN);
    bf16* dS = tile_ds(it);
    const int i0 = it * C::BN;

    uint32_t af[C::KS][4];
    float s[C::NB_S][4], dp[C::NB_S][4];
    zero_acc(s);
    zero_acc(dp);
    load_a_rows(af, Ks, C::LD, row0);
    mma_a_rows(s, af, Qt, C::LD);  // k q^T
    load_a_rows(af, Vs, C::LD, row0);
    mma_a_rows(dp, af, Gt, C::LD);  // v g^T
    // P'^T and dS^T per cell; the bounds and mask tests only on edge tiles
    const auto cells = [&](auto edge) {
#pragma unroll
      for (int nb = 0; nb < C::NB_S; ++nb) {
        const int c = nb * 8 + 2 * (lane % 4);
        const float2 lse_c = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 delta_c = *reinterpret_cast<const float2*>(delta_t + c);
        const uint2 rh_c = *reinterpret_cast<const uint2*>(rh_t + c);
        const float nl2[2] = {-lse_c.x * LOG2E, -lse_c.y * LOG2E};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const int i = i0 + c + (e & 1);
          float pe = 0.f, ds = 0.f;
          if (!decltype(edge)::value ||
              (ok[r] && i < N &&
               (mask == nullptr || mask_row(mask, p, b, h, i)[col[r]] != 0))) {
            const float prob = ex2(fmaf(s[nb][e], sl2, nl2[e & 1]));
            float dpv = dp[nb][e];
            pe = prob;
            if (p.has_dropout) {
              const bool keep = keep_cell((e & 1) ? rh_c.y : rh_c.x, col[r], p.threshold);
              pe = keep ? prob * p.inv_keep : 0.f;
              dpv = keep ? dpv * p.inv_keep : 0.f;
            }
            ds = prob * (dpv - ((e & 1) ? delta_c.y : delta_c.x));
          }
          s[nb][e] = pe;
          dp[nb][e] = ds;
        }
      }
    };
    if (mask != nullptr || i0 + C::BN > N || row0 + 16 > N) {
      cells(std::true_type());
    } else {
      cells(std::false_type());
    }
    uint32_t at[C::NB_S / 2][4];
    to_a(at, s);                    // P'^T rounded to bf16
    mma_a_cols(dv, at, Gt, C::LD);  // dv += P'^T g
    to_a(at, dp);                   // dS^T rounded to bf16
    mma_a_cols(dk, at, Qt, C::LD);  // dk += dS^T q
    // the same rounded dS^T, transposed into dS [query row, key/value row]
    const auto put = [&](uint32_t pair, int qr, int kv) {
      const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(&pair);
      dS[qr * C::LDS + kv] = v2.x;
      dS[(qr + 1) * C::LDS + kv] = v2.y;
    };
#pragma unroll
    for (int kk = 0; kk < C::NB_S / 2; ++kk) {
      const int qr = 16 * kk + 2 * (lane % 4);
      put(at[kk][0], qr, col[0]);
      put(at[kk][1], qr, col[1]);
      put(at[kk][2], qr + 8, col[0]);
      put(at[kk][3], qr + 8, col[1]);
    }
  }
  __syncthreads();  // the last tile's dS written
  if (warp < C::DQ_UNITS) dq_unit(n_q - 1);
  if (!active) return;
  float dk_factor[C::R], dv_factor[C::R];
#pragma unroll
  for (int r = 0; r < C::R; ++r) {
    dk_factor[r] = p.scale;
    dv_factor[r] = 1.f;
  }
  store_rows(static_cast<bf16*>(o.dk) + bh * N * D, D, N, row0, dk, dk_factor);
  store_rows(static_cast<bf16*>(o.dv) + bh * N * D, D, N, row0, dv, dv_factor);
}

// The bf16 fused instantiation: 13 warps, so one block holds the key/value
// rows of N <= 208 (the ViT-B/16 N = 197), against 32-row query tiles; one
// block per SM. 16-row query tiles free registers but double the tiles,
// and ran ~15% slower in the trial (experiments/tile_trial.py, PERF.md).
using FusedChoice = FusedMma<64, 13, 32>;

const void* fused_mma_kernel() {
  return reinterpret_cast<const void*>(flash_bwd_fused_mma_kernel<64, 13, 32>);
}

// Whether the bf16 fused pass at (N, D) runs flash_bwd_fused_mma_kernel:
// head dims staged to 64 and N within one block's key/value rows. The
// staged flash_bwd_fused_kernel runs the rest of the range fused_fits
// allows.
bool fused_mma_takes(int N, int D) {
  return mma::staged_dim(D) == 64 && N <= FusedChoice::BM;
}

// A bf16 dq or dkv instantiation as a function pointer, its geometry and
// its launcher: what launches and what flash_bwd_launch_info reports.
struct BwdChoice {
  const void* kernel;
  int rows, threads;
  size_t bytes;
  int (*launch)(const Operands&, const Params&, void*);
};

// The kernel over a grid of (rows-row tiles, heads, batch); `extra` are
// the arguments after (o, p), the bias kernels' Rel.
template <typename Kernel, typename... Extra>
int launch_grid(Kernel kernel, int rows, int threads, size_t bytes, const Operands& o,
                const Params& p, void* stream, const Extra&... extra) {
  const int err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + rows - 1) / rows, p.H, p.B);
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(o, p, extra...);
  return cudaGetLastError();
}

template <int DP, int WARPS, int BN, int MINB>
int launch_dq_mma(const Operands& o, const Params& p, void* stream) {
  using C = DqMma<DP, WARPS, BN, MINB>;
  return launch_grid(flash_bwd_dq_mma_kernel<DP, WARPS, BN, MINB>, C::BM, C::NT, C::BYTES,
                     o, p, stream);
}

template <int DP, int WARPS, int BN, int MINB>
int launch_dkv_mma(const Operands& o, const Params& p, void* stream) {
  using C = DkvMma<DP, WARPS, BN, MINB>;
  return launch_grid(flash_bwd_dkv_mma_kernel<DP, WARPS, BN, MINB>, C::BM, C::NT, C::BYTES,
                     o, p, stream);
}

template <int DP, int WARPS, int BN, int MINB>
BwdChoice dq_choice() {
  using C = DqMma<DP, WARPS, BN, MINB>;
  return {reinterpret_cast<const void*>(flash_bwd_dq_mma_kernel<DP, WARPS, BN, MINB>), C::BM,
          C::NT, C::BYTES, launch_dq_mma<DP, WARPS, BN, MINB>};
}

template <int DP, int WARPS, int BN, int MINB>
BwdChoice dkv_choice() {
  using C = DkvMma<DP, WARPS, BN, MINB>;
  return {reinterpret_cast<const void*>(flash_bwd_dkv_mma_kernel<DP, WARPS, BN, MINB>),
          C::BM, C::NT, C::BYTES, launch_dkv_mma<DP, WARPS, BN, MINB>};
}

// Tiles chosen by timing on an H100, at every N: 64-row blocks of 4 warps
// (16 rows a warp) against 32-row streamed tiles, registers capped for 4
// (dq) or 3 (dkv, which holds dk and dv) resident blocks per SM; DP = 80
// and 128 cap less, so that their wider accumulators stay in registers.
template <int DP>
BwdChoice dq_choice_n() {
  return dq_choice<DP, 4, 32, DP <= 64 ? 4 : 2>();
}

template <int DP>
BwdChoice dkv_choice_n() {
  return dkv_choice<DP, 4, 32, DP <= 64 ? 3 : DP <= 80 ? 2 : 1>();
}

template <int DP>
BwdChoice bwd_choice_dp(int kind) {
  return kind == 0 ? dq_choice_n<DP>() : dkv_choice_n<DP>();
}

// kind 0: dq, 1: dkv.
BwdChoice bwd_choice_bf16(int kind, int D) {
  switch (mma::staged_dim(D)) {
    case 16: return bwd_choice_dp<16>(kind);
    case 32: return bwd_choice_dp<32>(kind);
    case 64: return bwd_choice_dp<64>(kind);
    case 80: return bwd_choice_dp<80>(kind);
    default: return bwd_choice_dp<128>(kind);
  }
}

// The bias kernels: dq and dkv per REL mode, for head dims staged to 80,
// at the dq and dkv tiles above with registers capped for 2
// resident blocks per SM (the bias rows, the grid cells and REL_ROWS's 32
// dw accumulators besides).
struct RelChoice {
  const void* kernel;
  int rows, threads;
  size_t bytes;
  int (*launch)(const Operands&, const Params&, const Rel&, void*);
};

template <int DP, int MODE>
int launch_dq_rel(const Operands& o, const Params& p, const Rel& rel, void* stream) {
  using C = DqMma<DP, 4, 32, 2>;
  return launch_grid(flash_bwd_dq_rel_mma_kernel<DP, 4, 32, 2, MODE>, C::BM, C::NT, C::BYTES,
                     o, p, stream, rel);
}

template <int DP, int MODE>
int launch_dkv_rel(const Operands& o, const Params& p, const Rel& rel, void* stream) {
  using C = DkvMma<DP, 4, 32, 2>;
  return launch_grid(flash_bwd_dkv_rel_mma_kernel<DP, 4, 32, 2, MODE>, C::BM, C::NT, C::BYTES,
                     o, p, stream, rel);
}

template <int DP>
RelChoice rel_choice_dp(int kind, int mode) {
  using Q = DqMma<DP, 4, 32, 2>;
  using K = DkvMma<DP, 4, 32, 2>;
  if (kind == 1 && mode == REL_ROWS)
    return {reinterpret_cast<const void*>(flash_bwd_dkv_rel_mma_kernel<DP, 4, 32, 2, REL_ROWS>),
            K::BM, K::NT, K::BYTES, launch_dkv_rel<DP, REL_ROWS>};
  if (kind == 1)
    return {reinterpret_cast<const void*>(flash_bwd_dkv_rel_mma_kernel<DP, 4, 32, 2, REL_SMALL>),
            K::BM, K::NT, K::BYTES, launch_dkv_rel<DP, REL_SMALL>};
  if (mode == REL_ROWS)
    return {reinterpret_cast<const void*>(flash_bwd_dq_rel_mma_kernel<DP, 4, 32, 2, REL_ROWS>),
            Q::BM, Q::NT, Q::BYTES, launch_dq_rel<DP, REL_ROWS>};
  return {reinterpret_cast<const void*>(flash_bwd_dq_rel_mma_kernel<DP, 4, 32, 2, REL_SMALL>),
          Q::BM, Q::NT, Q::BYTES, launch_dq_rel<DP, REL_SMALL>};
}

bool rel_takes(int N, int D, int Kh, int Kw) {
  return D > 0 && D <= MAX_D && mma::staged_dim(D) == 80 && rel_mode(N, Kh, Kw) != 0;
}

// kind 0: dq, 1: dkv; where rel_takes.
RelChoice rel_choice(int kind, int N, int D, int Kh, int Kw) {
  return rel_choice_dp<80>(kind, rel_mode(N, Kh, Kw));
}

template <typename T>
size_t fused_bytes(int N, int D) {
  return BwdLayout<T>(Geometry<T>(D), 2, N).bytes;
}

// kind 0: dq pass, 1: dkv pass, 2: fused. bf16 dq and dkv run the
// mma.sync kernels, and the bf16 fused pass where fused_mma_takes; the
// other fused launches and every fp32 pass the staged kernels.
template <typename T>
int launch(int kind, const Operands& o, const Params& p, void* stream) {
  if (bad_params(p) || (p.has_dropout && o.seed == nullptr)) return cudaErrorInvalidValue;
  const BwdLayout<T> L(Geometry<T>(p.D), kind, p.N);
  if (kind == 2) {
    if constexpr (is_bf16<T>()) {
      if (fused_mma_takes(p.N, p.D)) {
        const int err = prepare(flash_bwd_fused_mma_kernel<64, 13, 32>, FusedChoice::BYTES);
        if (err != cudaSuccess) return err;
        flash_bwd_fused_mma_kernel<64, 13, 32><<<dim3(p.H, p.B), FusedChoice::NT,
                                                 FusedChoice::BYTES,
                                                 static_cast<cudaStream_t>(stream)>>>(o, p);
        return cudaGetLastError();
      }
    }
    const int err = prepare(flash_bwd_fused_kernel<T>, L.bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_fused_kernel<T><<<dim3(p.H, p.B), THREADS, L.bytes,
                                static_cast<cudaStream_t>(stream)>>>(o, p);
    return cudaGetLastError();
  }
  if constexpr (is_bf16<T>()) {
    return bwd_choice_bf16(kind, p.D).launch(o, p, stream);
  } else if (kind == 0) {
    return launch_grid(flash_bwd_dq_kernel<T>, TILE, THREADS, L.bytes, o, p, stream);
  } else {
    return launch_grid(flash_bwd_dkv_kernel<T>, TILE, THREADS, L.bytes, o, p, stream);
  }
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

// The bf16 dq and dkv passes with the decomposed relative-position bias:
// as flash_bwd_dq_bf16 / flash_bwd_dkv_bf16, plus rel_h [B, H, N, Kh] and
// rel_w [B, H, N, Kw] fp32, contiguous, N = Kh Kw on a grid that
// flash_rel_mode takes, head dims staged to 80; the dq pass also
// writes drel_h and drel_w (fp32, rel_h's and rel_w's shapes), every
// element once.
int flash_bwd_dq_rel_bf16(const void* q, const void* k, const void* v, const void* g,
                          const void* lse, const void* delta, const void* rel_h,
                          const void* rel_w, const void* mask, const void* seed, void* dq,
                          void* drel_h, void* drel_w, int B, int H, int N, int D, int Kh,
                          int Kw, int mask_heads, float scale, int has_dropout,
                          unsigned threshold, float inv_keep, void* stream) {
  const Operands o{q, k, v, g, lse, delta, mask, seed, dq, nullptr, nullptr};
  const Params p{B, H, N, D, mask_heads, scale, has_dropout, threshold, inv_keep};
  if (bad_params(p) || (has_dropout && seed == nullptr) || !rel_takes(N, D, Kh, Kw) ||
      dq == nullptr || rel_h == nullptr || rel_w == nullptr || drel_h == nullptr ||
      drel_w == nullptr)
    return cudaErrorInvalidValue;
  const Rel rel{static_cast<const float*>(rel_h), static_cast<const float*>(rel_w),
                static_cast<float*>(drel_h), static_cast<float*>(drel_w), Kh, Kw,
                1.f / static_cast<float>(Kw)};
  return rel_choice(0, N, D, Kh, Kw).launch(o, p, rel, stream);
}

int flash_bwd_dkv_rel_bf16(const void* q, const void* k, const void* v, const void* g,
                           const void* lse, const void* delta, const void* rel_h,
                           const void* rel_w, const void* mask, const void* seed, void* dk,
                           void* dv, int B, int H, int N, int D, int Kh, int Kw,
                           int mask_heads, float scale, int has_dropout, unsigned threshold,
                           float inv_keep, void* stream) {
  const Operands o{q, k, v, g, lse, delta, mask, seed, nullptr, dk, dv};
  const Params p{B, H, N, D, mask_heads, scale, has_dropout, threshold, inv_keep};
  if (bad_params(p) || (has_dropout && seed == nullptr) || !rel_takes(N, D, Kh, Kw) ||
      dk == nullptr || dv == nullptr || rel_h == nullptr || rel_w == nullptr)
    return cudaErrorInvalidValue;
  const Rel rel{static_cast<const float*>(rel_h), static_cast<const float*>(rel_w), nullptr,
                nullptr, Kh, Kw, 1.f / static_cast<float>(Kw)};
  return rel_choice(1, N, D, Kh, Kw).launch(o, p, rel, stream);
}

// flash_bwd_launch_info of the bias kernel of kind 0 (dq) or 1 (dkv) on a
// Kh x Kw grid of N keys.
int flash_bwd_rel_launch_info(int kind, int N, int D, int Kh, int Kw, int* info) {
  if ((kind != 0 && kind != 1) || !rel_takes(N, D, Kh, Kw)) return cudaErrorInvalidValue;
  const RelChoice c = rel_choice(kind, N, D, Kh, Kw);
  return mma::launch_info(c.kernel, c.rows, c.threads, c.bytes, true, info);
}

// What a launch of kind 0 (dq), 1 (dkv) or 2 (fused) at (N, D) runs, in
// info[0..6]: rows per block (the fused pass: 0, one block per head),
// threads, dynamic shared memory bytes, resident blocks per SM, registers
// per thread, local (spilled) bytes per thread, and 1 for an mma.sync
// kernel (0: a staged one). Returns the CUDA error code.
int flash_bwd_launch_info(int kind, int N, int D, int is_bf16, int* info) {
  if (N <= 0 || D <= 0 || D > MAX_D || kind < 0 || kind > 2) return cudaErrorInvalidValue;
  if (is_bf16 && kind != 2) {
    const BwdChoice c = bwd_choice_bf16(kind, D);
    return mma::launch_info(c.kernel, c.rows, c.threads, c.bytes, true, info);
  }
  if (is_bf16 && fused_mma_takes(N, D))
    return mma::launch_info(fused_mma_kernel(), 0, FusedChoice::NT, FusedChoice::BYTES, true,
                            info);
  const void* kernels[2][3] = {
      {reinterpret_cast<const void*>(flash_bwd_dq_kernel<float>),
       reinterpret_cast<const void*>(flash_bwd_dkv_kernel<float>),
       reinterpret_cast<const void*>(flash_bwd_fused_kernel<float>)},
      {nullptr, nullptr, reinterpret_cast<const void*>(flash_bwd_fused_kernel<bf16>)}};
  const size_t bytes = is_bf16 ? BwdLayout<bf16>(Geometry<bf16>(D), kind, N).bytes
                               : BwdLayout<float>(Geometry<float>(D), kind, N).bytes;
  return mma::launch_info(kernels[is_bf16 ? 1 : 0][kind], kind == 2 ? 0 : TILE, THREADS, bytes,
                          false, info);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
