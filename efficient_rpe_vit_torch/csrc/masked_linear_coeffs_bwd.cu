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
// dcoeffs: for every (head, q tile, kv tile) the dc kernels fold sum_b
// dW * A into a window of 2 * TILE - 1 values, the sums of the tile's
// diagonals, with index m = b - a + TILE - 1; the reduce kernel adds the
// windows of all tile pairs into dcoeffs[h, :], one thread per coefficient,
// in a fixed order. No float atomics: dcoeffs are bitwise the same run to
// run. The fold is linear, fold(sum_b X_b) = sum_b fold(X_b), so the bf16
// dc kernel (mlc_bwd_dc_mma_kernel, even F <= 272, D <= 64: the main path)
// folds each batch element's tiles on its own, into a per-batch scratch of
// windows that mlc_bwd_dc_batch_sum_kernel then sums over b in order; the
// staged dc kernel sums the batch first, in shared memory, then folds.
//
// What bounds it on an H100: bytes at the ViT-B/16 training shape (B=64,
// H=12, N=197, F=266, D=64, bf16): dq must move ~200 MB against ~19.7 GFLOP
// (60 us vs 20 us), dkv ~300 MB against ~39 GFLOP (89 us vs 40 us), dc
// ~200 MB against ~19.7 GFLOP. Operations at long N (B=4, N=4097): dkv
// ~1.06 TFLOP (1.08 ms), dq and dc ~0.53 TFLOP each.
//
// bf16 dkv (mlc_bwd_dkv_mma_kernel, even F <= 272, D <= 64: the main path)
// is register-resident on mma.sync (flash_attention_mma.cuh's fragments):
// 64 key/value rows per block, four warps per 16 of them, against 32-row
// query tiles streamed through a two-stage cp.async ring. The obstacle is
// the [16, 272] fp32 dk' accumulator of 16 key/value rows, 136 registers a
// thread for one warp: the four warps of a row group split its output
// columns (5 or 4 16-column blocks, 40 registers) and dv's, and split the
// score products by query columns instead (8 each, over all of F and D),
// then swap their rounded bf16 weights, which are exactly the registers of
// the next product's A fragment, through 16 bytes a lane of shared memory
// and a named barrier of the four. So nothing fp32 crosses warps, sums run
// in one order, and the kernel holds 123 registers a thread. F = 266 is
// padded to 272 inside the kernel (pad lanes zeroed as they are staged;
// the store writes the real columns). Rows of 532 bytes are 4-byte but not
// 16-byte aligned, so q' and k' move as 4-byte cp.async words, all in
// flight, a warp to a row so that a lane's addresses advance by a
// constant. The kernel is bound by issued instructions more than by the
// tensor cores, and staging q' is the largest single item of them, so the
// taller block, which stages it for 64 rows at once, wins at long N. The
// Toeplitz window of each tile pair (95 coefficients) rides in the ring
// beside q'. Times are in PERF.md (chip_smoke.py). What held the first
// version back was one block per SM on ~210 KB of shared tiles and fp32
// accumulators, two WMMA score passes through one shared score tile, two
// shared-accumulator products and six barriers per tile, loads not
// overlapped; this one takes 99,328 bytes and two barriers per tile (the
// block's, and the row group's swap).
//
// bf16 dc (mlc_bwd_dc_mma_kernel, the same shapes) folds before it sums the
// batch: one block per (128 query rows, head, batch element), 8 warps of 16
// rows, q', gn and s resident, k' and v through a two-stage cp.async ring
// 64 rows a stage. Each warp computes A and M for its rows on mma.sync in
// registers, forms (M - s) * A there, adds the fragment elements that share
// a diagonal ((r, c) and (r + 8, c + 8)) and stores 8 rows of 72 pair
// sums; one stage later one thread per (window tile, m) adds its diagonal
// in row order. The per-batch windows go to a scratch [B, H, n_t, n_t,
// 127] fp32 that the wrapper allocates and mlc_bwd_dc_batch_sum_kernel
// sums over b in order. What held the first version back: one block per
// (tile pair, head) looping over the batch (192 blocks at B = 64, N = 197),
// q' and k' staged again for every tile pair and batch element, three
// barriers per batch element around two WMMA passes through shared fp32
// tiles, one 142.6 KB block per SM. This grid has 1536 blocks at that shape
// and 1584 at B = 4, N = 4097; each block stages q' once and k' once per
// 128 query rows, with one barrier per stage. Its 217,600 bytes of shared
// memory leave one 8-warp block per SM: the tile trial (PERF.md) found
// 128-row blocks, which stream k' half as often, faster than 64-row ones at
// two blocks per SM, 64-row stages faster than 32-row ones, and 8 warps of
// 16 rows faster than 4 of 32. Bound: bytes at B = 64, operations at long
// N; it runs at ~4x and ~6x them, on latency within its one block per SM
// rather than on the tensor cores or shared-memory bandwidth.
//
// bf16 dq (mlc_bwd_dq_mma_kernel, the same shapes) is dkv's mirror image:
// one block per (128 query rows, head, batch element), gn and s resident
// (gn's A fragments over D in registers for the whole sweep), k', v and
// each stage's coefficient window w[t] = c[j0 - i0 + N - BM + t] through a
// two-stage cp.async ring of 64 key/value rows. It meets dkv's obstacle,
// the [16, 272] fp32 dq' accumulator of 16 query rows, the same way: two
// warps share 16 rows, each computes M = gn v^T for 32 of the stage's
// columns, forms round((M - s) * T) per cell in registers and swaps it with
// its partner as mma A fragments (8 bytes a lane and 8-column block, a
// named barrier of the two), then accumulates dq' += dA k' over its half
// of the 17 feature blocks (72 registers). One product over D, one
// weighting and one product over F a stage; one block barrier a stage.
// What held the first version back: one 8-warp block per SM on ~152 KB,
// the [64, 276] fp32 accumulator in shared memory (loaded and stored by
// every kv tile's WMMA pass), an fp32 score tile between the two products,
// four barriers a tile and loads not overlapped. The tile trial (PERF.md)
// found 128 query rows faster than 64 or 32 (each block streams all of k'
// and a taller one streams it less often) and 64-row stages faster than
// 32-row ones (half the barriers). It holds 128 registers a thread (8
// bytes spilled), so one 16-warp block per SM (126,976 bytes of shared
// memory); there it runs at ~5x and ~7x its bounds, on latency rather than
// on the tensor cores.
//
// The rest is the first version, simple rather than fast: one block per
// (tile, head, batch) for the fp32 / large-F dq and dkv, and per (tile
// pair, head) for the fp32 / large-F dc, tiles staged by 4-byte cp.async
// copies, WMMA bf16 products for bf16 inputs and fp32 FMA loops for fp32
// inputs, fp32 accumulators in shared memory. bf16 uses 64-row tiles; fp32 uses 32-row
// tiles so that the staged dkv block (q', k', v, gn tiles plus [TILE, F]
// and [TILE, D] accumulators) fits in the 227 KB a block may use at
// F = 266. At larger F (favor_hyper's F = 532) the [TILE, F] tiles and
// accumulators outgrow that, so dq and the staged dkv halve their tile
// until the block fits (bf16 32 rows, fp32 dkv 16); dc keeps its tile,
// since its windows' shape depends on it, and fits at F = 532 in both
// dtypes. Loads do not overlap products there, and dc recomputes M and A
// instead of sharing them with dkv.

#include "flash_attention_mma.cuh"
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

// ─── bf16 dk' and dv: register-resident tiles on mma.sync ───────────────

namespace fm = flash::mma;

// Geometry of mlc_bwd_dkv_mma_kernel: blocks of BM key/value rows, four
// warps per 16 of them (WARPS = BM / 4), against 32-row query tiles, each
// warp owning 8 of the tile's query columns in the score products and a
// quarter of the output columns after; features staged up to FMAX, values
// to DP. Shared memory: k' [BM, LDF] and v [BM, LDD] bf16 resident; a ring
// of two stages, each q' [BN, LDF] and gn [BN, LDD] bf16, s [BN] and the
// tile pair's coefficient window [WINP] fp32; and per warp one 16-byte
// word a lane of rounded weights, which the other three warps read.
template <int FMAX_, int DP_, int BM_>
struct DkvMma {
  static constexpr int FMAX = FMAX_, DP = DP_;
  static constexpr int BM = BM_, BN = 32, WARPS = BM / 4, NT = 32 * WARPS;
  static constexpr int LDF = FMAX + 8, LDD = DP + 8;
  static constexpr int PAIRS = (FMAX / 16 + 3) / 4;  // most 16-column dk' blocks a warp holds
  static constexpr int DV_PAIRS = DP / 64;           // 16-column dv blocks per warp
  static constexpr int WINP = (BM + BN - 1 + 3) / 4 * 4;
  static constexpr size_t KV = (size_t)BM * (LDF + LDD) * sizeof(bf16);
  static constexpr size_t STAGE =
      (size_t)BN * (LDF + LDD) * sizeof(bf16) + (size_t)(BN + WINP) * sizeof(float);
  static constexpr size_t XCH = (size_t)WARPS * 32 * sizeof(uint4);
  static constexpr size_t BYTES = KV + 2 * STAGE + XCH;
  static_assert(FMAX % 16 == 0 && DP % 64 == 0 && BM % 16 == 0, "tile shapes");
  static_assert(KV % 16 == 0 && STAGE % 16 == 0 && (BN * (LDF + LDD) * 2) % 16 == 0,
                "regions start 16-byte aligned");
};

// dk' and dv for one (BM-row key/value tile, head, batch), bf16, F <= FMAX,
// D <= DP. k' and v stay resident; query tiles (q', gn, s and the tile
// pair's coefficient window w[t] = c[j0 - i0 + N - BN + t]) arrive through
// the two-stage cp.async ring. Four warps own the same 16 key/value rows.
// Per tile each computes, for its 8 query columns, A^T = k' q'^T over all
// of F (even and odd 16-steps in two chains, added once) and M^T = v gn^T
// over D in registers, then per cell, with T^T[j, i] = w[(j - j0) - (i -
// i0) + BN - 1], Wk^T = round((M^T - s_i) T^T) and Wv^T = round(A^T T^T),
// packed as bf16 pairs: exactly the four registers of an mma A fragment
// that its 8 columns fill. The four warps swap these through shared memory
// (a named barrier of the four), so each holds the rounded Wk^T and Wv^T
// of all 32 columns as the A operands of dk' += Wk^T q' (a quarter of the
// 16-column feature blocks each) and dv += Wv^T gn (a quarter of the value
// columns each), accumulated in registers across the sweep. No float
// atomics; every sum runs in a fixed order.
template <int FMAX, int DP, int BM_>
__global__ void __launch_bounds__(BM_ * 8, BM_ <= 32 ? 2 : 1)
mlc_bwd_dkv_mma_kernel(const bf16* __restrict__ gn, const float* __restrict__ s,
                        const bf16* __restrict__ v, const bf16* __restrict__ q,
                        const bf16* __restrict__ k, const float* __restrict__ coeffs,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        int H, int N, int F, int D) {
  using C = DkvMma<FMAX, DP, BM_>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + C::BM * C::LDF;
  uint4* xch = reinterpret_cast<uint4*>(smem + C::KV + 2 * C::STAGE);

  const int j0 = blockIdx.x * C::BM;
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const int warp = threadIdx.x / 32;
  const int quarter = warp % 4;
  const int row0 = warp / 4 * 16;  // the row group's first key/value row in the tile
  const int fp = (F + 15) / 16 * 16;
  const int kf = fp / 16;  // 16-column steps of the A^T sum and blocks of dk'
  const int p_count = kf / 4 + (quarter < kf % 4 ? 1 : 0);
  const int p_begin = quarter * (kf / 4) + min(quarter, kf % 4);
  const bf16* qh = q + bh * N * F;
  const bf16* gnh = gn + bh * N * D;
  const float* sh = s + bh * N;
  const float* cb = coeffs + (size_t)h * (2 * N - 1);

  const auto tile_q = [&](int it) {
    return reinterpret_cast<bf16*>(smem + C::KV + (it & 1) * C::STAGE);
  };
  const auto stage_q = [&](int it) {
    bf16* Qt = tile_q(it);
    bf16* Gt = Qt + C::BN * C::LDF;
    float* s_t = reinterpret_cast<float*>(Gt + C::BN * C::LDD);
    float* w_t = s_t + C::BN;
    const int i0 = it * C::BN;
    const int rows = min(C::BN, N - i0);
    stage_words4<C::BN, C::NT>(Qt, C::LDF, fp, qh + (size_t)i0 * F, rows, F);
    fm::stage_rows<C::BN, C::NT>(Gt, C::LDD, DP, gnh + (size_t)i0 * D, rows, D);
    fm::stage_floats<C::NT>(s_t, sh + i0, C::BN, rows);
    const long long base = (long long)j0 - i0 + N - C::BN;
    for (int t = threadIdx.x; t < C::WINP; t += C::NT) {
      const long long m = base + t;
      const bool valid = m >= 0 && m < 2LL * N - 1;
      cp_async4(w_t + t, valid ? cb + m : cb, valid ? 4 : 0);
    }
  };
  const int rows_kv = min(C::BM, N - j0);
  stage_words4<C::BM, C::NT>(Ks, C::LDF, fp, k + (bh * N + j0) * F, rows_kv, F);
  fm::stage_rows<C::BM, C::NT>(Vs, C::LDD, DP, v + (bh * N + j0) * D, rows_kv, D);
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
    if (j0 + row0 >= N) continue;  // the four warps of a group skip together
    const bf16* Qt = tile_q(it);
    const bf16* Gt = Qt + C::BN * C::LDF;
    const float* s_t = reinterpret_cast<const float*>(Gt + C::BN * C::LDD);
    const float* w_t = s_t + C::BN;
    dkv_mma_stage<C>(dka, dva, Ks, Vs, Qt, Gt, s_t, WindowMask<C::BN>{w_t}, xch, th, it * C::BN,
                     j0, N, kf, p_begin, p_count);
  }
  store_block<C::PAIRS>(dk + bh * N * F, F, N, F, j0 + row0, p_begin * 16, p_count, dka);
  store_block<C::DV_PAIRS>(dv + bh * N * D, D, N, D, j0 + row0, quarter * C::DV_PAIRS * 16,
                           C::DV_PAIRS, dva);
}

// The bf16 instantiation: features up to 272 (F = 266), values up to 64,
// 64 key/value rows (16 warps) per block, picked by trial on an H100
// (experiments/tile_trial.py, numbers in PERF.md) over 32-row blocks of 8
// warps, two per SM: about as fast at N = 197 and ~10% faster at N = 4097,
// where each block streams all of q' and a taller block streams it half
// as often.
using DkvChoice = DkvMma<272, 64, 64>;

auto dkv_mma_fn() { return mlc_bwd_dkv_mma_kernel<272, 64, 64>; }

const void* dkv_mma_kernel() { return reinterpret_cast<const void*>(dkv_mma_fn()); }

// Whether a bf16 dkv launch at (F, D) runs mlc_bwd_dkv_mma_kernel; the
// staged kernel runs the rest (fp32, F > 272, D > 64).
bool dkv_mma_takes(int F, int D) { return F <= 272 && F % 2 == 0 && D <= 64; }

int launch_dkv_mma(const void* gn, const void* s, const void* v, const void* q, const void* k,
                   const void* coeffs, void* dk, void* dv, int B, int H, int N, int F, int D,
                   void* stream) {
  using C = DkvChoice;
  const auto kernel = dkv_mma_fn();
  (void)cudaGetLastError();  // start from a clean error state
  const int err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + C::BM - 1) / C::BM, H, B);
  kernel<<<grid, C::NT, C::BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gn), static_cast<const float*>(s), static_cast<const bf16*>(v),
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const float*>(coeffs),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, N, F, D);
  return cudaGetLastError();
}

// ─── bf16 dq': gn resident, rounded weights swapped as A fragments ──────

// Geometry of mlc_bwd_dq_mma_kernel: blocks of BM query rows, SPLIT warps
// per 16 of them (WARPS = BM / 16 * SPLIT), against BN key/value rows a
// stage; each warp owns BN / SPLIT of a stage's columns in the score
// product and about 1 / SPLIT of dq''s 16-column feature blocks; features
// staged up to FMAX, values to DP. Shared memory: gn [BM, LDD] bf16 and s
// [BM] fp32 resident; a ring of two stages, each k' [BN, LDF] and v
// [BN, LDD] bf16 and the tile pair's coefficient window [WINP] fp32; and
// per warp and 8-column block of its score columns one 8-byte word a lane
// of rounded weights, which the other warps of its row group read.
template <int FMAX_, int DP_, int BM_, int SPLIT_, int BN_>
struct DqMma {
  static constexpr int FMAX = FMAX_, DP = DP_, BM = BM_, SPLIT = SPLIT_, BN = BN_;
  static constexpr int WARPS = BM / 16 * SPLIT, NT = 32 * WARPS;
  static constexpr int NBW = BN / (8 * SPLIT);  // 8-column blocks of M a warp computes
  static constexpr int KS = BN / 16;            // 16-steps of the dq' product a stage
  static constexpr int LDF = FMAX + 8, LDD = DP + 8;
  static constexpr int PAIRS = (FMAX / 16 + SPLIT - 1) / SPLIT;  // most dq' blocks a warp holds
  static constexpr int WINP = (BM + BN - 1 + 3) / 4 * 4;
  static constexpr size_t G = (size_t)BM * LDD * sizeof(bf16);
  static constexpr size_t S = (size_t)BM * sizeof(float);
  static constexpr size_t STAGE =
      (size_t)BN * (LDF + LDD) * sizeof(bf16) + (size_t)WINP * sizeof(float);
  static constexpr size_t XCH = (size_t)WARPS * NBW * 32 * sizeof(uint2);
  static constexpr size_t BYTES = G + S + 2 * STAGE + XCH;
  static_assert(FMAX % 16 == 0 && DP % 16 == 0 && BM % 16 == 0 && BN % (16 * SPLIT) == 0,
                "tile shapes: each warp's score columns load in 16-column pairs");
  static_assert(BM / 16 <= 15, "one named barrier (1..15) per row group");
  static_assert(G % 16 == 0 && S % 16 == 0 && STAGE % 16 == 0 &&
                    (BN * LDF * sizeof(bf16)) % 16 == 0, "regions start 16-byte aligned");
};

// dq' for one (BM-row query block, head, batch), bf16, F <= FMAX, D <= DP.
// gn and s stay resident, gn's A fragments over D in registers for the
// whole sweep; key/value stages (k', v and the coefficient window w[t] =
// c[j0 - i0 + N - BM + t] of the block and the stage) arrive through the
// two-stage cp.async ring. The SPLIT warps of a row group own the same 16
// query rows. Per stage each computes M = gn v^T for its BN / SPLIT
// key/value columns in registers, then per cell, with T[i, j] = w[(j - j0)
// - (i - i0) + BM - 1], dA = round((M - s_i) T), zero for cells past N in
// either direction, packed as bf16 pairs: exactly the registers of an mma
// A fragment that its 8-column blocks fill. The warps of the group swap
// these through shared memory (a named barrier of the group), so each
// holds the rounded dA of all BN columns as the A operands of dq' += dA k'
// over its share of the feature blocks, accumulated in registers across
// the sweep. Groups wholly past N skip together after the ring's barrier.
// No float atomics; every sum runs in a fixed order.
template <typename C>
__global__ void __launch_bounds__(C::NT, C::NT <= 256 ? 2 : 1)
mlc_bwd_dq_mma_kernel(const bf16* __restrict__ gn, const float* __restrict__ s,
                      const bf16* __restrict__ v, const bf16* __restrict__ k,
                      const float* __restrict__ coeffs, bf16* __restrict__ dq,
                      int H, int N, int F, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Gs = reinterpret_cast<bf16*>(smem);
  float* s_s = reinterpret_cast<float*>(smem + C::G);
  unsigned char* ring = smem + C::G + C::S;
  uint2* xch = reinterpret_cast<uint2*>(ring + 2 * C::STAGE);

  const int i0 = blockIdx.x * C::BM;
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = warp / C::SPLIT;
  const int part = warp % C::SPLIT;
  const int row0 = group * 16;            // the group's first query row in the block
  const int c0 = part * C::NBW * 8;       // this warp's key/value columns in a stage
  const int fp = (F + 15) / 16 * 16;
  const int kf = fp / 16;  // 16-column blocks of dq'
  const int p_count = kf / C::SPLIT + (part < kf % C::SPLIT ? 1 : 0);
  const int p_begin = part * (kf / C::SPLIT) + min(part, kf % C::SPLIT);
  const int rows_q = min(C::BM, N - i0);
  const bf16* kh = k + bh * N * F;
  const bf16* vh = v + bh * N * D;
  const float* cb = coeffs + (size_t)h * (2 * N - 1);

  const auto stage_of = [&](int js) {
    return reinterpret_cast<bf16*>(ring + (js & 1) * C::STAGE);
  };
  const auto stage_kv = [&](int js) {
    bf16* Kt = stage_of(js);
    bf16* Vt = Kt + C::BN * C::LDF;
    float* w_t = reinterpret_cast<float*>(Vt + C::BN * C::LDD);
    const int j0 = js * C::BN;
    const int rows = min(C::BN, N - j0);
    stage_words4<C::BN, C::NT>(Kt, C::LDF, fp, kh + (size_t)j0 * F, rows, F);
    fm::stage_rows<C::BN, C::NT>(Vt, C::LDD, C::DP, vh + (size_t)j0 * D, rows, D);
    const long long base = (long long)j0 - i0 + N - C::BM;
    for (int t = threadIdx.x; t < C::WINP; t += C::NT) {
      const long long m = base + t;
      const bool valid = m >= 0 && m < 2LL * N - 1;
      cp_async4(w_t + t, valid ? cb + m : cb, valid ? 4 : 0);
    }
  };
  fm::stage_rows<C::BM, C::NT>(Gs, C::LDD, C::DP, gn + (bh * N + i0) * D, rows_q, D);
  fm::stage_floats<C::NT>(s_s, s + bh * N + i0, C::BM, rows_q);
  stage_kv(0);
  fm::cp_async_commit();

  float acc[2 * C::PAIRS][4];
  fm::zero_acc(acc);
  uint32_t gf[C::DP / 16][4];  // gn's A fragments, loaded once stage 0 has landed
  float s_r[2] = {0.f, 0.f};   // s of this thread's rows
  const int r = lane / 4;             // this thread's fragment rows r, r + 8
  const int qc = 2 * (lane % 4);      // and columns qc, qc + 1 of each 8-column block
  const bool row_ok[2] = {i0 + row0 + r < N, i0 + row0 + r + 8 < N};

  const int n_kv = (N + C::BN - 1) / C::BN;
  for (int js = 0; js < n_kv; ++js) {
    fm::cp_async_wait<0>();
    __syncthreads();  // stage js staged by every thread; stage js - 1's ring slot and words free
    if (js + 1 < n_kv) {
      stage_kv(js + 1);
      fm::cp_async_commit();
    }
    if (i0 + row0 >= N) continue;  // the warps of a group skip together
    if (js == 0) {
      fm::load_a_rows<C::DP / 16>(gf, Gs, C::LDD, row0);
      s_r[0] = s_s[row0 + r];
      s_r[1] = s_s[row0 + r + 8];
    }
    const bf16* Kt = stage_of(js);
    const bf16* Vt = Kt + C::BN * C::LDF;
    const float* w_t = reinterpret_cast<const float*>(Vt + C::BN * C::LDD);
    const int j0 = js * C::BN;

    // M = gn v^T for this warp's NBW 8-column blocks
    float m[C::NBW][4];
    fm::zero_acc(m);
    fm::mma_a_rows<C::DP / 16, C::NBW>(m, gf, Vt + c0 * C::LDD, C::LDD);
    // per cell (query row i, key/value row j): dA = round((M - s_i) T)
#pragma unroll
    for (int nb = 0; nb < C::NBW; ++nb) {
      float wd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = row0 + r + 8 * (e / 2);      // query row in the block
        const int c = c0 + nb * 8 + qc + (e & 1);  // key/value row in the stage
        wd[e] = 0.f;
        if (row_ok[e / 2] && j0 + c < N)
          wd[e] = (m[nb][e] - s_r[e / 2]) * w_t[c - a + C::BM - 1];
      }
      xch[(warp * C::NBW + nb) * 32 + lane] =
          make_uint2(fm::pack_bf16(wd[0], wd[1]), fm::pack_bf16(wd[2], wd[3]));
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(32 * C::SPLIT) : "memory");
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      // the A fragment of 16-step ks: 8-column blocks 2 ks (registers 0, 1)
      // and 2 ks + 1 (registers 2, 3), each from the warp that computed it
      uint32_t da[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int blk = 2 * ks + hh;
        const uint2 w2 = xch[((group * C::SPLIT + blk / C::NBW) * C::NBW + blk % C::NBW) * 32 +
                             lane];
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
  store_block<C::PAIRS>(dq + bh * N * F, F, N, F, i0 + row0, p_begin * 16, p_count, acc);
}

// The bf16 instantiation: features up to 272 (F = 266), values up to 64,
// 128 query rows (16 warps, two per 16 rows) per block against 64-row
// key/value stages, picked by trial on an H100 (experiments/tile_trial.py,
// numbers in PERF.md).
using DqChoice = DqMma<272, 64, 128, 2, 64>;

const void* dq_mma_kernel() {
  return reinterpret_cast<const void*>(mlc_bwd_dq_mma_kernel<DqChoice>);
}

// Whether a bf16 dq launch at (F, D) runs mlc_bwd_dq_mma_kernel; the staged
// kernel runs the rest (fp32, F > 272, odd F, D > 64).
bool dq_mma_takes(int F, int D) { return F <= 272 && F % 2 == 0 && D <= 64; }

int launch_dq_mma(const void* gn, const void* s, const void* v, const void* k,
                  const void* coeffs, void* dq, int B, int H, int N, int F, int D,
                  void* stream) {
  using C = DqChoice;
  const auto kernel = mlc_bwd_dq_mma_kernel<C>;
  (void)cudaGetLastError();  // start from a clean error state
  const int err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + C::BM - 1) / C::BM, H, B);
  kernel<<<grid, C::NT, C::BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gn), static_cast<const float*>(s), static_cast<const bf16*>(v),
      static_cast<const bf16*>(k), static_cast<const float*>(coeffs), static_cast<bf16*>(dq),
      H, N, F, D);
  return cudaGetLastError();
}

// ─── bf16 dcoeffs: q' resident, the fold before the batch sum ───────────

// Geometry of mlc_bwd_dc_mma_kernel: blocks of BM query rows (BM / 64 of
// the windows' 64-row tiles), one warp per 16 of them, against BN key/value
// rows a stage (64 / BN stages per window tile); features staged up to
// FMAX, values to DP. Shared memory: q' [BM, LDF] and gn [BM, LDD] bf16 and
// s [BM] fp32 resident; a ring of two stages, each k' [BN, LDF] and v
// [BN, LDD] bf16; and two buffers of a stage's diagonal pair sums, each
// [BM / 2, LDP] fp32. The fold runs one thread per (window tile, value m):
// 128 a tile, NT in all.
template <int FMAX_, int DP_, int BM_, int BN_>
struct DcMma {
  static constexpr int FMAX = FMAX_, DP = DP_;
  static constexpr int TILE = 64;  // the windows' tile: dc_tile<bf16>()
  static constexpr int WIN = 2 * TILE - 1;
  static constexpr int BM = BM_, BN = BN_, WARPS = BM / 16, NT = 32 * WARPS;
  static constexpr int NB = BN / 8;  // 8-column blocks of a warp's score rows
  static constexpr int LDF = FMAX + 8, LDD = DP + 8, LDP = BN + 8;
  static constexpr size_t Q = (size_t)BM * LDF * sizeof(bf16);
  static constexpr size_t G = (size_t)BM * LDD * sizeof(bf16);
  static constexpr size_t S = (size_t)BM * sizeof(float);
  static constexpr size_t STAGE = (size_t)BN * (LDF + LDD) * sizeof(bf16);
  static constexpr int PAIR_FLOATS = (BM / 2) * LDP;
  static constexpr size_t BYTES = Q + G + S + 2 * STAGE + 2 * PAIR_FLOATS * sizeof(float);
  static_assert(FMAX % 16 == 0 && DP % 16 == 0 && BM % TILE == 0 && TILE % BN == 0 &&
                    BN % 16 == 0, "tile shapes");
  static_assert(NT == 128 * (BM / TILE), "one fold thread per window value and tile");
  static_assert(LDP % 32 == 8, "pair-sum rows of four lanes' float2 stores on distinct banks");
  static_assert(Q % 16 == 0 && G % 16 == 0 && S % 16 == 0 && STAGE % 16 == 0 &&
                    (BN * LDF * sizeof(bf16)) % 16 == 0, "regions start 16-byte aligned");
};

// Per (BM-row query block, head, batch element), the diagonal windows of
// this batch element's dW * A for every tile pair of the block's tiles:
// scratch[b, h, iq, jk, m] = sum over the tile pair's (a, c) with
// c - a + 63 = m of (M - s)[a, c] * A[a, c], M = gn v^T and A = q' k'^T
// (bf16 products, fp32 accumulation; the difference and product fp32).
// q', gn and s stay resident; k' and v arrive through the two-stage
// cp.async ring, BN rows a stage. Per stage each warp computes A over all
// of F and M over D for its 16 query rows in registers, forms P = (M - s) *
// A, and adds each element to its partner 8 rows and 8 columns further on,
// on the same diagonal ((r, c) + (r + 8, c + 8), the two halves of its
// m16n8 fragments), so its 16 x BN tile leaves registers as 8 rows of
// BN + 8 pair sums. One stage later one thread per (window tile, m) adds
// the pair sums of its diagonal over the tile's rows in order, keeping the
// sum in a register across the tile's stages, and writes the window after
// the last; so the fold of stage js - 1 and the products of stage js share
// one step and one barrier, and the pair sums alternate between two
// buffers. Rows past N are zero-filled (their products are 0) and warps
// wholly past N skip the products; the fold reads no warp's rows wholly
// past N, and stages wholly past N are not staged. No float atomics: every
// sum runs in one order.
template <typename C>
__global__ void __launch_bounds__(C::NT)
mlc_bwd_dc_mma_kernel(const bf16* __restrict__ gn, const float* __restrict__ s,
                      const bf16* __restrict__ v, const bf16* __restrict__ q,
                      const bf16* __restrict__ k, float* __restrict__ scratch,
                      int H, int N, int F, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = reinterpret_cast<bf16*>(smem + C::Q);
  float* s_s = reinterpret_cast<float*>(smem + C::Q + C::G);
  unsigned char* ring = smem + C::Q + C::G + C::S;
  float* Ps = reinterpret_cast<float*>(ring + 2 * C::STAGE);

  const int i0 = blockIdx.x * C::BM;
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // the warp's first query row in the block
  const int fp = (F + 15) / 16 * 16;
  const int kf = fp / 16;  // 16-column steps of A's sum over F
  const int n_t = (N + C::TILE - 1) / C::TILE;
  const int rows_q = min(C::BM, N - i0);
  const bf16* kh = k + bh * N * F;
  const bf16* vh = v + bh * N * D;

  const auto stage_kv = [&](int js) {
    bf16* Kt = reinterpret_cast<bf16*>(ring + (js & 1) * C::STAGE);
    bf16* Vt = Kt + C::BN * C::LDF;
    const int j0 = js * C::BN;
    const int rows = min(C::BN, N - j0);
    stage_words4<C::BN, C::NT>(Kt, C::LDF, fp, kh + (size_t)j0 * F, rows, F);
    fm::stage_rows<C::BN, C::NT>(Vt, C::LDD, C::DP, vh + (size_t)j0 * D, rows, D);
  };
  stage_words4<C::BM, C::NT>(Qs, C::LDF, fp, q + (bh * N + i0) * F, rows_q, F);
  fm::stage_rows<C::BM, C::NT>(Gs, C::LDD, C::DP, gn + (bh * N + i0) * D, rows_q, D);
  fm::stage_floats<C::NT>(s_s, s + bh * N + i0, C::BM, rows_q);
  stage_kv(0);
  fm::cp_async_commit();

  const bool warp_live = row0 < rows_q;  // the warp holds a query row below N
  const int r = lane / 4;                // this thread's fragment rows r, r + 8
  const int qc = 2 * (lane % 4);         // and columns qc, qc + 1 of each 8-column block
  // the fold: thread (t, m) owns value m of the windows of the block's tile
  // t, over the tile's warps that hold a row below N
  const int t = threadIdx.x / 128;
  const int m = threadIdx.x % 128;
  const int rows_t = rows_q - t * C::TILE;  // tile t's query rows below N
  const bool folds = m < C::WIN && rows_t > 0;
  const int fold_warps = min(C::TILE / 16, (rows_t + 15) / 16);
  float* out = scratch + ((bh * n_t + i0 / C::TILE + t) * n_t) * C::WIN + m;
  float wsum = 0.f;

  constexpr int SPT = C::TILE / C::BN;  // stages per window tile
  const int steps = n_t * SPT;
  // step js: the fold of stage js - 1, then the products of stage js
  for (int js = 0; js <= steps; ++js) {
    fm::cp_async_wait<0>();
    // stage js landed for every thread; stage js - 1's products, their pair
    // sums and the fold of stage js - 2 are done
    __syncthreads();
    if (js + 1 < steps && (js + 1) * C::BN < N) stage_kv(js + 1);
    fm::cp_async_commit();
    if (js >= 1) {
      const int jp = js - 1;
      if (jp * C::BN < N && folds) {
        // pair row (w, rr) of tile t sums the diagonal through query rows
        // 16 w + rr and 16 w + rr + 8 at pair column m - 55 + 16 w + rr - jofs
        const float* Pt = Ps + (jp & 1) * C::PAIR_FLOATS + t * (C::TILE / 2) * C::LDP;
        const int c0 = m - (C::TILE - 1) + 8 - (jp * C::BN) % C::TILE;
#pragma unroll
        for (int w = 0; w < C::TILE / 16; ++w) {
          if (w >= fold_warps) break;
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) {
            const int cc = c0 + 16 * w + rr;
            if (cc >= 0 && cc < C::BN + 8) wsum += Pt[(w * 8 + rr) * C::LDP + cc];
          }
        }
      }
      if (jp % SPT == SPT - 1) {  // the window tile's last stage
        if (folds) out[(size_t)(jp / SPT) * C::WIN] = wsum;
        wsum = 0.f;
      }
    }
    if (js < steps && js * C::BN < N && warp_live) {
      const bf16* Kt = reinterpret_cast<const bf16*>(ring + (js & 1) * C::STAGE);
      const bf16* Vt = Kt + C::BN * C::LDF;
      float acc[C::NB][4];
      fm::zero_acc(acc);
#pragma unroll
      for (int kk = 0; kk < C::FMAX / 16; ++kk) {  // A = q' k'^T
        if (kk >= kf) break;
        uint32_t af[4];
        fm::load_a(af, Qs, C::LDF, row0, kk * 16);
#pragma unroll
        for (int np = 0; np < C::NB / 2; ++np) {
          uint32_t b[4];
          fm::load_b_rows(b, Kt, C::LDF, np * 16, kk * 16);
          fm::mma_bf16(acc[2 * np], af, b[0], b[1]);
          fm::mma_bf16(acc[2 * np + 1], af, b[2], b[3]);
        }
      }
      uint32_t gf[C::DP / 16][4];
      fm::load_a_rows<C::DP / 16>(gf, Gs, C::LDD, row0);
      const float s0 = s_s[row0 + r], s1 = s_s[row0 + r + 8];
#pragma unroll
      for (int np = 0; np < C::NB / 2; ++np) {  // M = gn v^T, 16 columns at a time
        float mm[2][4];
        fm::zero_acc(mm);
#pragma unroll
        for (int kd = 0; kd < C::DP / 16; ++kd) {
          uint32_t b[4];
          fm::load_b_rows(b, Vt, C::LDD, np * 16, kd * 16);
          fm::mma_bf16(mm[0], gf[kd], b[0], b[1]);
          fm::mma_bf16(mm[1], gf[kd], b[2], b[3]);
        }
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
          float(&a)[4] = acc[2 * np + hb];
          a[0] = (mm[hb][0] - s0) * a[0];
          a[1] = (mm[hb][1] - s0) * a[1];
          a[2] = (mm[hb][2] - s1) * a[2];
          a[3] = (mm[hb][3] - s1) * a[3];
        }
      }
      // pair sums: column block kb of the warp's 8 pair rows holds, at
      // column 8 kb + qc + j (c = that - 8), P[r, c] + P[r + 8, c + 8], each
      // term only where its column lies in this stage
      float* prow = Ps + (js & 1) * C::PAIR_FLOATS + (warp * 8 + r) * C::LDP + qc;
#pragma unroll
      for (int kb = 0; kb <= C::NB; ++kb) {
        float2 x = make_float2(0.f, 0.f);
        if (kb >= 1) {
          x.x += acc[kb - 1][0];
          x.y += acc[kb - 1][1];
        }
        if (kb < C::NB) {
          x.x += acc[kb][2];
          x.y += acc[kb][3];
        }
        *reinterpret_cast<float2*>(prow + 8 * kb) = x;
      }
    }
  }
}

// windows[i] = sum over b = 0..B-1 of scratch[b, i], in that order.
__global__ void __launch_bounds__(THREADS)
mlc_bwd_dc_batch_sum_kernel(const float* __restrict__ scratch, float* __restrict__ windows,
                            int B, long long per_batch) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= per_batch) return;
  float sum = 0.f;
  for (int b = 0; b < B; ++b) sum += scratch[b * per_batch + i];
  windows[i] = sum;
}

// The bf16 instantiation: features up to 272 (F = 266), values up to 64,
// 128 query rows (8 warps) a block against 64-row key/value stages, picked
// by trial on an H100 (experiments/tile_trial.py, numbers in PERF.md).
using DcChoice = DcMma<272, 64, 128, 64>;

const void* dc_mma_kernel() {
  return reinterpret_cast<const void*>(mlc_bwd_dc_mma_kernel<DcChoice>);
}

// Whether a bf16 dc launch at (F, D) runs mlc_bwd_dc_mma_kernel; the staged
// kernel runs the rest (fp32, F > 272, D > 64).
bool dc_mma_takes(int F, int D) { return F <= 272 && F % 2 == 0 && D <= 64; }

// fp32 values of the per-batch windows mlc_bwd_dc_mma_kernel writes.
long long dc_scratch_floats(int B, int H, int N) {
  const long long n_t = (N + DcChoice::TILE - 1) / DcChoice::TILE;
  return (long long)B * H * n_t * n_t * DcChoice::WIN;
}

int launch_dc_mma(const void* gn, const void* s, const void* v, const void* q, const void* k,
                  void* windows, void* scratch, int B, int H, int N, int F, int D,
                  void* stream) {
  using C = DcChoice;
  const auto kernel = mlc_bwd_dc_mma_kernel<C>;
  (void)cudaGetLastError();  // start from a clean error state
  int err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)C::BYTES);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + C::BM - 1) / C::BM, H, B);
  kernel<<<grid, C::NT, C::BYTES, st>>>(
      static_cast<const bf16*>(gn), static_cast<const float*>(s), static_cast<const bf16*>(v),
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<float*>(scratch),
      H, N, F, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per_batch = dc_scratch_floats(1, H, N);
  mlc_bwd_dc_batch_sum_kernel<<<(unsigned)((per_batch + THREADS - 1) / THREADS), THREADS, 0,
                                st>>>(static_cast<const float*>(scratch),
                                      static_cast<float*>(windows), B, per_batch);
  return cudaGetLastError();
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
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_t = (N + TILE - 1) / TILE;
  const int iq = blockIdx.x / n_t;
  const int jk = blockIdx.x - iq * n_t;
  const int h = blockIdx.y;
  const float* acc = batch_sum_dw_a<T, TILE>(smem, gn, s, v, q, k, B, H, N, F, D, h,
                                             iq * TILE, jk * TILE);
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
  const BatchSumLayout<T, TILE> L(F, D);
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

// A staged kernel's instantiation, its tile rows and its shared memory:
// what mlc_bwd_launch_info reports (the tiles launch_dq / launch_dkv pick).
struct StagedChoice {
  const void* kernel;
  int rows;
  size_t bytes;
};

template <typename T, int TILE = dc_tile<T>()>
StagedChoice dq_staged(int F, int D) {
  const DqLayout<T, TILE> L(F, D);
  if constexpr (TILE > MIN_TILE) {
    if (L.bytes > (size_t)MAX_SMEM) return dq_staged<T, TILE / 2>(F, D);
  }
  return {reinterpret_cast<const void*>(mlc_bwd_dq_kernel<T, TILE>), TILE, L.bytes};
}

template <typename T, int TILE = dc_tile<T>()>
StagedChoice dkv_staged(int F, int D) {
  const DkvLayout<T, TILE> L(F, D);
  if constexpr (TILE > MIN_TILE) {
    if (L.bytes > (size_t)MAX_SMEM) return dkv_staged<T, TILE / 2>(F, D);
  }
  return {reinterpret_cast<const void*>(mlc_bwd_dkv_kernel<T, TILE>), TILE, L.bytes};
}

// kind 0: dq, 1: dkv, 2: dc.
template <typename T>
StagedChoice staged_choice(int kind, int F, int D) {
  if (kind == 0) return dq_staged<T>(F, D);
  if (kind == 1) return dkv_staged<T>(F, D);
  return {reinterpret_cast<const void*>(mlc_bwd_dc_kernel<T>), dc_tile<T>(),
          BatchSumLayout<T, dc_tile<T>()>(F, D).bytes};
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
// shared memory even at MIN_TILE rows). The bf16 dq launch at even F <= 272,
// D <= 64 runs mlc_bwd_dq_mma_kernel.
int mlc_bwd_dq_bf16(const void* gn, const void* s, const void* v, const void* k,
                    const void* coeffs, void* dq, int B, int H, int N, int F, int D,
                    void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  if (dq_mma_takes(F, D)) return launch_dq_mma(gn, s, v, k, coeffs, dq, B, H, N, F, D, stream);
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
  if (dkv_mma_takes(F, D))
    return launch_dkv_mma(gn, s, v, q, k, coeffs, dk, dv, B, H, N, F, D, stream);
  return launch_dkv<bf16>(gn, s, v, q, k, coeffs, dk, dv, B, H, N, F, D, stream);
}

int mlc_bwd_dkv_f32(const void* gn, const void* s, const void* v, const void* q,
                    const void* k, const void* coeffs, void* dk, void* dv,
                    int B, int H, int N, int F, int D, void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  return launch_dkv<float>(gn, s, v, q, k, coeffs, dk, dv, B, H, N, F, D, stream);
}

// fp32 values of the scratch a dc launch at these dims needs: the per-batch
// windows [B, H, n_t, n_t, 127] of mlc_bwd_dc_mma_kernel for a bf16 launch
// it takes, else 0 (the staged kernel sums the batch in place); -1 for
// empty dims.
long long mlc_bwd_dc_scratch_floats(int B, int H, int N, int F, int D, int is_bf16) {
  if (bad_dims(B, H, N, F, D)) return -1;
  return is_bf16 && dc_mma_takes(F, D) ? dc_scratch_floats(B, H, N) : 0;
}

// windows [H, n_t, n_t, 2 * tile - 1] fp32; scratch holds
// mlc_bwd_dc_scratch_floats(...) fp32 values (null where that is 0). The
// bf16 launch at even F <= 272, D <= 64 runs mlc_bwd_dc_mma_kernel into the
// scratch, then mlc_bwd_dc_batch_sum_kernel into the windows.
int mlc_bwd_dc_bf16(const void* gn, const void* s, const void* v, const void* q,
                    const void* k, void* windows, void* scratch, int B, int H, int N,
                    int F, int D, void* stream) {
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  if (dc_mma_takes(F, D)) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    return launch_dc_mma(gn, s, v, q, k, windows, scratch, B, H, N, F, D, stream);
  }
  return launch_dc<bf16>(gn, s, v, q, k, windows, B, H, N, F, D, stream);
}

int mlc_bwd_dc_f32(const void* gn, const void* s, const void* v, const void* q,
                   const void* k, void* windows, void* scratch, int B, int H, int N,
                   int F, int D, void* stream) {
  (void)scratch;
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

// What a bf16 (is_bf16 = 1) or fp32 launch of kind 0 (dq), 1 (dkv) or 2
// (dc) at (N, F, D) runs, in info[0..6]: rows per tile (per block for the
// mma.sync kernels), threads, dynamic shared memory bytes, resident blocks
// per SM, registers per thread, local (spilled) bytes per thread, and 1 for
// mlc_bwd_dq_mma_kernel, mlc_bwd_dkv_mma_kernel or mlc_bwd_dc_mma_kernel (0
// for a staged kernel).
// Returns the CUDA error code (cudaErrorInvalidValue for bad arguments or a
// block that exceeds shared memory).
int mlc_bwd_launch_info(int kind, int N, int F, int D, int is_bf16, int* info) {
  if (bad_dims(1, 1, N, F, D) || kind < 0 || kind > 2) return cudaErrorInvalidValue;
  if (is_bf16 && kind == 0 && dq_mma_takes(F, D))
    return fm::launch_info(dq_mma_kernel(), DqChoice::BM, DqChoice::NT, DqChoice::BYTES, true,
                           info);
  if (is_bf16 && kind == 1 && dkv_mma_takes(F, D))
    return fm::launch_info(dkv_mma_kernel(), DkvChoice::BM, DkvChoice::NT, DkvChoice::BYTES,
                           true, info);
  if (is_bf16 && kind == 2 && dc_mma_takes(F, D))
    return fm::launch_info(dc_mma_kernel(), DcChoice::BM, DcChoice::NT, DcChoice::BYTES, true,
                           info);
  const StagedChoice c = is_bf16 ? staged_choice<bf16>(kind, F, D)
                                 : staged_choice<float>(kind, F, D);
  return fm::launch_info(c.kernel, c.rows, THREADS, c.bytes, false, info);
}

const char* mlc_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
