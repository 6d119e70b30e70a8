// Coeffs-native KERPLE (Toeplitz-masked linear attention) forward for Hopper.
//
// Replaces the TPU kernel efficient_rpe_vit_tpu/ops/pallas/masked_linear_coeffs.py
// `_fwd_kernel` (launched by `_fwd_impl`, public `masked_linear_attention_coeffs`).
// Per (batch b, head h) it computes, with T[i, j] = c[h, j - i + N - 1]:
//
//   S   = q' k'^T                      (fp32 accumulation)
//   W   = S * T                        (fp32)
//   den = rowsum(W)                    (fp32)
//   num = round_to_input_dtype(W) v    (fp32 accumulation)
//   out = num / (den + 1e-6)           (written in v's dtype), den written in fp32
//
// Neither T nor W ever reaches device memory: each block reads the
// bq + bkv - 1 coefficients its tile needs and indexes them directly as
// T[a, b] = w[b - a + BQ - 1].
//
// What bounds it on an H100: bytes at the ViT-B/16 serving and training
// shapes (B=32 / 64, H=12, N=197, F=266, D=64, bf16: ~100 / ~200 MB of q',
// k', v, out and den against ~9.9 / ~19.7 GFLOP, i.e. 30 / 60 us at
// 3.35 TB/s against 10 / 20 us at the bf16 tensor-core peak); operations at
// long N (B=4, N=4097: ~0.53 TFLOP, 0.54 ms). The quadratic [N, N] work
// stays in registers and shared memory.
//
// bf16 (mlc_fwd_mma_kernel, even F <= 272, D <= 64: the main path) is
// register-resident on mma.sync (flash_attention_mma.cuh's fragments), the
// flash forward without its online max: W = S * T needs no rescaling and
// den is a plain fp32 row sum. One block per (BM query rows, head, batch),
// one warp per 16 of them; q' is staged once and held as mma A fragments
// (17 x 4 registers at F = 266, padded to 272 with zero lanes), and its
// shared region then becomes the ring's second stage. k', v and the
// stage's coefficient window w[t] = c[j0 - i0 + N - BM + t] (T[a, b] =
// w[b - a + BM - 1]) move through a two-stage cp.async ring (532-byte q'
// and k' rows are 4-byte but not 16-byte aligned: 4-byte words, a warp to
// a row), stage j + 1 copied while stage j is computed, one barrier a
// stage. Per stage each warp computes its S = q' k'^T for all BN columns in
// registers, weighs each fragment element by T (exactly 0 past N in either
// direction), adds it to its rows' fp32 sums and rounds it to bf16, packed
// as the A fragments of W v, whose B fragments ldmatrix.trans reads from the
// stage. Nothing fp32 crosses warps: the row sums add over a fragment row's
// four lanes in a fixed shuffle order, and out = acc / (den + 1e-6) and den
// are written once. No float atomics; out and den are bitwise the same run
// to run. Geometry picked by trial (experiments/tile_trial.py, PERF.md).
// What held the first version back: WMMA fragments with the fp32 score tile
// written to shared memory, read back for the mask and row sum, written
// again as a bf16 weight tile and reloaded for W v (four round trips and
// three barriers a stage), and copies that never overlapped products.
//
// The rest is the first version, simple rather than fast: one block per
// (64-row query tile, head, batch) looping over 64-row kv tiles, each
// staged by 4-byte cp.async copies, all in flight before one wait; WMMA
// bf16 tensor-core products for bf16 inputs outside the rule above (odd F,
// F > 272 such as favor_hyper's 532, D > 64), fp32 FMA products for fp32
// inputs (with 32-row tiles where the 64-row q' and k' tiles outgrow shared
// memory: favor_hyper's F = 532 in fp32; F = 266 keeps the 64-row tiles).
// Loads do not overlap its products.

#include "flash_attention_mma.cuh"
#include "kerple_common.cuh"

namespace {

using namespace kerple;

// Query and key/value rows per block: 64, and for fp32 at large F (where
// the 64-row q' and k' tiles alone outgrow shared memory, F above ~380 at
// D = 64) 32.
constexpr int BIG = 64;
constexpr int SMALL = 32;
constexpr int MAX_D = 128;    // head dims up to 128 (accumulators live in registers)
constexpr float EPS = 1e-6f;

// Shared-memory layout, computed the same way on the host (for the launch
// size) and on the device (for the offsets).
struct Layout {
  int fp;    // feature columns staged per q'/k' row (zero-filled past F)
  int dp;    // value columns staged per v row (zero-filled past D), multiple of 16
  int ldf;   // row stride (elements) of the q' and k' tiles
  int ldd;   // row stride (elements) of the v tile
  int lds;   // row stride (floats) of the fp32 score / output tile
  int ldw;   // row stride (elements) of the rounded weight tile (bf16 only)
  size_t q_off, k_off, v_off, s_off, w_off, c_off, den_off, bytes;
};

template <typename T, int BQ, int BKV>
__host__ __device__ Layout make_layout(int F, int D) {
  constexpr bool kBf16 = is_bf16<T>();
  Layout L;
  L.dp = round_up(D, 16);
  if (kBf16) {
    // WMMA fragments are 16 wide: pad F to 16 with zeros; strides stay
    // multiples of 8 elements and every 16-row fragment starts 32-byte
    // aligned; the +8 staggers rows across shared-memory banks.
    L.fp = round_up(F, 16);
    L.ldf = L.fp + 8;
    L.ldd = L.dp + 8;
    L.ldw = BKV + 8;
  } else {
    // FMA loops walk a column across 16 rows: an odd stride spreads them
    // over distinct banks.
    L.fp = F;
    L.ldf = F | 1;
    L.ldd = L.dp;
    L.ldw = 0;
  }
  L.lds = (BKV > L.dp ? BKV : L.dp) + 4;
  size_t off = 0;
  L.q_off = off; off = align128(off + sizeof(T) * BQ * L.ldf);
  L.k_off = off; off = align128(off + sizeof(T) * BKV * L.ldf);
  L.v_off = off; off = align128(off + sizeof(T) * BKV * L.ldd);
  L.s_off = off; off = align128(off + sizeof(float) * BQ * L.lds);
  L.w_off = off; off = align128(off + sizeof(T) * BQ * L.ldw);
  L.c_off = off; off = align128(off + sizeof(float) * (BQ + BKV));
  L.den_off = off; off = align128(off + sizeof(float) * BQ);
  L.bytes = off;
  return L;
}

template <typename T, int BQ, int BKV>
__global__ void __launch_bounds__(THREADS)
mlc_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ coeffs,
               T* __restrict__ out, float* __restrict__ den,
               int H, int N, int F, int D) {
  using namespace nvcuda;
  constexpr bool kBf16 = is_bf16<T>();
  static_assert(!kBf16 || (BQ == BIG && BKV == BIG), "bf16 products assume 64-row tiles");
  constexpr int RQ = BQ / 16;   // fp32: rows per thread
  constexpr int RK = BKV / 16;  // fp32: score columns per thread
  const Layout L = make_layout<T, BQ, BKV>(F, D);

  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L.q_off);
  T* Ks = reinterpret_cast<T*>(smem + L.k_off);
  T* Vs = reinterpret_cast<T*>(smem + L.v_off);
  float* Ss = reinterpret_cast<float*>(smem + L.s_off);
  T* Ws = reinterpret_cast<T*>(smem + L.w_off);
  float* cw = reinterpret_cast<float*>(smem + L.c_off);
  float* den_s = reinterpret_cast<float*>(smem + L.den_off);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const T* qb = q + bh * N * F;
  const T* kb = k + bh * N * F;
  const T* vb = v + bh * N * D;
  const float* cb = coeffs + (size_t)h * (2 * N - 1);
  const int rows_q = min(BQ, N - i0);

  load_tile<T, BQ>(Qs, L.ldf, L.fp, qb + (size_t)i0 * F, rows_q, F);
  for (int a = tid; a < BQ; a += THREADS) den_s[a] = 0.f;

  // bf16: WMMA accumulators of the [BQ, dp] output tile, fragment
  // f = warp + WARPS * i at (f / (dp/16), f % (dp/16)).
  // fp32: thread (ty, tx) owns rows ty + 16 r and columns tx + 16 c.
  const int n_dfrag = L.dp / 16;
  const int n_ofrag = (BQ / 16) * n_dfrag;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.f);
  float acc32[RQ][MAX_D / 16];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < MAX_D / 16; ++c) acc32[r][c] = 0.f;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const int n_kv = (N + BKV - 1) / BKV;
  for (int jt = 0; jt < n_kv; ++jt) {
    const int j0 = jt * BKV;
    const int rows_kv = min(BKV, N - j0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, BKV>(Ks, L.ldf, L.fp, kb + (size_t)j0 * F, rows_kv, F);
    load_tile<T, BKV>(Vs, L.ldd, L.dp, vb + (size_t)j0 * D, rows_kv, D);
    // coefficient window: w[t] = c[base + t], t = b - a + BQ - 1
    const long long base = (long long)j0 - i0 + N - BQ;
    for (int t = tid; t < BQ + BKV - 1; t += THREADS) {
      const long long m = base + t;
      cw[t] = (m >= 0 && m < 2LL * N - 1) ? cb[m] : 0.f;
    }
    cp_async_wait_all();  // this tile's (and, first time round, Q's) copies
    __syncthreads();

    // S = q' k'^T  ->  Ss (fp32)
    if constexpr (kBf16) {
      // warp w computes fragments (w/4, w%4) and (w/4 + 2, w%4): one B
      // fragment serves both.
      const int fm = warp / 4;
      const int fn = warp % 4;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa0, fa1;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s0, s1;
      wmma::fill_fragment(s0, 0.f);
      wmma::fill_fragment(s1, 0.f);
      for (int k0 = 0; k0 < L.fp; k0 += 16) {
        wmma::load_matrix_sync(fb, Ks + (fn * 16) * L.ldf + k0, L.ldf);
        wmma::load_matrix_sync(fa0, Qs + (fm * 16) * L.ldf + k0, L.ldf);
        wmma::load_matrix_sync(fa1, Qs + ((fm + 2) * 16) * L.ldf + k0, L.ldf);
        wmma::mma_sync(s0, fa0, fb, s0);
        wmma::mma_sync(s1, fa1, fb, s1);
      }
      wmma::store_matrix_sync(Ss + (fm * 16) * L.lds + fn * 16, s0, L.lds, wmma::mem_row_major);
      wmma::store_matrix_sync(Ss + ((fm + 2) * 16) * L.lds + fn * 16, s1, L.lds, wmma::mem_row_major);
    } else {
      float s[RQ][RK];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < RK; ++c) s[r][c] = 0.f;
      for (int f = 0; f < F; ++f) {
        float qa[RQ], kb4[RK];
#pragma unroll
        for (int r = 0; r < RQ; ++r) qa[r] = Qs[(ty + 16 * r) * L.ldf + f];
#pragma unroll
        for (int c = 0; c < RK; ++c) kb4[c] = Ks[(tx + 16 * c) * L.ldf + f];
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int c = 0; c < RK; ++c) s[r][c] = fmaf(qa[r], kb4[c], s[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < RK; ++c) Ss[(ty + 16 * r) * L.lds + tx + 16 * c] = s[r][c];
    }
    __syncthreads();

    // W = S * T (masked past N), den += rowsum(W), W rounded to the input
    // dtype for the value product (in place for fp32).
    for (int r = 0; r < BQ / WARPS; ++r) {
      const int a = warp + WARPS * r;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        const int b = lane + 32 * c;
        float w = 0.f;
        if (a < rows_q && b < rows_kv) w = Ss[a * L.lds + b] * cw[b - a + BQ - 1];
        rs += w;
        if constexpr (kBf16) {
          Ws[a * L.ldw + b] = __float2bfloat16(w);
        } else {
          Ss[a * L.lds + b] = w;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      if (lane == 0) den_s[a] += rs;
    }
    __syncthreads();

    // num += W v
    if constexpr (kBf16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = warp + WARPS * i;
        if (f < n_ofrag) {
          const int fm = f / n_dfrag;
          const int fn = f % n_dfrag;
#pragma unroll
          for (int k0 = 0; k0 < BKV; k0 += 16) {
            wmma::load_matrix_sync(fa, Ws + (fm * 16) * L.ldw + k0, L.ldw);
            wmma::load_matrix_sync(fb, Vs + k0 * L.ldd + fn * 16, L.ldd);
            wmma::mma_sync(acc[i], fa, fb, acc[i]);
          }
        }
      }
    } else {
      for (int kk = 0; kk < BKV; ++kk) {
        float wr[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) wr[r] = Ss[(ty + 16 * r) * L.lds + kk];
#pragma unroll
        for (int c = 0; c < MAX_D / 16; ++c) {
          if (c < n_dfrag) {
            const float vv = Vs[kk * L.ldd + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < RQ; ++r) acc32[r][c] = fmaf(wr[r], vv, acc32[r][c]);
          }
        }
      }
    }
  }

  // out = num / (den + eps); den written as accumulated.
  T* ob = out + bh * N * D;
  if constexpr (kBf16) {
    __syncthreads();  // every warp is done reading Ss as scores
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = warp + WARPS * i;
      if (f < n_ofrag) {
        const int fm = f / n_dfrag;
        const int fn = f % n_dfrag;
        wmma::store_matrix_sync(Ss + (fm * 16) * L.lds + fn * 16, acc[i], L.lds, wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < rows_q * D; idx += THREADS) {
      const int a = idx / D;
      const int d = idx - a * D;
      ob[(size_t)(i0 + a) * D + d] = from_float<T>(Ss[a * L.lds + d] / (den_s[a] + EPS));
    }
  } else {
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int a = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < MAX_D / 16; ++c) {
        const int d = tx + 16 * c;
        if (c < n_dfrag && a < rows_q && d < D)
          ob[(size_t)(i0 + a) * D + d] = acc32[r][c] / (den_s[a] + EPS);
      }
    }
  }
  for (int a = tid; a < rows_q; a += THREADS) den[bh * N + i0 + a] = den_s[a];
}

template <typename T, int BQ, int BKV>
int launch_tiles(const void* q, const void* k, const void* v, const void* coeffs,
                 void* out, void* den, int B, int H, int N, int F, int D, void* stream) {
  const Layout L = make_layout<T, BQ, BKV>(F, D);
  if (L.bytes > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlc_fwd_kernel<T, BQ, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, H, B);
  mlc_fwd_kernel<T, BQ, BKV><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(coeffs), static_cast<T*>(out), static_cast<float*>(den),
      H, N, F, D);
  return cudaGetLastError();
}

bool bad_dims(int B, int H, int N, int F, int D) {
  return B <= 0 || H <= 0 || N <= 0 || F <= 0 || D <= 0 || D > MAX_D;
}

// The staged kernel a launch of T at (F, D) runs, its tile rows and its
// shared memory: 64-row tiles wherever they fit (always in bf16); fp32
// takes 32-row tiles only where the 64-row layout outgrows shared memory.
struct StagedChoice {
  const void* kernel;
  int rows;
  size_t bytes;
};

template <typename T>
StagedChoice staged_choice(int F, int D) {
  if constexpr (!is_bf16<T>()) {
    if (make_layout<T, BIG, BIG>(F, D).bytes > (size_t)MAX_SMEM)
      return {reinterpret_cast<const void*>(mlc_fwd_kernel<T, SMALL, SMALL>), SMALL,
              make_layout<T, SMALL, SMALL>(F, D).bytes};
  }
  return {reinterpret_cast<const void*>(mlc_fwd_kernel<T, BIG, BIG>), BIG,
          make_layout<T, BIG, BIG>(F, D).bytes};
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* coeffs,
           void* out, void* den, int B, int H, int N, int F, int D, void* stream) {
  (void)cudaGetLastError();  // start from a clean error state
  if (bad_dims(B, H, N, F, D)) return cudaErrorInvalidValue;
  if constexpr (!is_bf16<T>()) {
    if (staged_choice<T>(F, D).rows == SMALL)
      return launch_tiles<T, SMALL, SMALL>(q, k, v, coeffs, out, den, B, H, N, F, D, stream);
  }
  return launch_tiles<T, BIG, BIG>(q, k, v, coeffs, out, den, B, H, N, F, D, stream);
}

// ─── bf16: register-resident tiles on mma.sync ──────────────────────────

namespace fm = flash::mma;

// Geometry of mlc_fwd_mma_kernel: blocks of BM query rows, one warp per 16
// of them, against BN key/value rows a stage; features staged up to FMAX,
// values to DP. QREG: q' held as A fragments in registers for the sweep
// (else read by ldmatrix from its resident tile at every 16-step).
// Shared memory: a ring of two stages, each k' [BN, LDF] and v [BN, LDD]
// bf16 and the stage's coefficient window [WINP] fp32; and q' [BM, LDF]
// bf16, which with QREG is staged over the ring's second stage (and past
// it where it is the larger) and read once before that stage is first
// filled, else resident in front of the ring.
template <int FMAX_, int DP_, int BM_, int BN_, bool QREG_>
struct FwdMma {
  static constexpr int FMAX = FMAX_, DP = DP_, BM = BM_, BN = BN_;
  static constexpr bool QREG = QREG_;
  static constexpr int WARPS = BM / 16, NT = 32 * WARPS;
  static constexpr int KF = FMAX / 16;  // 16-steps of the score product
  static constexpr int NB = BN / 8;     // 8-column blocks of a warp's score rows
  static constexpr int LDF = FMAX + 8, LDD = DP + 8;
  static constexpr int WINP = (BM + BN - 1 + 3) / 4 * 4;
  static constexpr size_t Q = (size_t)BM * LDF * sizeof(bf16);
  static constexpr size_t STAGE =
      (size_t)BN * (LDF + LDD) * sizeof(bf16) + (size_t)WINP * sizeof(float);
  static constexpr size_t RING = QREG ? 0 : Q;  // offset of the ring
  static constexpr size_t Q_AT = QREG ? STAGE : 0;  // offset of q'
  static constexpr size_t BYTES = QREG ? STAGE + (Q > STAGE ? Q : STAGE) : Q + 2 * STAGE;
  static_assert(FMAX % 16 == 0 && DP % 16 == 0 && BM % 16 == 0 && BN % 16 == 0, "tile shapes");
  static_assert(Q % 16 == 0 && STAGE % 16 == 0 && (BN * LDF * sizeof(bf16)) % 16 == 0 &&
                    (BN * LDD * sizeof(bf16)) % 16 == 0, "regions start 16-byte aligned");
};

// out and den for one (BM-row query block, head, batch), bf16, even
// F <= FMAX, D <= DP. q' stays resident (with QREG as A fragments over F in
// registers); key/value stages (k', v and the coefficient window w[t] =
// c[j0 - i0 + N - BM + t] of the block and the stage) arrive through the
// two-stage cp.async ring. Warp w owns query rows 16 w..16 w + 15 and every
// column of a stage: per stage it computes S = q' k'^T in registers, then
// per fragment element, with T[a, b] = w[b - a + BM - 1] for the block's
// row a and the stage's row b, W = S * T (exactly 0 past N in either
// direction), adds W to this thread's fp32 row sums and packs round(W) as
// bf16 pairs, exactly the registers of the A fragments of acc += W v. Warps
// wholly past N skip the products after the ring's barrier. The row sums
// add over a fragment row's four lanes in a fixed shuffle order at the end;
// no float atomics, every sum in one order.
template <typename C>
__global__ void __launch_bounds__(C::NT)
mlc_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ coeffs,
                   bf16* __restrict__ out, float* __restrict__ den, int H, int N, int F,
                   int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + C::Q_AT);
  unsigned char* ring = smem + C::RING;

  const int i0 = blockIdx.x * C::BM;
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // the warp's first query row in the block
  const int fp = (F + 15) / 16 * 16;
  const int kf = fp / 16;  // 16-steps of the score product this F needs
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
  stage_words4<C::BM, C::NT>(Qs, C::LDF, fp, q + (bh * N + i0) * F, rows_q, F);
  stage_kv(0);
  fm::cp_async_commit();

  const bool warp_live = row0 < rows_q;  // the warp holds a query row below N
  const int r = lane / 4;                // this thread's fragment rows r, r + 8
  const int qc = 2 * (lane % 4);         // and columns qc, qc + 1 of each 8-column block
  const bool row_ok[2] = {row0 + r < rows_q, row0 + r + 8 < rows_q};
  // the A fragments of q': every 16-step's for the sweep (QREG), else one
  // 16-step's at a time
  uint32_t qf[C::QREG ? C::KF : 1][4];
  if constexpr (C::QREG) {
    fm::cp_async_wait<0>();
    __syncthreads();  // q' and stage 0 staged by every thread
#pragma unroll
    for (int kk = 0; kk < C::KF; ++kk)
      if (warp_live && kk < kf) fm::load_a(qf[kk], Qs, C::LDF, row0, kk * 16);
    // the loop's first barrier keeps q' in place until every warp holds it
  }

  float acc[C::DP / 8][4];
  fm::zero_acc(acc);
  float rs[2] = {0.f, 0.f};  // this thread's share of its rows' sums of W

  const int n_kv = (N + C::BN - 1) / C::BN;
  for (int js = 0; js < n_kv; ++js) {
    fm::cp_async_wait<0>();
    __syncthreads();  // stage js staged by every thread; stage js - 1's slot free
    if (js + 1 < n_kv) {
      stage_kv(js + 1);
      fm::cp_async_commit();
    }
    if (!warp_live) continue;
    const bf16* Kt = stage_of(js);
    const bf16* Vt = Kt + C::BN * C::LDF;
    const float* w_t = reinterpret_cast<const float*>(Vt + C::BN * C::LDD);
    const int j0 = js * C::BN;

    // S = q' k'^T over the 16-steps F needs
    float s[C::NB][4];
    fm::zero_acc(s);
#pragma unroll
    for (int kk = 0; kk < C::KF; ++kk) {
      if (kk >= kf) break;
      uint32_t(&a)[4] = qf[C::QREG ? kk : 0];
      if constexpr (!C::QREG) fm::load_a(a, Qs, C::LDF, row0, kk * 16);
#pragma unroll
      for (int np = 0; np < C::NB / 2; ++np) {
        uint32_t b[4];
        fm::load_b_rows(b, Kt, C::LDF, np * 16, kk * 16);
        fm::mma_bf16(s[2 * np], a, b[0], b[1]);
        fm::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    // per cell (query row a of the block, key/value row c of the stage):
    // W = S * T, exactly 0 past N; the row sums take W in fp32
    const bool ragged = j0 + C::BN > N || i0 + C::BM > N;
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = row0 + r + 8 * (e / 2);
        const int c = nb * 8 + qc + (e & 1);
        float w = s[nb][e] * w_t[c - a + C::BM - 1];
        if (ragged && !(row_ok[e / 2] && j0 + c < N)) w = 0.f;
        rs[e / 2] += w;
        s[nb][e] = w;
      }
    uint32_t wa[C::NB / 2][4];
    fm::to_a(wa, s);  // round(W) as A fragments
    fm::mma_a_cols<C::NB / 2, C::DP / 8>(acc, wa, Vt, C::LDD);  // acc += round(W) v
  }
  if (!warp_live) return;

  // den over the four lanes of a fragment row; out = acc / (den + eps)
  float dn[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float x = rs[half];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    dn[half] = x;
  }
#pragma unroll
  for (int nb = 0; nb < C::DP / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = acc[nb][e] / (dn[e / 2] + EPS);
  store_block<C::DP / 16>(out + bh * N * D, D, N, D, i0 + row0, 0, C::DP / 16, acc);
  if (lane % 4 == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (row_ok[half]) den[bh * N + i0 + row0 + r + 8 * half] = dn[half];
  }
}

// The bf16 instantiation: features up to 272 (F = 266), values up to 64,
// 128 query rows (8 warps) a block against 64-row key/value stages, q' in
// registers, picked by trial on an H100 (experiments/tile_trial.py,
// numbers in PERF.md).
using FwdChoice = FwdMma<272, 64, 128, 64, true>;

const void* fwd_mma_kernel() {
  return reinterpret_cast<const void*>(mlc_fwd_mma_kernel<FwdChoice>);
}

// Whether a bf16 forward launch at (F, D) runs mlc_fwd_mma_kernel; the
// staged kernel runs the rest (fp32, F > 272, odd F, D > 64).
bool fwd_mma_takes(int F, int D) { return F <= 272 && F % 2 == 0 && D <= 64; }

int launch_fwd_mma(const void* q, const void* k, const void* v, const void* coeffs, void* out,
                   void* den, int B, int H, int N, int F, int D, void* stream) {
  using C = FwdChoice;
  const auto kernel = mlc_fwd_mma_kernel<C>;
  (void)cudaGetLastError();  // start from a clean error state
  const int err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + C::BM - 1) / C::BM, H, B);
  kernel<<<grid, C::NT, C::BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(coeffs), static_cast<bf16*>(out), static_cast<float*>(den), H,
      N, F, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q', k' [B, H, N, F], v and out [B, H, N, D] in bf16; coeffs [H, 2N-1] and
// den [B, H, N] in fp32; all contiguous. Runs on `stream`, does not
// synchronise, allocates nothing. Returns the CUDA error code (0 = launched;
// cudaErrorInvalidValue for D > 128 or tiles that exceed shared memory: at
// D = 64, F above ~740 in bf16 and ~840 in fp32). The launch at even
// F <= 272, D <= 64 runs mlc_fwd_mma_kernel.
int mlc_fwd_bf16(const void* q, const void* k, const void* v, const void* coeffs,
                 void* out, void* den, int B, int H, int N, int F, int D, void* stream) {
  if (!bad_dims(B, H, N, F, D) && fwd_mma_takes(F, D))
    return launch_fwd_mma(q, k, v, coeffs, out, den, B, H, N, F, D, stream);
  return launch<bf16>(q, k, v, coeffs, out, den, B, H, N, F, D, stream);
}

// As mlc_fwd_bf16 with q', k', v and out in fp32.
int mlc_fwd_f32(const void* q, const void* k, const void* v, const void* coeffs,
                void* out, void* den, int B, int H, int N, int F, int D, void* stream) {
  return launch<float>(q, k, v, coeffs, out, den, B, H, N, F, D, stream);
}

// What a bf16 (is_bf16 = 1) or fp32 forward launch at (N, F, D) runs, in
// info[0..6]: rows per block, threads, dynamic shared memory bytes,
// resident blocks per SM, registers per thread, local (spilled) bytes per
// thread, and 1 for mlc_fwd_mma_kernel (0 for the staged kernel). Returns
// the CUDA error code (cudaErrorInvalidValue for bad arguments or a block
// that exceeds shared memory).
int mlc_fwd_launch_info(int N, int F, int D, int is_bf16, int* info) {
  if (bad_dims(1, 1, N, F, D)) return cudaErrorInvalidValue;
  if (is_bf16 && fwd_mma_takes(F, D))
    return fm::launch_info(fwd_mma_kernel(), FwdChoice::BM, FwdChoice::NT, FwdChoice::BYTES, true,
                           info);
  const StagedChoice c = is_bf16 ? staged_choice<bf16>(F, D) : staged_choice<float>(F, D);
  return fm::launch_info(c.kernel, c.rows, THREADS, c.bytes, false, info);
}

const char* mlc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
