// KERPLE attention forward with the feature map computed in the kernel, for Hopper.
//
// Replaces the TPU kernel efficient_rpe_vit_tpu/ops/pallas/masked_linear_coeffs.py
// `_fused_phi_fwd_kernel` with `_phi_tile` (launched by `_fused_phi_fwd_impl`,
// public `kerple_attention_fused_phi`). From the raw, L2-normalised q and k
// [B, H, N, D], v [B, H, N, Dv], Omega [H, D, F] and coeffs [H, 2N - 1] (both
// fp32), with T[i, j] = c[h, j - i + N - 1] and x a row of q or k:
//
//   u        = x round(Omega)                   (Omega rounded to the input dtype,
//                                                fp32 accumulation)
//   phi+(x)  = exp(u - max_f u - ||x||^2 / 2) / sqrt(F)
//                                               (max over the F real lanes,
//                                                ||x||^2 from fp32 x)
//   phi_relu = relu(u) / sqrt(F)
//   S = round(phi_q) round(phi_k)^T            (rounded to the input dtype,
//                                                fp32 accumulation)
//   W = S * T, den = rowsum(W), num = round(W) v, out = num / (den + 1e-6)
//
// the unfused forward (masked_linear_coeffs_fwd.cu) from there on. Neither
// phi, T nor W reaches device memory. k rows past N and feature lanes past F
// are zeroed explicitly: phi+ of a zero row is exp(-max)/sqrt(F), not 0.
//
// What bounds it on an H100: bytes at the ViT-B/16 serving shape (B=32,
// H=12, N=197, D=64, F=266, bf16): q, k, v, out (~39 MB) against ~16 GFLOP
// of products (phi of q and k once, S and W v), about 12 us vs 16 us; the
// unfused route also writes and reads q' and k' (~80 MB more) and runs phi as
// separate fp32 passes.
//
// bf16 (kfp_fwd_mma_kernel, even F <= 272, D <= 64 with D % 8 == 0, Dv <= 64:
// the main path) is the unfused forward's register-resident kernel
// (mlc_fwd_mma_kernel) with phi built in front of its products, on
// flash_attention_mma.cuh's mma.sync fragments. One block per (BM query
// rows, head, batch), one warp per 16 of them. Omega_h is staged once,
// rounded to bf16 and zero past D and F ([D, F] row-major, read by
// ldmatrix.trans as the B operand of u = x Omega). Each warp loads its 16
// raw q rows as A fragments, takes ||x||^2 / 2 from them in fp32, projects
// u for the row max over the F real lanes, then applies phi one 16-column
// pair at a time and packs it as bf16 straight into the A fragments of the
// score product (the C fragment of two 8-column blocks is the A fragment of
// one 16-step): phi_q never touches shared memory. Raw k and v rows (128
// bytes at D = 64, copied as 16-byte cp.async words) and the stage's
// coefficient window w[t] = c[j0 - i0 + N - BM + t] (T[a, b] =
// w[b - a + BM - 1]) move through a two-stage ring, stage j + 1 copied while
// stage j is computed. Per stage phi_k is projected from the stage's raw k
// rows against the resident Omega by the same rules and written as bf16
// into a [BN, FMAX + 8] slot; then the unfused forward's stage runs against
// it (kerple_common.cuh's fwd_mma_stage: S = phi_q phi_k^T, W = S * T, fp32
// row sums, round(W) passed to W v in registers), and its epilogue
// (fwd_mma_store) ends the block. No float atomics, every sum in one order:
// out and den are bitwise the same run to run.
//
// What the shipped geometry does about the cost of phi (picked by trial,
// experiments/tile_trial.py, numbers in PERF.md): the two query blocks of a
// head form a cluster, and each builds half of every stage's phi_k tiles and
// stores them into both blocks' slots (distributed shared memory), so phi_k
// is built once per head, not once per query block as on the TPU; two slots
// alternate, so one cluster barrier a stage orders both the writes and the
// reuse. A tile's four warps split its column pairs and exchange row maxima
// behind a barrier of their own. u stays in registers from the max pass to
// the phi pass (phi_q: all 17 pairs, before any of phi_q's fragments exist;
// phi_k: a warp's 5 pairs), and pairs are projected in groups with the
// 16-steps outermost; phi is computed for every lane and then selected, so
// no branch sits around expf and a thread's exponentials overlap. What held
// the first version back: WMMA products with the fp32 projection, the scores
// and the weights all through shared memory, phi_k built a warp to a row,
// five barriers a kv tile and copies that never overlapped products.
//
// The rest (fp32, and bf16 outside the rule above) is the first version,
// simple rather than fast: one block per (q tile, head, batch) sweeping the
// kv tiles; at the first tile it stages q and Omega_h (rounded to the input
// dtype) and keeps phi_q in shared memory for the sweep; per kv tile it
// recomputes phi_k from the raw k tile, then runs the unfused forward's S /
// W / den / value steps. bf16 takes 64-row tiles and WMMA products; its fp32
// projection u is dead once phi is written, so the score and weight tiles
// live inside it (~210 KB at F = 266, D = 64). fp32 takes 32-row tiles, fp32
// FMA products, and projects straight into the phi tiles (~165 KB). Loads do
// not overlap products.

#include "kerple_common.cuh"

#include <cmath>

namespace {

using namespace kerple;

constexpr float EPS = 1e-6f;

bool bad_dims(int B, int H, int N, int D, int Dv, int F) {
  return B <= 0 || H <= 0 || N <= 0 || D <= 0 || Dv <= 0 || F <= 0;
}

// Rows per q tile and per kv tile: 64 for bf16; 32 for fp32, whose phi tiles
// and Omega take twice the bytes.
template <typename T>
__host__ __device__ constexpr int tile_rows() { return is_bf16<T>() ? 64 : 32; }

// Shared-memory layout, computed the same way on the host (launch size) and
// the device (offsets).
template <typename T>
struct Layout {
  static constexpr int TILE = tile_rows<T>();
  int fp, dp, dvp;    // staged feature, q/k and v columns
  int ldf;            // row stride of the phi tiles and of Omega's rows
  int ldx, ldv;       // row stride of the raw q/k tile and of the v tile
  int ldu;            // row stride of the fp32 projection (bf16; fp32 projects into phi)
  int lds, ldw, lda;  // fp32 scores, rounded weights, fp32 output accumulator
  size_t om, phq, phk, x, v, u, sc, w, acc, cw, den, bytes;
  __host__ __device__ Layout(int D, int Dv, int F) {
    if (is_bf16<T>()) {
      // WMMA fragments are 16 wide and start 32-byte aligned: columns are
      // zero-filled to 16, strides stay multiples of 8 elements (fp32: 4)
      // and the padding staggers rows across banks.
      fp = round_up(F, 16);
      dp = round_up(D, 16);
      dvp = round_up(Dv, 16);
      ldf = fp + 8;
      ldx = dp + 8;
      ldv = dvp + 8;
      ldu = fp + 4;
      lds = TILE + 4;
      ldw = TILE + 8;
      lda = dvp + 4;
    } else {
      // FMA loops read a column across 16 rows: odd strides spread them over
      // distinct banks. The weights overwrite the scores in place.
      fp = F;
      dp = D;
      dvp = Dv;
      ldf = F | 1;
      ldx = D | 1;
      ldv = Dv | 1;
      ldu = 0;
      lds = TILE + 1;
      ldw = lds;
      lda = Dv | 1;
    }
    Arena a;
    om = a.take<T>(dp * ldf);
    phq = a.take<T>(TILE * ldf);
    phk = a.take<T>(TILE * ldf);
    x = a.take<T>(TILE * ldx);
    v = a.take<T>(TILE * ldv);
    const size_t sc_bytes = align128(sizeof(float) * TILE * lds);
    const size_t w_bytes = is_bf16<T>() ? align128(sizeof(T) * TILE * ldw) : 0;
    const size_t u_bytes = align128(sizeof(float) * TILE * ldu);
    u = a.top;  // the scores and weights reuse the projection's bytes
    sc = u;
    w = is_bf16<T>() ? sc + sc_bytes : sc;
    a.top += u_bytes > sc_bytes + w_bytes ? u_bytes : sc_bytes + w_bytes;
    acc = a.take<float>(TILE * lda);
    cw = a.take<float>(2 * TILE - 1);
    den = a.take<float>(TILE);
    bytes = a.top;
  }
};

// C[ROWS, ncols] (fp32, row stride ldc) = A[ROWS, K] B[K, ncols], A and B
// row-major in shared memory. bf16: K and ncols are multiples of 16
// (zero-filled).
template <typename T, int ROWS>
__device__ __forceinline__ void project(float* C, int ldc, const T* A, int lda,
                                        const T* B, int ldb, int K, int ncols) {
  if constexpr (is_bf16<T>()) {
    using namespace nvcuda;
    constexpr int NM = ROWS / 16;
    const int nn = ncols / 16;
    const int warp = threadIdx.x / 32;
    for (int f = warp; f < NM * nn; f += WARPS) {
      const int fm = f / nn;
      const int fn = f % nn;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::load_matrix_sync(fa, A + (fm * 16) * lda + k0, lda);
        wmma::load_matrix_sync(fb, B + k0 * ldb + fn * 16, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(C + (fm * 16) * ldc + fn * 16, acc, ldc, wmma::mem_row_major);
    }
  } else {
    constexpr int R = ROWS / 16;
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    for (int c0 = 0; c0 < ncols; c0 += 64) {
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        float a[R], b[4];
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = A[(ty + 16 * r) * lda + kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + tx + 16 * c;
          b[c] = col < ncols ? B[kk * ldb + col] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + tx + 16 * c;
          if (col < ncols) C[(ty + 16 * r) * ldc + col] = acc[r][c];
        }
    }
  }
}

// Phi[TILE, fp] (input dtype) = phi of the staged raw rows X against the
// staged Omega; rows >= rows_valid and lanes >= F are zero. U is the bf16
// layout's fp32 projection scratch (fp32 projects into Phi itself). Begins
// after and ends with a barrier.
template <typename T>
__device__ __forceinline__ void feature_map(T* Phi, const Layout<T>& L, const T* X,
                                            const T* Om, float* U, int rows_valid,
                                            int D, int F, int relu, float scale) {
  constexpr int TILE = Layout<T>::TILE;
  float* u;
  int ldu;
  if constexpr (is_bf16<T>()) {
    u = U;
    ldu = L.ldu;
  } else {
    u = Phi;
    ldu = L.ldf;
  }
  project<T, TILE>(u, ldu, X, L.ldx, Om, L.ldf, L.dp, L.fp);  // u = x round(Omega)
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int a = warp; a < TILE; a += WARPS) {  // one warp per row
    const float* ua = u + a * ldu;
    T* pa = Phi + a * L.ldf;
    if (a >= rows_valid) {
      for (int c = lane; c < L.fp; c += 32) pa[c] = from_float<T>(0.f);
      continue;
    }
    float mx = -INFINITY;
    float nh = 0.f;
    if (!relu) {
      for (int c = lane; c < F; c += 32) mx = fmaxf(mx, ua[c]);
      for (int d = lane; d < D; d += 32) {
        const float xv = to_float(X[a * L.ldx + d]);
        nh = fmaf(xv, xv, nh);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        nh += __shfl_xor_sync(0xffffffffu, nh, o);
      }
      nh *= 0.5f;
    }
    // each lane reads its u elements before writing the same elements of
    // phi (fp32: the same addresses)
    for (int c = lane; c < L.fp; c += 32) {
      float p = 0.f;
      if (c < F) p = relu ? fmaxf(ua[c], 0.f) * scale : expf((ua[c] - mx) - nh) * scale;
      pa[c] = from_float<T>(p);
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
kfp_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ omega, const float* __restrict__ coeffs,
               T* __restrict__ out, float* __restrict__ den,
               int H, int N, int D, int Dv, int F, int relu, float scale) {
  constexpr int TILE = Layout<T>::TILE;
  const Layout<T> L(D, Dv, F);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Om = reinterpret_cast<T*>(smem + L.om);
  T* Phq = reinterpret_cast<T*>(smem + L.phq);
  T* Phk = reinterpret_cast<T*>(smem + L.phk);
  T* Xs = reinterpret_cast<T*>(smem + L.x);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* U = reinterpret_cast<float*>(smem + L.u);
  float* Ss = reinterpret_cast<float*>(smem + L.sc);
  T* Ws = reinterpret_cast<T*>(smem + L.w);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* cw = reinterpret_cast<float*>(smem + L.cw);
  float* den_s = reinterpret_cast<float*>(smem + L.den);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int i0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const int rows_q = min(TILE, N - i0);
  const float* cb = coeffs + (size_t)h * (2 * N - 1);

  // q tile (asynchronous) and Omega_h rounded to the input dtype, zero-filled
  load_tile<T, TILE>(Xs, L.ldx, L.dp, q + (bh * N + i0) * D, rows_q, D);
  const float* omh = omega + (size_t)h * D * F;
  for (int idx = tid; idx < L.dp * L.fp; idx += THREADS) {
    const int r = idx / L.fp;
    const int c = idx - r * L.fp;
    Om[r * L.ldf + c] = from_float<T>(r < D && c < F ? omh[(size_t)r * F + c] : 0.f);
  }
  for (int idx = tid; idx < TILE * L.lda; idx += THREADS) acc[idx] = 0.f;
  for (int a = tid; a < TILE; a += THREADS) den_s[a] = 0.f;
  cp_async_wait_all();
  __syncthreads();
  feature_map<T>(Phq, L, Xs, Om, U, rows_q, D, F, relu, scale);  // kept for the sweep

  const int n_kv = (N + TILE - 1) / TILE;
  for (int jt = 0; jt < n_kv; ++jt) {
    const int j0 = jt * TILE;
    const int rows_kv = min(TILE, N - j0);
    __syncthreads();  // the previous tile's readers of Xs, Vs and the weights are done
    load_tile<T, TILE>(Xs, L.ldx, L.dp, k + (bh * N + j0) * D, rows_kv, D);
    load_tile<T, TILE>(Vs, L.ldv, L.dvp, v + (bh * N + j0) * Dv, rows_kv, Dv);
    load_window<TILE>(cw, cb, i0, j0, N);
    cp_async_wait_all();
    __syncthreads();
    feature_map<T>(Phk, L, Xs, Om, U, rows_kv, D, F, relu, scale);
    scores<T, TILE>(Ss, L.lds, Phq, L.ldf, Phk, L.ldf, L.fp);  // S = phi_q phi_k^T
    __syncthreads();
    // W = S * T (masked past N), den += rowsum(W), W rounded to the input
    // dtype for the value product (fp32: in place)
    for (int r = 0; r < TILE / WARPS; ++r) {
      const int a = warp + WARPS * r;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < TILE / 32; ++c) {
        const int b = lane + 32 * c;
        float w = 0.f;
        if (a < rows_q && b < rows_kv) w = Ss[a * L.lds + b] * cw[b - a + TILE - 1];
        rs += w;
        Ws[a * L.ldw + b] = from_float<T>(w);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      if (lane == 0) den_s[a] += rs;
    }
    __syncthreads();
    accumulate<T, TILE, false>(acc, L.lda, Ws, L.ldw, Vs, L.ldv, L.dvp);  // num += W v
  }
  __syncthreads();

  // out = num / (den + eps); den written as accumulated
  T* ob = out + (bh * N + i0) * Dv;
  for (int idx = tid; idx < rows_q * Dv; idx += THREADS) {
    const int a = idx / Dv;
    const int d = idx - a * Dv;
    ob[idx] = from_float<T>(acc[a * L.lda + d] / (den_s[a] + EPS));
  }
  for (int a = tid; a < rows_q; a += THREADS) den[bh * N + i0 + a] = den_s[a];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* omega,
           const void* coeffs, void* out, void* den, int B, int H, int N, int D,
           int Dv, int F, int relu, float scale, void* stream) {
  (void)cudaGetLastError();  // start from a clean error state
  if (bad_dims(B, H, N, D, Dv, F)) return cudaErrorInvalidValue;
  const Layout<T> L(D, Dv, F);
  if (L.bytes > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kfp_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return err;
  constexpr int TILE = Layout<T>::TILE;
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  kfp_fwd_kernel<T><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(omega), static_cast<const float*>(coeffs),
      static_cast<T*>(out), static_cast<float*>(den), H, N, D, Dv, F, relu, scale);
  return cudaGetLastError();
}

// ─── bf16: phi built into mma.sync fragments, the unfused forward's stage ─

namespace fm = flash::mma;

// Geometry of kfp_fwd_mma_kernel: blocks of BM query rows, one warp per 16
// of them, against BN key/value rows a stage; features up to FMAX, head
// dims of q, k and v up to DP. CL: a head's query blocks in clusters of CL
// (1 or 2), each block building TILES / CL of a stage's 16-row phi_k tiles
// for all of them. SPLIT warps build each tile, splitting its 16-column
// pairs and exchanging their row maxima. UREG: u held in registers from the
// max pass to the phi pass (else projected again).
// Shared memory: Omega_h [DP, LDF] bf16, resident; SLOTS phi_k slots
// [BN, LDF] bf16, raw q [BM, LDX] staged in the last (read before that slot
// is first written); the row-max exchange [SPLIT, BN] fp32; a ring of two
// stages, each raw k and v [BN, LDX] bf16 and the stage's coefficient
// window [WINP] fp32.
template <int FMAX_, int DP_, int BM_, int BN_, int SPLIT_, bool UREG_, int CL_>
struct FusedMma {
  static constexpr int FMAX = FMAX_, DP = DP_, BM = BM_, BN = BN_, SPLIT = SPLIT_;
  static constexpr bool UREG = UREG_;
  static constexpr int CL = CL_;  // query blocks of a head in one cluster
  static constexpr int WARPS = BM / 16, NT = 32 * WARPS;
  static constexpr int KF = FMAX / 16;    // 16-column pairs of the features
  static constexpr int KD = DP / 16;      // 16-steps of the projection u = x Omega
  static constexpr int NB = BN / 8;       // 8-column blocks of a warp's score rows
  static constexpr int TILES = BN / 16;   // 16-row tiles of a stage's phi_k
  static constexpr int TPC = TILES / CL;  // of them built by each block of a cluster
  static constexpr int PHI_WARPS = TPC * SPLIT;           // warps that build phi_k
  static constexpr int SLOTS = CL > 1 ? 2 : 1;            // phi_k slots
  static constexpr int PAIRS = (KF + SPLIT - 1) / SPLIT;  // pairs per phi_k warp
  static constexpr int LDF = FMAX + 8, LDX = DP + 8;
  static constexpr int WINP = (BM + BN - 1 + 3) / 4 * 4;
  static constexpr size_t OM = (size_t)DP * LDF * sizeof(bf16);
  static constexpr size_t PHK_BYTES = (size_t)BN * LDF * sizeof(bf16);
  static constexpr size_t Q_BYTES = (size_t)BM * LDX * sizeof(bf16);
  // raw q is staged in the last slot, which a cluster's blocks first fill
  // after the first cluster barrier
  static constexpr size_t PHK =
      (SLOTS - 1) * PHK_BYTES + (PHK_BYTES > Q_BYTES ? PHK_BYTES : Q_BYTES);
  static constexpr size_t Q_AT = OM + (SLOTS - 1) * PHK_BYTES;
  static constexpr size_t MAXX = SPLIT > 1 ? (size_t)SPLIT * BN * sizeof(float) : 0;
  static constexpr size_t STAGE =
      (size_t)2 * BN * LDX * sizeof(bf16) + (size_t)WINP * sizeof(float);
  static constexpr size_t PHK_AT = OM, MAXX_AT = OM + PHK, RING = MAXX_AT + MAXX;
  static constexpr size_t BYTES = RING + 2 * STAGE;
  static_assert(FMAX % 16 == 0 && DP % 16 == 0 && BM % 16 == 0 && BN % 16 == 0, "tile shapes");
  static_assert(PHI_WARPS <= WARPS, "phi_k takes more warps than the block has");
  static_assert(!UREG || SPLIT > 1, "u of all 17 pairs would not stay in registers");
  static_assert(CL >= 1 && CL <= 2 && TILES % CL == 0, "one or two blocks to a cluster");
  static_assert(OM % 16 == 0 && PHK_BYTES % 16 == 0 && PHK % 16 == 0 && MAXX % 16 == 0 &&
                    STAGE % 16 == 0 &&
                    (BN * LDX * sizeof(bf16)) % 16 == 0, "regions start 16-byte aligned");
};

// Omega_h ([D, F] fp32, row-major) rounded to bf16 into Om [DP, LDF], zero at
// rows >= D and columns >= F. F is even, so a column pair is whole or wholly
// past F; each thread keeps up to 36 pairs' loads in flight (34 at the
// shipped shape: all of its loads, one round trip).
template <typename C>
__device__ __forceinline__ void stage_omega(bf16* Om, const float* __restrict__ om, int D,
                                            int F) {
  constexpr int PPR = C::FMAX / 2;  // column pairs per staged row
  constexpr int TOTAL = C::DP * PPR;
  constexpr int ITER = (TOTAL + C::NT - 1) / C::NT;
  constexpr int BATCH = ITER < 36 ? ITER : 36;
  const bool vec = (reinterpret_cast<uintptr_t>(om) & 7) == 0;
  for (int base = threadIdx.x; base < TOTAL; base += BATCH * C::NT) {
    float2 x[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int idx = base + u * C::NT;
      const int r = idx / PPR;
      const int c = 2 * (idx - r * PPR);
      x[u] = make_float2(0.f, 0.f);
      if (idx < TOTAL && r < D && c < F) {
        const float* src = om + (size_t)r * F + c;
        x[u] = vec ? __ldg(reinterpret_cast<const float2*>(src))
                   : make_float2(__ldg(src), __ldg(src + 1));
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int idx = base + u * C::NT;
      if (idx < TOTAL) {
        const int r = idx / PPR;
        const int c = 2 * (idx - r * PPR);
        *reinterpret_cast<__nv_bfloat162*>(Om + r * C::LDF + c) =
            __floats2bfloat162_rn(x[u].x, x[u].y);
      }
    }
  }
}

// u = x round(Omega) for a warp's 16 rows (x as A fragments over the kd
// 16-steps D needs) over the G feature pairs p0, p0 + step, ... below KF:
// u[g][0], u[g][1] the two 8-column accumulators of pair g. The 16-steps
// run outermost, so 2 G independent products are in flight, not a chain.
template <typename C, int G>
__device__ __forceinline__ void project_pairs(float (&u)[G][2][4],
                                              const uint32_t (&xa)[C::KD][4], int kd,
                                              const bf16* Om, int p0, int step) {
#pragma unroll
  for (int g = 0; g < G; ++g) fm::zero_acc(u[g]);
#pragma unroll
  for (int kk = 0; kk < C::KD; ++kk) {
    if (kk >= kd) break;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int p = p0 + g * step;
      if (p >= C::KF) break;
      uint32_t b[4];
      fm::load_b_cols(b, Om, C::LDF, kk * 16, p * 16);
      fm::mma_bf16(u[g][0], xa[kk], b[0], b[1]);
      fm::mma_bf16(u[g][1], xa[kk], b[2], b[3]);
    }
  }
}

// ||x||^2 / 2 of this thread's fragment rows r, r + 8 from the A fragments
// of x: fp32 squares of the bf16 elements, summed in one order (this
// thread's pairs, then the fragment row's four lanes).
template <typename C>
__device__ __forceinline__ void half_norms(float (&nh)[2], const uint32_t (&xa)[C::KD][4],
                                           int kd) {
  nh[0] = nh[1] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::KD; ++kk) {
    if (kk >= kd) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // registers 0, 2: row r; 1, 3: row r + 8
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[kk][j]));
      nh[j & 1] = fmaf(x.x, x.x, nh[j & 1]);
      nh[j & 1] = fmaf(x.y, x.y, nh[j & 1]);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    nh[half] += __shfl_xor_sync(0xffffffffu, nh[half], 1);
    nh[half] += __shfl_xor_sync(0xffffffffu, nh[half], 2);
    nh[half] *= 0.5f;
  }
}

// Fold pair p's u into this thread's row maxima over the F real lanes.
__device__ __forceinline__ void pair_max(float (&mx)[2], const float (&u)[2][4], int p, int F) {
  const int qc = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int hb = 0; hb < 2; ++hb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e / 2] = fmaxf(mx[e / 2], p * 16 + hb * 8 + qc + (e & 1) < F ? u[hb][e] : -INFINITY);
}

// The row maxima over a fragment row's four lanes (fmaxf: exact in any order).
__device__ __forceinline__ void quad_max(float (&mx)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
  }
}

// phi of one projected feature: relu(u) / sqrt(F), or exp((u - max) -
// ||x||^2 / 2) / sqrt(F) in that order of subtractions, with expf. Callers
// compute it for every lane and select 0 where a lane or row is not real:
// no branch around expf, so a thread's exponentials overlap.
template <bool RELU>
__device__ __forceinline__ float phi_of(float u, float mx, float nh, float scale) {
  if constexpr (RELU) return fmaxf(u, 0.f) * scale;
  return expf((u - mx) - nh) * scale;
}

// phi(q) of a warp's 16 query rows (raw rows row0.. of the staged tile Qs)
// as the A fragments of the score product: feature pair p, rounded to bf16
// and packed as to_a packs two 8-column accumulators, is qf[p]; lanes >= F
// are 0. With UREG, u of every pair stays in registers from the max pass to
// the phi pass: at most 136 values, before any of qf exists.
template <typename C, bool RELU>
__device__ __forceinline__ void phi_q_fragments(uint32_t (&qf)[C::KF][4], const bf16* Qs,
                                                const bf16* Om, int row0, int kd, int kf, int F,
                                                float scale) {
  const int qc = 2 * (threadIdx.x % 4);
  uint32_t xa[C::KD][4];
#pragma unroll
  for (int kk = 0; kk < C::KD; ++kk)
    if (kk < kd) fm::load_a(xa[kk], Qs, C::LDX, row0, kk * 16);
  constexpr int G = (C::KF + 1) / 2;          // feature pairs projected at once: two groups
  constexpr int NG = (C::KF + G - 1) / G;
  constexpr bool HOLD = C::UREG;              // u held from the max pass to the phi pass
  float uq[HOLD ? NG : 1][G][2][4];
  float nh[2] = {0.f, 0.f}, mx[2] = {0.f, 0.f};
  if constexpr (!RELU) {
    half_norms<C>(nh, xa, kd);
    mx[0] = mx[1] = -INFINITY;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      if (n * G >= kf) break;
      float(&u)[G][2][4] = uq[HOLD ? n : 0];
      project_pairs<C, G>(u, xa, kd, Om, n * G, 1);
#pragma unroll
      for (int g = 0; g < G; ++g) pair_max(mx, u[g], n * G + g, F);  // lanes >= F left out
    }
    quad_max(mx);
  }
#pragma unroll
  for (int n = 0; n < NG; ++n) {
    if (n * G >= kf) break;
    float(&u)[G][2][4] = uq[HOLD ? n : 0];
    if (!HOLD || RELU) project_pairs<C, G>(u, xa, kd, Om, n * G, 1);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int p = n * G + g;
      if (p >= C::KF) break;
#pragma unroll
      for (int hb = 0; hb < 2; ++hb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = phi_of<RELU>(u[g][hb][e], mx[e / 2], nh[e / 2], scale);
          u[g][hb][e] = p * 16 + hb * 8 + qc + (e & 1) < F ? x : 0.f;
        }
      qf[p][0] = fm::pack_bf16(u[g][0][0], u[g][0][1]);
      qf[p][1] = fm::pack_bf16(u[g][0][2], u[g][0][3]);
      qf[p][2] = fm::pack_bf16(u[g][1][0], u[g][1][1]);
      qf[p][3] = fm::pack_bf16(u[g][1][2], u[g][1][3]);
    }
  }
}

// This block's rank in its cluster, the cluster's barrier (every thread of
// both blocks; release / acquire order the shared-memory writes of either
// block before it against the reads after it), the shared::cluster address
// of the peer block's copy of a shared-memory location, and a 4-byte store
// there.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

__device__ __forceinline__ uint32_t peer_addr(const void* p, unsigned rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(fm::smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// phi(k) of a stage's BN raw k rows (Kt) into the slot Phk [BN, LDF], bf16:
// warp w < PHI_WARPS takes the 16-row tile TPC rank + w % TPC (rank: the
// block's in its cluster) and the feature pairs w / TPC + SPLIT i below kf,
// and with CL = 2 writes them into the peer block's slot too (peer: its
// shared::cluster address). Rows >= rows_valid (past N) and lanes >= F are
// exactly 0 (phi+ of a zero row is not). With SPLIT > 1 a tile's warps
// exchange their row maxima through maxx behind a barrier of their own.
template <typename C, bool RELU>
__device__ __forceinline__ void phi_k_stage(bf16* Phk, uint32_t peer, unsigned rank,
                                            const bf16* Kt, const bf16* Om, float* maxx,
                                            int rows_valid, int kd, int kf, int F, float scale) {
  const int warp = threadIdx.x / 32;
  if (warp >= C::PHI_WARPS) return;
  const int lane = threadIdx.x % 32;
  const int r = lane / 4;
  const int qc = 2 * (lane % 4);
  const int tile = warp % C::TPC;  // of this block's tiles
  const int part = warp / C::TPC;
  const int t0 = (rank * C::TPC + tile) * 16;  // the tile's first row in the stage
  const auto put = [&](int row, int col, uint32_t w) {
    const int at = row * C::LDF + col;
    *reinterpret_cast<uint32_t*>(Phk + at) = w;
    if constexpr (C::CL > 1) st_cluster(peer + at * (int)sizeof(bf16), w);
  };
  if (t0 >= rows_valid) {    // wholly past N (the same for every warp of the tile)
    for (int i = 0; i < C::PAIRS; ++i) {
      const int p = part + i * C::SPLIT;
      if (p >= kf) break;
#pragma unroll
      for (int hb = 0; hb < 2; ++hb)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          put(t0 + r + 8 * half, p * 16 + hb * 8 + qc, 0u);
    }
    return;
  }
  uint32_t xa[C::KD][4];
#pragma unroll
  for (int kk = 0; kk < C::KD; ++kk)
    if (kk < kd) fm::load_a(xa[kk], Kt, C::LDX, t0, kk * 16);
  constexpr int G = C::PAIRS < 5 ? C::PAIRS : 5;  // feature pairs projected at once
  constexpr int NG = (C::PAIRS + G - 1) / G;      // groups of this warp's pairs
  constexpr int STRIDE = G * C::SPLIT;             // pairs from one group to the next
  float uk[C::UREG ? NG : 1][G][2][4];             // UREG: u of this warp's pairs
  float nh[2] = {0.f, 0.f}, mx[2] = {0.f, 0.f};
  if constexpr (!RELU) {
    half_norms<C>(nh, xa, kd);
    mx[0] = mx[1] = -INFINITY;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      const int p0 = part + n * STRIDE;
      if (p0 >= kf) break;
      float(&u)[G][2][4] = uk[C::UREG ? n : 0];
      project_pairs<C, G>(u, xa, kd, Om, p0, C::SPLIT);
#pragma unroll
      for (int g = 0; g < G; ++g) pair_max(mx, u[g], p0 + g * C::SPLIT, F);
    }
    quad_max(mx);
    if constexpr (C::SPLIT > 1) {
      if (lane % 4 == 0) {
        maxx[part * C::BN + t0 + r] = mx[0];
        maxx[part * C::BN + t0 + r + 8] = mx[1];
      }
      // the tile's SPLIT warps, named barrier 1 + tile (0 is __syncthreads)
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + tile), "r"(32 * C::SPLIT) : "memory");
#pragma unroll
      for (int sp = 0; sp < C::SPLIT; ++sp) {
        mx[0] = fmaxf(mx[0], maxx[sp * C::BN + t0 + r]);
        mx[1] = fmaxf(mx[1], maxx[sp * C::BN + t0 + r + 8]);
      }
    }
  }
  const bool ok[2] = {t0 + r < rows_valid, t0 + r + 8 < rows_valid};
#pragma unroll
  for (int n = 0; n < NG; ++n) {
    const int p0 = part + n * STRIDE;
    if (p0 >= kf) break;
    float(&u)[G][2][4] = uk[C::UREG ? n : 0];
    if (!C::UREG || RELU) project_pairs<C, G>(u, xa, kd, Om, p0, C::SPLIT);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int p = p0 + g * C::SPLIT;
      if (p >= kf) break;
#pragma unroll
      for (int hb = 0; hb < 2; ++hb)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = p * 16 + hb * 8 + qc;
          const float x0 = phi_of<RELU>(u[g][hb][2 * half], mx[half], nh[half], scale);
          const float x1 = phi_of<RELU>(u[g][hb][2 * half + 1], mx[half], nh[half], scale);
          put(t0 + r + 8 * half, col,
              fm::pack_bf16(ok[half] && col < F ? x0 : 0.f, ok[half] && col + 1 < F ? x1 : 0.f));
        }
    }
  }
}

// out and den for one (BM-row query block, head, batch), bf16, even
// F <= FMAX, D <= DP with D % 8 == 0 (16-byte rows), Dv <= DP: phi_q built
// into A fragments, then per stage phi_k from the stage's raw k rows and the
// unfused forward's stage against it (see the note at the top of the file).
// Warps wholly past N, and every warp of a block that only pads a cluster
// (rows_q <= 0), build phi_k with the others and skip the rest.
template <typename C, bool RELU>
__global__ void __launch_bounds__(C::NT)
kfp_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ omega,
                   const float* __restrict__ coeffs, bf16* __restrict__ out,
                   float* __restrict__ den, int H, int N, int D, int Dv, int F, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Om = reinterpret_cast<bf16*>(smem);
  bf16* Qs = reinterpret_cast<bf16*>(smem + C::Q_AT);  // raw q, read before phi_k fills its slot
  float* maxx = reinterpret_cast<float*>(smem + C::MAXX_AT);
  unsigned char* ring = smem + C::RING;

  const int i0 = blockIdx.x * C::BM;
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * H + h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // the warp's first query row in the block
  const int kf = (F + 15) / 16;  // feature pairs this F needs
  const int kd = (D + 15) / 16;  // 16-steps of the projection this D needs
  const int rows_q = min(C::BM, N - i0);  // <= 0 in a cluster's padding block
  const unsigned rank = C::CL > 1 ? cluster_rank() : 0;
  const bf16* kh = k + bh * N * D;
  const bf16* vh = v + bh * N * Dv;
  const float* cb = coeffs + (size_t)h * (2 * N - 1);

  const auto stage_of = [&](int js) {
    return reinterpret_cast<bf16*>(ring + (js & 1) * C::STAGE);
  };
  const auto stage_kv = [&](int js) {
    bf16* Kt = stage_of(js);
    bf16* Vt = Kt + C::BN * C::LDX;
    float* w_t = reinterpret_cast<float*>(Vt + C::BN * C::LDX);
    const int j0 = js * C::BN;
    const int rows = min(C::BN, N - j0);
    fm::stage_rows<C::BN, C::NT>(Kt, C::LDX, C::DP, kh + (size_t)j0 * D, rows, D);
    fm::stage_rows<C::BN, C::NT>(Vt, C::LDX, C::DP, vh + (size_t)j0 * Dv, rows, Dv);
    const long long base = (long long)j0 - i0 + N - C::BM;
    for (int t = threadIdx.x; t < C::WINP; t += C::NT) {
      const long long m = base + t;
      const bool valid = m >= 0 && m < 2LL * N - 1;
      cp_async4(w_t + t, valid ? cb + m : cb, valid ? 4 : 0);
    }
  };
  if (rows_q > 0) fm::stage_rows<C::BM, C::NT>(Qs, C::LDX, C::DP, q + (bh * N + i0) * D, rows_q, D);
  stage_kv(0);
  fm::cp_async_commit();
  stage_omega<C>(Om, omega + (size_t)h * D * F, D, F);  // while the copies fly
  fm::cp_async_wait<0>();
  // Omega, raw q and stage 0 staged by every thread (CL = 2: and both blocks
  // of the cluster running before either writes into the other's phi_k slot)
  if constexpr (C::CL > 1) cluster_sync(); else __syncthreads();

  const bool warp_live = row0 < rows_q;  // the warp holds a query row below N
  const int r = lane / 4;                // this thread's fragment rows r, r + 8
  const bool row_ok[2] = {row0 + r < rows_q, row0 + r + 8 < rows_q};
  uint32_t qf[C::KF][4];  // phi(q) as the A fragments of every 16-step
  if (warp_live) phi_q_fragments<C, RELU>(qf, Qs, Om, row0, kd, kf, F, scale);
  // raw q's slot is first written after the loop's first barrier (CL = 1)
  // or first cluster barrier (CL = 2: slot 1, in stage 1), which every warp
  // reaches with phi_q built

  float acc[C::DP / 8][4];
  fm::zero_acc(acc);
  float rs[2] = {0.f, 0.f};  // this thread's share of its rows' sums of W

  const int n_kv = (N + C::BN - 1) / C::BN;
  for (int js = 0; js < n_kv; ++js) {
    fm::cp_async_wait<0>();
    __syncthreads();  // stage js staged by every thread; stage js - 1's readers done
    if (js + 1 < n_kv) {
      stage_kv(js + 1);
      fm::cp_async_commit();
    }
    const bf16* Kt = stage_of(js);
    const bf16* Vt = Kt + C::BN * C::LDX;
    const float* w_t = reinterpret_cast<const float*>(Vt + C::BN * C::LDX);
    const int j0 = js * C::BN;
    bf16* Phk = reinterpret_cast<bf16*>(smem + C::PHK_AT + (js % C::SLOTS) * C::PHK_BYTES);
    const uint32_t peer = C::CL > 1 ? peer_addr(Phk, rank ^ 1) : 0;
    phi_k_stage<C, RELU>(Phk, peer, rank, Kt, Om, maxx, min(C::BN, N - j0), kd, kf, F, scale);
    // phi_k written (CL = 2: both halves, into both blocks; the slot written
    // next was last read before this barrier by either block)
    if constexpr (C::CL > 1) cluster_sync(); else __syncthreads();
    if (!warp_live) continue;
    fwd_mma_stage<C::KF, C::NB, C::DP / 8, C::BM, true>(
        acc, rs, qf, nullptr, C::LDF, kf, Phk, Vt, C::LDX, WindowMask<C::BM>{w_t}, row0, row_ok,
        i0, j0, N);
  }
  if (!warp_live) return;
  fwd_mma_store<C::DP / 8>(acc, rs, row_ok, out + bh * N * Dv, den + bh * N, N, Dv, i0 + row0);
}

// The bf16 instantiation: features up to 272 (F = 266), head dims up to 64,
// 128 query rows (8 warps) a block against 64-row key/value stages, a
// head's query blocks in clusters of two that each build half of a stage's
// phi_k (four warps to each of its two 16-row tiles, u held in registers),
// picked by trial on an H100 (experiments/tile_trial.py, numbers in
// PERF.md).
using FusedChoice = FusedMma<272, 64, 128, 64, 4, true, 2>;

// The phi+ instantiation (the main path's; launch_info reports it).
const void* fwd_mma_kernel() {
  return reinterpret_cast<const void*>(kfp_fwd_mma_kernel<FusedChoice, false>);
}

// Whether a bf16 launch at (F, D, Dv) runs kfp_fwd_mma_kernel: even
// F <= 272, D <= 64 with D % 8 == 0 (q and k rows of 16-byte multiples),
// Dv <= 64. The staged kernel runs the rest (and fp32).
bool kfp_mma_takes(int F, int D, int Dv) {
  return F <= 272 && F % 2 == 0 && D <= 64 && D % 8 == 0 && Dv <= 64;
}

int launch_fwd_mma(const void* q, const void* k, const void* v, const void* omega,
                   const void* coeffs, void* out, void* den, int B, int H, int N, int D,
                   int Dv, int F, int relu, float scale, void* stream) {
  using C = FusedChoice;
  const auto kernel = relu ? kfp_fwd_mma_kernel<C, true> : kfp_fwd_mma_kernel<C, false>;
  (void)cudaGetLastError();  // start from a clean error state
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::BYTES);
  if (err != cudaSuccess) return err;
  // a head's query blocks in clusters of CL (padded with a block past N)
  const int blocks = (N + C::BM - 1) / C::BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((blocks + C::CL - 1) / C::CL * C::CL, H, B);
  cfg.blockDim = dim3(C::NT);
  cfg.dynamicSmemBytes = C::BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = C::CL;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q),
                            static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                            static_cast<const float*>(omega), static_cast<const float*>(coeffs),
                            static_cast<bf16*>(out), static_cast<float*>(den), H, N, D, Dv, F,
                            scale);
}

}  // namespace

extern "C" {

// q, k [B, H, N, D], v and out [B, H, N, Dv] in bf16; omega [H, D, F],
// coeffs [H, 2N-1] and den [B, H, N] in fp32; all contiguous. relu = 1 for
// phi_relu, 0 for phi+; scale = 1 / sqrt(F). Runs on `stream`, does not
// synchronise, allocates nothing. Returns the CUDA error code (0 = launched;
// cudaErrorInvalidValue for empty dims or tiles that exceed shared memory:
// at F = 266 both dtypes take D and Dv up to 64). The launch at even
// F <= 272, D <= 64 with D % 8 == 0 and Dv <= 64 runs kfp_fwd_mma_kernel.
int kfp_fwd_bf16(const void* q, const void* k, const void* v, const void* omega,
                 const void* coeffs, void* out, void* den, int B, int H, int N, int D,
                 int Dv, int F, int relu, float scale, void* stream) {
  if (!bad_dims(B, H, N, D, Dv, F) && kfp_mma_takes(F, D, Dv))
    return launch_fwd_mma(q, k, v, omega, coeffs, out, den, B, H, N, D, Dv, F, relu, scale,
                          stream);
  return launch<bf16>(q, k, v, omega, coeffs, out, den, B, H, N, D, Dv, F, relu, scale,
                      stream);
}

// As kfp_fwd_bf16 with q, k, v and out in fp32.
int kfp_fwd_f32(const void* q, const void* k, const void* v, const void* omega,
                const void* coeffs, void* out, void* den, int B, int H, int N, int D,
                int Dv, int F, int relu, float scale, void* stream) {
  return launch<float>(q, k, v, omega, coeffs, out, den, B, H, N, D, Dv, F, relu, scale,
                       stream);
}

// What a bf16 (is_bf16 = 1) or fp32 launch at (N, F, D), with Dv = D,
// runs, in info[0..6]: rows per block, threads, dynamic shared memory bytes,
// resident blocks per SM, registers per thread, local (spilled) bytes per
// thread, and 1 for kfp_fwd_mma_kernel (0 for the staged kernel). Returns
// the CUDA error code (cudaErrorInvalidValue for bad arguments or a block
// that exceeds shared memory).
int kfp_fwd_launch_info(int N, int F, int D, int is_bf16, int* info) {
  if (bad_dims(1, 1, N, D, D, F)) return cudaErrorInvalidValue;
  if (is_bf16 && kfp_mma_takes(F, D, D))
    return fm::launch_info(fwd_mma_kernel(), FusedChoice::BM, FusedChoice::NT,
                           FusedChoice::BYTES, true, info);
  if (is_bf16)
    return fm::launch_info(reinterpret_cast<const void*>(kfp_fwd_kernel<bf16>),
                           tile_rows<bf16>(), THREADS, Layout<bf16>(D, D, F).bytes, false, info);
  return fm::launch_info(reinterpret_cast<const void*>(kfp_fwd_kernel<float>),
                         tile_rows<float>(), THREADS, Layout<float>(D, D, F).bytes, false, info);
}

const char* kfp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
