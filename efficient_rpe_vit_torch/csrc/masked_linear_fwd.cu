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
// only the mask differs: T may be any [H, N, N] fp32 matrix, not only a
// Toeplitz one, and no coefficient window is read.
//
// What bounds it on an H100: at the long-N shape (B=4, H=12, N=4097, F=266,
// D=64, bf16) operations, 2 B H N^2 (F + D) = 5.3e11, 0.54 ms at the bf16
// tensor-core peak, against 0.81 GB of T (0.24 ms); at the JAX A/B's ViT
// head dims (F=44, D=16) bytes, T's [H, N, N] and the q', k', v rows.
//
// bf16 (mlt_fwd_mma_kernel, even F <= 272, D <= 64, the coefficient
// kernels' rule) is #1's register-resident mainloop on mma.sync: one block
// per (batch, 128 query rows, head), one warp per 16 rows, q' held as mma A
// fragments, k' and v through a two-stage cp.async ring of 64-row stages;
// kerple_common.cuh's fwd_mma_stage forms S = q' k'^T, W = S * T and the
// fp32 row sums in registers and passes round(W) to W v as A fragments. The
// mask is the stage's template policy: where N % 4 == 0 (rows of T 16-byte
// aligned) the block's [128, 64] fp32 tile of T rides the ring beside k'
// and v as 16-byte words (row stride 72 floats, so a warp's 8-byte reads of
// an element pair fall on distinct banks; zero past N); elsewhere (odd N
// such as 197 and 4097, whose rows would move as 4-byte words) each thread
// loads its own 32 elements of T into registers in the accumulator layout,
// a stage ahead, right after the stage has read the previous ones. The
// batch is the fastest grid axis, so the B blocks that read one slab of T
// run together and T comes from device memory about once, not B times. Two
// instantiations by (F, D): features to 272 and values to 64, and F <= 64
// with D <= 16 (the JAX A/B's F = 44, D = 16), whose products skip the
// zero columns. Shapes, the two ways of reading T and the narrow
// instantiation were picked by trial (experiments/tile_trial.py, PERF.md).
// No float atomics: out and den are bitwise the same run to run.
//
// fp32 and the other shapes keep the first version, simple rather than
// fast: one block per (q tile, head, batch) looping over kv tiles with the
// shared tile products of kerple_common.cuh (WMMA bf16, fp32 FMA), 64-row
// tiles in bf16 and 32 in fp32 (halved where a large F outgrows shared
// memory), T's tile staged by 4-byte cp.async words, no load/compute
// overlap. launch_info reports which kernel a launch runs.

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

// ─── bf16: register-resident tiles on mma.sync, T through the ring ─────

namespace fm = flash::mma;

// Geometry of mlt_fwd_mma_kernel: blocks of BM query rows, one warp per 16
// of them, against BN key/value rows a stage; features staged up to FMAX,
// values to DP. Shared memory: a ring of two stages, each k' [BN, LDF] and
// v [BN, LDD] bf16 and, unless TREG, the stage's tile of T [BM, LDT] fp32;
// q' [BM, LDF] bf16 over the ring's second stage (and past it where it is
// the larger), read once as A fragments before that stage is first filled.
// TREG: each thread loads its own elements of T straight from device memory
// into registers in the accumulator layout, a stage ahead, instead.
template <int FMAX_, int DP_, int BM_, int BN_, bool TREG_>
struct TFwdMma {
  static constexpr int FMAX = FMAX_, DP = DP_, BM = BM_, BN = BN_;
  static constexpr bool TREG = TREG_;
  static constexpr int WARPS = BM / 16, NT = 32 * WARPS;
  static constexpr int KF = FMAX / 16;  // 16-steps of the score product
  static constexpr int NB = BN / 8;     // 8-column blocks of a warp's score rows
  static constexpr int LDF = FMAX + 8, LDD = DP + 8;
  // fp32 row stride of the T tile: a warp's 8-byte reads of a fragment
  // element pair (8 rows x 4 lanes) fall on distinct banks
  static constexpr int LDT = BN + 8;
  static constexpr size_t Q = (size_t)BM * LDF * sizeof(bf16);
  static constexpr size_t KV = (size_t)BN * (LDF + LDD) * sizeof(bf16);
  static constexpr size_t STAGE = KV + (TREG ? 0 : (size_t)BM * LDT * sizeof(float));
  static constexpr size_t BYTES = STAGE + (Q > STAGE ? Q : STAGE);
  static_assert(FMAX % 16 == 0 && DP % 16 == 0 && BM % 16 == 0 && BN % 16 == 0, "tile shapes");
  static_assert(Q % 16 == 0 && STAGE % 16 == 0 && KV % 16 == 0 && (BN * LDF * 2) % 16 == 0 &&
                    (LDT * 4) % 16 == 0, "regions and T's rows start 16-byte aligned");
};

// out and den for one (batch, BM-row query block, head), bf16, even
// F <= FMAX, D <= DP: mlc_fwd_mma_kernel (masked_linear_coeffs_fwd.cu) with
// the coefficient window replaced by the block's [BM, BN] tile of T, which
// rides the two-stage cp.async ring beside k' and v (16-byte words where
// N % 4 == 0, else 4-byte ones; zero past N), and with the batch as the
// fastest grid axis, so that the blocks sharing a tile of T run together
// and T comes from device memory about once. Warp w owns query rows
// 16 w.. 16 w + 15 and every column of a stage: per stage
// kerple_common.cuh's fwd_mma_stage computes S = q' k'^T in registers (q'
// held as mma A fragments for the sweep), W = S * T per fragment element
// (the T pair read as one 8-byte word, or from registers with TREG), the
// fp32 row sums, and acc += round(W) v with round(W) as the A fragments;
// fwd_mma_store writes out and den. No float atomics.
template <typename C>
__global__ void __launch_bounds__(C::NT)
mlt_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ t,
                   bf16* __restrict__ out, float* __restrict__ den, int H, int N, int F, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + C::STAGE);

  const size_t bh = (size_t)blockIdx.x * H + blockIdx.z;
  const int i0 = blockIdx.y * C::BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // the warp's first query row in the block
  const int fp = (F + 15) / 16 * 16;
  const int kf = fp / 16;  // 16-steps of the score product this F needs
  const int rows_q = min(C::BM, N - i0);
  const bf16* kh = k + bh * N * F;
  const bf16* vh = v + bh * N * D;
  const float* tb = t + (size_t)blockIdx.z * N * N;

  const auto stage_of = [&](int js) {
    return reinterpret_cast<bf16*>(smem + (js & 1) * C::STAGE);
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
  stage_words4<C::BM, C::NT>(Qs, C::LDF, fp, q + (bh * N + i0) * F, rows_q, F);
  stage_kv(0);
  fm::cp_async_commit();

  const bool warp_live = row0 < rows_q;  // the warp holds a query row below N
  const int r = lane / 4;                // this thread's fragment rows r, r + 8
  const bool row_ok[2] = {row0 + r < rows_q, row0 + r + 8 < rows_q};
  uint32_t qf[C::KF][4];  // the A fragments of q' over every 16-step
  float tf[C::TREG ? C::NB : 1][4];  // TREG: this thread's elements of the stage's T
  if constexpr (C::TREG) {
    if (warp_live) load_t_frag(tf, tb, i0 + row0, 0, N);
  }
  fm::cp_async_wait<0>();
  __syncthreads();  // q' and stage 0 staged by every thread
#pragma unroll
  for (int kk = 0; kk < C::KF; ++kk)
    if (warp_live && kk < kf) fm::load_a(qf[kk], Qs, C::LDF, row0, kk * 16);
  // the loop's first barrier keeps q' in place until every warp holds it

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
    const int j0 = js * C::BN;
    if constexpr (C::TREG) {
      // T's registers refilled for stage js + 1 once stage js has read them
      fwd_mma_stage<C::KF, C::NB, C::DP / 8, C::BM, true>(
          acc, rs, qf, Qs, C::LDF, kf, Kt, Vt, C::LDD, FragMask<C::NB>{tf}, row0, row_ok, i0,
          j0, N, [&] {
            if (js + 1 < n_kv) load_t_frag(tf, tb, i0 + row0, j0 + C::BN, N);
          });
    } else {
      const float* Tt = reinterpret_cast<const float*>(Vt + C::BN * C::LDD);
      fwd_mma_stage<C::KF, C::NB, C::DP / 8, C::BM, true>(
          acc, rs, qf, Qs, C::LDF, kf, Kt, Vt, C::LDD, TileMask{Tt, C::LDT}, row0, row_ok, i0,
          j0, N);
    }
  }
  if (!warp_live) return;
  fwd_mma_store<C::DP / 8>(acc, rs, row_ok, out + bh * N * D, den + bh * N, N, D, i0 + row0);
}

// The bf16 instantiations, picked by trial on an H100
// (experiments/tile_trial.py, numbers in PERF.md): 128 query rows (8 warps)
// against 64-row key/value stages; features up to 272 (F = 266) and values
// up to 64, and a narrow one whose score and value products skip the zero
// columns of the JAX A/B's head dims, F <= 64 with D <= 16 (F = 44,
// D = 16); each with T in registers where N is not a multiple of 4
// (fwd_t_in_registers), else staged in the ring.
template <bool TREG> using FwdWide = TFwdMma<272, 64, 128, 64, TREG>;
template <bool TREG> using FwdNarrow = TFwdMma<64, 16, 128, 64, TREG>;

// Where the forward holds T in registers: where T's rows are not 16-byte
// aligned and its ring stages would move T as 4-byte words.
bool fwd_t_in_registers(int N) { return N % 4 != 0; }

// Whether a bf16 launch at (F, D) runs mlt_fwd_mma_kernel (at even
// F <= 272, D <= 64, the rule of the coefficient kernels); the staged
// mlc_t_fwd_kernel runs the rest (fp32, F > 272, odd F, D > 64).
bool fwd_mma_takes(int F, int D) { return F <= 272 && F % 2 == 0 && D <= 64; }

// The instantiation a launch runs: its kernel, rows per block, threads and
// shared memory.
struct MmaChoice {
  const void* kernel;
  int rows, threads;
  size_t bytes;
};

template <typename C>
MmaChoice choice_of() {
  return {reinterpret_cast<const void*>(mlt_fwd_mma_kernel<C>), C::BM, C::NT, C::BYTES};
}

template <template <bool> class C>
MmaChoice choice_at(int N) {
  return fwd_t_in_registers(N) ? choice_of<C<true>>() : choice_of<C<false>>();
}

MmaChoice fwd_mma_choice(int N, int F, int D) {
  if (F <= FwdNarrow<false>::FMAX && D <= FwdNarrow<false>::DP) return choice_at<FwdNarrow>(N);
  return choice_at<FwdWide>(N);
}

int launch_fwd_mma(const void* q, const void* k, const void* v, const void* t, void* out,
                   void* den, int B, int H, int N, int F, int D, void* stream) {
  const MmaChoice c = fwd_mma_choice(N, F, D);
  const int err = flash::prepare(c.kernel, c.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (N + c.rows - 1) / c.rows, H);  // the batch fastest
  void* args[] = {&q, &k, &v, &t, &out, &den, &H, &N, &F, &D};
  return cudaLaunchKernel(c.kernel, grid, dim3(c.threads), args, c.bytes,
                          static_cast<cudaStream_t>(stream));
}

// The staged kernel's tile, from first_tile<T>() down to MIN_TILE: the
// largest whose block fits in shared memory.
template <typename T, int TILE = first_tile<T>()>
MmaChoice staged_choice(int F, int D) {
  const FwdLayout<T, TILE> L(F, D);
  if constexpr (TILE > MIN_TILE) {
    if (L.bytes > (size_t)MAX_SMEM) return staged_choice<T, TILE / 2>(F, D);
  }
  return {reinterpret_cast<const void*>(mlc_t_fwd_kernel<T, TILE>), TILE, THREADS, L.bytes};
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
  if (B > 0 && H > 0 && N > 0 && F > 0 && D > 0 && fwd_mma_takes(F, D)) {
    (void)cudaGetLastError();  // start from a clean error state
    return launch_fwd_mma(q, k, v, t, out, den, B, H, N, F, D, stream);
  }
  return checked_launch<bf16>(q, k, v, t, out, den, B, H, N, F, D, stream);
}

// As mlt_fwd_bf16 with q', k', v and out in fp32.
int mlt_fwd_f32(const void* q, const void* k, const void* v, const void* t, void* out,
                void* den, int B, int H, int N, int F, int D, void* stream) {
  return checked_launch<float>(q, k, v, t, out, den, B, H, N, F, D, stream);
}

// What a bf16 (is_bf16 = 1) or fp32 forward launch at (N, F, D) runs, in
// info[0..6]: rows per block, threads, dynamic shared memory bytes,
// resident blocks per SM, registers per thread, local (spilled) bytes per
// thread, and 1 for mlt_fwd_mma_kernel (0 for the staged kernel). Returns
// the CUDA error code (cudaErrorInvalidValue for bad arguments or a block
// that exceeds shared memory).
int mlt_fwd_launch_info(int N, int F, int D, int is_bf16, int* info) {
  if (N <= 0 || F <= 0 || D <= 0) return cudaErrorInvalidValue;
  const bool mma = is_bf16 && fwd_mma_takes(F, D);
  const MmaChoice c = mma ? fwd_mma_choice(N, F, D)
                          : is_bf16 ? staged_choice<bf16>(F, D) : staged_choice<float>(F, D);
  return fm::launch_info(c.kernel, c.rows, c.threads, c.bytes, mma, info);
}

const char* mlt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
