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
// What bounds it on an H100: bytes. At the ViT-B/16 serving shape
// (B=32, H=12, N=197, F=266, D=64, bf16) the call must move ~100 MB
// (q', k', v in; out, den out) against ~9.9 GFLOP, i.e. ~30 us at
// 3.35 TB/s versus ~10 us at the bf16 tensor-core peak. The design keeps
// the quadratic [N, N] work in shared memory and registers so device memory
// sees each input about once per query tile (the re-reads of k' and v by the
// ceil(N/64) query tiles of one head mostly hit L2). This first version is
// simple rather than fast: one block per (64-row query tile, head, batch)
// looping over 64-row kv tiles; each tile is staged in shared memory by
// 4-byte cp.async copies, all in flight before one wait (rows of F=266
// bf16 values are 4-byte but not 16-byte aligned); WMMA bf16 tensor-core
// products for bf16 inputs, fp32 FMA products for fp32 inputs (with 32-row
// tiles where the 64-row q' and k' tiles outgrow shared memory: favor_hyper's
// F = 532 in fp32; F = 266 keeps the 64-row tiles). Loads still
// do not overlap the products of the same block: double buffering, wgmma,
// TMA and a persistent schedule are later work.

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

// 64-row tiles wherever they fit (always in bf16); fp32 takes 32-row tiles
// only where the 64-row layout outgrows shared memory.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* coeffs,
           void* out, void* den, int B, int H, int N, int F, int D, void* stream) {
  (void)cudaGetLastError();  // start from a clean error state
  if (B <= 0 || H <= 0 || N <= 0 || F <= 0 || D <= 0 || D > MAX_D)
    return cudaErrorInvalidValue;
  if constexpr (!is_bf16<T>()) {
    if (make_layout<T, BIG, BIG>(F, D).bytes > (size_t)MAX_SMEM)
      return launch_tiles<T, SMALL, SMALL>(q, k, v, coeffs, out, den, B, H, N, F, D, stream);
  }
  return launch_tiles<T, BIG, BIG>(q, k, v, coeffs, out, den, B, H, N, F, D, stream);
}

}  // namespace

extern "C" {

// q', k' [B, H, N, F], v and out [B, H, N, D] in bf16; coeffs [H, 2N-1] and
// den [B, H, N] in fp32; all contiguous. Runs on `stream`, does not
// synchronise, allocates nothing. Returns the CUDA error code (0 = launched;
// cudaErrorInvalidValue for D > 128 or tiles that exceed shared memory: at
// D = 64, F above ~740 in bf16 and ~840 in fp32).
int mlc_fwd_bf16(const void* q, const void* k, const void* v, const void* coeffs,
                 void* out, void* den, int B, int H, int N, int F, int D, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, coeffs, out, den, B, H, N, F, D, stream);
}

// As mlc_fwd_bf16 with q', k', v and out in fp32.
int mlc_fwd_f32(const void* q, const void* k, const void* v, const void* coeffs,
                void* out, void* den, int B, int H, int N, int F, int D, void* stream) {
  return launch<float>(q, k, v, coeffs, out, den, B, H, N, F, D, stream);
}

const char* mlc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
