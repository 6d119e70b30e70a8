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
// separate fp32 passes. This first version is simple rather than fast: one
// block per (q tile, head, batch) sweeping the kv tiles; at the first tile it
// stages q and Omega_h (rounded to the input dtype) and keeps phi_q in shared
// memory for the sweep; per kv tile it recomputes phi_k from the raw k tile
// (the price of fusion: the k-side projection is redone by every q tile of a
// head), then runs the unfused forward's S / W / den / value steps. bf16 takes
// 64-row tiles and WMMA products; its fp32 projection u is dead once phi is
// written, so the score and weight tiles live inside it (~210 KB at F = 266,
// D = 64). fp32 takes 32-row tiles, fp32 FMA products, and projects straight
// into the phi tiles (~165 KB). Loads do not overlap products: double
// buffering, wgmma and sharing phi_k between a head's q tiles are later work.

#include "kerple_common.cuh"

#include <cmath>

namespace {

using namespace kerple;

constexpr float EPS = 1e-6f;

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
  if (B <= 0 || H <= 0 || N <= 0 || D <= 0 || Dv <= 0 || F <= 0)
    return cudaErrorInvalidValue;
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

}  // namespace

extern "C" {

// q, k [B, H, N, D], v and out [B, H, N, Dv] in bf16; omega [H, D, F],
// coeffs [H, 2N-1] and den [B, H, N] in fp32; all contiguous. relu = 1 for
// phi_relu, 0 for phi+; scale = 1 / sqrt(F). Runs on `stream`, does not
// synchronise, allocates nothing. Returns the CUDA error code (0 = launched;
// cudaErrorInvalidValue for empty dims or tiles that exceed shared memory:
// at F = 266 both dtypes take D and Dv up to 64).
int kfp_fwd_bf16(const void* q, const void* k, const void* v, const void* omega,
                 const void* coeffs, void* out, void* den, int B, int H, int N, int D,
                 int Dv, int F, int relu, float scale, void* stream) {
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

const char* kfp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
