// Circulant-STRING rotation along the head dim for Hopper, forward and
// backward.
//
// Replaces the TPU kernels efficient_rpe_vit_tpu/ops/pallas/rotation_kernels.py
// `_rot_kernel` (launched by `_rot_fwd_impl`) and `_bwd_kernel` (launched by
// `_cr_bwd`), public `circulant_rotate`. Per row x [D] of (b, h, n), with
// h = D/2, K = h + 1 frequencies and the angle tables ct = cos(theta),
// st = sin(theta) [H, N, K]:
//
//   x_re = x C_f,  x_im = -(x S_f)                      (rfft as DFT products)
//   y_re = ct x_re - st x_im,  y_im = st x_re + ct x_im  (rotate each frequency)
//   y    = y_re C_b - y_im S_b                          (irfft)
//
// and the backward from the cotangent g:
//
//   dy_re = g C_b^T,  dy_im = -(g S_b^T)
//   dx    = (ct dy_re + st dy_im) C_f^T - (-st dy_re + ct dy_im) S_f^T
//   dct  += dy_re x_re + dy_im x_im,  dst += dy_im x_re - dy_re x_im  (sum over b)
//
// With keep_cls, global row 0 passes through bit for bit (y = x, dx = g) and
// its angle gradients are 0. All arithmetic is fp32 whatever the input dtype.
//
// The constants come from the host, built by the same formula as the JAX
// package's `_rdft_matrices`, as two matrices over the S = D + 2 spectrum
// columns ordered [re_0 .. re_{h-1}, im_0 .. im_{h-1}, re_h, im_h]:
// fm = [C_f | -S_f] [D, S] and bm = [C_b ; -S_b] [S, D]. K is not padded
// to D (the TPU kernel padded it as a lane-width workaround). The backward
// needs the transposes of both; since C_b[k][d] = (w_k / D) C_f[d][k] (w_k
// = 1 at k = 0 and k = h, else 2), it takes g fm scaled by w / D for
// g [C_b ; -S_b]^T, and scales the rotated spectrum by D / w before bm for
// [C_f | -S_f]^T: the same two matrices in the same orientation.
//
// Two kernels of each direction, a documented dispatch by dtype, head dim
// and layout (circulant_rotate_launch_info reports which one a launch
// runs); a launch that fails raises, it never falls back.
//
// bf16 at D a multiple of 16 up to 64, with element strides that are
// multiples of 8 and 16-byte aligned rows (rot_mma_takes; the main paths'
// D = 64 head-split views): rot_fwd_mma_kernel / rot_bwd_mma_kernel, on
// mma.sync.m16n8k16 tensor-core products (csrc/flash_attention_mma.cuh).
// A block owns one (head, 128-row tile) and walks its batch group; each of
// its 8 warps owns 16 rows and runs on its own after one barrier:
//   - the spectrum columns are interleaved, column 2k = re_k and 2k+1 =
//     im_k, with the Nyquist re_h in column 1 (im_0 and im_h are zero: sin
//     vanishes there), so D columns hold the K frequencies and a thread's
//     m16n8 accumulator holds a frequency's re and im side by side: the
//     rotation is register-local, and two n8 tiles are the k16 A fragment
//     of the inverse product;
//   - fp32 accuracy from bf16 tensor cores by split products: each
//     constant is hi = bf16(c) plus lo = bf16(c - hi) (built in shared
//     memory from the fp32 fm, bm at block start); x and g are bf16 and
//     exact, so a spectrum is x fm_hi + x fm_lo; the rotated fp32 spectrum
//     s is split the same way and the inverse is s_hi bm_hi + s_lo bm_hi +
//     s_hi bm_lo (about 2^-16 relative, against 2^-9 for one bf16 pass);
//   - ct and st of a thread's rows and frequencies stay in registers across
//     the batch loop (the TPU grid's innermost-batch residency); the
//     backward's angle gradients accumulate there too, in batch order;
//   - rows move by 16-byte cp.async through a two-stage ring per warp (the
//     next batch element's rows load while this one's products run), A
//     fragments by ldmatrix, and the output goes back through the same
//     slot as 16-byte coalesced stores. Under keep_cls row 0 is the staged
//     input row, bit for bit; rows past N load as zeros and are not stored.
// The backward runs the forward's spectrum on g and x together (sharing
// the constants' fragments), and takes dx through the same inverse.
//
// Every other launch (fp32, D = 80, D = 4k, unaligned strides) runs the
// staged kernels rot_fwd_kernel / rot_bwd_kernel, the first design: fp32
// FMA block products from transposed fp32 tiles in shared memory, one
// block per (tile of rows, head, batch group) looping over its batches,
// each thread a block of 4 columns by 4 rows (forward at D <= 64) or 2 rows
// (the backward, and D = 128) of each product, the two Nyquist columns as
// plain dots; at D = 64 a tile is 64 rows forward, 32 backward.
//
// Both backward kernels sum the angle gradients over a batch group in
// order in the block, and across batch groups in a second, fixed-order sum
// kernel (group_sum_kernel): no float atomics, so the gradients are
// bitwise reproducible.
//
// What bounds it on an H100: at ViT-B (D = 64, K = 33, bf16) a row is 128
// bytes in and 128 out (the backward 256 in) against a [64 x 66] transform
// each way. On the tensor cores, even as the three split products, the
// DFTs take less time than moving the bytes (B = 32, H = 12, N = 197:
// 3.8 GFLOP, 3.9 us at 989 TFLOP/s, against 20.0 MB, 6.0 us at 3.35 TB/s),
// so the bytes bound it at every main-path shape (chip_smoke.py's
// rotation_bounds; times in PERF.md, NVIDIA H100 80GB HBM3, 700.00 W).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

#include "flash_attention_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_D = 128;                  // largest head dim a launch takes
constexpr int MAX_SMEM = 232448;            // dynamic shared memory one block may use on sm_90
constexpr int TARGET_BLOCKS = 4 * 132;      // four blocks on each of the H100's 132 SMs

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Rows of a thread's product block: the forward takes 4 (2 at D = 128, for
// shared memory); the backward 2, so that at D = 64 its 89 KB block leaves
// room for two on an SM (one at 4 rows: 139 KB). Measured on an H100 at
// ViT-B shapes: 2 rows cut the backward by a fifth and slow the forward by
// a sixth (PERF.md).
__host__ __device__ constexpr int fwd_rows_per_thread(int D) { return D <= 64 ? 4 : 2; }
constexpr int BWD_ROWS_PER_THREAD = 2;

// Tile geometry for head dim D (a multiple of 4, at most 128) and rb rows
// per thread.
struct Geometry {
  int D, h, K, S;   // head dim, D / 2, frequencies, spectrum columns
  int cg, rows;     // column groups of 4 (D / 4), rows per tile
  int ldf;          // row stride of fm [D][S] (S rounded up to 4)
  int ldt;          // row stride of transposed tiles [col][rows + 4]
  int lda;          // row stride of [K][rows + 1] angle-gradient sums
  __host__ __device__ Geometry(int D_, int rb) {
    D = D_;
    h = D / 2;
    K = h + 1;
    S = D + 2;
    cg = D / 4;
    rows = THREADS / cg * rb;
    ldf = (S + 3) / 4 * 4;
    ldt = rows + 4;
    lda = rows + 1;
  }
  __device__ int re(int k) const { return k < h ? k : D; }
  __device__ int im(int k) const { return k < h ? h + k : D + 1; }
};

// Bump allocator over the dynamic shared memory, run identically on the
// host (launch size) and the device (offsets).
struct Arena {
  size_t top = 0;
  __host__ __device__ size_t take_floats(size_t count) {
    const size_t at = top;
    top = align128(top + sizeof(float) * count);
    return at;
  }
};

// Shared-memory layout (offsets in bytes).
struct Layout {
  size_t fm, bm, ct, st, x, spec, g, xspec, acc_c, acc_s, bytes;
  __host__ __device__ Layout(const Geometry& q, bool backward) {
    Arena a;
    fm = a.take_floats((size_t)q.D * q.ldf);
    bm = a.take_floats((size_t)q.S * q.D);
    ct = a.take_floats((size_t)q.K * q.rows);
    st = a.take_floats((size_t)q.K * q.rows);
    x = a.take_floats((size_t)q.D * q.ldt);
    spec = a.take_floats((size_t)q.S * q.ldt);
    g = xspec = acc_c = acc_s = 0;
    if (backward) {
      g = a.take_floats((size_t)q.D * q.ldt);
      xspec = a.take_floats((size_t)q.S * q.ldt);
      acc_c = a.take_floats((size_t)q.K * q.lda);
      acc_s = a.take_floats((size_t)q.K * q.lda);
    }
    bytes = a.top;
  }
};

struct Params {
  int B, H, N, D;
  int keep_cls;
  int groups, per_group;         // batch groups (grid z) and batches per group
  long long xb, xh, xn;          // element strides of x (its last dim is contiguous)
  long long gb, gh, gn;          // element strides of g (backward)
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// Four consecutive values of a row in global memory, in T.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

template <int RB>
__device__ __forceinline__ void load_rows(float (&a)[RB], const float* p) {
  if constexpr (RB == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x; a[1] = v.y;
  }
}

// acc[a][i][j] = sum_kk A_a[kk][row0 + i] M[kk][col0 + j] for the NA
// transposed operand tiles A_a (row stride lda) against one row-major matrix
// M (row stride ldm), kk in order.
template <int RB, int NA>
__device__ __forceinline__ void block_product(float (&acc)[NA][RB][4], const float* const* A,
                                              int lda, const float* M, int ldm, int kdim,
                                              int row0, int col0) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < kdim; ++kk) {
    const float4 m = *reinterpret_cast<const float4*>(M + kk * ldm + col0);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      float av[RB];
      load_rows<RB>(av, A[a] + kk * lda + row0);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        acc[a][i][0] = fmaf(av[i], m.x, acc[a][i][0]);
        acc[a][i][1] = fmaf(av[i], m.y, acc[a][i][1]);
        acc[a][i][2] = fmaf(av[i], m.z, acc[a][i][2]);
        acc[a][i][3] = fmaf(av[i], m.w, acc[a][i][3]);
      }
    }
  }
}

// The spectra of NA transposed [D][rows] tiles into transposed [S][rows]
// tiles: the first D columns by block products, the two Nyquist columns
// (re_h, im_h) as plain dots.
template <int RB, int NA>
__device__ __forceinline__ void spectra(const Geometry& q, const float* fm,
                                        const float* const* in, float* const* out) {
  const int t = threadIdx.x;
  const int row0 = t / q.cg * RB, col0 = t % q.cg * 4;
  float acc[NA][RB][4];
  block_product<RB, NA>(acc, in, q.ldt, fm, q.ldf, q.D, row0, col0);
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* o = out[a] + (col0 + j) * q.ldt + row0;
      if constexpr (RB == 4) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[a][0][j], acc[a][1][j], acc[a][2][j], acc[a][3][j]);
      } else {
        *reinterpret_cast<float2*>(o) = make_float2(acc[a][0][j], acc[a][1][j]);
      }
    }
  for (int i = t; i < NA * 2 * q.rows; i += THREADS) {
    const int a = i / (2 * q.rows), c = q.D + (i / q.rows) % 2, r = i % q.rows;
    const float* x = in[a] + r;
    float s = 0.f;
    for (int kk = 0; kk < q.D; ++kk) s = fmaf(x[kk * q.ldt], fm[kk * q.ldf + c], s);
    out[a][c * q.ldt + r] = s;
  }
}

// Stage fm, bm and the tile's ct/st rows ([K][rows], zero past N).
__device__ __forceinline__ void stage_constants(const Geometry& q, const Layout& L,
                                                unsigned char* smem,
                                                const float* __restrict__ fm_g,
                                                const float* __restrict__ bm_g,
                                                const float* __restrict__ ct,
                                                const float* __restrict__ st,
                                                size_t table_row0, int valid) {
  float* fm = reinterpret_cast<float*>(smem + L.fm);
  float* bm = reinterpret_cast<float*>(smem + L.bm);
  float* cts = reinterpret_cast<float*>(smem + L.ct);
  float* sts = reinterpret_cast<float*>(smem + L.st);
  for (int i = threadIdx.x; i < q.D * q.S; i += THREADS) {
    const int d = i / q.S, c = i - d * q.S;
    fm[d * q.ldf + c] = fm_g[i];
  }
  for (int i = threadIdx.x; i < q.S * q.D; i += THREADS) bm[i] = bm_g[i];
  for (int i = threadIdx.x; i < q.K * q.rows; i += THREADS) {
    const int k = i / q.rows, r = i - k * q.rows;
    const bool ok = r < valid;
    cts[i] = ok ? ct[(table_row0 + r) * q.K + k] : 0.f;
    sts[i] = ok ? st[(table_row0 + r) * q.K + k] : 0.f;
  }
}

// dst[d][r] = row r of one (b, h) tile as fp32, zero past `valid`.
template <typename T>
__device__ __forceinline__ void load_tile(const Geometry& q, float* dst,
                                          const T* __restrict__ src, long long row_stride,
                                          int valid) {
  for (int i = threadIdx.x; i < q.rows * q.D; i += THREADS) {
    const int r = i / q.D, d = i - r * q.D;
    dst[d * q.ldt + r] = r < valid ? to_float(src[r * row_stride + d]) : 0.f;
  }
}

// out rows of the tile = spec^T bm (the inverse DFT), written to global
// memory in T; under keep_cls the global row 0 is `cls` (the tile's own
// transposed input) instead.
template <int RB, typename T>
__device__ __forceinline__ void inverse_to_global(const Geometry& q, const float* spec,
                                                  const float* bm, const float* cls,
                                                  bool keep_cls, int n0, int valid, T* o) {
  const int t = threadIdx.x;
  const int row0 = t / q.cg * RB, col0 = t % q.cg * 4;
  float acc[1][RB][4];
  const float* A[1] = {spec};
  block_product<RB, 1>(acc, A, q.ldt, bm, q.D, q.S, row0, col0);
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int r = row0 + i;
    if (r >= valid) continue;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = keep_cls && n0 + r == 0 ? cls[(col0 + j) * q.ldt + r] : acc[0][i][j];
    store4(o + (size_t)r * q.D + col0, v);
  }
}

template <typename T, int RB>
__global__ void __launch_bounds__(THREADS)
rot_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ct,
               const float* __restrict__ st, const float* __restrict__ fm_g,
               const float* __restrict__ bm_g, T* __restrict__ out, const Params p) {
  const Geometry q(p.D, RB);
  const Layout L(q, false);
  extern __shared__ __align__(128) unsigned char smem[];
  const float* fm = reinterpret_cast<const float*>(smem + L.fm);
  const float* bm = reinterpret_cast<const float*>(smem + L.bm);
  const float* cts = reinterpret_cast<const float*>(smem + L.ct);
  const float* sts = reinterpret_cast<const float*>(smem + L.st);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  float* spec = reinterpret_cast<float*>(smem + L.spec);

  const int N = p.N;
  const int n0 = blockIdx.x * q.rows;
  const int h = blockIdx.y;
  const int valid = min(q.rows, N - n0);
  stage_constants(q, L, smem, fm_g, bm_g, ct, st, (size_t)h * N + n0, valid);

  const int b_end = min(p.B, (blockIdx.z + 1) * p.per_group);
  for (int b = blockIdx.z * p.per_group; b < b_end; ++b) {
    __syncthreads();  // constants staged; the previous batch's readers are done
    load_tile<T>(q, xs, x + b * p.xb + h * p.xh + n0 * p.xn, p.xn, valid);
    __syncthreads();
    const float* in[1] = {xs};
    float* outs[1] = {spec};
    spectra<RB, 1>(q, fm, in, outs);  // [x_re | x_im] = x [C_f | -S_f]
    __syncthreads();
    for (int i = threadIdx.x; i < q.K * q.rows; i += THREADS) {
      const int k = i / q.rows, r = i - k * q.rows;
      float* re = spec + q.re(k) * q.ldt + r;
      float* im = spec + q.im(k) * q.ldt + r;
      const float a = *re, c = *im, co = cts[i], si = sts[i];
      *re = co * a - si * c;
      *im = si * a + co * c;
    }
    __syncthreads();
    // y = [y_re | y_im] [C_b ; -S_b]
    inverse_to_global<RB, T>(q, spec, bm, xs, p.keep_cls, n0, valid,
                             out + (((size_t)b * p.H + h) * N + n0) * q.D);
  }
}

// Backward of one (tile, head, batch group): dx for each of its batches, and
// the group's sums of the angle gradients, in batch order, into dct/dst
// [groups, H, N, K] (with one group: the final [H, N, K]).
template <typename T, int RB>
__global__ void __launch_bounds__(THREADS)
rot_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ ct,
               const float* __restrict__ st, const float* __restrict__ fm_g,
               const float* __restrict__ bm_g, T* __restrict__ dx, float* __restrict__ dct,
               float* __restrict__ dst, const Params p) {
  const Geometry q(p.D, RB);
  const Layout L(q, true);
  extern __shared__ __align__(128) unsigned char smem[];
  const float* fm = reinterpret_cast<const float*>(smem + L.fm);
  const float* bm = reinterpret_cast<const float*>(smem + L.bm);
  const float* cts = reinterpret_cast<const float*>(smem + L.ct);
  const float* sts = reinterpret_cast<const float*>(smem + L.st);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  float* gs = reinterpret_cast<float*>(smem + L.g);
  float* dspec = reinterpret_cast<float*>(smem + L.spec);
  float* xspec = reinterpret_cast<float*>(smem + L.xspec);
  float* acc_c = reinterpret_cast<float*>(smem + L.acc_c);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc_s);

  const int N = p.N;
  const int n0 = blockIdx.x * q.rows;
  const int h = blockIdx.y;
  const int valid = min(q.rows, N - n0);
  stage_constants(q, L, smem, fm_g, bm_g, ct, st, (size_t)h * N + n0, valid);
  for (int i = threadIdx.x; i < q.K * q.lda; i += THREADS) acc_c[i] = acc_s[i] = 0.f;

  const int b_end = min(p.B, (blockIdx.z + 1) * p.per_group);
  for (int b = blockIdx.z * p.per_group; b < b_end; ++b) {
    __syncthreads();
    load_tile<T>(q, gs, g + b * p.gb + h * p.gh + n0 * p.gn, p.gn, valid);
    load_tile<T>(q, xs, x + b * p.xb + h * p.xh + n0 * p.xn, p.xn, valid);
    __syncthreads();
    // g fm (scaled by w / D below: g [C_b ; -S_b]^T) and the forward
    // spectrum of x again, sharing fm's loads
    const float* in[2] = {gs, xs};
    float* outs[2] = {dspec, xspec};
    spectra<RB, 2>(q, fm, in, outs);
    __syncthreads();
    const float inv_d = 1.f / q.D;
    for (int i = threadIdx.x; i < q.K * q.rows; i += THREADS) {
      const int k = i / q.rows, r = i - k * q.rows;
      const float w = (k == 0 || k == q.h) ? 1.f : 2.f;
      float* re = dspec + q.re(k) * q.ldt + r;
      float* im = dspec + q.im(k) * q.ldt + r;
      // the forward ignored row 0's rotation under keep_cls: no cotangent
      // flows through it
      const bool cls = p.keep_cls && n0 + r == 0;
      const float dre = cls ? 0.f : *re * w * inv_d, dim = cls ? 0.f : *im * w * inv_d;
      const float xre = xspec[q.re(k) * q.ldt + r], xim = xspec[q.im(k) * q.ldt + r];
      const float co = cts[i], si = sts[i];
      acc_c[k * q.lda + r] += dre * xre + dim * xim;
      acc_s[k * q.lda + r] += dim * xre - dre * xim;
      // [dx_re | dx_im] [C_f | -S_f]^T = ([dx_re | dx_im] * D / w) [C_b ; -S_b]
      const float back = q.D / w;
      *re = (co * dre + si * dim) * back;
      *im = (-si * dre + co * dim) * back;
    }
    __syncthreads();
    inverse_to_global<RB, T>(q, dspec, bm, gs, p.keep_cls, n0, valid,
                             dx + (((size_t)b * p.H + h) * N + n0) * q.D);
  }
  __syncthreads();
  const size_t row0 = ((size_t)blockIdx.z * p.H + h) * N + n0;
  for (int i = threadIdx.x; i < valid * q.K; i += THREADS) {
    const int r = i / q.K, k = i - r * q.K;
    dct[row0 * q.K + i] = acc_c[k * q.lda + r];
    dst[row0 * q.K + i] = acc_s[k * q.lda + r];
  }
}

// out[i] = sum over groups of part[group][i], groups in order (no atomics).
__global__ void __launch_bounds__(THREADS)
group_sum_kernel(const float* __restrict__ part, float* __restrict__ out, size_t n, int groups) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    float s = 0.f;
    for (int gi = 0; gi < groups; ++gi) s += part[gi * n + i];
    out[i] = s;
  }
}

int groups_for(int B, int H, int N, int D, int rb) {
  const int rows = Geometry(D, rb).rows;
  const int blocks = (N + rows - 1) / rows * H;
  int groups = (TARGET_BLOCKS + blocks - 1) / blocks;
  groups = groups < 1 ? 1 : (groups > B ? B : groups);
  const int per = (B + groups - 1) / groups;
  return (B + per - 1) / per;  // no empty group
}

bool bad_shape(int B, int H, int N, int D) {
  return B <= 0 || H <= 0 || N <= 0 || D < 4 || D > MAX_D || D % 4 != 0;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  (void)cudaGetLastError();  // start from a clean error state
  if (bytes > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Params make_params(int B, int H, int N, int D, int rb, int keep_cls, long long xb,
                   long long xh, long long xn, long long gb, long long gh, long long gn) {
  const int groups = bad_shape(B, H, N, D) ? 1 : groups_for(B, H, N, D, rb);
  return Params{B, H, N, D, keep_cls, groups, (B + groups - 1) / groups, xb, xh, xn, gb, gh, gn};
}

// ─── the bf16 mma.sync kernels ──────────────────────────────────────────

namespace fm = flash::mma;

// Rows per block (warps of 16 rows), ring stages per warp, and the number
// of blocks the batch groups aim at, per kernel: picked by trial on an H100
// (experiments/tile_trial.py, numbers in PERF.md).
constexpr int FWD_MMA_WARPS = 8;
constexpr int FWD_MMA_STAGES = 2;
constexpr int FWD_MMA_TARGET = 2 * 132;
constexpr int BWD_MMA_WARPS = 8;
constexpr int BWD_MMA_STAGES = 2;
constexpr int BWD_MMA_TARGET = 2 * 132;
constexpr int MMA_MAX_D = 64;

// Whether a bf16 launch at head dim D with element strides (sb, sh, sn) of
// x (and g) runs the mma.sync kernels: D a multiple of 16 up to 64 and
// strides that are multiples of 8, so rows start 16-byte aligned from a
// 16-byte aligned base (which the entry points check on the pointers).
bool rot_mma_takes(int D, long long sb, long long sh, long long sn) {
  return D % 16 == 0 && D >= 16 && D <= MMA_MAX_D && sb % 8 == 0 && sh % 8 == 0 &&
         sn % 8 == 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Geometry of a block at head dim D: W warps of 16 rows, each with a ring of
// S slots of NTENS [16, LD] bf16 tiles (x; the backward's g and x), after
// the four [D, LD] constant matrices fm_hi, fm_lo, bm_hi, bm_lo.
template <int D, int W, int S, int NTENS>
struct MmaGeometry {
  static constexpr int NT = 32 * W;     // threads
  static constexpr int ROWS = 16 * W;   // rows per block
  static constexpr int LD = D + 8;      // row stride (elements): 16-byte rows, and the eight
                                        // row addresses of an ldmatrix on distinct banks
  static constexpr int MAT = D * LD;    // elements of one constant matrix
  static constexpr int TILE = 16 * LD;  // elements of one warp's 16-row tile
  static constexpr size_t BYTES =
      sizeof(bf16) * ((size_t)4 * MAT + (size_t)W * S * NTENS * TILE);
};

// Column p of the interleaved spectrum as a column of fm (a row of bm) in
// their staged order: p = 0 re_0, p = 1 re_h (in im_0's slot), p = 2k re_k,
// p = 2k + 1 im_k.
__device__ __forceinline__ int staged_column(int D, int p) {
  return p == 1 ? D : (p % 2 == 0 ? p / 2 : D / 2 + p / 2);
}

// The four constant matrices in shared memory, [D, D + 8] bf16 each: fm_hi,
// fm_lo ([depth d][column p]) and bm_hi, bm_lo ([row p][column d]), from
// the fp32 fm [D, D + 2] and bm [D + 2, D]; hi = bf16(c), lo = bf16(c - hi).
template <int D, int NT>
__device__ __forceinline__ void stage_split_constants(bf16* c, const float* __restrict__ fm,
                                                      const float* __restrict__ bm) {
  constexpr int LD = D + 8, MAT = D * LD;
  for (int i = threadIdx.x; i < D * D; i += NT) {
    const int r = i / D, col = i - r * D;
    const float f = fm[r * (D + 2) + staged_column(D, col)];  // depth r, column col
    const float b = bm[staged_column(D, r) * D + col];        // spectrum row r, column col
    const bf16 fh = __float2bfloat16_rn(f), bh = __float2bfloat16_rn(b);
    c[r * LD + col] = fh;
    c[MAT + r * LD + col] = __float2bfloat16_rn(f - __bfloat162float(fh));
    c[2 * MAT + r * LD + col] = bh;
    c[3 * MAT + r * LD + col] = __float2bfloat16_rn(b - __bfloat162float(bh));
  }
}

// Stage 16 rows of D bf16 (row stride rs elements, the first `valid` of
// them real) into a warp's [16, D + 8] tile by 16-byte cp.async; rows past
// `valid` are zero. Committed by the caller.
template <int D>
__device__ __forceinline__ void stage_warp_rows(bf16* tile, const bf16* __restrict__ src,
                                                long long rs, int valid) {
  constexpr int CH = D / 8;  // 16-byte words a row
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, w = c - r * CH;
    const bool ok = r < valid;
    flash::cp_async<16>(tile + r * (D + 8) + 8 * w, ok ? src + r * rs + 8 * w : src,
                        ok ? 16 : 0);
  }
}

// The first `valid` rows of a warp's [16, D + 8] tile to dst (row stride D)
// as 16-byte stores.
template <int D>
__device__ __forceinline__ void store_warp_rows(bf16* __restrict__ dst, const bf16* tile,
                                                int valid) {
  constexpr int CH = D / 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, w = c - r * CH;
    if (r < valid)
      *reinterpret_cast<uint4*>(dst + (size_t)r * D + 8 * w) =
          *reinterpret_cast<const uint4*>(tile + r * (D + 8) + 8 * w);
  }
}

// acc[a] = the interleaved spectrum of the warp tile in[a] ([16, D + 8]
// bf16): in[a] fm_lo + in[a] fm_hi, in fp32 accumulators of D / 8 n8
// tiles. Each B fragment of the constants is loaded once for all NA tiles.
// The forward (NA = 1: x) and the backward (NA = 2: g and x) share it.
template <int D, int NA>
__device__ __forceinline__ void split_spectra(float (&acc)[NA][D / 8][4],
                                              const bf16* const (&in)[NA], const bf16* fh,
                                              const bf16* fl) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int a = 0; a < NA; ++a) fm::zero_acc<D / 8>(acc[a]);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[NA][4];
#pragma unroll
    for (int a = 0; a < NA; ++a) fm::load_a(af[a], in[a], LD, 0, kk * 16);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bh[4], bl[4];
      fm::load_b_cols(bh, fh, LD, kk * 16, np * 16);
      fm::load_b_cols(bl, fl, LD, kk * 16, np * 16);
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        fm::mma_bf16(acc[a][2 * np], af[a], bl[0], bl[1]);
        fm::mma_bf16(acc[a][2 * np], af[a], bh[0], bh[1]);
        fm::mma_bf16(acc[a][2 * np + 1], af[a], bl[2], bl[3]);
        fm::mma_bf16(acc[a][2 * np + 1], af[a], bh[2], bh[3]);
      }
    }
  }
}

// v0, v1 as bf16 pairs hi = bf16(v) and lo = bf16(v - hi), the lower column
// in the low half.
__device__ __forceinline__ void split_pack(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - back.x, v1 - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// y = s bm as three bf16 products, s_lo bm_hi + s_hi bm_lo + s_hi bm_hi,
// with s the warp's rotated fp32 spectrum in accumulator layout: two n8
// tiles are one k16 A fragment (fm::to_a's packing), here split into hi
// and lo.
template <int D>
__device__ __forceinline__ void split_inverse(float (&y)[D / 8][4], const float (&s)[D / 8][4],
                                              const bf16* bh_m, const bf16* bl_m) {
  constexpr int LD = D + 8;
  fm::zero_acc<D / 8>(y);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split_pack(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
    split_pack(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
    split_pack(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
    split_pack(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bh[4], bl[4];
      fm::load_b_cols(bh, bh_m, LD, kk * 16, np * 16);
      fm::load_b_cols(bl, bl_m, LD, kk * 16, np * 16);
      fm::mma_bf16(y[2 * np], lo, bh[0], bh[1]);
      fm::mma_bf16(y[2 * np], hi, bl[0], bl[1]);
      fm::mma_bf16(y[2 * np], hi, bh[0], bh[1]);
      fm::mma_bf16(y[2 * np + 1], lo, bh[2], bh[3]);
      fm::mma_bf16(y[2 * np + 1], hi, bl[2], bl[3]);
      fm::mma_bf16(y[2 * np + 1], hi, bh[2], bh[3]);
    }
  }
}

// A thread's angle tables, held in registers across the batch loop: for n8
// tile j and row half f (rows lane/4 and lane/4 + 8 of the warp's 16), the
// frequency k = 4 j + lane % 4 whose (re, im) the accumulator's columns
// (2 t, 2 t + 1) hold. The lanes with t = 0 hold (re_0, re_h) in tile 0:
// there c, s are (ct_0, 0) and c1 is ct_h (elsewhere c1 is tile 0's c), so
// one formula rotates every pair: (c re - s im, s re + c1 im). Rows past
// `valid` get zeros.
template <int D>
struct AngleRegs {
  float c[D / 8][2], s[D / 8][2], c1[2];

  __device__ __forceinline__ void load(const float* __restrict__ ct,
                                       const float* __restrict__ st, size_t row0, int valid) {
    constexpr int K = D / 2 + 1;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int r = g + 8 * f;
      const bool ok = r < valid;
      const float* cr = ct + (row0 + r) * K;
      const float* sr = st + (row0 + r) * K;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        c[j][f] = ok ? __ldg(cr + 4 * j + t) : 0.f;
        s[j][f] = ok && (j > 0 || t > 0) ? __ldg(sr + 4 * j + t) : 0.f;
      }
      c1[f] = ok ? __ldg(cr + (t == 0 ? D / 2 : t)) : 0.f;
    }
  }

  // The forward rotation, in place: (re, im) -> (c re - s im, s re + c1 im).
  __device__ __forceinline__ void rotate(float (&a)[D / 8][4]) const {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const float re = a[j][2 * f], im = a[j][2 * f + 1];
        const float cc = j == 0 ? c1[f] : c[j][f];
        a[j][2 * f] = c[j][f] * re - s[j][f] * im;
        a[j][2 * f + 1] = s[j][f] * re + cc * im;
      }
  }

  // The reverse rotation of g's spectrum, in place: (re, im) -> (c re + s
  // im, c1 im - s re). On the unscaled g fm (not g C_b^T) this is the
  // spectrum whose product with bm is dx: C_f^T = diag(D / w) C_b undoes
  // the w / D of C_b^T = C_f diag(w / D).
  __device__ __forceinline__ void rotate_back(float (&a)[D / 8][4]) const {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const float re = a[j][2 * f], im = a[j][2 * f + 1];
        const float cc = j == 0 ? c1[f] : c[j][f];
        a[j][2 * f] = c[j][f] * re + s[j][f] * im;
        a[j][2 * f + 1] = cc * im - s[j][f] * re;
      }
  }
};

// A warp's fp32 accumulators of 16 rows as bf16 pairs into its [16, D + 8]
// tile, skipping row 0 when skip_row0 (the staged input row then stays:
// keep_cls).
template <int D>
__device__ __forceinline__ void write_warp_rows(bf16* tile, const float (&y)[D / 8][4],
                                                bool skip_row0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    if (f == 0 && skip_row0 && g == 0) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(tile + (g + 8 * f) * (D + 8) + 8 * j + 2 * t) =
          fm::pack_bf16(y[j][2 * f], y[j][2 * f + 1]);
  }
}

// The forward of one (row tile, head, batch group).
template <int D, int W, int S>
__global__ void __launch_bounds__(32 * W)
rot_fwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ ct,
                   const float* __restrict__ st, const float* __restrict__ fm_g,
                   const float* __restrict__ bm_g, bf16* __restrict__ out, const Params p) {
  using G = MmaGeometry<D, W, S, 1>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* cst = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x / 32;
  bf16* ring = cst + 4 * G::MAT + (size_t)warp * S * G::TILE;
  const int h = blockIdx.y;
  const int n0 = blockIdx.x * G::ROWS + 16 * warp;  // the warp's first row
  const int valid = min(16, p.N - n0);
  const int b0 = blockIdx.z * p.per_group;
  const int count = min(p.B - b0, p.per_group);
  const bf16* xw = x + h * p.xh + (long long)n0 * p.xn + b0 * p.xb;

  if (valid > 0) {
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (i < count) stage_warp_rows<D>(ring + i * G::TILE, xw + i * p.xb, p.xn, valid);
      fm::cp_async_commit();
    }
  }
  stage_split_constants<D, G::NT>(cst, fm_g, bm_g);
  __syncthreads();  // the only block-wide barrier: from here each warp runs on its own
  if (valid <= 0) return;
  AngleRegs<D> ang;
  ang.load(ct, st, (size_t)h * p.N + n0, valid);
  const bool cls = p.keep_cls && n0 == 0;
  for (int i = 0; i < count; ++i) {
    if (i + S - 1 < count)
      stage_warp_rows<D>(ring + (i + S - 1) % S * G::TILE, xw + (i + S - 1) * p.xb, p.xn,
                         valid);
    fm::cp_async_commit();
    fm::cp_async_wait<S - 1>();
    __syncwarp();
    bf16* xs = ring + i % S * G::TILE;
    float spec[1][D / 8][4];
    const bf16* const in[1] = {xs};
    split_spectra<D, 1>(spec, in, cst, cst + G::MAT);
    ang.rotate(spec[0]);
    float y[D / 8][4];
    split_inverse<D>(y, spec[0], cst + 2 * G::MAT, cst + 3 * G::MAT);
    __syncwarp();  // every lane's ldmatrix of the tile is done
    write_warp_rows<D>(xs, y, cls);
    __syncwarp();
    store_warp_rows<D>(out + (((size_t)(b0 + i) * p.H + h) * p.N + n0) * D, xs, valid);
    __syncwarp();  // the slot is free for a later load
  }
}

// The backward of one (row tile, head, batch group): dx of each batch
// element, and the group's sums of the angle gradients into dct / dst
// [groups, H, N, K] (with one group, the final [H, N, K]).
template <int D, int W, int S>
__global__ void __launch_bounds__(32 * W)
rot_bwd_mma_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
                   const float* __restrict__ ct, const float* __restrict__ st,
                   const float* __restrict__ fm_g, const float* __restrict__ bm_g,
                   bf16* __restrict__ dx, float* __restrict__ dct, float* __restrict__ dst,
                   const Params p) {
  using G = MmaGeometry<D, W, S, 2>;
  constexpr int K = D / 2 + 1;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* cst = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* ring = cst + 4 * G::MAT + (size_t)warp * S * 2 * G::TILE;  // a slot: g, then x
  const int h = blockIdx.y;
  const int n0 = blockIdx.x * G::ROWS + 16 * warp;
  const int valid = min(16, p.N - n0);
  const int b0 = blockIdx.z * p.per_group;
  const int count = min(p.B - b0, p.per_group);
  const bf16* gw = g + h * p.gh + (long long)n0 * p.gn + b0 * p.gb;
  const bf16* xw = x + h * p.xh + (long long)n0 * p.xn + b0 * p.xb;

  if (valid > 0) {
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
      if (i < count) {
        stage_warp_rows<D>(ring + 2 * i * G::TILE, gw + i * p.gb, p.gn, valid);
        stage_warp_rows<D>(ring + (2 * i + 1) * G::TILE, xw + i * p.xb, p.xn, valid);
      }
      fm::cp_async_commit();
    }
  }
  stage_split_constants<D, G::NT>(cst, fm_g, bm_g);
  __syncthreads();  // the only block-wide barrier
  if (valid <= 0) return;
  AngleRegs<D> ang;
  ang.load(ct, st, (size_t)h * p.N + n0, valid);
  // the global row 0 under keep_cls: the forward passed it through, so no
  // cotangent reaches its spectrum (and dx's row 0 is g's, bit for bit)
  const bool cls = p.keep_cls && n0 == 0;
  const bool cls_lane = cls && lane < 4;
  const bool nyquist_lane = lane % 4 == 0;  // holds (re_0, re_h) in tile 0
  float acc_c[D / 8][2], acc_s[D / 8][2];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc_c[j][0] = acc_c[j][1] = acc_s[j][0] = acc_s[j][1] = 0.f;

  for (int i = 0; i < count; ++i) {
    if (i + S - 1 < count) {
      const int slot = (i + S - 1) % S;
      stage_warp_rows<D>(ring + 2 * slot * G::TILE, gw + (i + S - 1) * p.gb, p.gn, valid);
      stage_warp_rows<D>(ring + (2 * slot + 1) * G::TILE, xw + (i + S - 1) * p.xb, p.xn,
                         valid);
    }
    fm::cp_async_commit();
    fm::cp_async_wait<S - 1>();
    __syncwarp();
    bf16* gs = ring + 2 * (i % S) * G::TILE;
    const bf16* xs = gs + G::TILE;
    float spec[2][D / 8][4];  // g fm, x fm
    const bf16* const in[2] = {gs, xs};
    split_spectra<D, 2>(spec, in, cst, cst + G::MAT);
    if (cls_lane) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) spec[0][j][0] = spec[0][j][1] = 0.f;
    }
    // the angle gradients before their scale w / D (taken once, at the
    // end): dct += gre xre + gim xim, dst += gim xre - gre xim; the
    // Nyquist lanes' tile-0 pair is (re_0, re_h) in both spectra, so their
    // two sums there are dct_0 and dct_h (dst_0 = dst_h = 0)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const float gre = spec[0][j][2 * f], gim = spec[0][j][2 * f + 1];
        const float xre = spec[1][j][2 * f], xim = spec[1][j][2 * f + 1];
        const float pp = gre * xre, qq = gim * xim;
        if (j == 0 && nyquist_lane) {
          acc_c[j][f] += pp;
          acc_s[j][f] += qq;
        } else {
          acc_c[j][f] += pp + qq;
          acc_s[j][f] += gim * xre - gre * xim;
        }
      }
    ang.rotate_back(spec[0]);
    float y[D / 8][4];
    split_inverse<D>(y, spec[0], cst + 2 * G::MAT, cst + 3 * G::MAT);
    __syncwarp();
    write_warp_rows<D>(gs, y, cls);
    __syncwarp();
    store_warp_rows<D>(dx + (((size_t)(b0 + i) * p.H + h) * p.N + n0) * D, gs, valid);
    __syncwarp();
  }
  // the group's sums, scaled by w / D (w = 1 at k = 0 and k = h, else 2)
  const int gq = lane / 4, t = lane % 4;
  constexpr float inv_d = 1.f / D;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int r = gq + 8 * f;
    if (r >= valid) continue;
    const size_t o = (((size_t)blockIdx.z * p.H + h) * p.N + n0 + r) * K;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (j == 0 && nyquist_lane) {
        dct[o] = acc_c[0][f] * inv_d;
        dst[o] = 0.f;
        dct[o + D / 2] = acc_s[0][f] * inv_d;
        dst[o + D / 2] = 0.f;
      } else {
        dct[o + 4 * j + t] = acc_c[j][f] * (2.f * inv_d);
        dst[o + 4 * j + t] = acc_s[j][f] * (2.f * inv_d);
      }
    }
  }
}

int mma_groups_for(int B, int H, int N, int rows, int target) {
  const int blocks = (N + rows - 1) / rows * H;
  int groups = (target + blocks - 1) / blocks;
  groups = groups < 1 ? 1 : (groups > B ? B : groups);
  const int per = (B + groups - 1) / groups;
  return (B + per - 1) / per;  // no empty group
}

int fwd_mma_groups(int B, int H, int N) {
  return mma_groups_for(B, H, N, 16 * FWD_MMA_WARPS, FWD_MMA_TARGET);
}
int bwd_mma_groups(int B, int H, int N) {
  return mma_groups_for(B, H, N, 16 * BWD_MMA_WARPS, BWD_MMA_TARGET);
}

// The mma.sync kernel of one direction at head dim D and its dynamic
// shared memory; null for a D it is not built for.
const void* mma_kernel(bool backward, int D, size_t* bytes) {
  constexpr int FW = FWD_MMA_WARPS, FS = FWD_MMA_STAGES;
  constexpr int BW = BWD_MMA_WARPS, BS = BWD_MMA_STAGES;
#define ROT_MMA_CASE(DD)                                                                  \
  case DD:                                                                                \
    *bytes = backward ? MmaGeometry<DD, BW, BS, 2>::BYTES : MmaGeometry<DD, FW, FS, 1>::BYTES; \
    return backward ? reinterpret_cast<const void*>(rot_bwd_mma_kernel<DD, BW, BS>)       \
                    : reinterpret_cast<const void*>(rot_fwd_mma_kernel<DD, FW, FS>);
  switch (D) {
    ROT_MMA_CASE(16)
    ROT_MMA_CASE(32)
    ROT_MMA_CASE(48)
    ROT_MMA_CASE(64)
  }
#undef ROT_MMA_CASE
  return nullptr;
}

int launch_fwd_mma(const void* x, const void* ct, const void* st, const void* fmat,
                   const void* bmat, void* out, const Params& p, void* stream) {
  size_t bytes = 0;
  const void* kernel = mma_kernel(false, p.D, &bytes);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const int err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int rows = 16 * FWD_MMA_WARPS;
  const dim3 grid((p.N + rows - 1) / rows, p.H, p.groups);
  Params q = p;
  void* args[] = {&x, &ct, &st, &fmat, &bmat, &out, &q};
  return cudaLaunchKernel(kernel, grid, dim3(32 * FWD_MMA_WARPS), args, bytes,
                          static_cast<cudaStream_t>(stream));
}

int launch_bwd_mma(const void* g, const void* x, const void* ct, const void* st,
                   const void* fmat, const void* bmat, void* dx, void* dct, void* dst,
                   void* work, const Params& p, void* stream) {
  if (p.groups > 1 && work == nullptr) return cudaErrorInvalidValue;
  size_t bytes = 0;
  const void* kernel = mma_kernel(true, p.D, &bytes);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)p.H * p.N * (p.D / 2 + 1);
  float* part_c = static_cast<float*>(p.groups > 1 ? work : dct);
  float* part_s = p.groups > 1 ? static_cast<float*>(work) + (size_t)p.groups * n
                               : static_cast<float*>(dst);
  const int rows = 16 * BWD_MMA_WARPS;
  const dim3 grid((p.N + rows - 1) / rows, p.H, p.groups);
  Params q = p;
  void* args[] = {&g, &x, &ct, &st, &fmat, &bmat, &dx, &part_c, &part_s, &q};
  err = cudaLaunchKernel(kernel, grid, dim3(32 * BWD_MMA_WARPS), args, bytes, s);
  if (err != cudaSuccess || p.groups == 1) return err;
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  group_sum_kernel<<<blocks, THREADS, 0, s>>>(part_c, static_cast<float*>(dct), n, p.groups);
  group_sum_kernel<<<blocks, THREADS, 0, s>>>(part_s, static_cast<float*>(dst), n, p.groups);
  return cudaGetLastError();
}

template <typename T, int RB>
int launch_fwd_rb(const void* x, const void* ct, const void* st, const void* fm, const void* bm,
                  void* out, const Params& p, void* stream) {
  const Geometry q(p.D, RB);
  const Layout L(q, false);
  const int err = prepare(rot_fwd_kernel<T, RB>, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + q.rows - 1) / q.rows, p.H, p.groups);
  rot_fwd_kernel<T, RB><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(ct), static_cast<const float*>(st),
      static_cast<const float*>(fm), static_cast<const float*>(bm), static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* x, const void* ct, const void* st, const void* fm, const void* bm,
               void* out, const Params& p, void* stream) {
  if (bad_shape(p.B, p.H, p.N, p.D)) return cudaErrorInvalidValue;
  return fwd_rows_per_thread(p.D) == 4
             ? launch_fwd_rb<T, 4>(x, ct, st, fm, bm, out, p, stream)
             : launch_fwd_rb<T, 2>(x, ct, st, fm, bm, out, p, stream);
}

template <typename T, int RB>
int launch_bwd_rb(const void* g, const void* x, const void* ct, const void* st, const void* fm,
                  const void* bm, void* dx, float* part_c, float* part_s, const Params& p,
                  cudaStream_t s) {
  const Geometry q(p.D, RB);
  const Layout L(q, true);
  const int err = prepare(rot_bwd_kernel<T, RB>, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + q.rows - 1) / q.rows, p.H, p.groups);
  rot_bwd_kernel<T, RB><<<grid, THREADS, L.bytes, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const float*>(ct),
      static_cast<const float*>(st), static_cast<const float*>(fm),
      static_cast<const float*>(bm), static_cast<T*>(dx), part_c, part_s, p);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const void* x, const void* ct, const void* st, const void* fm,
               const void* bm, void* dx, void* dct, void* dst, void* work, const Params& p,
               void* stream) {
  if (bad_shape(p.B, p.H, p.N, p.D) || (p.groups > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)p.H * p.N * (p.D / 2 + 1);
  float* part_c = static_cast<float*>(p.groups > 1 ? work : dct);
  float* part_s = p.groups > 1 ? static_cast<float*>(work) + (size_t)p.groups * n
                               : static_cast<float*>(dst);
  int err = launch_bwd_rb<T, BWD_ROWS_PER_THREAD>(g, x, ct, st, fm, bm, dx, part_c, part_s,
                                                  p, s);
  if (err != cudaSuccess || p.groups == 1) return err;
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  group_sum_kernel<<<blocks, THREADS, 0, s>>>(part_c, static_cast<float*>(dct), n, p.groups);
  group_sum_kernel<<<blocks, THREADS, 0, s>>>(part_s, static_cast<float*>(dst), n, p.groups);
  return cudaGetLastError();
}

// The bf16 launches the mma.sync kernels take (rot_mma_takes, on the
// strides of x and g and 16-byte aligned bases); the rest run the staged
// kernels.
template <typename T>
bool takes_mma(int B, int H, int N, int D, const void* x, long long xb, long long xh,
               long long xn) {
  return std::is_same<T, bf16>::value && !bad_shape(B, H, N, D) &&
         rot_mma_takes(D, xb, xh, xn) && aligned16(x);
}

template <typename T>
int rotate_fwd(const void* x, const void* ct, const void* st, const void* fm, const void* bm,
               void* out, int B, int H, int N, int D, int keep_cls, long long xb,
               long long xh, long long xn, void* stream) {
  if (takes_mma<T>(B, H, N, D, x, xb, xh, xn)) {
    const int groups = fwd_mma_groups(B, H, N);
    const Params p{B, H, N, D, keep_cls, groups, (B + groups - 1) / groups, xb, xh, xn, 0, 0, 0};
    return launch_fwd_mma(x, ct, st, fm, bm, out, p, stream);
  }
  const Params p = make_params(B, H, N, D, fwd_rows_per_thread(D), keep_cls, xb, xh, xn,
                               0, 0, 0);
  return launch_fwd<T>(x, ct, st, fm, bm, out, p, stream);
}

template <typename T>
int rotate_bwd(const void* g, const void* x, const void* ct, const void* st, const void* fm,
               const void* bm, void* dx, void* dct, void* dst, void* work, int B, int H,
               int N, int D, int keep_cls, long long gb, long long gh, long long gn,
               long long xb, long long xh, long long xn, void* stream) {
  if (takes_mma<T>(B, H, N, D, x, xb, xh, xn) && takes_mma<T>(B, H, N, D, g, gb, gh, gn)) {
    const int groups = bwd_mma_groups(B, H, N);
    const Params p{B, H, N, D, keep_cls, groups, (B + groups - 1) / groups, xb, xh, xn,
                   gb, gh, gn};
    return launch_bwd_mma(g, x, ct, st, fm, bm, dx, dct, dst, work, p, stream);
  }
  const Params p = make_params(B, H, N, D, BWD_ROWS_PER_THREAD, keep_cls, xb, xh, xn, gb,
                               gh, gn);
  return launch_bwd<T>(g, x, ct, st, fm, bm, dx, dct, dst, work, p, stream);
}

}  // namespace

extern "C" {

// Batch groups of a backward launch at [B, H, N, D], the most that either
// backward kernel splits it into: the workspace holds 2 * groups * H * N * K
// floats when groups > 1.
int circulant_rotate_groups(int B, int H, int N, int D) {
  if (bad_shape(B, H, N, D)) return 1;
  const int staged = groups_for(B, H, N, D, BWD_ROWS_PER_THREAD);
  const int mma = rot_mma_takes(D, 0, 0, 0) ? bwd_mma_groups(B, H, N) : 1;
  return staged > mma ? staged : mma;
}

// x [B, H, N, D] (bf16 or fp32, D a multiple of 4 up to 128) with element
// strides (xb, xh, xn) and a contiguous last dim; ct, st [H, N, K] fp32,
// K = D/2 + 1; fm [D, D + 2] and bm [D + 2, D] fp32 in the spectrum column
// order above; out contiguous [B, H, N, D] like x. Runs on `stream`, does
// not synchronise, allocates nothing; returns the CUDA error code (0 =
// launched, cudaErrorInvalidValue for arguments it refuses). A bf16 launch
// that rot_mma_takes, from a 16-byte aligned x, runs rot_fwd_mma_kernel.
int circulant_rotate_fwd_bf16(const void* x, const void* ct, const void* st, const void* fm,
                              const void* bm, void* out, int B, int H, int N, int D,
                              int keep_cls, long long xb, long long xh, long long xn,
                              void* stream) {
  return rotate_fwd<bf16>(x, ct, st, fm, bm, out, B, H, N, D, keep_cls, xb, xh, xn, stream);
}

int circulant_rotate_fwd_f32(const void* x, const void* ct, const void* st, const void* fm,
                             const void* bm, void* out, int B, int H, int N, int D,
                             int keep_cls, long long xb, long long xh, long long xn,
                             void* stream) {
  return rotate_fwd<float>(x, ct, st, fm, bm, out, B, H, N, D, keep_cls, xb, xh, xn, stream);
}

// The backward: g and x [B, H, N, D] strided as above; dx contiguous like x;
// dct, dst [H, N, K] fp32; work as `circulant_rotate_groups` says (may be
// null with one group). Launches a backward kernel (rot_bwd_mma_kernel where
// both g and x are taken as by the forward) and, with several batch groups,
// two fixed-order sums over them.
int circulant_rotate_bwd_bf16(const void* g, const void* x, const void* ct, const void* st,
                              const void* fm, const void* bm, void* dx, void* dct, void* dst,
                              void* work, int B, int H, int N, int D, int keep_cls,
                              long long gb, long long gh, long long gn, long long xb,
                              long long xh, long long xn, void* stream) {
  return rotate_bwd<bf16>(g, x, ct, st, fm, bm, dx, dct, dst, work, B, H, N, D, keep_cls, gb,
                          gh, gn, xb, xh, xn, stream);
}

int circulant_rotate_bwd_f32(const void* g, const void* x, const void* ct, const void* st,
                             const void* fm, const void* bm, void* dx, void* dct, void* dst,
                             void* work, int B, int H, int N, int D, int keep_cls,
                             long long gb, long long gh, long long gn, long long xb,
                             long long xh, long long xn, void* stream) {
  return rotate_bwd<float>(g, x, ct, st, fm, bm, dx, dct, dst, work, B, H, N, D, keep_cls, gb,
                           gh, gn, xb, xh, xn, stream);
}

// What a forward (kind 0) or backward (kind 1) launch at (N, D) in bf16
// (is_bf16 = 1) or fp32, with x's (and g's) element strides (sb, sh, sn),
// runs, in info[0..6]: rows per block, threads, dynamic shared memory
// bytes, resident blocks per SM, registers per thread, local (spilled)
// bytes per thread, and 1 for the mma.sync kernel (0 for the staged one).
// Returns the CUDA error code (cudaErrorInvalidValue for bad arguments).
int circulant_rotate_launch_info(int kind, int N, int D, int is_bf16, long long sb,
                                 long long sh, long long sn, int* info) {
  if (bad_shape(1, 1, N, D) || (kind != 0 && kind != 1)) return cudaErrorInvalidValue;
  const bool backward = kind == 1;
  if (is_bf16 && rot_mma_takes(D, sb, sh, sn)) {
    size_t bytes = 0;
    const void* kernel = mma_kernel(backward, D, &bytes);
    const int warps = backward ? BWD_MMA_WARPS : FWD_MMA_WARPS;
    return fm::launch_info(kernel, 16 * warps, 32 * warps, bytes, true, info);
  }
  const int rb = backward ? BWD_ROWS_PER_THREAD : fwd_rows_per_thread(D);
  const Geometry q(D, rb);
  const size_t bytes = Layout(q, backward).bytes;
  const void* kernel;
  if (backward) {
    kernel = is_bf16 ? reinterpret_cast<const void*>(rot_bwd_kernel<bf16, BWD_ROWS_PER_THREAD>)
                     : reinterpret_cast<const void*>(rot_bwd_kernel<float, BWD_ROWS_PER_THREAD>);
  } else if (rb == 4) {
    kernel = is_bf16 ? reinterpret_cast<const void*>(rot_fwd_kernel<bf16, 4>)
                     : reinterpret_cast<const void*>(rot_fwd_kernel<float, 4>);
  } else {
    kernel = is_bf16 ? reinterpret_cast<const void*>(rot_fwd_kernel<bf16, 2>)
                     : reinterpret_cast<const void*>(rot_fwd_kernel<float, 2>);
  }
  return fm::launch_info(kernel, q.rows, THREADS, bytes, false, info);
}

const char* circulant_rotate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
