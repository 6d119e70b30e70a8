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
// What bounds it on an H100: at ViT-B (D = 64, K = 33, bf16) a row is 128
// bytes in and out against 8 D K = 16.9 kFLOP of fp32 products forward
// (12 D K backward), so the fp32 FMA rate bounds it (B=32, H=12, N=197:
// 1.28 GFLOP, 19 us, against 20 MB, 6 us). This version is simple rather
// than fast: one block per (tile of rows, head, batch group) stages fm and
// bm and the tile's ct/st rows in shared memory once and loops over its
// batches. Tiles are kept transposed ([col][row]) in shared memory; each
// thread computes a block of 4 columns by 4 rows (forward at D <= 64) or 2
// rows (the backward, and D = 128) of each product from 16-byte shared
// loads, and the two Nyquist columns as plain dots; at D = 64 a tile is 64
// rows forward, 32 backward. The batch sum of the
// angle gradients runs in a fixed order in the block, and across batch
// groups in a second, fixed-order sum kernel: no float atomics, so the
// gradients are bitwise reproducible. Tensor-core products (the DFTs are
// [rows, 64] x [64, 66] GEMMs) and overlapping loads with products are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>

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

}  // namespace

extern "C" {

// Batch groups of a launch at [B, H, N, D]: the backward's workspace holds
// 2 * groups * H * N * K floats when groups > 1.
int circulant_rotate_groups(int B, int H, int N, int D) {
  return bad_shape(B, H, N, D) ? 1 : groups_for(B, H, N, D, BWD_ROWS_PER_THREAD);
}

// x [B, H, N, D] (bf16 or fp32, D a multiple of 4 up to 128) with element
// strides (xb, xh, xn) and a contiguous last dim; ct, st [H, N, K] fp32,
// K = D/2 + 1; fm [D, D + 2] and bm [D + 2, D] fp32 in the spectrum column
// order above; out contiguous [B, H, N, D] like x. Runs on `stream`, does
// not synchronise, allocates nothing; returns the CUDA error code (0 =
// launched, cudaErrorInvalidValue for arguments it refuses).
#define ROT_FWD(SUFFIX, T)                                                                   \
  int circulant_rotate_fwd_##SUFFIX(const void* x, const void* ct, const void* st,          \
                                    const void* fm, const void* bm, void* out, int B, int H, \
                                    int N, int D, int keep_cls, long long xb, long long xh,  \
                                    long long xn, void* stream) {                            \
    const Params p = make_params(B, H, N, D, fwd_rows_per_thread(D), keep_cls, xb, xh, xn,  \
                                 0, 0, 0);                                                   \
    return launch_fwd<T>(x, ct, st, fm, bm, out, p, stream);                                 \
  }
ROT_FWD(bf16, bf16)
ROT_FWD(f32, float)

// The backward: g and x [B, H, N, D] strided as above; dx contiguous like x;
// dct, dst [H, N, K] fp32; work as `circulant_rotate_groups` says (may be
// null with one group). Launches the backward kernel and, with several
// batch groups, two fixed-order sums over them.
#define ROT_BWD(SUFFIX, T)                                                                     \
  int circulant_rotate_bwd_##SUFFIX(const void* g, const void* x, const void* ct,             \
                                    const void* st, const void* fm, const void* bm, void* dx, \
                                    void* dct, void* dst, void* work, int B, int H, int N,    \
                                    int D, int keep_cls, long long gb, long long gh,          \
                                    long long gn, long long xb, long long xh, long long xn,   \
                                    void* stream) {                                            \
    const Params p = make_params(B, H, N, D, BWD_ROWS_PER_THREAD, keep_cls, xb, xh, xn, gb,   \
                                 gh, gn);                                                      \
    return launch_bwd<T>(g, x, ct, st, fm, bm, dx, dct, dst, work, p, stream);                 \
  }
ROT_BWD(bf16, bf16)
ROT_BWD(f32, float)

const char* circulant_rotate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
