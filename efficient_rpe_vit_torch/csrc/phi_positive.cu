// The FAVOR+ positive feature map phi+ and its backward, one kernel each, for Hopper.
//
// Replaces no TPU kernel: in the JAX package `phi_positive` is a chain of
// XLA operations that XLA fuses. The port's plain version
// (ops/feature_maps.py::phi_positive) runs that chain as separate fp32
// PyTorch passes; these two kernels are what it does on the card for bf16 x
// [B, H, N, D] (any strides with a contiguous last dim) and fp32 Omega
// [H, D, F], with D <= 64, D % 8 == 0 and even F <= 272:
//
//   u      = x Omega                                  (fp32-exact, below)
//   nh     = bf16(sum_d bf16(x_d^2)) / 2              (x's dtype, as the plain
//                                                      version's (x * x).sum() / 2)
//   phi    = bf16(exp((u - max_f u) - nh) * (1 / sqrt(F)))   [B, H, N, F] contiguous
//
// (exp on the special-function unit, 2^(z log2 e), within about 2^-21 of
// expf, far below a bf16 step; below 2^-126 it flushes to zero),
//
// and from the cotangent g [B, H, N, F] (bf16), with the row max a detached
// stabiliser as in the plain version:
//
//   dz     = (g * (1 / sqrt(F))) * exp((u - max_f u) - nh)          (fp32)
//   dsq    = bf16(-sum_f dz) / 2
//   dx     = bf16(2 bf16(dsq x) + bf16(dz Omega^T))
//
// which are autograd's rounding points for the plain chain: the fp32 grad
// of nh is summed and cast to bf16, x * x passes bf16(dsq x) to each of its
// two operands, x.float() casts dz Omega^T to bf16, and the three reach x
// in that order.
//
// What bounds it on an H100, at the ViT-B/16 shape (B=128, H=12, N=197,
// D=64, F=266): the forward reads x (38.7 MB) and writes phi (161 MB); the
// backward reads x and g and writes dx; about 10.5 GB a train step over q
// and k in 12 layers, 3.1 ms at 3.35 TB/s. The products at fp32 accuracy,
// as three bf16 tensor-core passes, come to about 2.2 ms a step at 989
// TFLOP/s. The plain chain wrote the fp32 projection [B, H, N, F] (322 MB)
// and read and wrote it again in each of its passes (max, subtract, exp,
// scale, cast), then rebuilt it all in the backward: 139.5 ms a step.
//
// Design. One block per SM, kept for the whole launch (blocks = SMs, split
// over the heads); a block stages Omega_h once and its eight warps then walk
// 16-row groups of the head's B * N rows (b and n flattened, so no group is
// padded to N), each warp on its own: no block barrier after the staging.
//
//   - fp32 accuracy on bf16 tensor cores: Omega is split into three bf16
//     planes, hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid),
//     whose sum is w exactly (each remainder is exact in fp32). x is bf16,
//     so every product x * plane is exact in fp32, and u = x lo + x mid +
//     x hi (the small planes first) on mma.sync.m16n8k16 with fp32
//     accumulators differs from an fp32 product only in the order of its
//     sums. Omega is never rounded. In the backward dz is split the same
//     way and dz Omega^T takes the six products whose parts are above
//     2^-27 of the result (dz_lo Omega_hi, dz_mid Omega_mid, dz_hi
//     Omega_lo, dz_mid Omega_hi, dz_hi Omega_mid, dz_hi Omega_hi). Each
//     mma rounds its fp32 result, so a 16-feature step's six products are
//     summed from zero and then added to the running sum once: 17 roundings
//     of the sum at F = 266, against 102 if every product went into it.
//   - a warp's 16 rows x 272 features of u stay in registers (136 fp32 a
//     thread) from the projection to the row max (quad shuffles), the exp
//     and the bf16 pack; ||x||^2 comes from the x fragments.
//   - Omega_h^T is staged as [F, D + 8] per plane (117,504 B at F = 272):
//     ldmatrix reads it as the B operand of x Omega (rows) and of dz Omega^T
//     (columns, transposed), and the +8 puts eight row addresses on distinct
//     banks.
//   - x rows (128 bytes at D = 64) come by 16-byte cp.async, the next
//     group's while this one is computed (forward). A group's phi rows are
//     one contiguous byte range in the output (rows of 532 bytes at F =
//     266, not 16-byte aligned): the warp packs them into shared memory at
//     the same address modulo 16 as their destination and stores the range
//     with 16-byte words (4-byte words at its ends, and for the rows after
//     a batch boundary inside the group). The backward stages g the same
//     way with cp.async.
//   - the backward recomputes u with the same fragments in the same order,
//     so its max and exp are bitwise the forward's; each 16-feature step of
//     dz is formed, summed and split into the A fragments of dz Omega^T at
//     once, so dz never leaves registers.
//
// Every sum runs in one order: phi and dx are bitwise the same run to run.
// Launches run on the caller's stream, allocate nothing and check
// cudaGetLastError.

#include "flash_attention_mma.cuh"

#include <cmath>

namespace {

using flash::bf16;
namespace fm = flash::mma;

constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;
constexpr int DP = 64;       // staged head dim: D <= 64, zero past D
constexpr int KD = DP / 16;  // 16-steps of u = x Omega
constexpr int LDX = DP + 8;  // row stride (elements) of the Omega^T planes and the x tiles
constexpr int FMAX = 272;    // most features a launch takes

// Shared memory of a block: the three planes of Omega_h^T [FP, LDX] (hi,
// mid, lo), then per warp two x tiles [16, LDX] and a byte range for its 16
// rows of phi (forward) or of g (backward), 16 bytes longer than the rows
// so that they can start at any 4-byte offset modulo 16. Every F takes this
// one geometry: the loops stop at the launch's own F.
struct Geo {
  static constexpr int FP = FMAX;     // staged features
  static constexpr int KF = FP / 16;  // 16-feature steps
  static constexpr int NB = FP / 8;   // 8-column accumulator blocks of u
  static constexpr size_t PLANE = (size_t)FP * LDX * sizeof(bf16);
  static constexpr size_t XTILE = (size_t)16 * LDX * sizeof(bf16);
  static constexpr size_t ROWS = ((size_t)16 * FP * sizeof(bf16) + 16 + 15) / 16 * 16;
  static constexpr size_t WARP_BYTES = 2 * XTILE + ROWS;
  static constexpr size_t BYTES = 3 * PLANE + WARPS * WARP_BYTES;
  static_assert(FP % 16 == 0, "staged features");
  static_assert(PLANE % 16 == 0 && XTILE % 16 == 0 && ROWS % 16 == 0, "16-byte regions");
};

// What every launch takes besides its tensors.
struct Args {
  int B, H, N, D, F;
  long long xb, xh, xn;  // x's element strides
  long long db, dh, dn;  // dx's (backward)
  float scale;           // 1 / sqrt(F) as fp32
};

bool takes(int D, int F) { return D > 0 && D <= DP && D % 8 == 0 && F > 0 && F % 2 == 0 && F <= FMAX; }

bool bad_dims(int B, int H, int N, int D, int F) {
  return B <= 0 || H <= 0 || N <= 0 || !takes(D, F);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// exp(z) on the special-function unit: 2^(z log2 e), about 2^-21 relative
// against bf16's 2^-9 step; results below 2^-126 (z < -87) flush to zero.
__device__ __forceinline__ float exp_sfu(float z) { return fm::ex2(z * fm::LOG2E); }

// v = hi + mid + lo exactly, each part bf16.
__device__ __forceinline__ void split3(float v, bf16& hi, bf16& mid, bf16& lo) {
  hi = __float2bfloat16(v);
  const float r = v - __bfloat162float(hi);
  mid = __float2bfloat16(r);
  lo = __float2bfloat16(r - __bfloat162float(mid));
}

__device__ __forceinline__ uint32_t pack(bf16 a, bf16 b) {
  const __nv_bfloat162 v = __halves2bfloat162(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Omega_h ([D, F] fp32, row-major) as its three planes of Omega_h^T, zero at
// features >= F and head dims >= D.
__device__ __forceinline__ void stage_planes(bf16* planes, const float* __restrict__ om, int D,
                                             int F) {
  constexpr size_t P = (size_t)Geo::FP * LDX;
  for (int idx = threadIdx.x; idx < Geo::FP * DP; idx += NT) {
    const int d = idx / Geo::FP;
    const int f = idx - d * Geo::FP;
    const float w = (d < D && f < F) ? __ldg(om + (size_t)d * F + f) : 0.f;
    bf16 hi, mid, lo;
    split3(w, hi, mid, lo);
    const int at = f * LDX + d;
    planes[at] = hi;
    planes[P + at] = mid;
    planes[2 * P + at] = lo;
  }
}

// Row r (b and n flattened) of head h in a tensor with element strides
// (sb, sh, sn).
__device__ __forceinline__ long long row_at(long long r, int N, int h, long long sb,
                                            long long sh, long long sn) {
  const long long b = r / N;
  return b * sb + h * sh + (r - b * N) * sn;
}

// The warp's rows r0 .. r0 + 15 of x into a [16, LDX] tile by 16-byte
// cp.async, zero past D and past the last row; committed by the caller.
__device__ __forceinline__ void stage_x(bf16* tile, const bf16* __restrict__ x, const Args& a,
                                        int h, long long r0, long long rows) {
  constexpr int W = DP / 8;  // 16-byte words of a staged row
  const int lane = threadIdx.x % 32;
  const int words = a.D / 8;
  for (int i = lane; i < 16 * W; i += 32) {
    const int r = i / W, w = i - r * W;
    const bool valid = r0 + r < rows && w < words;
    const bf16* src = valid ? x + row_at(r0 + r, a.N, h, a.xb, a.xh, a.xn) + 8 * w : x;
    flash::cp_async<16>(tile + r * LDX + 8 * w, src, valid ? 16 : 0);
  }
}

// Where a byte range [0, bytes) is moved by 16-byte words: from `head` to
// `head + body`, when both ends agree modulo 16; the rest by 4-byte words.
__device__ __forceinline__ void word_split(uintptr_t g, uintptr_t s, int bytes, int& head,
                                           int& body) {
  head = bytes;
  body = 0;
  if (((g ^ s) & 15) == 0) {
    head = (int)((16 - (g & 15)) & 15);
    if (head > bytes) head = bytes;
    body = (bytes - head) / 16 * 16;
  }
}

// Store `bytes` (a multiple of 4) from shared src to global dst with the warp.
__device__ __forceinline__ void warp_store(char* dst, const char* src, int bytes) {
  const int lane = threadIdx.x % 32;
  int head, body;
  word_split(reinterpret_cast<uintptr_t>(dst), reinterpret_cast<uintptr_t>(src), bytes, head,
             body);
  for (int i = 4 * lane; i < head; i += 128)
    *reinterpret_cast<uint32_t*>(dst + i) = *reinterpret_cast<const uint32_t*>(src + i);
  for (int i = head + 16 * lane; i < head + body; i += 512)
    *reinterpret_cast<int4*>(dst + i) = *reinterpret_cast<const int4*>(src + i);
  for (int i = head + body + 4 * lane; i < bytes; i += 128)
    *reinterpret_cast<uint32_t*>(dst + i) = *reinterpret_cast<const uint32_t*>(src + i);
}

// Stage `bytes` (a multiple of 4) of global src into shared dst with the
// warp by cp.async; committed by the caller.
__device__ __forceinline__ void warp_stage(char* dst, const char* src, int bytes) {
  const int lane = threadIdx.x % 32;
  int head, body;
  word_split(reinterpret_cast<uintptr_t>(src), reinterpret_cast<uintptr_t>(dst), bytes, head,
             body);
  for (int i = 4 * lane; i < head; i += 128) flash::cp_async<4>(dst + i, src + i, 4);
  for (int i = head + 16 * lane; i < head + body; i += 512) flash::cp_async<16>(dst + i, src + i, 16);
  for (int i = head + body + 4 * lane; i < bytes; i += 128) flash::cp_async<4>(dst + i, src + i, 4);
}

// The rows r0 .. min(r0 + 16, rows) of a [B, H, N, F] contiguous tensor
// (element base t) against the warp's packed rows at s: each run of rows of
// one batch is one contiguous range. Stores them (STORE) or stages them.
template <bool STORE>
__device__ __forceinline__ void move_rows(bf16* t, bf16* s, const Args& a, int h, long long r0,
                                          long long rows) {
  const long long end = r0 + 16 < rows ? r0 + 16 : rows;
  int local = 0;
  for (long long r = r0; r < end;) {
    const long long b = r / a.N, n = r - b * a.N;
    const int len = (int)(end - r < a.N - n ? end - r : a.N - n);
    char* g = reinterpret_cast<char*>(t + ((b * a.H + h) * a.N + n) * a.F);
    char* l = reinterpret_cast<char*>(s + (size_t)local * a.F);
    const int bytes = len * a.F * (int)sizeof(bf16);
    if constexpr (STORE) warp_store(g, l, bytes);
    else warp_stage(l, g, bytes);
    r += len;
    local += len;
  }
}

// The warp's packed rows in its byte range: at the offset modulo 16 of row
// r0's first element in t, so that its range moves by 16-byte words.
__device__ __forceinline__ bf16* packed_rows(unsigned char* range, const bf16* t, const Args& a,
                                             int h, long long r0) {
  const long long b = r0 / a.N;
  const bf16* first = t + ((b * a.H + h) * a.N + (r0 - b * a.N)) * a.F;
  return reinterpret_cast<bf16*>(range + (reinterpret_cast<uintptr_t>(first) & 15));
}

// ||x||^2 / 2 of this thread's fragment rows (r, r + 8) from the A
// fragments of x, rounded as the plain version rounds it: each square to
// bf16, the fp32 sum to bf16, then halved.
__device__ __forceinline__ void half_norms(float (&nh)[2], const uint32_t (&xa)[KD][4], int kd) {
  nh[0] = nh[1] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    if (kk >= kd) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // registers 0, 2: row r; 1, 3: row r + 8
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[kk][j]));
      nh[j & 1] += bf16_round(v.x * v.x);
      nh[j & 1] += bf16_round(v.y * v.y);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    nh[half] += __shfl_xor_sync(0xffffffffu, nh[half], 1);
    nh[half] += __shfl_xor_sync(0xffffffffu, nh[half], 2);
    nh[half] = bf16_round(nh[half]) * 0.5f;
  }
}

// u = x lo + x mid + x hi for the warp's 16 rows over kf 16-feature steps,
// and the row maxima over the F real features (fmaxf: exact in any order).
__device__ __forceinline__ void project(float (&u)[Geo::NB][4], float (&mx)[2],
                                        const uint32_t (&xa)[KD][4], const bf16* planes, int kd,
                                        int kf, int F) {
#pragma unroll
  for (int nb = 0; nb < Geo::NB; ++nb) u[nb][0] = u[nb][1] = u[nb][2] = u[nb][3] = 0.f;
#pragma unroll
  for (int pl = 2; pl >= 0; --pl) {
    const bf16* om = planes + (size_t)pl * Geo::FP * LDX;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (kk >= kd) break;
#pragma unroll
      for (int p = 0; p < Geo::KF; ++p) {
        if (p >= kf) break;
        uint32_t b[4];
        fm::load_b_rows(b, om, LDX, p * 16, kk * 16);
        fm::mma_bf16(u[2 * p], xa[kk], b[0], b[1]);
        fm::mma_bf16(u[2 * p + 1], xa[kk], b[2], b[3]);
      }
    }
  }
  const int qc = 2 * (threadIdx.x % 4);
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int nb = 0; nb < Geo::NB; ++nb) {
    if (nb >= 2 * kf) break;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e / 2] = fmaxf(mx[e / 2], nb * 8 + qc + (e & 1) < F ? u[nb][e] : -INFINITY);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
  }
}

// Row r (b and n flattened) of head h in a contiguous [B, H, N, cols] tensor,
// and a warp's fp32 accumulators of 16 rows x 8 NB columns stored there
// (the RAW checks), rows and columns past the ends left out.
template <typename T>
__device__ __forceinline__ T* raw_row(T* t, const Args& a, int h, long long r, int cols) {
  const long long b = r / a.N;
  return t + ((b * a.H + h) * a.N + (r - b * a.N)) * cols;
}

template <int NB>
__device__ __forceinline__ void store_raw(float* t, const float (&acc)[NB][4], const Args& a,
                                          int h, long long r0, long long rows, int cols) {
  const int lane = threadIdx.x % 32, qc = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long r = r0 + lane / 4 + 8 * half;
    if (r >= rows) continue;
    float* o = raw_row(t, a, h, r, cols);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int c = nb * 8 + qc;
      if (c >= cols) break;
      *reinterpret_cast<float2*>(o + c) = make_float2(acc[nb][2 * half], acc[nb][2 * half + 1]);
    }
  }
}

// The warp's x tile of group iteration `it` (two alternate).
__device__ __forceinline__ bf16* x_tile(unsigned char* mine, int it) {
  return reinterpret_cast<bf16*>(mine + (it & 1) * (16 * LDX * sizeof(bf16)));
}

// The x tile's A fragments, ||x||^2 / 2, u and its row maxima for a group.
__device__ __forceinline__ void group_u(float (&u)[Geo::NB][4], float (&mx)[2], float (&nh)[2],
                                        const bf16* tile, const bf16* planes, int kd, int kf,
                                        int F) {
  uint32_t xa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    if (kk < kd) fm::load_a(xa[kk], tile, LDX, 0, kk * 16);
  half_norms(nh, xa, kd);
  project(u, mx, xa, planes, kd, kf, F);
}

// RAW (a check of the products, not the feature map): out is fp32
// [B, H, N, F] and receives u itself.
template <bool RAW>
__global__ void __launch_bounds__(NT, 1)
phi_pos_fwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ omega,
                       void* __restrict__ y, const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x % a.H;
  const int part = blockIdx.x / a.H, parts = gridDim.x / a.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, qc = 2 * (lane % 4);
  const bf16* planes = reinterpret_cast<const bf16*>(smem);
  unsigned char* mine = smem + 3 * Geo::PLANE + warp * Geo::WARP_BYTES;
  unsigned char* range = mine + 2 * Geo::XTILE;
  const long long rows = (long long)a.B * a.N, groups = (rows + 15) / 16;
  const long long step = (long long)parts * WARPS;
  const int kd = (a.D + 15) / 16, kf = (a.F + 15) / 16;

  long long grp = (long long)part * WARPS + warp;
  if (grp < groups) stage_x(x_tile(mine, 0), x, a, h, 16 * grp, rows);
  fm::cp_async_commit();
  stage_planes(reinterpret_cast<bf16*>(smem), omega + (size_t)h * a.D * a.F, a.D, a.F);
  __syncthreads();
  for (int it = 0; grp < groups; grp += step, ++it) {
    if (grp + step < groups) stage_x(x_tile(mine, it + 1), x, a, h, 16 * (grp + step), rows);
    fm::cp_async_commit();
    fm::cp_async_wait<1>();
    __syncwarp();
    float u[Geo::NB][4], mx[2], nh[2];
    group_u(u, mx, nh, x_tile(mine, it), planes, kd, kf, a.F);
    if constexpr (RAW) {
      store_raw<Geo::NB>(static_cast<float*>(y), u, a, h, 16 * grp, rows, a.F);
      __syncwarp();
      continue;
    }
    bf16* out = static_cast<bf16*>(y);
    bf16* s = packed_rows(range, out, a, h, 16 * grp);
#pragma unroll
    for (int nb = 0; nb < Geo::NB; ++nb) {
      const int c = nb * 8 + qc;
      if (nb >= 2 * kf) break;
      if (c >= a.F) continue;  // F is even: a pair is whole or wholly past F
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v0 = exp_sfu((u[nb][2 * half] - mx[half]) - nh[half]) * a.scale;
        const float v1 = exp_sfu((u[nb][2 * half + 1] - mx[half]) - nh[half]) * a.scale;
        *reinterpret_cast<__nv_bfloat162*>(s + (lane / 4 + 8 * half) * a.F + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncwarp();
    move_rows<true>(out, s, a, h, 16 * grp, rows);
    __syncwarp();  // the packed rows and this x tile are refilled next
  }
}

// RAW (a check of the products): g is dz itself, fp32 [B, H, N, F], and dx
// is fp32 [B, H, N, D] and receives dz Omega^T.
template <bool RAW>
__global__ void __launch_bounds__(NT, 1)
phi_pos_bwd_mma_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
                       const float* __restrict__ omega, void* __restrict__ dx, const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x % a.H;
  const int part = blockIdx.x / a.H, parts = gridDim.x / a.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, qc = 2 * (lane % 4);
  const bf16* planes = reinterpret_cast<const bf16*>(smem);
  constexpr size_t P = (size_t)Geo::FP * LDX;
  unsigned char* mine = smem + 3 * Geo::PLANE + warp * Geo::WARP_BYTES;
  unsigned char* range = mine + 2 * Geo::XTILE;
  bf16* gt = const_cast<bf16*>(g);
  const long long rows = (long long)a.B * a.N, groups = (rows + 15) / 16;
  const long long step = (long long)parts * WARPS;
  const int kd = (a.D + 15) / 16, kf = (a.F + 15) / 16;

  long long grp = (long long)part * WARPS + warp;
  if (grp < groups) {
    stage_x(x_tile(mine, 0), x, a, h, 16 * grp, rows);
    if constexpr (!RAW)
      move_rows<false>(gt, packed_rows(range, g, a, h, 16 * grp), a, h, 16 * grp, rows);
  }
  fm::cp_async_commit();
  stage_planes(reinterpret_cast<bf16*>(smem), omega + (size_t)h * a.D * a.F, a.D, a.F);
  __syncthreads();
  for (int it = 0; grp < groups; grp += step, ++it) {
    const bf16* tile = x_tile(mine, it);
    fm::cp_async_wait<0>();
    __syncwarp();
    float u[Geo::NB][4], mx[2], nh[2];
    group_u(u, mx, nh, tile, planes, kd, kf, a.F);
    const bf16* gs = packed_rows(range, g, a, h, 16 * grp);
    float acc[DP / 8][4];
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int p = 0; p < Geo::KF; ++p) {
      if (p >= kf) break;
      // dz of features 16p .. 16p + 15 as the A fragments of its three
      // planes (to_a's packing: register 2 hb + half)
      uint32_t ah[4], am[4], al[4];
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const int c = p * 16 + hb * 8 + qc;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float z0 = 0.f, z1 = 0.f;
          if constexpr (RAW) {  // dz given, fp32 [B, H, N, F]
            const long long rr = 16 * grp + lane / 4 + 8 * half;
            if (rr < rows && c < a.F) {
              const float2 zv = *reinterpret_cast<const float2*>(
                  raw_row(reinterpret_cast<const float*>(g), a, h, rr, a.F) + c);
              z0 = zv.x;
              z1 = zv.y;
            }
          } else {
            float2 gv = make_float2(0.f, 0.f);
            if (c < a.F)
              gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  gs + (lane / 4 + 8 * half) * a.F + c));
            const float* uu = &u[2 * p + hb][2 * half];
            z0 = (gv.x * a.scale) * exp_sfu((uu[0] - mx[half]) - nh[half]);
            z1 = (gv.y * a.scale) * exp_sfu((uu[1] - mx[half]) - nh[half]);
            z0 = c < a.F ? z0 : 0.f;
            z1 = c < a.F ? z1 : 0.f;
          }
          sum[half] += z0;
          sum[half] += z1;
          bf16 h0, m0, l0, h1, m1, l1;
          split3(z0, h0, m0, l0);
          split3(z1, h1, m1, l1);
          ah[2 * hb + half] = pack(h0, h1);
          am[2 * hb + half] = pack(m0, m1);
          al[2 * hb + half] = pack(l0, l1);
        }
      }
#pragma unroll
      for (int np = 0; np < KD; ++np) {
        if (np >= kd) break;
        uint32_t bh[4], bm[4], bl[4];
        fm::load_b_cols(bh, planes, LDX, p * 16, np * 16);
        fm::load_b_cols(bm, planes + P, LDX, p * 16, np * 16);
        fm::load_b_cols(bl, planes + 2 * P, LDX, p * 16, np * 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // this step's six products from zero, the small ones first, then
          // one fp32 add (round to nearest) into the running sum: each mma
          // rounds its result, so the running sum takes one rounding a step
          // instead of six
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          fm::mma_bf16(t, al, bh[2 * j], bh[2 * j + 1]);
          fm::mma_bf16(t, am, bm[2 * j], bm[2 * j + 1]);
          fm::mma_bf16(t, ah, bl[2 * j], bl[2 * j + 1]);
          fm::mma_bf16(t, am, bh[2 * j], bh[2 * j + 1]);
          fm::mma_bf16(t, ah, bm[2 * j], bm[2 * j + 1]);
          fm::mma_bf16(t, ah, bh[2 * j], bh[2 * j + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[2 * np + j][e] += t[e];
        }
      }
    }
    __syncwarp();  // every lane has read its g rows: the next group's may come
    const long long next = grp + step;
    if (next < groups) {
      stage_x(x_tile(mine, it + 1), x, a, h, 16 * next, rows);
      if constexpr (!RAW)
        move_rows<false>(gt, packed_rows(range, g, a, h, 16 * next), a, h, 16 * next, rows);
    }
    fm::cp_async_commit();
    if constexpr (RAW) {
      store_raw<DP / 8>(static_cast<float*>(dx), acc, a, h, 16 * grp, rows, a.D);
      __syncwarp();
      continue;
    }
    float dsq[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
      dsq[half] = bf16_round(-sum[half]) * 0.5f;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = lane / 4 + 8 * half;
      const long long rr = 16 * grp + r;
      if (rr >= rows) continue;
      bf16* o = static_cast<bf16*>(dx) + row_at(rr, a.N, h, a.db, a.dh, a.dn);
#pragma unroll
      for (int nb = 0; nb < DP / 8; ++nb) {
        const int c = nb * 8 + qc;
        if (c >= a.D) break;
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + r * LDX + c));
        const float v0 = 2.f * bf16_round(dsq[half] * xv.x) + bf16_round(acc[nb][2 * half]);
        const float v1 = 2.f * bf16_round(dsq[half] * xv.y) + bf16_round(acc[nb][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncwarp();  // this x tile is refilled two groups on
  }
}

template <bool RAW>
const void* kernel_of(bool backward) {
  return backward ? reinterpret_cast<const void*>(phi_pos_bwd_mma_kernel<RAW>)
                  : reinterpret_cast<const void*>(phi_pos_fwd_mma_kernel<RAW>);
}

const void* kernel_for(bool backward, bool raw) {
  return raw ? kernel_of<true>(backward) : kernel_of<false>(backward);
}

// Blocks of the launch: as many as are resident at once on the card, split
// evenly over the heads, and no more than a head's groups need.
int grid_of(const void* kernel, size_t bytes, int B, int H, int N, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long groups = ((long long)B * N + 15) / 16;
  long long parts = (long long)sms * per_sm / H;
  const long long most = (groups + WARPS - 1) / WARPS;
  if (parts > most) parts = most;
  if (parts < 1) parts = 1;
  *grid = (int)(parts * H);
  return cudaSuccess;
}

int launch(bool backward, bool raw, const void* g, const void* x, const void* omega, void* y,
           const Args& a, void* stream) {
  if (bad_dims(a.B, a.H, a.N, a.D, a.F)) return cudaErrorInvalidValue;
  const size_t bytes = Geo::BYTES;
  const void* kernel = kernel_for(backward, raw);
  int err = flash::prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = grid_of(kernel, bytes, a.B, a.H, a.N, &grid);
  if (err != cudaSuccess) return err;
  Args args = a;
  void* params[5];
  int n = 0;
  if (backward) params[n++] = const_cast<void**>(&g);
  params[n++] = const_cast<void**>(&x);
  params[n++] = const_cast<void**>(&omega);
  params[n++] = &y;
  params[n++] = &args;
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(NT), params, bytes,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, H, N, D] bf16 with element strides (xb, xh, xn), its rows 16-byte
// aligned (strides multiples of 8, a 16-byte aligned base), the last dim
// contiguous; omega [H, D, F] fp32 contiguous; out [B, H, N, F] bf16
// contiguous; scale = 1 / sqrt(F) in fp32. Runs phi_pos_fwd_mma_kernel on
// `stream`, does not synchronise, allocates nothing. Returns the CUDA error
// code (0 = launched; cudaErrorInvalidValue for empty dims or a (D, F)
// outside phi_pos_takes).
int phi_pos_fwd_bf16(const void* x, const void* omega, void* out, int B, int H, int N, int D,
                     int F, long long xb, long long xh, long long xn, float scale,
                     void* stream) {
  const Args a{B, H, N, D, F, xb, xh, xn, 0, 0, 0, scale};
  return launch(false, false, nullptr, x, omega, out, a, stream);
}

// g [B, H, N, F] bf16 contiguous, the cotangent of phi; x and omega as
// phi_pos_fwd_bf16; dx like x with element strides (db, dh, dn), its rows
// 4-byte aligned. Runs phi_pos_bwd_mma_kernel, as phi_pos_fwd_bf16 does.
int phi_pos_bwd_bf16(const void* g, const void* x, const void* omega, void* dx, int B, int H,
                     int N, int D, int F, long long xb, long long xh, long long xn,
                     long long db, long long dh, long long dn, float scale, void* stream) {
  const Args a{B, H, N, D, F, xb, xh, xn, db, dh, dn, scale};
  return launch(true, false, g, x, omega, dx, a, stream);
}

// The products alone, in fp32, for checks of their precision: u = x Omega
// into y [B, H, N, F] (backward = 0, g unused), or dz Omega^T into y [B, H,
// N, D] from a given fp32 dz [B, H, N, F] in g (backward = 1), all
// contiguous, by the same fragments in the same order as the two kernels
// above.
int phi_pos_products(int backward, const void* g, const void* x, const void* omega, void* y,
                     int B, int H, int N, int D, int F, long long xb, long long xh,
                     long long xn, float scale, void* stream) {
  const Args a{B, H, N, D, F, xb, xh, xn, 0, 0, 0, scale};
  return launch(backward != 0, true, g, x, omega, y, a, stream);
}

// 1 where the kernels take head dim D and F features: D <= 64 with D % 8
// == 0, even F <= 272.
int phi_pos_takes(int D, int F) { return takes(D, F) ? 1 : 0; }

// What a forward (backward = 0) or backward launch at (F, D) runs, in
// info[0..6]: rows per warp group, threads, dynamic shared memory bytes,
// resident blocks per SM, registers per thread, local (spilled) bytes per
// thread, and 1 (an mma.sync kernel). Returns the CUDA error code.
int phi_pos_launch_info(int backward, int F, int D, int* info) {
  if (!takes(D, F)) return cudaErrorInvalidValue;
  return fm::launch_info(kernel_for(backward != 0, false), 16, NT, Geo::BYTES, true, info);
}

const char* phi_pos_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
