// Flash attention for Hopper: non-causal softmax(Q K^T / sqrt(d)) V, forward and
// backward, with the [N, N] logits never in device memory.
//
// Replaces the Pallas TPU kernel behind `_flash_sdpa` in
// toycrystals_tpu/ops/attention.py (jax.experimental.pallas.ops.tpu
// .flash_attention: one forward kernel plus the dKV and dQ backward kernels of
// its custom VJP). It computes what that kernel computes and is not carried
// over block by block: the TPU kernel walks 1,024-wide q/k tiles with a
// sequential grid that carries the running max and sum in VMEM scratch. Here
// blocks run in no order, so the key loop lives inside the block:
//
//   forward   one block per (item, head, 64 query rows), 4 warps x 16 rows;
//             loop over 64-key tiles staged in shared memory: S = Q K^T,
//             running max m and sum l per row in f32 registers (exp2 with
//             scale * log2(e) folded once, in f32), P rounded to bf16 and
//             multiplied into the f32 accumulator of O. Writes O in the input
//             type and the row log-sum-exp L = m + log(l) as f32 [B, H, N].
//   delta     delta = rowsum(dO * O) in f32, [B, H, N].
//   dK/dV     one block per (item, head, 64 keys), loop over query tiles:
//             P^T = exp(S^T - L), dV += P^T dO, dP^T = V dO^T,
//             dS^T = P^T * (dP^T - delta), dK += dS^T Q; dK scaled at the end.
//   dQ        one block per (item, head, 64 query rows), loop over key tiles:
//             dQ += dS K, scaled at the end.
//
// No atomics anywhere: every output element has one owner, so results are
// the same from run to run.
//
// Bound: operations. One forward at [B, N, H, d] does 4 B H N^2 d operations
// on (3 reads + 1 write) B N H d elements: at N = 4,096 and d = 48 about
// 2,000 operations per byte, far above the card's ~295. So the products run on
// the tensor cores in bf16 (mma.sync.m16n8k16, f32 accumulation): the C
// fragment of S is, register for register, the A fragment of the second
// product, so P never leaves registers. K and V rows sit in shared memory at a
// pitch of d + 8 elements, which makes the 32-bit fragment loads and ldmatrix
// conflict-free. wgmma, TMA and an asynchronous pipeline are left to a later
// change; this version relies on several blocks per SM to hide the tile loads.
//
// float32 inputs are the checking type, not the working one: the same kernel
// templates instantiate a plain f32-FMA body (one thread per row, K/V tiles
// in shared memory, expf), with no tensor cores and no TF32.
//
// One head dim per build: compile with -DFLASH_HEAD_DIM=<multiple of 16, at
// most 128>. q, k, v arrive as [B, N, H, d] views given by element strides (d
// contiguous, rows 16-byte aligned); N must be a multiple of 128.
//
// Plain C interface, built with nvcc and loaded through ctypes
// (toycrystals_torch/ops/attention.py). Launches go on the caller's stream;
// each function returns the first cudaError_t it met.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef FLASH_HEAD_DIM
#define FLASH_HEAD_DIM 48
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = FLASH_HEAD_DIM;
static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head dim: a multiple of 16 up to 128");

constexpr int kThreads = 128;
constexpr int kTile = 64;    // bf16 bodies: query rows per block and keys per tile
constexpr int kLd = D + 8;   // bf16 shared-memory row pitch, in elements
constexpr int kRowsF = 128;  // f32 bodies: rows per block, one per thread
constexpr int kTileF = 32;   // f32 bodies: rows per shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;  // [B, N, H, D] views: element strides below, D contiguous
  const void* k;
  const void* v;
  const void* o;     // backward: the forward's output, contiguous [B, N, H, D]
  const void* dout;  // backward: its cotangent, contiguous [B, N, H, D]
  void* out;         // forward: O, contiguous [B, N, H, D]
  float* lse;        // [B, H, N]
  float* delta;      // [B, H, N]
  void* dq;          // gradients: element strides gsb, gsn, gsh
  void* dk;
  void* dv;
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, gsb, gsn, gsh;
  int B, N, H;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// kTile rows of D bf16 (row r at src + r * stride) into dst[r][kLd].
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const uint4 v = *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * kLd + c * 8) = v;
  }
}

// A fragment (16 x 16, row-major) of a shared tile: rows row0.., columns k0..
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int k0,
                                       int lane) {
  const bf16* p = tile + (row0 + (lane >> 2)) * kLd + k0 + (lane & 3) * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * kLd);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * kLd + 8);
}

// B fragment (16 x 8) with B(k, n) = X[n0 + n][k0 + k] for a shared tile X[n][k].
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[2], const bf16* tile, int n0, int k0,
                                          int lane) {
  const bf16* p = tile + (n0 + (lane >> 2)) * kLd + k0 + (lane & 3) * 2;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragments of two neighbouring n-tiles (n0 and n0 + 8) with
// B(k, n) = X[k0 + k][n0 + n] for a shared tile X[k][n]: b[0..1] and b[2..3].
__device__ __forceinline__ void load_b_kn_x2(uint32_t (&b)[4], const bf16* tile, int k0, int n0,
                                             int lane) {
  const bf16* p = tile + (k0 + (lane & 15)) * kLd + n0 + (lane >> 4) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16) * b (16 x 8, bf16).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] (16 x 64) += A[row0.., :] * X^T, A and X shared tiles of D columns.
__device__ __forceinline__ void mma_rows_by_rows(float (&acc)[8][4], const bf16* a_tile,
                                                 int row0, const bf16* x_tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a(a, a_tile, row0, kk * 16, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t b[2];
      load_b_nk(b, x_tile, nt * 8, kk * 16, lane);
      mma(acc[nt], a, b[0], b[1]);
    }
  }
}

// acc (16 x D) += P (16 x 64, a C-fragment array) * X (64 x D shared tile).
__device__ __forceinline__ void mma_frag_by_tile(float (&acc)[D / 8][4], const float (&p)[8][4],
                                                 const bf16* x_tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack2(p[2 * kk][0], p[2 * kk][1]), pack2(p[2 * kk][2], p[2 * kk][3]),
                           pack2(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack2(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      load_b_kn_x2(b, x_tile, kk * 16, dn * 16, lane);
      mma(acc[2 * dn], a, b[0], b[1]);
      mma(acc[2 * dn + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A warp's 16 x D accumulator, times `mul[0]` (rows g) and `mul[1]` (rows
// g + 8), to rows row0.. of a [.., D] tensor with row stride `stride`.
__device__ __forceinline__ void store_rows(bf16* dst, long long stride, int row0,
                                           const float (&acc)[D / 8][4], float mul0, float mul1,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  bf16* r0 = dst + static_cast<long long>(row0 + g) * stride + t * 2;
  bf16* r1 = r0 + 8 * stride;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    *reinterpret_cast<uint32_t*>(r0 + dn * 8) = pack2(acc[dn][0] * mul0, acc[dn][1] * mul0);
    *reinterpret_cast<uint32_t*>(r1 + dn * 8) = pack2(acc[dn][2] * mul1, acc[dn][3] * mul1);
  }
}

__device__ void fwd_mma(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTile * kLd;
  bf16* vs = ks + kTile * kLd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh + q0 * p.qsn;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ksb + h * p.ksh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vsb + h * p.vsh;

  load_tile(qs, q, p.qsn);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], qs, warp * 16, kk * 16, lane);

  float oacc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) oacc[dn][0] = oacc[dn][1] = oacc[dn][2] = oacc[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max, in log2 units
  float l[2] = {0.f, 0.f};              // this thread's share of the running row sum
  const float sl2 = p.scale * kLog2e;

  for (int k0 = 0; k0 < p.N; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile(ks, k + k0 * p.ksn, p.ksn);
    load_tile(vs, v + k0 * p.vsn, p.vsn);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bb[2];
        load_b_nk(bb, ks, nt * 8, kk * 16, lane);
        mma(s[nt], qf[kk], bb[0], bb[1]);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // scale > 0, so the max commutes with the scaling; m = -inf on the
      // first tile gives corr = exp2(-inf) = 0 against a finite new max
      const float mn = fmaxf(m[r], quad_max(mx[r]) * sl2);
      corr[r] = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] * sl2 - m[0]);
      s[nt][1] = exp2f(s[nt][1] * sl2 - m[0]);
      s[nt][2] = exp2f(s[nt][2] * sl2 - m[1]);
      s[nt][3] = exp2f(s[nt][3] * sl2 - m[1]);
      l[0] += s[nt][0] + s[nt][1];
      l[1] += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      oacc[dn][0] *= corr[0];
      oacc[dn][1] *= corr[0];
      oacc[dn][2] *= corr[1];
      oacc[dn][3] *= corr[1];
    }
    mma_frag_by_tile(oacc, s, vs, lane);
  }

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  const long long row_stride = static_cast<long long>(p.H) * D;
  bf16* o = static_cast<bf16*>(p.out) + (static_cast<long long>(b) * p.N * p.H + h) * D;
  store_rows(o, row_stride, q0 + warp * 16, oacc, 1.f / l[0], 1.f / l[1], lane);
  if ((lane & 3) == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.N + q0 + warp * 16 + (lane >> 2);
    lse[0] = m[0] * kLn2 + logf(l[0]);
    lse[8] = m[1] * kLn2 + logf(l[1]);
  }
}

__device__ void dkv_mma(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile * kLd;
  bf16* qs = vs + kTile * kLd;
  bf16* dos = qs + kTile * kLd;
  float* ls = reinterpret_cast<float*>(dos + kTile * kLd);  // L * log2(e) of the query tile
  float* dl = ls + kTile;                                   // delta of the query tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ksb + h * p.ksh + k0 * p.ksn;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vsb + h * p.vsh + k0 * p.vsn;
  const long long row_stride = static_cast<long long>(p.H) * D;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + (static_cast<long long>(b) * p.N * p.H + h) * D;
  const long long bh = (static_cast<long long>(b) * p.H + h) * p.N;
  const float sl2 = p.scale * kLog2e;

  load_tile(ks, k, p.ksn);
  load_tile(vs, v, p.vsn);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dk[dn][0] = dk[dn][1] = dk[dn][2] = dk[dn][3] = 0.f;
    dv[dn][0] = dv[dn][1] = dv[dn][2] = dv[dn][3] = 0.f;
  }

  for (int q0 = 0; q0 < p.N; q0 += kTile) {
    __syncthreads();
    load_tile(qs, q + q0 * p.qsn, p.qsn);
    load_tile(dos, dout + q0 * row_stride, row_stride);
    if (threadIdx.x < kTile) {
      ls[threadIdx.x] = p.lse[bh + q0 + threadIdx.x] * kLog2e;
      dl[threadIdx.x] = p.delta[bh + q0 + threadIdx.x];
    }
    __syncthreads();

    // rows: this warp's 16 keys; columns: the tile's 64 queries
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    mma_rows_by_rows(s, ks, warp * 16, qs, lane);    // S^T = K Q^T
    mma_rows_by_rows(dp, vs, warp * 16, dos, lane);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + (lane & 3) * 2 + j;
        const float lc = ls[col], dc = dl[col];
        const float p0 = exp2f(s[nt][j] * sl2 - lc);
        const float p1 = exp2f(s[nt][2 + j] * sl2 - lc);
        s[nt][j] = p0;
        s[nt][2 + j] = p1;
        dp[nt][j] = p0 * (dp[nt][j] - dc);
        dp[nt][2 + j] = p1 * (dp[nt][2 + j] - dc);
      }
    }
    mma_frag_by_tile(dv, s, dos, lane);  // dV += P^T dO
    mma_frag_by_tile(dk, dp, qs, lane);  // dK += dS^T Q
  }

  bf16* gk = static_cast<bf16*>(p.dk) + b * p.gsb + h * p.gsh;
  bf16* gv = static_cast<bf16*>(p.dv) + b * p.gsb + h * p.gsh;
  store_rows(gk, p.gsn, k0 + warp * 16, dk, p.scale, p.scale, lane);
  store_rows(gv, p.gsn, k0 + warp * 16, dv, 1.f, 1.f, lane);
}

__device__ void dq_mma(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kTile * kLd;
  bf16* ks = dos + kTile * kLd;
  bf16* vs = ks + kTile * kLd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qsb + h * p.qsh + q0 * p.qsn;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ksb + h * p.ksh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vsb + h * p.vsh;
  const long long row_stride = static_cast<long long>(p.H) * D;
  const bf16* dout = static_cast<const bf16*>(p.dout) +
                     (static_cast<long long>(b) * p.N * p.H + h) * D + q0 * row_stride;
  const long long row = (static_cast<long long>(b) * p.H + h) * p.N + q0 + warp * 16 + (lane >> 2);
  const float lr[2] = {p.lse[row] * kLog2e, p.lse[row + 8] * kLog2e};
  const float dr[2] = {p.delta[row], p.delta[row + 8]};
  const float sl2 = p.scale * kLog2e;

  load_tile(qs, q, p.qsn);
  load_tile(dos, dout, row_stride);
  float dq[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;

  for (int k0 = 0; k0 < p.N; k0 += kTile) {
    __syncthreads();
    load_tile(ks, k + k0 * p.ksn, p.ksn);
    load_tile(vs, v + k0 * p.vsn, p.vsn);
    __syncthreads();

    // rows: this warp's 16 queries; columns: the tile's 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    mma_rows_by_rows(s, qs, warp * 16, ks, lane);    // S = Q K^T
    mma_rows_by_rows(dp, dos, warp * 16, vs, lane);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        dp[nt][j] = exp2f(s[nt][j] * sl2 - lr[r]) * (dp[nt][j] - dr[r]);
      }
    }
    mma_frag_by_tile(dq, dp, ks, lane);  // dQ += dS K
  }

  bf16* gq = static_cast<bf16*>(p.dq) + b * p.gsb + h * p.gsh;
  store_rows(gq, p.gsn, q0 + warp * 16, dq, p.scale, p.scale, lane);
}

// ---------------------------------------------------------------------------
// float32 with plain FMAs: one thread per row
// ---------------------------------------------------------------------------

// `rows` rows of D floats (row r at src + r * stride) into dst[r * D].
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long stride,
                                              int rows) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    reinterpret_cast<float4*>(dst)[i] = *reinterpret_cast<const float4*>(src + r * stride + c * 4);
  }
}

__device__ __forceinline__ void load_row_f32(float (&dst)[D], const float* src) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 t = *reinterpret_cast<const float4*>(src + d);
    dst[d] = t.x;
    dst[d + 1] = t.y;
    dst[d + 2] = t.z;
    dst[d + 3] = t.w;
  }
}

__device__ __forceinline__ void store_row_f32(float* dst, const float (&src)[D], float mul) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    *reinterpret_cast<float4*>(dst + d) =
        make_float4(src[d] * mul, src[d + 1] * mul, src[d + 2] * mul, src[d + 3] * mul);
  }
}

__device__ __forceinline__ float dot_f32(const float (&a)[D], const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 t = *reinterpret_cast<const float4*>(b + d);
    acc += a[d] * t.x;
    acc += a[d + 1] * t.y;
    acc += a[d + 2] * t.z;
    acc += a[d + 3] * t.w;
  }
  return acc;
}

__device__ __forceinline__ void axpy_f32(float (&acc)[D], float a, const float* x) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 t = *reinterpret_cast<const float4*>(x + d);
    acc[d] += a * t.x;
    acc[d + 1] += a * t.y;
    acc[d + 2] += a * t.z;
    acc[d + 3] += a * t.w;
  }
}

__device__ void fwd_fma(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kTileF * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * kRowsF + threadIdx.x;
  const float* k = static_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const float* v = static_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;
  float qr[D], acc[D];
  load_row_f32(qr, static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh + row * p.qsn);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < p.N; k0 += kTileF) {
    __syncthreads();
    load_rows_f32(ks, k + k0 * p.ksn, p.ksn, kTileF);
    load_rows_f32(vs, v + k0 * p.vsn, p.vsn, kTileF);
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kTileF; j0 += 8) {
      float s[8];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] = dot_f32(qr, ks + (j0 + j) * D) * p.scale;
        mx = fmaxf(mx, s[j]);
      }
      const float mn = fmaxf(m, mx);
      const float corr = expf(m - mn);  // 0 on the first keys, where m = -inf
      m = mn;
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = expf(s[j] - mn);
        l += pj;
        axpy_f32(acc, pj, vs + (j0 + j) * D);
      }
    }
  }
  float* o = static_cast<float*>(p.out) + ((static_cast<long long>(b) * p.N + row) * p.H + h) * D;
  store_row_f32(o, acc, 1.f / l);
  p.lse[(static_cast<long long>(b) * p.H + h) * p.N + row] = m + logf(l);
}

__device__ void dkv_fma(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kTileF * D;
  float* ls = dos + kTileF * D;
  float* dl = ls + kTileF;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * kRowsF + threadIdx.x;  // this thread's key
  const float* q = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const long long row_stride = static_cast<long long>(p.H) * D;
  const float* dout =
      static_cast<const float*>(p.dout) + (static_cast<long long>(b) * p.N * p.H + h) * D;
  const long long bh = (static_cast<long long>(b) * p.H + h) * p.N;
  float kr[D], vr[D], dk[D], dv[D];
  load_row_f32(kr, static_cast<const float*>(p.k) + b * p.ksb + h * p.ksh + row * p.ksn);
  load_row_f32(vr, static_cast<const float*>(p.v) + b * p.vsb + h * p.vsh + row * p.vsn);
#pragma unroll
  for (int d = 0; d < D; ++d) dk[d] = dv[d] = 0.f;

  for (int q0 = 0; q0 < p.N; q0 += kTileF) {
    __syncthreads();
    load_rows_f32(qs, q + q0 * p.qsn, p.qsn, kTileF);
    load_rows_f32(dos, dout + q0 * row_stride, row_stride, kTileF);
    if (threadIdx.x < kTileF) {
      ls[threadIdx.x] = p.lse[bh + q0 + threadIdx.x];
      dl[threadIdx.x] = p.delta[bh + q0 + threadIdx.x];
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < kTileF; ++i) {
      const float pij = expf(dot_f32(kr, qs + i * D) * p.scale - ls[i]);
      const float dsij = pij * (dot_f32(vr, dos + i * D) - dl[i]);
      axpy_f32(dv, pij, dos + i * D);
      axpy_f32(dk, dsij, qs + i * D);
    }
  }
  store_row_f32(static_cast<float*>(p.dk) + b * p.gsb + h * p.gsh + row * p.gsn, dk, p.scale);
  store_row_f32(static_cast<float*>(p.dv) + b * p.gsb + h * p.gsh + row * p.gsn, dv, 1.f);
}

__device__ void dq_fma(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kTileF * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = blockIdx.x * kRowsF + threadIdx.x;  // this thread's query
  const float* k = static_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const float* v = static_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;
  const long long bhn = (static_cast<long long>(b) * p.H + h) * p.N + row;
  const float lr = p.lse[bhn], dr = p.delta[bhn];
  float qr[D], dor[D], dq[D];
  load_row_f32(qr, static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh + row * p.qsn);
  load_row_f32(dor, static_cast<const float*>(p.dout) +
                        ((static_cast<long long>(b) * p.N + row) * p.H + h) * D);
#pragma unroll
  for (int d = 0; d < D; ++d) dq[d] = 0.f;

  for (int k0 = 0; k0 < p.N; k0 += kTileF) {
    __syncthreads();
    load_rows_f32(ks, k + k0 * p.ksn, p.ksn, kTileF);
    load_rows_f32(vs, v + k0 * p.vsn, p.vsn, kTileF);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kTileF; ++j) {
      const float pij = expf(dot_f32(qr, ks + j * D) * p.scale - lr);
      const float dsij = pij * (dot_f32(dor, vs + j * D) - dr);
      axpy_f32(dq, dsij, ks + j * D);
    }
  }
  store_row_f32(static_cast<float*>(p.dq) + b * p.gsb + h * p.gsh + row * p.gsn, dq, p.scale);
}

// ---------------------------------------------------------------------------
// The four kernels: T = bf16 runs the tensor-core bodies, T = float the FMA ones.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  if constexpr (sizeof(T) == 2) fwd_mma(p); else fwd_fma(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const Params p) {
  if constexpr (sizeof(T) == 2) dkv_mma(p); else dkv_fma(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Params p) {
  if constexpr (sizeof(T) == 2) dq_mma(p); else dq_fma(p);
}

__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    acc += fx.x * fy.x + fx.y * fy.y;
  }
  return acc;
}

// delta[b, h, n] = sum_d dO[b, n, h, d] * O[b, n, h, d], one thread per row.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_delta_kernel(const Params p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long rows = static_cast<long long>(p.B) * p.N * p.H;
  if (i >= rows) return;
  const int h = static_cast<int>(i % p.H);
  const long long bn = i / p.H;
  const int n = static_cast<int>(bn % p.N);
  const long long b = bn / p.N;
  const T* o = static_cast<const T*>(p.o) + i * D;
  const T* g = static_cast<const T*>(p.dout) + i * D;
  float acc = 0.f;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int d = 0; d < D; d += 8) {
      acc += dot8(*reinterpret_cast<const uint4*>(o + d), *reinterpret_cast<const uint4*>(g + d));
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(o + d);
      const float4 c = *reinterpret_cast<const float4*>(g + d);
      acc += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
    }
  }
  p.delta[(b * p.H + h) * p.N + n] = acc;
}

template <typename T>
constexpr int fwd_smem() {
  return sizeof(T) == 2 ? 3 * kTile * kLd * 2 : 2 * kTileF * D * 4;
}

template <typename T>
constexpr int dkv_smem() {
  return sizeof(T) == 2 ? 4 * kTile * kLd * 2 + 2 * kTile * 4 : 2 * kTileF * D * 4 + 2 * kTileF * 4;
}

template <typename T>
constexpr int dq_smem() {
  return sizeof(T) == 2 ? 4 * kTile * kLd * 2 : 2 * kTileF * D * 4;
}

template <typename T>
dim3 row_grid(const Params& p) {
  const int rows = sizeof(T) == 2 ? kTile : kRowsF;
  return dim3(static_cast<unsigned>(p.N / rows), static_cast<unsigned>(p.H),
              static_cast<unsigned>(p.B));
}

bool bad_shape(const Params& p) {
  return p.B <= 0 || p.N <= 0 || p.H <= 0 || p.N % 128 != 0 || p.B > 65535 || p.H > 65535 ||
         !(p.scale > 0.f);
}

// The kernels load and store rows 16 bytes at a time: every pointer and every
// stride (in elements of T) must keep a row 16-byte aligned. Pointers and
// strides a call does not use are 0.
template <typename T>
bool misaligned(const Params& p) {
  constexpr long long per16 = 16 / sizeof(T);
  const long long strides[] = {p.qsb, p.qsn, p.qsh, p.ksb, p.ksn, p.ksh,
                               p.vsb, p.vsn, p.vsh, p.gsb, p.gsn, p.gsh};
  for (long long st : strides) {
    if (st % per16 != 0) return true;
  }
  const void* ptrs[] = {p.q, p.k, p.v, p.out, p.o, p.dout, p.dq, p.dk, p.dv};
  for (const void* ptr : ptrs) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return true;
  }
  return false;
}

// Raises the three tiled kernels' dynamic shared memory limit, once per
// device and element type instead of before every launch.
template <typename T>
cudaError_t ensure_smem_limits() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fwd_smem<T>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_smem<T>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem<T>());
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

template <typename T>
cudaError_t forward(const Params& p, cudaStream_t s) {
  if (misaligned<T>(p)) return cudaErrorMisalignedAddress;
  cudaError_t err = ensure_smem_limits<T>();
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T><<<row_grid<T>(p), kThreads, fwd_smem<T>(), s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const Params& p, cudaStream_t s) {
  if (misaligned<T>(p)) return cudaErrorMisalignedAddress;
  cudaError_t err = ensure_smem_limits<T>();
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(p.B) * p.N * p.H;
  flash_delta_kernel<T><<<static_cast<unsigned>((rows + kThreads - 1) / kThreads), kThreads, 0,
                          s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<T><<<row_grid<T>(p), kThreads, dkv_smem<T>(), s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_dq_kernel<T><<<row_grid<T>(p), kThreads, dq_smem<T>(), s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_head_dim() { return D; }

// dtype: 0 = float32, 1 = bfloat16. q, k, v: [B, N, H, D] views with element
// strides (batch, row, head), D contiguous. out: contiguous [B, N, H, D];
// lse: f32 [B, H, N]. Returns a cudaError_t.
extern "C" int flash_attn_forward(const void* q, const void* k, const void* v, void* out,
                                  float* lse, int B, int N, int H, long long qsb, long long qsn,
                                  long long qsh, long long ksb, long long ksn, long long ksh,
                                  long long vsb, long long vsn, long long vsh, float scale,
                                  int dtype, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse = lse;
  p.qsb = qsb; p.qsn = qsn; p.qsh = qsh;
  p.ksb = ksb; p.ksn = ksn; p.ksh = ksh;
  p.vsb = vsb; p.vsn = vsn; p.vsh = vsh;
  p.B = B; p.N = N; p.H = H; p.scale = scale;
  if (bad_shape(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(forward<float>(p, s));
  if (dtype == 1) return static_cast<int>(forward<bf16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The three backward kernels in order: delta, dK/dV, dQ. o, dout: contiguous
// [B, N, H, D]; lse, delta (scratch): f32 [B, H, N]; dq, dk, dv: [B, N, H, D]
// views sharing the element strides (gsb, gsn, gsh). Returns a cudaError_t.
extern "C" int flash_attn_backward(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, float* lse, float* delta, void* dq, void* dk,
                                   void* dv, int B, int N, int H, long long qsb, long long qsn,
                                   long long qsh, long long ksb, long long ksn, long long ksh,
                                   long long vsb, long long vsn, long long vsh, long long gsb,
                                   long long gsn, long long gsh, float scale, int dtype,
                                   void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.qsb = qsb; p.qsn = qsn; p.qsh = qsh;
  p.ksb = ksb; p.ksn = ksn; p.ksh = ksh;
  p.vsb = vsb; p.vsn = vsn; p.vsh = vsh;
  p.gsb = gsb; p.gsn = gsn; p.gsh = gsh;
  p.B = B; p.N = N; p.H = H; p.scale = scale;
  if (bad_shape(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(backward<float>(p, s));
  if (dtype == 1) return static_cast<int>(backward<bf16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
