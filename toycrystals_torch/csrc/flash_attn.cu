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
//   forward   one block per (item, head, 128 query rows): two consumer
//             warpgroups of 64 rows and a producer warpgroup (bf16; see
//             fwd_wgmma); loop over 128-key tiles: S = Q K^T, running max m
//             and sum l per row in f32 registers (exp2 with scale * log2(e)
//             folded once, in f32), P rounded to bf16 and multiplied into the
//             f32 accumulator of O. Writes O in the input type and the row
//             log-sum-exp L = m + log(l) as f32 [B, H, N].
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
// Bound: operations. One forward at [B, N, H, d] does 4 B H N^2 d tensor
// operations and B H N^2 exponentials on (3 reads + 1 write) B N H d elements.
// At N = 4,096 and d = 48 that is only 192 tensor operations per exponential,
// and the special-function unit (16 exp2 per clock per SM) takes longer than
// the tensor cores: the exponentials bound the forward. Its design therefore
// overlaps them with the products: both products on wgmma (S from shared
// memory, P V with P from registers: the f32 C fragment of S, pairs packed to
// bf16, is the A fragment, so P never leaves registers), K/V tiles arriving
// by TMA round a ring of mbarrier-guarded stages, and two consumer
// warpgroups that take turns at the tensor cores, each running its
// exponentials while the other's products run. The backward kernels still use
// mma.sync.m16n8k16 with K/V/Q/dO rows in shared memory at a pitch of d + 8
// elements (conflict-free 32-bit fragment loads and ldmatrix) and rely on
// several blocks per SM to hide synchronous tile loads.
//
// float32 inputs are the checking type, not the working one: an f32 forward
// kernel and the same backward templates instantiate a plain f32-FMA body (one thread per row, K/V tiles
// in shared memory, expf), with no tensor cores and no TF32.
//
// One head dim per build: compile with -DFLASH_HEAD_DIM=<multiple of 16, at
// most 128>. q, k, v arrive as [B, N, H, d] views given by element strides (d
// contiguous, rows 16-byte aligned); N must be a multiple of 128. The bf16
// forward reads them through TMA tensor maps encoded per call.
//
// Plain C interface, built with nvcc and loaded through ctypes
// (toycrystals_torch/ops/attention.py). Launches go on the caller's stream;
// each function returns the first cudaError_t it met.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked
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

// ---------------------------------------------------------------------------
// bf16 forward on wgmma, K/V through a TMA ring
// ---------------------------------------------------------------------------
//
// Shared tiles are [128 rows, D] bf16 cut into D / 16 slabs of 16 columns:
// slab c holds columns 16c.. as 128 rows of 32 bytes (4,096 bytes), in the
// 32-byte swizzle that TMA writes and wgmma reads. A 5-D tensor map over (16
// elements, rows, D / 16 slabs, heads, batch) writes a whole tile with one TMA
// load, whatever the row and head strides of the view: d = 48 rows are 96
// bytes, which no 64- or 128-byte swizzle fits, and every 32-byte request of
// the copy is one whole L2 sector. A slab is one k-step of S = Q K^T (Q and K
// K-major: 8-row groups 256 bytes apart) and one 16-wide n-atom of P V (V
// MN-major, d contiguous: 8-key groups 256 bytes apart, slabs 4,096).

constexpr int kRows = 128;                      // query rows per block, keys per tile
constexpr int kTileBytes = kRows * D * 2;       // one [128, D] bf16 tile
constexpr int kSlabBytes = kRows * 32;          // 16 columns of a tile
constexpr int kSmemPerBlock = 232448;           // the most a block may have on sm_90
constexpr int kRingFits = (kSmemPerBlock - 1024 - kTileBytes) / (2 * kTileBytes);
constexpr int kStages = kRingFits < 4 ? kRingFits : 4;  // K/V ring depth: 4, 3 at d > 96
constexpr int kFwdThreads = 384;                // 2 consumer warpgroups + 1 producer
static_assert(kStages >= 2, "K/V ring needs two stages");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One [128, D] tile at (row0, head, item) of `map` into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, int row0, int h,
                                              int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row0), "r"(0), "r"(h), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// Named barrier `id` over `threads` threads: wait, or arrive without waiting.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a 32-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 3.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins a register across asynchronous wgmma issue and wait.
template <int R, int C>
__device__ __forceinline__ void keep(float (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
  }
}

template <int R, int C>
__device__ __forceinline__ void keep(uint32_t (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
  }
}

// d (64 x 128, f32) = A * B (+ d if accumulate): A, B bf16 K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x n, f32) += A * B: A (64 x 16, bf16) from registers in the mma.sync
// A-fragment layout, B (16 x n, bf16) MN-major in shared memory. One overload
// per width n = 16, 32, .., 128, so that a build's head dim D picks its own.
__device__ __forceinline__ void wgmma_rs(float (&d)[2][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[6][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[10][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[12][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[14][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// One block: 128 query rows of one (item, head). Warpgroups 0 and 1 each own
// 64 rows; warpgroup 2 is the producer, of which one thread issues the TMA
// loads: Q once, then K and V tiles of 128 keys round a ring of kStages
// stages, each with a "full" barrier (TMA bytes) and an "empty" one (one
// arrival per consumer warp once its P V product has retired).
//
// A consumer's iteration j: S_j = Q K_j^T (SS wgmma, D / 16 k-steps) and
// O += P_{j-1} V_{j-1} (RS wgmma, P in registers, 8 k-steps) are issued
// together; then the online softmax of S_j turns it into P_j and rescales O.
// The two warpgroups take turns issuing through named barriers 1 and 2, so
// one warpgroup's exponentials run while the other's products occupy the
// tensor cores.
__device__ void fwd_wgmma(const Params& p, const CUtensorMap* qmap, const CUtensorMap* kmap,
                          const CUtensorMap* vmap) {
  extern __shared__ __align__(1024) unsigned char fwd_smem_raw[];  // swizzle atoms: 256 bytes
  unsigned char* qs = fwd_smem_raw;
  unsigned char* ks = qs + kTileBytes;
  unsigned char* vs = ks + kStages * kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tiles = p.N / kRows;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // 4 warps x 2 consumer warpgroups
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, kTileBytes);
      tma_load_tile(qs, qmap, q0, h, b, qbar);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_tile(ks + s * kTileBytes, kmap, j * kRows, h, b, &full[s]);
        tma_load_tile(vs + s * kTileBytes, vmap, j * kRows, h, b, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    // this warpgroup's 64 rows start 64 * 32 bytes into each slab
    const uint64_t qdesc = smem_desc(qs + wg * 64 * 32, 16, 256);
    constexpr uint64_t kKStep = kSlabBytes >> 4;  // 16 columns of Q or K: the next slab
    constexpr uint64_t kVStep = (16 * 32) >> 4;   // 16 keys of V

    float o[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
    uint32_t pa[8][4];  // P of the previous tile, bf16 pairs: the A operand of P V
    float m[2] = {-INFINITY, -INFINITY};  // running row max, in log2 units
    float l[2] = {0.f, 0.f};              // this thread's share of the running row sum
    const float sl2 = p.scale * kLog2e;
    const int turn = 1 + wg, other = 2 - wg;

    if (wg == 1) bar_arrive(other, 256);  // warpgroup 0 issues first
    mbar_wait(qbar, 0);
    int sp = 0;  // stage of the previous tile
    for (int j = 0; j < tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      bar_sync(turn, 256);
      float sacc[16][4];
      keep(o);
      keep(pa);
      wgmma_fence();
      const uint64_t kdesc = smem_desc(ks + s * kTileBytes, 16, 256);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_n128(sacc, qdesc + kk * kKStep, kdesc + kk * kKStep, kk > 0);
      }
      wgmma_commit();
      if (j > 0) {
        const uint64_t vdesc = smem_desc(vs + sp * kTileBytes, kSlabBytes, 256);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) wgmma_rs(o, pa[kk], vdesc + kk * kVStep);
        wgmma_commit();
      }
      bar_arrive(other, 256);
      wgmma_wait_all();
      keep(sacc);
      keep(o);
      keep(pa);
      if (j > 0 && lane == 0) mbar_arrive(&empty[sp]);

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(sacc[nt][0], sacc[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sacc[nt][2], sacc[nt][3]));
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
      for (int nt = 0; nt < 16; ++nt) {
        const float e0 = exp2f(sacc[nt][0] * sl2 - m[0]);
        const float e1 = exp2f(sacc[nt][1] * sl2 - m[0]);
        const float e2 = exp2f(sacc[nt][2] * sl2 - m[1]);
        const float e3 = exp2f(sacc[nt][3] * sl2 - m[1]);
        l[0] += e0 + e1;
        l[1] += e2 + e3;
        // the C fragment of S, pairs packed to bf16, is the A fragment of P V
        pa[nt >> 1][(nt & 1) * 2] = pack2(e0, e1);
        pa[nt >> 1][(nt & 1) * 2 + 1] = pack2(e2, e3);
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][0] *= corr[0];
        o[dn][1] *= corr[0];
        o[dn][2] *= corr[1];
        o[dn][3] *= corr[1];
      }
      sp = s;
    }

    bar_sync(turn, 256);
    keep(o);
    keep(pa);
    wgmma_fence();
    const uint64_t vdesc = smem_desc(vs + sp * kTileBytes, kSlabBytes, 256);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs(o, pa[kk], vdesc + kk * kVStep);
    wgmma_commit();
    if (wg == 0) bar_arrive(other, 256);  // warpgroup 1 still waits for its last turn
    wgmma_wait_all();
    keep(o);
    keep(pa);

    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    const int row0 = q0 + wg * 64 + warp * 16;
    const long long row_stride = static_cast<long long>(p.H) * D;
    bf16* out = static_cast<bf16*>(p.out) + (static_cast<long long>(b) * p.N * p.H + h) * D;
    store_rows(out, row_stride, row0, o, 1.f / l[0], 1.f / l[1], lane);
    if ((lane & 3) == 0) {
      float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.N + row0 + (lane >> 2);
      lse[0] = m[0] * kLn2 + logf(l[0]);
      lse[8] = m[1] * kLn2 + logf(l[1]);
    }
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
// The kernels: the forward has a wgmma kernel for bf16 and an FMA one for f32;
// in the backward T = bf16 runs the tensor-core bodies, T = float the FMA ones.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap) {
  fwd_wgmma(p, &qmap, &kmap, &vmap);
}

__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(const Params p) { fwd_fma(p); }

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
  // bf16: Q, the K and V ring, then 2 kStages + 1 mbarriers
  return sizeof(T) == 2 ? (1 + 2 * kStages) * kTileBytes + (2 * kStages + 1) * 8
                        : 2 * kTileF * D * 4;
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

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime's entry-point query, so the library links nothing beyond the runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return cudaSuccess;
}

// The tensor map of a bf16 [B, N, H, D] view with element strides (sb, sn, sh)
// whose [128, D] boxes land in the slab layout of fwd_wgmma: dims (16
// elements, N rows, D / 16 slabs of 32 bytes, H, B), box (16, 128, D / 16, 1,
// 1), 32-byte swizzle. Encoded per call, since the map holds the base pointer.
cudaError_t tile_map(CUtensorMap* map, const void* base, const Params& p, long long sb,
                     long long sn, long long sh) {
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[5] = {16, static_cast<cuuint64_t>(p.N), D / 16,
                              static_cast<cuuint64_t>(p.H), static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(sn) * 2, 32,  // bytes, dims 1..4
                                 static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[5] = {16, kRows, D / 16, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
  if constexpr (sizeof(T) == 2) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               fwd_smem<T>());
  } else {
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               fwd_smem<T>());
  }
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
  const dim3 grid(static_cast<unsigned>(p.N / kRows), static_cast<unsigned>(p.H),
                  static_cast<unsigned>(p.B));
  if constexpr (sizeof(T) == 2) {
    CUtensorMap qmap, kmap, vmap;
    err = tile_map(&qmap, p.q, p, p.qsb, p.qsn, p.qsh);
    if (err == cudaSuccess) err = tile_map(&kmap, p.k, p, p.ksb, p.ksn, p.ksh);
    if (err == cudaSuccess) err = tile_map(&vmap, p.v, p, p.vsb, p.vsn, p.vsh);
    if (err != cudaSuccess) return err;
    flash_fwd_wgmma_kernel<<<grid, kFwdThreads, fwd_smem<T>(), s>>>(p, qmap, kmap, vmap);
  } else {
    flash_fwd_f32_kernel<<<grid, kThreads, fwd_smem<T>(), s>>>(p);
  }
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
