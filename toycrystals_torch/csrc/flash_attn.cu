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
//   delta     delta = rowsum(dO * O) in f32, [B, H, N], one thread per row.
//   dK/dV     one block per (item, head, 128 keys), bf16 (see dkv_wgmma): K
//             and V resident, loop over tiles of 128 query rows (64 at
//             d > 64): S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T - L),
//             dS^T = P^T * (dP^T - delta), dV += P^T dO, dK += dS^T Q; dK
//             scaled at the end.
//   dQ        one block per (item, head, 128 query rows), bf16 (see
//             dq_wgmma): Q and dO resident, loop over 128-key tiles: S, dP,
//             dS as above, dQ += dS K, scaled at the end.
//
// No atomics anywhere: every output element has one owner, so results are
// the same from run to run. The price is that S and exp(S - L) are formed in
// both backward kernels: 7 products of 2 B H N^2 d operations, not 5.
//
// Bound: operations. One forward at [B, N, H, d] does 4 B H N^2 d tensor
// operations and B H N^2 exponentials on (3 reads + 1 write) B N H d elements.
// At N = 4,096 and d = 48 that is only 192 tensor operations per exponential,
// and the special-function unit (16 exp2 per clock per SM) takes longer than
// the tensor cores: the exponentials bound the forward. The backward's 10
// (here 14) B H N^2 d operations against 2 B H N^2 exponentials put its bound
// on the tensor cores. All bf16 kernels share one design: every product on
// wgmma (S, dP from shared memory; P V, dS K, P^T dO, dS^T Q with P or dS from
// registers: the f32 C fragment of S, pairs packed to bf16, is the A fragment,
// so P and dS never leave registers), tiles arriving by TMA round a ring of
// mbarrier-guarded stages filled by a producer warpgroup, and two consumer
// warpgroups that take turns at the tensor cores, each running its
// exponentials while the other's products run.
//
// float32 is a working type too: the SDE trainer and the sampling CLIs run
// in f32 unless told otherwise. Its kernels (fwd_tf32, dkv_tf32, dq_tf32) do
// the same work with the same blocks' roles, and f32 accuracy on the tensor
// cores: each operand is split into two TF32 values, hi and lo, and each
// product formed as lo hi + hi lo + hi hi (see "float32 on the tensor cores"
// below). That triples the tensor operations, so they, not the
// exponentials, bound the f32 forward too: 3 x 4 B H N^2 d at the TF32 rate
// (1.87 ms at [24, 4096, 4, 48], the exponentials 0.39). The f32 kernels run
// mma.sync, which reached about 300 TFLOP/s of TF32 on an H100 SXM, 0.62 of
// that peak: the first cap. Every operand is split once per block into
// shared memory, packed in fragment order (one conflict-free 16-byte load per
// fragment), P and dS split in registers. Each warp reads every B fragment
// itself, 12 operations per byte of shared memory for 16 rows a warp (24 for
// the forward's 32), near the 16 that mma.sync's rate needs from 128 bytes a
// clock: the second. The third is the split between two barriers, when no
// product runs (a third of the forward's time on the H100 at 16 rows a warp,
// less at 32 with two blocks an SM). The kernels read
// no `allow_tf32` flag: the split is always on.
//
// One head dim per build: compile with -DFLASH_HEAD_DIM=<multiple of 16, at
// most 128>. q, k, v arrive as [B, N, H, d] views given by element strides (d
// contiguous, rows 16-byte aligned); N must be a multiple of 128. Both passes
// also take K and V of Nk rows against Q of N (sequence-parallel attention:
// a rank's queries against the keys gathered from every rank), Nk a multiple
// of 128 too: the forward and dQ loop over Nk keys, dK/dV has a block per 128
// (f32 at d > 64: 64) of the Nk keys and loops over the N queries, so dK and
// dV are [B, Nk, H, D], this rank's queries' share of every key's gradient.
// The bf16 kernels read q, k, v and dO through TMA tensor maps encoded per
// call, the f32 ones with 4- and 8-byte loads into registers.
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

constexpr int kThreads = 128;  // the delta kernel
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
  void* dq;          // gradient of q: element strides gsb, gsn, gsh
  void* dk;          // gradients of k and v: element strides dsb, dsn, dsh
  void* dv;
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, gsb, gsn, gsh, dsb, dsn, dsh;
  int B, N, H;
  int Nk;  // rows of K and V: the key loop of the forward and of dQ, dK/dV's blocks
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Backward. dQ: Q and dO resident, the K/V ring of the forward (4 stages, 3 at
// d 96-112, 2 at d 128). dK/dV: K and V resident, a ring of Q and dO tiles of
// kQRows query rows with their L and delta; 64 rows at d > 64, where the f32
// dK and dV accumulators take the registers that S^T and dP^T would need.
constexpr int kDqRingFits = (kSmemPerBlock - 1024 - 2 * kTileBytes) / (2 * kTileBytes);
constexpr int kDqStages = kDqRingFits < 4 ? kDqRingFits : 4;
constexpr int kQRows = D <= 64 ? 128 : 64;
constexpr int kQTileBytes = kQRows * D * 2;
constexpr int kQSlabBytes = kQRows * 32;
constexpr int kDkvStageBytes = 2 * kQTileBytes + 2 * kQRows * 4;  // Q, dO, L, delta
constexpr int kDkvRingFits = (kSmemPerBlock - 1024 - 2 * kTileBytes) / kDkvStageBytes;
constexpr int kDkvStages = kDkvRingFits < 4 ? kDkvRingFits : 4;
static_assert(kDqStages >= 2 && kDkvStages >= 2, "backward rings need two stages");

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

// One box of `map` ([rows, D]) at (row0, head, item) into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, int row0, int h,
                                              int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row0), "r"(0), "r"(h), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` into shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A ring's barriers: per stage a "full" one (TMA bytes) and an "empty" one (one
// arrival per consumer warp), and `once` for the tiles loaded once.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, uint64_t* once,
                                          int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // 4 warps x 2 consumer warpgroups
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
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

// d (64 x n, f32) = A * B (+ d if accumulate): A, B bf16 K-major in shared
// memory; n = 128 and 64.
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t a, uint64_t b,
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

__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
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

// acc = A B over D / 16 k-steps: A and B K-major in slabs, `astep` and `bstep`
// the descriptor steps to their next 16 columns. Issued, not committed.
template <int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N][4], uint64_t a, uint64_t b,
                                         uint64_t astep, uint64_t bstep) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(acc, a + kk * astep, b + kk * bstep, kk > 0);
}

// acc += A B over K 16-row steps: A from registers (bf16 pairs, the A-fragment
// layout), B the MN-major tile at `t` whose slabs lie `slab` bytes apart.
// Issued, not committed.
template <int N, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[N][4], const uint32_t (&a)[K][4],
                                         const unsigned char* t, uint32_t slab) {
  constexpr uint64_t kRowStep = (16 * 32) >> 4;  // 16 rows of 32 bytes
  const uint64_t desc = smem_desc(t, slab, 256);
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_rs(acc, a[kk], desc + kk * kRowStep);
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
  const int tiles = p.Nk / kRows;
  const int wg = threadIdx.x / 128;

  init_ring(full, empty, qbar, kStages);

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
      issue_ss(sacc, qdesc, smem_desc(ks + s * kTileBytes, 16, 256), kKStep, kKStep);
      wgmma_commit();
      if (j > 0) {
        issue_rs(o, pa, vs + sp * kTileBytes, kSlabBytes);
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
    issue_rs(o, pa, vs + sp * kTileBytes, kSlabBytes);
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

// ---------------------------------------------------------------------------
// bf16 backward on wgmma: dQ, and dK/dV, each fed by a TMA ring
// ---------------------------------------------------------------------------
//
// Both kernels have the forward's shape: 128-row blocks of two consumer
// warpgroups (64 rows each) and a producer warpgroup, tiles in the forward's
// slabs, turns at the tensor cores through named barriers 1 and 2. S and
// exp(S - L) are formed in both (7 products where 5 would do) so that every
// output element has one owner and no atomics are needed.
//
// In its turn a consumer first issues and retires the previous tile's RS
// products (the ones that take P or dS from registers), which frees that
// tile's stage, then issues this tile's two SS products and passes the turn:
// the other warpgroup's products run while this one forms P and dS. Retiring
// the RS products before the SS ones are issued keeps the packed bf16 A
// fragments and the two f32 SS tiles out of the registers at the same time.
// Issuing both at once where the registers allow it (d <= 48) measured no
// faster.

// 2^x in one special-function instruction; exp2f adds a range fix-up for
// results below 2^-126, which the backward's P and dS do not need (bf16 pairs
// of them are what the products read).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One block: 128 query rows of one (item, head). The producer loads Q and dO
// once, then K and V tiles of 128 keys round a ring of kDqStages stages. A
// consumer's iteration j, after dQ += dS_{j-1} K_{j-1} (RS wgmma, K read
// MN-major as the forward reads V): S = Q K_j^T and dP = dO V_j^T (SS wgmma,
// dO and V K-major as Q and K), then
// dS = exp2(S * scale * log2(e) - L * log2(e)) * (dP - delta), with L and
// delta of its two rows per thread held in registers, packed to bf16 pairs:
// the C fragment of S is the A fragment of dS K, as P's is of P V in the
// forward.
__device__ void dq_wgmma(const Params& p, const CUtensorMap* qmap, const CUtensorMap* kmap,
                         const CUtensorMap* vmap, const CUtensorMap* omap) {
  extern __shared__ __align__(1024) unsigned char bwd_smem_raw[];
  unsigned char* qs = bwd_smem_raw;
  unsigned char* dos = qs + kTileBytes;
  unsigned char* ks = dos + kTileBytes;
  unsigned char* vs = ks + kDqStages * kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kDqStages * kTileBytes);
  uint64_t* empty = full + kDqStages;
  uint64_t* qbar = empty + kDqStages;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tiles = p.Nk / kRows;
  const int wg = threadIdx.x / 128;
  init_ring(full, empty, qbar, kDqStages);

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, 2 * kTileBytes);
      tma_load_tile(qs, qmap, q0, h, b, qbar);
      tma_load_tile(dos, omap, q0, h, b, qbar);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kDqStages;
        if (j >= kDqStages) mbar_wait(&empty[s], (j / kDqStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_tile(ks + s * kTileBytes, kmap, j * kRows, h, b, &full[s]);
        tma_load_tile(vs + s * kTileBytes, vmap, j * kRows, h, b, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const uint64_t qdesc = smem_desc(qs + wg * 64 * 32, 16, 256);
    const uint64_t odesc = smem_desc(dos + wg * 64 * 32, 16, 256);
    constexpr uint64_t kKStep = kSlabBytes >> 4;  // the next 16 columns: the next slab
    const int row0 = q0 + wg * 64 + warp * 16;
    const long long row = (static_cast<long long>(b) * p.H + h) * p.N + row0 + (lane >> 2);
    const float l2[2] = {p.lse[row] * kLog2e, p.lse[row + 8] * kLog2e};
    const float dl[2] = {p.delta[row], p.delta[row + 8]};
    const float sl2 = p.scale * kLog2e;
    const int turn = 1 + wg, other = 2 - wg;

    float dq[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;
    uint32_t ds[8][4];  // dS of the previous tile, bf16 pairs: the A operand of dS K

    if (wg == 1) bar_arrive(other, 256);  // warpgroup 0 issues first
    mbar_wait(qbar, 0);
    int sp = 0;  // stage of the previous tile
    for (int j = 0; j < tiles; ++j) {
      const int s = j % kDqStages;
      mbar_wait(&full[s], (j / kDqStages) & 1);
      bar_sync(turn, 256);
      if (j > 0) {
        keep(dq);
        keep(ds);
        wgmma_fence();
        issue_rs(dq, ds, ks + sp * kTileBytes, kSlabBytes);
        wgmma_commit();
        wgmma_wait_all();
        keep(dq);
        keep(ds);
        if (lane == 0) mbar_arrive(&empty[sp]);
      }
      float sacc[16][4], dpacc[16][4];
      wgmma_fence();
      issue_ss(sacc, qdesc, smem_desc(ks + s * kTileBytes, 16, 256), kKStep, kKStep);
      issue_ss(dpacc, odesc, smem_desc(vs + s * kTileBytes, 16, 256), kKStep, kKStep);
      wgmma_commit();
      bar_arrive(other, 256);
      wgmma_wait_all();
      keep(sacc);
      keep(dpacc);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const float d0 = exp2_ftz(sacc[nt][0] * sl2 - l2[0]) * (dpacc[nt][0] - dl[0]);
        const float d1 = exp2_ftz(sacc[nt][1] * sl2 - l2[0]) * (dpacc[nt][1] - dl[0]);
        const float d2 = exp2_ftz(sacc[nt][2] * sl2 - l2[1]) * (dpacc[nt][2] - dl[1]);
        const float d3 = exp2_ftz(sacc[nt][3] * sl2 - l2[1]) * (dpacc[nt][3] - dl[1]);
        ds[nt >> 1][(nt & 1) * 2] = pack2(d0, d1);
        ds[nt >> 1][(nt & 1) * 2 + 1] = pack2(d2, d3);
      }
      sp = s;
    }

    bar_sync(turn, 256);
    keep(dq);
    keep(ds);
    wgmma_fence();
    issue_rs(dq, ds, ks + sp * kTileBytes, kSlabBytes);
    wgmma_commit();
    if (wg == 0) bar_arrive(other, 256);  // warpgroup 1 still waits for its last turn
    wgmma_wait_all();
    keep(dq);
    bf16* gq = static_cast<bf16*>(p.dq) + b * p.gsb + h * p.gsh;
    store_rows(gq, p.gsn, row0, dq, p.scale, p.scale, lane);
  }
}

// One block: 128 keys of one (item, head), 64 per consumer warpgroup, each
// holding its f32 dK and dV. The producer loads K and V once, then round a
// ring of kDkvStages stages the tiles of kQRows query rows of Q and dO (TMA)
// with their L and delta (1-D bulk copies), all on one full barrier. A
// consumer's iteration i, after dV += P^T_{i-1} dO_{i-1} and
// dK += dS^T_{i-1} Q_{i-1} (RS wgmma, dO and Q read MN-major): S^T = K Q_i^T
// and dP^T = V dO_i^T (SS wgmma, K and V as the K-major A operand, Q and dO as
// the K-major B operand: the forward's roles swapped), then
// P^T = exp2(S^T * scale * log2(e) - L * log2(e)) and
// dS^T = P^T * (dP^T - delta), with L and delta per column, read from the
// stage as pairs.
__device__ void dkv_wgmma(const Params& p, const CUtensorMap* kmap, const CUtensorMap* vmap,
                          const CUtensorMap* qmap, const CUtensorMap* omap) {
  extern __shared__ __align__(1024) unsigned char bwd_smem_raw[];
  unsigned char* ks = bwd_smem_raw;
  unsigned char* vs = ks + kTileBytes;
  unsigned char* qs = vs + kTileBytes;
  unsigned char* dos = qs + kDkvStages * kQTileBytes;
  float* ls = reinterpret_cast<float*>(dos + kDkvStages * kQTileBytes);  // L per stage
  float* dls = ls + kDkvStages * kQRows;                                 // delta per stage
  uint64_t* full = reinterpret_cast<uint64_t*>(dls + kDkvStages * kQRows);
  uint64_t* empty = full + kDkvStages;
  uint64_t* kvbar = empty + kDkvStages;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tiles = p.N / kQRows;
  const int wg = threadIdx.x / 128;
  const long long bh = (static_cast<long long>(b) * p.H + h) * p.N;
  init_ring(full, empty, kvbar, kDkvStages);

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kvbar, 2 * kTileBytes);
      tma_load_tile(ks, kmap, k0, h, b, kvbar);
      tma_load_tile(vs, vmap, k0, h, b, kvbar);
      for (int i = 0; i < tiles; ++i) {
        const int s = i % kDkvStages;
        if (i >= kDkvStages) mbar_wait(&empty[s], (i / kDkvStages - 1) & 1);
        mbar_expect_tx(&full[s], kDkvStageBytes);
        tma_load_tile(qs + s * kQTileBytes, qmap, i * kQRows, h, b, &full[s]);
        tma_load_tile(dos + s * kQTileBytes, omap, i * kQRows, h, b, &full[s]);
        bulk_load(ls + s * kQRows, p.lse + bh + i * kQRows, kQRows * 4, &full[s]);
        bulk_load(dls + s * kQRows, p.delta + bh + i * kQRows, kQRows * 4, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    // this warpgroup's 64 keys start 64 * 32 bytes into each slab of K and V
    const uint64_t kdesc = smem_desc(ks + wg * 64 * 32, 16, 256);
    const uint64_t vdesc = smem_desc(vs + wg * 64 * 32, 16, 256);
    constexpr uint64_t kKStep = kSlabBytes >> 4;   // A: the next 16 columns of K or V
    constexpr uint64_t kQStep = kQSlabBytes >> 4;  // B: the next 16 columns of Q or dO
    const float sl2 = p.scale * kLog2e;
    const int turn = 1 + wg, other = 2 - wg;

    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      dk[dn][0] = dk[dn][1] = dk[dn][2] = dk[dn][3] = 0.f;
      dv[dn][0] = dv[dn][1] = dv[dn][2] = dv[dn][3] = 0.f;
    }
    // P^T and dS^T of the previous tile, bf16 pairs: the A operands of the RS products
    uint32_t pa[kQRows / 16][4], dsa[kQRows / 16][4];

    if (wg == 1) bar_arrive(other, 256);  // warpgroup 0 issues first
    mbar_wait(kvbar, 0);
    int sp = 0;  // stage of the previous tile
    for (int i = 0; i < tiles; ++i) {
      const int s = i % kDkvStages;
      mbar_wait(&full[s], (i / kDkvStages) & 1);
      bar_sync(turn, 256);
      if (i > 0) {
        keep(dk);
        keep(dv);
        keep(pa);
        keep(dsa);
        wgmma_fence();
        issue_rs(dv, pa, dos + sp * kQTileBytes, kQSlabBytes);
        issue_rs(dk, dsa, qs + sp * kQTileBytes, kQSlabBytes);
        wgmma_commit();
        wgmma_wait_all();
        keep(dk);
        keep(dv);
        keep(pa);
        keep(dsa);
        if (lane == 0) mbar_arrive(&empty[sp]);
      }
      float st[kQRows / 8][4], dpt[kQRows / 8][4];
      wgmma_fence();
      issue_ss(st, kdesc, smem_desc(qs + s * kQTileBytes, 16, 256), kKStep, kQStep);
      issue_ss(dpt, vdesc, smem_desc(dos + s * kQTileBytes, 16, 256), kKStep, kQStep);
      wgmma_commit();
      bar_arrive(other, 256);
      wgmma_wait_all();
      keep(st);
      keep(dpt);
      // this thread's columns: nt * 8 + 2 t and the next
      const float* lt = ls + s * kQRows + (lane & 3) * 2;
      const float* dt = dls + s * kQRows + (lane & 3) * 2;
#pragma unroll
      for (int nt = 0; nt < kQRows / 8; ++nt) {
        const float2 lc = *reinterpret_cast<const float2*>(lt + nt * 8);
        const float2 dc = *reinterpret_cast<const float2*>(dt + nt * 8);
        const float l0 = lc.x * kLog2e, l1 = lc.y * kLog2e;
        const float p0 = exp2_ftz(st[nt][0] * sl2 - l0), p1 = exp2_ftz(st[nt][1] * sl2 - l1);
        const float p2 = exp2_ftz(st[nt][2] * sl2 - l0), p3 = exp2_ftz(st[nt][3] * sl2 - l1);
        pa[nt >> 1][(nt & 1) * 2] = pack2(p0, p1);
        pa[nt >> 1][(nt & 1) * 2 + 1] = pack2(p2, p3);
        dsa[nt >> 1][(nt & 1) * 2] = pack2(p0 * (dpt[nt][0] - dc.x), p1 * (dpt[nt][1] - dc.y));
        dsa[nt >> 1][(nt & 1) * 2 + 1] =
            pack2(p2 * (dpt[nt][2] - dc.x), p3 * (dpt[nt][3] - dc.y));
      }
      sp = s;
    }

    bar_sync(turn, 256);
    keep(dk);
    keep(dv);
    keep(pa);
    keep(dsa);
    wgmma_fence();
    issue_rs(dv, pa, dos + sp * kQTileBytes, kQSlabBytes);
    issue_rs(dk, dsa, qs + sp * kQTileBytes, kQSlabBytes);
    wgmma_commit();
    if (wg == 0) bar_arrive(other, 256);  // warpgroup 1 still waits for its last turn
    wgmma_wait_all();
    keep(dk);
    keep(dv);
    const int row0 = k0 + wg * 64 + warp * 16;
    bf16* gk = static_cast<bf16*>(p.dk) + b * p.dsb + h * p.dsh;
    bf16* gv = static_cast<bf16*>(p.dv) + b * p.dsb + h * p.dsh;
    store_rows(gk, p.dsn, row0, dk, p.scale, p.scale, lane);
    store_rows(gv, p.dsn, row0, dv, 1.f, 1.f, lane);
  }
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores: three TF32 products per product
// ---------------------------------------------------------------------------
//
// Every f32 operand x is split in two TF32 values, hi = tf32(x) and
// lo = tf32(x - hi), each rounded to nearest (cvt.rna), and every product is
// formed as lo hi + hi lo + hi hi in f32 accumulators by
// mma.sync.m16n8k8.tf32; lo lo, 2^-22 of the product, is dropped. One TF32
// product would keep 10 bits (5e-4 of attention's largest entry); the three
// keep f32's (1e-6).
//
// A warp owns 16 or 32 rows (queries; keys in dK/dV) and keeps its
// accumulators in the mma C layout. Operands wait in shared memory split and packed in the
// mma fragment order, 8 x 8 blocks of them: per block and lane one float4
// {hi, hi, lo, lo} of a B operand, or two ({hi x4}, {lo x4}) of an A operand,
// so that every fragment is one 16-byte load and a warp reads 512 contiguous
// bytes: no bank conflicts. Within each 8-wide step of a contraction, mma
// slot t holds element 2t and slot t + 4 element 2t + 1. The C fragment of
// S (columns 2t and 2t + 1 of each 8) is then the A fragment of P V, dS K,
// P^T dO or dS^T Q as it stands, split in registers, and a lane's two
// values of an operand contracted over d are one 8-byte load.
//
// Tiles come from device memory by cp.async while the previous tile's
// products run, each thread copying the elements of its own slots into a
// staging area in slot order; between two barriers each thread then splits
// and packs what it copied, so the block splits every element once for all
// of its warps. The transposed operands of the products that contract over
// rows (V in P V, K in dS K, Q and dO in dK/dV) are copied 4 bytes at a
// time, the others 8.
//
// The tensor cores' f32 sums drift over a long chain of products: O at d 16
// against 4,096 keys accumulated in them ended 2.4e-5 of its largest entry
// from the plain version on the card. So the products over a tile's keys or
// queries are summed in the tensor cores per tile (12 or 24 mma) and added
// to the f32 accumulators by the f32 adds.

// The forward's warps own kFwdMt m-tiles of 16 query rows each, so that each
// B fragment a warp loads from shared memory feeds kFwdMt products: 32 rows a
// warp halve its fragment bytes per product, and its blocks of 4 warps run 2
// to an SM. The backward's warps own 16 rows (queries in dQ, keys in dK/dV):
// with 32, their accumulators spilled and they ran slower on the H100.
constexpr int kFwdMt = D <= 64 ? 2 : 1;
constexpr int kFwdWarps = 4;
constexpr int kBwdWarps = D <= 64 ? 8 : 4;
constexpr int kFwdRows = 16 * kFwdMt * kFwdWarps;  // a forward block's queries
constexpr int kBwdRows = 16 * kBwdWarps;           // a dQ block's queries, a dK/dV block's keys
static_assert(128 % kFwdRows == 0 && 128 % kBwdRows == 0, "blocks tile N and Nk, multiples of 128");
constexpr int kFwdKeysF = D <= 64 ? 32 : 16;  // forward: keys per tile
constexpr int kDqKeysF = D <= 48 ? 64 : (D <= 64 ? 32 : 16);  // dQ: keys per tile
constexpr int kDkvRowsF = D <= 64 ? 32 : 16;  // dK/dV: queries per tile

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = hi + lo to within 2^-22 |x|, hi and lo TF32 values
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// c += A B: A 16 x 8 (a0..a3), B 8 x 8 (b0, b1), TF32 in, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const float4& a, float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)), "r"(__float_as_uint(a.z)),
        "r"(__float_as_uint(a.w)), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// c += A B to f32 accuracy, the small terms first: b = {hi0, hi1, lo0, lo1}
__device__ __forceinline__ void mma3(float (&c)[4], const float4& ahi, const float4& alo,
                                     const float4& b) {
  mma_tf32(c, alo, b.x, b.y);
  mma_tf32(c, ahi, b.z, b.w);
  mma_tf32(c, ahi, b.x, b.y);
}

// The A fragment (hi, lo) of a product over the 8 columns of C block c:
// columns 2t and 2t + 1 are slots t and t + 4, so a0, a1, a2, a3 = c0, c2, c1, c3.
__device__ __forceinline__ void split_c(const float (&c)[4], float4& hi, float4& lo) {
  split_tf32(c[0], hi.x, lo.x);
  split_tf32(c[2], hi.y, lo.y);
  split_tf32(c[1], hi.z, lo.z);
  split_tf32(c[3], hi.w, lo.w);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The 16 MT rows per warp of a [.., D] tensor at `src` (row stride `stride`
// elements) as A operands: block (mb, kb) = rows 16 mb.., d 8 kb..; lane
// (g, t) holds rows 16 mb + g and + 8 at d 8 kb + 2t (a0, a1) and + 1 (a2,
// a3), {hi x4} then {lo x4} 512 bytes on. Each warp packs its own MT m-tiles.
template <int MT>
__device__ __forceinline__ void pack_a(float4* dst, const float* src, long long stride) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int mb = warp * MT + mt;
    const float* r0 = src + (16 * mb + (lane >> 2)) * stride + 2 * (lane & 3);
    const float* r1 = r0 + 8 * stride;
#pragma unroll
    for (int kb = 0; kb < D / 8; ++kb) {
      const float2 x0 = *reinterpret_cast<const float2*>(r0 + 8 * kb);
      const float2 x1 = *reinterpret_cast<const float2*>(r1 + 8 * kb);
      float4 hi, lo;
      split_tf32(x0.x, hi.x, lo.x);
      split_tf32(x1.x, hi.y, lo.y);
      split_tf32(x0.y, hi.z, lo.z);
      split_tf32(x1.y, hi.w, lo.w);
      float4* blk = dst + (mb * (D / 8) + kb) * 64;
      blk[lane] = hi;
      blk[32 + lane] = lo;
    }
  }
}

// ROWS rows x D of a [.., D] tensor as a B operand. kByD: the product
// contracts over d; block kb * ROWS / 8 + nb holds d 8 kb.. of rows 8 nb..,
// lane (g, t) row 8 nb + g at d 8 kb + 2t and + 1. Otherwise it contracts over
// the rows; block kb * D / 8 + nb holds rows 8 kb.. at d 8 nb.., lane (g, t)
// rows 8 kb + 2t and + 1 at d 8 nb + g. Of a block of WARPS warps, a thread
// takes the same lane of every WARPS-th block from its warp's on: `copy`
// starts the copies of its raw values into `raw` (a float2 per slot, in slot
// order), `pack` splits them into the pack (a float4 per slot) once they have
// arrived.
template <int ROWS, bool kByD, int WARPS>
struct BPack {
  static constexpr int kBlocks = ROWS / 8 * (D / 8);
  static constexpr int kPer = kBlocks / WARPS;
  static constexpr int kSlots = kBlocks * 32;
  static_assert(kBlocks % WARPS == 0, "a warp's share of the blocks");

  static __device__ __forceinline__ void copy(float2* raw, const float* src, long long stride) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int blk = threadIdx.x / 32 + r * WARPS;
      float2* dst = raw + blk * 32 + lane;
      if constexpr (kByD) {
        const int kb = blk / (ROWS / 8), nb = blk % (ROWS / 8);
        cp_async8(dst, src + (8 * nb + g) * stride + 8 * kb + 2 * t);
      } else {
        const int kb = blk / (D / 8), nb = blk % (D / 8);
        const float* e = src + (8 * kb + 2 * t) * stride + 8 * nb + g;
        cp_async4(&dst->x, e);
        cp_async4(&dst->y, e + stride);
      }
    }
  }

  static __device__ __forceinline__ void pack(float4* dst, const float2* raw) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = (threadIdx.x / 32 + r * WARPS) * 32 + lane;
      const float2 x = raw[i];
      float4 v;
      split_tf32(x.x, v.x, v.z);
      split_tf32(x.y, v.y, v.w);
      dst[i] = v;
    }
  }
};

// A warp's 16 x D accumulator, times `mul[0]` (rows g) and `mul[1]` (rows
// g + 8), to rows row0.. of an f32 [.., D] tensor with row stride `stride`.
__device__ __forceinline__ void store_rows_f32(float* dst, long long stride, int row0,
                                               const float (&acc)[D / 8][4], float mul0,
                                               float mul1, int lane) {
  float* r0 = dst + static_cast<long long>(row0 + (lane >> 2)) * stride + (lane & 3) * 2;
  float* r1 = r0 + 8 * stride;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    *reinterpret_cast<float2*>(r0 + dn * 8) = make_float2(acc[dn][0] * mul0, acc[dn][1] * mul0);
    *reinterpret_cast<float2*>(r1 + dn * 8) = make_float2(acc[dn][2] * mul1, acc[dn][3] * mul1);
  }
}

// One block: kFwdRows query rows of one (item, head), Q packed once; a loop
// over tiles of kFwdKeysF keys: S = Q K^T, the online softmax of the bf16
// forward (exp2 with scale * log2(e) folded, running max and sum in f32),
// O = O * corr + P V with P split in registers.
__device__ void fwd_tf32(const Params& p) {
  constexpr int kKeys = kFwdKeysF, MT = kFwdMt, W = kFwdWarps;
  using KPack = BPack<kKeys, true, W>;   // S = Q K^T contracts over d
  using VPack = BPack<kKeys, false, W>;  // O += P V over the keys
  extern __shared__ __align__(16) unsigned char f32_smem[];
  float4* qs = reinterpret_cast<float4*>(f32_smem);
  float4* ks = qs + kFwdRows * D / 2;
  float4* vs = ks + KPack::kSlots;
  float2* kraw = reinterpret_cast<float2*>(vs + VPack::kSlots);
  float2* vraw = kraw + KPack::kSlots;
  const int q0 = blockIdx.x * kFwdRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const float* k = static_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const float* v = static_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;
  KPack::copy(kraw, k, p.ksn);
  VPack::copy(vraw, v, p.vsn);
  cp_async_commit();
  pack_a<MT>(qs, static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh + q0 * p.qsn, p.qsn);

  const float4* qw = qs + warp * MT * (D / 8) * 64;  // this warp's rows
  const float sl2 = p.scale * kLog2e;
  float o[MT][D / 8][4] = {};
  float m[MT][2], l[MT][2] = {};  // running row max (log2 units); this thread's share of the sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) m[mt][0] = m[mt][1] = -INFINITY;
  const int tiles = p.Nk / kKeys;
  for (int j = 0; j < tiles; ++j) {
    __syncthreads();  // every warp is done with the previous tile
    cp_async_wait_all();
    KPack::pack(ks, kraw);
    VPack::pack(vs, vraw);
    __syncthreads();
    if (j + 1 < tiles) {
      KPack::copy(kraw, k + (j + 1) * kKeys * p.ksn, p.ksn);
      VPack::copy(vraw, v + (j + 1) * kKeys * p.vsn, p.vsn);
      cp_async_commit();
    }
    float s[MT][kKeys / 8][4] = {};
#pragma unroll
    for (int kb = 0; kb < D / 8; ++kb) {
      float4 ahi[MT], alo[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ahi[mt] = qw[(mt * (D / 8) + kb) * 64 + lane];
        alo[mt] = qw[(mt * (D / 8) + kb) * 64 + 32 + lane];
      }
#pragma unroll
      for (int nb = 0; nb < kKeys / 8; ++nb) {
        const float4 bk = ks[(kb * (kKeys / 8) + nb) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma3(s[mt][nb], ahi[mt], alo[mt], bk);
      }
    }
    float corr[MT][2];
    float4 phi[MT][kKeys / 8], plo[MT][kKeys / 8];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nb = 0; nb < kKeys / 8; ++nb) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][nb][0], s[mt][nb][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][nb][2], s[mt][nb][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // scale > 0, so the max commutes with the scaling; m = -inf on the
        // first tile gives corr = exp2(-inf) = 0 against a finite new max
        const float mn = fmaxf(m[mt][r], quad_max(mx[r]) * sl2);
        corr[mt][r] = exp2f(m[mt][r] - mn);
        m[mt][r] = mn;
        l[mt][r] *= corr[mt][r];
      }
#pragma unroll
      for (int nb = 0; nb < kKeys / 8; ++nb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][nb][i] = exp2f(s[mt][nb][i] * sl2 - m[mt][i >> 1]);
        l[mt][0] += s[mt][nb][0] + s[mt][nb][1];
        l[mt][1] += s[mt][nb][2] + s[mt][nb][3];
        split_c(s[mt][nb], phi[mt][nb], plo[mt][nb]);
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      float t[MT][4] = {};
#pragma unroll
      for (int kb = 0; kb < kKeys / 8; ++kb) {
        const float4 bv = vs[(kb * (D / 8) + dn) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma3(t[mt], phi[mt][kb], plo[mt][kb], bv);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) o[mt][dn][i] = o[mt][dn][i] * corr[mt][i >> 1] + t[mt][i];
      }
    }
  }

  float* out = static_cast<float*>(p.out) + (static_cast<long long>(b) * p.N * p.H + h) * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float l0 = quad_sum(l[mt][0]), l1 = quad_sum(l[mt][1]);
    const int row0 = q0 + (warp * MT + mt) * 16;
    store_rows_f32(out, static_cast<long long>(p.H) * D, row0, o[mt], 1.f / l0, 1.f / l1, lane);
    if ((lane & 3) == 0) {
      float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.N + row0 + (lane >> 2);
      lse[0] = m[mt][0] * kLn2 + logf(l0);
      lse[8] = m[mt][1] * kLn2 + logf(l1);
    }
  }
}

// One block: kBwdRows query rows of one (item, head), Q and dO packed once,
// L and delta of the thread's two rows in registers; a loop over tiles of
// kDqKeysF keys: S = Q K^T, dP = dO V^T,
// dS = exp2(S * scale * log2(e) - L * log2(e)) * (dP - delta), dQ += dS K;
// dQ scaled at the end.
__device__ void dq_tf32(const Params& p) {
  constexpr int kKeys = kDqKeysF;
  using KPack = BPack<kKeys, true, kBwdWarps>;    // K in S = Q K^T, V in dP = dO V^T: over d
  using KtPack = BPack<kKeys, false, kBwdWarps>;  // K in dQ += dS K: over the keys
  extern __shared__ __align__(16) unsigned char f32_smem[];
  float4* qs = reinterpret_cast<float4*>(f32_smem);
  float4* dos = qs + kBwdRows * D / 2;
  float4* ks = dos + kBwdRows * D / 2;
  float4* kts = ks + KPack::kSlots;
  float4* vs = kts + KtPack::kSlots;
  float2* kraw = reinterpret_cast<float2*>(vs + KPack::kSlots);
  float2* ktraw = kraw + KPack::kSlots;
  float2* vraw = ktraw + KtPack::kSlots;
  const int q0 = blockIdx.x * kBwdRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const long long on = static_cast<long long>(p.H) * D;  // dO: contiguous [B, N, H, D]
  const float* k = static_cast<const float*>(p.k) + b * p.ksb + h * p.ksh;
  const float* v = static_cast<const float*>(p.v) + b * p.vsb + h * p.vsh;
  KPack::copy(kraw, k, p.ksn);
  KtPack::copy(ktraw, k, p.ksn);
  KPack::copy(vraw, v, p.vsn);
  cp_async_commit();
  pack_a<1>(qs, static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh + q0 * p.qsn, p.qsn);
  pack_a<1>(dos, static_cast<const float*>(p.dout) + (static_cast<long long>(b) * p.N + q0) * on +
                     h * D, on);

  const int row0 = q0 + warp * 16;
  const long long row = (static_cast<long long>(b) * p.H + h) * p.N + row0 + (lane >> 2);
  const float l2[2] = {p.lse[row] * kLog2e, p.lse[row + 8] * kLog2e};
  const float dl[2] = {p.delta[row], p.delta[row + 8]};
  const float sl2 = p.scale * kLog2e;
  const float4* qw = qs + warp * (D / 8) * 64;
  const float4* ow = dos + warp * (D / 8) * 64;
  float dq[D / 8][4] = {};
  const int tiles = p.Nk / kKeys;
  for (int j = 0; j < tiles; ++j) {
    __syncthreads();
    cp_async_wait_all();
    KPack::pack(ks, kraw);
    KtPack::pack(kts, ktraw);
    KPack::pack(vs, vraw);
    __syncthreads();
    if (j + 1 < tiles) {
      KPack::copy(kraw, k + (j + 1) * kKeys * p.ksn, p.ksn);
      KtPack::copy(ktraw, k + (j + 1) * kKeys * p.ksn, p.ksn);
      KPack::copy(vraw, v + (j + 1) * kKeys * p.vsn, p.vsn);
      cp_async_commit();
    }
    float s[kKeys / 8][4] = {}, dp[kKeys / 8][4] = {};
#pragma unroll
    for (int kb = 0; kb < D / 8; ++kb) {
      const float4 qhi = qw[kb * 64 + lane], qlo = qw[kb * 64 + 32 + lane];
      const float4 ohi = ow[kb * 64 + lane], olo = ow[kb * 64 + 32 + lane];
#pragma unroll
      for (int nb = 0; nb < kKeys / 8; ++nb) {
        mma3(s[nb], qhi, qlo, ks[(kb * (kKeys / 8) + nb) * 32 + lane]);
        mma3(dp[nb], ohi, olo, vs[(kb * (kKeys / 8) + nb) * 32 + lane]);
      }
    }
    float4 dhi[kKeys / 8], dlo[kKeys / 8];
#pragma unroll
    for (int nb = 0; nb < kKeys / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nb][i] = exp2_ftz(s[nb][i] * sl2 - l2[i >> 1]) * (dp[nb][i] - dl[i >> 1]);
      }
      split_c(s[nb], dhi[nb], dlo[nb]);
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      float t[4] = {};
#pragma unroll
      for (int kb = 0; kb < kKeys / 8; ++kb) {
        mma3(t, dhi[kb], dlo[kb], kts[(kb * (D / 8) + dn) * 32 + lane]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) dq[dn][i] += t[i];
    }
  }
  float* gq = static_cast<float*>(p.dq) + b * p.gsb + h * p.gsh;
  store_rows_f32(gq, p.gsn, row0, dq, p.scale, p.scale, lane);
}

// One block: kBwdRows keys of one (item, head), K and V packed once; a loop
// over tiles of kDkvRowsF query rows with their L and delta: S^T = K Q^T,
// dP^T = V dO^T, P^T = exp2(S^T * scale * log2(e) - L * log2(e)),
// dS^T = P^T * (dP^T - delta) (L and delta per column), dV += P^T dO,
// dK += dS^T Q; dK scaled at the end.
__device__ void dkv_tf32(const Params& p) {
  constexpr int kRowsQ = kDkvRowsF;
  using QPack = BPack<kRowsQ, true, kBwdWarps>;    // Q in S^T = K Q^T, dO in dP^T = V dO^T: over d
  using QtPack = BPack<kRowsQ, false, kBwdWarps>;  // Q in dK += dS^T Q, dO in dV += P^T dO
  static_assert(kBwdWarps * 32 >= kRowsQ, "a thread per row copies L and delta");
  extern __shared__ __align__(16) unsigned char f32_smem[];
  float4* ks = reinterpret_cast<float4*>(f32_smem);
  float4* vs = ks + kBwdRows * D / 2;
  float4* qs = vs + kBwdRows * D / 2;
  float4* qts = qs + QPack::kSlots;
  float4* dos = qts + QtPack::kSlots;
  float4* dots = dos + QPack::kSlots;
  float2* qraw = reinterpret_cast<float2*>(dots + QtPack::kSlots);
  float2* qtraw = qraw + QPack::kSlots;
  float2* oraw = qtraw + QtPack::kSlots;
  float2* otraw = oraw + QPack::kSlots;
  float* ls = reinterpret_cast<float*>(otraw + QtPack::kSlots);  // L log2(e) of the tile's rows
  float* dls = ls + kRowsQ;                                       // their delta
  float* lraw = dls + kRowsQ;                                     // L and delta as copied
  float* draw = lraw + kRowsQ;
  const int k0 = blockIdx.x * kBwdRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const long long on = static_cast<long long>(p.H) * D;  // dO: contiguous [B, N, H, D]
  const long long bh = (static_cast<long long>(b) * p.H + h) * p.N;
  const float* q = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* dout = static_cast<const float*>(p.dout) + static_cast<long long>(b) * p.N * on +
                      h * D;
  const bool lrow = threadIdx.x < kRowsQ;  // copies one row's L and delta
  QPack::copy(qraw, q, p.qsn);
  QtPack::copy(qtraw, q, p.qsn);
  QPack::copy(oraw, dout, on);
  QtPack::copy(otraw, dout, on);
  if (lrow) {
    cp_async4(lraw + threadIdx.x, p.lse + bh + threadIdx.x);
    cp_async4(draw + threadIdx.x, p.delta + bh + threadIdx.x);
  }
  cp_async_commit();
  pack_a<1>(ks, static_cast<const float*>(p.k) + b * p.ksb + h * p.ksh + k0 * p.ksn, p.ksn);
  pack_a<1>(vs, static_cast<const float*>(p.v) + b * p.vsb + h * p.vsh + k0 * p.vsn, p.vsn);

  const float4* kw = ks + warp * (D / 8) * 64;
  const float4* vw = vs + warp * (D / 8) * 64;
  const float sl2 = p.scale * kLog2e;
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  const int tiles = p.N / kRowsQ;
  for (int i = 0; i < tiles; ++i) {
    __syncthreads();
    cp_async_wait_all();
    QPack::pack(qs, qraw);
    QtPack::pack(qts, qtraw);
    QPack::pack(dos, oraw);
    QtPack::pack(dots, otraw);
    if (lrow) {
      ls[threadIdx.x] = lraw[threadIdx.x] * kLog2e;
      dls[threadIdx.x] = draw[threadIdx.x];
    }
    __syncthreads();
    if (i + 1 < tiles) {
      const long long r1 = static_cast<long long>(i + 1) * kRowsQ;
      QPack::copy(qraw, q + r1 * p.qsn, p.qsn);
      QtPack::copy(qtraw, q + r1 * p.qsn, p.qsn);
      QPack::copy(oraw, dout + r1 * on, on);
      QtPack::copy(otraw, dout + r1 * on, on);
      if (lrow) {
        cp_async4(lraw + threadIdx.x, p.lse + bh + r1 + threadIdx.x);
        cp_async4(draw + threadIdx.x, p.delta + bh + r1 + threadIdx.x);
      }
      cp_async_commit();
    }
    float st[kRowsQ / 8][4] = {}, dpt[kRowsQ / 8][4] = {};
#pragma unroll
    for (int kb = 0; kb < D / 8; ++kb) {
      const float4 khi = kw[kb * 64 + lane], klo = kw[kb * 64 + 32 + lane];
      const float4 vhi = vw[kb * 64 + lane], vlo = vw[kb * 64 + 32 + lane];
#pragma unroll
      for (int nb = 0; nb < kRowsQ / 8; ++nb) {
        mma3(st[nb], khi, klo, qs[(kb * (kRowsQ / 8) + nb) * 32 + lane]);
        mma3(dpt[nb], vhi, vlo, dos[(kb * (kRowsQ / 8) + nb) * 32 + lane]);
      }
    }
    // this thread's columns: nb * 8 + 2t and the next
    const float* lt = ls + (lane & 3) * 2;
    const float* dt = dls + (lane & 3) * 2;
    float4 phi[kRowsQ / 8], plo[kRowsQ / 8], dhi[kRowsQ / 8], dlo[kRowsQ / 8];
#pragma unroll
    for (int nb = 0; nb < kRowsQ / 8; ++nb) {
      const float2 lc = *reinterpret_cast<const float2*>(lt + nb * 8);
      const float2 dc = *reinterpret_cast<const float2*>(dt + nb * 8);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pt = exp2_ftz(st[nb][c] * sl2 - ((c & 1) ? lc.y : lc.x));
        st[nb][c] = pt;
        dpt[nb][c] = pt * (dpt[nb][c] - ((c & 1) ? dc.y : dc.x));
      }
      split_c(st[nb], phi[nb], plo[nb]);
      split_c(dpt[nb], dhi[nb], dlo[nb]);
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      float tv[4] = {}, tk[4] = {};
#pragma unroll
      for (int kb = 0; kb < kRowsQ / 8; ++kb) {
        mma3(tv, phi[kb], plo[kb], dots[(kb * (D / 8) + dn) * 32 + lane]);
        mma3(tk, dhi[kb], dlo[kb], qts[(kb * (D / 8) + dn) * 32 + lane]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dv[dn][c] += tv[c];
        dk[dn][c] += tk[c];
      }
    }
  }
  const int row0 = k0 + warp * 16;
  float* gk = static_cast<float*>(p.dk) + b * p.dsb + h * p.dsh;
  float* gv = static_cast<float*>(p.dv) + b * p.dsb + h * p.dsh;
  store_rows_f32(gk, p.dsn, row0, dk, p.scale, p.scale, lane);
  store_rows_f32(gv, p.dsn, row0, dv, 1.f, 1.f, lane);
}

// ---------------------------------------------------------------------------
// The kernels: wgmma kernels for bf16, TF32 mma ones for f32; the delta
// kernel serves both types.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap) {
  fwd_wgmma(p, &qmap, &kmap, &vmap);
}

__global__ void __launch_bounds__(32 * kFwdWarps, 1)
    flash_fwd_tf32_kernel(const Params p) {
  fwd_tf32(p);
}

__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_dkv_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap omap) {
  dkv_wgmma(p, &kmap, &vmap, &qmap, &omap);
}

__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_dq_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap) {
  dq_wgmma(p, &qmap, &kmap, &vmap, &omap);
}

__global__ void __launch_bounds__(32 * kBwdWarps, 1)
    flash_dkv_tf32_kernel(const Params p) {
  dkv_tf32(p);
}

__global__ void __launch_bounds__(32 * kBwdWarps, 1)
    flash_dq_tf32_kernel(const Params p) {
  dq_tf32(p);
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

// f32: a packed row of D values takes 8 D bytes (hi and lo)
template <typename T>
constexpr int fwd_smem() {
  // bf16: Q, the K and V ring, then 2 kStages + 1 mbarriers; f32: Q, K and V
  // packed, K and V as copied (half a pack each)
  return sizeof(T) == 2 ? (1 + 2 * kStages) * kTileBytes + (2 * kStages + 1) * 8
                        : (kFwdRows + 3 * kFwdKeysF) * D * 8;
}

template <typename T>
constexpr int dkv_smem() {
  // bf16: K, V, the ring of Q, dO, L and delta, then 2 kDkvStages + 1 mbarriers;
  // f32: K, V, Q and dO each packed twice and as copied, L and delta twice
  return sizeof(T) == 2 ? 2 * kTileBytes + kDkvStages * kDkvStageBytes + (2 * kDkvStages + 1) * 8
                        : (2 * kBwdRows + 6 * kDkvRowsF) * D * 8 + 4 * kDkvRowsF * 4;
}

template <typename T>
constexpr int dq_smem() {
  // bf16: Q, dO, the K and V ring, then 2 kDqStages + 1 mbarriers; f32: Q, dO,
  // K packed twice, V, and as copied
  return sizeof(T) == 2 ? (2 + 2 * kDqStages) * kTileBytes + (2 * kDqStages + 1) * 8
                        : (2 * kBwdRows + 3 * kDqKeysF) * D * 8 + 3 * kDqKeysF * D * 4;
}

static_assert(fwd_smem<float>() <= kSmemPerBlock && dkv_smem<float>() <= kSmemPerBlock &&
                  dq_smem<float>() <= kSmemPerBlock,
              "f32 tiles exceed a block's shared memory");

bool bad_shape(const Params& p) {
  return p.B <= 0 || p.N <= 0 || p.H <= 0 || p.N % 128 != 0 || p.Nk <= 0 ||
         p.Nk % 128 != 0 || p.B > 65535 || p.H > 65535 || !(p.scale > 0.f);
}

// The kernels load and store rows 16 bytes at a time (TMA and bulk copies
// too): every pointer and every stride (in elements of T) must keep a row
// 16-byte aligned. Pointers and strides a call does not use are 0.
template <typename T>
bool misaligned(const Params& p) {
  constexpr long long per16 = 16 / sizeof(T);
  const long long strides[] = {p.qsb, p.qsn, p.qsh, p.ksb, p.ksn, p.ksh,
                               p.vsb, p.vsn, p.vsh, p.gsb, p.gsn, p.gsh,
                               p.dsb, p.dsn, p.dsh};
  for (long long st : strides) {
    if (st % per16 != 0) return true;
  }
  const void* ptrs[] = {p.q, p.k, p.v, p.out, p.o, p.dout, p.dq, p.dk, p.dv, p.lse, p.delta};
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

// The tensor map of a bf16 [B, n, H, D] view with element strides (sb, sn, sh)
// whose [rows, D] boxes land in the slab layout of fwd_wgmma: dims (16
// elements, n rows, D / 16 slabs of 32 bytes, H, B), box (16, rows, D / 16, 1,
// 1), 32-byte swizzle. Encoded per call, since the map holds the base pointer.
cudaError_t tile_map(CUtensorMap* map, const void* base, const Params& p, long long n,
                     long long sb, long long sn, long long sh, int rows = kRows) {
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[5] = {16, static_cast<cuuint64_t>(n), D / 16,
                              static_cast<cuuint64_t>(p.H), static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(sn) * 2, 32,  // bytes, dims 1..4
                                 static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[5] = {16, static_cast<cuuint32_t>(rows), D / 16, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename K>
cudaError_t max_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
    err = max_smem(flash_fwd_wgmma_kernel, fwd_smem<T>());
    if (err == cudaSuccess) err = max_smem(flash_dkv_wgmma_kernel, dkv_smem<T>());
    if (err == cudaSuccess) err = max_smem(flash_dq_wgmma_kernel, dq_smem<T>());
  } else {
    err = max_smem(flash_fwd_tf32_kernel, fwd_smem<T>());
    if (err == cudaSuccess) err = max_smem(flash_dkv_tf32_kernel, dkv_smem<T>());
    if (err == cudaSuccess) err = max_smem(flash_dq_tf32_kernel, dq_smem<T>());
  }
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

template <typename T>
cudaError_t forward(const Params& p, cudaStream_t s) {
  if (misaligned<T>(p)) return cudaErrorMisalignedAddress;
  cudaError_t err = ensure_smem_limits<T>();
  if (err != cudaSuccess) return err;
  // a block per kRows (f32: kFwdRows) queries
  const int rows = sizeof(T) == 2 ? kRows : kFwdRows;
  const dim3 grid(static_cast<unsigned>(p.N / rows), static_cast<unsigned>(p.H),
                  static_cast<unsigned>(p.B));
  if constexpr (sizeof(T) == 2) {
    CUtensorMap qmap, kmap, vmap;
    err = tile_map(&qmap, p.q, p, p.N, p.qsb, p.qsn, p.qsh);
    if (err == cudaSuccess) err = tile_map(&kmap, p.k, p, p.Nk, p.ksb, p.ksn, p.ksh);
    if (err == cudaSuccess) err = tile_map(&vmap, p.v, p, p.Nk, p.vsb, p.vsn, p.vsh);
    if (err != cudaSuccess) return err;
    flash_fwd_wgmma_kernel<<<grid, kFwdThreads, fwd_smem<T>(), s>>>(p, qmap, kmap, vmap);
  } else {
    flash_fwd_tf32_kernel<<<grid, 32 * kFwdWarps, fwd_smem<T>(), s>>>(p);
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
  // dQ: a block per kRows (f32: kBwdRows) queries; dK/dV: per as many of the Nk keys
  const int brows = sizeof(T) == 2 ? kRows : kBwdRows;
  const dim3 grid(static_cast<unsigned>(p.N / brows), static_cast<unsigned>(p.H),
                  static_cast<unsigned>(p.B));
  const dim3 kgrid(static_cast<unsigned>(p.Nk / brows), static_cast<unsigned>(p.H),
                   static_cast<unsigned>(p.B));
  if constexpr (sizeof(T) == 2) {
    // dO is contiguous [B, N, H, D]; dK/dV reads Q and dO in tiles of kQRows rows
    const long long on = static_cast<long long>(p.H) * D, ob = p.N * on;
    CUtensorMap qmap, kmap, vmap, omap, qrows, orows;
    err = tile_map(&qmap, p.q, p, p.N, p.qsb, p.qsn, p.qsh);
    if (err == cudaSuccess) err = tile_map(&kmap, p.k, p, p.Nk, p.ksb, p.ksn, p.ksh);
    if (err == cudaSuccess) err = tile_map(&vmap, p.v, p, p.Nk, p.vsb, p.vsn, p.vsh);
    if (err == cudaSuccess) err = tile_map(&omap, p.dout, p, p.N, ob, on, D);
    if (err == cudaSuccess) err = tile_map(&qrows, p.q, p, p.N, p.qsb, p.qsn, p.qsh, kQRows);
    if (err == cudaSuccess) err = tile_map(&orows, p.dout, p, p.N, ob, on, D, kQRows);
    if (err != cudaSuccess) return err;
    flash_dkv_wgmma_kernel<<<kgrid, kFwdThreads, dkv_smem<T>(), s>>>(p, kmap, vmap, qrows, orows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_dq_wgmma_kernel<<<grid, kFwdThreads, dq_smem<T>(), s>>>(p, qmap, kmap, vmap, omap);
  } else {
    flash_dkv_tf32_kernel<<<kgrid, 32 * kBwdWarps, dkv_smem<T>(), s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_dq_tf32_kernel<<<grid, 32 * kBwdWarps, dq_smem<T>(), s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attn_head_dim() { return D; }

// dtype: 0 = float32, 1 = bfloat16. q: [B, N, H, D], k, v: [B, Nk, H, D] views
// with element strides (batch, row, head), D contiguous. out: contiguous [B, N,
// H, D]; lse: f32 [B, H, N]. Returns a cudaError_t.
extern "C" int flash_attn_forward(const void* q, const void* k, const void* v, void* out,
                                  float* lse, int B, int N, int Nk, int H, long long qsb,
                                  long long qsn, long long qsh, long long ksb, long long ksn,
                                  long long ksh, long long vsb, long long vsn, long long vsh,
                                  float scale, int dtype, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse = lse;
  p.qsb = qsb; p.qsn = qsn; p.qsh = qsh;
  p.ksb = ksb; p.ksn = ksn; p.ksh = ksh;
  p.vsb = vsb; p.vsn = vsn; p.vsh = vsh;
  p.B = B; p.N = N; p.Nk = Nk; p.H = H; p.scale = scale;
  if (bad_shape(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(forward<float>(p, s));
  if (dtype == 1) return static_cast<int>(forward<bf16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The three backward kernels in order: delta, dK/dV, dQ. q: [B, N, H, D], k, v:
// [B, Nk, H, D] views as for flash_attn_forward; o, dout: contiguous [B, N, H, D];
// lse, delta (scratch): f32 [B, H, N]; dq: a [B, N, H, D] view with element strides
// (gsb, gsn, gsh); dk, dv: [B, Nk, H, D] views sharing the strides (dsb, dsn, dsh).
// Returns a cudaError_t.
extern "C" int flash_attn_backward(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, float* lse, float* delta, void* dq, void* dk,
                                   void* dv, int B, int N, int Nk, int H, long long qsb,
                                   long long qsn, long long qsh, long long ksb, long long ksn,
                                   long long ksh, long long vsb, long long vsn, long long vsh,
                                   long long gsb, long long gsn, long long gsh, long long dsb,
                                   long long dsn, long long dsh, float scale, int dtype,
                                   void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.qsb = qsb; p.qsn = qsn; p.qsh = qsh;
  p.ksb = ksb; p.ksn = ksn; p.ksh = ksh;
  p.vsb = vsb; p.vsn = vsn; p.vsh = vsh;
  p.gsb = gsb; p.gsn = gsn; p.gsh = gsh;
  p.dsb = dsb; p.dsn = dsn; p.dsh = dsh;
  p.B = B; p.N = N; p.Nk = Nk; p.H = H; p.scale = scale;
  if (bad_shape(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(backward<float>(p, s));
  if (dtype == 1) return static_cast<int>(backward<bf16>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
