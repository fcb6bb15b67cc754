// Gaussian-atom rasterizer for Hopper: images as a sum of separable Gaussians.
//
// Replaces the Pallas TPU kernel `_raster_kernel` / `rasterize_pallas` in
// toycrystals_tpu/data/rasterize.py. Per image b, with c = inv[b] = 1 / (2 sigma_b^2):
//
//   Ey[h, p] = exp(-(h - y_p)^2 c) * w_p      Ex[w, p] = exp(-(w - x_p)^2 c)
//   out[h, w] = sum_p Ey[h, p] * Ex[w, p]          (f32 throughout, no TF32)
//
// Bound: bytes. A call must read points, weights and inv once and write the
// images once, 4 * B * (3P + H*W + 1) bytes: 4.26 MB (1.27 us at 3.35 TB/s) for
// the 64x64 training batch (B 128, P 1,408) and 12.12 MB (3.62 us) for the
// 256x256 one (B 32, P 9,728). The operations that the data needs are far
// fewer: an atom with weight 0 adds nothing, and a factor exp(e) is exactly
// 0.0f for e < -104 (below half the smallest denormal), i.e. beyond about
// 14.4 sigma. Only 6-13% of a budget's atoms carry weight and each reaches a
// few dozen rows and columns, so the pairs with both factors non-zero (2
// operations each, plus one exp per row and column) take a fraction of the
// bytes time (chip_smoke.py:raster_bound counts them on each run's data). A
// dense render of every atom of the budget at every pixel does 24-160x more.
//
// So the design renders only what reaches a pixel, and keeps atoms in flight:
//
// - An item is one 64 x 64 output tile of one image. One CTA of 16 warps
//   splits it into 16 x 16 warp sub-tiles. The grid is as many CTAs as the
//   card holds at once (or one per item), and each CTA walks its share.
// - The atoms of a CTA's items reach shared memory as one stream of chunks by
//   cp.async.bulk through a ring of 48 KB, one "full" mbarrier per stage; a
//   stage is refilled as soon as the CTA has filtered it, so the chunks of the
//   next item land while this one renders. Each tile's CTA reads its image's
//   atoms itself (from L2 after the first tile).
// - Each CTA filters every chunk as it lands: an atom is kept when its weight
//   is non-zero and its exponent at the tile's nearest row and at its nearest
//   column, computed with the render's own f32 expression, is not below -104.
//   A skipped atom therefore adds exactly 0 at every pixel of the tile (the
//   exponent only falls further away from the nearest row). Survivors go to a
//   list in shared memory in index order: each thread tests a few atoms of the
//   chunk, and one barrier and one warp's scan of the ballot counts per
//   (atom block, warp) give every survivor its place; no atomics, so a rerun
//   repeats bit for bit. A list that would outgrow its buffer is rendered and
//   emptied first, pass after pass, so nothing is ever cut off.
// - To render, each warp filters the CTA's list again against its 16 x 16
//   sub-tile (same test), builds Ey and Ex of its survivors only (one expf
//   per lane and survivor: 16 rows and 16 columns), and accumulates a 2 x 4
//   register tile per lane with f32 FMAs in index order.
//
// A thread-block cluster per image, its atoms multicast to the cluster's CTAs
// once, measured slower on the card than every CTA reading its own from L2
// (the cluster advanced at the pace of its slowest CTA; PERF.md). So did
// tiles of 16 px at every shape measured, and of 32 px at every shape but
// batches of 32 or fewer 64 x 64 images, where they saved 1-2 us of a call
// whose host cost is 50-110 us (PERF.md).
//
// Plain C interface, built with nvcc and loaded through ctypes
// (toycrystals_torch/data/rasterize.py). The launch goes on the caller's
// stream; the function returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr float kCut = -104.f;  // expf(e) == 0.0f for every e < kCut, denormals or not
constexpr int kList = 1024;     // survivors a CTA holds before it renders a pass
constexpr int kSub = 16;        // warp sub-tile edge
constexpr int kBatch = 16;      // survivors whose factors a warp holds at once

constexpr int kTile = 64;       // output tile edge: one CTA's item
constexpr int kWarps = (kTile / kSub) * (kTile / kSub);
constexpr int kThreads = 32 * kWarps;
// atoms a thread tests per chunk: the chunk's kK * kWarps ballots, one per
// (atom block, warp), are scanned by one warp
constexpr int kK = 32 / kWarps;
constexpr int kChunk = kK * kThreads;     // atoms per ring stage
constexpr int kStages = 4;                // ring stages, 48 KB in all
constexpr int kStageBytes = 12 * kChunk;  // points, then weights

constexpr int align16(int n) { return (n + 15) / 16 * 16; }

// Shared-memory layout.
constexpr int kCntOff = 8 * kStages;  // after full[]
constexpr int kRingOff = align16(kCntOff + 2 * 32 * 4);  // int count[2][32]
constexpr int kListOff = kRingOff + kStages * kStageBytes;
constexpr int kWarpOff = kListOff + 12 * kList;  // x[kList], y[kList], w[kList]
// per warp: a buffer of up to 64 survivors' x, y, w (banks apart), then
// their factors f[kBatch][32]
constexpr int kWarpFloats = 208 + kBatch * 32;
constexpr int kSmem = kWarpOff + kWarps * kWarpFloats * 4;
static_assert(kK * kWarps == 32, "one warp scans the chunk's ballot counts");
static_assert(kChunk <= kList, "an emptied list holds any chunk's survivors");

struct Args {
  const float* points;   // [B, P, 2] (x, y)
  const float* weights;  // [B, P]
  const float* inv;      // [B]  1 / (2 sigma^2)
  float* out;            // [B, H, W]
  int P, H, W, tiles_x, tiles, items, cull;
};

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

// `bytes` (a multiple of 16) from global `src` into shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Whether the atom can reach a pixel of rows [r0, r1] x columns [c0, c1]: its
// weight is non-zero and neither exponent at the nearest row or column falls
// below kCut. The exponents are the render's own expression at that row and
// column, and lie further below at every other row and column.
__device__ __forceinline__ bool reaches(float x, float y, float w, float c, float r0, float r1,
                                        float c0, float c1) {
  const float dy = fminf(fmaxf(y, r0), r1) - y;
  const float dx = fminf(fmaxf(x, c0), c1) - x;
  return w != 0.f && !(-(dy * dy) * c < kCut) && !(-(dx * dx) * c < kCut);
}

// One CTA renders the items (image, tile) blockIdx.x, blockIdx.x + gridDim.x,
// ... Their atoms arrive as one stream of chunks through the ring, so the
// chunks of the next item load while this one renders.
__global__ void __launch_bounds__(kThreads, 2) rasterize_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int* cnt = reinterpret_cast<int*>(smem + kCntOff);
  unsigned char* ring = smem + kRingOff;
  float* lx = reinterpret_cast<float*>(smem + kListOff);
  float* ly = lx + kList;
  float* lw = ly + kList;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nch = (a.P + kChunk - 1) / kChunk;  // chunks per item
  const int mine = (a.items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                   static_cast<int>(gridDim.x);
  const int total = mine * nch;  // chunks in this CTA's stream

  auto chunk_atoms = [&](int ch) {
    const int n = a.P - ch * kChunk;
    return n < kChunk ? n : kChunk;
  };
  auto load_chunk = [&](int g) {  // chunk g of the stream into its stage
    const int s = g % kStages;
    const int k = g / nch;
    const int ch = g - k * nch;
    const int b = (static_cast<int>(blockIdx.x) + k * static_cast<int>(gridDim.x)) / a.tiles;
    const long long atom = static_cast<long long>(b) * a.P + static_cast<long long>(ch) * kChunk;
    const uint32_t n = static_cast<uint32_t>(chunk_atoms(ch));
    unsigned char* st = ring + s * kStageBytes;
    mbar_expect_tx(&full[s], 12 * n);
    bulk_load(st, a.points + 2 * atom, 8 * n, &full[s]);
    bulk_load(st + 8 * kChunk, a.weights + atom, 4 * n, &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int g = 0; g < kStages && g < total; ++g) load_chunk(g);
  }
  __syncthreads();  // the barriers exist before any thread waits on them

  float* sx = reinterpret_cast<float*>(smem + kWarpOff) + warp * kWarpFloats;
  float* sy = sx + 65;
  float* sw = sx + 130;
  float* f = sx + 208;  // f[q][0..15]: Ey at the sub-tile's rows, f[q][16..31]: Ex at its columns
  const unsigned lt = (1u << lane) - 1u;
  // lane's outputs: rows 2 (lane / 4) + {0, 1}, columns 4 (lane % 4) + {0..3} of the sub-tile
  const int orow = 2 * (lane >> 2);
  const int ocol = 4 * (lane & 3);
  const int wy = warp / (kTile / kSub);
  const int wx = warp - wy * (kTile / kSub);
  int buf = 0;

  for (int k = 0; k < mine; ++k) {
    const int item = static_cast<int>(blockIdx.x) + k * static_cast<int>(gridDim.x);
    const int b = item / a.tiles;
    const int t = item - b * a.tiles;
    const int row0 = (t / a.tiles_x) * kTile;
    const int col0 = (t % a.tiles_x) * kTile;
    const float c = a.inv[b];
    // This CTA's tile and this warp's sub-tile, as the rows and columns inside the image.
    const float r0 = static_cast<float>(row0);
    const float r1 = static_cast<float>((row0 + kTile < a.H ? row0 + kTile : a.H) - 1);
    const float c0 = static_cast<float>(col0);
    const float c1 = static_cast<float>((col0 + kTile < a.W ? col0 + kTile : a.W) - 1);
    const int sr0 = row0 + kSub * wy;
    const int sc0 = col0 + kSub * wx;
    const bool active = sr0 < a.H && sc0 < a.W;
    const float wr0 = static_cast<float>(sr0);
    const float wr1 = static_cast<float>((sr0 + kSub < a.H ? sr0 + kSub : a.H) - 1);
    const float wc0 = static_cast<float>(sc0);
    const float wc1 = static_cast<float>((sc0 + kSub < a.W ? sc0 + kSub : a.W) - 1);
    // lane's factor: row sr0 + lane, or column sc0 + lane - 16
    const float coord = static_cast<float>(lane < kSub ? sr0 + lane : sc0 + lane - kSub);
    const float* src = lane < kSub ? sy : sx;

    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    // Adds the first m survivors held in the warp's buffer, in order.
    auto consume = [&](int m) {
#pragma unroll 4
      for (int q = 0; q < m; ++q) {
        const float d = coord - src[q];
        float e = expf(-(d * d) * c);
        if (lane < kSub) e *= sw[q];
        f[q * 32 + lane] = e;
      }
      __syncwarp();
#pragma unroll 4
      for (int q = 0; q < m; ++q) {
        const float2 ey = *reinterpret_cast<const float2*>(f + q * 32 + orow);
        const float4 ex = *reinterpret_cast<const float4*>(f + q * 32 + kSub + ocol);
        const float av[2] = {ey.x, ey.y};
        const float vv[4] = {ex.x, ex.y, ex.z, ex.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], vv[jj], acc[i][jj]);
      }
      __syncwarp();
    };

    // Adds the list's atoms [0, count) that reach this warp's sub-tile, in
    // order: they gather in the warp's buffer and are added kBatch at a time.
    auto render = [&](int count) {
      if (!active) return;
      int held = 0;
      for (int j0 = 0; j0 < count; j0 += 32) {
        const int j = j0 + lane;
        bool keep = false;
        float x = 0.f, y = 0.f, w = 0.f;
        if (j < count) {
          x = lx[j];
          y = ly[j];
          w = lw[j];
          keep = !a.cull || reaches(x, y, w, c, wr0, wr1, wc0, wc1);
        }
        const unsigned hit = __ballot_sync(0xffffffffu, keep);
        if (keep) {
          const int q = held + __popc(hit & lt);
          sx[q] = x;
          sy[q] = y;
          sw[q] = w;
        }
        held += __popc(hit);
        while (held >= kBatch) {
          __syncwarp();
          consume(kBatch);
          held -= kBatch;  // move the rest (fewer than 32) to the front
          const bool mv = lane < held;
          if (mv) {
            x = sx[kBatch + lane];
            y = sy[kBatch + lane];
            w = sw[kBatch + lane];
          }
          __syncwarp();
          if (mv) {
            sx[lane] = x;
            sy[lane] = y;
            sw[lane] = w;
          }
        }
      }
      __syncwarp();
      if (held > 0) consume(held);
    };

    // Filter each chunk as it lands into the CTA's list, in index order: the
    // chunk's atoms j * threads + tid (j < kK) are tested, the ballot counts of
    // its (block j, warp) pairs scanned in that order, the survivors written.
    int count = 0;
    for (int ch = 0; ch < nch; ++ch) {
      const int g = k * nch + ch;
      const int s = g % kStages;
      const int n = chunk_atoms(ch);
      mbar_wait(&full[s], (g / kStages) & 1);
      const float2* sp = reinterpret_cast<const float2*>(ring + s * kStageBytes);
      const float* swt = reinterpret_cast<const float*>(ring + s * kStageBytes + 8 * kChunk);
      unsigned hit[kK];
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        const int i = j * kThreads + tid;
        bool keep = false;
        if (i < n) {
          const float2 p = sp[i];
          keep = !a.cull || reaches(p.x, p.y, swt[i], c, r0, r1, c0, c1);
        }
        hit[j] = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) cnt[buf * 32 + j * kWarps + warp] = __popc(hit[j]);
      }
      __syncthreads();
      // Every thread is done with the previous chunk's stage: refill it with
      // the chunk kStages on from it, of this item or a later one.
      if (tid == 0 && ch > 0 && g - 1 + kStages < total) load_chunk(g - 1 + kStages);
      const int v = lane < kK * kWarps ? cnt[buf * 32 + lane] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < kK * kWarps; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const int all = __shfl_sync(0xffffffffu, incl, kK * kWarps - 1);
      if (count + all > kList) {  // the list would overflow: render it, then empty it
        render(count);
        __syncthreads();
        count = 0;
      }
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        const int before = __shfl_sync(0xffffffffu, incl - v, j * kWarps + warp);
        if ((hit[j] >> lane) & 1u) {
          const int i = j * kThreads + tid;
          const int pos = count + before + __popc(hit[j] & lt);
          const float2 p = sp[i];
          lx[pos] = p.x;
          ly[pos] = p.y;
          lw[pos] = swt[i];
        }
      }
      count += all;
      buf ^= 1;
    }
    __syncthreads();
    // the item's last stage is read: refill it
    if (tid == 0 && k * nch + nch - 1 + kStages < total) load_chunk(k * nch + nch - 1 + kStages);
    render(count);

    if (active) {
      float* img = a.out + static_cast<long long>(b) * a.H * a.W;
      const int col = sc0 + ocol;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = sr0 + orow + i;
        if (r >= a.H) continue;
        float* dst = img + static_cast<long long>(r) * a.W + col;
        if ((a.W & 3) == 0 && col + 3 < a.W) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < a.W) dst[j] = acc[i][j];
        }
      }
    }
  }
}

struct Plan {
  int ctas, items, tiles_x, tiles;
};

int tiles_of(int n) { return (n + kTile - 1) / kTile; }

// The launch for one call: as many CTAs as are items (image, tile), up to as
// many as the card holds at once (or `ctas` where it is not 0), each walking
// its share of the items. Per-device state (SM count, CTAs per SM) is kept.
cudaError_t make_plan(int B, int P, int H, int W, int ctas, Plan* out) {
  if (B <= 0 || P <= 0 || H <= 0 || W <= 0 || P % 128 != 0 || ctas < 0)
    return cudaErrorInvalidValue;
  constexpr int kDevices = 64;
  static int fit_of[kDevices] = {};  // CTAs the card holds at once, once prepared
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (fit_of[dev] == 0) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(rasterize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSmem);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rasterize_kernel, kThreads,
                                                            kSmem);
      if (err != cudaSuccess) return err;
      if (per_sm == 0) return cudaErrorInvalidConfiguration;
      fit_of[dev] = per_sm * sms;
    }
  }
  Plan p;
  p.tiles_x = tiles_of(W);
  p.tiles = p.tiles_x * tiles_of(H);
  const long long items = static_cast<long long>(B) * p.tiles;
  if (items > 2147483647LL) return cudaErrorInvalidValue;
  p.items = static_cast<int>(items);
  const int most = ctas != 0 ? ctas : fit_of[dev];
  p.ctas = p.items < most ? p.items : most;
  *out = p;
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// points [B, P, 2], weights [B, P], inv [B], out [B, H, W], all f32 and
// contiguous, points and weights 16-byte aligned; P a multiple of 128. ctas
// (the grid) forces the launch plan, 0 lets make_plan choose; cull 0 renders
// every atom at every pixel (the same sums, for tests). Returns a cudaError_t.
extern "C" int rasterize_launch(const void* points, const void* weights, const void* inv,
                                void* out, int B, int P, int H, int W, int ctas, int cull,
                                void* stream) {
  if (!aligned16(points) || !aligned16(weights)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = make_plan(B, P, H, W, ctas, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const float*>(points), static_cast<const float*>(weights),
               static_cast<const float*>(inv), static_cast<float*>(out), P, H, W, p.tiles_x,
               p.tiles, p.items, cull != 0};
  rasterize_kernel<<<dim3(static_cast<unsigned>(p.ctas)), dim3(kThreads), kSmem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The plan a call of this shape gets: out[0..7] = tile edge, threads per CTA,
// atoms per ring stage, ring stages, list capacity, dynamic shared memory
// bytes, CTAs, items (image, tile). Returns a cudaError_t.
extern "C" int rasterize_plan(int B, int P, int H, int W, int ctas, int* out) {
  Plan p{};
  const cudaError_t err = make_plan(B, P, H, W, ctas, &p);
  const int v[8] = {kTile, kThreads, kChunk, kStages, kList, kSmem, p.ctas, p.items};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return static_cast<int>(err);
}

extern "C" const char* rasterize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
