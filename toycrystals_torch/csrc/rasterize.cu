// Gaussian-atom rasterizer for Hopper: images as a sum of separable Gaussians.
//
// Replaces the Pallas TPU kernel `_raster_kernel` / `rasterize_pallas` in
// toycrystals_tpu/data/rasterize.py. Per image b, with inv = 1 / (2 sigma_b^2):
//
//   Ey[h, p] = w_p * exp(-(h - y_p)^2 * inv)      Ex[w, p] = exp(-(w - x_p)^2 * inv)
//   out[h, w] = sum_p Ey[h, p] * Ex[w, p]          (f32 throughout)
//
// Atoms with weight 0 (padding, vacancies, cropped points) contribute exactly
// 0: their Ey column is 0 * exp(...) with exp(...) finite.
//
// Bound: operations. One image costs 2*H*W*P flops and P*(H+W) exponentials
// against 4*(3P + H*W) bytes, ~440 flop/byte at 64x64 with P = 2432, far above
// what plain f32 needs to hide device memory. So the design spends nothing on
// memory: the two factors never exist in device memory. One block owns one
// 64x64 output tile of one image and walks P in chunks of 64 atoms; for each
// chunk its 256 threads fill a [64 atoms][64 rows] slab of Ey and a
// [64 atoms][64 cols] slab of Ex in shared memory with expf (32 KB in all),
// then every thread accumulates a 4x4 register tile with f32 FMAs, reading
// its 4 Ey and 4 Ex values per atom as two 16-byte shared loads (16 FMAs per
// 2 loads). Plain f32 FMAs, no TF32 and no tensor cores, so the result agrees
// with the plain version to f32 rounding. A tile that hangs over the image
// edge computes the full tile and masks its stores.
//
// Plain C interface, built with nvcc and loaded through ctypes
// (toycrystals_torch/data/rasterize.py). The launch goes on the caller's
// stream; the function returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kChunk = 64;     // atoms per shared-memory slab
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
rasterize_kernel(const float* __restrict__ points,   // [B, P, 2] (x, y)
                 const float* __restrict__ weights,  // [B, P]
                 const float* __restrict__ inv,      // [B]  1 / (2 sigma^2)
                 float* __restrict__ out,            // [B, H, W]
                 int P, int H, int W, int tiles_x, int tiles_y) {
  __shared__ __align__(16) float ey_s[kChunk][kTile];
  __shared__ __align__(16) float ex_s[kChunk][kTile];
  __shared__ float px_s[kChunk];
  __shared__ float py_s[kChunk];
  __shared__ float w_s[kChunk];

  const int tiles = tiles_x * tiles_y;
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x - b * tiles;
  const int row0 = (t / tiles_x) * kTile;
  const int col0 = (t % tiles_x) * kTile;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // 0..15: rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 15;  // 0..15: cols tx*4 .. tx*4+3 of the tile

  const float c = inv[b];
  const float* __restrict__ pts = points + static_cast<long long>(b) * P * 2;
  const float* __restrict__ wts = weights + static_cast<long long>(b) * P;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int p0 = 0; p0 < P; p0 += kChunk) {
    if (tid < kChunk) {
      const float2 xy = reinterpret_cast<const float2*>(pts)[p0 + tid];
      px_s[tid] = xy.x;
      py_s[tid] = xy.y;
      w_s[tid] = wts[p0 + tid];
    }
    __syncthreads();
    // Each slab entry [k][r]: atom k of the chunk, row (or column) r of the tile.
    for (int e = tid; e < kChunk * kTile; e += kThreads) {
      const int k = e >> 6;
      const int r = e & (kTile - 1);
      const float dy = static_cast<float>(row0 + r) - py_s[k];
      const float dx = static_cast<float>(col0 + r) - px_s[k];
      ey_s[k][r] = expf(-(dy * dy) * c) * w_s[k];
      ex_s[k][r] = expf(-(dx * dx) * c);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&ey_s[k][ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&ex_s[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* __restrict__ img = out + static_cast<long long>(b) * H * W;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < W) img[static_cast<long long>(r) * W + col] = acc[i][j];
    }
  }
}

}  // namespace

// points [B, P, 2], weights [B, P], inv [B], out [B, H, W], all f32 and
// contiguous; P a multiple of 64. Returns a cudaError_t.
extern "C" int rasterize_launch(const void* points, const void* weights, const void* inv,
                                void* out, int B, int P, int H, int W, void* stream) {
  if (B <= 0 || P <= 0 || H <= 0 || W <= 0 || P % kChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(B) * tiles_x * tiles_y;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  rasterize_kernel<<<dim3(static_cast<unsigned>(blocks)), dim3(kThreads), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(weights),
      static_cast<const float*>(inv), static_cast<float*>(out), P, H, W, tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rasterize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
