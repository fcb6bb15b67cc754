// Fused GroupNorm + SiLU (+ 1-pixel circular halo) for NCHW tensors on Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` / `_gn_silu_pallas` in
// toycrystals_tpu/ops/groupnorm.py. Per (item, group) it takes the f32 mean
// and the fast variance E[x^2] - E[x]^2 clipped at 0, normalises with
// rsqrt(var + eps), applies the per-channel scale and bias and SiLU, and
// stores in x's type. With pad = 1 it writes the [H+2, W+2] plane whose
// border is the circular wrap of the interior, so the next conv runs VALID.
//
// Bound: bytes. The op does ~10 flops per element and must move one read of
// x and one write of the output (each at 2 bytes in bf16), far below the
// card's ~295 flop/byte balance point. One block owns one (item, group): in
// NCHW that is one contiguous run of C/G * H * W elements, so pass 1 streams
// it with 16-byte loads and pass 2 writes one contiguous run of
// C/G * (H+2p) * (W+2p) outputs, neighbouring threads on neighbouring
// addresses. Pass 2 reads x a second time; at the main path's shapes a
// block's slab (<= 192 KB) was read moments before and is mostly still in
// L2, so device memory sees close to 1 read + 1 write. Keeping the slab in
// shared memory instead is left to a later change.
//
// This is the forward. Under autograd the wrapper launches it inside a
// torch.autograd.Function whose backward differentiates the plain PyTorch
// version at the saved inputs; there is no backward kernel here yet.
//
// Plain C interface, built with nvcc and loaded through ctypes
// (toycrystals_torch/ops/groupnorm.py). The launch goes on the caller's
// stream; the function returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One wrapped source index for output index o of a padded (or unpadded) axis.
__device__ __forceinline__ int wrap(int o, int pad, int n) {
  int s = o - pad;
  if (s < 0) s += n;
  if (s >= n) s -= n;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_silu_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out, int C, int H,
               int W, int groups, float eps, int pad) {
  const int cg = C / groups;
  const int g = blockIdx.x % groups;
  const int b = blockIdx.x / groups;
  const int hw = H * W;
  const int n = cg * hw;
  const int ho = H + 2 * pad;
  const int wo = W + 2 * pad;
  const int plane = ho * wo;
  const long long first_ch = static_cast<long long>(b) * C + static_cast<long long>(g) * cg;
  const T* __restrict__ xg = x + first_ch * hw;
  T* __restrict__ og = out + first_ch * plane;

  // Pass 1: sum and sum of squares in f32.
  float s1 = 0.f, s2 = 0.f;
  constexpr int kVec = 16 / sizeof(T);
  if (reinterpret_cast<uintptr_t>(xg) % 16 == 0 && n % kVec == 0) {
    const uint4* xv = reinterpret_cast<const uint4*>(xg);
    const int nv = n / kVec;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      uint4 u = __ldg(xv + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float v = to_f32(e[k]);
        s1 += v;
        s2 += v * v;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float v = to_f32(xg[i]);
      s1 += v;
      s2 += v * v;
    }
  }

  __shared__ float red1[kThreads / 32];
  __shared__ float red2[kThreads / 32];
  __shared__ float stats[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red1[warp] = s1;
    red2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    s1 = lane < n_warps ? red1[lane] : 0.f;
    s2 = lane < n_warps ? red2[lane] : 0.f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float mean = s1 / static_cast<float>(n);
      const float var = fmaxf(s2 / static_cast<float>(n) - mean * mean, 0.f);
      stats[0] = mean;
      stats[1] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  const float mean = stats[0];
  const float inv = stats[1];

  // Pass 2: walk the output positions; each reads its wrapped source.
  const int total = cg * plane;
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    const int c = o / plane;
    const int r = o - c * plane;
    const int i = r / wo;
    const int j = r - i * wo;
    const int si = wrap(i, pad, H);
    const int sj = wrap(j, pad, W);
    const int ch = g * cg + c;
    float y = (to_f32(xg[c * hw + si * W + sj]) - mean) * inv;
    y = y * scale[ch] + bias[ch];
    y = y / (1.f + expf(-y));
    og[o] = from_f32<T>(y);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. pad: 0 or 1. Returns a cudaError_t.
extern "C" int gn_silu_launch(const void* x, const void* scale, const void* bias,
                              void* out, int B, int C, int H, int W, int groups,
                              float eps, int pad, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || groups <= 0 || C % groups != 0 ||
      (pad != 0 && pad != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(groups));
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 0) {
    gn_silu_kernel<float><<<grid, block, 0, s>>>(static_cast<const float*>(x), sc, bi,
                                                 static_cast<float*>(out), C, H, W,
                                                 groups, eps, pad);
  } else if (dtype == 1) {
    gn_silu_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), sc, bi, static_cast<__nv_bfloat16*>(out), C,
        H, W, groups, eps, pad);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gn_silu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
