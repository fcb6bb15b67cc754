// Fused GroupNorm + SiLU (+ 1-pixel circular halo) for NCHW tensors on Hopper,
// forward and backward.
//
// Replaces the Pallas TPU kernel `_kernel` / `_gn_silu_pallas` in
// toycrystals_tpu/ops/groupnorm.py and the backward of its custom VJP (the VJP
// of `_ref_full`). Per (item, group) the forward takes the f32 mean and the
// fast variance E[x^2] - E[x]^2 clipped at 0, normalises with
// rsqrt(var + eps), applies the per-channel scale and bias and SiLU, and
// stores in x's type. With pad = 1 it writes the [H+2, W+2] plane whose
// border is the circular wrap of the interior, so the next conv runs VALID.
//
// Bound: bytes. The op does ~10 flops per element; the forward must move one
// read of x and one write of the output, the backward one read of x and of
// the upstream gradient and one write of dx, far below the card's ~295
// flop/byte balance point. The design keeps every byte read once:
//
// - A group is split by input rows across a thread-block cluster of k CTAs
//   (k = 1..16, chosen per shape by the launcher so that a CTA's rows fit
//   about half an SM's shared memory, two CTAs per SM, or else a whole SM).
//   Each CTA copies its rows into shared memory with 16-byte cp.async, reduces
//   them, and the CTAs add the k partial sums through distributed shared
//   memory, every CTA in the same rank order, so all hold the same mean and
//   inv and a result repeats bit for bit.
// - The forward's write pass walks a contiguous range of output rows (the
//   halo rows beside the interior rows they copy), with a per-channel
//   a_c = inv * scale_c and b_c = bias_c - mean * a_c. A table in shared memory
//   gives each output row its source row and coefficients, built once per row,
//   so a pair of outputs costs one multiply-high division and one table read
//   beyond its arithmetic: index work, not bytes, is what limits this pass. A
//   halo row whose source row lies in another CTA of the cluster is read from
//   that CTA's shared memory.
// - The backward keeps its rows of x and the padded gradient rows that fold
//   onto them in shared memory, with a table of its rows (x row, gradient
//   rows, channel, scale, bias), and folds the halo while it reads. Pass A sums
//   dz and dz * xhat per channel (a warp per row, or per several rows narrower
//   than 32; running sums reduced across the warp when the channel changes);
//   the CTAs exchange those sums across the cluster (no atomics); pass B writes
//   dx a pair of elements per lane, as the forward does. The per-(item,
//   channel) sums go to a [B, C, 2] scratch that the caller sums over B into
//   dbias and dscale.
// - A slab too large for 16 CTAs' shared memory takes the same kernels in a
//   mode that reads its rows from global memory a second time.
//
// The forward also writes (mean, inv, clipped) per (item, group) to `stats`
// when the pointer is not null; the backward reads them instead of reducing x
// again. clipped = 1 where E[x^2] - E[x]^2 < 0, and then the variance path
// carries no gradient (as torch's clamp does; at exactly 0 it passes).
//
// Under a space axis (an image split by rows over several ranks) a group's
// statistics span the ranks, so the op runs as two kernels with an all-reduce
// between them, both plain one-pass grids with no clusters:
//
// - gn_silu_sums_kernel: k blocks per (item, group) each sum a contiguous
//   share of the group's elements (x and x^2, f32) and write their partials;
//   the caller adds the k partials in block order and the ranks' sums.
// - gn_silu_apply_kernel: normalises with the given sums exactly as the
//   forward forms its statistics (mean = S1 / n, var = S2 / n - mean^2
//   clipped at 0, a_c = inv * scale_c, b_c = bias_c - mean * a_c), applies
//   SiLU, and with pad = 1 writes the [H+2, W+2] plane wrapped over the rank's
//   own rows; the caller replaces the two H halo rows by its neighbours'.
//
// Both are bound by bytes: the sums kernel reads x once, the apply kernel
// reads x once and writes the output once.
//
// Training under a space axis cuts the backward at the same place, into two
// more plain grids with an all-reduce between them (the caller first returns
// the padded gradient's two H halo rows to the ranks that own them, the
// `edge` rows below):
//
// - gn_silu_bwd_sums_kernel: k blocks per (item, channel), each over a share
//   of the channel's rows, sum dz and dz * xhat (f32) over the rank's rows,
//   where dz = g * SiLU'(z) is the upstream gradient folded over the W halo
//   (and the edge rows) at z = xhat * scale_c + bias_c; the caller adds the
//   k partials in block order into the per-(item, channel) sums (dbias and
//   dscale once added over the batch), weights them by scale_c into the
//   group's sums of dxhat and dxhat * xhat, and adds those over the ranks.
// - gn_silu_bwd_apply_kernel: dx = inv * (dz * scale_c - m1 - xhat * m2) with
//   m1, m2 the group's sums over its whole count (m2 = 0 where the variance
//   was clipped), as gn_silu_bwd_kernel's pass B.
//
// A warp takes a row, each lane 16 bytes of x (and of an unpadded gradient,
// and of dx) at a time; the padded gradient's rows start one element in, so
// a lane reads them an element at a time. The sums kernel reads x and the
// gradient once; the apply kernel reads both again and writes dx once: bound
// by bytes, like the rest.
//
// Plain C interface, built with nvcc and loaded through ctypes
// (toycrystals_torch/ops/groupnorm.py). Launches go on the caller's stream;
// each entry returns cudaGetLastError() of its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr size_t kTwoPerSm = 112 * 1024;  // dynamic shared memory for two CTAs per SM
constexpr size_t kOnePerSm = 226 * 1024;  // for one CTA per SM (opt-in limit is 227 KB)

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (d >= 1).
struct FastDiv {
  unsigned d, mul, shr;
};

FastDiv make_div(unsigned d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    unsigned l = 0;
    while ((1u << l) < d) ++l;
    const unsigned p = 31 + l;
    f.mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
    f.shr = p - 32;
  }
  return f;
}

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  return f.d == 1 ? n
                  : static_cast<int>(__umulhi(static_cast<unsigned>(n), f.mul) >> f.shr);
}

struct Dims {
  int C, H, W, groups, pad, cg, ho, wo;
  int rows;     // cg * H: input rows of one group
  int k;        // CTAs per group: the cluster
  int R;        // input rows per CTA
  int nseg;     // most channels one CTA's rows touch (backward)
  int in_smem;  // 1: a CTA keeps its rows in shared memory; 0: it reads them twice
  float eps;
  FastDiv dW, dH, dho, dwo, dR;
};

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

// The wrapped source index of index o of a padded (or unpadded) axis of size n.
__device__ __forceinline__ int wrap(int o, int pad, int n) {
  int s = o - pad;
  if (s < 0) s += n;
  if (s >= n) s -= n;
  return s;
}

// 1 / (1 + e^-z) with the fast reciprocal: 0 once e^-z passes 2^126, where z * 0
// stays within f32 rounding of SiLU's true value.
__device__ __forceinline__ float sigmoid(float z) { return __fdividef(1.f, 1.f + __expf(-z)); }

__host__ __device__ __forceinline__ size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

// Copies `count` elements from global `src` into shared memory at `buf` (16-byte
// aligned, count * sizeof(T) + 16 bytes long), placed at src's offset modulo 16
// so that all but the ends move as 16-byte cp.async. Returns where element 0
// landed. The caller waits (cp_async_wait_all) and synchronises.
template <typename T>
__device__ T* stage(unsigned char* buf, const T* src, int count) {
  constexpr int V = 16 / sizeof(T);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  T* dst = reinterpret_cast<T*>(buf + mis);
  const int head = mis ? min(count, (16 - mis) / static_cast<int>(sizeof(T))) : 0;
  const int nv = (count - head) / V;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + head + v * V));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + head + v * V)
                 : "memory");
  }
  for (int i = head + nv * V + threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  return dst;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Sum and sum of squares of p[0, count) in f32 (p in shared or global memory).
template <typename T>
__device__ void sum_sq(const T* p, int count, float& s1, float& s2) {
  constexpr int V = 16 / sizeof(T);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  const int head = mis ? min(count, (16 - mis) / static_cast<int>(sizeof(T))) : 0;
  const int nv = (count - head) / V;
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
#pragma unroll 4
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const uint4 u = pv[v];
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float f = to_f32(e[k]);
      s1 += f;
      s2 += f * f;
    }
  }
  for (int i = threadIdx.x; i < head; i += blockDim.x) {
    const float f = to_f32(p[i]);
    s1 += f;
    s2 += f * f;
  }
  for (int i = head + nv * V + threadIdx.x; i < count; i += blockDim.x) {
    const float f = to_f32(p[i]);
    s1 += f;
    s2 += f * f;
  }
}

// Block sum of (a, b) in a fixed order; the result is valid in thread 0.
__device__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    a = lane < nw ? red[lane] : 0.f;
    b = lane < nw ? red[32 + lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

// First output row (within the group) that the CTA whose rows start at input
// row `ir` writes: the CTA owns the output rows whose interior rows it holds,
// and the top halo row of a channel whose row 0 it holds.
__host__ __device__ __forceinline__ int first_out_row(int ir, int rows, int H, int ho, int pad,
                                                      int cg) {
  if (ir >= rows) return cg * ho;
  const int c = ir / H;
  const int i = ir - c * H;
  return c * ho + (i == 0 ? 0 : i + pad);
}

// Where one output row's values come from: its source row of x (in this CTA's
// shared memory, another CTA's, or global memory) and its channel's a_c, b_c.
template <typename T>
struct alignas(16) RowSrc {
  const T* src;
  float a, b;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
gn_silu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out,
                   float* __restrict__ stats, Dims d) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float red[64];
  __shared__ float partial[2];
  __shared__ float stat[2];
  __shared__ const T* slab[kMaxCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int grp = blockIdx.x / d.k;
  const int g = grp % d.groups;
  const long long first_ch = static_cast<long long>(grp / d.groups) * d.C +
                             static_cast<long long>(g) * d.cg;
  const int hw = d.H * d.W;
  const T* xg = x + first_ch * hw;
  T* og = out + first_ch * d.ho * d.wo;
  const int r0 = min(rank * d.R, d.rows), r1 = min(r0 + d.R, d.rows);
  const int count = (r1 - r0) * d.W;
  float* coef = reinterpret_cast<float*>(dyn);  // a_c [cg], then b_c [cg]
  unsigned char* buf = dyn + align16(2 * d.cg * sizeof(float));

  // Pass 1: this CTA's rows (into shared memory), their sum and sum of squares.
  const T* xs = xg + static_cast<long long>(r0) * d.W;
  if (d.in_smem) {
    xs = stage(buf, xs, count);
    cp_async_wait_all();
    __syncthreads();
  }
  float s1 = 0.f, s2 = 0.f;
  sum_sq(xs, count, s1, s2);
  block_sum2(s1, s2, red);
  if (threadIdx.x == 0) {
    partial[0] = s1;
    partial[1] = s2;
  }
  if (d.in_smem && threadIdx.x < d.k) {
    const int t = threadIdx.x;
    const T* src = xg + static_cast<long long>(min(t * d.R, d.rows)) * d.W;
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
    slab[t] = t == rank ? xs
                        : reinterpret_cast<const T*>(cluster.map_shared_rank(buf, t) + mis);
  }
  cluster.sync();

  // The group's statistics: the k partials in rank order, the same in every CTA.
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < d.k; ++r) {
      const float* p = cluster.map_shared_rank(partial, r);
      t1 += p[0];
      t2 += p[1];
    }
    const float n = static_cast<float>(d.cg * hw);
    const float mean = t1 / n;
    const float var = t2 / n - mean * mean;
    const float inv = rsqrtf(fmaxf(var, 0.f) + d.eps);
    stat[0] = mean;
    stat[1] = inv;
    if (stats != nullptr && rank == 0) {
      stats[3 * grp] = mean;
      stats[3 * grp + 1] = inv;
      stats[3 * grp + 2] = var < 0.f ? 1.f : 0.f;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d.cg; c += blockDim.x) {
    const float a = stat[1] * scale[g * d.cg + c];
    coef[c] = a;
    coef[d.cg + c] = bias[g * d.cg + c] - stat[0] * a;
  }
  if (!d.in_smem) cluster.sync();  // no CTA leaves while another reads its partial
  __syncthreads();

  // Pass 2: the output rows this CTA owns, one contiguous range. A table gives
  // each row its source row and coefficients; then neighbouring lanes take
  // neighbouring pairs of outputs (one store of two elements where the padded
  // width is even), a multiply-high division and one table read per pair.
  const int or_lo = first_out_row(r0, d.rows, d.H, d.ho, d.pad, d.cg);
  const int or_hi = first_out_row(r1, d.rows, d.H, d.ho, d.pad, d.cg);
  RowSrc<T>* table = reinterpret_cast<RowSrc<T>*>(
      buf + (d.in_smem ? align16(static_cast<size_t>(d.R) * d.W * sizeof(T) + 16) : 0));
  for (int t = threadIdx.x; t < or_hi - or_lo; t += blockDim.x) {
    const int orow = or_lo + t;
    const int c = fdiv(orow, d.dho);
    const int irow = c * d.H + wrap(orow - c * d.ho, d.pad, d.H);
    RowSrc<T> e;
    if (d.in_smem) {
      const int rk = fdiv(irow, d.dR);
      e.src = slab[rk] + (irow - rk * d.R) * d.W;
    } else {
      e.src = xg + static_cast<long long>(irow) * d.W;
    }
    e.a = coef[c];
    e.b = coef[d.cg + c];
    table[t] = e;
  }
  __syncthreads();
  T* ob = og + static_cast<long long>(or_lo) * d.wo;
  const int n_out = (or_hi - or_lo) * d.wo;
  auto value = [&](const RowSrc<T>& rs, int col) -> T {
    const float y = to_f32(rs.src[wrap(col, d.pad, d.W)]) * rs.a + rs.b;
    return from_f32<T>(y * sigmoid(y));
  };
  if (d.wo % 2 == 0 && reinterpret_cast<uintptr_t>(ob) % (2 * sizeof(T)) == 0) {
    using Pair = typename std::conditional<sizeof(T) == 2, unsigned, uint2>::type;
#pragma unroll 4
    for (int q = threadIdx.x; q < n_out / 2; q += blockDim.x) {
      const int r = fdiv(2 * q, d.dwo);
      const int col = 2 * q - r * d.wo;
      const RowSrc<T> rs = table[r];
      alignas(2 * sizeof(T)) T v[2] = {value(rs, col), value(rs, col + 1)};
      reinterpret_cast<Pair*>(ob)[q] = *reinterpret_cast<const Pair*>(v);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < n_out; e += blockDim.x) {
      const int r = fdiv(e, d.dwo);
      ob[e] = value(table[r], e - r * d.wo);
    }
  }
  if (d.in_smem) cluster.sync();  // no CTA leaves while another reads its rows
}

// Where one CTA's rows of the padded gradient lie: rows [os, oe) of the group's
// [cg * ho] padded rows, plus the top halo row of channel c0 and the bottom halo
// row of channel c1 where the CTA needs them and they fall outside that range.
struct GradRows {
  int c0, c1, os, oe, top, bot;
};

__host__ __device__ __forceinline__ GradRows grad_rows(int r0, int r1, int H, int ho,
                                                       int pad) {
  GradRows s{0, -1, 0, 0, 0, 0};
  if (r1 <= r0) return s;
  s.c0 = r0 / H;
  s.c1 = (r1 - 1) / H;
  const int a0 = r0 - s.c0 * H, b1 = r1 - 1 - s.c1 * H;
  s.os = s.c0 * ho + (a0 == 0 ? 0 : a0 + pad);
  s.oe = s.c1 * ho + (b1 == H - 1 ? ho : b1 + pad + 1);
  s.top = pad && a0 > 0 && (s.c1 > s.c0 || b1 == H - 1);
  s.bot = pad && b1 < H - 1 && (s.c1 > s.c0 || a0 == 0);
  return s;
}

// One input row of a backward CTA: its x row, the padded gradient row that
// holds its interior, the halo rows that also fold onto it (or null), its
// channel within the group and that channel's scale and bias.
template <typename T>
struct alignas(16) BwdRow {
  const T *x, *g, *gt, *gb;
  float sc, bc;
  int c;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
gn_silu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gout,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const float* __restrict__ stats, T* __restrict__ dx,
                   float* __restrict__ chan, Dims d) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float mstat[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int grp = blockIdx.x / d.k;
  const int g = grp % d.groups;
  const long long first_ch = static_cast<long long>(grp / d.groups) * d.C +
                             static_cast<long long>(g) * d.cg;
  const int hw = d.H * d.W;
  const T* xg = x + first_ch * hw;
  const T* gg = gout + first_ch * d.ho * d.wo;
  const int r0 = min(rank * d.R, d.rows), r1 = min(r0 + d.R, d.rows);
  const int count = (r1 - r0) * d.W;
  const float mean = stats[3 * grp], inv = stats[3 * grp + 1];
  const bool clipped = stats[3 * grp + 2] != 0.f;
  const int nwarps = blockDim.x >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float* part = reinterpret_cast<float*>(dyn);  // [cg][2]: this CTA's (sum dz, sum dz xhat)
  float* tot = part + 2 * d.cg;                 // [cg][2]: the group's
  float* wred = tot + 2 * d.cg;                 // [nseg][nwarps][2]
  unsigned char* buf = dyn + align16((4 * d.cg + 2 * d.nseg * nwarps) * sizeof(float));
  for (int t = threadIdx.x; t < 2 * d.cg; t += blockDim.x) part[t] = 0.f;

  GradRows gr = grad_rows(r0, r1, d.H, d.ho, d.pad);
  const T* xs = xg + static_cast<long long>(r0) * d.W;
  const T* gs = gg;
  const T* gtop = nullptr;
  const T* gbot = nullptr;
  if (d.in_smem) {
    xs = stage(buf, xs, count);
    buf += align16(count * sizeof(T) + 16);
    const int gcount = (gr.oe - gr.os) * d.wo;
    gs = stage(buf, gg + static_cast<long long>(gr.os) * d.wo, gcount);
    buf += align16(gcount * sizeof(T) + 16);
    if (gr.top) {
      gtop = stage(buf, gg + static_cast<long long>(gr.c0) * d.ho * d.wo, d.wo);
      buf += align16(d.wo * sizeof(T) + 16);
    }
    if (gr.bot) {
      gbot = stage(buf, gg + static_cast<long long>(gr.c1 * d.ho + d.ho - 1) * d.wo, d.wo);
      buf += align16(d.wo * sizeof(T) + 16);
    }
    cp_async_wait_all();
    __syncthreads();
  } else {
    gr.os = 0;
    gr.top = gr.bot = 0;
  }

  // The padded gradient row r of channel c (within the group).
  auto grow = [&](int c, int r) -> const T* {
    if (gr.top && c == gr.c0 && r == 0) return gtop;
    if (gr.bot && c == gr.c1 && r == d.ho - 1) return gbot;
    return gs + (c * d.ho + r - gr.os) * d.wo;
  };
  // The table of this CTA's rows, built once and read by both passes.
  BwdRow<T>* rows_t = reinterpret_cast<BwdRow<T>*>(buf);
  for (int lrow = threadIdx.x; lrow < r1 - r0; lrow += blockDim.x) {
    BwdRow<T> r;
    const int irow = r0 + lrow;
    r.c = fdiv(irow, d.dH);
    const int i = irow - r.c * d.H;
    r.x = xs + lrow * d.W;
    r.g = grow(r.c, i + d.pad);
    r.gt = d.pad && i == d.H - 1 ? grow(r.c, 0) : nullptr;
    r.gb = d.pad && i == 0 ? grow(r.c, d.H + 1) : nullptr;
    r.sc = scale[g * d.cg + r.c];
    r.bc = bias[g * d.cg + r.c];
    rows_t[lrow] = r;
  }
  // The upstream gradient at column j folded over every padded position that
  // copies it, times SiLU' at z = xhat * scale_c + bias_c.
  auto fold = [&](const T* row, int j) -> float {
    float v = to_f32(row[j + d.pad]);
    if (d.pad) {
      if (j == d.W - 1) v += to_f32(row[0]);
      if (j == 0) v += to_f32(row[d.W + 1]);
    }
    return v;
  };
  auto dz_at = [&](const BwdRow<T>& r, int j, float xhat) -> float {
    float gi = fold(r.g, j);
    if (r.gt != nullptr) gi += fold(r.gt, j);
    if (r.gb != nullptr) gi += fold(r.gb, j);
    const float z = xhat * r.sc + r.bc;
    const float s = sigmoid(z);
    return gi * s * (1.f + z * (1.f - s));
  };
  // Work in row tasks: a warp takes rt consecutive rows, each on wp lanes (the
  // power of two >= W, at most 32), a lane every wp-th column.
  const int wp = d.W >= 32 ? 32 : 1 << (32 - __clz(d.W - 1));
  const int rt = 32 / wp;
  const int sub = lane / wp, j0 = lane % wp;
  const int nr = r1 - r0;
  const int ntasks = (nr + rt - 1) / rt;

  // Pass A: per channel, sum dz and dz * xhat over this CTA's rows. A lane
  // keeps running sums over its rows and the warp reduces them only when a
  // row's channel differs from the last, adding each row group's sums in order
  // into the warp's slot of wred.
  for (int t = threadIdx.x; t < 2 * d.nseg * nwarps; t += blockDim.x) wred[t] = 0.f;
  __syncthreads();
  float sdz = 0.f, sdzx = 0.f;
  int seg = -1;  // the channel (minus c0) that this lane's sums belong to
  auto flush = [&]() {
    float a = sdz, b = sdzx;
    for (int off = wp >> 1; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    for (int q = 0; q < rt; ++q) {
      const float qa = __shfl_sync(0xffffffffu, a, q * wp);
      const float qb = __shfl_sync(0xffffffffu, b, q * wp);
      const int sg = __shfl_sync(0xffffffffu, seg, q * wp);
      if (lane == 0 && sg >= 0) {
        wred[2 * (sg * nwarps + warp)] += qa;
        wred[2 * (sg * nwarps + warp) + 1] += qb;
      }
    }
    sdz = sdzx = 0.f;
  };
  for (int t = warp; t < ntasks; t += nwarps) {
    const int lrow = t * rt + sub;
    const int row_seg = lrow < nr ? rows_t[lrow].c - gr.c0 : seg;
    if (__any_sync(0xffffffffu, seg >= 0 && row_seg != seg)) flush();
    seg = row_seg;
    if (lrow < nr) {
      const BwdRow<T> r = rows_t[lrow];
#pragma unroll 4
      for (int j = j0; j < d.W; j += wp) {
        const float xhat = (to_f32(r.x[j]) - mean) * inv;
        const float dz = dz_at(r, j, xhat);
        sdz += dz;
        sdzx += dz * xhat;
      }
    }
  }
  flush();
  __syncthreads();
  for (int t = threadIdx.x; t <= gr.c1 - gr.c0; t += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      a += wred[2 * (t * nwarps + w)];
      b += wred[2 * (t * nwarps + w) + 1];
    }
    part[2 * (gr.c0 + t)] = a;
    part[2 * (gr.c0 + t) + 1] = b;
  }
  cluster.sync();
  // The group's per-channel sums: the k CTAs' in rank order, the same in every CTA.
  for (int t = threadIdx.x; t < d.cg; t += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < d.k; ++r) {
      const float* p = cluster.map_shared_rank(part, r);
      a += p[2 * t];
      b += p[2 * t + 1];
    }
    tot[2 * t] = a;
    tot[2 * t + 1] = b;
    if (rank == 0) {
      chan[2 * (first_ch + t)] = a;
      chan[2 * (first_ch + t) + 1] = b;
    }
  }
  cluster.sync();  // every CTA has read the others' sums; tot is visible block-wide
  if (threadIdx.x == 0) {
    float m1 = 0.f, m2 = 0.f;
    for (int c = 0; c < d.cg; ++c) {
      const float sc = scale[g * d.cg + c];
      m1 += sc * tot[2 * c];
      m2 += sc * tot[2 * c + 1];
    }
    const float n = static_cast<float>(d.cg * hw);
    mstat[0] = m1 / n;
    mstat[1] = clipped ? 0.f : m2 / n;
  }
  __syncthreads();
  const float m1 = mstat[0], m2 = mstat[1];

  // Pass B: dx = inv * (dz * scale_c - m1 - xhat * m2) over this CTA's rows,
  // neighbouring lanes on neighbouring pairs of elements (one store each where
  // W is even), a multiply-high division and one table read per pair.
  T* dxs = dx + first_ch * hw + static_cast<long long>(r0) * d.W;
  auto dx_at = [&](const BwdRow<T>& r, int j) -> T {
    const float xhat = (to_f32(r.x[j]) - mean) * inv;
    return from_f32<T>(inv * (dz_at(r, j, xhat) * r.sc - m1 - xhat * m2));
  };
  if (d.W % 2 == 0 && reinterpret_cast<uintptr_t>(dxs) % (2 * sizeof(T)) == 0) {
    using Pair = typename std::conditional<sizeof(T) == 2, unsigned, uint2>::type;
#pragma unroll 4
    for (int q = threadIdx.x; q < count / 2; q += blockDim.x) {
      const int lrow = fdiv(2 * q, d.dW);
      const int j = 2 * q - lrow * d.W;
      const BwdRow<T> r = rows_t[lrow];
      alignas(2 * sizeof(T)) T v[2] = {dx_at(r, j), dx_at(r, j + 1)};
      reinterpret_cast<Pair*>(dxs)[q] = *reinterpret_cast<const Pair*>(v);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < count; e += blockDim.x) {
      const int lrow = fdiv(e, d.dW);
      dxs[e] = dx_at(rows_t[lrow], e - lrow * d.W);
    }
  }
}

// ---------------------------------------------------------------- launch plans

struct Plan {
  int k, threads, in_smem, nseg;
  size_t smem;
};

// Threads per CTA: 1,024 where one CTA holds an SM, else by the CTA's rows.
int threads_for(long long elems, bool whole_sm) {
  return whole_sm ? kMaxThreads : elems >= 16384 ? 512 : elems >= 4096 ? 256 : 128;
}

// Dynamic shared memory of one CTA (the largest over the cluster's ranks).
size_t smem_bytes(bool backward, const Dims& d, int k, int threads, int elt, bool in_smem,
                  int* nseg) {
  const int R = (d.rows + k - 1) / k;
  size_t most = 0;
  int seg = 1;
  for (int r = 0; r < k; ++r) {
    const int r0 = r * R < d.rows ? r * R : d.rows;
    const int r1 = r0 + R < d.rows ? r0 + R : d.rows;
    const GradRows s = grad_rows(r0, r1, d.H, d.ho, d.pad);
    if (s.c1 - s.c0 + 1 > seg) seg = s.c1 - s.c0 + 1;
    size_t b = 0;
    if (in_smem) {
      b += align16(static_cast<size_t>(r1 - r0) * d.W * elt + 16);
      if (backward) {
        b += align16(static_cast<size_t>(s.oe - s.os) * d.wo * elt + 16);
        b += (s.top + s.bot) * align16(static_cast<size_t>(d.wo) * elt + 16);
      }
    }
    if (b > most) most = b;
  }
  *nseg = seg;
  if (backward)  // sums, then the rows, then the table of rows (48 bytes each)
    return align16((4 * d.cg + 2 * seg * (threads / 32)) * sizeof(float)) + most +
           static_cast<size_t>(R) * 48;
  // forward: coefficients, the rows, and the table of output rows (16 bytes each)
  int out_rows = 0;
  for (int r = 0; r < k; ++r) {
    const int r0 = r * R < d.rows ? r * R : d.rows;
    const int r1 = r0 + R < d.rows ? r0 + R : d.rows;
    const int n = first_out_row(r1, d.rows, d.H, d.ho, d.pad, d.cg) -
                  first_out_row(r0, d.rows, d.H, d.ho, d.pad, d.cg);
    if (n > out_rows) out_rows = n;
  }
  const size_t slab = in_smem ? align16(static_cast<size_t>(R) * d.W * elt + 16) : 0;
  return align16(2 * d.cg * sizeof(float)) + slab + static_cast<size_t>(out_rows) * 16;
}

// Whether one cluster of this shape fits on the card.
bool can_launch(const void* kernel, int k, int threads, size_t smem, int clusters) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(k * clusters));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const bool ok = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess && n > 0;
  cudaGetLastError();  // a refused configuration is an answer, not an error
  return ok;
}

// Allows the kernel the largest dynamic shared memory and clusters of up to 16.
cudaError_t prepare(const void* kernel, int dev) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(fa.sharedSizeBytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Cluster size, threads and shared memory for one call. The cluster is at
// least large enough to give the card two CTAs per SM, and as small as lets a
// CTA keep its rows in shared memory at two CTAs per SM, else at one; a slab
// that fits neither at 16 CTAs reads its rows twice.
Plan make_plan(const void* kernel, bool backward, const Dims& d, int bg, int elt, int sms) {
  const int kmax = d.rows < kMaxCluster ? d.rows : kMaxCluster;
  int kpar = (2 * sms + bg - 1) / bg;
  kpar = kpar < 1 ? 1 : kpar > kmax ? kmax : kpar;
  const size_t budgets[2] = {kTwoPerSm, kOnePerSm};
  for (size_t budget : budgets) {
    for (int k = kpar; k <= kmax; ++k) {
      const int R = (d.rows + k - 1) / k;
      const int threads = threads_for(static_cast<long long>(R) * d.W, budget == kOnePerSm);
      int nseg = 1;
      const size_t smem = smem_bytes(backward, d, k, threads, elt, true, &nseg);
      if (smem <= budget && can_launch(kernel, k, threads, smem, bg < 4 ? bg : 4))
        return Plan{k, threads, 1, nseg, smem};
    }
  }
  for (int k = kmax; k >= 1; --k) {
    int nseg = 1;
    const size_t smem = smem_bytes(backward, d, k, kMaxThreads, elt, false, &nseg);
    if (can_launch(kernel, k, kMaxThreads, smem, 1)) return Plan{k, kMaxThreads, 0, nseg, smem};
  }
  return Plan{0, 0, 0, 0, 0};
}

// make_plan's answer per (kernel, device, shape), kept so that a call's host
// work is a table lookup; prepare runs at a kernel's first plan on a device.
cudaError_t cached_plan(const void* kernel, bool backward, const Dims& d, int B, int elt,
                        Plan* out) {
  struct Entry {
    const void* kernel;
    int dev, B, C, H, W, groups, pad;
    Plan plan;
  };
  static Entry cache[128];
  static int used = 0, next = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  bool seen = false;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.kernel != kernel || e.dev != dev) continue;
    seen = true;
    if (e.B == B && e.C == d.C && e.H == d.H && e.W == d.W && e.groups == d.groups &&
        e.pad == d.pad) {
      *out = e.plan;
      return cudaSuccess;
    }
  }
  if (!seen && (err = prepare(kernel, dev)) != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *out = make_plan(kernel, backward, d, B * d.groups, elt, sms);
  if (out->k == 0) return cudaErrorInvalidConfiguration;
  cache[next] = Entry{kernel, dev, B, d.C, d.H, d.W, d.groups, d.pad, *out};
  next = (next + 1) % 128;
  if (used < 128) ++used;
  return cudaSuccess;
}

bool make_dims(int B, int C, int H, int W, int groups, float eps, int pad, Dims* d) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || groups <= 0 || C % groups != 0 ||
      (pad != 0 && pad != 1))
    return false;
  const long long cgl = C / groups;
  // every index within one group stays below 2^31
  if (cgl * (H + 2 * pad) * (W + 2 * pad) >= (1ll << 31)) return false;
  if (static_cast<long long>(B) * groups * kMaxCluster >= (1ll << 31)) return false;
  d->C = C;
  d->H = H;
  d->W = W;
  d->groups = groups;
  d->pad = pad;
  d->cg = static_cast<int>(cgl);
  d->ho = H + 2 * pad;
  d->wo = W + 2 * pad;
  d->rows = d->cg * H;
  d->eps = eps;
  d->dW = make_div(W);
  d->dH = make_div(H);
  d->dho = make_div(d->ho);
  d->dwo = make_div(d->wo);
  return true;
}

void finish_dims(const Plan& p, Dims* d) {
  d->k = p.k;
  d->R = (d->rows + p.k - 1) / p.k;
  d->dR = make_div(d->R);
  d->nseg = p.nseg;
  d->in_smem = p.in_smem;
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, const Plan& p, int bg, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(bg) * static_cast<unsigned>(p.k));
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The kernel of a pass, and its plan for one call.
template <typename T>
const void* kernel_of(bool backward) {
  return backward ? reinterpret_cast<const void*>(gn_silu_bwd_kernel<T>)
                  : reinterpret_cast<const void*>(gn_silu_fwd_kernel<T>);
}

template <typename T>
cudaError_t plan_for(bool backward, int B, Dims* d, Plan* p) {
  const cudaError_t err = cached_plan(kernel_of<T>(backward), backward, *d, B, sizeof(T), p);
  if (err == cudaSuccess) finish_dims(*p, d);
  return err;
}

template <typename T>
int forward(const void* x, const void* scale, const void* bias, void* out, void* stats, int B,
            Dims d, cudaStream_t s) {
  Plan p;
  cudaError_t err = plan_for<T>(false, B, &d, &p);
  if (err == cudaSuccess)
    err = launch(gn_silu_fwd_kernel<T>, p, B * d.groups, s, static_cast<const T*>(x),
                 static_cast<const float*>(scale), static_cast<const float*>(bias),
                 static_cast<T*>(out), static_cast<float*>(stats), d);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int backward(const void* x, const void* g, const void* scale, const void* bias,
             const void* stats, void* dx, void* chan, int B, Dims d, cudaStream_t s) {
  Plan p;
  cudaError_t err = plan_for<T>(true, B, &d, &p);
  if (err == cudaSuccess)
    err = launch(gn_silu_bwd_kernel<T>, p, B * d.groups, s, static_cast<const T*>(x),
                 static_cast<const T*>(g), static_cast<const float*>(scale),
                 static_cast<const float*>(bias), static_cast<const float*>(stats),
                 static_cast<T*>(dx), static_cast<float*>(chan), d);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The space axis: partial sums, and the apply pass with given statistics
// ---------------------------------------------------------------------------

constexpr int kSumThreads = 512;
constexpr int kApplyThreads = 256;

// Block j of the k blocks of (item, group) `grp` sums elements [lo, hi) of the
// group's `per_group` contiguous elements; part[grp * k + j] = (S1, S2).
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
gn_silu_sums_kernel(const T* __restrict__ x, float* __restrict__ part, int per_group, int k) {
  __shared__ float red[64];
  const int grp = blockIdx.x / k, j = blockIdx.x - grp * k;
  // shares are whole 16-byte vectors where the group starts on one
  const int vec = 16 / static_cast<int>(sizeof(T));
  const int share = ((per_group + k - 1) / k + vec - 1) / vec * vec;
  const int lo = min(j * share, per_group), hi = min(lo + share, per_group);
  float s1 = 0.f, s2 = 0.f;
  sum_sq(x + static_cast<long long>(grp) * per_group + lo, hi - lo, s1, s2);
  block_sum2(s1, s2, red);
  if (threadIdx.x == 0) {
    part[2 * (static_cast<long long>(grp) * k + j)] = s1;
    part[2 * (static_cast<long long>(grp) * k + j) + 1] = s2;
  }
}

// Block j of the k blocks of (item, group) `grp` writes every k-th run of
// output rows of the group's [cg, ho, wo] plane, a warp per row: the row's
// channel, source row and coefficients once, then the lanes along its columns
// (coalesced loads and stores, no division per element).
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
gn_silu_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, const float* __restrict__ sums,
                     T* __restrict__ out, Dims d, float count, int k) {
  const int grp = blockIdx.x / k, j = blockIdx.x - grp * k;
  const int g = grp % d.groups;
  const float mean = sums[2 * grp] / count;
  const float var = sums[2 * grp + 1] / count - mean * mean;
  const float inv = rsqrtf(fmaxf(var, 0.f) + d.eps);
  // an item's groups are consecutive: group grp starts at channel grp * cg
  const T* xg = x + static_cast<long long>(grp) * d.cg * d.H * d.W;
  T* og = out + static_cast<long long>(grp) * d.cg * d.ho * d.wo;
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int rows = d.cg * d.ho;
  for (int r = j * warps + (threadIdx.x >> 5); r < rows; r += k * warps) {
    const int c = fdiv(r, d.dho);
    const float a = inv * scale[g * d.cg + c];
    const float b = bias[g * d.cg + c] - mean * a;
    const T* src = xg + static_cast<long long>(c * d.H + wrap(r - c * d.ho, d.pad, d.H)) * d.W;
    T* dst = og + static_cast<long long>(r) * d.wo;
    for (int col = lane; col < d.wo; col += 32) {
      const float y = to_f32(src[wrap(col, d.pad, d.W)]) * a + b;
      dst[col] = from_f32<T>(y * sigmoid(y));
    }
  }
}

constexpr int kBwdSpaceThreads = 256;

// What the space backward kernels read for one row: x's row, the upstream
// gradient's padded row, and with pad the edge rows returned by the ranks
// that read this row as their halo (null where none does).
template <typename T>
struct SpaceRow {
  const T *x, *g, *e0, *e1;
};

template <typename T>
__device__ __forceinline__ SpaceRow<T> space_row(const T* x, const T* g, const T* edge,
                                                 const Dims& d, long long bc, int i) {
  SpaceRow<T> r;
  r.x = x + (bc * d.H + i) * d.W;
  r.g = g + (bc * d.ho + i + d.pad) * d.wo;
  r.e0 = d.pad && i == 0 ? edge + (2 * bc) * d.wo : nullptr;
  r.e1 = d.pad && i == d.H - 1 ? edge + (2 * bc + 1) * d.wo : nullptr;
  return r;
}

// A padded gradient row at interior column j, folded over the W halo.
template <typename T>
__device__ __forceinline__ float fold_col(const T* row, int j, const Dims& d) {
  float v = to_f32(row[j + d.pad]);
  if (d.pad) {
    if (j == d.W - 1) v += to_f32(row[0]);
    if (j == 0) v += to_f32(row[d.W + 1]);
  }
  return v;
}

// V consecutive values of x and of the folded gradient at columns [j, j + V)
// of one row, in f32; V > 1 reads x (and an unpadded gradient) 16 bytes at a time.
template <typename T, int V>
__device__ __forceinline__ void load_row_chunk(const SpaceRow<T>& r, int j, const Dims& d,
                                               float (&xv)[V], float (&gv)[V]) {
  if constexpr (V > 1) {
    const uint4 u = *reinterpret_cast<const uint4*>(r.x + j);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int q = 0; q < V; ++q) xv[q] = to_f32(e[q]);
    if (!d.pad) {
      const uint4 w = *reinterpret_cast<const uint4*>(r.g + j);
      const T* f = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int q = 0; q < V; ++q) gv[q] = to_f32(f[q]);
      return;
    }
  } else {
    xv[0] = to_f32(r.x[j]);
  }
#pragma unroll
  for (int q = 0; q < V; ++q) {
    float v = fold_col(r.g, j + q, d);
    if (r.e0 != nullptr) v += fold_col(r.e0, j + q, d);
    if (r.e1 != nullptr) v += fold_col(r.e1, j + q, d);
    gv[q] = v;
  }
}

// Mean and inv of group `grp` from its sums (S1, S2) over `count` elements,
// as the apply kernel forms them; clipped where the fast variance is negative.
__device__ __forceinline__ void group_stats(const float* sums, int grp, float count, float eps,
                                            float& mean, float& inv, bool& clipped) {
  mean = sums[2 * grp] / count;
  const float var = sums[2 * grp + 1] / count - mean * mean;
  clipped = var < 0.f;
  inv = rsqrtf(fmaxf(var, 0.f) + eps);
}

// Block j of the k blocks of (item, channel) `bc` sums dz and dz * xhat over
// its share of the channel's rows: part[bc * k + j] = (sum dz, sum dz xhat).
template <typename T, int V>
__global__ void __launch_bounds__(kBwdSpaceThreads)
gn_silu_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const T* __restrict__ edge, const float* __restrict__ scale,
                        const float* __restrict__ bias, const float* __restrict__ sums,
                        float* __restrict__ part, Dims d, float count, int k) {
  __shared__ float red[64];
  const int bc = blockIdx.x / k, j = blockIdx.x - bc * k;
  const int c = bc % d.C;
  const int grp = bc / d.C * d.groups + c / d.cg;
  float mean, inv;
  bool clipped;
  group_stats(sums, grp, count, d.eps, mean, inv, clipped);
  const float sc = scale[c], bi = bias[c];
  const int share = (d.H + k - 1) / k;
  const int i0 = min(j * share, d.H), i1 = min(i0 + share, d.H);
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  float s1 = 0.f, s2 = 0.f;
  for (int i = i0 + (threadIdx.x >> 5); i < i1; i += warps) {
    const SpaceRow<T> r = space_row(x, g, edge, d, bc, i);
    for (int col = lane * V; col < d.W; col += 32 * V) {
      float xv[V], gv[V];
      load_row_chunk<T, V>(r, col, d, xv, gv);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float xhat = (xv[q] - mean) * inv;
        const float z = xhat * sc + bi;
        const float sg = sigmoid(z);
        const float dz = gv[q] * sg * (1.f + z * (1.f - sg));
        s1 += dz;
        s2 += dz * xhat;
      }
    }
  }
  block_sum2(s1, s2, red);
  if (threadIdx.x == 0) {
    part[2 * (static_cast<long long>(bc) * k + j)] = s1;
    part[2 * (static_cast<long long>(bc) * k + j) + 1] = s2;
  }
}

// Block j of the k blocks of (item, channel) `bc` writes dx over its share of
// the channel's rows; dsums [B * groups * 2] holds each group's (sum dxhat,
// sum dxhat * xhat) over every rank's rows.
template <typename T, int V>
__global__ void __launch_bounds__(kBwdSpaceThreads)
gn_silu_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const T* __restrict__ edge, const float* __restrict__ scale,
                         const float* __restrict__ bias, const float* __restrict__ sums,
                         const float* __restrict__ dsums, T* __restrict__ dx, Dims d,
                         float count, int k) {
  const int bc = blockIdx.x / k, j = blockIdx.x - bc * k;
  const int c = bc % d.C;
  const int grp = bc / d.C * d.groups + c / d.cg;
  float mean, inv;
  bool clipped;
  group_stats(sums, grp, count, d.eps, mean, inv, clipped);
  const float m1 = dsums[2 * grp] / count;
  const float m2 = clipped ? 0.f : dsums[2 * grp + 1] / count;
  const float sc = scale[c], bi = bias[c];
  const int share = (d.H + k - 1) / k;
  const int i0 = min(j * share, d.H), i1 = min(i0 + share, d.H);
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int i = i0 + (threadIdx.x >> 5); i < i1; i += warps) {
    const SpaceRow<T> r = space_row(x, g, edge, d, bc, i);
    T* out = dx + (static_cast<long long>(bc) * d.H + i) * d.W;
    for (int col = lane * V; col < d.W; col += 32 * V) {
      float xv[V], gv[V];
      load_row_chunk<T, V>(r, col, d, xv, gv);
      alignas(16) T res[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float xhat = (xv[q] - mean) * inv;
        const float z = xhat * sc + bi;
        const float sg = sigmoid(z);
        const float dz = gv[q] * sg * (1.f + z * (1.f - sg));
        res[q] = from_f32<T>(inv * (dz * sc - m1 - xhat * m2));
      }
      if constexpr (V > 1) {
        *reinterpret_cast<uint4*>(out + col) = *reinterpret_cast<const uint4*>(res);
      } else {
        out[col] = res[0];
      }
    }
  }
}

template <typename T>
int space_bwd(bool apply, const void* x, const void* g, const void* edge, const void* scale,
              const void* bias, const void* sums, const void* dsums, void* out, int B,
              const Dims& d, float count, int k, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const unsigned blocks = static_cast<unsigned>(B) * d.C * k;
  const T *xt = static_cast<const T*>(x), *gt = static_cast<const T*>(g);
  const T* et = static_cast<const T*>(edge);
  const float *sct = static_cast<const float*>(scale), *bit = static_cast<const float*>(bias);
  const float* st = static_cast<const float*>(sums);
  // 16-byte rows: x (and dx) hold W elements a row from a 16-byte aligned start
  const bool vec = d.W % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (d.pad || reinterpret_cast<uintptr_t>(g) % 16 == 0);
  if (apply) {
    const float* dt = static_cast<const float*>(dsums);
    T* o = static_cast<T*>(out);
    if (vec)
      gn_silu_bwd_apply_kernel<T, V><<<blocks, kBwdSpaceThreads, 0, s>>>(xt, gt, et, sct, bit,
                                                                         st, dt, o, d, count, k);
    else
      gn_silu_bwd_apply_kernel<T, 1><<<blocks, kBwdSpaceThreads, 0, s>>>(xt, gt, et, sct, bit,
                                                                         st, dt, o, d, count, k);
  } else {
    float* o = static_cast<float*>(out);
    if (vec)
      gn_silu_bwd_sums_kernel<T, V><<<blocks, kBwdSpaceThreads, 0, s>>>(xt, gt, et, sct, bit, st,
                                                                        o, d, count, k);
    else
      gn_silu_bwd_sums_kernel<T, 1><<<blocks, kBwdSpaceThreads, 0, s>>>(xt, gt, et, sct, bit, st,
                                                                        o, d, count, k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int space_sums(const void* x, void* part, int B, const Dims& d, int k, cudaStream_t s) {
  gn_silu_sums_kernel<T><<<static_cast<unsigned>(B) * d.groups * k, kSumThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<float*>(part), d.rows * d.W, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int space_apply(const void* x, const void* scale, const void* bias, const void* sums, void* out,
                int B, const Dims& d, float count, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough blocks for four per SM, no more than the plane has rows for their warps
  const int bg = B * d.groups;
  const int runs = (d.cg * d.ho + kApplyThreads / 32 - 1) / (kApplyThreads / 32);
  const int k = max(1, min(runs, (4 * sms + bg - 1) / bg));
  gn_silu_apply_kernel<T><<<static_cast<unsigned>(bg) * k, kApplyThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(sums), static_cast<T*>(out), d,
      count, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace


// dtype: 0 = float32, 1 = bfloat16. pad: 0 or 1. stats: null, or [B * groups * 3]
// f32 that receives (mean, inv, clipped) per (item, group). Returns a cudaError_t.
extern "C" int gn_silu_launch(const void* x, const void* scale, const void* bias, void* out,
                              void* stats, int B, int C, int H, int W, int groups, float eps,
                              int pad, int dtype, void* stream) {
  Dims d;
  if (!make_dims(B, C, H, W, groups, eps, pad, &d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return forward<float>(x, scale, bias, out, stats, B, d, s);
  if (dtype == 1) return forward<__nv_bfloat16>(x, scale, bias, out, stats, B, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g: the upstream gradient [B, C, H+2pad, W+2pad] in x's type; stats: what the
// forward wrote; dx: [B, C, H, W] in x's type; chan: [B, C, 2] f32 that receives
// (sum dz, sum dz * xhat) per (item, channel), whose sums over B are dbias and
// dscale. Returns a cudaError_t.
extern "C" int gn_silu_backward_launch(const void* x, const void* g, const void* scale,
                                       const void* bias, const void* stats, void* dx,
                                       void* chan, int B, int C, int H, int W, int groups,
                                       float eps, int pad, int dtype, void* stream) {
  Dims d;
  if (!make_dims(B, C, H, W, groups, eps, pad, &d) || stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return backward<float>(x, g, scale, bias, stats, dx, chan, B, d, s);
  if (dtype == 1) return backward<__nv_bfloat16>(x, g, scale, bias, stats, dx, chan, B, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan a call of this shape gets: out[0..3] = cluster size, threads per
// CTA, 1 if a CTA keeps its rows in shared memory, dynamic shared memory bytes.
extern "C" int gn_silu_plan(int B, int C, int H, int W, int groups, int pad, int dtype,
                            int backward_pass, int* out) {
  Dims d;
  if (!make_dims(B, C, H, W, groups, 1e-6f, pad, &d) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  const cudaError_t err = dtype == 0 ? plan_for<float>(backward_pass != 0, B, &d, &p)
                                     : plan_for<__nv_bfloat16>(backward_pass != 0, B, &d, &p);
  out[0] = p.k;
  out[1] = p.threads;
  out[2] = p.in_smem;
  out[3] = static_cast<int>(p.smem);
  return static_cast<int>(err);
}

// The space axis's sums kernel: part [B * groups * k * 2] f32 receives (S1,
// S2) of each of the k shares of every (item, group). Returns a cudaError_t.
extern "C" int gn_silu_sums_launch(const void* x, void* part, int B, int C, int H, int W,
                                   int groups, int k, int dtype, void* stream) {
  Dims d;
  if (!make_dims(B, C, H, W, groups, 1e-6f, 0, &d) || k < 1 || k > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return space_sums<float>(x, part, B, d, k, s);
  if (dtype == 1) return space_sums<__nv_bfloat16>(x, part, B, d, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The space axis's apply kernel: sums [B * groups * 2] f32 (S1, S2) over
// `count` elements per (item, group); out as gn_silu_launch's. Returns a
// cudaError_t.
extern "C" int gn_silu_apply_launch(const void* x, const void* scale, const void* bias,
                                    const void* sums, void* out, int B, int C, int H, int W,
                                    int groups, float count, float eps, int pad, int dtype,
                                    void* stream) {
  Dims d;
  if (!make_dims(B, C, H, W, groups, eps, pad, &d) || !(count > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return space_apply<float>(x, scale, bias, sums, out, B, d, count, s);
  if (dtype == 1) return space_apply<__nv_bfloat16>(x, scale, bias, sums, out, B, d, count, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The space axis's backward sums kernel. g: the upstream gradient [B, C, H+2pad,
// W+2pad] in x's type; edge: with pad, [B, C, 2, W+2] in x's type, the gradient
// rows that the ranks above and below return to this rank's first and last
// rows (else unused); sums: the forward's [B * groups * 2] (S1, S2) over `count`
// elements per (item, group); part [B * C * k * 2] f32 receives (sum dz, sum dz
// xhat) of each of the k shares of every (item, channel). Returns a cudaError_t.
extern "C" int gn_silu_backward_sums_launch(const void* x, const void* g, const void* edge,
                                            const void* scale, const void* bias,
                                            const void* sums, void* part, int B, int C, int H,
                                            int W, int groups, float count, float eps, int pad,
                                            int k, int dtype, void* stream) {
  Dims d;
  if (!make_dims(B, C, H, W, groups, eps, pad, &d) || !(count > 0.f) || k < 1 || k > H ||
      (pad && edge == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return space_bwd<float>(false, x, g, edge, scale, bias, sums, nullptr, part, B, d, count,
                            k, s);
  if (dtype == 1)
    return space_bwd<__nv_bfloat16>(false, x, g, edge, scale, bias, sums, nullptr, part, B, d,
                                    count, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The space axis's backward apply kernel: dsums [B * groups * 2] f32 holds each
// group's (sum dxhat, sum dxhat * xhat) over every rank's rows; dx: [B, C, H, W]
// in x's type; the rest as gn_silu_backward_sums_launch's. Returns a cudaError_t.
extern "C" int gn_silu_backward_apply_launch(const void* x, const void* g, const void* edge,
                                             const void* scale, const void* bias,
                                             const void* sums, const void* dsums, void* dx,
                                             int B, int C, int H, int W, int groups,
                                             float count, float eps, int pad, int k, int dtype,
                                             void* stream) {
  Dims d;
  if (!make_dims(B, C, H, W, groups, eps, pad, &d) || !(count > 0.f) || k < 1 || k > H ||
      (pad && edge == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return space_bwd<float>(true, x, g, edge, scale, bias, sums, dsums, dx, B, d, count, k, s);
  if (dtype == 1)
    return space_bwd<__nv_bfloat16>(true, x, g, edge, scale, bias, sums, dsums, dx, B, d,
                                    count, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gn_silu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
