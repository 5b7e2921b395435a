// Copyright 2026 The kubeflow-tpu Authors.
//
// Licensed under the Apache License, Version 2.0 (the "License");
// you may not use this file except in compliance with the License.
// You may obtain a copy of the License at
//
//     http://www.apache.org/licenses/LICENSE-2.0
//
// Unless required by applicable law or agreed to in writing, software
// distributed under the License is distributed on an "AS IS" BASIS,
// WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
// See the License for the specific language governing permissions and
// limitations under the License.

// Batch-norm training forward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU kernel kubeflow_tpu/ops/bn_pallas.py::_bn_fwd_kernel
// (a Pallas kernel whose sequential grid carried per-channel fp32 sums
// in VMEM scratch from a stats phase into a normalize phase). It
// computes the same function on a row-major [M, C] x:
//   mean = sum(x[:m_stat]) / m_stat, var = max(sum(x^2) / m_stat - mean^2, 0)
//   y    = (x - mean) * (rsqrt(var + eps) * scale) + bias
// with fp32 statistics and arithmetic, y cast to x's type. m_stat <= M
// is the number of leading rows that feed the statistics (ghost batch
// norm); every row is normalized.
//
// What bounds it on the H100: a few operations per element, far below
// the card's ~295 operations per byte, so bytes. The least traffic is
// x read once and y written once; the statistics must be complete before
// any row is normalized, so a design that streams x reads the stat rows
// twice unless it finds them on chip the second time.
//
// Design: ONE cooperative launch of a persistent grid (every block
// co-resident, cudaLaunchCooperativeKernel, so a grid too large comes
// back as cudaErrorCooperativeLaunchTooLarge and never hangs), in three
// phases split by two grid-wide barriers (cooperative_groups):
//  (a) partial sums. Block b owns C tile b % c_tiles and row chunk
//      b / c_tiles: stat rows [a0, a1) and non-stat rows [b0, b1). A
//      block of 512 threads is tx channel-vectors wide and ty rows deep
//      (16-byte vector loads along C; a warp reads whole rows even at
//      C = 64). The last `keep` stat rows of the block (its slab, or as
//      much of it as fits in shared memory) are loaded once by 16-byte
//      cp.async at the start, each thread copying the cells it will sum
//      and normalize; meanwhile the threads stream the rest with U
//      independent 16-byte loads in flight each, then sum the kept rows.
//      Per-thread fp32 sums go through a fixed shared-memory tree to one
//      fp32 partial per (chunk, channel).
//  (b) finalize, spread over the grid: block b takes channels
//      [b * cpb, (b + 1) * cpb); a warp sums one channel's chunk
//      partials in double, lane-strided, then a fixed xor-shuffle tree,
//      and writes mean, var and mul = rsqrt(var + eps) * scale.
//  (c) normalize: the tile's mean, mul and bias staged in shared
//      memory; first the streamed stat rows in the REVERSE of the order
//      phase (a) read them, so the tens of MB it read last are still in
//      the 50 MB L2; then the kept rows, straight from shared memory;
//      then the non-stat rows (ghost statistics), read once.
// When a block's whole stat slab fits in shared memory (the "onchip"
// route, chosen by launch_plan from the shape alone), x is read from
// device memory exactly once.
//
// Against the earlier three-launch design, point by point:
//  1. one launch instead of three dependent ones, so no ramp and tail
//     between them; the two grid barriers cost about 1 us each;
//  2. the finalize runs over the whole grid, chains of at most
//     chunks / 32 loads a lane, instead of one thread per channel
//     summing every chunk in turn;
//  3. x is read once where a block's stat slab fits in shared memory
//     (16 of ResNet-50's 53 layers at b256 with exact statistics, most
//     of them with ghost statistics); elsewhere the kept rows are read
//     once and the streamed ones meet L2 on the way back;
//  4. U = 4 independent 16-byte loads in flight a thread, 512 threads
//     an SM, plus the kept rows' cp.async;
//  5. the wrapper's host work is one allocation for y and one for
//     mean, var and the work buffer, and a cached plan; chip_smoke.py
//     times the kernel as 20 back-to-back calls and by the profiler.
// Phase (c) stages the tile's mean, mul and bias in shared memory: read
// from L2 by every thread, they would queue the whole grid on a few L2
// lines (scripts/bn_phase_times.py times each phase).
//
// The sync route (a batch split over the ranks of a gang, sync batch
// norm) splits this function around an all-reduce of the per-channel
// sums, with two more entries (bn_stats_kernel, bn_apply_kernel):
//  stats: phases (a) and (b) of the fused launch over the rank's stat
//    rows, with the fused launch's plan and so its partial-sum order, but
//    the finalize writes fp32 sum(x) and sum(x^2) (the double sums cast
//    to float, as the fused finalize casts them before dividing);
//  apply: phase (c) from given global sums and a global row count: each
//    block derives its channels' mean, var and mul by the fused
//    finalize's arithmetic, then normalizes its rows.
// On one rank, stats + apply give the fused launch's bits.
//
// Same bits on every run: every sum is taken in an order fixed by the
// plan (no floating-point atomics; the only shared counter is the grid
// barrier's). Hierarchical sums (a thread's rows in fp32, the block tree
// in fp32, chunks in double) keep the statistics accurate over the 3.2 M
// rows of the ResNet-50 stem. y is rounded op by op (__fsub_rn,
// __fmul_rn, __fadd_rn) to follow the plain version. Channel and row
// tails are masked; a C that is not a multiple of the vector width, or
// an unaligned x, takes the scalar path (vec = 1), which streams only.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// 16-byte loads a thread keeps in flight when it streams rows.
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC consecutive elements; VEC > 1 is one 16-byte access. p may point
// to global or shared memory.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_float(p[0]);
  } else {
    static_assert(sizeof(T) * VEC == 16, "vector accesses are 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_float(v[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_float<T>(in[0]);
  } else {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = from_float<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16-byte cp.async, global -> shared, cached in L2 only.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}

struct Params {
  const void* x;
  void* y;
  const float* scale;
  const float* bias;
  float* mean;
  float* var;
  float* work;  // partial [chunks][2][c], then mul [c]
  long long m, m_stat;
  long long stat_per;  // stat rows per chunk
  long long rest_per;  // rows of [m_stat, m) per chunk
  int c, c_tiles, chunks, keep;
  float eps;
};

// Sum rows r0 + j, j = t, t + nt, ... < n, into s and ss: U loads in
// flight before they are added, in row order.
template <typename T, int VEC>
__device__ __forceinline__ void sum_rows(const T* x, long long r0, long long n,
                                         int c, int c0, int t, int nt,
                                         float (&s)[VEC], float (&ss)[VEC]) {
  long long j = t;
  for (; j + static_cast<long long>(kUnroll - 1) * nt < n;
       j += static_cast<long long>(kUnroll) * nt) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_vec<T, VEC>(x + (r0 + j + u * nt) * c + c0, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += v[u][i];
        ss[i] += v[u][i] * v[u][i];
      }
  }
  for (; j < n; j += nt) {
    float v[VEC];
    load_vec<T, VEC>(x + (r0 + j) * c + c0, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[i] += v[i];
      ss[i] += v[i] * v[i];
    }
  }
}

// VEC fp32 values to or from shared memory, 16 bytes at a time where
// they come in fours.
template <int VEC>
__device__ __forceinline__ void put(float* dst, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = v[i];
  }
}

template <int VEC>
__device__ __forceinline__ void add_from(float (&v)[VEC], const float* src) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + i);
      v[i] += t.x;
      v[i + 1] += t.y;
      v[i + 2] += t.z;
      v[i + 3] += t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] += src[i];
  }
}

template <int VEC>
__device__ __forceinline__ void normalize(float (&v)[VEC], const float (&mu)[VEC],
                                          const float (&k)[VEC],
                                          const float (&b)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    v[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[i], mu[i]), k[i]), b[i]);
}

// y = normalized x over rows base + dir * j, j = t, t + nt, ... < n.
template <typename T, int VEC>
__device__ __forceinline__ void normalize_rows(const T* x, T* y, long long base,
                                               int dir, long long n, int c,
                                               int c0, int t, int nt,
                                               const float (&mu)[VEC],
                                               const float (&k)[VEC],
                                               const float (&b)[VEC]) {
  long long j = t;
  for (; j + static_cast<long long>(kUnroll - 1) * nt < n;
       j += static_cast<long long>(kUnroll) * nt) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_vec<T, VEC>(x + (base + dir * (j + u * nt)) * c + c0, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      normalize<VEC>(v[u], mu, k, b);
      store_vec<T, VEC>(y + (base + dir * (j + u * nt)) * c + c0, v[u]);
    }
  }
  for (; j < n; j += nt) {
    float v[VEC];
    load_vec<T, VEC>(x + (base + dir * j) * c + c0, v);
    normalize<VEC>(v, mu, k, b);
    store_vec<T, VEC>(y + (base + dir * j) * c + c0, v);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    bn_train_forward_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const T* __restrict__ x = static_cast<const T*>(p.x);
  T* __restrict__ y = static_cast<T*>(p.y);
  const int c = p.c;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nty = blockDim.y;
  const int tid = ty * blockDim.x + tx;
  const int c_tile = blockIdx.x % p.c_tiles;
  const int chunk = blockIdx.x / p.c_tiles;
  const int c_base = c_tile * blockDim.x * VEC;
  const int c0 = c_base + tx * VEC;  // VEC > 1 only when c % VEC == 0
  const bool active = c0 < c;
  const int width = min(static_cast<int>(blockDim.x) * VEC, c - c_base);

  const long long a0 = min(p.m_stat, chunk * p.stat_per);
  const long long a1 = min(p.m_stat, a0 + p.stat_per);
  const long long keep = min(static_cast<long long>(p.keep), a1 - a0);
  const long long streamed = a1 - a0 - keep;
  const long long b0 = min(p.m, p.m_stat + chunk * p.rest_per);
  const long long b1 = min(p.m, b0 + p.rest_per);

  // Shared memory: the reduction tree's scratch, then the kept rows.
  float* red = reinterpret_cast<float*>(smem);
  T* slab = reinterpret_cast<T*>(smem + (kThreads / 2) * VEC * 2 *
                                            sizeof(float));

  // (a) Start the kept rows' copies, then stream the rest. A thread
  // copies, sums and later normalizes the same cells of the slab, so
  // nothing but its own cp.async group orders them.
  if constexpr (VEC > 1) {
    if (active && keep > 0) {
      const T* src = x + (a1 - keep) * c + c0;
      for (long long r = ty; r < keep; r += nty)
        cp_async16(smem_u32(slab + r * width + tx * VEC), src + r * c);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }

  float s[VEC], ss[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = ss[i] = 0.f;
  if (active) sum_rows<T, VEC>(x, a0, streamed, c, c0, ty, nty, s, ss);
  if constexpr (VEC > 1) {
    if (active && keep > 0) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      for (long long r = ty; r < keep; r += nty) {
        float v[VEC];
        load_vec<T, VEC>(slab + r * width + tx * VEC, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s[j] += v[j];
          ss[j] += v[j] * v[j];
        }
      }
    }
  }

  // The block's fixed tree over its ty row lanes: the upper half hands
  // its sums to the lower half through shared memory.
  const int wf = blockDim.x * VEC;
  float* red_s = red;
  float* red_ss = red + (nty / 2) * wf;
  for (int half = nty / 2; half > 0; half /= 2) {
    if (ty >= half && ty < 2 * half) {
      put<VEC>(red_s + (ty - half) * wf + tx * VEC, s);
      put<VEC>(red_ss + (ty - half) * wf + tx * VEC, ss);
    }
    __syncthreads();
    if (ty < half) {
      add_from<VEC>(s, red_s + ty * wf + tx * VEC);
      add_from<VEC>(ss, red_ss + ty * wf + tx * VEC);
    }
    __syncthreads();
  }
  float* partial = p.work;
  if (ty == 0 && active) {
    float* out = partial + static_cast<long long>(chunk) * 2 * c;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      out[c0 + i] = s[i];
      out[c + c0 + i] = ss[i];
    }
  }

  cg::grid_group grid = cg::this_grid();
  grid.sync();

  // (b) Finalize a slice of the channels: a warp per channel.
  float* mul = p.work + static_cast<long long>(p.chunks) * 2 * c;
  {
    const int blocks = gridDim.x;
    const int cpb = (c + blocks - 1) / blocks;
    const int lane = tid & 31, warp = tid >> 5;
    const int ch_end = min(c, (static_cast<int>(blockIdx.x) + 1) * cpb);
    for (int ch = blockIdx.x * cpb + warp; ch < ch_end; ch += kThreads / 32) {
      double ds = 0.0, dss = 0.0;
      for (int k = lane; k < p.chunks; k += 32) {
        ds += __ldcg(partial + static_cast<long long>(k) * 2 * c + ch);
        dss += __ldcg(partial + static_cast<long long>(k) * 2 * c + c + ch);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ds += __shfl_xor_sync(0xffffffffu, ds, o);
        dss += __shfl_xor_sync(0xffffffffu, dss, o);
      }
      if (lane == 0) {
        const float n = static_cast<float>(p.m_stat);
        const float mean = __fdiv_rn(static_cast<float>(ds), n);
        const float ex2 = __fdiv_rn(static_cast<float>(dss), n);
        const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
        p.mean[ch] = mean;
        p.var[ch] = var;
        mul[ch] = __fmul_rn(rsqrtf(__fadd_rn(var, p.eps)), p.scale[ch]);
      }
    }
  }

  grid.sync();

  // (c) Normalize: streamed stat rows newest first, kept rows from
  // shared memory, then the non-stat rows. The tile's mean, mul and
  // bias come through the tree's scratch, one load a channel, not one
  // per thread from the same few L2 lines.
  for (int i = tid; i < width; i += kThreads) {
    red[i] = __ldcg(p.mean + c_base + i);
    red[width + i] = __ldcg(mul + c_base + i);
    red[2 * width + i] = p.bias[c_base + i];
  }
  __syncthreads();
  if (!active) return;
  float mu[VEC], k[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mu[i] = red[tx * VEC + i];
    k[i] = red[width + tx * VEC + i];
    b[i] = red[2 * width + tx * VEC + i];
  }
  normalize_rows<T, VEC>(x, y, a0 + streamed - 1, -1, streamed, c, c0, ty,
                         nty, mu, k, b);
  if constexpr (VEC > 1) {
    for (long long r = ty; r < keep; r += nty) {
      float v[VEC];
      load_vec<T, VEC>(slab + r * width + tx * VEC, v);
      normalize<VEC>(v, mu, k, b);
      store_vec<T, VEC>(y + (a1 - keep + r) * c + c0, v);
    }
  }
  normalize_rows<T, VEC>(x, y, b0, 1, b1 - b0, c, c0, ty, nty, mu, k, b);
}

// The sync route's stats: phase (a) of the fused kernel with its plan,
// the kept rows read from device memory in the order the fused kernel
// sums them from shared memory, then phase (b)'s double sums over the
// chunks, written as fp32 sums (sums[0:c] = sum x, sums[c:2c] = sum x^2).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    bn_stats_kernel(const Params p, float* __restrict__ sums) {
  extern __shared__ __align__(128) unsigned char smem[];
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int c = p.c;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nty = blockDim.y;
  const int tid = ty * blockDim.x + tx;
  const int c_tile = blockIdx.x % p.c_tiles;
  const int chunk = blockIdx.x / p.c_tiles;
  const int c_base = c_tile * blockDim.x * VEC;
  const int c0 = c_base + tx * VEC;
  const bool active = c0 < c;

  const long long a0 = min(p.m_stat, chunk * p.stat_per);
  const long long a1 = min(p.m_stat, a0 + p.stat_per);
  const long long keep = min(static_cast<long long>(p.keep), a1 - a0);
  const long long streamed = a1 - a0 - keep;

  float s[VEC], ss[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = ss[i] = 0.f;
  if (active) {
    sum_rows<T, VEC>(x, a0, streamed, c, c0, ty, nty, s, ss);
    sum_rows<T, VEC>(x, a1 - keep, keep, c, c0, ty, nty, s, ss);
  }

  float* red = reinterpret_cast<float*>(smem);
  const int wf = blockDim.x * VEC;
  float* red_s = red;
  float* red_ss = red + (nty / 2) * wf;
  for (int half = nty / 2; half > 0; half /= 2) {
    if (ty >= half && ty < 2 * half) {
      put<VEC>(red_s + (ty - half) * wf + tx * VEC, s);
      put<VEC>(red_ss + (ty - half) * wf + tx * VEC, ss);
    }
    __syncthreads();
    if (ty < half) {
      add_from<VEC>(s, red_s + ty * wf + tx * VEC);
      add_from<VEC>(ss, red_ss + ty * wf + tx * VEC);
    }
    __syncthreads();
  }
  float* partial = p.work;
  if (ty == 0 && active) {
    float* out = partial + static_cast<long long>(chunk) * 2 * c;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      out[c0 + i] = s[i];
      out[c + c0 + i] = ss[i];
    }
  }

  cg::grid_group grid = cg::this_grid();
  grid.sync();

  const int blocks = gridDim.x;
  const int cpb = (c + blocks - 1) / blocks;
  const int lane = tid & 31, warp = tid >> 5;
  const int ch_end = min(c, (static_cast<int>(blockIdx.x) + 1) * cpb);
  for (int ch = blockIdx.x * cpb + warp; ch < ch_end; ch += kThreads / 32) {
    double ds = 0.0, dss = 0.0;
    for (int k = lane; k < p.chunks; k += 32) {
      ds += __ldcg(partial + static_cast<long long>(k) * 2 * c + ch);
      dss += __ldcg(partial + static_cast<long long>(k) * 2 * c + c + ch);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ds += __shfl_xor_sync(0xffffffffu, ds, o);
      dss += __shfl_xor_sync(0xffffffffu, dss, o);
    }
    if (lane == 0) {
      sums[ch] = static_cast<float>(ds);
      sums[c + ch] = static_cast<float>(dss);
    }
  }
}

// The sync route's apply: a plain grid, block (tile, chunk) normalizing
// rows [chunk * stat_per, (chunk + 1) * stat_per) of its C tile with the
// mean, var and mul the fused finalize would give for sums and a count
// m_stat (block chunk 0 writes mean and var).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const Params p, const float* __restrict__ sums) {
  const T* __restrict__ x = static_cast<const T*>(p.x);
  T* __restrict__ y = static_cast<T*>(p.y);
  const int c = p.c;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c_tile = blockIdx.x % p.c_tiles;
  const int chunk = blockIdx.x / p.c_tiles;
  const int c0 = c_tile * blockDim.x * VEC + tx * VEC;
  if (c0 >= c) return;
  const float n = static_cast<float>(p.m_stat);
  float mu[VEC], k[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int ch = c0 + i;
    const float mean = __fdiv_rn(sums[ch], n);
    const float ex2 = __fdiv_rn(sums[c + ch], n);
    const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
    mu[i] = mean;
    k[i] = __fmul_rn(rsqrtf(__fadd_rn(var, p.eps)), p.scale[ch]);
    b[i] = p.bias[ch];
    if (chunk == 0 && ty == 0) {
      p.mean[ch] = mean;
      p.var[ch] = var;
    }
  }
  const long long r0 = min(p.m, chunk * p.stat_per);
  const long long r1 = min(p.m, r0 + p.stat_per);
  normalize_rows<T, VEC>(x, y, r0, 1, r1 - r0, c, c0, ty, blockDim.y, mu, k,
                         b);
}

template <typename T, int VEC>
cudaError_t launch_stats(Params p, float* sums, int tx, int ty,
                         cudaStream_t stream) {
  if (tx * ty != kThreads || (VEC == 1 && p.keep != 0))
    return cudaErrorInvalidValue;
  void* args[] = {&p, &sums};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(bn_stats_kernel<T, VEC>),
      dim3(p.c_tiles * p.chunks), dim3(tx, ty), args,
      static_cast<size_t>((kThreads / 2) * VEC * 2 * sizeof(float)), stream);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

template <typename T, int VEC>
cudaError_t launch_apply(const Params& p, const float* sums, int tx, int ty,
                         cudaStream_t stream) {
  if (tx * ty != kThreads) return cudaErrorInvalidValue;
  bn_apply_kernel<T, VEC>
      <<<p.c_tiles * p.chunks, dim3(tx, ty), 0, stream>>>(p, sums);
  return cudaGetLastError();
}

// Bytes of dynamic shared memory a launch takes: the reduction tree's
// scratch and `keep` rows of the widest C tile.
template <typename T, int VEC>
long long smem_bytes(int tx, int c, int keep) {
  const long long width = (tx * VEC < c ? tx * VEC : c) * sizeof(T);
  return (kThreads / 2) * VEC * 2 * sizeof(float) + keep * width;
}

// Let the kernel take the device's opt-in shared memory (set once per
// device; setting it twice is harmless).
template <typename T, int VEC>
cudaError_t allow_full_smem(int* optin) {
  static int set_to[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && set_to[dev] != 0) {
    *optin = set_to[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bn_train_forward_kernel<T, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *optin);
  if (err == cudaSuccess && dev < 64) set_to[dev] = *optin;
  return err;
}

template <typename T, int VEC>
cudaError_t limits(int* sms, int* blocks_per_sm, long long* slab_bytes) {
  int optin = 0, dev = 0;
  cudaError_t err = allow_full_smem<T, VEC>(&optin);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // Co-resident blocks at the most shared memory a launch may take, so
  // any launch of the plan is co-resident.
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bn_train_forward_kernel<T, VEC>, kThreads, optin);
  if (err != cudaSuccess) return err;
  *slab_bytes = optin - smem_bytes<T, VEC>(1, 1, 0);
  return cudaSuccess;
}

template <typename T, int VEC>
cudaError_t launch(Params p, int tx, int ty, long long smem,
                   cudaStream_t stream) {
  if (smem != smem_bytes<T, VEC>(tx, p.c, p.keep) || tx * ty != kThreads ||
      (VEC == 1 && p.keep != 0))
    return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = allow_full_smem<T, VEC>(&optin);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(bn_train_forward_kernel<T, VEC>),
      dim3(p.c_tiles * p.chunks), dim3(tx, ty), args,
      static_cast<size_t>(smem), stream);
  // A refused launch is returned, not left for the next caller's check.
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

extern "C" {

// One launch's geometry (kubeflow_tpu_torch/ops/bn_fused.py: launch_plan,
// passed as its _Geometry): x is row-major [m, c] of dtype (0 = float32,
// 1 = bfloat16), the stats use rows [0, m_stat); vec is 1, or 16 bytes
// of x's type (then c % vec == 0 and x is 16-byte aligned); tx * ty =
// 512 threads with ty a power of two; c_tiles * chunks blocks; `keep`
// stat rows a block holds in shared memory (0 when vec = 1), and
// smem_bytes, which must equal what that keep takes.
struct Geometry {
  long long m, m_stat, stat_per, rest_per, smem_bytes;
  int dtype, vec, c, tx, ty, c_tiles, chunks, keep;
};

// For one instantiation of the kernel on the current device: its SMs,
// its co-resident blocks per SM at the most shared memory a launch may
// take, and the bytes of x a block may keep in shared memory.
int kft_bn_limits(int dtype, int vec, int* sms, int* blocks_per_sm,
                  long long* slab_bytes) {
  if (dtype == 0 && vec == 1)
    return limits<float, 1>(sms, blocks_per_sm, slab_bytes);
  if (dtype == 0 && vec == 4)
    return limits<float, 4>(sms, blocks_per_sm, slab_bytes);
  if (dtype == 1 && vec == 1)
    return limits<__nv_bfloat16, 1>(sms, blocks_per_sm, slab_bytes);
  if (dtype == 1 && vec == 8)
    return limits<__nv_bfloat16, 8>(sms, blocks_per_sm, slab_bytes);
  return static_cast<int>(cudaErrorInvalidValue);
}

// scale and bias are fp32 [c]; stats holds mean [c], var [c], then the
// work buffer: chunk partials [chunks][2][c] and mul [c]. Returns the
// launch's cudaError_t: cudaErrorCooperativeLaunchTooLarge for a grid
// that cannot be co-resident.
int kft_bn_forward(const void* x, const float* scale, const float* bias,
                   void* y, float* stats, const Geometry* g, float eps,
                   void* stream) {
  const Params p{x,           y,           scale,    bias,
                 stats,       stats + g->c, stats + 2 * g->c,
                 g->m,        g->m_stat,   g->stat_per, g->rest_per,
                 g->c,        g->c_tiles,  g->chunks, g->keep,
                 eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tx = g->tx, ty = g->ty;
  const long long smem = g->smem_bytes;
  if (g->dtype == 0 && g->vec == 1) return launch<float, 1>(p, tx, ty, smem, s);
  if (g->dtype == 0 && g->vec == 4) return launch<float, 4>(p, tx, ty, smem, s);
  if (g->dtype == 1 && g->vec == 1)
    return launch<__nv_bfloat16, 1>(p, tx, ty, smem, s);
  if (g->dtype == 1 && g->vec == 8)
    return launch<__nv_bfloat16, 8>(p, tx, ty, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The sync route's stats over x's rows [0, g->m_stat) with the fused
// launch's geometry g: fp32 sums [2][c] (sum x, then sum x^2); work
// holds the chunk partials [chunks][2][c].
int kft_bn_stats(const void* x, float* sums, float* work, const Geometry* g,
                 void* stream) {
  const Params p{x,       nullptr,   nullptr,     nullptr,
                 nullptr, nullptr,   work,        g->m,
                 g->m_stat, g->stat_per, g->rest_per, g->c,
                 g->c_tiles, g->chunks, g->keep,   0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g->dtype == 0 && g->vec == 1)
    return launch_stats<float, 1>(p, sums, g->tx, g->ty, s);
  if (g->dtype == 0 && g->vec == 4)
    return launch_stats<float, 4>(p, sums, g->tx, g->ty, s);
  if (g->dtype == 1 && g->vec == 1)
    return launch_stats<__nv_bfloat16, 1>(p, sums, g->tx, g->ty, s);
  if (g->dtype == 1 && g->vec == 8)
    return launch_stats<__nv_bfloat16, 8>(p, sums, g->tx, g->ty, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The sync route's apply: y over x's g->m rows from global sums [2][c]
// and the global stat-row count g->m_stat, in g->chunks row chunks of
// g->stat_per rows; mean and var [c] out.
int kft_bn_apply(const void* x, const float* sums, const float* scale,
                 const float* bias, void* y, float* mean, float* var,
                 const Geometry* g, float eps, void* stream) {
  const Params p{x,    y,       scale,       bias,
                 mean, var,     nullptr,     g->m,
                 g->m_stat, g->stat_per, 0, g->c,
                 g->c_tiles, g->chunks, 0, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g->dtype == 0 && g->vec == 1)
    return launch_apply<float, 1>(p, sums, g->tx, g->ty, s);
  if (g->dtype == 0 && g->vec == 4)
    return launch_apply<float, 4>(p, sums, g->tx, g->ty, s);
  if (g->dtype == 1 && g->vec == 1)
    return launch_apply<__nv_bfloat16, 1>(p, sums, g->tx, g->ty, s);
  if (g->dtype == 1 && g->vec == 8)
    return launch_apply<__nv_bfloat16, 8>(p, sums, g->tx, g->ty, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
