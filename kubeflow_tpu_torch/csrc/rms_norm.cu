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

// Row-wise RMSNorm for Hopper (sm_90a), bf16 and fp32, in two entries:
//   rms_norm:      y = (x * T(r)) * scale,   r = rsqrt(mean(float(x)^2) + eps)
//   add_rms_norm:  s = T(float(x) + float(delta)), y = rms_norm(s)
// rounded where kubeflow_tpu/models/llama.py:53-56 (RMSNorm.__call__)
// rounds: rsqrt(var + eps) cast to x's type (T), the product, then the
// scale; s as PyTorch rounds a residual add (one fp32 add, one rounding),
// which is where the reference's block (:264-275) adds each residual
// before the next norm. No Pallas original: the reference leaves both to
// XLA.
//
// Why a kernel: PyTorch's reduction sizes its block from the number of
// rows, so a row's sum of squares is taken in another order at M = 4
// than at M = 1, and the decode engine's rows must have the bits they
// have alone. Why two entries: 64 of a Llama forward's 65 norms follow a
// residual add, an elementwise launch of its own that re-reads and
// re-writes the [M, d] stream; the fused entry writes the sum and the
// norm in one launch.
//
// What bounds it on the H100: a few operations per element, so bytes:
// x (and delta) read once, y (and s) written once, the scale once. At a
// decode step's [4, 4096] the bound is ~20 ns and a launch is the cost;
// at a prefill's [8192, 4096] the rows stream from device memory.
//
// The design. The row lives in registers: a CTA of kThreads takes a
// row, thread t the 16-byte chunks t, t + kThreads, ... (kPer of them,
// about four), loaded at once with the scale's chunks, which are issued
// first so that their loads overlap the reduction. The sum of squares is
// taken in one order fixed by the width alone: each thread's chunks in
// order (each square rounded, then added), a __shfl_xor_sync butterfly
// within the warp, then the warps' partials through one fixed 32-lane
// butterfly, which every warp runs alike (no serial tail, one barrier a
// row). So a row has the same bits at any row count and in either entry.
//   A CTA a row at every row count: past a wave (the CTAs the card holds
// at once) the hardware's block scheduler hands the rows out in order.
// A persistent grid that walks the rows with a ring of bulk copies
// (cp.async.bulk on an mbarrier) was built and measured, and took 5-7%
// longer at 8192 rows.
//
// The host's work. A call's arguments come as one packed block
// (KftRmsNormArgs), so that the wrapper's foreign call converts one
// pointer, not ten arguments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(const uint4& u,
                                                float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  // Rounded to bf16 and back: the value a bf16 tensor holds.
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Chunk<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const uint4& u,
                                                float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// A width's shape: about four 16-byte chunks a thread, whole warps.
template <typename T, int D>
struct Row {
  static constexpr int kVec = Chunk<T>::n;
  static constexpr int kChunks = D / kVec;
  static constexpr int kThreads = ((kChunks + 3) / 4 + 31) / 32 * 32;
  static constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
  static constexpr int kWarps = kThreads / 32;
  static_assert(D % kVec == 0, "a row is whole 16-byte chunks");
  static_assert(kWarps <= 32, "one warp combines the partials");
  // Whether chunk p of this thread lies in the row.
  __device__ __forceinline__ static bool has(int p) {
    return kChunks % kThreads == 0 || threadIdx.x + p * kThreads < kChunks;
  }
};

// A 16-byte load on the coherent path, issued where it is written. The
// compiler sinks read-only (.nc) loads to their first use: the scale's
// past the row's barrier, to after the reduction, and the later chunks'
// after the first chunks' arithmetic, each a device-memory round trip
// more on the row. A coherent load cannot cross the barrier, and every
// load of the row is then in flight at once.
__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One row a CTA: its chunks (and delta's, and the scale's) loaded into
// registers at once; s = x + delta (kAdd) rounded to T; the sum of
// squares in the fixed order; y (and s) stored.
template <typename T, int D, bool kAdd>
__device__ __forceinline__ void norm_row(const T* __restrict__ x, const T* __restrict__ delta,
                                         const T* __restrict__ scale, T* __restrict__ s,
                                         T* __restrict__ y, float eps) {
  using R = Row<T, D>;
  using C = Chunk<T>;
  constexpr int V = R::kVec;
  __shared__ float red[R::kWarps];
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * R::kChunks;
  uint4 sc[R::kPer], xv[R::kPer], dv[R::kPer];
#pragma unroll
  for (int p = 0; p < R::kPer; ++p)
    if (R::has(p)) sc[p] = ld16(reinterpret_cast<const uint4*>(scale) + t + p * R::kThreads);
#pragma unroll
  for (int p = 0; p < R::kPer; ++p) {
    if (!R::has(p)) continue;
    const int j = t + p * R::kThreads;
    xv[p] = ld16(reinterpret_cast<const uint4*>(x) + base + j);
    if constexpr (kAdd) dv[p] = ld16(reinterpret_cast<const uint4*>(delta) + base + j);
  }
  float part = 0.0f;
#pragma unroll
  for (int p = 0; p < R::kPer; ++p) {
    if (!R::has(p)) continue;
    float f[V];
    C::unpack(xv[p], f);
    if constexpr (kAdd) {
      float g[V];
      C::unpack(dv[p], g);
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = C::round(__fadd_rn(f[e], g[e]));
      xv[p] = C::pack(f);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) part = __fadd_rn(part, __fmul_rn(f[e], f[e]));
  }
  part = warp_sum(part);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[t >> 5] = part;
  __syncthreads();
  const float total = warp_sum(lane < R::kWarps ? red[lane] : 0.0f);
  const float var = __fmul_rn(total, 1.0f / static_cast<float>(D));
  const float r = C::round(rsqrtf(__fadd_rn(var, eps)));
#pragma unroll
  for (int p = 0; p < R::kPer; ++p) {
    if (!R::has(p)) continue;
    const int j = t + p * R::kThreads;
    float f[V], g[V];
    C::unpack(xv[p], f);
    C::unpack(sc[p], g);
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = __fmul_rn(C::round(__fmul_rn(f[e], r)), g[e]);
    reinterpret_cast<uint4*>(y)[base + j] = C::pack(f);
    if constexpr (kAdd) reinterpret_cast<uint4*>(s)[base + j] = xv[p];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Row<T, D>::kThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ y,
                    float eps) {
  norm_row<T, D, false>(x, nullptr, scale, nullptr, y, eps);
}

template <typename T, int D>
__global__ void __launch_bounds__(Row<T, D>::kThreads)
    add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                        const T* __restrict__ scale, T* __restrict__ s, T* __restrict__ y,
                        float eps) {
  norm_row<T, D, true>(x, delta, scale, s, y, eps);
}

template <typename T, int D>
int launch(const void* x, const void* delta, const void* scale, void* s, void* y,
           long long rows, float eps, cudaStream_t stream) {
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(rows));
  if (delta == nullptr)
    rms_norm_kernel<T, D><<<grid, Row<T, D>::kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(y), eps);
  else
    add_rms_norm_kernel<T, D><<<grid, Row<T, D>::kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(delta), static_cast<const T*>(scale),
        static_cast<T*>(s), static_cast<T*>(y), eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_width(int d, const void* x, const void* delta, const void* scale, void* s, void* y,
             long long rows, float eps, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(x, delta, scale, s, y, rows, eps, stream);
    case 64: return launch<T, 64>(x, delta, scale, s, y, rows, eps, stream);
    case 1024: return launch<T, 1024>(x, delta, scale, s, y, rows, eps, stream);
    case 4096: return launch<T, 4096>(x, delta, scale, s, y, rows, eps, stream);
    case 5120: return launch<T, 5120>(x, delta, scale, s, y, rows, eps, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One call's arguments, in the order and layout the wrapper packs them
// (Python's struct format "<7q2if4x": little-endian, 72 bytes). x, delta,
// s, y: [rows, d] contiguous; scale: [d]; all of dtype (0 = float32,
// 1 = bfloat16) and 16-byte aligned; d one of 32, 64, 1024, 4096, 5120
// (the wrapper checks). A null delta is rms_norm (s unused); otherwise
// s = x + delta and y = rms_norm(s).
struct KftRmsNormArgs {
  const void* x;
  const void* delta;
  const void* scale;
  void* s;
  void* y;
  long long rows;
  void* stream;
  int dtype;
  int d;
  float eps;
  int unused;
};
static_assert(sizeof(void*) == 8 && sizeof(KftRmsNormArgs) == 72 &&
                  offsetof(KftRmsNormArgs, dtype) == 56 && offsetof(KftRmsNormArgs, eps) == 64,
              "the layout the wrapper packs");

// Returns the launch's cudaError_t.
int kft_rms_norm(const KftRmsNormArgs* a) {
  cudaStream_t st = static_cast<cudaStream_t>(a->stream);
  if (a->rows <= 0) return 0;
  if (a->dtype == 0)
    return by_width<float>(a->d, a->x, a->delta, a->scale, a->s, a->y, a->rows, a->eps, st);
  if (a->dtype == 1)
    return by_width<__nv_bfloat16>(a->d, a->x, a->delta, a->scale, a->s, a->y, a->rows, a->eps,
                                   st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
