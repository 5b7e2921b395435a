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

// Row-wise RMSNorm for Hopper (sm_90a), bf16 and fp32:
//   var = mean(float(x)^2) over the row, r = rsqrt(var + eps)
//   y   = (x * T(r)) * scale            (T = x's type, rounded op by op)
// which is where kubeflow_tpu/models/llama.py:53-56 (RMSNorm.__call__)
// rounds: rsqrt(var + eps) cast to x's dtype, the product, then the
// scale. It has no Pallas original (the reference leaves it to XLA).
//
// Why a kernel: PyTorch's reduction sizes its block from the number of
// rows, so a row's sum of squares is taken in another order at M = 4
// than at M = 1, and the decode engine's rows must have the bits they
// have alone. Here one block of kThreads takes one row, whatever the
// row count: thread t sums the 16-byte chunks t, t + kThreads, ... in
// order (each square rounded, then added), a fixed __shfl_xor_sync
// butterfly sums a warp, and thread 0 adds the warps' sums in warp
// order. The formula in plain PyTorch is about eight launches; this is
// one.
//
// What bounds it on the H100: a few operations per element, so bytes:
// x read once (the second pass finds the row in L1), y written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    T* __restrict__ y, int d, long long x_stride, float eps) {
  using C = Chunk<T>;
  constexpr int V = C::n;
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float row_mul;
  const long long row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * x_stride);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  uint4* yr = reinterpret_cast<uint4*>(y + row * static_cast<long long>(d));
  const int chunks = d / V;
  float part = 0.0f;
  for (int j = threadIdx.x; j < chunks; j += kThreads) {
    float f[V];
    C::unpack(__ldg(xr + j), f);
#pragma unroll
    for (int e = 0; e < V; ++e) part = __fadd_rn(part, __fmul_rn(f[e], f[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total = __fadd_rn(total, warp_sums[w]);
    const float var = __fmul_rn(total, 1.0f / static_cast<float>(d));
    row_mul = C::round(rsqrtf(__fadd_rn(var, eps)));
  }
  __syncthreads();
  const float r = row_mul;
  for (int j = threadIdx.x; j < chunks; j += kThreads) {
    float f[V], s[V];
    C::unpack(__ldg(xr + j), f);
    C::unpack(__ldg(sr + j), s);
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = __fmul_rn(C::round(__fmul_rn(f[e], r)), s[e]);
    yr[j] = C::pack(f);
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* y, long long rows, int d,
           long long x_stride, float eps, cudaStream_t stream) {
  rms_norm_kernel<T><<<static_cast<unsigned int>(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(y), d, x_stride, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [rows, d], rows x_stride elements apart; scale: [d]; y: [rows, d]
// contiguous; all of dtype (0 = float32, 1 = bfloat16). d must be a
// multiple of 16 bytes of the type, and x, scale and x_stride 16-byte
// aligned (the wrapper checks). Returns the launch's cudaError_t.
int kft_rms_norm(const void* x, const void* scale, void* y, int dtype,
                 long long rows, int d, long long x_stride, float eps,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (dtype == 0) return launch<float>(x, scale, y, rows, d, x_stride, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, y, rows, d, x_stride, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
