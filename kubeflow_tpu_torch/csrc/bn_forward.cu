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
// the card's ~295 operations per byte, so it is bound by bytes. The
// statistics must be complete before any row is normalized, and a
// ResNet activation (up to 411 MB at batch 256) does not stay in the
// 50 MB L2 between the passes, so the least traffic is: read the stat
// rows, read x, write y. The design moves exactly that, in 16-byte
// vector loads along C.
//
// Layout. Three launches on the caller's stream:
//  (a) bn_partial_sums: a grid of (C tiles x row chunks). A block of
//      256 threads is tx channel-vectors wide and ty rows deep (tx a
//      power of two up to 32, tx * ty = 256), so a warp reads whole
//      rows contiguously even at C = 64. Each thread sums its rows in
//      fp32 registers; the block reduces over ty in shared memory in a
//      fixed tree and writes fp32 partials [chunk, 2, C].
//  (b) bn_finalize: one thread per channel sums the chunks' partials in
//      chunk order in double (no atomics: the same shape gives the same
//      bits on every run), then forms mean, var and mul = rsqrt(var +
//      eps) * scale in fp32 by the reference's formula.
//  (c) bn_normalize: the same block geometry over all M rows; each
//      thread keeps its channels' mean, mul and bias in registers.
// Hierarchical sums (a thread's ~100 rows, a block tree, a double over
// chunks) keep the statistics accurate over the 3.2 M rows of the
// ResNet-50 stem, where one sequential fp32 accumulator loses digits.
// Arithmetic is rounded op by op (__fsub_rn, __fmul_rn, __fadd_rn) so
// that y follows the plain version's rounding. The TPU's C % 128 and
// M % block_m limits do not carry over: channel and row tails are
// masked, and a C that is not a multiple of the vector width (or an
// unaligned x) takes the scalar path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// VEC consecutive elements; VEC > 1 is one 16-byte access.
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

// (a) Per-chunk fp32 sums of x and x^2 over rows [chunk * rows, ...)
// that lie below m_stat. partial is [gridDim.y, 2, c].
template <typename T, int VEC>
__global__ void bn_partial_sums(const T* __restrict__ x,
                                float* __restrict__ partial, long long m_stat,
                                int c, long long rows_per_chunk) {
  extern __shared__ float red[];  // [2][ty][tx * VEC]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int width = blockDim.x * VEC;
  const int c0 = (blockIdx.x * blockDim.x + tx) * VEC;
  const long long r_begin = blockIdx.y * rows_per_chunk;
  const long long r_end = min(m_stat, r_begin + rows_per_chunk);

  float s[VEC], ss[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = ss[i] = 0.f;
  // VEC > 1 only when c % VEC == 0, so a vector is wholly in range.
  if (c0 < c) {
    for (long long r = r_begin + ty; r < r_end; r += blockDim.y) {
      float v[VEC];
      load_vec<T, VEC>(x + r * c + c0, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += v[i];
        ss[i] += v[i] * v[i];
      }
    }
  }
  float* red_s = red;
  float* red_ss = red + blockDim.y * width;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red_s[ty * width + tx * VEC + i] = s[i];
    red_ss[ty * width + tx * VEC + i] = ss[i];
  }
  __syncthreads();
  // blockDim.y is a power of two: a fixed tree over the row lanes.
  for (int stride = blockDim.y / 2; stride > 0; stride /= 2) {
    if (ty < stride) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        red_s[ty * width + tx * VEC + i] +=
            red_s[(ty + stride) * width + tx * VEC + i];
        red_ss[ty * width + tx * VEC + i] +=
            red_ss[(ty + stride) * width + tx * VEC + i];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && c0 < c) {
    float* out = partial + static_cast<long long>(blockIdx.y) * 2 * c;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      out[c0 + i] = red_s[tx * VEC + i];
      out[c + c0 + i] = red_ss[tx * VEC + i];
    }
  }
}

// (b) Chunk partials -> mean, var (outputs) and mul (scratch).
__global__ void bn_finalize(const float* __restrict__ partial, int chunks,
                            int c, long long m_stat, float eps,
                            const float* __restrict__ scale,
                            float* __restrict__ mean_out,
                            float* __restrict__ var_out,
                            float* __restrict__ mul_out) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  double s = 0.0, ss = 0.0;
  for (int k = 0; k < chunks; ++k) {
    s += partial[static_cast<long long>(k) * 2 * c + ch];
    ss += partial[static_cast<long long>(k) * 2 * c + c + ch];
  }
  const float n = static_cast<float>(m_stat);
  const float mean = __fdiv_rn(static_cast<float>(s), n);
  const float ex2 = __fdiv_rn(static_cast<float>(ss), n);
  const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
  mean_out[ch] = mean;
  var_out[ch] = var;
  mul_out[ch] = __fmul_rn(rsqrtf(__fadd_rn(var, eps)), scale[ch]);
}

// (c) y = (x - mean) * mul + bias over rows [chunk * rows, ...) < m.
template <typename T, int VEC>
__global__ void bn_normalize(const T* __restrict__ x, T* __restrict__ y,
                             const float* __restrict__ mean,
                             const float* __restrict__ mul,
                             const float* __restrict__ bias, long long m,
                             int c, long long rows_per_chunk) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= c) return;
  float mu[VEC], k[VEC], b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mu[i] = mean[c0 + i];
    k[i] = mul[c0 + i];
    b[i] = bias[c0 + i];
  }
  const long long r_begin = blockIdx.y * rows_per_chunk;
  const long long r_end = min(m, r_begin + rows_per_chunk);
  for (long long r = r_begin + threadIdx.y; r < r_end; r += blockDim.y) {
    float v[VEC];
    load_vec<T, VEC>(x + r * c + c0, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      v[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[i], mu[i]), k[i]), b[i]);
    store_vec<T, VEC>(y + r * c + c0, v);
  }
}

struct Plan {
  int tx, ty, c_tiles;
  int stat_chunks;
  long long stat_rows;
  int norm_chunks;
  long long norm_rows;
};

template <typename T, int VEC>
cudaError_t launch(const void* x, const float* scale, const float* bias,
                   void* y, float* mean, float* var, float* work, long long m,
                   int c, long long m_stat, float eps, const Plan& p,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  float* partial = work;
  float* mul = work + static_cast<long long>(p.stat_chunks) * 2 * c;
  const dim3 block(p.tx, p.ty);
  const size_t smem = 2 * sizeof(float) * p.tx * VEC * p.ty;
  bn_partial_sums<T, VEC><<<dim3(p.c_tiles, p.stat_chunks), block, smem,
                            stream>>>(xt, partial, m_stat, c, p.stat_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_finalize<<<(c + 255) / 256, 256, 0, stream>>>(
      partial, p.stat_chunks, c, m_stat, eps, scale, mean, var, mul);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_normalize<T, VEC><<<dim3(p.c_tiles, p.norm_chunks), block, 0, stream>>>(
      xt, yt, mean, mul, bias, m, c, p.norm_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x and y are row-major [m, c]; the
// stats use rows [0, m_stat). scale, bias, mean and var are fp32 [c].
// work holds stat_chunks * 2 * c + c floats. vec is 1, or 16 bytes of
// x's type (then c % vec == 0 and x is 16-byte aligned). The launch
// geometry comes from the caller (kubeflow_tpu_torch/ops/bn_fused.py:
// launch_plan), with tx * ty <= 1024 and ty a power of two. Returns
// the first launch's cudaError_t.
int kft_bn_forward(const void* x, const float* scale, const float* bias,
                   void* y, float* mean, float* var, float* work, int dtype,
                   long long m, int c, long long m_stat, float eps, int vec,
                   int tx, int ty, int c_tiles, int stat_chunks,
                   long long stat_rows, int norm_chunks, long long norm_rows,
                   void* stream) {
  const Plan p{tx, ty, c_tiles, stat_chunks, stat_rows, norm_chunks,
               norm_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(x, scale, bias, y, mean, var, work, m, c, m_stat,
                            eps, p, s);
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(x, scale, bias, y, mean, var, work, m, c, m_stat,
                            eps, p, s);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, scale, bias, y, mean, var, work, m, c,
                                    m_stat, eps, p, s);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, scale, bias, y, mean, var, work, m, c,
                                    m_stat, eps, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
