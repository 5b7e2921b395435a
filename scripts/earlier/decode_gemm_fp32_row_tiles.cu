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

// An earlier design of csrc/decode_gemm.cu's fp32 route, kept so that
// chip_smoke.py and scripts/gemm_ab.py can time it beside today's on the
// same card: y[M, N] = x[M, K] . W[N, K]^T in full fp32 FMA. A CTA owns 4
// output columns; its 8 warps split K into 8 fixed slices of 16-byte
// chunks, lane l takes chunks l, l + 32, ... and FMAs each element in
// order into one partial per (row, column); a fixed __shfl_xor_sync
// butterfly sums the lanes and the warps' sums are added in warp order
// through shared memory. Rows go in tiles of 8, so W is read once a tile,
// and every CTA reads x's whole rows for its 64 KB of W. Only the fp32
// route is here (dtype 0 of the same C entry point); the port never
// builds or loads this file.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFmaWarps = 8;  // warps a CTA, each a fixed slice of K
constexpr int kFmaCols = 4;   // output columns a CTA owns
constexpr int kFmaRows = 8;   // rows a CTA computes in one pass over K

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__global__ void __launch_bounds__(kFmaWarps * 32)
    decode_gemm_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            float* __restrict__ y, int m, int n, int k, long long x_stride) {
  __shared__ float part[kFmaWarps][kFmaRows][kFmaCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kFmaCols;
  const int chunks = k / 4;
  // Warp w sums the 16-byte chunks [c0, c1) of K: a split fixed by K.
  const int per_warp = (chunks + kFmaWarps - 1) / kFmaWarps;
  const int c0 = warp * per_warp;
  const int c1 = min(chunks, c0 + per_warp);
  const uint4* wrow[kFmaCols];
#pragma unroll
  for (int c = 0; c < kFmaCols; ++c) {
    // Columns past N read the last row again and are not stored.
    const int col = min(col0 + c, n - 1);
    wrow[c] = reinterpret_cast<const uint4*>(w + static_cast<long long>(col) * k);
  }
  for (int r0 = 0; r0 < m; r0 += kFmaRows) {
    float acc[kFmaRows][kFmaCols];
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r)
#pragma unroll
      for (int c = 0; c < kFmaCols; ++c) acc[r][c] = 0.0f;
    const uint4* xrow[kFmaRows];
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r)
      xrow[r] = reinterpret_cast<const uint4*>(
          x + static_cast<long long>(min(r0 + r, m - 1)) * x_stride);
#pragma unroll 2
    for (int j = c0 + lane; j < c1; j += 32) {
      float wf[kFmaCols][4];
#pragma unroll
      for (int c = 0; c < kFmaCols; ++c) unpack(__ldg(wrow[c] + j), wf[c]);
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) {
        if (r0 + r < m) {
          float xf[4];
          unpack(__ldg(xrow[r] + j), xf);
#pragma unroll
          for (int c = 0; c < kFmaCols; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][c] = fmaf(xf[e], wf[c][e], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) {
#pragma unroll
      for (int c = 0; c < kFmaCols; ++c) {
        float v = acc[r][c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) part[warp][r][c] = v;
      }
    }
    __syncthreads();
    // The warps' sums, added in warp order.
    if (threadIdx.x < kFmaRows * kFmaCols) {
      const int r = threadIdx.x / kFmaCols, c = threadIdx.x % kFmaCols;
      float v = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kFmaWarps; ++wi) v += part[wi][r][c];
      if (r0 + r < m && col0 + c < n) y[static_cast<long long>(r0 + r) * n + col0 + c] = v;
    }
    __syncthreads();
  }
}

int launch_fp32(const void* x, const void* w, void* y, int m, int n, int k, long long x_stride,
                cudaStream_t stream) {
  const dim3 grid((n + kFmaCols - 1) / kFmaCols);
  decode_gemm_fp32_kernel<<<grid, kFmaWarps * 32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), m, n,
      k, x_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int kft_decode_gemm(const void* x, const void* w, void* y, int dtype, int m, int n, int k,
                    long long x_stride, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fp32(x, w, y, m, n, k, x_stride, static_cast<cudaStream_t>(stream));
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
