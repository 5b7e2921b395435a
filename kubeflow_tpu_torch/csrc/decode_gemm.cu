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

// The decode step's linear layer for Hopper (sm_90a): y[M, N] = x[M, K] ·
// W[N, K]^T, with W in nn.Linear's layout (row-major, K contiguous), fp32
// accumulation and one rounding to the output type. Two instantiations:
// bf16 x, W and y (the q/k/v/o, gate/up/down projections) and fp32 x, W
// and y in full fp32 FMA, never TF32 (the fp32 lm_head).
//
// It has no Pallas original: the reference leaves these products to XLA
// (kubeflow_tpu/models/llama.py, the nn.Dense layers of a decode step).
// The port needs its own kernel because a decode step must give every
// row the bits that row gets alone: the continuous-batching engine runs
// M = slots rows where B=1 generate runs one, and the engine's output
// contract is that every slot's stream equals B=1 generate bitwise.
// cuBLAS picks its kernel (tile, split-K) from the shape, so the rows of
// an M = 4 product round apart from M = 1.
//
// The property that matters: each output element's reduction order
// depends on K alone, never on M, the grid or the row tile. There are no
// atomics and no split that depends on M. A block owns kCols output
// columns; its kWarps warps split K into kWarps fixed slices of 16-byte
// chunks; in its slice, lane l takes the chunks l, l + 32, l + 64, ...
// in that order, keeps one fp32 partial per (row, column) in registers
// and adds a chunk's elements to it one fused multiply-add at a time, in
// element order; a fixed __shfl_xor_sync butterfly sums the 32 lanes
// (every lane ends with the same bits, since a + b == b + a), and the
// warps' sums are added in warp order through shared memory. Rows go in
// tiles of kRows, each tile handled in the same way, so any M is
// accepted and row r's arithmetic is the same in every tile and at
// every M.
//
// What bounds it on the H100: at decode's M (1 to 16) it does about M
// operations per byte of W, far below the ~295 at which the tensor cores
// would be the limit: it is a weight read, 3.35 TB/s. Per llama3-8b
// decode step that is 13.96 GB of bf16 and 2.10 GB of fp32 head, 4.79 ms
// at the bytes bound. The design is simple rather than fast: one block
// per kCols columns gives every shape thousands of blocks (K split over
// the warps keeps a block's loads short), each lane has kCols 16-byte
// weight loads in flight per chunk, and a tile past the first re-reads
// W (from L2 where the grid's working set fits). Reaching the bound is a
// later change's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a block, each a fixed slice of K
constexpr int kCols = 4;   // output columns a block owns
constexpr int kRows = 8;   // rows a block computes in one pass over K

// A 16-byte chunk as floats: 8 bf16 or 4 fp32, in element order.
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
  __device__ __forceinline__ static __nv_bfloat16 round(float v) {
    return __float2bfloat16_rn(v);
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
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    decode_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       T* __restrict__ y, int m, int n, int k,
                       long long x_stride) {
  using C = Chunk<T>;
  constexpr int V = C::n;
  __shared__ float part[kWarps][kRows][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kCols;
  const int chunks = k / V;
  // Warp w sums the 16-byte chunks [c0, c1) of K: a split fixed by K.
  const int per_warp = (chunks + kWarps - 1) / kWarps;
  const int c0 = warp * per_warp;
  const int c1 = min(chunks, c0 + per_warp);
  const uint4* wrow[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    // Columns past N read the last row again and are not stored.
    const int col = min(col0 + c, n - 1);
    wrow[c] = reinterpret_cast<const uint4*>(w + static_cast<long long>(col) * k);
  }
  for (int r0 = 0; r0 < m; r0 += kRows) {
    float acc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
    const uint4* xrow[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      xrow[r] = reinterpret_cast<const uint4*>(
          x + static_cast<long long>(min(r0 + r, m - 1)) * x_stride);
#pragma unroll 2
    for (int j = c0 + lane; j < c1; j += 32) {
      float wf[kCols][V];
#pragma unroll
      for (int c = 0; c < kCols; ++c) C::unpack(__ldg(wrow[c] + j), wf[c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r0 + r < m) {
          float xf[V];
          C::unpack(__ldg(xrow[r] + j), xf);
#pragma unroll
          for (int c = 0; c < kCols; ++c)
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[r][c] = fmaf(xf[e], wf[c][e], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float v = acc[r][c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) part[warp][r][c] = v;
      }
    }
    __syncthreads();
    // The warps' sums, added in warp order.
    if (threadIdx.x < kRows * kCols) {
      const int r = threadIdx.x / kCols, c = threadIdx.x % kCols;
      float v = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) v += part[wi][r][c];
      if (r0 + r < m && col0 + c < n)
        y[static_cast<long long>(r0 + r) * n + col0 + c] = C::round(v);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int m, int n, int k,
           long long x_stride, cudaStream_t stream) {
  const dim3 grid((n + kCols - 1) / kCols);
  decode_gemm_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      m, n, k, x_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [m, k] rows x_stride elements apart; w: [n, k] contiguous; y: [m, n]
// contiguous. dtype 0 = float32, 1 = bfloat16 (all three alike). k must
// be a multiple of 16 bytes of the type, and x, w and x_stride 16-byte
// aligned (the wrapper checks). Returns the launch's cudaError_t.
int kft_decode_gemm(const void* x, const void* w, void* y, int dtype, int m,
                    int n, int k, long long x_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return 0;
  if (dtype == 0) return launch<float>(x, w, y, m, n, k, x_stride, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, m, n, k, x_stride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
