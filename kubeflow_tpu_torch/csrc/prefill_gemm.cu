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

// The prefill's linear layer for Hopper (sm_90a): y[M, N] = x[M, K] ·
// W[N, K]^T in bf16, with W in nn.Linear's layout (row-major, K
// contiguous), fp32 accumulation on the tensor cores and one rounding to
// bf16.
//
// It has no Pallas original: the reference leaves a prefill's products to
// XLA (kubeflow_tpu/models/llama.py:72, _dense). The port needs its own
// kernel because a prefix-cache hit prefills only the prompt's unmatched
// tail, in a block of the tail's width, where the cold run prefills the
// whole prompt in a wider block; the reference pins the two streams equal
// bitwise. cuBLAS picks its kernel (tile, split-K) from M, so a position's
// row rounds apart at the two widths.
//
// The property that matters: each output element's reduction order
// depends on K alone (and the compile-time tile), never on M, the grid or
// where the row sits in its tile. There is one BM x BN x BK tile for every
// M; K is walked in order, BK at a time, into one fp32 accumulator per
// element (mma.sync.m16n8k16 adds each 16-deep slice in turn); there is no
// split-K, no stream-K and no atomics; rows past M (and columns past N, and
// K past its end) are zero-filled in shared memory by cp.async, never a
// different code path. A row's bits are then those it gets in a block of
// any other width.
//
// Design: 256 threads (8 warps, 2 x 4, each a 64 x 32 sub-tile) own a
// 128 x 128 output tile; a 4-stage ring of cp.async copies brings the
// 128 x 32 tiles of x and W into shared memory (16-byte chunks, XOR-
// swizzled so ldmatrix reads them without bank conflicts) while the warps
// multiply the stage that has landed. The epilogue rounds to bf16 and
// stores straight from the accumulators.
//
// What bounds it on the H100: at a prefill's M (hundreds of rows) it does
// far more than the ~295 operations per byte of weight at which the tensor
// cores become the limit, so operations: 989 TFLOP/s of bf16. mma.sync
// reaches part of that (wgmma is the way to all of it); this design is
// simple rather than fast, and reaching cuBLAS is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output rows a block
constexpr int kBN = 128;  // output columns a block
constexpr int kBK = 32;   // K a stage
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kWarpsN = 4;        // warps along N; 2 along M
constexpr int kWarpM = 64;        // rows a warp
constexpr int kWarpN = 32;        // columns a warp
constexpr int kChunks = kBK / 8;  // 16-byte chunks a tile row
constexpr int kTileElems = kBM * kBK;
constexpr int kStageElems = 2 * kTileElems;  // x tile, then W tile
constexpr int kSmemBytes = kStages * kStageElems * 2;
static_assert(kBM == kBN, "one tile shape for x and W");

// A tile row holds kChunks 16-byte chunks; chunk c of row r sits at
// c ^ ((r >> 1) & 3): the 8 rows one ldmatrix phase reads then cover all
// 32 banks.
__device__ __forceinline__ int swizzle(int row, int chunk) {
  return row * kBK + ((chunk ^ ((row >> 1) & 3)) << 3);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  const int bytes = full ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy K-tile kt of x (rows m0..) and W (rows n0..) into stage `slot`.
// Each thread moves two 16-byte chunks of each; a chunk past M, N or K
// is zero-filled.
__device__ __forceinline__ void load_stage(
    __nv_bfloat16* smem, int slot, int kt, const __nv_bfloat16* x,
    const __nv_bfloat16* w, int m, int n, int k, long long x_stride, int m0,
    int n0) {
  __nv_bfloat16* xs = smem + slot * kStageElems;
  __nv_bfloat16* ws = xs + kTileElems;
  const int k0 = kt * kBK;
#pragma unroll
  for (int i = 0; i < kTileElems / 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int row = idx / kChunks, chunk = idx % kChunks;
    const int col = k0 + chunk * 8;
    const bool kin = col < k;
    const bool xin = kin && m0 + row < m;
    const bool win = kin && n0 + row < n;
    const __nv_bfloat16* xsrc =
        xin ? x + static_cast<long long>(m0 + row) * x_stride + col : x;
    const __nv_bfloat16* wsrc =
        win ? w + static_cast<long long>(n0 + row) * k + col : w;
    cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(
                   xs + swizzle(row, chunk))),
               xsrc, xin);
    cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(
                   ws + swizzle(row, chunk))),
               wsrc, win);
  }
}

__global__ void __launch_bounds__(kThreads)
    prefill_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ y, int m, int n, int k,
                        long long x_stride) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp / kWarpsN) * kWarpM;  // warp's first row in the tile
  const int wn = (warp % kWarpsN) * kWarpN;  // and first column
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int ktiles = (k + kBK - 1) / kBK;

  float acc[kWarpM / 16][kWarpN / 8][4];
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWarpN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(smem, s, s, x, w, m, n, k, x_stride, m0, n0);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free again
    const int next = kt + kStages - 1;
    if (next < ktiles)
      load_stage(smem, next % kStages, next, x, w, m, n, k, x_stride, m0, n0);
    cp_async_commit();

    const __nv_bfloat16* xs = smem + (kt % kStages) * kStageElems;
    const __nv_bfloat16* ws = xs + kTileElems;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[kWarpM / 16][4];
      uint32_t b[kWarpN / 8][2];
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i) {
        // Lanes 0-15 give rows 0-15 at k 0-7, lanes 16-31 at k 8-15.
        const int row = wm + i * 16 + (lane & 15);
        const int chunk = ks * 2 + (lane >> 4);
        ldmatrix_x4(a[i], static_cast<uint32_t>(__cvta_generic_to_shared(
                              xs + swizzle(row, chunk))));
      }
#pragma unroll
      for (int j = 0; j < kWarpN / 16; ++j) {
        // Two n8 tiles at once: lanes 0-7 rows 0-7 at k 0-7, 8-15 at
        // k 8-15, 16-23 rows 8-15 at k 0-7, 24-31 at k 8-15.
        const int row = wn + j * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int chunk = ks * 2 + ((lane >> 3) & 1);
        uint32_t r[4];
        ldmatrix_x4(r, static_cast<uint32_t>(__cvta_generic_to_shared(
                           ws + swizzle(row, chunk))));
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWarpN / 8; ++j)
          mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: lane l holds rows l/4 and l/4 + 8 of each 16 x 8 tile, at
  // columns 2 (l % 4) and the next one; paired stores where N is even.
  const bool even_n = (n & 1) == 0;
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + i * 16 + (lane >> 2) + half * 8;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < kWarpN / 8; ++j) {
        const int col = n0 + wn + j * 8 + (lane & 3) * 2;
        __nv_bfloat16* dst = y + static_cast<long long>(row) * n + col;
        const float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        if (even_n && col + 1 < n) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < n) dst[0] = __float2bfloat16_rn(v0);
          if (col + 1 < n) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory a block takes: the ring of x and W stages.
int kft_prefill_gemm_smem_bytes() { return kSmemBytes; }

// x: [m, k] bf16, rows x_stride elements apart; w: [n, k] bf16
// contiguous; y: [m, n] bf16 contiguous. k must be a multiple of 8 and x,
// w and x_stride 16-byte aligned (the wrapper checks). Returns the
// launch's cudaError_t.
int kft_prefill_gemm(const void* x, const void* w, void* y, int m, int n,
                     int k, long long x_stride, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || k % 8) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      prefill_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  prefill_gemm_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y), m,
      n, k, x_stride);
  return static_cast<int>(cudaGetLastError());
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
