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
// accumulation and one rounding to the output type. Two designs: bf16 x,
// W and y (the q/k/v/o, gate/up/down projections) on the tensor cores,
// and fp32 x, W and y in full fp32 FMA, never TF32 (the fp32 lm_head).
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
// depends on K alone (and N, which a weight fixes), never on M, the grid
// or where the row sits. The tile and the ring are fixed and the K split
// is chosen from (N, K) and the card's SM count (split_for), never from
// M; there are no atomics; rows past M,
// columns past N and K past its end are zero-filled in shared memory,
// never a different code path.
//
// What bounds it on the H100: at decode's M (1 to 32) it does about M
// operations per byte of W, far below the ~295 at which the tensor cores
// would be the limit: it is a weight read, 3.35 TB/s. Per llama3-8b
// decode step that is 13.96 GB of bf16 and 2.10 GB of fp32 head, 4.79 ms
// at the bytes bound.
//
// bf16 design (decode_gemm_bf16_kernel): a streamed weight read. A CTA of
// 4 warps owns a slab of 64 rows of W (64 output columns) and a range of
// K; all 128 threads keep a 3-stage ring of cp.async copies in flight,
// each stage the slab's next 128 columns of K (16 KB of W, a 256-byte run
// of each row) and the same columns of up to 32 rows of x (staged once a
// stage for every warp), so 32 KB of W are in flight a CTA, three CTAs
// fit an SM, and W is read once for every M up to 32.
// Each warp multiplies its 16 W rows by the staged x rows on
// mma.sync.m16n8k16 with W as A and x as B (8 x rows an n8 tile, zero
// rows past M), one fp32 accumulator per element in one thread's
// register: each 16-deep slice of K is added in turn, so no lane or warp
// combine is needed. A thread's 16-byte shared-memory read of 8
// consecutive K elements feeds two k16 steps; the same K permutation on
// both operands leaves each slice's elements the same. Where N gives few
// slabs (k/v: 16), K is split over a cluster of up to 8 CTAs, fixed by
// (N, K) and the card's SM count: each writes its fp32 partials into shared memory and, after a
// cluster barrier, each finishes a share of the columns by adding the
// ranks' partials in rank order through distributed shared memory. The
// split makes at most two CTAs an SM in one wave (k/v 128, q/o and down
// 256, gate/up 224). M above 32 takes another pass over W per 32 rows
// (the grid's y). In a development sweep on the H100, 64-wide stages
// 4-6 deep, a rotation of each slab's K start and 2-deep 128-wide rings
// came within 1-5% of this; deeper rings (fewer CTAs an SM) took up to
// 1.9x as long.
//
// fp32 design (decode_gemm_fp32_kernel): the same streamed weight read in
// full fp32 FMA. A CTA of 8 warps owns a slab of 64 rows of W (output
// columns); its 256 threads keep a 3-stage ring of cp.async copies in
// flight, each stage the slab's next 64 columns of K (16 KB of W, a
// 256-byte run of each row: 128-byte runs streamed 7% slower in a
// development sweep) and the same columns of up to 32 rows of x, so x's
// reads from L2 stay within half of W's at M = 32 and two CTAs fit an SM.
// Each output's K is split into 8 fixed classes (16-byte chunk index mod
// 8): a lane takes one class of an 8-row x 8-column register tile, adds
// its K elements in ascending order, one fmaf each, and a fixed butterfly
// over the 8 lanes of the classes sums the partials. The lane layout makes
// every shared-memory read a full 128-byte wavefront: a quarter-warp reads
// 8 consecutive chunks of one W row, or of one x row (layouts that
// broadcast x to the lanes of a column group were bound by shared memory
// at M = 20). The order is fixed by K alone, and a row past M is skipped,
// never computed differently. So W is read once for every M up to 32 (M
// above 32 takes another pass per 32 rows, the grid's y); at M = 32 the
// FMAs (33.6 GFLOP for the lm_head, 0.50 ms at 67 TFLOP/s) come near the
// bytes bound (2.10 GB, 0.63 ms). The earlier design gave a CTA 4 columns
// and rows in tiles of 8: it read W once a tile of 8 rows, and each CTA
// read x's whole rows for its 64 KB of W.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// bf16: a streamed weight read on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kRowsPerPass = 32;  // x rows one pass over W serves
constexpr int kBN = 64;           // W rows (output columns) a CTA
constexpr int kBK = 128;          // K a stage: a 256-byte run of each W row
constexpr int kRowChunks = kBK / 8;  // 16-byte chunks a tile row
constexpr int kWarps = 4;         // each 16 W rows
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kMaxSplit = 8;      // CTAs a cluster (the portable size)
constexpr int kWBytes = kBN * kBK * 2;
constexpr int kXBytes = kRowsPerPass * kBK * 2;
constexpr int kStageBytes = kWBytes + kXBytes;
constexpr int kPartStride = kRowsPerPass + 1;  // floats a W row's partials
constexpr int kPartBytes = kBN * kPartStride * 4;
// The partials reuse the ring once it is drained: 73,728 bytes, so three
// CTAs fit an SM and a launch's clusters of up to 8 fit the card at once
// (with the partials beside a 6-deep ring, two did, and q/o and down,
// clusters of 4, took 1.5x as long).
constexpr int kSmemBytes = kStages * kStageBytes > kPartBytes ? kStages * kStageBytes : kPartBytes;
static_assert(kBN == 16 * kWarps, "a warp's m16 tile of W rows");

// The K split, from (N, K) and the card's SM count: the largest power of
// two up to 8 that keeps the CTAs within two an SM, halved while a CTA
// would get fewer than 2 stages of K.
__host__ __device__ inline int split_for(int n, int k, int sms) {
  const int slabs = (n + kBN - 1) / kBN;
  const int k_tiles = (k + kBK - 1) / kBK;
  int split = 1;
  while (split < kMaxSplit && slabs * split * 2 <= 2 * sms) split *= 2;
  while (split > 1 && k_tiles < 2 * split) split /= 2;
  return split;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  const int bytes = full ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of kBK-wide
// rows; odd rows swap each 128-byte half, so the two rows a quarter-warp
// reads with one 16-byte load cover all 32 banks.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kBK * 2 + ((chunk ^ ((row & 1) << 2)) << 4);
}

__global__ void __launch_bounds__(kThreads)
    decode_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            __nv_bfloat16* __restrict__ y, int m, int n, int k,
                            long long x_stride, int split, int k_per_rank) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* part = reinterpret_cast<float*>(smem_raw);  // after the ring drains
  const uint32_t ring = smem_u32(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x % split;  // the cluster's CTAs line up along x
  const int n0 = (blockIdx.x / split) * kBN;
  const int r0 = blockIdx.y * kRowsPerPass;
  const int rows = min(kRowsPerPass, m - r0);  // x rows of this pass
  const int subtiles = (rows + 7) / 8;         // n8 tiles holding a row
  const int k_tiles = (k + kBK - 1) / kBK;
  const int kt0 = min(k_tiles, rank * k_per_rank);
  const int nk = min(k_tiles, kt0 + k_per_rank) - kt0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;

  // Stage `slot` <- K tile kt of the W slab and of the pass's x rows; a
  // chunk past N, M or K is zero-filled.
  auto load = [&](int slot, int kt) {
    const uint32_t st = ring + slot * kStageBytes;
    const int k0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < kBN * kRowChunks / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int row = i / kRowChunks, chunk = i % kRowChunks, col = k0 + chunk * 8;
      const bool in = n0 + row < n && col < k;
      cp_async16(st + swz(row, chunk), in ? w + static_cast<long long>(n0 + row) * k + col : w,
                 in);
    }
    for (int i = threadIdx.x; i < subtiles * 8 * kRowChunks; i += kThreads) {
      const int row = i / kRowChunks, chunk = i % kRowChunks, col = k0 + chunk * 8;
      const bool in = row < rows && col < k;
      cp_async16(st + kWBytes + swz(row, chunk),
                 in ? x + static_cast<long long>(r0 + row) * x_stride + col : x, in);
    }
  };

  float acc[kRowsPerPass / 8][4];
#pragma unroll
  for (int t = 0; t < kRowsPerPass / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, kt0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; stage i - 1 is free again
    if (i + kStages - 1 < nk) load((i + kStages - 1) % kStages, kt0 + i + kStages - 1);
    cp_async_commit();
    const uint32_t st = ring + (i % kStages) * kStageBytes;
#pragma unroll
    for (int c = 0; c < kBK / 32; ++c) {
      // Lane (g, q) reads K elements 32 c + 8 q .. + 7 of W rows g and
      // g + 8 of its warp's 16 and of x row g of each n8 tile: pairs 0, 1
      // fill the fragment slots (2q, 2q + 8) of one k16 step, pairs 2, 3
      // those of the next, on both operands alike.
      const int chunk = 4 * c + q;
      const uint4 wa = lds128(st + swz(16 * warp + g, chunk));
      const uint4 wb = lds128(st + swz(16 * warp + g + 8, chunk));
#pragma unroll
      for (int t = 0; t < kRowsPerPass / 8; ++t) {
        if (t < subtiles) {
          const uint4 xv = lds128(st + kWBytes + swz(8 * t + g, chunk));
          mma_bf16(acc[t], wa.x, wb.x, wa.y, wb.y, xv.x, xv.y);
          mma_bf16(acc[t], wa.z, wb.z, wa.w, wb.w, xv.z, xv.w);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // acc[t][e]: W row 16 warp + g + 8 (e >> 1), x row 8 t + 2 q + (e & 1).
#pragma unroll
  for (int t = 0; t < kRowsPerPass / 8; ++t)
    if (t < subtiles)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(16 * warp + g + 8 * (e >> 1)) * kPartStride + 8 * t + 2 * q + (e & 1)] = acc[t][e];
  cluster.sync();
  // This CTA's share of the slab's columns: the ranks' partials added in
  // rank order, rounded once.
  const int cols = kBN / split;
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int row = idx / cols, col = rank * cols + idx % cols;
    if (n0 + col >= n) continue;
    float* cell = part + col * kPartStride + row;
    float v = *cluster.map_shared_rank(cell, 0);
    for (int r = 1; r < split; ++r) v += *cluster.map_shared_rank(cell, r);
    y[static_cast<long long>(r0 + row) * n + n0 + col] = __float2bfloat16_rn(v);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// fp32: a streamed weight read in full fp32 FMA.
// ---------------------------------------------------------------------------

constexpr int kF32BN = 64;   // W rows (output columns) a CTA
constexpr int kF32BK = 64;   // K a stage: a 256-byte run of each W row
constexpr int kF32Chunks = kF32BK / 4;  // 16-byte chunks a tile row
constexpr int kF32Classes = 8;          // K classes: chunk index mod 8
constexpr int kF32Threads = 4 * kF32BN; // 2 quads of 4 warps, 32 W rows each
constexpr int kF32Stages = 3;
constexpr int kF32WBytes = kF32BN * kF32BK * 4;
constexpr int kF32XBytes = kRowsPerPass * kF32BK * 4;
constexpr int kF32StageBytes = kF32WBytes + kF32XBytes;
// 73,728 bytes: two CTAs an SM (the registers allow two), each with two
// stages (32 KB of W) in flight while it computes the third.
constexpr int kF32SmemBytes = kF32Stages * kF32StageBytes;
static_assert(kF32Chunks % kF32Classes == 0, "whole K classes a stage");
static_assert(kRowsPerPass == 32, "a lane's x rows rg + 4 i, i < 8");

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__global__ void __launch_bounds__(kF32Threads, 2)
    decode_gemm_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            float* __restrict__ y, int m, int n, int k, long long x_stride) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t ring = smem_u32(smem_raw);
  const int n0 = blockIdx.x * kF32BN;
  const int r0 = blockIdx.y * kRowsPerPass;
  const int rows = min(kRowsPerPass, m - r0);  // x rows of this pass
  const int k_tiles = (k + kF32BK - 1) / kF32BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Lane (q, kb) of warp w: K class kb, W rows 32 (w / 4) + 8 q .. + 7 and
  // x rows rg + 4 i with rg = (q + w) mod 4, so the 4 warps of a quad
  // cover each (W row group, x row group) pair once. A quarter-warp (one
  // q) reads 8 consecutive chunks of one W row, or of one x row: every
  // shared-memory read is a whole 128-byte wavefront, none broadcast.
  const int kb = lane % kF32Classes, q = lane / kF32Classes;
  const int wrow0 = 32 * (warp / 4) + 8 * q;
  const int rg = (q + warp) % 4;

  // Stage `slot` <- K tile kt of the W slab and of the pass's x rows; W
  // past N or K is zero-filled, x rows past M are never read.
  auto load = [&](int slot, int kt) {
    const uint32_t st = ring + slot * kF32StageBytes;
    const int k0 = kt * kF32BK;
#pragma unroll
    for (int j = 0; j < kF32BN * kF32Chunks / kF32Threads; ++j) {
      const int i = threadIdx.x + j * kF32Threads;
      const int row = i / kF32Chunks, chunk = i % kF32Chunks, col = k0 + chunk * 4;
      const bool in = n0 + row < n && col < k;
      cp_async16(st + i * 16, in ? w + static_cast<long long>(n0 + row) * k + col : w, in);
    }
    for (int i = threadIdx.x; i < rows * kF32Chunks; i += kF32Threads) {
      const int row = i / kF32Chunks, col = k0 + (i % kF32Chunks) * 4;
      const bool in = col < k;
      cp_async16(st + kF32WBytes + i * 16,
                 in ? x + static_cast<long long>(r0 + row) * x_stride + col : x, in);
    }
  };

  float acc[8][8];  // [x row rg + 4 i][W row wrow0 + c]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < k_tiles; ++t) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // stage t landed; stage t - 1 is free again
    if (t + kF32Stages - 1 < k_tiles) load((t + kF32Stages - 1) % kF32Stages, t + kF32Stages - 1);
    cp_async_commit();
    const uint32_t st = ring + (t % kF32Stages) * kF32StageBytes;
#pragma unroll
    for (int j = 0; j < kF32Chunks / kF32Classes; ++j) {
      const int kk = kF32Classes * j + kb;
      float wf[8][4];
#pragma unroll
      for (int c = 0; c < 8; ++c) unpack(lds128(st + ((wrow0 + c) * kF32Chunks + kk) * 16), wf[c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (rg + 4 * i < rows) {
          float xf[4];
          unpack(lds128(st + kF32WBytes + ((rg + 4 * i) * kF32Chunks + kk) * 16), xf);
          // Each K element of the chunk in ascending order, one fmaf each.
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(xf[e], wf[c][e], acc[i][c]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // The 8 classes' partials of each output, summed by a fixed butterfly
  // over the lanes' kb bits: ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 +
  // p7)), the same bits on every lane (addition commutes).
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg + 4 * i;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v = acc[i][c];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      const int col = n0 + wrow0 + c;
      if (kb == 0 && r < rows && col < n) y[static_cast<long long>(r0 + r) * n + col] = v;
    }
  }
}

// The card's SM count, read (and both kernels' shared-memory limits
// raised) once a process: a decode step launches the kernel 225 times.
cudaError_t card_sms(int* out) {
  static int known = 0;
  if (known == 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(decode_gemm_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(decode_gemm_fp32_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kF32SmemBytes);
    if (err != cudaSuccess) return err;
    known = sms;
  }
  *out = known;
  return cudaSuccess;
}

int launch_bf16(const void* x, const void* w, void* y, int m, int n, int k, long long x_stride,
                cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = card_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int split = split_for(n, k, sms);
  const int k_tiles = (k + kBK - 1) / kBK;
  const int k_per_rank = (k_tiles + split - 1) / split;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(((n + kBN - 1) / kBN) * split, (m + kRowsPerPass - 1) / kRowsPerPass);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kSmemBytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, decode_gemm_bf16_kernel,
                            static_cast<const __nv_bfloat16*>(x),
                            static_cast<const __nv_bfloat16*>(w),
                            static_cast<__nv_bfloat16*>(y), m, n, k, x_stride, split, k_per_rank);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int launch_fp32(const void* x, const void* w, void* y, int m, int n, int k, long long x_stride,
                cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = card_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kF32BN - 1) / kF32BN, (m + kRowsPerPass - 1) / kRowsPerPass);
  decode_gemm_fp32_kernel<<<grid, kF32Threads, kF32SmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), m, n,
      k, x_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The launch plan at (dtype, m, n, k) on a card of `sms` SMs, as ints:
// x rows a pass over W, output columns a CTA, K a stage, the K split
// (CTAs a cluster; 1 for fp32), ring stages, threads a CTA, dynamic
// shared memory, grid x and grid y. Only grid y depends on m; ops/decode_gemm.py's launch_plan
// mirrors it. dtype 0 = float32, 1 = bfloat16; -1 for another.
int kft_decode_gemm_plan(int dtype, int m, int n, int k, int sms, int* out) {
  if (dtype == 1) {
    const int split = split_for(n, k, sms);
    const int vals[9] = {kRowsPerPass, kBN,        kBK,
                         split,        kStages,    kThreads,
                         kSmemBytes,   ((n + kBN - 1) / kBN) * split,
                         (m + kRowsPerPass - 1) / kRowsPerPass};
    for (int i = 0; i < 9; ++i) out[i] = vals[i];
    return 0;
  }
  if (dtype == 0) {
    const int vals[9] = {kRowsPerPass,  kF32BN,     kF32BK,
                         1,             kF32Stages, kF32Threads,
                         kF32SmemBytes, (n + kF32BN - 1) / kF32BN,
                         (m + kRowsPerPass - 1) / kRowsPerPass};
    for (int i = 0; i < 9; ++i) out[i] = vals[i];
    return 0;
  }
  return -1;
}

// x: [m, k] rows x_stride elements apart; w: [n, k] contiguous; y: [m, n]
// contiguous. dtype 0 = float32, 1 = bfloat16 (all three alike). k must
// be a multiple of 16 bytes of the type, and x, w and x_stride 16-byte
// aligned (the wrapper checks). Returns the launch's cudaError_t.
int kft_decode_gemm(const void* x, const void* w, void* y, int dtype, int m, int n, int k,
                    long long x_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return 0;
  if (dtype == 0) return launch_fp32(x, w, y, m, n, k, x_stride, s);
  if (dtype == 1) return launch_bf16(x, w, y, m, n, k, x_stride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
